"""The whole forward's share of the card's peak: one batch's least time
(``roofline``) over the traced window's seconds per batch."""
LAYER = "model forward: models/cnn.py"
MOVES = "inputs_per_s"


def read(r):
    if r.batches == 0 or r.window_s <= 0:
        return None
    return 100.0 * r.least_s * r.batches / r.window_s

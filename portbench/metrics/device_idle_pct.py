"""The share of the traced window in which no kernel, copy or memset
ran on the card."""
LAYER = "device: one H100"
MOVES = "inputs_per_s"


def read(r):
    if r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)

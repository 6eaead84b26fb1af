"""Device milliseconds per batch in PyTorch's own kernels (every kernel
that is not one of the program's ``csrc`` kernels); copies and memsets
are left out."""
LAYER = "plain tensor ops on the card: core/binarize.py, core/binary_layers.py, models/cnn.py"
MOVES = "inputs_per_s"


def read(r):
    if r.batches == 0 or r.busy_s <= 0:
        return None
    return 1e3 * r.plain_s / r.batches

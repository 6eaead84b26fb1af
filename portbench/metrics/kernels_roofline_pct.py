"""The device's work against its roofline: one batch's least time
(``roofline``) over the device's busy time per batch (the union of
kernel, copy and memset intervals), so idle time is left out."""
LAYER = "kernels: csrc/*.cu through kernels/*.py"
MOVES = "inputs_per_s"


def read(r):
    if r.batches == 0 or r.busy_s <= 0:
        return None
    return 100.0 * r.least_s * r.batches / r.busy_s

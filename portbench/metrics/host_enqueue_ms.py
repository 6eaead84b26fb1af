"""Host milliseconds per batch inside the forward call, which returns
once the batch's work is enqueued: the harness's host-clock span around
each traced batch's ``fwd(x)``."""
LAYER = "layers and dispatch: kernels/ops.py, kernels/library.py"
MOVES = "inputs_per_s"


def read(r):
    if not r.enqueue_s:
        return None
    return 1e3 * sum(r.enqueue_s) / len(r.enqueue_s)

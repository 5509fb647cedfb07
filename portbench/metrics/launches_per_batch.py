"""launches_per_batch (launches, device trace): kernels the device ran in
the traced window, over the requests in it."""


def read(run):
    t = run.trace
    if t is None or t.batches == 0:
        return None
    return len(t.kernels()) / t.batches

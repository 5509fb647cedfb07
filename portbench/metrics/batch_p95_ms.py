"""batch_p95_ms (ms, host clock): the 95th percentile of the window's
requests, each from the call to its ids and distances on the host."""

from portbench.stats import percentile


def read(run):
    if run.trace is not None or not run.latencies_s:
        return None
    return percentile(run.latencies_s, 95) * 1e3

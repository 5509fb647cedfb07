"""qps (queries/s, host clock): queries whose results reached the host in
the window, over the window's seconds."""


def read(run):
    if run.trace is not None or run.window_s <= 0:
        return None
    return run.queries / run.window_s

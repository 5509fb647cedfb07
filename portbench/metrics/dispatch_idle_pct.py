"""dispatch_idle_pct (%, device trace): the share of the traced window in
which no kernel, copy or fill ran on the device while the host was inside
the program's ``scann.search`` span (the intersection of the device's
idle stretches with the span's intervals): the device waiting on the
program's own dispatch; left out where the trace holds no such span."""

from portbench.stages import dispatch_idle_s


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    idle = dispatch_idle_s(t)
    if idle is None:
        return None
    return 100.0 * idle / t.window_s

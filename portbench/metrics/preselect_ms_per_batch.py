"""preselect_ms_per_batch (ms, device trace): device time of the
operations the program enqueues inside its ``tree_ah.preselect`` span
(the approximate top-pre_k over the leaf scores with its sort key, the
candidates' rows and ids, the validity masks) over the traced requests;
left out where ``portbench/stages.py`` cannot attribute the window's
operations."""

from portbench.stages import stage_ms_per_batch


def read(run):
    return stage_ms_per_batch(run, "tree_ah.preselect")

"""rerank_ms_per_batch (ms, device trace): device time of the operations
the program enqueues inside its ``tree_ah.rerank`` span (the gather of
the candidates' rows, their exact distances, the final top-k and the
missing masks) over the traced requests; left out where
``portbench/stages.py`` cannot attribute the window's operations."""

from portbench.stages import stage_ms_per_batch


def read(run):
    return stage_ms_per_batch(run, "tree_ah.rerank")

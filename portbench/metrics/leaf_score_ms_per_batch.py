"""leaf_score_ms_per_batch (ms, device trace): device time of the
operations the program enqueues inside its ``tree_ah.leaf.score`` span
(the grouped leaf scorer's launch alone, #1, without the leaf-major
reorder that ``leaf_ms_per_batch`` also counts) over the traced requests.

Operations go to the innermost span around their enqueue call, as in
``portbench/stages.py``, with ``tree_ah.leaf.score`` among the program's
spans. Read by the span and not by the kernel's name (as
``leaf_roofline`` reads #1), so the metric keeps its meaning across a
redesign of the scorer that renames, splits or merges its kernel, and
counts any copy or fill the scorer enqueues. Left out where the trace
holds no such span (a program that does not mark it) or where
``stages.py`` cannot match operations to enqueue calls.
"""

from portbench import stages

SCORE_SPAN = "tree_ah.leaf.score"


def score_s(trace):
    """Device seconds enqueued inside ``SCORE_SPAN`` in the window; None
    where the trace has no such span or the counts differ."""
    spans = sorted((e for e in trace.host
                    if e[0] in stages.PROGRAM_SPANS or e[0] == SCORE_SPAN),
                   key=lambda e: (e[1], -e[2]))
    if not any(e[0] == SCORE_SPAN for e in spans):
        return None
    calls = sorted(e[1] for e in trace.host
                   if e[0].startswith(stages.ENQUEUE_PREFIXES))
    ops = sorted((a, b) for _, a, b, _ in trace.device)
    if len(calls) != len(ops):
        return None
    return sum((b - a) * 1e-9
               for name, (a, b) in zip(stages._innermost(spans, calls), ops)
               if name == SCORE_SPAN)


def read(run):
    t = run.trace
    if t is None or t.batches == 0:
        return None
    s = score_s(t)
    return None if s is None else s * 1e3 / t.batches

"""Device time by stage of the program's search, read from the spans the
program marks in a ``--trace 1`` window.

The program wraps each search in ``scann.search`` (the facade) and
``tree_ah.search`` (the tree-x-AH searcher), and each stage inside in a
span of its own (``STAGE_SPANS``). The trace keeps no link from a device
operation to the host call that enqueued it, so operations are matched to
enqueue calls by order: the window's work runs on one stream and the
harness synchronises before the window opens, so the n-th device
operation by device start is the one enqueued by the n-th enqueue call on
the window's thread by host start. Each operation counts for the
innermost program span around its enqueue call; one enqueued outside
every program span (the harness's copies of the results) counts for none.
Where the two counts differ, nothing is attributed: no guess.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from portbench.stats import gaps

DISPATCH_SPAN = "scann.search"
SEARCHER_SPAN = "tree_ah.search"
STAGE_SPANS = ("tree_ah.partitions", "tree_ah.luts", "tree_ah.group",
               "tree_ah.leaf", "tree_ah.mask", "tree_ah.preselect",
               "tree_ah.rerank")
PROGRAM_SPANS = (DISPATCH_SPAN, SEARCHER_SPAN) + STAGE_SPANS
# host calls that put a kernel, copy or fill on a stream
ENQUEUE_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def _program_spans(trace) -> List[Tuple[str, int, int]]:
    """The program's spans on the window's thread, by start."""
    return sorted((e for e in trace.host if e[0] in PROGRAM_SPANS),
                  key=lambda e: (e[1], -e[2]))


def _innermost(spans: List[Tuple[str, int, int]], points: List[int]
               ) -> List[Optional[str]]:
    """The innermost span around each of the sorted ``points``, or None."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][1] <= t:
            # spans on one thread nest: the stack holds the open ones
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def attribute(trace) -> Optional[Dict[Optional[str], float]]:
    """Seconds of device operations by the innermost program span that
    enqueued them (key None: outside every program span); None when the
    trace holds no program span or the enqueue calls and the device
    operations differ in number."""
    spans = _program_spans(trace)
    if not spans:
        return None
    calls = sorted(e[1] for e in trace.host
                   if e[0].startswith(ENQUEUE_PREFIXES))
    ops = sorted((a, b) for _, a, b, _ in trace.device)
    if len(calls) != len(ops):
        return None
    out: Dict[Optional[str], float] = {}
    for name, (a, b) in zip(_innermost(spans, calls), ops):
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def stage_ms_per_batch(run, stage: str) -> Optional[float]:
    """Device milliseconds a request of the operations enqueued inside
    ``stage``; None where nothing can be attributed."""
    t = run.trace
    if t is None or t.batches == 0:
        return None
    by_span = attribute(t)
    if by_span is None:
        return None
    return by_span.get(stage, 0.0) * 1e3 / t.batches


def _intersection(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]
                  ) -> int:
    """Length of the intersection of two lists of disjoint sorted
    intervals."""
    total, j = 0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        i = j
        while i < len(ys) and ys[i][0] < b:
            total += max(0, min(b, ys[i][1]) - max(a, ys[i][0]))
            i += 1
    return total


def dispatch_idle_s(trace) -> Optional[float]:
    """Seconds of the window in which the device was idle while the host
    was inside a ``scann.search`` span; None when the trace has none."""
    searches = sorted((a, b) for n, a, b in trace.host
                      if n == DISPATCH_SPAN)
    if not searches:
        return None
    holes = gaps(((a, b) for _, a, b, _ in trace.device), *trace.window)
    return _intersection(holes, searches) * 1e-9

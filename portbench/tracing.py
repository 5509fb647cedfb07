"""The device trace of a ``--trace 1`` window, read from ``torch.profiler``.

The harness wraps its window in a ``portbench.window`` span and each
request in a ``portbench.batch`` span (spans of the benchmark's own, around
its calls into the program). This module reads the profiler's raw events
into plain tuples: the device's kernels, copies and fills, and the host's
operations on the window's thread, all on one clock in nanoseconds.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Tuple

from portbench.stats import gaps, union_length

WINDOW_SPAN = "portbench.window"
BATCH_SPAN = "portbench.batch"

_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                 "gpu_memset": "memset"}
_HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class DeviceTrace:
    window: Tuple[int, int]
    batches: int
    # (name, start, end, kind): kind is "kernel", "memcpy" or "memset"
    device: List[Tuple[str, int, int, str]]
    # (name, start, end) of the host operations on the window's thread
    host: List[Tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self) -> List[Tuple[str, int, int, str]]:
        return [e for e in self.device if e[3] == "kernel"]

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or fill ran."""
        return union_length(((a, b) for _, a, b, _ in self.device),
                            *self.window) * 1e-9

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        """Summed seconds of the kernels whose name ``match`` accepts."""
        return sum(b - a for n, a, b, _ in self.kernels() if match(n)) * 1e-9

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Each stretch of the window with nothing on the device, named by
        the innermost host operation running at its middle ("python" where
        none ran: the host was between operations)."""
        holes = gaps(((a, b) for _, a, b, _ in self.device), *self.window)
        mids = sorted(((a + b) // 2, b - a) for a, b in holes)
        host = sorted(self.host, key=lambda e: (e[1], -e[2]))
        out, stack, i = [], [], 0
        for mid, length in mids:
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] <= host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            out.append((stack[-1][0] if stack else "python", length * 1e-9))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time and the idle time by
        what the host was doing, each summed by name, at most ``top``."""
        ops = collections.Counter()
        for n, a, b, _ in self.device:
            ops[n] += (b - a) * 1e-9
        idle = collections.Counter()
        for n, s in self.idle_gaps():
            idle[n] += s
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}


def _kind(event) -> str:
    """The event's kineto activity type; profilers whose events do not
    give it (torch 2.11) are classified by device and annotation flag."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind()
    annotation = event.is_user_annotation()
    name = event.name()
    if str(event.device_type()).endswith("CUDA"):
        if annotation:
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy")
                else "gpu_memset" if name.startswith("Memset") else "kernel")
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def from_events(events) -> DeviceTrace:
    """A :class:`DeviceTrace` of the profiler's raw (kineto) events."""
    rows = []
    window, thread = None, None
    for e in events:
        kind = _kind(e)
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        rows.append((e.name(), start, end, kind, e.start_thread_id()))
        if kind == "user_annotation" and e.name() == WINDOW_SPAN:
            window, thread = (start, end), e.start_thread_id()
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = window
    device = [(n, a, b, _DEVICE_KINDS[k]) for n, a, b, k, _ in rows
              if k in _DEVICE_KINDS and b > lo and a < hi]
    host = [(n, a, b) for n, a, b, k, t in rows
            if k in _HOST_KINDS and t == thread
            and n not in (WINDOW_SPAN, BATCH_SPAN)
            and b > lo and a < hi]
    batches = sum(1 for n, a, b, k, t in rows
                  if k == "user_annotation" and n == BATCH_SPAN
                  and a >= lo and b <= hi)
    return DeviceTrace(window=window, batches=batches, device=device,
                       host=host)


def from_profiler(prof) -> DeviceTrace:
    """The trace of a stopped ``torch.profiler.profile``."""
    return from_events(prof.profiler.kineto_results.events())


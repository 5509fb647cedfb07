"""One run of one cell: set-up, the measured window, the reference's
judgement, the metrics and the result line.

Set-up (``setup_s``, from the start of ``run.py``): imports, the device,
the rows and queries made on the device from the seed, the program's build
(``build_s``), and the warm-up requests of the mix, which also build the
index's serving layout. ``index_bytes`` is the device memory the program
holds after them, less what it held before the build, a row.

The window: a closed loop of requests, each the program's search of one
batch of the query set, ending when its ids and distances are on the host;
it closes after the first request that ends ``seconds`` after the start.
With ``trace`` the profiler records the whole window, the per-layer
metrics read it, and the result line carries ``busy_s``, ``window_s`` and
the ``breakdown``.

After the window: the peak memory is read, the program's state is freed,
and the reference judges every answer (``reference/compare.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import subprocess
import sys
import time
from typing import List, Optional, Tuple

import torch

from portbench import tracing
from portbench.datagen import mixture
from portbench.reference.compare import Verdict, judge
from portbench.spec import Cell, read_metrics
from portbench.traffic import Schedule, schedule


@dataclasses.dataclass
class Run:
    """What the metrics' readers read of one run."""

    cell: Cell
    setup_s: float
    build_s: float
    index_bytes: float
    latencies_s: List[float]
    window_s: float
    queries: int
    slices: List[int]              # the query slice of each request
    schedule: Schedule
    recall: float
    trace: Optional[tracing.DeviceTrace]
    index: Optional[dict]          # Program.index_view, for counts only


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _no_span(name: str):
    return contextlib.nullcontext()


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


class Answers:
    """Host slots for the window's answers, allocated in set-up:
    page-locked on a card, so each request's ids and distances come to the
    host by DMA, with no staging copy and no page fault inside the window.
    An answer of another shape or dtype than the warm-up's (a faulty
    program), or past the last slot, is copied as it is."""

    def __init__(self, ids: torch.Tensor, dists: torch.Tensor,
                 capacity: int, cuda: bool):
        self.cuda = cuda
        self.ids = torch.empty((capacity, *ids.shape), dtype=ids.dtype,
                               pin_memory=cuda)
        self.dists = torch.empty((capacity, *dists.shape),
                                 dtype=dists.dtype, pin_memory=cuda)
        self.used = 0

    def fetch(self, ids: torch.Tensor, dists: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, distances) on the host, once the device has them ready."""
        i = self.used
        if (i < len(self.ids) and ids.shape == self.ids.shape[1:]
                and dists.shape == self.dists.shape[1:]
                and ids.dtype == self.ids.dtype
                and dists.dtype == self.dists.dtype):
            self.used += 1
            hi, hd = self.ids[i], self.dists[i]
            hi.copy_(ids, non_blocking=True)
            hd.copy_(dists, non_blocking=True)
            if self.cuda:
                torch.cuda.current_stream().synchronize()
            return hi, hd
        return ids.cpu(), dists.cpu()


def _warm_up(call, sched: Schedule, seconds: float, cuda: bool) -> Answers:
    """The mix's warm-up requests, then the answer slots for ``seconds`` at
    the fastest warm-up request's pace (with a quarter to spare), then one
    request more through them."""
    took = []
    for i in range(sched.warmup):
        t = time.perf_counter()
        ids, dists = call(sched.batches[sched.request(i)])
        ids, dists = ids.cpu(), dists.cpu()
        took.append(time.perf_counter() - t)
    # the first request also builds the serving layout
    fastest = min(took[1:] or took)
    capacity = int(seconds / max(fastest, 1e-4) * 1.25) + 8
    answers = Answers(ids, dists, capacity, cuda)
    answers.fetch(*call(sched.batches[sched.request(sched.warmup)]))
    answers.used = 0
    return answers


def _window(call, answers: Answers, sched: Schedule, seconds: float, span
            ) -> Tuple[List[float], List[Tuple[int, torch.Tensor,
                                               torch.Tensor]], float]:
    """(latencies, served answers on the host, window seconds)."""
    latencies, served = [], []
    with span(tracing.WINDOW_SPAN):
        i = 0
        t0 = time.perf_counter()
        while True:
            s = sched.request(i)
            with span(tracing.BATCH_SPAN):
                tb = time.perf_counter()
                ids, dists = answers.fetch(*call(sched.batches[s]))
                te = time.perf_counter()
            latencies.append(te - tb)
            served.append((s, ids, dists))
            i += 1
            if te - t0 >= seconds:
                break
    return latencies, served, te - t0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, program=None
             ) -> Tuple[dict, Verdict]:
    """(the result line's object, the verdict) of one run of ``cell``."""
    if program is None:
        from portbench.program import Program
        program = Program()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    allocated = ((lambda: torch.cuda.memory_allocated(device)) if cuda
                 else (lambda: 0))

    log(f"[start] imports and device in "
        f"{time.perf_counter() - t_start:.3f}s")
    t = time.perf_counter()
    rows, queries = mixture(cell.config["data"], seed, device)
    sched = schedule(cell.mix, queries)
    handed = program.prepare(rows)
    sync()
    log(f"[data] {tuple(rows.shape)} rows, {tuple(queries.shape)} queries "
        f"in {time.perf_counter() - t:.3f}s")
    before = allocated()
    t = time.perf_counter()
    searcher = program.build(cell.config, handed, device)
    sync()
    build_s = time.perf_counter() - t
    del handed
    log(f"[build] {program.name} in {build_s:.3f}s")
    call = program.call(searcher, sched.k, sched.reorder)
    t = time.perf_counter()
    answers = _warm_up(call, sched, seconds, cuda)
    sync()
    log(f"[warm-up] {sched.warmup + 1} requests in "
        f"{time.perf_counter() - t:.3f}s; {len(answers.ids)} answer slots")
    index_bytes = (allocated() - before) / rows.shape[0]
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f}s; {index_bytes:.3f} bytes a row on the "
        f"device")

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    span = torch.profiler.record_function if trace else _no_span
    sync()
    with prof if prof is not None else contextlib.nullcontext():
        latencies, served, window_s = _window(call, answers, sched,
                                              seconds, span)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"[window] {len(served)} requests in {window_s:.3f}s, "
        f"{answers.used} in answer slots")
    dtrace = None
    if prof is not None:
        t = time.perf_counter()
        dtrace = tracing.from_profiler(prof)
        prof = None
        log(f"[trace] {len(dtrace.device)} device events, "
            f"{len(dtrace.host)} host events read in "
            f"{time.perf_counter() - t:.3f}s")
    index = program.index_view(searcher, cell.config)
    del searcher, call, answers
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    verdict = judge(served, sched.batches, rows, k=sched.k,
                    measure=cell.config["scann"]["distance_measure"],
                    gap_limit=float(cell.limits["dist_gap"]),
                    recall_floor=float(cell.config["recall_floor"]))
    log(f"[reference] judged {verdict.attempted} queries in "
        f"{time.perf_counter() - t:.3f}s")

    run = Run(cell=cell, setup_s=setup_s, build_s=build_s,
              index_bytes=index_bytes, latencies_s=latencies,
              window_s=window_s,
              queries=sum(sched.batches[s].shape[0] for s, _, _ in served),
              slices=[s for s, _, _ in served], schedule=sched,
              recall=verdict.recall, trace=dtrace, index=index)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           run)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": (torch.cuda.get_device_name(device) if cuda
                    else device.type),
           "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    if cuda:
        limit = _power_limit()
        if limit:
            dev["power_limit"] = limit
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s()
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = dtrace.breakdown()
    result["compared"] = verdict.numbers
    return result, verdict


def log_compared(verdict: Verdict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for name, n in verdict.numbers.items():
        log(f"compared {name} {n['value']!r} must be {n['must_be']} "
            f"{n['limit']!r}")
    log(f"correct {verdict.correct}")

"""Shared timing and recall helpers (counterpart of
``scann_tpu/utils/benchmarking.py``).

Two timing modes, as in the JAX package:

- :func:`scan_time` / :func:`chained`: ``iters`` calls back to back, each
  call's query perturbed by the running sum of the previous results, so
  the calls form one data-dependent chain on the device and none can be
  skipped; on a card the chain is queued while the stream waits, so its
  time is the device's; the best per-call time over rounds (noise only
  ever adds time).
- :func:`pipelined`: ``iters`` distinct query batches staged before the
  clock starts, dispatched back to back, one synchronization at the end.

The JAX package chains its calls inside one ``lax.scan`` program and falls
back to :func:`pipelined` past ``CHAINED_BYTES_LIMIT`` or when that program
fails to compile: XLA rematerializes the scan's loop invariants and runs
out of device memory at the largest shapes
(``scann_tpu/utils/benchmarking.py:24-28, 66-77``). Here the chain is a
sequence of ordinary calls on one CUDA stream, with no program to compile
and no invariant to copy, so neither the limit nor the fallback exists.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def log(*a):  # overridable by importers
    print(*a, flush=True)


def scan_time(make_scan, iters, rounds=3):
    """Best per-iteration seconds of ``make_scan(iters)()`` over rounds; the
    call returns a scalar whose ``float()`` waits for its work (a card
    scalar synchronizes the device)."""
    fn = make_scan(iters)
    float(fn())  # build and run once
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        float(fn())
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained(kern_call, arrays, iters, rounds=3, log=log):
    """Best per-call seconds of ``kern_call(q_perturbed, *arrays[1:])`` ->
    (vals, idx) over ``rounds`` chains of ``iters`` calls, after one call
    that builds what the call needs.

    Call i of a chain takes ``q + acc * 1e-20 + i * 1e-6``, where ``q`` is
    ``arrays[0]`` and ``acc`` the sum of the finite ``vals`` of the calls
    before it, kept on the device: each input depends on the previous
    result, as the JAX package's scan body does (``:54-63``).

    On a card a chain is timed with CUDA events, queued behind a sleep
    kernel (``torch.cuda._sleep``) twice as long as the host took for
    ``iters`` warm calls: the host enqueues the chain while the stream
    waits, so the events time the device's calls back to back, without
    the host's dispatch between them, as the JAX package's chain runs as
    one device program. A call that synchronizes inside waits for the
    sleep and then runs at its own pace. On the CPU the host clock times
    the chain. ``log`` is kept for the JAX signature; nothing is logged."""
    q0, rest = arrays[0], arrays[1:]
    device = q0.device
    t0 = time.perf_counter()
    kern_call(q0, *rest)
    _sync(device)
    warm_s = time.perf_counter() - t0

    def chain():
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(iters):
            vals, _ = kern_call(q0 + acc * 1e-20 + i * 1e-6, *rest)
            vals = vals.float()
            acc = acc + torch.where(torch.isfinite(vals), vals,
                                    torch.zeros_like(vals)).sum()
        return acc

    best = float("inf")
    for _ in range(rounds):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # cycles at 2 GHz, above the card's clock: the sleep lasts at
            # least this long
            torch.cuda._sleep(int(min(2 * iters * warm_s, 2.0) * 2e9))
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize(device)
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            float(chain())
            secs = time.perf_counter() - t0
        best = min(best, secs / iters)
    return best


def pipelined(kern_call, arrays, iters, rounds=3):
    """Best per-call seconds of ``iters`` calls on distinct pre-staged query
    batches (``q + (i + 1) * 1e-6``), dispatched back to back and
    synchronized once, over ``rounds``, after one call that builds what the
    call needs; host clock."""
    q0, rest = arrays[0], arrays[1:]
    device = q0.device
    qs = [q0 + np.float32(i + 1) * 1e-6 for i in range(iters)]
    kern_call(qs[0], *rest)
    _sync(device)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for q in qs:
            kern_call(q, *rest)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def recall_at_k(idx, gt, k=10):
    """Mean fraction of the k true neighbors present per row."""
    return float(np.mean([len(set(map(int, a[:k])) & set(map(int, g[:k]))) / k
                          for a, g in zip(idx, gt)]))

"""Grouped leaf scoring for tree-x-AH (counterpart of
``scann_tpu/ops/tree_ah_grouped.py``).

Many queries of a batch probe the same partition, so the [B, p]
(query, partition) pairs are grouped by partition, at most ``q_cap`` pairs
per group, and each group's LUT rows score its partition's CSR code columns
once for all its queries.

Two forms of the scorer compute the same thing:

  - ``csrc/tree_ah_grouped.cu``, a CUDA kernel written for Hopper, which
    replaces the TPU kernel ``scann_tpu/ops/tree_ah_grouped.py::_kernel``,
    both of its branches: bf16 tables give bf16 scores, int8 tables (the
    int8-LUT variant) give exact int16 sums. :func:`kernel_plan` lays out
    a call: columns a thread, the code ring beside the tables in shared
    memory, and the column ranges (one block each) a group splits into;
    :func:`fit_q_cap` lowers a batch's q_cap until one group's tables fit
    a block's shared memory. Its source note gives what bounds it on the
    H100 and how the design meets that;
  - :func:`tree_ah_grouped_scores_reference`, its plain PyTorch twin.

:func:`tree_ah_grouped_scores` takes the twin for CPU tensors only; for CUDA
tensors it launches the kernel or raises.

Layout contract (the JAX package's):
  - codes_csr [S_pad, N_csr] uint8, or packed [S_pad/2, N_csr] uint8 with
    subspace 2j in the low nibble and 2j+1 in the high nibble of byte j;
    partition-contiguous columns with ``l_cap`` columns of slack at the end;
  - luts [NG*q_cap, S_pad*C], zero rows for pad subspaces (float, cast
    to bf16, or int8); with packed codes the subspace order is even-first.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from scann_tpu_torch.types import (
    MASKED_DISTANCE,
    MAX_SHARED_MEMORY,
    align_up,
    on_card,
)

# int16 sentinel for masked slots of the int8-LUT variant: real sums are
# bounded by 128 * S_pad (the wrapper asserts S_pad * 255 < 32767, the JAX
# package's bound)
I16_MASK = 32767

# q_cap values the CUDA kernel is instantiated for
KERNEL_Q_CAPS = (1, 2, 4, 8, 16, 32)
# threads a block of the CUDA kernel (csrc/tree_ah_grouped.cu's kThreads)
THREADS = 128
# a group's columns split into at most this many ranges, one block each
MAX_RANGES = 4
# code rows a stage of the kernel's two-stage code ring: the first that
# fits beside the tables wins; with none, the kernel reads codes from
# global memory
RING_STAGES = 2
STAGE_ROWS = (16, 8, 4, 2, 1)

# Kernel launches since the last reset: one per launch of the CUDA kernel,
# never for the plain twin. A run reads it to show that the main path went
# through the kernel.
LAUNCHES = 0

_fn = None


def group_pairs_by_partition(parts: torch.Tensor, num_partitions: int,
                             q_cap: int
                             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Group the [B, p] selected-partition pairs by partition id, ``q_cap``
    pairs per group (a partition probed by more queries spans several
    groups; every group holds pairs of one partition). No host sync.

    Returns:
        grp_part: [NG] int64 partition of each group, -1 for unused groups
            (callers give those size 0 so the kernel skips them).
        slot: [B*p] int64 row of each pair in the [NG*q_cap] grouped layout.
        NG: group-count bound min(K, B*p) + ceil(B*p / q_cap) — each
            distinct partition opens at most one partly filled group.
    """
    b, p = parts.shape
    bp = b * p
    ng = min(int(num_partitions), bp) + -(-bp // q_cap)
    flat = parts.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    sp = flat[order]
    idx = torch.arange(bp, device=parts.device)
    newrun = torch.ones(bp, dtype=torch.bool, device=parts.device)
    newrun[1:] = sp[1:] != sp[:-1]
    run_start = torch.cummax(torch.where(newrun, idx, 0), dim=0).values
    rank = idx - run_start
    newgrp = newrun | (rank % q_cap == 0)
    grp_id = torch.cumsum(newgrp.long(), dim=0) - 1
    slot = torch.empty_like(idx)
    slot[order] = grp_id * q_cap + rank % q_cap
    grp_part = torch.full((ng,), -1, dtype=torch.int64, device=parts.device)
    grp_part[grp_id] = sp
    return grp_part, slot, ng


def _check_args(luts_grouped, codes_csr, grp_offsets, grp_sizes, *,
                l_cap: int, l_tile: int, q_cap: int, packed: bool):
    """Shapes of a scorer call: (NG, S_pad, C)."""
    if luts_grouped.dim() != 2 or codes_csr.dim() != 2:
        raise ValueError("luts_grouped and codes_csr must be 2-D")
    if codes_csr.dtype != torch.uint8:
        raise ValueError(f"codes_csr must be uint8, got {codes_csr.dtype}")
    ngq, sc = luts_grouped.shape
    s_pad = 2 * codes_csr.shape[0] if packed else codes_csr.shape[0]
    c = sc // s_pad
    if s_pad * c != sc:
        raise ValueError(f"LUT width {sc} is not a multiple of S_pad={s_pad}")
    if packed and c > 16:
        raise ValueError(f"packed int4 codes need num_codes <= 16, got {c}")
    ng = ngq // q_cap
    if ng * q_cap != ngq:
        raise ValueError(f"{ngq} LUT rows are not a multiple of q_cap={q_cap}")
    if l_cap % l_tile != 0:
        raise ValueError(f"l_cap={l_cap} is not a multiple of l_tile={l_tile}")
    if luts_grouped.dtype == torch.int8 and s_pad * 255 >= I16_MASK:
        raise ValueError(f"int8 LUTs need S_pad * 255 < {I16_MASK}, got "
                         f"S_pad={s_pad}")
    if grp_offsets.shape != (ng,) or grp_sizes.shape != (ng,):
        raise ValueError(f"grp_offsets/grp_sizes must be [{ng}]")
    return ng, s_pad, c


def tree_ah_grouped_scores_reference(
        luts_grouped: torch.Tensor, codes_csr: torch.Tensor,
        grp_offsets: torch.Tensor, grp_sizes: torch.Tensor, *, l_cap: int,
        l_tile: int = 256, q_cap: int = 32, packed: bool = False
) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA kernel: [NG*q_cap, l_cap] scores
    masked past each group's size.

    Float LUTs are cast to bf16 first, sums run in float32 over subspaces
    in the kernel's order (for packed codes byte j adds its low then its
    high nibble) and round once to bf16, so the two agree bit for bit;
    masked slots hold bf16(``MASKED_DISTANCE``). int8 LUTs sum exactly in
    int32 and come back as int16, masked slots ``I16_MASK``. Works on any
    device; memory is one [NG, q_cap, l_cap] accumulator plus the
    [rows, NG, l_cap] gathered code bytes. Groups of size 0 (every slot
    masked) are not summed: a sharded searcher's shard gives size 0 to
    the many groups of partitions it does not own."""
    ng_all, s_pad, c = _check_args(luts_grouped, codes_csr, grp_offsets,
                                   grp_sizes, l_cap=l_cap, l_tile=l_tile,
                                   q_cap=q_cap, packed=packed)
    s_rows, n_csr = codes_csr.shape
    device = codes_csr.device
    int8 = luts_grouped.dtype == torch.int8
    live = torch.nonzero(grp_sizes > 0).flatten()
    ng = len(live)
    luts_live = luts_grouped.view(ng_all, q_cap, -1)[live]
    if int8:
        luts = luts_live.int().view(ng, q_cap, s_pad, c)
    else:
        luts = luts_live.to(torch.bfloat16).float().view(ng, q_cap, s_pad, c)
    iota_l = torch.arange(l_cap, device=device)
    cols = (grp_offsets.long()[live][:, None] + iota_l).clamp_max(n_csr - 1)
    codes_g = codes_csr[:, cols]                             # [rows, NG, l_cap]
    acc = torch.zeros(ng, q_cap, l_cap, dtype=luts.dtype, device=device)

    def add(s: int, code: torch.Tensor) -> None:
        idx = code.long()[:, None, :].expand(ng, q_cap, l_cap)
        acc.add_(torch.gather(luts[:, :, s, :], 2, idx))

    for j in range(s_rows):
        if packed:
            add(j, codes_g[j] & 0xF)
            add(s_rows + j, codes_g[j] >> 4)
        else:
            add(j, codes_g[j])
    valid = iota_l[None, :] < grp_sizes.long()[live][:, None]  # [NG, l_cap]
    fill = I16_MASK if int8 else float(MASKED_DISTANCE)
    out_dtype = torch.int16 if int8 else torch.bfloat16
    out = torch.full((ng_all, q_cap, l_cap), fill, dtype=out_dtype,
                     device=device)
    out[live] = torch.where(valid[:, None, :], acc, fill).to(out_dtype)
    return out.reshape(ng_all * q_cap, l_cap)


@dataclass(frozen=True)
class KernelPlan:
    """How ``csrc/tree_ah_grouped.cu`` lays out one call."""
    cols: int          # neighbouring columns a thread (q_cap * cols <= 32)
    tile_cols: int     # columns a tile: THREADS * cols
    stage_rows: int    # code rows a ring stage
    stages: int        # RING_STAGES, 0 where codes are read from global
    table_bytes: int   # one group's staged tables, 16-aligned
    smem_bytes: int    # tables + ring (+ 16 bytes of read slack)
    range_cols: int    # columns a block, a multiple of tile_cols
    ranges: int        # blocks a group: ceil(l_cap / range_cols)


def _group_table_bytes(q_cap: int, s_pad: int, c: int, int8: bool) -> int:
    """Shared bytes of one group's staged tables, before alignment. Raises
    where they do not fit a block's shared memory, the only shape the
    kernel refuses."""
    raw = (1 if int8 else 2) * q_cap * s_pad * c
    if raw > MAX_SHARED_MEMORY:
        raise ValueError(f"LUT rows of one group need {raw} bytes of shared "
                         f"memory, more than the {MAX_SHARED_MEMORY} a block "
                         f"has")
    return raw


def fit_q_cap(q_cap: int, s_pad: int, c: int, *, int8: bool) -> int:
    """The largest of ``KERNEL_Q_CAPS`` at most ``q_cap`` whose group's
    tables fit a block's shared memory (:func:`kernel_plan` then plans
    it). Grouping only changes which pairs share a block, never a pair's
    sum or its order, so scores do not depend on the value. Raises where
    even one query's tables do not fit."""
    one = _group_table_bytes(1, s_pad, c, int8)
    return max(q for q in KERNEL_Q_CAPS
               if q <= q_cap and q * one <= MAX_SHARED_MEMORY)


def kernel_plan(q_cap: int, s_pad: int, c: int, *, int8: bool, packed: bool,
                l_cap: int) -> KernelPlan:
    """The CUDA kernel's plan for one call. Raises where one group's tables
    do not fit a block's shared memory (:func:`fit_q_cap` picks a q_cap
    that fits)."""
    cols = 4 if q_cap <= 8 else 32 // q_cap
    tile = THREADS * cols
    raw = _group_table_bytes(q_cap, s_pad, c, int8)
    table = align_up(raw, 16)
    s_rows = s_pad // 2 if packed else s_pad
    stage_rows, stages, ring = s_rows, 0, 0
    for rows in STAGE_ROWS:
        rows = min(rows, s_rows)
        need = RING_STAGES * rows * (tile + 16) + 16
        if table + need <= MAX_SHARED_MEMORY:
            stage_rows, stages, ring = rows, RING_STAGES, need
            break
    tiles = -(-l_cap // tile)
    range_cols = max(2, -(-tiles // MAX_RANGES)) * tile
    return KernelPlan(cols, tile, stage_rows, stages, table, table + ring,
                      range_cols, -(-l_cap // range_cols))


def _kernel_fn():
    global _fn
    if _fn is None:
        from scann_tpu_torch import native

        fn = native.load("tree_ah_grouped").tree_ah_grouped_scores
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                       ctypes.c_longlong, i32, i32, i32, i32, i32, i32, i32,
                       vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def tree_ah_grouped_scores(
        luts_grouped: torch.Tensor, codes_csr: torch.Tensor,
        grp_offsets: torch.Tensor, grp_sizes: torch.Tensor, *, l_cap: int,
        l_tile: int = 256, q_cap: int = 32, packed: bool = False
) -> torch.Tensor:
    """[NG*q_cap, l_cap] grouped leaf scores (masked past each size): bf16
    for float LUTs, int16 for int8 LUTs (``I16_MASK`` where masked).

    CPU tensors go to :func:`tree_ah_grouped_scores_reference`; CUDA tensors
    to the CUDA kernel, built from ``csrc/tree_ah_grouped.cu`` at first use.
    A failed build or launch raises: there is no fallback on the GPU. Rows
    of unused group slots hold scores of whatever LUT rows they were given;
    callers read rows back through the pair -> slot map only."""
    if not on_card(luts_grouped, "tree_ah_grouped_scores"):
        return tree_ah_grouped_scores_reference(
            luts_grouped, codes_csr, grp_offsets, grp_sizes, l_cap=l_cap,
            l_tile=l_tile, q_cap=q_cap, packed=packed)
    ng, s_pad, c = _check_args(luts_grouped, codes_csr, grp_offsets,
                               grp_sizes, l_cap=l_cap, l_tile=l_tile,
                               q_cap=q_cap, packed=packed)
    device = luts_grouped.device
    for name, t, dtype in (("codes_csr", codes_csr, torch.uint8),
                           ("grp_offsets", grp_offsets, torch.int32),
                           ("grp_sizes", grp_sizes, torch.int32)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, LUTs on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q_cap not in KERNEL_Q_CAPS:
        raise ValueError(f"q_cap={q_cap} not in {KERNEL_Q_CAPS}")
    int8 = luts_grouped.dtype == torch.int8
    plan = kernel_plan(q_cap, s_pad, c, int8=int8, packed=packed,
                       l_cap=l_cap)
    luts = (luts_grouped if int8 else luts_grouped.to(torch.bfloat16)
            ).contiguous()
    out = torch.empty(ng * q_cap, l_cap, dtype=torch.int16 if int8
                      else torch.bfloat16, device=device)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(luts.data_ptr(), codes_csr.data_ptr(), grp_offsets.data_ptr(),
                 grp_sizes.data_ptr(), out.data_ptr(), ng, q_cap,
                 codes_csr.shape[0], c, codes_csr.shape[1], l_cap,
                 plan.range_cols, plan.stage_rows, int(plan.stages > 0),
                 plan.table_bytes, int(packed), int(int8), stream)
    if err != 0:
        raise RuntimeError(f"tree_ah_grouped kernel launch failed: CUDA "
                           f"error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out

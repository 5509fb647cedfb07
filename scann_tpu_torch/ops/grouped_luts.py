"""The grouped scorer's bf16 tables for tree-x-AH, written from the
un-expanded float32 tables.

A batch's tables come as a :class:`LutSource`: one [S, C] table per query
(the inner-product path: a query's tables are the same for every partition
it probes, the partition's term -<q, c_t> a bias on subspace 0) or one per
(query, partition) pair (the squared-L2 path's residual tables, or any
flat [B*p, S_pad*C] tables). The grouped scorer (``ops/tree_ah_grouped``)
reads them as [NG*q_cap, S_pad*C] bf16 rows in slot order, pad subspaces
zero, even-first subspace order for packed codes.

Two forms compute those rows:

  - ``csrc/grouped_luts.cu``, a CUDA kernel, one block per query, that
    writes each slot row once from the source (its source note gives the
    byte bound and how the design meets it);
  - :func:`grouped_luts_reference`, its plain PyTorch twin: the expansion
    (:func:`expand_luts`), the bf16 cast, the even-first order and the rows
    put in slot order.

:func:`grouped_luts` takes the twin for CPU tensors only; for CUDA tensors
it launches the kernel or raises. Rows no pair's slot names are zero in
both. No TPU kernel stands behind this: the JAX package's ``_group_luts``
is XLA operations.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from scann_tpu_torch.types import on_card

# Kernel launches since the last reset: one per call that reached the CUDA
# kernel, never for the plain twin. A run reads it to show that the grouped
# path went through the kernel.
LAUNCHES = 0
# Rows the kernel wrote since the last reset: NG*q_cap a launch, the rows
# of unused slots (written as zeros) included.
STAGED_ROWS = 0

_fn = None


class LutSource(NamedTuple):
    """A batch's float32 tables before they are expanded to pairs.

    ``tables`` is [B, S, C] with ``per_query`` (every pair of query b reads
    tables[b]) or [B*p, S, C] without (pair i = b*p + t reads tables[i]).
    ``bias`` is None or, on a per-query source only, [B, p] float32, added
    to subspace 0's C entries of pair (b, t)'s table."""
    tables: torch.Tensor
    bias: Optional[torch.Tensor]
    per_query: bool


def _num_pairs(src: LutSource, p: int) -> int:
    n, s, _ = src.tables.shape
    bp = n * p if src.per_query else n
    if not src.per_query and n % p:
        raise ValueError(f"{n} per-pair tables are not a multiple of p={p}")
    if src.bias is not None and not src.per_query:
        raise ValueError("a bias needs the per-query source")
    if src.bias is not None and src.bias.numel() != bp:
        raise ValueError(f"bias has {src.bias.numel()} entries, not {bp}")
    return bp


def expand_luts(src: LutSource, *, p: int, s_pad: int) -> torch.Tensor:
    """[B*p, s_pad*C] float32: each pair's table, bias added in float32 to
    subspace 0, zero rows for the pad subspaces."""
    n, s, c = src.tables.shape
    bp = _num_pairs(src, p)
    if s > s_pad:
        raise ValueError(f"{s} subspaces exceed S_pad={s_pad}")
    luts = src.tables.float()
    if src.per_query:
        luts = luts[:, None].expand(n, p, s, c).clone().reshape(bp, s, c)
        if src.bias is not None:
            luts[:, 0, :] += src.bias.reshape(bp)[:, None].float()
    if s_pad != s:
        luts = F.pad(luts, (0, 0, 0, s_pad - s))
    return luts.reshape(bp, s_pad * c)


def even_first(luts: torch.Tensor, s_pad: int) -> torch.Tensor:
    """[rows, s_pad*C] tables with their subspaces in even-first order
    (0, 2, 4, ..., then 1, 3, 5, ...), the order the nibble unpack of
    packed codes yields."""
    l3 = luts.reshape(luts.shape[0], s_pad, -1)
    return torch.cat([l3[:, 0::2], l3[:, 1::2]], dim=1).reshape(
        luts.shape[0], -1)


def _check_args(src: LutSource, slot: torch.Tensor, *, p: int, s_pad: int,
                rows: int, packed: bool) -> int:
    if src.tables.dim() != 3:
        raise ValueError("tables must be [N, S, C]")
    bp = _num_pairs(src, p)
    if slot.shape != (bp,):
        raise ValueError(f"slot must be [{bp}], got {list(slot.shape)}")
    if src.tables.shape[1] > s_pad:
        raise ValueError(f"{src.tables.shape[1]} subspaces exceed "
                         f"S_pad={s_pad}")
    if packed and s_pad % 2:
        raise ValueError(f"packed codes need an even S_pad, got {s_pad}")
    if rows < 0:
        raise ValueError(f"rows must be >= 0, got {rows}")
    return bp


def grouped_luts_reference(src: LutSource, slot: torch.Tensor, *, p: int,
                           s_pad: int, rows: int, packed: bool
                           ) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA kernel: [rows, s_pad*C] bf16, row
    ``slot[i]`` pair i's expanded table rounded once to bf16 (even-first
    with ``packed``), every other row zero."""
    _check_args(src, slot, p=p, s_pad=s_pad, rows=rows, packed=packed)
    luts = expand_luts(src, p=p, s_pad=s_pad).to(torch.bfloat16)
    if packed:
        luts = even_first(luts, s_pad)
    out = torch.zeros(rows, luts.shape[1], dtype=torch.bfloat16,
                      device=luts.device)
    out[slot] = luts
    return out


def _kernel_fn():
    global _fn
    if _fn is None:
        from scann_tpu_torch import native

        fn = native.load("grouped_luts").grouped_luts_bf16
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                       ctypes.c_longlong, i32, i32, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def grouped_luts(src: LutSource, slot: torch.Tensor, *, p: int, s_pad: int,
                 rows: int, packed: bool) -> torch.Tensor:
    """[rows, s_pad*C] bf16 grouped tables: row ``slot[i]`` holds pair i's
    table (source row, ``bias`` on subspace 0 in float32, pad subspaces
    zero, one rounding to bf16, even-first order with ``packed``); rows no
    pair names are zero.

    CPU tensors go to :func:`grouped_luts_reference`; CUDA tensors to the
    CUDA kernel, built from ``csrc/grouped_luts.cu`` at first use. A failed
    build or launch raises: there is no fallback on the GPU."""
    if not on_card(src.tables, "grouped_luts"):
        return grouped_luts_reference(src, slot, p=p, s_pad=s_pad, rows=rows,
                                      packed=packed)
    bp = _check_args(src, slot, p=p, s_pad=s_pad, rows=rows, packed=packed)
    n, s, c = src.tables.shape
    device = src.tables.device
    tables = src.tables.float().contiguous()
    bias = None if src.bias is None else (
        src.bias.float().reshape(bp).contiguous())
    slot = slot.long().contiguous()
    for name, t in (("slot", slot), ("bias", bias)):
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, tables on {device}")
    out = torch.empty(rows, s_pad * c, dtype=torch.bfloat16, device=device)
    if rows == 0 or bp == 0:
        return out
    used = torch.empty(rows, dtype=torch.uint8, device=device)
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(tables.data_ptr(), None if bias is None else bias.data_ptr(),
                 slot.data_ptr(), used.data_ptr(), out.data_ptr(),
                 bp // p, p, int(not src.per_query), s, s_pad, c, rows,
                 int(packed), int(tables.data_ptr() % 16 == 0), stream)
    if err != 0:
        raise RuntimeError(f"grouped_luts kernel launch failed: CUDA error "
                           f"{err}")
    global LAUNCHES, STAGED_ROWS
    LAUNCHES += 1
    STAGED_ROWS += rows
    return out

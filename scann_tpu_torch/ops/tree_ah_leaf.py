"""Per-(query, partition) float32 leaf scoring for tree-x-AH (counterpart of
``scann_tpu/ops/tree_ah_pallas.py``).

For every (query, selected partition) pair, the pair's float32 table scores
the partition's contiguous CSR code columns; slots past the partition's
size are masked. This is the function of the JAX package's non-grouped
search path (``tree_ah_search`` -> ``leaf_scores_xla``), which the Pallas
kernel was written to replace.

Two forms compute the same thing:

  - ``csrc/tree_ah_leaf.cu``, a CUDA kernel written for Hopper, which
    replaces the TPU kernel ``scann_tpu/ops/tree_ah_pallas.py::_kernel``.
    It scores the pairs in partition order (:func:`pair_order`), Q a block
    (:func:`pairs_per_block`), so that each partition's codes are read once
    for all the pairs of a block that probe it. Its source note gives what
    bounds it on the H100 and how the design meets that;
  - :func:`tree_ah_leaf_scores_reference`, its plain PyTorch twin.

:func:`tree_ah_leaf_scores` takes the twin for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from scann_tpu_torch.types import (MASKED_DISTANCE, MAX_SHARED_MEMORY,
                                   align_up, on_card)

# The CUDA kernel scores Q pairs a thread block, in partition order, with
# their Q tables resident in shared memory; at most MAX_PAIRS_PER_BLOCK.
MAX_PAIRS_PER_BLOCK = 8
# Shared memory of one block besides its tables: the code ring of
# csrc/tree_ah_leaf.cu (2 stages of 16 rows of 528 bytes; the two must
# agree) and 1 KB for its static chunk record (260 bytes).
FIXED_SHARED_BYTES = 2 * 16 * 528 + 1024
# Tables are budgeted so that this many blocks share an SM and one block's
# copies overlap another's lookups.
BLOCKS_PER_SM = 4

# Kernel launches since the last reset: one per launch of the CUDA kernel,
# never for the plain twin.
LAUNCHES = 0

_fn = None


def _pad_luts(luts: torch.Tensor, s_pad: int) -> torch.Tensor:
    """[B, p, S, C] tables with zero rows up to the codes' S_pad."""
    s = luts.shape[2]
    if s > s_pad:
        raise ValueError(f"{s} LUT subspaces exceed the codes' S_pad={s_pad}")
    if s < s_pad:
        luts = torch.nn.functional.pad(luts, (0, 0, 0, s_pad - s))
    return luts


def _check_args(luts, codes_csr, offsets, sizes):
    if luts.dim() != 4:
        raise ValueError(f"luts must be [B, p, S, C], got {tuple(luts.shape)}")
    if codes_csr.dim() != 2 or codes_csr.dtype != torch.uint8:
        raise ValueError("codes_csr must be a [S_pad, N_csr] uint8 tensor")
    b, p = luts.shape[:2]
    if offsets.shape != (b, p) or sizes.shape != (b, p):
        raise ValueError(f"offsets and sizes must be [{b}, {p}]")


def tree_ah_leaf_scores_reference(luts: torch.Tensor, codes_csr: torch.Tensor,
                                  offsets: torch.Tensor, sizes: torch.Tensor,
                                  *, l_cap: int) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA kernel: [B, p, l_cap] float32 scores,
    ``MASKED_DISTANCE`` past each pair's size. Sums run in float32 over
    ascending subspaces from 0, the kernel's order, so the two agree bit for
    bit. Works on any device; memory is one [B, p, l_cap] accumulator plus
    one subspace's gathered codes at a time."""
    _check_args(luts, codes_csr, offsets, sizes)
    s_pad, n_csr = codes_csr.shape
    luts = _pad_luts(luts.float(), s_pad)
    b, p, _, c = luts.shape
    device = codes_csr.device
    iota_l = torch.arange(l_cap, device=device)
    cols = (offsets.long()[:, :, None] + iota_l).clamp_max(n_csr - 1)
    acc = torch.zeros(b, p, l_cap, dtype=torch.float32, device=device)
    for s in range(s_pad):
        acc.add_(torch.gather(luts[:, :, s, :], 2, codes_csr[s][cols].long()))
    valid = iota_l < sizes.long()[:, :, None]
    return torch.where(valid, acc, torch.tensor(float(MASKED_DISTANCE),
                                                device=device))


def pairs_per_block(s_pad: int, c: int) -> int:
    """Q, the pairs one thread block of the CUDA kernel scores: as many
    [S_pad, C] float32 tables as fit a quarter of the shared memory beside
    the code ring, at least 1 and at most ``MAX_PAIRS_PER_BLOCK`` (8 for the
    4 KB tables of S_pad 64, C=16). Raises where one table does not fit."""
    table = 4 * s_pad * c
    if align_up(table, 16) + FIXED_SHARED_BYTES > MAX_SHARED_MEMORY:
        raise ValueError(f"one pair's table needs {table} bytes of shared "
                         f"memory; beside the kernel's other "
                         f"{FIXED_SHARED_BYTES} bytes that is more than the "
                         f"{MAX_SHARED_MEMORY} a block has")
    budget = MAX_SHARED_MEMORY // BLOCKS_PER_SM - FIXED_SHARED_BYTES
    return max(1, min(MAX_PAIRS_PER_BLOCK, budget // table))


def pair_order(offsets: torch.Tensor) -> torch.Tensor:
    """[B*p] int32 pair indices sorted by their partition's CSR offset,
    stably: pairs of one partition become neighbours, in pair order. One
    device sort, no host synchronisation."""
    return torch.argsort(offsets.reshape(-1), stable=True).to(torch.int32)


def _kernel_fn():
    global _fn
    if _fn is None:
        from scann_tpu_torch import native

        fn = native.load("tree_ah_leaf").tree_ah_leaf_scores
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32,
                       ctypes.c_longlong, i32, i32, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def tree_ah_leaf_scores(luts: torch.Tensor, codes_csr: torch.Tensor,
                        offsets: torch.Tensor, sizes: torch.Tensor, *,
                        l_cap: int) -> torch.Tensor:
    """[B, p, l_cap] float32 leaf scores, ``MASKED_DISTANCE`` past each
    pair's size.

    Args:
        luts: [B, p, S, C] float32 per-pair tables; zero rows are added up
            to the codes' S_pad (pad codes then add nothing).
        codes_csr: [S_pad, N_csr] uint8 CSR-ordered codes, every partition
            contiguous; a pair's columns off..off+size-1 must lie inside.
        offsets: [B, p] int32 first CSR column of each pair's partition
            (no alignment needed).
        sizes: [B, p] int32 partition size of each pair.

    CPU tensors go to :func:`tree_ah_leaf_scores_reference`; CUDA tensors to
    the CUDA kernel, built from ``csrc/tree_ah_leaf.cu`` at first use. A
    failed build or launch raises: there is no fallback on the GPU."""
    if not on_card(luts, "tree_ah_leaf_scores"):
        return tree_ah_leaf_scores_reference(luts, codes_csr, offsets, sizes,
                                             l_cap=l_cap)
    _check_args(luts, codes_csr, offsets, sizes)
    device = luts.device
    for name, t, dtype in (("codes_csr", codes_csr, torch.uint8),
                           ("offsets", offsets, torch.int32),
                           ("sizes", sizes, torch.int32)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, LUTs on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if luts.dtype != torch.float32:
        raise ValueError(f"luts must be float32, got {luts.dtype}")
    s_pad, n_csr = codes_csr.shape
    luts = _pad_luts(luts, s_pad).contiguous()
    b, p, _, c = luts.shape
    q = pairs_per_block(s_pad, c)
    out = torch.empty(b, p, l_cap, dtype=torch.float32, device=device)
    if b * p == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(device):
        order = pair_order(offsets)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(luts.data_ptr(), codes_csr.data_ptr(), offsets.data_ptr(),
                 sizes.data_ptr(), order.data_ptr(), out.data_ptr(), b * p,
                 s_pad, c, n_csr, l_cap, q, stream)
    if err != 0:
        raise RuntimeError(f"tree_ah_leaf kernel launch failed: CUDA error "
                           f"{err}")
    global LAUNCHES
    LAUNCHES += 1
    return out

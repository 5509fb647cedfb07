"""Top-k selection (counterpart of ``scann_tpu/ops/topk.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

# float dtype -> (same-width signed int dtype, mask of its magnitude bits)
_ORDER_BITS = {
    torch.float32: (torch.int32, 0x7FFFFFFF),
    torch.bfloat16: (torch.int16, 0x7FFF),
}


def top_k_smallest(dists: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis: (values ascending, int64 indices).

    Equal values come out lower index first, the order ``lax.top_k``
    guarantees. ``torch.topk`` leaves ties in an order that depends on the
    row's width and the device, and bf16 leaf scores tie often, so the
    selection runs on a key without ties: the value's bits above the column
    index. A 16-bit value and a column below 2**16 fit one float32 (the bf16
    pattern is a float32's upper half), which selects at float32 speed —
    measured 1.40 ms against 3.13 ms for the int64 key at [1024, 61440] on
    an H100 (PERF.md); wider rows and float32 values take the int64 key.
    """
    n = dists.shape[-1]
    col = torch.arange(n, dtype=torch.int32, device=dists.device)
    int_dtype, magnitude = _ORDER_BITS[dists.dtype]
    bits = dists.contiguous().view(int_dtype)
    if int_dtype == torch.int16 and n <= 1 << 16:
        # negative floats order by descending bit pattern: flip the column
        # there so ties still come out lower index first
        low = torch.where(bits < 0, 0xFFFF - col, col)
        key = ((bits.int() << 16) | low).view(torch.float32)
    else:
        # sign-magnitude -> two's-complement order, then the column below
        bits = torch.where(bits < 0, bits ^ magnitude, bits).long()
        key = (bits << 32) | col.long()
    _, idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return torch.gather(dists, -1, idx), idx


def approx_top_k_smallest(dists: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate selection before an exact re-rank. On a TPU the JAX package
    uses ``lax.approx_min_k``; on its CPU backend that lowers to exact
    selection, and the port selects exactly as well."""
    return top_k_smallest(dists, k)

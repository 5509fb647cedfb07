"""Top-k selection (counterpart of ``scann_tpu/ops/topk.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

# float dtype -> (same-width signed int dtype, mask of its magnitude bits)
_ORDER_BITS = {
    torch.float32: (torch.int32, 0x7FFFFFFF),
    torch.bfloat16: (torch.int16, 0x7FFF),
}


# float32 rows at least this wide select on their values (see
# top_k_smallest); narrower rows and bf16 take the tie-free key directly
VALUE_SELECT_MIN_N = 1 << 15


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """Integers in ``x``'s value order (-0.0 before +0.0): the float bits,
    sign-magnitude turned two's complement, as int64."""
    int_dtype, magnitude = _ORDER_BITS[x.dtype]
    bits = x.contiguous().view(int_dtype)
    return torch.where(bits < 0, bits ^ magnitude, bits).long()


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
    an H100 (PERF.md); wider bf16 rows and float32 values take the int64
    key.

    float32 rows of at least ``VALUE_SELECT_MIN_N`` columns select on the
    values themselves, the k + 1 smallest, and need the key only to order
    those k: where the k-th value is below the (k+1)-th, the k smallest are
    one set whatever the ties inside it. Rows where they are equal (a tie
    across the boundary, or NaN) are selected again with the key. The
    results are those of the key alone; the full-width int64 key costs
    several passes over 8 bytes a value (measured in PERF.md).
    """
    n = dists.shape[-1]
    if dists.dtype == torch.float32 and k < n and n >= VALUE_SELECT_MIN_N:
        return _top_k_by_value(dists, k)
    return _top_k_by_key(dists, k)


def _top_k_by_key(dists: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k by the tie-free key over the whole row."""
    n = dists.shape[-1]
    col = torch.arange(n, dtype=torch.int32, device=dists.device)
    int_dtype, _ = _ORDER_BITS[dists.dtype]
    if int_dtype == torch.int16 and n <= 1 << 16:
        bits = dists.contiguous().view(int_dtype)
        # negative floats order by descending bit pattern: flip the column
        # there so ties still come out lower index first
        low = torch.where(bits < 0, 0xFFFF - col, col)
        key = ((bits.int() << 16) | low).view(torch.float32)
    else:
        key = (_ordered_bits(dists) << 32) | col.long()
    _, idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return torch.gather(dists, -1, idx), idx


def _top_k_by_value(dists: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k of float32 rows by ``torch.topk`` on the values, ordered
    and tie-checked with the key (see :func:`top_k_smallest`)."""
    lead = dists.shape[:-1]
    rows = dists.reshape(-1, dists.shape[-1])
    vals, idx = torch.topk(rows, k + 1, dim=-1, largest=False, sorted=True)
    tied = ~(vals[:, k - 1] < vals[:, k])
    vals, idx = vals[:, :k], idx[:, :k]
    order = torch.sort((_ordered_bits(vals) << 32) | idx, dim=-1).indices
    vals, idx = vals.gather(-1, order), idx.gather(-1, order)
    if bool(tied.any()):
        redo = tied.nonzero().squeeze(1)
        vals[redo], idx[redo] = _top_k_by_key(rows[redo], k)
    return vals.reshape(*lead, k), idx.reshape(*lead, k)


def approx_top_k_smallest(dists: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate selection before an exact re-rank. On a TPU the JAX package
    uses ``lax.approx_min_k``; on its CPU backend that lowers to exact
    selection, and the port selects exactly as well."""
    return top_k_smallest(dists, k)

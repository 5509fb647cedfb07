"""Top-k selection (counterpart of ``scann_tpu/ops/topk.py``), with the
dedup selections that spilling needs (a point may sit in several
partitions, so its candidates may repeat)."""

from __future__ import annotations

from typing import Tuple

import torch

from scann_tpu_torch.types import MASKED_DISTANCE

# float dtype -> (same-width signed int dtype, mask of its magnitude bits)
_ORDER_BITS = {
    torch.float32: (torch.int32, 0x7FFFFFFF),
    torch.bfloat16: (torch.int16, 0x7FFF),
}


# float32 rows at least this wide select on their values (see
# top_k_smallest); narrower rows and bf16 take the tie-free key directly
VALUE_SELECT_MIN_N = 1 << 15

# rows that the selection by value sent back to the key (a tie across the k
# boundary), counted for the record
KEY_PATH_ROWS = 0


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
    global KEY_PATH_ROWS
    lead = dists.shape[:-1]
    rows = dists.reshape(-1, dists.shape[-1])
    vals, idx = torch.topk(rows, k + 1, dim=-1, largest=False, sorted=True)
    tied = ~(vals[:, k - 1] < vals[:, k])
    vals, idx = vals[:, :k], idx[:, :k]
    order = torch.sort((_ordered_bits(vals) << 32) | idx, dim=-1).indices
    vals, idx = vals.gather(-1, order), idx.gather(-1, order)
    if bool(tied.any()):
        redo = tied.nonzero().squeeze(1)
        KEY_PATH_ROWS += redo.numel()
        vals[redo], idx[redo] = _top_k_by_key(rows[redo], k)
    return vals.reshape(*lead, k), idx.reshape(*lead, k)


def approx_top_k_smallest(dists: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate selection before an exact re-rank. On a TPU the JAX package
    uses ``lax.approx_min_k``; on its CPU backend that lowers to exact
    selection, and the port selects exactly as well."""
    return top_k_smallest(dists, k)


def top_k_with_threshold(dists: torch.Tensor, k: int, epsilon: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k with an epsilon distance threshold: entries with distance
    > epsilon come back as (inf, -1)."""
    vals, idx = top_k_smallest(dists, k)
    good = vals <= epsilon
    return (torch.where(good, vals, float("inf")),
            torch.where(good, idx, -1))


def merge_top_k(dists: torch.Tensor, indices: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over candidate lists ``dists`` [..., M] whose global ids are
    ``indices`` [..., M]: (values [..., k], ids [..., k])."""
    vals, pos = top_k_smallest(dists, k)
    return vals, torch.gather(indices, -1, pos)


def dedup_top_k(vals: torch.Tensor, cand: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep-first-occurrence dedup over an ascending candidate list, then
    truncate to k. Duplicate and missing slots come back as (inf, -1)."""
    kp = cand.shape[-1]
    # dup[i]: some j < i holds the same id (ascending, so j is closer)
    eq = cand[..., :, None] == cand[..., None, :]
    lower = torch.ones(kp, kp, dtype=torch.bool,
                       device=cand.device).tril(diagonal=-1)
    dup = (eq & lower).any(dim=-1) & (cand >= 0)
    vals = torch.where(dup, float("inf"), vals)
    cand = torch.where(dup, -1, cand)
    # push the duplicates behind the (already ascending) unique entries
    order = torch.argsort(dup.to(torch.uint8), dim=-1, stable=True)
    return (torch.gather(vals, -1, order)[..., :k],
            torch.gather(cand, -1, order)[..., :k])


def top_k_unique(dists: torch.Tensor, ids: torch.Tensor, k: int,
                 multiplicity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k over candidates whose ids may repeat, at most
    ``multiplicity`` times each: the k * multiplicity smallest hold at least
    k distinct ids, the first occurrence of each is kept. Duplicate and
    missing slots come back as (inf, -1)."""
    kp = min(k * max(int(multiplicity), 1), dists.shape[-1])
    vals, pos = top_k_smallest(dists, kp)
    return dedup_top_k(vals, torch.gather(ids, -1, pos), k)


def keep_best_per_id(vals: torch.Tensor, ids: torch.Tensor, out_k: int,
                     payload=None):
    """Smallest-``out_k`` over unique ids, keeping each id's best copy.

    The JAX package sorts (id, value) with one stable two-key ``lax.sort``;
    here one stable sort on a combined int64 key does the same: the id
    (shifted past -1) in the high 32 bits, the value's order bits in the low
    32, so copies of an id come together best first and exact ties keep
    their original order. Every entry equal to its left neighbour's id is
    then a worse copy and is masked, and the survivors are selected by
    value. Masked entries (``MASKED_DISTANCE``) sort behind the real copies
    of their id, so they never displace one. ``vals`` are float32.

    Returns ``(vals [..., out_k], ids [..., out_k])`` ascending with
    (``MASKED_DISTANCE``, -1) fill, plus the payload gathered to the same
    slots when ``payload`` is given."""
    vals = vals.float()
    low = _ordered_bits(vals) + (1 << 31)                 # in [0, 2**32)
    key = ((ids.long() + 1) << 32) | low
    order = torch.sort(key, dim=-1, stable=True).indices
    ids_s = torch.gather(ids, -1, order)
    vals_s = torch.gather(vals, -1, order)
    prev = torch.cat([torch.full_like(ids_s[..., :1], -1), ids_s[..., :-1]],
                     dim=-1)
    dup = (ids_s == prev) & (ids_s >= 0)
    vals_s = torch.where(dup, float(MASKED_DISTANCE), vals_s)
    out_v, pos = top_k_smallest(vals_s, out_k)
    out_i = torch.gather(ids_s, -1, pos)
    out_i = torch.where(out_v >= MASKED_DISTANCE / 2, -1, out_i)
    if payload is None:
        return out_v, out_i
    return out_v, out_i, torch.gather(torch.gather(payload, -1, order), -1,
                                      pos)


def radius_search_mask(dists: torch.Tensor, radius: float) -> torch.Tensor:
    """Boolean mask of the points within ``radius`` (``dists <= radius``)."""
    return dists <= radius

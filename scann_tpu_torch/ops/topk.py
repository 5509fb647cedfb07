"""Top-k selection (counterpart of ``scann_tpu/ops/topk.py``), with the
dedup selections that spilling needs (a point may sit in several
partitions, so its candidates may repeat).

Every selection here is exact. bf16 rows on the card go to a CUDA kernel,
``csrc/topk_select.cu`` (an exact radix select over the 16-bit ordered
value), which replaces no TPU kernel: the JAX package's TPU path calls
``lax.approx_min_k`` there. Its plain twin is :func:`_top_k_by_key`."""

from __future__ import annotations

import ctypes
import math
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

# the selection kernel (csrc/topk_select.cu) keeps its candidate keys in a
# buffer of a power of two keys, at least SELECT_MIN_CAP; up to
# SELECT_SHARED_CAP keys it is shared memory, beyond that a global scratch
# [rows, cap] int64 allocated here. Columns and chunk offsets are 32-bit
# integers there, so a row has at most SELECT_MAX_N columns.
SELECT_MIN_CAP = 4096
SELECT_SHARED_CAP = 16384
SELECT_MAX_N = (1 << 31) - 16

# bf16 rows on a CUDA device selected by the kernel, and its launches;
# counted after each launch, with no host sync
SELECT_KERNEL_ROWS = 0
SELECT_LAUNCHES = 0

_select_fn = None


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
    index. The selection is exact on every path.

    Every bf16 row on a CUDA device goes to the selection kernel
    (``csrc/topk_select.cu``, see :func:`_top_k_by_kernel`): an exact radix
    select over the 16-bit ordered value, whose results are the int64 key's
    bit for bit, with no key in memory. bf16 rows elsewhere and float32 rows
    below ``VALUE_SELECT_MIN_N`` columns take the int64 key.

    float32 rows of at least ``VALUE_SELECT_MIN_N`` columns select on the
    values themselves, the k + 1 smallest, and need the key only to order
    those k: where the k-th value is below the (k+1)-th, the k smallest are
    one set whatever the ties inside it. Rows where they are equal (a tie
    across the boundary, or NaN) are selected again with the key. The
    results are those of the key alone; the full-width int64 key costs
    several passes over 8 bytes a value (measured in PERF.md).
    """
    n = dists.shape[-1]
    if select_kernel_takes(dists):
        return _top_k_by_kernel(dists, k)
    if dists.dtype == torch.float32 and k < n and n >= VALUE_SELECT_MIN_N:
        return _top_k_by_value(dists, k)
    return _top_k_by_key(dists, k)


def select_kernel_takes(dists: torch.Tensor) -> bool:
    """Whether :func:`top_k_smallest` sends ``dists`` to the selection
    kernel: bf16 on a CUDA device, whatever its shape, layout, k or width
    (:func:`kernel_rows` brings it to the kernel's layout, and raises
    where a width or k cannot be selected at all)."""
    return dists.dtype == torch.bfloat16 and dists.device.type == "cuda"


def kernel_rows(dists: torch.Tensor, k: int) -> torch.Tensor:
    """The 2-D ``[rows, n]`` view with unit column stride that the kernel
    reads: leading axes flattened, a copy only where the layout needs one
    (a transposed view, columns with a stride); any row stride is kept.
    Raises for a k outside [0, n] or a row wider than ``SELECT_MAX_N``."""
    n = dists.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"top-k selection: k={k} is outside [0, {n}], the "
                         f"row width")
    if n > SELECT_MAX_N:
        raise ValueError(f"top-k selection: rows of {n} columns are wider "
                         f"than the kernel's {SELECT_MAX_N}")
    rows = dists if dists.dim() == 2 else dists.reshape(
        math.prod(dists.shape[:-1]), n)
    return rows if rows.stride(-1) == 1 else rows.contiguous()


def key_capacity(k: int) -> Tuple[int, bool]:
    """The kernel's key buffer for a k: (keys a row, a power of two at least
    ``SELECT_MIN_CAP`` and k; whether they fit shared memory)."""
    cap = max(SELECT_MIN_CAP, 1 << max(k - 1, 0).bit_length())
    return cap, cap <= SELECT_SHARED_CAP


def _select_kernel_fn():
    global _select_fn
    if _select_fn is None:
        from scann_tpu_torch import native

        fn = native.load("topk_select").topk_select_bf16
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.c_longlong, i32, i32, i32, i32, vp, vp, vp,
                       vp]
        fn.restype = ctypes.c_int
        _select_fn = fn
    return _select_fn


def _top_k_by_kernel(dists: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selection kernel's launch over bf16 rows on a CUDA device: one
    block a row, outputs (and, past ``SELECT_SHARED_CAP`` keys, the key
    scratch) allocated here, no synchronisation. Results are
    :func:`_top_k_by_key`'s, bit for bit."""
    global SELECT_KERNEL_ROWS, SELECT_LAUNCHES
    lead = dists.shape[:-1]
    rows = kernel_rows(dists, k)
    r, n = rows.shape
    vals = torch.empty(r, k, dtype=torch.bfloat16, device=dists.device)
    idx = torch.empty(r, k, dtype=torch.int64, device=dists.device)
    if r == 0 or k == 0:
        return vals.reshape(*lead, k), idx.reshape(*lead, k)
    cap, shared = key_capacity(k)
    scratch = None if shared else torch.empty(
        r, cap, dtype=torch.int64, device=dists.device)
    fn = _select_kernel_fn()
    with torch.cuda.device(dists.device):
        stream = torch.cuda.current_stream(dists.device).cuda_stream
        err = fn(rows.data_ptr(), rows.stride(0), r, n, k, cap,
                 vals.data_ptr(), idx.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_select kernel launch failed: CUDA error "
                           f"{err}")
    SELECT_KERNEL_ROWS += r
    SELECT_LAUNCHES += 1
    return vals.reshape(*lead, k), idx.reshape(*lead, k)


def _top_k_by_key(dists: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k by the tie-free key over the whole row. Values are
    gathered as bits, so NaN payloads come back as they went in (a float
    gather on the CPU rewrites them)."""
    col = torch.arange(dists.shape[-1], device=dists.device)
    key = (_ordered_bits(dists) << 32) | col
    _, idx = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    bits = dists.contiguous().view(_ORDER_BITS[dists.dtype][0])
    return torch.gather(bits, -1, idx).view(dists.dtype), idx


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
    selection (equal values in an order of its own), and the port selects
    exactly, in ``lax.top_k``'s order, through :func:`top_k_smallest`:
    every bf16 tensor on the card (tree-x-AH's leaf scores, the hasher's
    LUT16 scores, the block sweep's minima) by the selection kernel, the
    rest by value or by the key."""
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

"""Exact re-rank stores (counterpart of ``scann_tpu/utils/reordering.py``).

A re-rank store is the copy of the rows that the exact re-rank gathers
candidates from, on the device:

  - float32: the [N, D] rows themselves;
  - bfloat16: [N, D] bf16 rows (torch's cast rounds as ``ml_dtypes`` does);
  - int8: a ``(codes [N, D] u8, scale [D], mn [D])`` tuple, the per-dimension
    affine codec of :func:`rerank_codec`;
  - anchored int8 / int16: a ``(codes, scale, mn, tok [N], centers [K, D])``
    tuple, the codec of :func:`residual_rerank_codec` over residuals
    ``row - centers[token]``;
  - the id-embedded CSR store (:func:`build_csr_rerank_store`): rows in CSR
    order with the point id in ``ID_LANES`` base-256 digit lanes.

:class:`ReorderingHelper` re-ranks given candidate lists against a dataset
exactly, as the JAX package's helper does.

The codecs are the JAX package's numpy code, so their codes equal its bytes.
numpy's uint16 int16 codes are stored in ``torch.int16`` as ``code - 32768``
(torch indexes int16 on the card; uint16 has few CUDA ops) and decode to the
same values (:func:`decode_codes`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.ops.distances import DistanceMeasure, gathered_distances
from scann_tpu_torch.ops.topk import top_k_smallest
from scann_tpu_torch.types import (
    DEFAULT_DEVICE,
    MASKED_DISTANCE,
    align_up,
    require_device,
)

ID_LANES = 4  # base-256 digits: ids to 2**32, exact in bf16 / f32 / u8 lanes

# offset of numpy's uint16 codes in their torch.int16 store
_U16_OFFSET = 32768

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.float32): torch.float32}


def to_store(host: np.ndarray, device: Union[str, torch.device]
             ) -> torch.Tensor:
    """A host code array on ``device``: uint16 as int16 ``code - 32768``,
    uint8 and float32 as they are."""
    if host.dtype == np.uint16:
        host = (host.astype(np.int32) - _U16_OFFSET).astype(np.int16)
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


def decode_codes(store: torch.Tensor) -> torch.Tensor:
    """float32 values of stored codes (int16 stores add the offset back)."""
    x = store.float()
    return x + _U16_OFFSET if store.dtype == torch.int16 else x


class ReorderingHelper:
    """Exact re-rank of given candidate lists (the JAX package's
    ``ReorderingHelper``), on ``device``."""

    def __init__(self, distance_measure: DistanceMeasure =
                 DistanceMeasure.SQUARED_L2,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.distance_measure = distance_measure
        self.device = torch.device(device)

    def reorder(self, dataset, queries: np.ndarray, candidates: np.ndarray,
                k: int) -> Tuple[np.ndarray, np.ndarray]:
        """``dataset`` a DenseDataset, ``queries`` [B, D] (or one [D]),
        ``candidates`` [B, C] row indices, -1 where missing -> (ids [B, k']
        int32, distances [B, k'] float32) ascending, k' = min(k, C); -1 and
        inf where fewer than k' candidates are real."""
        dev = require_device(self.device)
        db = dataset.device_tensor(dev)
        q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
        cand = torch.as_tensor(np.asarray(candidates, np.int64), device=dev)
        q = q[None] if q.dim() == 1 else q
        cand = cand[None] if cand.dim() == 1 else cand
        dists = gathered_distances(self.distance_measure, q,
                                   db[cand.clamp_min(0)])
        dists = torch.where(cand >= 0, dists, float(MASKED_DISTANCE))
        vals, pos = top_k_smallest(dists, min(k, cand.shape[1]))
        idx = torch.gather(cand, 1, pos)
        missing = vals >= MASKED_DISTANCE / 2
        return (torch.where(missing, -1, idx).int().cpu().numpy(),
                torch.where(missing, float("inf"), vals).cpu().numpy())


def rerank_codec(data: np.ndarray, n: int, dtype: str):
    """Shared re-rank codec: (storage dtype, row encoder, dequant).

    ``dequant`` is None for float storage, or ``(scale [D], mn [D])`` for
    int8: the per-dimension affine codec over the exact min..max of each
    coordinate, 256 levels, ``codes * scale + mn`` after the gather. The
    bf16 encoder returns a torch tensor (numpy has no bf16), the others
    numpy arrays."""
    if dtype == "int8":
        valid = data[:n]
        mn = valid.min(axis=0).astype(np.float32)
        scale = ((valid.max(axis=0) - mn) / 255.0).astype(np.float32)
        scale = np.maximum(scale, 1e-30)

        def encode(rows):
            return np.clip(np.rint((rows - mn) / scale), 0, 255) \
                .astype(np.uint8)

        return torch.uint8, encode, (scale, mn)
    if dtype == "bfloat16":
        return torch.bfloat16, (lambda rows: torch.from_numpy(
            np.ascontiguousarray(rows, np.float32)).to(torch.bfloat16)), None
    if dtype == "float32":
        return torch.float32, (lambda rows: rows.astype(np.float32)), None
    raise ValueError(f"unsupported rerank dtype {dtype!r}")


def residual_rerank_codec(data: np.ndarray, n: int, tokens: np.ndarray,
                          centers: np.ndarray, clip_sigmas: float = 4.0,
                          levels: int = 255):
    """Anchored int8 / int16 codec for partitioned searchers: quantize the
    residual ``row - centers[token]`` per dimension (range clipped at
    mean +- ``clip_sigmas`` sigma, intersected with the observed min / max;
    statistics in float64 sums, as the JAX package takes them) and add the
    centroid back after the gather.

    Returns ``(encode(rows, row_tokens) -> u8 / u16 numpy, (scale [D],
    mn [D]))``."""
    valid = data[:n]
    d = data.shape[1]
    resid_mn = np.full(d, np.inf, np.float32)
    resid_mx = np.full(d, -np.inf, np.float32)
    s1 = np.zeros(d, np.float64)
    s2 = np.zeros(d, np.float64)
    cs = max(1, (1 << 22) // max(d, 1))
    for lo in range(0, n, cs):
        r = valid[lo:lo + cs] - centers[tokens[lo:lo + cs]]
        resid_mn = np.minimum(resid_mn, r.min(axis=0))
        resid_mx = np.maximum(resid_mx, r.max(axis=0))
        s1 += r.sum(axis=0, dtype=np.float64)
        s2 += np.einsum("nd,nd->d", r, r, dtype=np.float64)
    mean = (s1 / max(n, 1)).astype(np.float32)
    std = np.sqrt(np.maximum(s2 / max(n, 1) - mean.astype(np.float64) ** 2,
                             0.0)).astype(np.float32)
    if clip_sigmas is not None and clip_sigmas > 0:
        lo_c = np.maximum(resid_mn, mean - clip_sigmas * std)
        hi_c = np.minimum(resid_mx, mean + clip_sigmas * std)
    else:
        lo_c, hi_c = resid_mn, resid_mx
    scale = np.maximum((hi_c - lo_c) / float(levels), 1e-30).astype(np.float32)
    mn = lo_c.astype(np.float32)
    store_dt = np.uint8 if levels <= 255 else np.uint16

    def encode(rows, row_tokens):
        r = rows - centers[row_tokens]
        return np.clip(np.rint((r - mn) / scale), 0, levels).astype(store_dt)

    return encode, (scale, mn)


def encode_rerank_rows(out, data: np.ndarray, n: int, encode) -> None:
    """Chunked encode of ``data[:n]`` into a preallocated store (numpy or a
    host torch tensor; ``out`` may be padded past n), float32 temporaries
    ~16 MB whatever N."""
    cs = max(1, (1 << 22) // max(data.shape[1], 1) - 1)
    for i in range(0, n, cs):
        hi = min(i + cs, n)
        out[i:hi] = encode(data[i:hi])


def rerank_norms_fn(dequant) -> Callable[[torch.Tensor], torch.Tensor]:
    """Squared norms over a store, from the SAME rounded / dequantized rows
    the re-rank gathers (float32 sums), or small exact distances go
    negative."""
    def _norms(x: torch.Tensor) -> torch.Tensor:
        x = decode_codes(x)
        if dequant is not None:
            x = x * dequant[0] + dequant[1]
        return torch.sum(x * x, dim=-1)

    return _norms


def _chunked_norms(store: torch.Tensor, fn, d: int) -> torch.Tensor:
    ch = max(1, (1 << 22) // max(d, 1))
    return torch.cat([fn(store[lo:lo + ch], lo)
                      for lo in range(0, store.shape[0], ch)])


def build_rerank_store(data: np.ndarray, n: int, dtype: str, row_align: int,
                       device: Union[str, torch.device]):
    """(db_repr, norms) on ``device``: bf16 rows, or the int8 ``(codes,
    scale, mn)`` tuple (:func:`rerank_codec`), encoded on the host in
    chunks and uploaded once; rows padded with zeros to ``row_align``."""
    if dtype == "float32":
        raise ValueError("unsupported rerank dtype 'float32'")
    n_pad = align_up(max(n, 1), row_align)
    dt, encode, dequant = rerank_codec(data, n, dtype)
    host = torch.zeros(n_pad, data.shape[1], dtype=dt)
    encode_rerank_rows(host, data, n, lambda rows: torch.as_tensor(
        encode(rows)))
    store = host.to(device)
    if dequant is not None:
        dq = tuple(torch.from_numpy(a).to(device) for a in dequant)
        norms_fn = rerank_norms_fn(dq)
        norms = _chunked_norms(store, lambda x, lo: norms_fn(x),
                               data.shape[1])
        return (store,) + dq, norms
    norms_fn = rerank_norms_fn(None)
    return store, _chunked_norms(store, lambda x, lo: norms_fn(x),
                                 data.shape[1])


def build_residual_rerank_store(data: np.ndarray, n: int, tokens: np.ndarray,
                                centers: np.ndarray, row_align: int,
                                device: Union[str, torch.device],
                                levels: int = 255):
    """Anchored int8 (``levels=255``) or int16 (``levels=65535``) store:
    ``((codes, scale, mn, tok, centers), norms)`` on ``device``, norms from
    the same dequantized rows the gathers produce."""
    encode, (scale, mn) = residual_rerank_codec(data, n, tokens, centers,
                                                levels=levels)
    n_pad = align_up(max(n, 1), row_align)
    host = np.zeros((n_pad, data.shape[1]),
                    np.uint8 if levels <= 255 else np.uint16)
    cs = max(1, (1 << 22) // max(data.shape[1], 1))
    for lo in range(0, n, cs):
        hi = min(lo + cs, n)
        host[lo:hi] = encode(data[lo:hi], tokens[lo:hi])
    tok = np.zeros(n_pad, np.int64)
    tok[:n] = tokens[:n]
    store = to_store(host, device)
    tok_dev = torch.from_numpy(tok).to(device)
    cent_dev = torch.from_numpy(np.asarray(centers, np.float32)).to(device)
    sc = torch.from_numpy(scale).to(device)
    mnd = torch.from_numpy(mn).to(device)

    def norms(x: torch.Tensor, lo: int) -> torch.Tensor:
        rows = decode_codes(x) * sc + mnd + cent_dev[tok_dev[lo:lo + len(x)]]
        return torch.sum(rows * rows, dim=-1)

    return ((store, sc, mnd, tok_dev, cent_dev),
            _chunked_norms(store, norms, data.shape[1]))


def build_csr_rerank_store(data: np.ndarray, perm: np.ndarray, dtype: str,
                           device: Union[str, torch.device],
                           row_parts: Optional[np.ndarray] = None,
                           tokens: Optional[np.ndarray] = None,
                           centers: Optional[np.ndarray] = None):
    """Re-rank store in CSR (partition-sorted, aligned) row order, the
    point id in ``ID_LANES`` base-256 digit lanes after the D data lanes:
    the gather takes the candidates' CSR rows directly and no [B, sel] perm
    gather exists. Alignment-gap rows hold ``data[perm[gap]]`` with its id,
    excluded downstream by their masked approximate scores.

    Anchored codecs (int8 / int16) need ``row_parts`` (each CSR row's
    partition), ``tokens`` and ``centers``: calibrated on PRIMARY-token
    residuals (the id layout's statistics at one assignment per point), each
    CSR row encoded against its own partition's centroid, so spilled copies
    may saturate at the clip. Returns the [N_csr, D + ID_LANES] store, or
    ``(store, scale, mn)`` for anchored codecs."""
    d = data.shape[1]
    n_csr = len(perm)
    anchored = dtype in ("int8", "int16")
    if anchored:
        if row_parts is None or tokens is None or centers is None:
            raise ValueError(
                "rerank_layout='csr' with an anchored codec needs "
                "row_parts (per-CSR-row partition), tokens and centers")
        levels = 255 if dtype == "int8" else 65535
        _, (scale, mn) = residual_rerank_codec(data, len(data), tokens,
                                               centers, levels=levels)
        dt = np.uint8 if levels <= 255 else np.uint16

        def encode_rows(rows, parts_blk):
            r = rows - centers[parts_blk]
            return np.clip(np.rint((r - mn) / scale), 0, levels).astype(dt)
    else:
        _, encode, _ = rerank_codec(data, len(data), dtype)
        dt = np.float32
    host = np.zeros((n_csr, d + ID_LANES), dtype=dt)
    ids = perm.astype(np.int64)
    cs = max(1, (1 << 22) // max(d, 1))
    for lo in range(0, n_csr, cs):
        hi = min(lo + cs, n_csr)
        if anchored:
            host[lo:hi, :d] = encode_rows(data[perm[lo:hi]], row_parts[lo:hi])
        elif dtype == "bfloat16":
            # bf16 values held in float32 until the upload; exact either way
            host[lo:hi, :d] = encode(data[perm[lo:hi]]).float().numpy()
        else:
            host[lo:hi, :d] = encode(data[perm[lo:hi]])
        block = ids[lo:hi]
        for j in range(ID_LANES):
            host[lo:hi, d + j] = ((block >> (8 * j)) & 0xFF).astype(dt)
    store = to_store(host, device)
    if dtype == "bfloat16":
        store = store.to(torch.bfloat16)
    if anchored:
        return (store, torch.from_numpy(scale).to(device),
                torch.from_numpy(mn).to(device))
    return store


def gather_csr_rerank_rows(store_repr, csr_rows: torch.Tensor, d: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float32 data rows [B, sel, d], decoded int64 ids [B, sel]) of CSR
    rows ``csr_rows`` from an id-embedded store. An anchored ``(codes,
    scale, mn)`` store gives the dequantized RESIDUAL rows; the caller adds
    each slot's partition centroid back."""
    anchored = isinstance(store_repr, tuple)
    store = store_repr[0] if anchored else store_repr
    raw = store[csr_rows]
    # contiguous, as the id-order gather returns them: the same rows then
    # give the same distances bit for bit in either layout
    rows = decode_codes(raw[..., :d]).contiguous()
    if anchored:
        rows = rows * store_repr[1] + store_repr[2]
    digits = decode_codes(raw[..., d:d + ID_LANES]).long()
    ids = (digits[..., 0] | (digits[..., 1] << 8) | (digits[..., 2] << 16)
           | (digits[..., 3] << 24))
    return rows, ids


def gather_rerank_rows(db_repr, idx: torch.Tensor) -> torch.Tensor:
    """float32 candidate rows ([..., D]) gathered from a re-rank store of
    any representation: codec stores dequantize only the gathered rows (the
    anchored 5-tuple adds each row's anchor centroid back); bf16 rows cast
    after the gather."""
    if isinstance(db_repr, tuple):
        if len(db_repr) == 5:
            codes, scale, mn, tok, centers = db_repr
            return (decode_codes(codes[idx]) * scale + mn
                    + centers[tok[idx]])
        codes, scale, mn = db_repr
        return decode_codes(codes[idx]) * scale + mn
    rows = db_repr[idx]
    return rows if rows.dtype == torch.float32 else rows.float()


def gather_candidates(store_repr, rows: Optional[torch.Tensor],
                      ids: Optional[torch.Tensor], *, order: str = "id",
                      slot_centers: Optional[Callable[[], torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float32 rows [B, C, D], ids [B, C]) of candidates, gathered as the
    store is indexed: by point id (``order="id"``, any representation; -1
    reads row 0), by CSR row from a store in the caller's CSR order
    (``"row"``, a shard's), or by CSR row from an id-embedded store
    (``"csr"``), whose digit lanes give the ids and whose anchored form adds
    back ``slot_centers()``, each candidate's partition centroid."""
    if order == "id":
        return gather_rerank_rows(store_repr, ids.clamp_min(0)), ids
    if order == "row":
        return gather_rerank_rows(store_repr, rows), ids
    if order != "csr":
        raise ValueError(f"unknown store order {order!r}")
    anchored = isinstance(store_repr, tuple)
    width = (store_repr[0] if anchored else store_repr).shape[-1]
    out, ids = gather_csr_rerank_rows(store_repr, rows, width - ID_LANES)
    return (out + slot_centers() if anchored else out), ids


def rerank_store_rows(db_repr) -> int:
    """Row count (padded) of a re-rank store of any representation."""
    return (db_repr[0] if isinstance(db_repr, tuple) else db_repr).shape[0]


def rerank_store_bytes(db_repr) -> int:
    """Device bytes of a re-rank store's rows (codes or values)."""
    t = db_repr[0] if isinstance(db_repr, tuple) else db_repr
    return t.numel() * t.element_size()

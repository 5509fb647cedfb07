"""PQ lookup-table scoring without a kernel (counterpart of
``scann_tpu/ops/lut16_scoring.py``).

:func:`lut_score` scores every database code against a batch of tables; the
asymmetric hasher uses it where the LUT16 kernels do not apply (C > 16).
The JAX package computes it two ways and the port keeps their arithmetic:

  * C <= 32: a bf16 one-hot product, so each table entry is rounded to bf16
    before the float32 sum;
  * larger C: a gather of the float32 entries, summed in float32.

Both sum the S entries of a column in ascending s (the JAX package leaves
the order to XLA) and stream the codes in chunks, so no [B, S, N] gather is
ever materialised.

:func:`lut_score_gathered` scores per-query candidate code lists.
"""

from __future__ import annotations

import torch

# elements of one chunk's [B, T] float32 accumulator
_CHUNK_ELEMS = 1 << 24


def sum_lut_entries(luts: torch.Tensor, codes_t: torch.Tensor,
                    acc: torch.Tensor) -> torch.Tensor:
    """acc[b, t] += Σ_s luts[b, s, codes_t[s, t]], one subspace at a time in
    ascending s, in ``acc``'s dtype. ``luts`` [B, S, C]; ``codes_t`` [S, T]
    (any integer dtype, any strides)."""
    for s in range(codes_t.shape[0]):
        acc.add_(luts[:, s, :].index_select(1, codes_t[s].long()))
    return acc


def lut_score(luts: torch.Tensor, codes: torch.Tensor,
              chunk_size: int = 16384) -> torch.Tensor:
    """Approximate distances [B, N] float32 = Σ_s luts[b, s, codes[n, s]].

    Args:
        luts: [B, S, C] float32 per-query tables.
        codes: [N, S] uint8 database codes (on the tables' device).
        chunk_size: upper bound on the codes scored per step.
    """
    b, s, c = luts.shape
    n = codes.shape[0]
    table = luts.float()
    if c <= 32:
        table = table.to(torch.bfloat16).float()
    out = torch.empty(b, n, dtype=torch.float32, device=luts.device)
    step = max(1, min(chunk_size, _CHUNK_ELEMS // max(b, 1)))
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        acc = torch.zeros(b, hi - lo, dtype=torch.float32, device=luts.device)
        out[:, lo:hi] = sum_lut_entries(table, codes[lo:hi].T, acc)
    return out


def lut_score_gathered(luts: torch.Tensor, codes_per_query: torch.Tensor,
                       chunk_t: int = 8192) -> torch.Tensor:
    """Scores of per-query candidate code lists: [B, T] float32.

    A chunked flat-index gather, never a one-hot: with per-query candidate
    lists a one-hot would be [B, T, S*C].

    Args:
        luts: [B, S, C] float32.
        codes_per_query: [B, T, S] codes gathered per query.
    """
    b, s, c = luts.shape
    t = codes_per_query.shape[1]
    luts_flat = luts.float().reshape(b, s * c)
    base = torch.arange(s, device=luts.device) * c
    out = torch.empty(b, t, dtype=torch.float32, device=luts.device)
    for lo in range(0, t, chunk_t):
        chunk = codes_per_query[:, lo:lo + chunk_t].long() + base  # [B, Tc, S]
        vals = torch.gather(luts_flat, 1, chunk.reshape(b, -1))
        out[:, lo:lo + chunk_t] = vals.reshape(b, -1, s).sum(dim=-1)
    return out

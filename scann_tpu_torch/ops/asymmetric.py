"""Asymmetric scoring: float32 queries against a quantized database
(counterpart of ``scann_tpu/ops/asymmetric.py``).

The codec is affine, ``d' = C * scale + offset`` (C the stored codes as
float32), so

    q . d' = scale * (q . C) + offset * sum(q)

and SQUARED_L2, L2, DOT_PRODUCT, COSINE and GENERAL_INNER_PRODUCT against
the *dequantized* rows need only the raw product ``q . C`` plus per-row
squared norms precomputed from the dequantized rows. The raw product comes
from the int8-dots kernel over the transposed uint8 codes
(``codes_transposed``: no float copy of the codes in device memory) or from
a float32 product of the cast codes (bf16 and fp8 storage, scale 1 and
offset 0), which the JAX package also leaves to the library. The fold
applies the JAX package's float32 operations in its order; scale and offset
are float32.
"""

from __future__ import annotations

from typing import Union

import torch

from scann_tpu_torch.ops.distances import DistanceMeasure, squared_norms
from scann_tpu_torch.ops.scoring_kernels import int8_dots

ASYMMETRIC_MEASURES = (DistanceMeasure.SQUARED_L2, DistanceMeasure.L2,
                       DistanceMeasure.DOT_PRODUCT, DistanceMeasure.COSINE,
                       DistanceMeasure.GENERAL_INNER_PRODUCT)

Scalar = Union[float, torch.Tensor]


def fold_affine(measure: DistanceMeasure, queries: torch.Tensor,
                raw_dots: torch.Tensor, db_sq_norms: torch.Tensor,
                scale: Scalar = 1.0, offset: Scalar = 0.0) -> torch.Tensor:
    """[B, N] distances from the raw dots ``q . C`` [B, N] float32, which
    this overwrites (the [B, N] matrix is the search's largest buffer).
    ``db_sq_norms`` [N] are the dequantized rows' squared norms."""
    if measure not in ASYMMETRIC_MEASURES:
        raise NotImplementedError(f"asymmetric scoring for {measure}")
    q = queries.float()
    f32 = dict(dtype=torch.float32, device=raw_dots.device)
    scale = torch.as_tensor(scale, **f32)
    offset = torch.as_tensor(offset, **f32)
    dots = raw_dots.mul_(scale).add_(offset * q.sum(dim=1, keepdim=True))
    if measure in (DistanceMeasure.DOT_PRODUCT,
                   DistanceMeasure.GENERAL_INNER_PRODUCT):
        return dots.neg_()
    q_sq = squared_norms(q)
    if measure == DistanceMeasure.COSINE:
        denom = q_sq.sqrt()[:, None] * db_sq_norms.sqrt()[None, :]
        sim = torch.where(denom > 0.0, dots / denom.clamp_min(1e-30), 0.0)
        return 1.0 - sim
    # (|q|^2 + |d'|^2) - 2 q.d', as the JAX package orders it (2x is exact)
    d = q_sq[:, None] + db_sq_norms[None, :]
    d.sub_(dots.mul_(2.0)).clamp_min_(0.0)
    return d.sqrt_() if measure == DistanceMeasure.L2 else d


def asymmetric_many_to_many(measure: DistanceMeasure, queries: torch.Tensor,
                            db_codes: torch.Tensor, db_sq_norms: torch.Tensor,
                            scale: Scalar = 1.0, offset: Scalar = 0.0,
                            codes_transposed: bool = False) -> torch.Tensor:
    """[B, N] distances between float32 queries [B, D] and an
    affine-quantized database: ``db_codes`` [N, D] uint8 / bf16 / fp8
    stored codes, or [D, N] uint8 with ``codes_transposed`` (the int8-dots
    kernel); ``db_sq_norms`` [N] of the dequantized rows."""
    if measure not in ASYMMETRIC_MEASURES:
        raise NotImplementedError(f"asymmetric scoring for {measure}")
    q = queries.float()
    if codes_transposed:
        raw = int8_dots(q, db_codes)
    else:
        raw = q @ db_codes.float().T
    return fold_affine(measure, q, raw, db_sq_norms, scale, offset)

"""Anisotropic vector quantization: score-aware PQ training for MIPS
(counterpart of ``scann_tpu/hashes/avq.py``).

The anisotropic loss of Guo et al., "Accelerating Large-Scale Inference with
Anisotropic Vector Quantization" (ICML 2020): quantization error parallel
to the datapoint's direction perturbs the inner products of high-scoring
queries far more than orthogonal error, so it weighs eta >= 1 times more.
With residual r = x - x_tilde and unit direction x_hat:

    loss(x, x_tilde) = ||r||^2 + (eta - 1) * <r, x_hat>^2,
    eta = (d - 1) * T^2 / (1 - T^2)   (T: ScaNN's threshold, e.g. 0.2)

Training alternates two steps:

* code assignment, by exact coordinate descent across subspaces: the
  parallel term couples the subspaces (<r, x_hat> = sum_s <r_s, x_hat_s>),
  so codes change one subspace at a time while the running parallel dot
  t = <r, x_hat> is carried; each step is an [N, C] product and an argmin;
* the centroid update, in closed form: per (subspace, code) with points I

      (|I| * Id + (eta-1) * sum_I x_hat x_hat^T) c
          = sum_I x + (eta-1) * sum_I (<x, x_hat> + t_rest) x_hat

  summed with one ``index_add_`` over the flattened (subspace, code) ids
  and solved as one batched [S*C, d_sub, d_sub] ``torch.linalg.solve``.

On the card ``index_add_`` sums in no fixed order, so the sums (and the
centroids) may differ from run to run in their last bits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def anisotropic_eta(threshold: float, dim: int) -> float:
    """Parallel / orthogonal weight ratio from ScaNN's threshold (Guo et
    al. 2020, Thm 3.3): eta = (d-1) T^2 / (1 - T^2), at least 1."""
    t2 = float(threshold) * float(threshold)
    if not 0.0 < t2 < 1.0:
        raise ValueError(
            f"anisotropic threshold must be in (0, 1), got {threshold}")
    return max((dim - 1) * t2 / (1.0 - t2), 1.0)


def _split_subspaces(x: torch.Tensor, s: int) -> torch.Tensor:
    n, d = x.shape
    return x.reshape(n, s, d // s).transpose(0, 1)          # [S, N, d_sub]


def _assign_pass(xs, hs, centroids, codes, contribs, t, eta):
    """One coordinate-descent sweep over the subspaces, in order.

    xs, hs: [S, N, d_sub]; centroids [S, C, d_sub]; codes, contribs [S, N];
    t [N] the current <r, x_hat>. Returns the updated (codes, contribs, t);
    the first minimum wins, as ``jnp.argmin``."""
    codes, contribs = codes.clone(), contribs.clone()
    for si in range(xs.shape[0]):
        x_s, h_s, c_s = xs[si], hs[si], centroids[si]
        x_sq = (x_s * x_s).sum(dim=-1)                        # [N]
        c_sq = (c_s * c_s).sum(dim=-1)                        # [C]
        d1 = x_sq[:, None] - 2.0 * (x_s @ c_s.T) + c_sq[None, :]
        xh = (x_s * h_s).sum(dim=-1)
        d2 = xh[:, None] - h_s @ c_s.T                        # <x_s - c, h_s>
        t_rest = t - contribs[si]
        score = d1 + (eta - 1.0) * torch.square(d2 + t_rest[:, None])
        new_code = torch.argmin(score, dim=-1)
        new_contrib = torch.gather(d2, 1, new_code[:, None])[:, 0]
        codes[si] = new_code
        contribs[si] = new_contrib
        t = t_rest + new_contrib
    return codes, contribs, t


def _init_assignment(xs, hs, centroids):
    """Plain L2 argmin codes and the contribs / t they imply."""
    c_sq = (centroids * centroids).sum(dim=-1)                # [S, C]
    xc = torch.einsum("snd,scd->snc", xs, centroids)
    x_sq = (xs * xs).sum(dim=-1)                              # [S, N]
    d1 = x_sq[:, :, None] - 2.0 * xc + c_sq[:, None, :]
    codes = torch.argmin(d1, dim=-1)                          # [S, N]
    xh = (xs * hs).sum(dim=-1)
    hc = torch.einsum("snd,scd->snc", hs, centroids)
    d2 = xh[:, :, None] - hc
    contribs = torch.gather(d2, 2, codes[:, :, None])[:, :, 0]
    return codes, contribs, contribs.sum(dim=0)


def _update_centroids(xs, hs, centroids, codes, contribs, t, eta):
    """The closed-form anisotropic centroid update (batched normal
    equations); a code no point took keeps its centroid."""
    s, n, dsub = xs.shape
    c = centroids.shape[1]
    ids = (codes + (torch.arange(s, device=xs.device) * c)[:, None]
           ).reshape(-1)
    t_rest = t[None, :] - contribs                            # [S, N]
    xh = (xs * hs).sum(dim=-1)
    hh = hs[..., :, None] * hs[..., None, :]                  # [S, N, d, d]
    rhs2 = (xh + t_rest)[..., None] * hs
    ones = torch.ones(s, n, 1, dtype=xs.dtype, device=xs.device)
    flat = torch.cat([hh.reshape(s, n, dsub * dsub), xs, rhs2, ones],
                     dim=-1).reshape(s * n, -1)
    sums = torch.zeros(s * c, flat.shape[1], dtype=xs.dtype,
                       device=xs.device).index_add_(0, ids, flat)
    hh_sum = sums[:, :dsub * dsub].reshape(s * c, dsub, dsub)
    x_sum = sums[:, dsub * dsub:dsub * dsub + dsub]
    r2_sum = sums[:, dsub * dsub + dsub:dsub * dsub + 2 * dsub]
    counts = sums[:, -1]
    eye = torch.eye(dsub, dtype=xs.dtype, device=xs.device)
    # the ridge keeps empty codes solvable; their solution is dropped below
    a = counts[:, None, None] * eye + (eta - 1.0) * hh_sum + 1e-6 * eye
    b = x_sum + (eta - 1.0) * r2_sum
    sol = torch.linalg.solve(a, b[..., None])[..., 0].reshape(s, c, dsub)
    keep = (counts.reshape(s, c) > 0.5)[..., None]
    return torch.where(keep, sol, centroids)


def avq_refine(x: torch.Tensor, x_hat: torch.Tensor,
               centroids: torch.Tensor, eta: float, *, iters: int = 8
               ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Refine [S, C, d_sub] centroids under the anisotropic loss.

    ``x`` [N, D]: the vectors to quantize (points, or residuals for
    tree-x-AH); ``x_hat`` [N, D]: the unit direction of the original point
    (normalized ``x`` for a standalone hasher). Returns (centroids, codes
    [N, S] int64, the mean anisotropic loss). ``iters`` rounds of assignment
    + update, then a final assignment."""
    x = x.float()
    s = centroids.shape[0]
    xs = _split_subspaces(x, s)
    hs = _split_subspaces(x_hat.float().to(x.device), s)
    centroids = centroids.float().to(x.device)
    eta = float(eta)
    codes, contribs, t = _init_assignment(xs, hs, centroids)
    for _ in range(int(iters)):
        codes, contribs, t = _assign_pass(xs, hs, centroids, codes,
                                          contribs, t, eta)
        centroids = _update_centroids(xs, hs, centroids, codes, contribs,
                                      t, eta)
    codes, contribs, t = _assign_pass(xs, hs, centroids, codes, contribs, t,
                                      eta)
    r = xs - torch.gather(
        centroids, 1, codes[:, :, None].expand(-1, -1, xs.shape[2]))
    loss = torch.mean((r * r).sum(dim=(0, 2)) + (eta - 1.0) * t * t)
    return centroids, codes.T.contiguous(), float(loss)


def avq_encode(x: torch.Tensor, x_hat: torch.Tensor,
               centroids: torch.Tensor, eta: float, *, passes: int = 2,
               chunk_size: int = 8192) -> torch.Tensor:
    """Score-aware [N, S] int64 codes of ``x`` [N, D] against fixed
    centroids: the plain L2 argmin, then ``passes`` coordinate-descent
    sweeps; ``chunk_size`` rows at a time (rows are independent, so the
    chunking never changes a code)."""
    x = x.float()
    s = centroids.shape[0]
    centroids = centroids.float().to(x.device)
    x_hat = x_hat.float().to(x.device)
    eta = float(eta)
    out = torch.empty(x.shape[0], s, dtype=torch.int64, device=x.device)
    for lo in range(0, x.shape[0], chunk_size):
        xs = _split_subspaces(x[lo:lo + chunk_size], s)
        hs = _split_subspaces(x_hat[lo:lo + chunk_size], s)
        codes, contribs, t = _init_assignment(xs, hs, centroids)
        for _ in range(passes):
            codes, contribs, t = _assign_pass(xs, hs, centroids, codes,
                                              contribs, t, eta)
        out[lo:lo + chunk_size] = codes.T
    return out


def unit_directions(points) -> torch.Tensor:
    """[N, D] -> unit rows, float32 (zero rows stay zero: their
    anisotropic term vanishes and the loss is plain reconstruction)."""
    p = torch.as_tensor(np.asarray(points, np.float32)) if not isinstance(
        points, torch.Tensor) else points.float()
    norms = torch.sqrt((p * p).sum(dim=-1, keepdim=True))
    return p / norms.clamp_min(1e-30)

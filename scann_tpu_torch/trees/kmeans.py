"""K-means clustering on the device (counterpart of
``scann_tpu/trees/kmeans.py``).

  - assignment: chunked distance matmul [chunk, K] + argmin, with the chunk
    bounded so the [chunk, K] block stays near 1 GB at any K;
  - update: per-cluster sums of the bf16-rounded rows accumulated in float32
    (the JAX package's one-hot bf16 contraction, ``trees/kmeans.py:201-205``,
    computes exactly these sums) + count division; an empty cluster i is
    reseeded to ``data[i % n]``;
  - init: k-means++ for k <= ``KMEANS_PP_MAX_K``, random rows above it, or
    PROVIDED centers;
  - convergence: relative inertia change < threshold, checked before the
    update step.

Randomness comes from an explicit ``torch.Generator`` seeded with
``seed + restart``; it gives other bits than ``jax.random`` with the same
seed, so builds agree with the JAX package in quality, not in centroid bits.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


class KMeansInit(enum.Enum):
    RANDOM = "Random"
    KMEANS_PLUS_PLUS = "KMeansPlusPlus"
    PROVIDED = "Provided"


@dataclasses.dataclass
class KMeansConfig:
    num_clusters: int = 10
    max_iterations: int = 100
    convergence_threshold: float = 1e-5
    init_method: KMeansInit = KMeansInit.KMEANS_PLUS_PLUS
    seed: Optional[int] = None
    num_restarts: int = 1


@dataclasses.dataclass
class KMeansResult:
    centers: torch.Tensor        # [K, D] float32, on the fit's device
    assignments: torch.Tensor    # [N] int64
    cluster_sizes: torch.Tensor  # [K] int64
    inertia: float
    num_iterations: int
    converged: bool


# k-means++ is sequential over k; above this k, random init plus Lloyd
# refinement reaches the same quality regime at far lower build cost
KMEANS_PP_MAX_K = 256


def adaptive_row_chunk(chunk_size: int, n: int, k: int,
                       cap_elems: int = 200_000_000) -> int:
    """Rows per chunk such that the [chunk, K] distance block stays near
    ~1 GB whatever K is."""
    c = min(chunk_size, max(n, 1), max(cap_elems // max(k, 1), 4096))
    return max(256, (c // 256) * 256) if c >= 256 else c


def _assign_chunk(x: torch.Tensor, centers: torch.Tensor,
                  c_sq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dist = ((x * x).sum(dim=1)[:, None] + c_sq[None, :]
            - 2.0 * (x @ centers.T)).clamp_min(0.0)
    md, a = dist.min(dim=1)
    return a, md


def assign_clusters(data: torch.Tensor, centers: torch.Tensor,
                    chunk_size: int = 65536
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(assignments [N] int64, min squared distance [N] float32)."""
    n = data.shape[0]
    chunk = adaptive_row_chunk(chunk_size, n, centers.shape[0])
    c_sq = (centers * centers).sum(dim=1)
    a_out = torch.empty(n, dtype=torch.int64, device=data.device)
    d_out = torch.empty(n, dtype=torch.float32, device=data.device)
    for lo in range(0, n, chunk):
        a_out[lo:lo + chunk], d_out[lo:lo + chunk] = _assign_chunk(
            data[lo:lo + chunk], centers, c_sq)
    return a_out, d_out


def lloyd_step(data: torch.Tensor, centers: torch.Tensor,
               chunk_size: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd's iteration: (new centers [K, D], inertia of ``centers``
    as a 0-d float32 tensor)."""
    n, d = data.shape
    k = centers.shape[0]
    chunk = adaptive_row_chunk(chunk_size, n, k)
    c_sq = (centers * centers).sum(dim=1)
    sums = torch.zeros(k, d, dtype=torch.float32, device=data.device)
    counts = torch.zeros(k, dtype=torch.float32, device=data.device)
    inertia = torch.zeros((), dtype=torch.float32, device=data.device)
    for lo in range(0, n, chunk):
        x = data[lo:lo + chunk]
        a, md = _assign_chunk(x, centers, c_sq)
        sums.index_add_(0, a, x.to(torch.bfloat16).float())
        counts += torch.bincount(a, minlength=k).float()
        inertia += md.sum()
    means = sums / counts.clamp_min(1.0)[:, None]
    reseed = data[torch.arange(k, device=data.device) % n]
    return torch.where((counts > 0)[:, None], means, reseed), inertia


def _random_init(data: torch.Tensor, k: int,
                 gen: torch.Generator) -> torch.Tensor:
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data[perm[:k]]


def _kmeans_pp_init(data: torch.Tensor, k: int,
                    gen: torch.Generator) -> torch.Tensor:
    """First center uniform, then sample proportional to the squared
    distance to the nearest chosen center; uniform when all distances are
    zero (duplicate points). No host sync inside the loop."""
    n, d = data.shape
    centers = torch.empty(k, d, dtype=torch.float32, device=data.device)
    first = torch.randint(n, (1,), generator=gen, device=data.device)
    c = data[first]                                     # [1, D]
    centers[0] = c[0]
    min_d = ((data - c) ** 2).sum(dim=1)
    for i in range(1, k):
        w = torch.where(min_d.sum() > 0, min_d, torch.ones_like(min_d))
        c = data[torch.multinomial(w, 1, generator=gen)]
        centers[i] = c[0]
        min_d = torch.minimum(min_d, ((data - c) ** 2).sum(dim=1))
    return centers


def kmeans_fit_device(data: torch.Tensor, gen: torch.Generator, *, k: int,
                      max_iterations: int, convergence_threshold: float,
                      init_method: KMeansInit,
                      init_centers: Optional[torch.Tensor] = None):
    """One k-means run: (centers, assignments, counts, inertia, iterations,
    converged). The host reads the inertia each iteration to apply the
    reference's convergence rule (break before the update)."""
    if init_centers is not None:
        centers = init_centers.float()
    elif init_method == KMeansInit.RANDOM or k > KMEANS_PP_MAX_K:
        centers = _random_init(data, k, gen)
    else:
        centers = _kmeans_pp_init(data, k, gen)

    prev_inertia = float("inf")
    converged = False
    iters = 0
    for it in range(max_iterations):
        iters = it + 1
        new_centers, inertia_dev = lloyd_step(data, centers)
        inertia = float(inertia_dev)
        rel = (abs(prev_inertia - inertia) / (prev_inertia + 1e-10)
               if prev_inertia != float("inf") else float("inf"))
        if rel < convergence_threshold:
            converged = True
            break
        prev_inertia = inertia
        centers = new_centers

    assignments, min_d = assign_clusters(data, centers)
    counts = torch.bincount(assignments, minlength=k)
    return centers, assignments, counts, float(min_d.sum()), iters, converged


class KMeans:
    """Restarts around :func:`kmeans_fit_device`, keeping the best-inertia
    run. Runs on ``device``."""

    def __init__(self, config: Optional[KMeansConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or KMeansConfig()
        self.device = torch.device(device)

    @classmethod
    def with_clusters(cls, k: int,
                      device: Union[str, torch.device] = DEFAULT_DEVICE
                      ) -> "KMeans":
        """k clusters, every other setting at its default."""
        return cls(KMeansConfig(num_clusters=k), device=device)

    def fit(self, data, init_centers=None) -> KMeansResult:
        x = torch.as_tensor(data, dtype=torch.float32,
                            device=require_device(self.device))
        n = x.shape[0]
        if n == 0:
            raise ScannError.invalid_argument("Cannot cluster empty dataset")
        cfg = self.config
        k = min(cfg.num_clusters, n)
        if k <= 0:
            raise ScannError.invalid_argument("Number of clusters must be > 0")
        if cfg.init_method == KMeansInit.PROVIDED and init_centers is None:
            raise ScannError.invalid_argument(
                "Provided initialization requires initial centers")
        if init_centers is not None:
            init_centers = torch.as_tensor(init_centers, dtype=torch.float32,
                                           device=self.device)
            if tuple(init_centers.shape) != (k, x.shape[1]):
                raise ScannError.invalid_argument(
                    f"init_centers shape {tuple(init_centers.shape)} != "
                    f"({k}, {x.shape[1]})")
        seed = (cfg.seed if cfg.seed is not None
                else np.random.SeedSequence().entropy % (2**31))

        best = None
        for restart in range(max(cfg.num_restarts, 1)):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed) + restart)
            centers, assignments, counts, inertia, iters, converged = \
                kmeans_fit_device(
                    x, gen, k=k, max_iterations=cfg.max_iterations,
                    convergence_threshold=float(cfg.convergence_threshold),
                    init_method=cfg.init_method, init_centers=init_centers)
            if best is None or inertia < best.inertia:
                best = KMeansResult(centers=centers, assignments=assignments,
                                    cluster_sizes=counts, inertia=inertia,
                                    num_iterations=iters, converged=converged)
        return best

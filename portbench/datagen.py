"""Seeded rows and queries at a configuration's published shape.

A frozen copy of the Gaussian mixture that ``chip_smoke.py`` draws on the
host (centres N(0, spread^2), each row a centre plus N(0, noise^2) noise,
queries drawn the same way), moved to the device and keyed by the run's
seed: one ``torch.Generator`` on the device, a few large calls. The same
seed gives the same rows and queries; every seed gives the same sizes.
"""

from __future__ import annotations

from typing import Tuple

import torch

# torch.Generator takes seeds in [0, 2**64)
_SEED_MOD = 1 << 64


def mixture(data: dict, seed: int, device: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows [rows, dim], queries [queries, dim]) float32 on ``device``
    from ``data`` of kind "gaussian_mixture": its ``rows``, ``dim``,
    ``clusters``, ``spread``, ``noise``, ``queries`` and ``normalize``
    (unit rows and queries, for angular data)."""
    if data.get("kind") != "gaussian_mixture":
        raise ValueError(f"no generator for data of kind {data.get('kind')}")
    n, d, c = int(data["rows"]), int(data["dim"]), int(data["clusters"])
    q = int(data["queries"])
    spread, noise = float(data["spread"]), float(data["noise"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % _SEED_MOD)
    centers = torch.randn(c, d, generator=gen, device=device) * spread
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    rows = torch.randn(n, d, generator=gen, device=device)
    rows.mul_(noise).add_(centers[labels])
    del labels
    q_labels = torch.randint(0, c, (q,), generator=gen, device=device)
    queries = torch.randn(q, d, generator=gen, device=device)
    queries.mul_(noise).add_(centers[q_labels])
    if data.get("normalize", False):
        rows.div_(rows.norm(dim=1, keepdim=True).clamp_min(1e-30))
        queries.div_(queries.norm(dim=1, keepdim=True).clamp_min(1e-30))
    return rows, queries

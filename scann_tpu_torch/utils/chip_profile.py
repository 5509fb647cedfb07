"""Per-card performance profile behind ``Scann.auto()``'s crossovers
(counterpart of ``scann_tpu/utils/chip_profile.py``).

``auto_config`` chooses an architecture from two measured constants: the N
where the block sweep, whose batch cost grows linearly in N, loses to
tree-x-AH, whose cost stays about flat, and the bytes of float32 re-rank
rows past which the re-rank copy goes to bfloat16. Both are properties of
the card, not of the library. The profile is JSON in the JAX package's
format (a file written by either package loads in the other); it defaults
to this port's own measurement on an H100, is overridden per deployment by
``SCANN_TPU_TORCH_CHIP_PROFILE=/path.json`` (a separate variable from the
JAX package's, so a TPU deployment's profile never sets the card's
crossovers), and is re-measured on the current card by :func:`calibrate`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import numpy as np
import torch

from scann_tpu_torch.types import DEFAULT_DEVICE, require_device

PROFILE_ENV = "SCANN_TPU_TORCH_CHIP_PROFILE"


@dataclasses.dataclass
class ChipProfile:
    """Measured constants that set ``auto_config``'s crossovers. The
    defaults are :func:`calibrate`'s result on the card ``source`` names,
    printed by ``chip_smoke.py`` phase 35."""

    # N above which the block sweep's batch costs more than tree-x-AH's
    sweep_max_n: int = 1_504_749
    # float32 re-rank bytes (N * dim * 4) above which auto() stores the
    # re-rank rows in bfloat16: a third of the card's memory
    f32_rerank_max_bytes: int = 28_339_164_501
    # points per partition of auto()'s tree-x-AH builds: a property of the
    # k-means builds the JAX package converged to (1.18M / 2000, 5M / 8000,
    # 10M / 16000 partitions), not a time or a size on the card
    partition_density: int = 600
    # where the numbers come from
    source: str = (
        "calibrate() on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py "
        "phase 35): chained 2-pt n_probe=200000/800000 dim=100 B=1024 "
        "a=0.48ms b=0.864ns/pt t_tree=1.78ms fit=1504749 "
        "hbm_cap=83898842; sweep_max_n floored at n_big=800000")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ChipProfile":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


_cached: Optional[ChipProfile] = None


def load_profile(path: Optional[str] = None) -> ChipProfile:
    """Profile from ``path`` / $SCANN_TPU_TORCH_CHIP_PROFILE / the
    defaults."""
    global _cached
    path = path or os.environ.get(PROFILE_ENV)
    if path:
        with open(path) as f:
            return ChipProfile.from_json(f.read())
    if _cached is None:
        _cached = ChipProfile()
    return _cached


def save_profile(profile: ChipProfile, path: str) -> None:
    with open(path, "w") as f:
        f.write(profile.to_json())


@dataclasses.dataclass
class Calibration:
    """What :func:`measure_calibration` measured, and the profile that
    follows from it (:meth:`profile`). Times are seconds a batch."""

    device_name: str
    n_probe: int
    n_big: int
    dim: int
    batch: int
    t_small: float        # block sweep at n_probe
    t_big: float          # block sweep at n_big
    t_tree: float         # tree-x-AH at n_big
    a: float              # the sweep's fixed cost
    b: float              # the sweep's seconds a row
    bytes_per_point: int  # the sweep's two serving copies, bytes a row
    hbm_bytes: int
    n_fit: int            # where a + b * N reaches t_tree
    n_hbm: int            # rows whose two copies fill 60% of the memory

    @property
    def sweep_max_n(self) -> int:
        """min(n_fit, n_hbm), never below n_big: below n_big the fit is
        extrapolated past the points it was measured at."""
        return max(min(self.n_fit, self.n_hbm), self.n_big)

    def profile(self) -> ChipProfile:
        return ChipProfile(
            sweep_max_n=self.sweep_max_n,
            f32_rerank_max_bytes=self.hbm_bytes // 3,
            source=(f"calibrate() on {self.device_name}: chained 2-pt "
                    f"n_probe={self.n_probe}/{self.n_big} dim={self.dim} "
                    f"B={self.batch} a={self.a * 1e3:.2f}ms "
                    f"b={self.b * 1e9:.3f}ns/pt "
                    f"t_tree={self.t_tree * 1e3:.2f}ms fit={self.n_fit} "
                    f"hbm_cap={self.n_hbm}; sweep_max_n floored at "
                    f"n_big={self.n_big}"))


def measure_calibration(n_probe: int = 200_000, dim: int = 100,
                        batch: int = 1024, seed: int = 0,
                        hbm_bytes: Optional[int] = None,
                        device: Union[str, torch.device] = DEFAULT_DEVICE,
                        iters: int = 20, rounds: int = 5) -> Calibration:
    """The measurement behind :func:`calibrate`.

      1. time ``BlockSweepSearcher(BlockSweepConfig(block_r=64,
         pre_reorder_k=100)).search_batched_tensors`` at ``n_probe`` and
         ``4 * n_probe`` rows with :func:`~scann_tpu_torch.utils.
         benchmarking.chained` (``rounds`` chains of ``iters`` calls at
         each size, the sizes in turns, the best chain of each) and fit its
         batch cost as ``a + b * N``; the configured ``block_r`` is the one
         that runs (the searcher's own call routes the sweep);
      2. time the tree-x-AH searcher at ``4 * n_probe`` (N / 600
         partitions, 16-code PQ at about two dimensions a subspace; p=10,
         pre_k=150), whose cost is about flat in N at fixed (p, l_cap);
      3. the crossover is ``(t_tree - a) / b``, capped where the sweep's two
         serving copies (the augmented bf16 copy, as the probe searcher's
         ``memory_usage()`` counts it, plus the float32 rows) fill 60% of
         the card's memory, and floored at ``4 * n_probe``.

    Only the slope ``b`` carries the linear-in-N term: at small N the fixed
    cost ``a`` dominates both searchers, so a one-point ratio would
    extrapolate a crossover near ``n_probe`` (the JAX package's finding,
    ``scann_tpu/utils/chip_profile.py:114-120``). At these sizes the block
    sweep's batch is host-bound on an H100 (a wall-clock chain read 1.29 ms
    at 200,000 rows and 1.22 ms at 800,000: no slope), so ``chained``
    times the device's work, the chain queued while the stream waits; the
    best of several chains, the sizes in turns, keeps drift off the
    slope.

    ``hbm_bytes`` defaults to the CUDA device's total memory; on the CPU it
    must be given."""
    from scann_tpu_torch.data.dataset import DenseDataset
    from scann_tpu_torch.hashes.hasher import AsymmetricHasherConfig
    from scann_tpu_torch.models.block_sweep import (
        BlockSweepConfig,
        BlockSweepSearcher,
    )
    from scann_tpu_torch.models.searcher import SearchParameters
    from scann_tpu_torch.models.tree_x_hybrid import (
        TreeXHybridConfig,
        TreeXHybridSearcher,
    )
    from scann_tpu_torch.utils.benchmarking import chained

    device = require_device(device)
    if hbm_bytes is None:
        if device.type != "cuda":
            raise ValueError("calibrate on a non-CUDA device needs hbm_bytes")
        hbm_bytes = int(torch.cuda.get_device_properties(device).total_memory)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    rng = np.random.default_rng(seed)
    n_big = 4 * n_probe
    db = rng.standard_normal((n_big, dim), dtype=np.float32)
    q = torch.from_numpy(
        rng.standard_normal((batch, dim), dtype=np.float32)).to(device)

    def sweep(n):
        s = BlockSweepSearcher(DenseDataset(db[:n]), BlockSweepConfig(
            block_r=64, pre_reorder_k=100), device=device)
        aug = s.device_state()[0]
        return s, s.memory_usage() // aug.shape[0] + 4 * dim

    (small, _), (big, row_bytes) = sweep(n_probe), sweep(n_big)
    t1 = t2 = float("inf")
    for _ in range(rounds):
        # the two sizes in turns, so drift of the host's speed falls on both
        for s, which in ((small, 0), (big, 1)):
            t = chained(lambda qq: s.search_batched_tensors(qq, 10)[::-1],
                        (q,), iters=iters, rounds=1)
            t1, t2 = (min(t1, t), t2) if which == 0 else (t1, min(t2, t))
    del small, big
    b = max((t2 - t1) / max(n_big - n_probe, 1), 1e-12)
    a = max(t1 - b * n_probe, 0.0)

    subs = min((s for s in range(1, dim + 1) if dim % s == 0),
               key=lambda s: (abs(dim / s - 2), -s))
    tree = TreeXHybridSearcher(TreeXHybridConfig(
        num_partitions=max(n_big // 600, 16), partitions_to_search=10,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=subs, seed=seed, max_iterations=8)),
        device=device).build(DenseDataset(db))
    params = SearchParameters(num_leaves_to_search=10,
                              pre_reordering_num_neighbors=150)
    t_tree = chained(
        lambda qq: tree.search_batched_tensors(qq, 10, params)[::-1], (q,),
        iters=iters, rounds=rounds)

    n_hbm = int(0.6 * hbm_bytes / row_bytes)
    n_fit = int((t_tree - a) / b) if t_tree > a else n_big
    return Calibration(
        device_name=name, n_probe=n_probe, n_big=n_big, dim=dim, batch=batch,
        t_small=t1, t_big=t2, t_tree=t_tree, a=a, b=b,
        bytes_per_point=int(row_bytes), hbm_bytes=int(hbm_bytes),
        n_fit=n_fit, n_hbm=n_hbm)


def calibrate(n_probe: int = 200_000, dim: int = 100,
              batch: int = 1024, seed: int = 0,
              hbm_bytes: Optional[int] = None,
              verbose: bool = False,
              device: Union[str, torch.device] = DEFAULT_DEVICE
              ) -> ChipProfile:
    """Re-measure the crossover constants on ``device``
    (:func:`measure_calibration`). Builds two sweep copies and one tree-x-AH
    index at ``4 * n_probe`` rows. Returns a ChipProfile, not saved (pass it
    to :func:`save_profile`)."""
    cal = measure_calibration(n_probe, dim, batch, seed, hbm_bytes, device)
    prof = cal.profile()
    if verbose:
        print(f"calibrate: sweep a={cal.a * 1e3:.2f}ms "
              f"b={cal.b * 1e9:.3f}ns/pt (t({cal.n_probe})="
              f"{cal.t_small * 1e3:.2f}ms t({cal.n_big})="
              f"{cal.t_big * 1e3:.2f}ms) t_tree={cal.t_tree * 1e3:.2f}ms -> "
              f"fit {cal.n_fit:,}, hbm cap {cal.n_hbm:,} -> "
              f"sweep_max_n={prof.sweep_max_n:,}", flush=True)
    return prof

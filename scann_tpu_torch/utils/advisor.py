"""Build-knob advisor: index-build knobs from cheap data statistics
(counterpart of ``scann_tpu/utils/advisor.py``).

The lever on skewed data is partition-mass skew: Zipf-like cluster mass
lowers tree-x-AH recall at a given p and widens the largest partition
(l_cap), and SOAR secondary assignments are the mitigation. The reference
leaves each of these knobs to its user.

``advise_build`` clusters a small sample on the device, measures the mass
skew and returns the tree-x-AH build knobs (SOAR on or off, partition
count, balance cap); ``advise_config`` composes them with the chip
profile's crossover into a full ScannConfig, the path ``Scann.auto()``
takes. The rules and thresholds are the JAX package's (each cites its
line there); the port measures none of them anew.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.types import DEFAULT_DEVICE, align_up


@dataclasses.dataclass
class DataStats:
    """Cheap sample statistics that drive the build knobs."""

    n_sample: int
    n_clusters: int
    # fraction of the sample's mass in the top 10% of clusters (0.1 =
    # uniform)
    top_decile_mass: float
    # largest cluster mass / mean cluster mass (1.0 = uniform)
    max_over_mean: float
    # coefficient of variation of the point norms (heavy-tailed norms)
    norm_cv: float

    @property
    def skewed(self) -> bool:
        """The JAX package's cut (``scann_tpu/utils/advisor.py:44-54``):
        k-means over-segmentation inflates the mass statistics even on
        uniform-mass data, so the mass cuts sit above that floor, and the
        norm spread, which over-segmentation does not inflate, triggers on
        its own."""
        return (self.top_decile_mass > 0.26 or self.max_over_mean > 4.5
                or self.norm_cv > 0.25)


def dataset_stats(sample: np.ndarray, n_clusters: Optional[int] = None,
                  seed: int = 0,
                  device: Union[str, torch.device] = DEFAULT_DEVICE
                  ) -> DataStats:
    """Cluster ``sample`` (a few thousand rows) on ``device`` with k-means++
    (20 iterations) and measure its mass skew. The cluster count defaults
    to sample size / 50 in [8, 256], so a cluster averages about 50 points.
    The port's k-means draws its start from a ``torch.Generator``, so the
    cluster sizes are not the JAX package's bits; the decisions agree."""
    from scann_tpu_torch.trees.kmeans import KMeans, KMeansConfig, KMeansInit

    sample = np.asarray(sample, np.float32)
    n = len(sample)
    if n < 64:
        return DataStats(n, 1, 0.1, 1.0, 0.0)
    k = n_clusters or max(min(n // 50, 256), 8)
    res = KMeans(KMeansConfig(
        num_clusters=k, max_iterations=20, seed=seed,
        init_method=KMeansInit.KMEANS_PLUS_PLUS), device=device).fit(sample)
    sizes = np.sort(res.cluster_sizes.cpu().numpy().astype(np.float64))[::-1]
    mass = sizes / max(sizes.sum(), 1.0)
    top_dec = float(mass[: max(len(mass) // 10, 1)].sum())
    max_over_mean = float(sizes[0] / max(sizes.mean(), 1e-9))
    norms = np.linalg.norm(sample, axis=1)
    norm_cv = float(norms.std() / max(norms.mean(), 1e-9))
    return DataStats(n, k, top_dec, max_over_mean, norm_cv)


@dataclasses.dataclass
class BuildAdvice:
    num_partitions: int
    spilling: bool           # SOAR secondary assignments
    spilling_mode: str
    max_partition_size: object   # "auto" = 1.5x-mean cap
    split_stragglers: bool
    partitions_to_search: int
    pre_reorder_k: int
    stats: DataStats

    def apply_to(self, cfg) -> None:
        """Write the knobs into a TreeXHybridConfig in place."""
        cfg.num_partitions = self.num_partitions
        cfg.partitions_to_search = self.partitions_to_search
        cfg.spilling = self.spilling
        cfg.spilling_mode = self.spilling_mode
        cfg.max_partition_size = self.max_partition_size
        cfg.split_stragglers = self.split_stragglers


def advise_build(n: int, dim: int, sample: np.ndarray,
                 target_recall: Optional[float] = None,
                 seed: int = 0,
                 stats: Optional[DataStats] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE
                 ) -> BuildAdvice:
    """Tree-x-AH build knobs from data statistics, by the JAX package's
    rules (``scann_tpu/utils/advisor.py:106-151``):

    - the partition count follows the profile's ``partition_density``;
    - SOAR turns on when the sample's cluster mass is skewed or the recall
      target is >= 0.99;
    - the balance cap and the straggler split stay on;
    - on skewed data ``partitions_to_search`` is a fraction of the
      partition count, not a constant (recall at a matched probe fraction
      holds across scales): 1.5% for a target >= 0.99, 0.6% for >= 0.97,
      0.4% below, at least 30; otherwise p=10, pre_k=150.
    """
    from scann_tpu_torch.utils.chip_profile import load_profile

    prof = load_profile()
    if stats is None:
        stats = dataset_stats(sample, seed=seed, device=device)
    dens = max(int(prof.partition_density), 1)
    parts = int(min(max(256, round(n / dens / 256) * 256), 65536))
    if n < 256 * dens:
        parts = max(n // dens, 16)
    want_soar = stats.skewed or (target_recall is not None
                                 and target_recall >= 0.99)
    if want_soar:
        tr = 0.99 if target_recall is None else target_recall
        frac = 0.015 if tr >= 0.99 else 0.006 if tr >= 0.97 else 0.004
        p = max(30, int(np.ceil(frac * parts)))
        pre_k = max(300, int(np.ceil(p * 10 / 3)))
    else:
        p, pre_k = 10, 150
    return BuildAdvice(
        num_partitions=parts,
        spilling=want_soar,
        spilling_mode="soar",
        max_partition_size="auto",
        split_stragglers=True,
        partitions_to_search=p,
        pre_reorder_k=pre_k,
        stats=stats,
    )


def compact_sweep_bytes_per_row(dim: int) -> int:
    """Card bytes a row of the skew route's block sweep takes in this port:
    the int8 augmented sweep copy (``dim`` codes and three norm digits,
    8-aligned: ``ops/sweep.build_int8_augmented_db``) plus the bfloat16
    re-rank rows. Sweep rows pad to the q-major step, so ``memory_usage()``
    of such a searcher is N times this where N is a multiple of it."""
    return align_up(dim + 3, 8) + 2 * dim


def advise_config(n: int, dim: int, sample: np.ndarray,
                  measure: DistanceMeasure = DistanceMeasure.SQUARED_L2,
                  target_recall: Optional[float] = None,
                  seed: int = 0,
                  device: Union[str, torch.device] = DEFAULT_DEVICE):
    """Full ScannConfig from scale, data statistics and the chip profile:
    ``auto_config``'s architecture with the data-dependent knobs set from
    the sample statistics (``scann_tpu/utils/advisor.py:158-213``).

    Skewed data between ``sweep_max_n`` and the sweep's memory ceiling goes
    to the block sweep with compact copies (int8 sweep rows, bfloat16
    re-rank rows): the sweep streams every row, so its recall does not
    depend on the cluster mass, while tree-x-AH needs a wide probe there.
    The ceiling is where those copies fill half of the card's memory (three
    times ``f32_rerank_max_bytes``), at :func:`compact_sweep_bytes_per_row`
    a row; past it the tree is the only choice that fits."""
    from scann_tpu_torch.config import ScannConfig
    from scann_tpu_torch.models.scann import auto_config
    from scann_tpu_torch.utils.chip_profile import load_profile

    stats = dataset_stats(sample, seed=seed, device=device)
    cfg = auto_config(n, dim, measure)
    skew_sweep = False
    if cfg.brute_force is None and stats.skewed:
        hbm = 3 * load_profile().f32_rerank_max_bytes
        ceil_n = int(0.5 * hbm / compact_sweep_bytes_per_row(dim))
        if n <= ceil_n:
            cfg = ScannConfig(distance_measure=measure)
            cfg.with_brute_force()
            cfg.brute_force.block_sweep = True
            cfg.brute_force.block_sweep_dtype = "int8"
            skew_sweep = True
    if cfg.brute_force is not None:
        # the sweep streams everything: the knobs that matter are the
        # re-rank depth and, for >= 0.99 targets, top2, which lifts the
        # one-candidate-per-block ceiling
        cfg.brute_force.block_sweep_top2 = (target_recall or 0) >= 0.99
        cfg.with_reordering()
        cfg.exact_reordering.num_candidates = (
            100 if (target_recall or 0) >= 0.99 else 64)
        if skew_sweep:
            # the ceiling above assumed bfloat16 re-rank rows
            cfg.exact_reordering.rerank_dtype = "bfloat16"
        return cfg
    adv = advise_build(n, dim, sample, target_recall, seed=seed,
                       stats=stats, device=device)
    cfg.partitioning.num_partitions = adv.num_partitions
    cfg.partitioning.num_partitions_to_search = adv.partitions_to_search
    cfg.partitioning.spilling = adv.spilling
    cfg.partitioning.spilling_mode = adv.spilling_mode
    cfg.partitioning.max_partition_size = adv.max_partition_size
    cfg.partitioning.split_stragglers = adv.split_stragglers
    cfg.exact_reordering.num_candidates = adv.pre_reorder_k
    return cfg

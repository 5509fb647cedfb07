"""ANN-Benchmarks-style evaluation harness (counterpart of
``scann_tpu/harness/ann_benchmark.py``).

Mirror of the reference's ``ann_benchmark`` binary: loads an
ANN-Benchmarks JSON (``{"train": [[..]], "test": [[..]], "neighbors":
[[..]]}``) or HDF5 file from a local path, or generates a seeded synthetic
dataset with exact ground truth, builds the configured index through the
``Scann`` facade on ``--device`` (the CUDA device by default), times the
search phase and prints a JSON report with build seconds, search seconds,
QPS, recall@k and memory. The report has the JAX harness's keys.

Departures from the reference, as in the JAX harness: queries run in
batches (``--batch-size``); memory is the host RSS delta plus the index's
device bytes.

Run: ``python -m scann_tpu_torch.harness.ann_benchmark --algorithm tree-ah
...`` (``--device cpu`` on a host without a CUDA device).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional, Union

import numpy as np
import torch

from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


@dataclasses.dataclass
class BenchmarkData:
    train: np.ndarray   # [N, D] f32
    test: np.ndarray    # [Q, D] f32
    gt: np.ndarray      # [Q, k] int32
    source: str
    dimension: int


@dataclasses.dataclass
class BenchmarkReport:
    """The JAX harness's report, field for field."""

    dataset: str
    algorithm: str
    distance: str
    k: int
    train_size: int
    test_size: int
    dimension: int
    build_seconds: float
    search_seconds: float
    qps: float
    recall_at_k: float
    index_rss_delta_bytes: Optional[int] = None
    index_device_bytes: Optional[int] = None
    batch_size: Optional[int] = None
    # wall-clock QPS includes each batch's host-to-device round trip; these
    # fields tell a reader how much of the search time that floor explains
    timing_mode: str = "wall_clock_per_batch_dispatch"
    host_roundtrip_seconds: Optional[float] = None
    dispatch_bound_fraction: Optional[float] = None
    # --autotune-target provenance (None when tuning was not requested)
    autotune_target: Optional[float] = None
    autotune_target_met: Optional[bool] = None
    autotune_sample_recall: Optional[float] = None
    autotune_seconds: Optional[float] = None
    autotuned_num_leaves_to_search: Optional[int] = None
    autotuned_pre_reordering_num_neighbors: Optional[int] = None
    # --shards N: served through the database-sharded wrappers on an
    # N-device mesh (None/1 = single device)
    shards: Optional[int] = None
    # --save-index / --load-index provenance: when loaded, build_seconds is
    # the load time, not a training run
    index_loaded_from: Optional[str] = None
    index_saved_to: Optional[str] = None
    index_save_seconds: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def current_rss_bytes() -> Optional[int]:
    """Resident bytes of this process (the reference reads
    /proc/self/statm)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def measure_host_roundtrip_seconds(
        rounds: int = 7,
        device: Union[str, torch.device] = DEFAULT_DEVICE) -> float:
    """Median wall-clock of one trivial op on ``device`` plus the
    ``.item()`` that fetches its result: the per-batch overhead floor every
    wall-clock QPS row pays."""
    x = torch.zeros(8, dtype=torch.float32, device=require_device(device))
    (x + 1.0)[0].item()
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        (x + 1.0)[0].item()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _measure_for(name: str):
    from scann_tpu_torch.ops.distances import DistanceMeasure

    return {"squared-l2": DistanceMeasure.SQUARED_L2,
            "l2": DistanceMeasure.L2,
            "cosine": DistanceMeasure.COSINE,
            "dot-product": DistanceMeasure.DOT_PRODUCT}[name]


def exact_ground_truth(train: np.ndarray, queries: np.ndarray, k: int,
                       batch: int = 256, distance: str = "squared-l2",
                       device: Union[str, torch.device] = DEFAULT_DEVICE
                       ) -> np.ndarray:
    """Exact ids from the port's brute-force searcher on ``device`` under
    the benchmarked distance measure."""
    from scann_tpu_torch.data.dataset import DenseDataset
    from scann_tpu_torch.models.brute_force import BruteForceSearcher

    s = BruteForceSearcher(DenseDataset(train), _measure_for(distance),
                           device=device)
    out = []
    for i in range(0, len(queries), batch):
        idx, _ = s.search_batched_arrays(queries[i : i + batch], k)
        out.append(idx)
    return np.concatenate(out, axis=0).astype(np.int32)


def generate_synthetic_dataset(
        train_size: int = 10_000, test_size: int = 200, dim: int = 64,
        k: int = 10, seed: int = 42, clustered: bool = False,
        distance: str = "squared-l2",
        device: Union[str, torch.device] = DEFAULT_DEVICE) -> BenchmarkData:
    """Seeded synthetic data: uniform [0, 1) like the reference, or
    clustered (Gaussian centres scaled by 3, unit noise, a centre every
    500 rows, at least 8) for partition-friendly regimes.

    Drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``, as
    the JAX harness draws with ``jax.random`` on its device (a host draw of
    10^8 variates is slow); so the bits differ from the JAX harness's for
    the same seed, and between a CUDA device and the CPU."""
    device = require_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    if clustered:
        n_clusters = max(train_size // 500, 8)
        centers = normal(n_clusters, dim) * 3.0
        a = torch.randint(0, n_clusters, (train_size,), generator=gen,
                          device=device)
        train = centers[a] + normal(train_size, dim)
        aq = torch.randint(0, n_clusters, (test_size,), generator=gen,
                           device=device)
        test = centers[aq] + normal(test_size, dim)
        source = f"synthetic_clustered_n{train_size}_q{test_size}_d{dim}"
    else:
        train = torch.rand((train_size, dim), generator=gen, device=device)
        test = torch.rand((test_size, dim), generator=gen, device=device)
        source = f"synthetic_n{train_size}_q{test_size}_d{dim}"
    train = train.cpu().numpy()
    test = test.cpu().numpy()
    gt = exact_ground_truth(train, test, k, distance=distance, device=device)
    return BenchmarkData(train, test, gt, source, dim)


def generate_adversarial_dataset(
        train_size: int, test_size: int, dim: int, k: int, seed: int = 42,
        distance: str = "squared-l2", zipf_s: float = 1.07,
        aniso_sigma: float = 0.6, norm_sigma: float = 0.35,
        device: Union[str, torch.device] = DEFAULT_DEVICE) -> BenchmarkData:
    """Skewed synthetic data shaped like GloVe embeddings:

    - **Zipf cluster mass**: p_i proportional to (i+1)^-zipf_s;
    - **anisotropic covariance**: per-cluster, per-axis log-normal scales
      (sigma ``aniso_sigma``) before a global rotation;
    - **correlated dimensions**: one random orthogonal mixing matrix for
      every point;
    - **heavy-tailed norms**: a per-point log-normal radial factor (sigma
      ``norm_sigma``).

    Queries come from the same mixture. The draws are host numpy in the JAX
    harness's order, so the rows are bit-equal to its; only the exact
    ground truth runs on ``device``."""
    rng = np.random.default_rng(seed)
    n_clusters = max(train_size // 500, 64)
    p = (np.arange(1, n_clusters + 1, dtype=np.float64)) ** (-zipf_s)
    p /= p.sum()
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3.0
    scales = np.exp(rng.standard_normal((n_clusters, dim)) * aniso_sigma
                    ).astype(np.float32)
    rot = np.linalg.qr(rng.standard_normal((dim, dim)))[0].astype(np.float32)

    def draw(m):
        a = rng.choice(n_clusters, size=m, p=p)
        x = rng.standard_normal((m, dim), dtype=np.float32)
        x *= scales[a]
        x += centers[a]
        r = np.exp(rng.standard_normal((m, 1)) * norm_sigma).astype(np.float32)
        return (x * r) @ rot

    train = draw(train_size)
    test = draw(test_size)
    gt = exact_ground_truth(train, test, k, distance=distance, device=device)
    source = f"synthetic_adversarial_n{train_size}_q{test_size}_d{dim}"
    return BenchmarkData(train, test, gt, source, dim)


def load_hdf5_dataset(path: str, k: int, limit_train: Optional[int] = None,
                      limit_test: Optional[int] = None,
                      distance: str = "squared-l2",
                      device: Union[str, torch.device] = DEFAULT_DEVICE
                      ) -> BenchmarkData:
    """An ANN-Benchmarks HDF5 file (train / test / neighbors datasets).
    Truncating the train set invalidates the file's neighbor ids (they
    index the full set), so the ground truth is then recomputed exactly
    over the kept rows. Needs ``h5py``, imported here."""
    import h5py

    with h5py.File(path, "r") as f:
        train = np.asarray(f["train"], dtype=np.float32)
        test = np.asarray(f["test"], dtype=np.float32)
        neighbors = np.asarray(f["neighbors"], dtype=np.int64)
    truncated = bool(limit_train) and limit_train < len(train)
    if limit_train:
        train = train[:limit_train]
    if limit_test:
        test = test[:limit_test]
        neighbors = neighbors[:limit_test]
    if truncated:
        gt = exact_ground_truth(train, test, k, distance=distance,
                                device=device)
    else:
        if neighbors.shape[1] < k:
            raise ValueError(f"neighbors rows must have at least {k} entries")
        gt = neighbors[: len(test), :k].astype(np.int32)
    return BenchmarkData(train, test, gt, path, train.shape[1])


def load_json_dataset(path: str, k: int, limit_train: Optional[int] = None,
                      limit_test: Optional[int] = None,
                      distance: str = "squared-l2",
                      device: Union[str, torch.device] = DEFAULT_DEVICE
                      ) -> BenchmarkData:
    """An ANN-Benchmarks JSON file; as with HDF5, the ground truth is
    recomputed when ``limit_train`` truncates the indexable rows."""
    with open(path) as f:
        raw = json.load(f)
    train = np.asarray(raw["train"], dtype=np.float32)
    test = np.asarray(raw["test"], dtype=np.float32)
    neighbors = [list(map(int, row)) for row in raw["neighbors"]]
    truncated = bool(limit_train) and limit_train < len(train)
    if limit_train:
        train = train[:limit_train]
    if limit_test:
        test = test[:limit_test]
        neighbors = neighbors[:limit_test]
    if len(train) == 0 or len(test) == 0 or len(neighbors) == 0:
        raise ValueError(
            "dataset JSON must include non-empty train/test/neighbors")
    if truncated:
        gt = exact_ground_truth(train, test, k, distance=distance,
                                device=device)
    else:
        if any(len(r) < k for r in neighbors):
            raise ValueError(f"neighbors rows must have at least {k} entries")
        gt = np.asarray([r[:k] for r in neighbors[: len(test)]],
                        dtype=np.int32)
    return BenchmarkData(train, test, gt, path, train.shape[1])


def average_recall_at_k(results: np.ndarray, gt: np.ndarray) -> float:
    """Mean over queries of |found ∩ true| / |true| (ids < 0 are empty
    slots)."""
    recs = []
    for found, want in zip(results, gt):
        want_set = set(int(w) for w in want)
        found_set = set(int(f) for f in found if f >= 0)
        recs.append(len(found_set & want_set) / max(len(want_set), 1))
    return float(np.mean(recs))


def build_index(algorithm: str, data: BenchmarkData, args) -> "object":
    """The ``Scann`` facade for ``algorithm`` with the CLI's knobs, built on
    ``args.device``."""
    from scann_tpu_torch.config import (
        ExactReorderingConfig,
        HashConfig,
        PartitioningConfig,
        ScannConfig,
    )
    from scann_tpu_torch.data.dataset import DenseDataset
    from scann_tpu_torch.models.scann import Scann

    cfg = ScannConfig(num_neighbors=args.k, distance_measure=_measure_for(
        getattr(args, "distance", "squared-l2")))
    if algorithm == "brute-force":
        cfg.with_brute_force()
    elif algorithm == "block-sweep":
        cfg.with_brute_force()
        cfg.brute_force.with_block_sweep(
            pre_k=args.reorder or 100,
            sweep_dtype=getattr(args, "sweep_dtype", "bfloat16"))
    elif algorithm == "partitioned":
        cfg.with_partitioning(PartitioningConfig(
            num_partitions=args.num_partitions,
            num_partitions_to_search=args.partitions_to_search,
        ))
    elif algorithm == "hashed":
        cfg.with_hashing(HashConfig(num_blocks=args.num_blocks,
                                    num_buckets=args.num_buckets))
        if args.reorder:
            cfg.with_reordering(
                ExactReorderingConfig(num_candidates=args.reorder))
    elif algorithm == "tree-ah":
        cfg.with_partitioning(PartitioningConfig(
            num_partitions=args.num_partitions,
            num_partitions_to_search=args.partitions_to_search,
        ))
        cfg.with_hashing(HashConfig(num_blocks=args.num_blocks,
                                    num_buckets=16))
        cfg.with_reordering(ExactReorderingConfig(
            num_candidates=args.reorder or args.k * 3,
            rerank_dtype=args.rerank_dtype))
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return Scann(DenseDataset(data.train), cfg,
                 device=getattr(args, "device", DEFAULT_DEVICE))


_KIND_TO_ALGORITHM = {
    "BruteForceSearcher": "brute-force",
    "BlockSweepSearcher": "block-sweep",
    "ScalarQuantizedBruteForceSearcher": "scalar-quantized",
    "PartitionedSearcher": "partitioned",
    "AsymmetricHasher": "hashed",
    "TreeXHybridSearcher": "tree-ah",
}


def _algorithm_of(index) -> str:
    """The reported algorithm, from the searcher's type (a loaded index
    must not take the CLI's default, which could mislabel the report)."""
    return _KIND_TO_ALGORITHM.get(type(index).__name__,
                                  type(index).__name__)


def _shard_index(index, n_shards: int, device: torch.device):
    """Re-serve a built index through the database-sharded wrappers on an
    n-device mesh: the visible CUDA devices (more shards than devices
    raises, as in the JAX harness), or on the CPU ``n_shards`` shards of
    the CPU (the JAX package's virtual CPU devices)."""
    from scann_tpu_torch.models.block_sweep import BlockSweepSearcher
    from scann_tpu_torch.models.brute_force import BruteForceSearcher
    from scann_tpu_torch.models.tree_x_hybrid import TreeXHybridSearcher
    from scann_tpu_torch.parallel.mesh import make_mesh
    from scann_tpu_torch.parallel.sharded import ShardedBruteForceSearcher
    from scann_tpu_torch.parallel.sharded_flagship import (
        ShardedBlockSweepSearcher,
        ShardedTreeXHybridSearcher,
    )

    impl = getattr(index, "impl", index)
    mesh = make_mesh(n_shards, axis_names=("db",),
                     devices=([device] * n_shards if device.type == "cpu"
                              else None))
    if isinstance(impl, TreeXHybridSearcher):
        return ShardedTreeXHybridSearcher(impl, mesh)
    if isinstance(impl, BlockSweepSearcher):
        return ShardedBlockSweepSearcher(impl, mesh)
    if isinstance(impl, BruteForceSearcher):
        return ShardedBruteForceSearcher(impl.dataset,
                                         impl.distance_measure, mesh)
    raise ValueError(
        f"--shards supports brute-force / block-sweep / tree-ah indexes, "
        f"not {type(impl).__name__}")


def run_benchmark(algorithm: str, data: BenchmarkData,
                  args) -> BenchmarkReport:
    """Build (or ``--load-index``) the index on ``args.device``, optionally
    ``--save-index`` and ``--autotune-target``, search ``data.test`` in
    batches of ``args.batch_size`` (``--pipeline`` batches in flight) and
    report. ``--shards`` > 1 serves the index through the database-sharded
    wrappers (:func:`_shard_index`)."""
    device = require_device(getattr(args, "device", DEFAULT_DEVICE))
    rss0 = current_rss_bytes()
    t0 = time.perf_counter()
    loaded_from = getattr(args, "load_index", None)
    if loaded_from:
        from scann_tpu_torch.io import load_index

        index = load_index(loaded_from, device=device)
        algorithm = _algorithm_of(index)
        # a loaded index served against another dataset would score recall
        # against ground truth for rows it never indexed: refuse
        if index.dataset_size() != len(data.train):
            raise ValueError(
                f"--load-index {loaded_from!r} holds {index.dataset_size()} "
                f"points but the dataset has {len(data.train)}; the loaded "
                "index does not match this dataset (check --seed / "
                "--synthetic-train / --dataset)")
        if index.dimensionality() != data.dimension:
            raise ValueError(
                f"--load-index {loaded_from!r} is {index.dimensionality()}-d "
                f"but the dataset is {data.dimension}-d; the loaded index "
                "does not match this dataset")
    else:
        index = build_index(algorithm, data, args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    rss1 = current_rss_bytes()

    save_s = None
    saved_to = getattr(args, "save_index", None)
    if saved_to:
        from scann_tpu_torch.io import save_index

        t_sv = time.perf_counter()
        save_index(saved_to, index)
        save_s = time.perf_counter() - t_sv

    # shard AFTER saving: the .npz holds the single-device index (the
    # sharded wrappers lay it out anew on any mesh at load)
    n_shards = max(1, int(getattr(args, "shards", 1) or 1))
    if n_shards > 1:
        index = _shard_index(index, n_shards, device)

    batch = args.batch_size
    # warm-up (kernel builds, device state), outside the timed region
    index.search_batched_arrays(data.test[:batch], args.k)

    tuned_params = None
    tune_info: dict = {}
    target = getattr(args, "autotune_target", None)
    if target:
        from scann_tpu_torch.utils.autotune import autotune

        n_sample = min(256, len(data.test))
        p_grid = _parse_int_list(getattr(args, "autotune_leaves", None))
        pre_k_grid = _parse_int_list(getattr(args, "autotune_prek", None))
        t_at = time.perf_counter()
        res = autotune(index, data.test[:n_sample], k=args.k,
                       target_recall=float(target),
                       p_grid=p_grid, pre_k_grid=pre_k_grid,
                       gt=data.gt[:n_sample, : args.k])
        tuned_params = res.params
        tune_info = dict(
            autotune_target=float(target),
            autotune_target_met=res.target_met,
            autotune_sample_recall=res.recall,
            autotune_seconds=time.perf_counter() - t_at,
            autotuned_num_leaves_to_search=res.params.num_leaves_to_search,
            autotuned_pre_reordering_num_neighbors=(
                res.params.pre_reordering_num_neighbors),
        )
        # re-warm at the tuned parameters
        index.search_batched_arrays(data.test[:batch], args.k, tuned_params)

    profiler = None
    if getattr(args, "profile_dir", None):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()

    results = np.full((len(data.test), args.k), -1, dtype=np.int64)
    pipeline = max(1, int(getattr(args, "pipeline", 1) or 1))
    starts = list(range(0, len(data.test), batch))
    t0 = time.perf_counter()
    if pipeline > 1:
        # `pipeline` batches in flight on worker threads, as a concurrent
        # serving front end issues requests: one batch's host work and
        # transfers overlap another's device work
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=pipeline) as ex:
            futs = [ex.submit(index.search_batched_arrays,
                              data.test[i : i + batch], args.k, tuned_params)
                    for i in starts]
            for i, f in zip(starts, futs):
                idx, _ = f.result()
                results[i : i + idx.shape[0], : idx.shape[1]] = idx
    else:
        for i in starts:
            idx, _ = index.search_batched_arrays(data.test[i : i + batch],
                                                 args.k, tuned_params)
            results[i : i + idx.shape[0], : idx.shape[1]] = idx
    search_s = time.perf_counter() - t0

    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(args.profile_dir, "search_trace.json"))

    recall = average_recall_at_k(results, data.gt)
    dev_bytes = None
    impl = getattr(index, "impl", index)  # a loaded index is the searcher
    if hasattr(impl, "memory_usage"):
        dev_bytes = int(impl.memory_usage())

    rtt = measure_host_roundtrip_seconds(device=device)
    n_batches = -(-len(data.test) // batch)
    dispatch_frac = (min(1.0, (rtt * n_batches) / (search_s * pipeline))
                     if search_s > 0 else None)

    return BenchmarkReport(
        dataset=data.source,
        algorithm=algorithm,
        distance=getattr(args, "distance", "squared-l2"),
        k=args.k,
        train_size=len(data.train),
        test_size=len(data.test),
        dimension=data.dimension,
        build_seconds=build_s,
        search_seconds=search_s,
        qps=len(data.test) / search_s if search_s > 0 else 0.0,
        recall_at_k=recall,
        index_rss_delta_bytes=(rss1 - rss0 if rss0 is not None
                               and rss1 is not None else None),
        index_device_bytes=dev_bytes,
        batch_size=batch,
        timing_mode=(f"wall_clock_pipelined_x{pipeline}" if pipeline > 1
                     else "wall_clock_per_batch_dispatch"),
        shards=n_shards if n_shards > 1 else None,
        host_roundtrip_seconds=rtt,
        dispatch_bound_fraction=dispatch_frac,
        index_loaded_from=loaded_from,
        index_saved_to=saved_to,
        index_save_seconds=save_s,
        **tune_info,
    )


def _parse_int_list(spec) -> Optional[list]:
    """'2,5,10' -> [2, 5, 10]; None / '' -> None (autotune's defaults)."""
    if not spec:
        return None
    return [int(s) for s in str(spec).split(",") if s.strip()]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="scann_tpu_torch ANN benchmark harness")
    p.add_argument("--algorithm", default="brute-force",
                   choices=["brute-force", "block-sweep", "partitioned",
                            "hashed", "tree-ah"])
    p.add_argument("--distance", default="squared-l2",
                   choices=["squared-l2", "l2", "cosine", "dot-product"])
    p.add_argument("--dataset", default=None,
                   help="ANN-Benchmarks JSON or HDF5 (.hdf5, .h5) path")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--num-partitions", type=int, default=100)
    p.add_argument("--partitions-to-search", type=int, default=10)
    p.add_argument("--num-blocks", type=int, default=16)
    p.add_argument("--num-buckets", type=int, default=256)
    p.add_argument("--reorder", type=int, default=0)
    p.add_argument("--rerank-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="tree-ah exact re-rank copy dtype (bfloat16 halves, "
                        "int8 quarters the largest serving allocation)")
    p.add_argument("--sweep-dtype", default="bfloat16",
                   choices=["bfloat16", "int8"],
                   help="block-sweep streamed copy dtype (int8 halves the "
                        "stream; the exact re-rank recovers recall)")
    p.add_argument("--limit-train", type=int, default=None)
    p.add_argument("--limit-test", type=int, default=None)
    p.add_argument("--synthetic-train", type=int, default=10_000)
    p.add_argument("--synthetic-test", type=int, default=200)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--pipeline", type=int, default=1,
                   help="query batches in flight (worker threads); > 1 "
                        "overlaps one batch's host work with another's "
                        "device work, as a concurrent serving front end does")
    p.add_argument("--autotune-target", type=float, default=None,
                   help="tune (num_leaves_to_search, pre_reordering depth) on "
                        "a <= 256-query sample to the cheapest point meeting "
                        "this recall@k, then serve with it (utils/autotune)")
    p.add_argument("--autotune-leaves", default=None,
                   help="comma list of num_leaves_to_search grid values "
                        "(default: autotune's own grid)")
    p.add_argument("--autotune-prek", default=None,
                   help="comma list of pre_reordering_num_neighbors grid "
                        "values")
    p.add_argument("--clustered", action="store_true")
    p.add_argument("--adversarial", action="store_true",
                   help="GloVe-shaped skewed synthetic data: Zipf cluster "
                        "sizes, anisotropic covariance, correlated "
                        "dimensions, heavy-tailed norms")
    p.add_argument("--save-index", default=None,
                   help="after building, save the index to this .npz path "
                        "(scann_tpu_torch.io.save_index; the JAX package "
                        "reads it too)")
    p.add_argument("--load-index", default=None,
                   help="serve an index saved with --save-index (by either "
                        "package) instead of building; --algorithm and the "
                        "training knobs are ignored, build_seconds reports "
                        "the load")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the search phase "
                        "here (search_trace.json)")
    p.add_argument("--calibrate-profile", default=None, metavar="PATH",
                   help="measure the chip profile's crossovers on this card "
                        "(utils/chip_profile.calibrate), save the JSON to "
                        "PATH and use it for the rest of the run")
    p.add_argument("--shards", type=int, default=1,
                   help="serve through the database-sharded wrappers on an "
                        "N-device mesh (brute-force/block-sweep/tree-ah; on "
                        "the CPU N shards of the CPU)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to build and search on (default "
                        "cuda; cpu where there is no CUDA device)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    if args.calibrate_profile:
        from scann_tpu_torch.utils.chip_profile import (
            PROFILE_ENV,
            calibrate,
            save_profile,
        )

        prof = calibrate(verbose=True, device=args.device)
        save_profile(prof, args.calibrate_profile)
        # the rest of this run (auto_config's crossovers, the advisor)
        # reads it
        os.environ[PROFILE_ENV] = args.calibrate_profile
        print(f"chip profile calibrated -> {args.calibrate_profile}: "
              f"sweep_max_n={prof.sweep_max_n:,}", flush=True)
    if args.dataset:
        loader = load_hdf5_dataset if args.dataset.endswith(
            (".hdf5", ".h5")) else load_json_dataset
        data = loader(args.dataset, args.k, args.limit_train,
                      args.limit_test, distance=args.distance,
                      device=args.device)
    elif args.adversarial:
        data = generate_adversarial_dataset(
            args.synthetic_train, args.synthetic_test, args.dim, args.k,
            args.seed, distance=args.distance, device=args.device)
    else:
        data = generate_synthetic_dataset(
            args.synthetic_train, args.synthetic_test, args.dim, args.k,
            args.seed, clustered=args.clustered, distance=args.distance,
            device=args.device)
    report = run_benchmark(args.algorithm, data, args)
    print(report.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())

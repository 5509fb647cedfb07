"""The ANN-Benchmarks harness of the PyTorch port against the JAX package's
on the CPU: the generators, the JSON and HDF5 loaders, ``run_benchmark``
for every algorithm (same report keys, recalls within tolerance, an index
the JAX harness saved served by the port), the CLI and the flags the port
adds or refuses.

Tolerances: the adversarial generator is host numpy in the JAX order, so
its rows are bit-equal and its exact ground-truth ids equal (no ties in
these float rows). Loaders: equal arrays. Reports on shared data and
ground truth: brute force and the block sweep (no training; the sweep's
twin matches JAX's bf16 sweep) within one id of the sample, the
partitioned, hashed and tree-x-AH runs within ``TRAINED_TOL`` (each
package trains its own k-means and codebooks from its own draws; the runs
search half the partitions, where recall depends little on the
partitioning: at a quarter the two packages' k-means gave 0.8781 and
0.7781), a
tree-x-AH index saved by the JAX harness within ``LOADED_TOL`` (the port's
bf16 grouped scores against JAX's float32 per-pair path off the TPU can
swap a candidate tied at the pre_k boundary).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from scann_tpu.harness import ann_benchmark as jhb
from scann_tpu_torch.harness import ann_benchmark as phb
from torch_threads import one_torch_thread  # noqa: F401

K = 10
TRAINED_TOL = 0.05
LOADED_TOL = 0.01


def _clustered(n=2000, d=16, q=32, seed=7):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, d)).astype(np.float32) * 3.0
    db = (centers[rng.integers(0, 16, n)]
          + rng.normal(size=(n, d))).astype(np.float32)
    qs = (centers[rng.integers(0, 16, q)]
          + rng.normal(size=(q, d))).astype(np.float32)
    return db, qs


@pytest.fixture(scope="module")
def shared():
    """One dataset for both harnesses, ground truth from the JAX one."""
    db, q = _clustered()
    gt = jhb.exact_ground_truth(db, q, K)
    return (jhb.BenchmarkData(db, q, gt, "clustered", 16),
            phb.BenchmarkData(db, q, gt, "clustered", 16))


def _args(package, argv, device="cpu"):
    if package is phb:
        argv = [*argv, "--device", device]
    return package.make_parser().parse_args(argv)


# -- generators and loaders ------------------------------------------------------


@pytest.mark.parametrize("sizes", [(4000, 20, 16, 10, 3), (6000, 8, 24, 10, 5)])
def test_adversarial_generator_is_bit_equal_to_jax(sizes):
    want = jhb.generate_adversarial_dataset(*sizes[:4], seed=sizes[4])
    got = phb.generate_adversarial_dataset(*sizes[:4], seed=sizes[4],
                                           device="cpu")
    np.testing.assert_array_equal(got.train, want.train)
    np.testing.assert_array_equal(got.test, want.test)
    np.testing.assert_array_equal(got.gt, want.gt)
    assert got.gt.dtype == want.gt.dtype == np.int32
    assert (got.source, got.dimension) == (want.source, want.dimension)


@pytest.mark.parametrize("clustered", [False, True])
def test_synthetic_generator_is_seeded_with_exact_ground_truth(clustered):
    """Drawn from a seeded ``torch.Generator``: other bits than the JAX
    harness's, the same for the same seed, the same shapes and source; the
    ground truth is exact."""
    a = phb.generate_synthetic_dataset(500, 12, 8, K, 3, clustered=clustered,
                                       device="cpu")
    b = phb.generate_synthetic_dataset(500, 12, 8, K, 3, clustered=clustered,
                                       device="cpu")
    j = jhb.generate_synthetic_dataset(500, 12, 8, K, 3, clustered=clustered)
    np.testing.assert_array_equal(a.train, b.train)
    assert a.train.shape == j.train.shape and a.test.shape == j.test.shape
    assert a.source == j.source and a.gt.dtype == np.int32
    d = ((a.test[:, None, :] - a.train[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a.gt, np.argsort(d, axis=1)[:, :K])
    if not clustered:
        assert a.train.min() >= 0 and a.train.max() < 1


def test_json_loader_matches_jax(tmp_path):
    data = jhb.generate_synthetic_dataset(200, 6, 4, 3, 1)
    path = tmp_path / "ds.json"
    path.write_text(json.dumps({"train": data.train.tolist(),
                                "test": data.test.tolist(),
                                "neighbors": data.gt.tolist()}))
    for kw in ({}, {"limit_train": 50}, {"limit_test": 4},
               {"limit_train": 80, "distance": "dot-product"}):
        want = jhb.load_json_dataset(str(path), 3, **kw)
        got = phb.load_json_dataset(str(path), 3, device="cpu", **kw)
        for f in ("train", "test", "gt"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.gt.dtype == want.gt.dtype
    for package in (jhb, phb):
        with pytest.raises(ValueError):
            package.load_json_dataset(str(path), 10)


def test_hdf5_loader_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    data = jhb.generate_synthetic_dataset(80, 5, 4, 3, 1)
    path = str(tmp_path / "ds.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=data.train)
        f.create_dataset("test", data=data.test)
        f.create_dataset("neighbors", data=data.gt)
    for kw in ({}, {"limit_train": 50, "limit_test": 2}):
        want = jhb.load_hdf5_dataset(path, 3, **kw)
        got = phb.load_hdf5_dataset(path, 3, device="cpu", **kw)
        for f in ("train", "test", "gt"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_recall_math_matches_jax():
    got = np.array([[0, 1, 2], [3, 4, -1]])
    gt = np.array([[0, 1, 9], [3, 4, 5]])
    assert phb.average_recall_at_k(got, gt) == \
        jhb.average_recall_at_k(got, gt) == pytest.approx((2 / 3 + 2 / 3) / 2)


# -- run_benchmark ------------------------------------------------------------------


RUNS = {
    "brute-force": ([], 1 / (32 * K) + 1e-12),
    "block-sweep": (["--reorder", "60"], 1 / (32 * K) + 1e-12),
    "partitioned": (["--num-partitions", "16", "--partitions-to-search",
                     "8"], TRAINED_TOL),
    "hashed": (["--num-blocks", "4", "--num-buckets", "16", "--reorder",
                "40"], TRAINED_TOL),
    "tree-ah": (["--num-partitions", "16", "--partitions-to-search", "8",
                 "--num-blocks", "4", "--reorder", "40"], TRAINED_TOL),
}


@pytest.mark.parametrize("algorithm", list(RUNS))
def test_run_benchmark_matches_jax(shared, algorithm):
    jdata, pdata = shared
    extra, tol = RUNS[algorithm]
    argv = ["--algorithm", algorithm, "--batch-size", "8", *extra]
    want = jhb.run_benchmark(algorithm, jdata, _args(jhb, argv))
    got = phb.run_benchmark(algorithm, pdata, _args(phb, argv))
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
    assert abs(got.recall_at_k - want.recall_at_k) <= tol, (
        got.recall_at_k, want.recall_at_k)
    for f in ("dataset", "algorithm", "distance", "k", "train_size",
              "test_size", "dimension", "batch_size", "timing_mode"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.index_device_bytes is None) == \
        (want.index_device_bytes is None)
    assert got.qps > 0 and got.host_roundtrip_seconds > 0
    assert 0 <= got.dispatch_bound_fraction <= 1


def test_run_benchmark_serves_an_index_the_jax_harness_saved(shared,
                                                             tmp_path):
    """``--save-index`` by the JAX harness, ``--load-index`` by the port:
    the report names the file and the algorithm from the searcher's type,
    and its recall is the JAX harness's within ``LOADED_TOL``."""
    jdata, pdata = shared
    path = str(tmp_path / "tree.npz")
    built = jhb.run_benchmark("tree-ah", jdata, _args(jhb, [
        "--algorithm", "tree-ah", "--num-partitions", "16",
        "--partitions-to-search", "4", "--num-blocks", "4", "--reorder",
        "40", "--batch-size", "8", "--save-index", path]))
    assert built.index_saved_to == path
    argv = ["--algorithm", "brute-force", "--batch-size", "8",
            "--load-index", path]
    want = jhb.run_benchmark("brute-force", jdata, _args(jhb, argv))
    got = phb.run_benchmark("brute-force", pdata, _args(phb, argv))
    assert got.algorithm == want.algorithm == "tree-ah"
    assert got.index_loaded_from == path
    assert abs(got.recall_at_k - want.recall_at_k) <= LOADED_TOL
    assert abs(got.recall_at_k - built.recall_at_k) <= LOADED_TOL


def test_run_benchmark_save_load_pipeline_and_profile(shared, tmp_path):
    """The port's own round trip gives the same results; ``--pipeline 4``
    the serial recall; ``--profile-dir`` a non-empty trace."""
    _, pdata = shared
    path = str(tmp_path / "idx.npz")
    tree = ["--algorithm", "tree-ah", "--num-partitions", "8",
            "--partitions-to-search", "8", "--num-blocks", "4", "--reorder",
            "40", "--batch-size", "8"]
    built = phb.run_benchmark("tree-ah", pdata, _args(phb, [
        *tree, "--save-index", path]))
    assert built.index_save_seconds is not None
    trace = tmp_path / "trace"
    served = phb.run_benchmark("tree-ah", pdata, _args(phb, [
        *tree, "--load-index", path, "--profile-dir", str(trace)]))
    assert served.recall_at_k == built.recall_at_k
    assert served.index_loaded_from == path and served.algorithm == "tree-ah"
    assert (trace / "search_trace.json").stat().st_size > 0
    piped = phb.run_benchmark("tree-ah", pdata, _args(phb, [
        *tree, "--load-index", path, "--pipeline", "4"]))
    assert piped.recall_at_k == served.recall_at_k
    assert piped.timing_mode == "wall_clock_pipelined_x4"


def test_run_benchmark_autotune_target_matches_jax(shared):
    """``--autotune-target`` stamps the same provenance fields, meets the
    target on both sides and serves the whole run at the tuned params."""
    jdata, pdata = shared
    argv = ["--algorithm", "tree-ah", "--num-partitions", "16",
            "--partitions-to-search", "2", "--num-blocks", "4", "--reorder",
            "20", "--batch-size", "32", "--autotune-target", "0.95",
            "--autotune-leaves", "4,8,16", "--autotune-prek", "30,60"]
    want = jhb.run_benchmark("tree-ah", jdata, _args(jhb, argv))
    got = phb.run_benchmark("tree-ah", pdata, _args(phb, argv))
    for r in (got, want):
        assert r.autotune_target == pytest.approx(0.95)
        assert r.autotune_target_met and r.autotune_sample_recall >= 0.95
        assert r.autotuned_num_leaves_to_search in (4, 8, 16)
        assert r.autotuned_pre_reordering_num_neighbors in (30, 60)
    assert abs(got.recall_at_k - want.recall_at_k) <= TRAINED_TOL


def test_run_benchmark_refuses_what_it_cannot_serve(shared, tmp_path):
    """A loaded index of another dataset raises as in the JAX harness;
    ``--shards 2`` serves brute force, the block sweep and tree-x-AH
    through the database-sharded wrappers (on the CPU, two CPU shards; the
    JAX harness on two of its virtual devices) with the JAX report's
    shard count and recall, and refuses an algorithm with no sharded
    wrapper as the JAX harness does. (The test once also pinned the
    ``NotImplementedError`` of ``--shards`` before the sharded searchers
    were ported.)"""
    jdata, pdata = shared
    path = str(tmp_path / "bf.npz")
    phb.run_benchmark("brute-force", pdata, _args(phb, [
        "--batch-size", "8", "--save-index", path]))
    db, q = _clustered(n=1500)
    other = phb.BenchmarkData(db, q, pdata.gt, "other", 16)
    with pytest.raises(ValueError, match="does not match"):
        phb.run_benchmark("brute-force", other, _args(phb, [
            "--batch-size", "8", "--load-index", path]))
    one_id = 1.0 / (len(pdata.test) * K)
    for algo, extra, tol in (
            ("brute-force", [], one_id),
            ("block-sweep", ["--reorder", "60"], one_id),
            ("tree-ah", ["--num-partitions", "16", "--partitions-to-search",
                         "8", "--num-blocks", "4", "--reorder", "100"],
             TRAINED_TOL)):
        argv = ["--batch-size", "16", "--shards", "2", *extra]
        got = phb.run_benchmark(algo, pdata, _args(phb, argv))
        want = jhb.run_benchmark(algo, jdata, _args(jhb, argv))
        assert got.shards == want.shards == 2
        assert abs(got.recall_at_k - want.recall_at_k) <= tol + 1e-12, (
            algo, got.recall_at_k, want.recall_at_k)
    for package, data in ((phb, pdata), (jhb, jdata)):
        with pytest.raises(ValueError, match="--shards supports"):
            package.run_benchmark("hashed", data, _args(package, [
                "--batch-size", "16", "--shards", "2"]))
    if not torch.cuda.is_available():
        # the default device is the card: without one it raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            phb.run_benchmark("brute-force", pdata, _args(phb, [], "cuda"))


def test_run_benchmark_shards_with_save_and_autotune(shared, tmp_path):
    """``--shards`` composes with ``--save-index`` (the file holds the
    single-device index, saved before sharding, which either package
    loads) and ``--autotune-target`` (the tuner reaches the partitions
    through the sharded wrapper and sweeps the leaves grid), as in the JAX
    harness (``tests/test_scann_facade.py``)."""
    from scann_tpu.io import load_index as jax_load_index

    _, pdata = shared
    path = str(tmp_path / "sh.npz")
    got = phb.run_benchmark("tree-ah", pdata, _args(phb, [
        "--num-partitions", "16", "--partitions-to-search", "4",
        "--num-blocks", "4", "--reorder", "40", "--batch-size", "32",
        "--shards", "2", "--save-index", path, "--autotune-target", "0.95",
        "--autotune-leaves", "4,8,16", "--autotune-prek", "40,100"]))
    assert got.shards == 2 and got.index_saved_to == path
    assert got.autotuned_num_leaves_to_search in (4, 8, 16)
    assert got.autotune_target_met and got.autotune_sample_recall >= 0.95
    assert got.recall_at_k >= 0.9
    assert jax_load_index(path).dataset_size() == len(pdata.train)
    from scann_tpu_torch.io import load_index

    assert type(load_index(path, device="cpu")).__name__ == \
        "TreeXHybridSearcher"


def test_cli_prints_one_report(capsys):
    assert phb.main(["--algorithm", "brute-force", "--synthetic-train",
                     "300", "--synthetic-test", "10", "--dim", "8",
                     "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["recall_at_k"] == pytest.approx(1.0)
    assert report.keys() == {f.name for f in
                             dataclasses.fields(jhb.BenchmarkReport)}
    want = {a.dest for a in jhb.make_parser()._actions}
    got = {a.dest for a in phb.make_parser()._actions}
    assert got - want == {"device"} and want <= got
    assert phb.make_parser().parse_args([]).device == "cuda"

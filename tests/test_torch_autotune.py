"""The chip profile, the advisor, the autotuners, ``Scann.auto`` and the
timing helpers of the PyTorch port against the JAX package on the CPU,
on ``tests/test_autotune.py``'s data (4,000-8,000 x 24).

Each package reads its profile from its own variable
(``SCANN_TPU_CHIP_PROFILE``, ``SCANN_TPU_TORCH_CHIP_PROFILE``); the tests
point both at one file. Tolerances:

- ``auto_config``, ``advise_build`` and ``advise_config`` are decisions:
  equal field for field (the configs' dicts);
- ``dataset_stats`` runs k-means from a ``torch.Generator`` start in the
  port, so its statistics are not JAX's bits: the ``skewed`` decision
  agrees;
- autotune tables: the same (params, cost) entries in the same order;
  recalls equal within ``TABLE_TOL`` (3 ids of the 32 x 10 sample) for
  tree-x-AH, whose port scores bf16 grouped LUT sums where the JAX CPU
  path scores float32 per pair, so a candidate that ties at the pre_k
  boundary can swap (ROADMAP queue 3), and within one id for the block
  sweep; the same choice wherever no grid recall lies within that
  tolerance of the target.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.harness import ann_benchmark as jhb
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxAHConfig
from scann_tpu.io import save_index as jax_save_index
from scann_tpu.models import scann as jscann
from scann_tpu.models.block_sweep import BlockSweepConfig as JaxSweepConfig
from scann_tpu.models.block_sweep import BlockSweepSearcher as JaxSweep
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig as JaxTreeConfig
from scann_tpu.models.tree_x_hybrid import TreeXHybridSearcher as JaxTree
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.utils import advisor as jadv
from scann_tpu.utils import autotune as jat
from scann_tpu.utils import chip_profile as jcp
import scann_tpu_torch as T
from scann_tpu_torch.harness import ann_benchmark as phb
from scann_tpu_torch.models import scann as pscann
from scann_tpu_torch.ops.sweep import augmented_dim
from scann_tpu_torch.utils import advisor as padv
from scann_tpu_torch.utils import autotune as pat
from scann_tpu_torch.utils import benchmarking as pbm
from scann_tpu_torch.utils import chip_profile as pcp
from torch_threads import one_torch_thread  # noqa: F401

K = 10
TABLE_TOL = 3 / (32 * K) + 1e-12
SWEEP_TOL = 1 / (32 * K) + 1e-12
MEASURES = ["SQUARED_L2", "DOT_PRODUCT", "COSINE"]


@pytest.fixture(scope="module")
def clustered():
    """``tests/test_autotune.py``'s fixture."""
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(32, 24)).astype(np.float32) * 3.0
    assign = rng.integers(0, 32, size=4000)
    db = (centers[assign] + rng.normal(size=(4000, 24)) * 0.4
          ).astype(np.float32)
    q = (centers[rng.integers(0, 32, size=32)]
         + rng.normal(size=(32, 24)) * 0.4).astype(np.float32)
    return db, q


def _friendly(seed, n=6000):
    """Uniform-mass clustered rows (``tests/test_autotune.py:135-139``)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, 24)).astype(np.float32) * 3.0
    return (centers[rng.integers(0, 32, size=n)]
            + rng.normal(size=(n, 24)) * 0.4).astype(np.float32)


@pytest.fixture
def profile(tmp_path, monkeypatch):
    """``set(**fields)`` writes one profile with the JAX package's
    ``save_profile`` and points both packages' variables at it."""

    def set_(**fields):
        path = str(tmp_path / "profile.json")
        jcp.save_profile(jcp.ChipProfile(source="test", **fields), path)
        monkeypatch.setenv("SCANN_TPU_CHIP_PROFILE", path)
        monkeypatch.setenv(pcp.PROFILE_ENV, path)
        return path

    return set_


def _same_tables(port, jax, tol):
    assert [(e.params.num_leaves_to_search,
             e.params.pre_reordering_num_neighbors, e.cost)
            for e in port.table] == \
        [(e.params.num_leaves_to_search,
          e.params.pre_reordering_num_neighbors, e.cost) for e in jax.table]
    for p, j in zip(port.table, jax.table):
        assert abs(p.recall - j.recall) <= tol, (p, j)


def _same_choice(port, jax, target, tol):
    """The same chosen point where no grid recall is within ``tol`` of the
    target; otherwise the port's choice follows from its own table."""
    if all(abs(e.recall - target) > tol for e in jax.table):
        assert (port.params.num_leaves_to_search,
                port.params.pre_reordering_num_neighbors) == \
            (jax.params.num_leaves_to_search,
             jax.params.pre_reordering_num_neighbors)
        assert port.target_met == jax.target_met
    meeting = [e for e in port.table if e.recall >= target]
    if meeting:
        assert port.params == min(meeting,
                                  key=lambda e: (e.cost, -e.recall)).params


# -- the chip profile ----------------------------------------------------------


def test_profile_files_cross_between_the_packages(tmp_path, monkeypatch):
    """The same JSON format both ways; each package reads only its own
    variable, so a TPU profile never sets the card's crossovers."""
    fields = dict(sweep_max_n=1234, f32_rerank_max_bytes=5678,
                  partition_density=300, source="test")
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jcp.save_profile(jcp.ChipProfile(**fields), jpath)
    pcp.save_profile(pcp.ChipProfile(**fields), ppath)
    assert dataclasses.asdict(pcp.load_profile(jpath)) == fields
    assert dataclasses.asdict(jcp.load_profile(ppath)) == fields
    assert open(jpath).read() == open(ppath).read()
    monkeypatch.setenv("SCANN_TPU_CHIP_PROFILE", jpath)
    monkeypatch.delenv(pcp.PROFILE_ENV, raising=False)
    assert pcp.load_profile() == pcp.ChipProfile()
    monkeypatch.setenv(pcp.PROFILE_ENV, ppath)
    assert pcp.load_profile().sweep_max_n == 1234


def test_default_profile_is_the_cards_own():
    """The defaults are a calibration on the card, not the JAX package's
    TPU numbers; ``source`` names the card and its power limit."""
    d = pcp.ChipProfile()
    assert "H100" in d.source and " W" in d.source
    jd = jcp.ChipProfile()
    assert d.sweep_max_n != jd.sweep_max_n
    assert d.f32_rerank_max_bytes != jd.f32_rerank_max_bytes
    assert d.partition_density == jd.partition_density == 600


def test_calibrate_on_the_cpu_follows_from_its_fit(monkeypatch):
    """A tiny calibration on the CPU: the profile's fields follow from its
    own fitted a, b and memory cap by the rules of
    ``measure_calibration``; without ``hbm_bytes`` the CPU raises."""
    cal = pcp.measure_calibration(n_probe=1000, dim=8, batch=16, seed=1,
                                  hbm_bytes=10**8, device="cpu", iters=3,
                                  rounds=2)
    assert (cal.n_probe, cal.n_big, cal.dim, cal.batch) == (1000, 4000, 8,
                                                            16)
    assert min(cal.t_small, cal.t_big, cal.t_tree) > 0
    assert cal.b == max((cal.t_big - cal.t_small) / 3000, 1e-12)
    assert cal.a == max(cal.t_small - cal.b * 1000, 0.0)
    assert cal.n_fit == (int((cal.t_tree - cal.a) / cal.b)
                         if cal.t_tree > cal.a else 4000)
    # the augmented bf16 sweep row and the float32 row
    assert cal.bytes_per_point == augmented_dim(8) * 2 + 8 * 4 == 64
    assert cal.n_hbm == int(0.6 * 10**8 / 64)
    prof = cal.profile()
    assert prof.sweep_max_n == max(min(cal.n_fit, cal.n_hbm), 4000)
    assert prof.f32_rerank_max_bytes == 10**8 // 3
    assert prof.partition_density == 600
    assert f"fit={cal.n_fit}" in prof.source
    assert f"hbm_cap={cal.n_hbm}" in prof.source
    # calibrate() is that measurement's profile
    monkeypatch.setattr(pcp, "measure_calibration", lambda *a, **k: cal)
    assert pcp.calibrate(device="cpu", hbm_bytes=10**8) == prof
    monkeypatch.undo()
    with pytest.raises(ValueError, match="hbm_bytes"):
        pcp.calibrate(n_probe=1000, dim=8, batch=16, device="cpu")


@pytest.mark.parametrize("fields", [
    dict(sweep_max_n=5000, f32_rerank_max_bytes=10**6, partition_density=300),
    dict(sweep_max_n=2_000_000, f32_rerank_max_bytes=3 * 10**9),
])
@pytest.mark.parametrize("measure", MEASURES)
def test_auto_config_matches_jax_field_for_field(profile, fields, measure):
    """``auto_config`` equals the JAX package's for the same profile over a
    grid of n and dim (37 is prime: one dimension a subspace), both
    branches and the bfloat16 re-rank switch."""
    profile(**fields)
    for n in (1000, 5000, 5001, 200_000, 2_000_001, 10_000_000):
        for dim in (24, 37, 100, 128):
            for force in (False, True):
                want = jscann.auto_config(n, dim, JaxMeasure[measure],
                                          force_tree=force)
                got = pscann.auto_config(n, dim, T.DistanceMeasure[measure],
                                         force_tree=force)
                assert got.to_dict() == want.to_dict(), (n, dim, force)


# -- the advisor ---------------------------------------------------------------


@pytest.mark.parametrize("stats", [
    (6000, 120, 0.27, 4.46, 0.39), (6000, 120, 0.22, 3.8, 0.12),
    (20000, 256, 0.3, 2.0, 0.1), (6000, 120, 0.1, 5.0, 0.0)])
def test_advise_build_equal_from_equal_stats(profile, stats):
    """Equal ``BuildAdvice`` from equal ``DataStats`` (passed as
    ``stats=``), over scales, targets and densities."""
    for density in (600, 300):
        profile(partition_density=density)
        for n in (50_000, 1_180_000, 10_000_000):
            for target in (None, 0.9, 0.95, 0.97, 0.99):
                want = jadv.advise_build(n, 24, None, target,
                                         stats=jadv.DataStats(*stats))
                got = padv.advise_build(n, 24, None, target,
                                        stats=padv.DataStats(*stats),
                                        device="cpu")
                assert got.stats.skewed == want.stats.skewed
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_skew_decision_matches_jax():
    """``tests/test_autotune.py:127-151``'s samples: the adversarial rows
    (bit-equal from both generators) are skewed on both sides, the
    uniform-mass rows on neither."""
    adv_j = jhb.generate_adversarial_dataset(6000, 8, 24, 10, seed=3)
    adv_p = phb.generate_adversarial_dataset(6000, 8, 24, 10, seed=3,
                                             device="cpu")
    np.testing.assert_array_equal(adv_p.train, adv_j.train)
    friendly = _friendly(3)
    for sample, skewed in ((adv_j.train, True), (friendly, False)):
        want = jadv.dataset_stats(sample)
        got = padv.dataset_stats(sample, device="cpu")
        assert got.skewed == want.skewed == skewed, (vars(got), vars(want))
        assert (got.n_sample, got.n_clusters) == (want.n_sample,
                                                  want.n_clusters)
        # the norm statistic has no k-means in it: equal to float32 sums
        assert got.norm_cv == pytest.approx(want.norm_cv, rel=1e-5)
    small = padv.dataset_stats(friendly[:63], device="cpu")
    assert dataclasses.asdict(small) == dataclasses.asdict(
        jadv.dataset_stats(friendly[:63]))


def test_advise_config_routes_match_jax(profile):
    """``tests/test_autotune.py:213-236``: past ``sweep_max_n`` skewed data
    goes to the int8 sweep with bfloat16 re-rank rows, friendly data to the
    tree; equal configs on both sides."""
    profile(sweep_max_n=1000)
    adv = jhb.generate_adversarial_dataset(6000, 8, 24, 10, seed=5)
    friendly = _friendly(0)
    for sample, target in ((adv.train, 0.99), (friendly, 0.9),
                           (adv.train, None), (friendly, 0.99)):
        want = jadv.advise_config(6000, 24, sample, target_recall=target)
        got = padv.advise_config(6000, 24, sample, target_recall=target,
                                 device="cpu")
        assert got.to_dict() == want.to_dict(), target
    got = padv.advise_config(6000, 24, adv.train, target_recall=0.99,
                             device="cpu")
    assert got.brute_force.block_sweep_dtype == "int8"
    assert got.exact_reordering.rerank_dtype == "bfloat16"


def test_skew_route_ceiling_counts_the_ports_row_bytes(profile):
    """The skew route's ceiling is half of three times
    ``f32_rerank_max_bytes`` over the port's bytes a row (an int8 sweep
    row and a bfloat16 re-rank row), not the JAX package's lane-padded 3
    bytes a dimension: between the two ceilings the packages route
    differently, by design. At dim 24 a row is 32 + 48 bytes (JAX: 384)."""
    assert padv.compact_sweep_bytes_per_row(24) == 80
    assert padv.compact_sweep_bytes_per_row(100) == 104 + 200
    # ceilings for 6000 x 24: the port 0.5 * 3 * 500_000 / 80 = 9375 rows,
    # the JAX package 0.5 * 3 * 500_000 / 384 = 1953 rows
    profile(sweep_max_n=1000, f32_rerank_max_bytes=500_000)
    adv = jhb.generate_adversarial_dataset(6000, 8, 24, 10, seed=5)
    want = jadv.advise_config(6000, 24, adv.train, target_recall=0.99)
    got = padv.advise_config(6000, 24, adv.train, target_recall=0.99,
                             device="cpu")
    assert want.partitioning is not None and want.brute_force is None
    assert got.brute_force is not None and got.brute_force.block_sweep
    profile(sweep_max_n=1000, f32_rerank_max_bytes=300_000)
    got = padv.advise_config(6000, 24, adv.train, target_recall=0.99,
                             device="cpu")  # ceiling 5625 < 6000
    assert got.partitioning is not None and got.partitioning.spilling


@pytest.mark.parametrize("dim", [24, 37, 100])
def test_compact_sweep_row_bytes_equal_memory_usage(dim):
    """``memory_usage()`` of an int8 sweep with bfloat16 re-rank rows is N
    times the advisor's bytes a row (N a multiple of the row padding)."""
    n = 8192
    db = np.random.default_rng(dim).normal(size=(n, dim)).astype(np.float32)
    s = T.BlockSweepSearcher(T.DenseDataset(db), T.BlockSweepConfig(
        sweep_dtype="int8", rerank_dtype="bfloat16"), device="cpu")
    assert s.device_state()[0].shape[0] == n
    assert s.memory_usage() == n * padv.compact_sweep_bytes_per_row(dim)


# -- the autotuners --------------------------------------------------------------


@pytest.fixture(scope="module")
def saved_tree(clustered, tmp_path_factory):
    """``test_autotune_tree_ah_meets_target``'s index, built by the JAX
    package and saved; the port loads the file."""
    db, _ = clustered
    jax_s = JaxTree(JaxTreeConfig(
        num_partitions=32, partitions_to_search=4,
        hash_config=JaxAHConfig(num_codes=16, num_subspaces=8, seed=1,
                                max_iterations=5))).build(JaxDataset(db))
    path = str(tmp_path_factory.mktemp("tree") / "tree.npz")
    jax_save_index(path, jax_s)
    return jax_s, path


@pytest.mark.parametrize("target", [0.9, 0.95, 1.01])
def test_autotune_table_matches_jax_on_a_saved_index(clustered, saved_tree,
                                                     target):
    db, q = clustered
    jax_s, path = saved_tree
    port = T.load_index(path, device="cpu")
    assert port._csr_state()[-1] == jax_s._csr_state()[5]  # l_cap
    grid = dict(p_grid=(2, 4, 8, 16), pre_k_grid=(20, 50, 100))
    want = jat.autotune(jax_s, q, k=K, target_recall=target, **grid)
    got = pat.autotune(port, q, k=K, target_recall=target, **grid)
    _same_tables(got, want, TABLE_TOL)
    _same_choice(got, want, target, TABLE_TOL)
    if target > 1:
        assert not got.target_met
        assert got.recall == max(e.recall for e in got.table)


def test_autotune_default_grid_and_gt_match_jax(clustered, saved_tree):
    """The default grids (p up to the partition count) and ground truth
    from the searcher's own dataset and measure."""
    _, q = clustered
    jax_s, path = saved_tree
    port = T.load_index(path, device="cpu")
    want = jat.autotune(jax_s, q[:8], k=K, target_recall=0.9)
    got = pat.autotune(port, q[:8], k=K, target_recall=0.9)
    assert len(got.table) == len(want.table) == 36
    _same_tables(got, want, 3 / (8 * K) + 1e-12)


@pytest.mark.parametrize("measure", ["SQUARED_L2", "COSINE"])
def test_autotune_block_sweep_searcher_matches_jax(clustered, measure):
    """pre_k only (no partitioner): the same table, the smallest passing
    pre_k (``tests/test_autotune.py:55-96``)."""
    db, q = clustered
    jax_s = JaxSweep(JaxDataset(db), JaxSweepConfig(
        distance_measure=JaxMeasure[measure], block_r=8, tile_n=256,
        pre_reorder_k=16))
    port = T.BlockSweepSearcher(T.DenseDataset(db), T.BlockSweepConfig(
        distance_measure=T.DistanceMeasure[measure], block_r=8, tile_n=256,
        pre_reorder_k=16), device="cpu")
    grid = dict(pre_k_grid=(16, 32, 64, 128))
    want = jat.autotune(jax_s, q, k=K, target_recall=0.98, **grid)
    got = pat.autotune(port, q, k=K, target_recall=0.98, **grid)
    assert got.params.num_leaves_to_search is None
    _same_tables(got, want, SWEEP_TOL)
    _same_choice(got, want, 0.98, SWEEP_TOL)


def test_autotune_block_sweep_matches_jax(clustered):
    """``autotune_block_sweep`` (``tests/test_autotune.py:103-124``): the
    same knobs and costs over the (dtype, r, top2, pre_k) grid, recalls
    within one id, the same build config."""
    db, q = clustered
    grid = dict(k=K, target_recall=0.95, r_grid=(8,),
                dtype_grid=("bfloat16", "int8"), top2_options=(False, True),
                pre_k_grid=(20, 60))
    want = jat.autotune_block_sweep(JaxDataset(db), q, **grid)
    got = pat.autotune_block_sweep(T.DenseDataset(db), q, device="cpu",
                                   **grid)
    assert len(got.table) == len(want.table) == 8
    assert [(kn, c) for kn, _, c in got.table] == \
        [(kn, c) for kn, _, c in want.table]
    for (_, rp, _), (_, rj, _) in zip(got.table, want.table):
        assert abs(rp - rj) <= SWEEP_TOL
    if all(abs(r - 0.95) > SWEEP_TOL for _, r, _ in want.table):
        assert dataclasses.asdict(got.config)["block_r"] == \
            want.config.block_r
        assert (got.config.sweep_dtype, got.config.top2,
                got.config.pre_reorder_k) == (
            want.config.sweep_dtype, want.config.top2,
            want.config.pre_reorder_k)
    assert got.target_met
    # the chosen config rebuilt reaches its reported recall
    s = T.BlockSweepSearcher(T.DenseDataset(db), got.config, device="cpu")
    idx, _ = s.search_batched_arrays(q, K, got.params)
    gt, _ = T.BruteForceSearcher(T.DenseDataset(db), device="cpu"
                                 ).search_batched_arrays(q, K)
    assert pat._recall(idx, gt) == pytest.approx(got.recall)


def test_autotune_block_sweep_reads_top2_at_search_time(clustered):
    """Swapping ``_config`` to top2 changes the search and needs no other
    state: the swapped searcher equals one built with top2."""
    db, q = clustered
    ds = T.DenseDataset(db)
    cfg = T.BlockSweepConfig(block_r=8, pre_reorder_k=20)
    s = T.BlockSweepSearcher(ds, cfg, device="cpu")
    s.search_batched_arrays(q, K)
    s._config = dataclasses.replace(cfg, top2=True)
    fresh = T.BlockSweepSearcher(ds, dataclasses.replace(cfg, top2=True),
                                 device="cpu")
    for a, b in zip(s.search_batched_arrays(q, K),
                    fresh.search_batched_arrays(q, K)):
        np.testing.assert_array_equal(a, b)


# -- Scann.auto ----------------------------------------------------------------


def _record(monkeypatch, module, params_cls, calls):
    """Replace ``module.autotune`` by a recorder that returns a met target
    at default parameters (the mode and sample rows are under test here,
    the tables above)."""

    def fake(searcher, queries, k=10, target_recall=0.95, **kw):
        calls.append(np.array(queries))
        return module.AutotuneResult(params_cls(), 1.0, True, [])

    monkeypatch.setattr(module, "autotune", fake)


@pytest.mark.parametrize("route", ["sweep", "tree"])
def test_scann_auto_picks_jax_mode_and_sample_rows(profile, monkeypatch,
                                                   route):
    """``Scann.auto(target_recall=...)`` draws the same 20,000-row sample
    (here all 8,000 rows in the JAX order) for the advisor and the same
    256 tuning rows, and picks the same mode, inner class and config. The
    tree route forces ``sweep_max_n`` below N on uniform rows, far from the
    skew cut on both sides (clustered rows can sit near it: on
    ``_friendly(5, 8000)`` the JAX k-means gives max/mean 4.92, the port's
    2.66, about the 4.5 cut)."""
    if route == "tree":
        profile(sweep_max_n=1000, partition_density=300)
        db = np.random.default_rng(5).random((8000, 24), dtype=np.float32)
    else:
        profile(sweep_max_n=50_000)
        db = jhb.generate_adversarial_dataset(8000, 8, 24, 10, seed=5).train
    samples = {"jax": [], "port": []}
    for name, module in (("jax", jadv), ("port", padv)):
        real = module.advise_config

        def spy(n, dim, sample, *a, _real=real, _name=name, **kw):
            samples[_name].append(np.array(sample))
            return _real(n, dim, sample, *a, **kw)

        monkeypatch.setattr(module, "advise_config", spy)
    tuned = {"jax": [], "port": []}
    _record(monkeypatch, jat, jscann.SearchParameters, tuned["jax"])
    _record(monkeypatch, pat, T.SearchParameters, tuned["port"])
    target = 0.99 if route == "sweep" else 0.95
    want = jscann.Scann.auto(JaxDataset(db), target_recall=target, seed=3)
    got = T.Scann.auto(T.DenseDataset(db), target_recall=target, seed=3,
                       device="cpu")
    np.testing.assert_array_equal(samples["port"][0], samples["jax"][0])
    np.testing.assert_array_equal(tuned["port"][0], tuned["jax"][0])
    assert tuned["port"][0].shape == (256, 24)
    assert got.search_mode.value == want.search_mode.value
    assert type(got.impl).__name__ == type(want.impl).__name__ == (
        "BlockSweepSearcher" if route == "sweep" else "TreeXHybridSearcher")
    assert got.config.to_dict() == want.config.to_dict()
    assert set(got.describe()) == set(want.describe())


def test_scann_auto_without_target_and_builder_match_jax(profile):
    """No target: ``auto_config`` alone, no tuning; ``ScannBuilder.auto()``
    picks the same and keeps the builder's k."""
    db = _friendly(1, 3000)
    for fields in (dict(sweep_max_n=10_000), dict(sweep_max_n=1000)):
        profile(**fields)
        want = jscann.Scann.auto(JaxDataset(db))
        got = T.Scann.auto(T.DenseDataset(db), device="cpu")
        assert got.config.to_dict() == want.config.to_dict()
        assert got.autotune_result is None and got.default_params is None
        assert got.describe() == want.describe()
        built = T.ScannBuilder().num_neighbors(7).auto().build(
            T.DenseDataset(db), device="cpu")
        jbuilt = jscann.ScannBuilder().num_neighbors(7).auto().build(
            JaxDataset(db))
        assert built.config.to_dict() == jbuilt.config.to_dict()
        assert built.config.num_neighbors == 7


def test_scann_auto_serves_its_tuned_params(monkeypatch):
    """``default_params`` serve a search without explicit params through
    both entry points; explicit params win; ``describe`` names them."""
    data = phb.generate_adversarial_dataset(8000, 64, 24, 10, seed=5,
                                            device="cpu")
    s = T.Scann.auto(T.DenseDataset(data.train), target_recall=0.99,
                     tune_queries=data.test, device="cpu")
    assert s.autotune_result.target_met
    assert s.default_params == s.autotune_result.params
    assert s.describe()["autotuned_params"] == str(s.default_params)
    idx, _ = s.search_batched_arrays(data.test, 10)
    assert pat._recall(idx, data.gt) >= 0.99 - 0.01
    k, params = s.search_arguments()
    assert params == s.default_params
    ids, _ = s.search_batched_tensors(torch.from_numpy(data.test))
    np.testing.assert_array_equal(ids.numpy(), idx)
    explicit = T.SearchParameters(pre_reordering_num_neighbors=10)
    assert s.search_arguments(params=explicit)[1] == explicit


# -- the timing helpers ----------------------------------------------------------


def test_chained_calls_once_an_iteration_on_the_previous_result():
    """One build call, then ``rounds`` chains of ``iters`` calls; call i of
    a chain takes q + acc * 1e-20 + i * 1e-6 with acc the sum of the
    earlier calls' finite values (here 1e19 a call, so each input moves by
    0.1 a previous call)."""
    seen = []
    q0 = torch.zeros(2, 3)

    def call(q, extra):
        seen.append(q.clone())
        assert extra == "x"
        vals = torch.tensor([1e19, float("inf")])
        return vals, torch.zeros(2, dtype=torch.int64)

    t = pbm.chained(call, (q0, "x"), iters=4, rounds=2)
    assert t > 0 and len(seen) == 1 + 2 * 4
    assert torch.equal(seen[0], q0)
    for chain in (seen[1:5], seen[5:9]):
        for i, q in enumerate(chain):
            want = torch.full((2, 3), i * 0.1 + i * 1e-6)
            torch.testing.assert_close(q, want, rtol=1e-5, atol=1e-6)


def test_pipelined_calls_once_an_iteration_on_distinct_batches():
    seen = []
    q0 = torch.zeros(1, 2)

    def call(q):
        seen.append(float(q[0, 0]))
        return q, None

    t = pbm.pipelined(call, (q0,), iters=3, rounds=2)
    assert t > 0 and len(seen) == 1 + 2 * 3
    want = [float(np.float32(i + 1) * np.float32(1e-6)) for i in range(3)]
    assert seen[1:4] == pytest.approx(want) and seen[4:] == seen[1:4]
    assert len(set(seen[1:4])) == 3


def test_scan_time_is_the_best_round_per_iteration():
    calls = []

    def make(iters):
        def fn():
            calls.append(iters)
            return torch.tensor(1.0)
        return fn

    assert pbm.scan_time(make, 5, rounds=3) >= 0
    assert calls == [5] * 4


def test_exports_match_jax():
    import scann_tpu

    names = ("advise_build", "advise_config", "dataset_stats", "autotune",
             "AutotuneResult", "autotune_block_sweep", "SweepAutotuneResult",
             "ChipProfile", "calibrate", "load_profile")
    for name in names:
        assert name in T.__all__ and name in scann_tpu.__all__
        assert callable(getattr(T, name))
    assert [f.name for f in dataclasses.fields(T.ChipProfile)] == \
        [f.name for f in dataclasses.fields(jcp.ChipProfile)]
    assert [f.name for f in dataclasses.fields(padv.BuildAdvice)] == \
        [f.name for f in dataclasses.fields(jadv.BuildAdvice)]
    assert json.loads(T.ChipProfile().to_json()).keys() == \
        json.loads(jcp.ChipProfile().to_json()).keys()

"""The ``Scann`` facade, ``ScannBuilder`` and the configs of the PyTorch
port against the JAX package on the CPU: the eleven facade cases of
``tests/test_scann_facade.py`` that need neither the harness nor
``auto``, the same mode and inner searcher class for every config, the
same results when the JAX facade's index state is carried across (its
file, read by the port's ``load_index``), configs that serialize to the
JAX package's very dict, and a mesh raising.

Tolerance: results equal the JAX facade's, ids exactly and distances
within 1e-5 relative (the same float32 arithmetic in another order). The
hashed mode selects its re-rank candidates on bf16 LUT16 scores in the
port and float32 scores in the JAX CPU path, which can swap a candidate
that ties at the pre_k boundary (ROADMAP queue 3); these data hold no such
tie, and ``test_torch_hasher.py`` compares that path tie by tie.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import scann_tpu.config as jcfg
from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.io import save_index as jax_save_index
from scann_tpu.models.scann import Scann as JaxScann
from scann_tpu.models.scann import ScannBuilder as JaxBuilder
import scann_tpu_torch as T
import scann_tpu_torch.config as pcfg
from scann_tpu_torch.errors import ScannError
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5


@pytest.fixture(scope="module")
def small_db():
    return np.random.default_rng(42).normal(size=(600, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def clustered():
    """``test_query_config_honored``'s data: 2000 x 24 around 16 centres."""
    rng = np.random.default_rng(9)
    centers = rng.normal(size=(16, 24)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 16, 2000)]
          + rng.normal(size=(2000, 24)).astype(np.float32))
    q = (centers[rng.integers(0, 16, 8)]
         + rng.normal(size=(8, 24)).astype(np.float32))
    return db, q


def _both(cfg_fn):
    """The same config in both packages: built with the JAX classes, read
    by the port from the JAX JSON."""
    jc = cfg_fn(jcfg)
    return jc, T.ScannConfig.from_json(jc.to_json())


def _carried(jax_facade, db, tmp_path):
    """A port facade around the JAX facade's index state (its file, read by
    the port's ``load_index``), with the config from the file."""
    path = str(tmp_path / "facade.npz")
    jax_save_index(path, jax_facade)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    assert meta["facade"] is True
    return T.Scann(T.DenseDataset(db),
                   T.ScannConfig.from_dict(meta["scann_config"]),
                   _impl=T.load_index(path, device="cpu"),
                   _mode=T.SearchMode(jax_facade.search_mode.value),
                   device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    fin = np.isfinite(want[1])
    np.testing.assert_array_equal(fin, np.isfinite(got[1]))
    np.testing.assert_allclose(got[1][fin], want[1][fin], rtol=RTOL,
                               atol=1e-5)


# every mode the facade routes to, as a function of the config module
MODES = {
    "brute_force": lambda c: c.ScannConfig(),
    "partitioned": lambda c: c.ScannConfig().with_partitioning(
        c.PartitioningConfig(num_partitions=8)),
    "hashed": lambda c: c.ScannConfig().with_hashing(
        c.HashConfig(num_blocks=4, num_buckets=16)),
    "hashed_reorder": lambda c: c.ScannConfig(
        hash=c.HashConfig(num_blocks=4, num_buckets=16),
        exact_reordering=c.ExactReorderingConfig(num_candidates=100)),
    "tree_ah": lambda c: c.ScannConfig(num_neighbors=5).with_partitioning(
        c.PartitioningConfig(num_partitions=8, num_partitions_to_search=4)
    ).with_hashing(c.HashConfig(num_blocks=4, num_buckets=16)
                   ).with_reordering(c.ExactReorderingConfig(
                       num_candidates=50)),
    "scalar_quantized": lambda c: c.ScannConfig().with_brute_force(
        c.BruteForceConfig().with_scalar_quantization(8)),
    "scalar_quantized_int4": lambda c: c.ScannConfig().with_brute_force(
        c.BruteForceConfig().with_scalar_quantization(4)),
    "block_sweep": lambda c: c.ScannConfig(num_neighbors=5).with_brute_force(
        c.BruteForceConfig().with_block_sweep(pre_k=64)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_impl_and_carried_results_match_jax(mode, small_db, tmp_path):
    """Same SearchMode and inner searcher class as the JAX facade for the
    config; the same results from the JAX facade's carried index state,
    with the facade's own k and parameters (HASHED's configured re-rank
    depth included) and with a query_config."""
    jc, pc = _both(MODES[mode])
    js = JaxScann(JaxDataset(small_db), jc)
    ps = T.Scann(T.DenseDataset(small_db), pc, device="cpu")
    assert ps.search_mode.value == js.search_mode.value
    assert type(ps.impl).__name__ == type(js.impl).__name__
    assert ps.describe() == {
        **js.describe(), "impl": type(js.impl).__name__}
    carried = _carried(js, small_db, tmp_path)
    q = small_db[:6] + 0.05
    _same(carried.search_batched_arrays(q), js.search_batched_arrays(q))
    qc = (jcfg.QueryConfig(num_neighbors=3),
          T.QueryConfig(num_neighbors=3))
    _same(carried.search_batched_arrays(q, query_config=qc[1]),
          js.search_batched_arrays(q, query_config=qc[0]))


# -- the eleven facade cases of tests/test_scann_facade.py ---------------------


def test_default_is_brute_force(small_db):
    s = T.Scann(T.DenseDataset(small_db), device="cpu")
    assert s.search_mode == T.SearchMode.BRUTE_FORCE
    res = s.search(small_db[5], 3)
    assert res.neighbors[0].index == 5
    # no docids until the dataset API is ported (ROADMAP item 8c)
    assert s._docids() is None and res.neighbors[0].docid is None


def test_mode_selection(small_db):
    ds = T.DenseDataset(small_db)
    cpu = dict(device="cpu")
    assert T.Scann(ds, T.ScannConfig().with_partitioning(
        T.PartitioningConfig(num_partitions=8)), **cpu
    ).search_mode == T.SearchMode.PARTITIONED
    assert T.Scann(ds, T.ScannConfig().with_hashing(
        T.HashConfig(num_blocks=4, num_buckets=16)), **cpu
    ).search_mode == T.SearchMode.HASHED
    cfg = (T.ScannConfig()
           .with_partitioning(T.PartitioningConfig(num_partitions=8))
           .with_hashing(T.HashConfig(num_blocks=4, num_buckets=16)))
    assert T.Scann(ds, cfg, **cpu).search_mode == T.SearchMode.TREE_AH


def test_builder(small_db):
    s = (T.ScannBuilder()
         .num_neighbors(5)
         .tree(num_partitions=8, partitions_to_search=4)
         .hash(num_blocks=4, num_buckets=16)
         .reorder(50)
         .build(T.DenseDataset(small_db), device="cpu"))
    assert s.search_mode == T.SearchMode.TREE_AH
    idx, dist = s.search_batched_arrays(small_db[:4])
    assert idx.shape == (4, 5)
    assert (idx[:, 0] == np.arange(4)).all()
    # the facade only routes: its tree-x-AH depth is the config's 50
    assert s.impl.config.pre_reorder_multiplier == 10.0
    assert s.impl.config.hash_config.seed == 42
    want = (JaxBuilder().num_neighbors(5).tree(8, 4).hash(4, 16).reorder(50)
            ._config.to_dict())
    assert s.config.to_dict() == want


def test_scalar_quantized_mode(small_db):
    s = T.Scann(T.DenseDataset(small_db), T.ScannConfig().with_brute_force(
        T.BruteForceConfig().with_scalar_quantization(8)), device="cpu")
    res = s.search(small_db[10], 1)
    assert res.neighbors[0].index == 10


def test_empty_dataset_rejected():
    with pytest.raises(ScannError):
        T.Scann(T.DenseDataset(np.zeros((0, 8), np.float32)), device="cpu")


def test_block_sweep_facade_mode(small_db):
    cfg = T.ScannConfig(num_neighbors=5).with_brute_force()
    cfg.brute_force.with_block_sweep(pre_k=64)
    s = T.Scann(T.DenseDataset(small_db), cfg, device="cpu")
    assert isinstance(s.impl, T.BlockSweepSearcher)
    idx, _ = s.search_batched_arrays(small_db[:4], 5)
    assert idx.shape == (4, 5)
    assert all(idx[i, 0] == i for i in range(4))


def test_query_config_honored(clustered):
    db, q = clustered
    s = T.Scann(T.DenseDataset(db), T.ScannConfig(
        num_neighbors=5,
        partitioning=T.PartitioningConfig(num_partitions=16,
                                          num_partitions_to_search=2),
        hash=T.HashConfig(num_blocks=6, num_buckets=16)), device="cpu")
    i3, _ = s.search_batched_arrays(q, query_config=T.QueryConfig(
        num_neighbors=3))
    assert i3.shape == (8, 3)
    i_narrow, _ = s.search_batched_arrays(q, 5)
    i_wide, _ = s.search_batched_arrays(q, 5, query_config=T.QueryConfig(
        num_partitions_to_search=16, reordering_num_candidates=100))
    gt, _ = T.BruteForceSearcher(T.DenseDataset(db), device="cpu") \
        .search_batched_arrays(q, 5)
    r_n = np.mean([len(set(a) & set(g)) / 5 for a, g in zip(i_narrow, gt)])
    r_w = np.mean([len(set(a) & set(g)) / 5 for a, g in zip(i_wide, gt)])
    assert r_w >= r_n - 1e-9
    assert r_w >= 0.9
    i_p, _ = s.search_batched_arrays(
        q, 4, params=T.SearchParameters(num_leaves_to_search=16,
                                        pre_reordering_num_neighbors=100),
        query_config=T.QueryConfig(num_neighbors=2))
    assert i_p.shape == (8, 4)


def test_query_config_keeps_configured_reordering(small_db):
    q = small_db[:6]
    s = T.Scann(T.DenseDataset(small_db), T.ScannConfig(
        hash=T.HashConfig(num_blocks=4, num_buckets=16),
        exact_reordering=T.ExactReorderingConfig(num_candidates=100)),
        device="cpu")
    i_plain, d_plain = s.search_batched_arrays(q, 5)
    i_qc, d_qc = s.search_batched_arrays(
        q, 5, query_config=T.QueryConfig(num_neighbors=5))
    np.testing.assert_array_equal(i_plain, i_qc)
    np.testing.assert_allclose(d_plain, d_qc, rtol=1e-6)
    exact = ((q[:, None, :] - small_db[i_qc]) ** 2).sum(-1)
    np.testing.assert_allclose(d_qc, exact, rtol=1e-4, atol=1e-4)
    k, params = s.search_arguments(5, None, T.QueryConfig(num_neighbors=5))
    assert params.pre_reordering_num_neighbors == 100


def test_query_config_epsilon_filters_final_distances(small_db):
    q = small_db[:4]
    s = T.Scann(T.DenseDataset(small_db), T.ScannConfig(
        hash=T.HashConfig(num_blocks=4, num_buckets=16),
        exact_reordering=T.ExactReorderingConfig(num_candidates=100)),
        device="cpu")
    _, d_all = s.search_batched_arrays(q, 5)
    eps = float(np.sort(d_all, axis=1)[:, 2].max())
    idx, dists = s.search_batched_arrays(
        q, 5, query_config=T.QueryConfig(epsilon=eps))
    kept = idx >= 0
    assert kept.any() and (~kept).any()
    assert np.all(dists[kept] <= eps + 1e-6)
    np.testing.assert_array_equal(idx[~kept], -1)


def test_hashed_mode_threads_rerank_dtype(small_db):
    s = T.Scann(T.DenseDataset(small_db), T.ScannConfig(
        hash=T.HashConfig(num_blocks=4, num_buckets=16),
        exact_reordering=T.ExactReorderingConfig(num_candidates=60,
                                                 quantized=True)),
        device="cpu")
    assert s.search_mode == T.SearchMode.HASHED
    assert s.impl.config.rerank_dtype == "int8"
    idx, _ = s.search_batched_arrays(small_db[:4], 3)
    assert idx.shape == (4, 3)
    assert (idx >= 0).all()


def test_block_sweep_honors_reordering_depth(small_db):
    cfg = T.ScannConfig(exact_reordering=T.ExactReorderingConfig(
        num_candidates=77))
    cfg.with_brute_force()
    cfg.brute_force.block_sweep = True
    s = T.Scann(T.DenseDataset(small_db), cfg, device="cpu")
    assert s.impl.config.pre_reorder_k == 77


# -- what waits for other items ---------------------------------------------


def test_auto_with_a_mesh_raises_naming_item_11(small_db):
    """``Scann.auto`` runs without a mesh (``test_torch_autotune.py``); a
    mesh needs the sharded searchers and raises naming their ROADMAP item,
    before anything is built."""
    ds = T.DenseDataset(small_db)
    with pytest.raises(NotImplementedError, match="11"):
        T.Scann.auto(ds, mesh=object())
    with pytest.raises(NotImplementedError, match="11"):
        T.Scann.auto(ds, target_recall=0.9, mesh=object(), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU host")
def test_entry_points_default_to_the_card(small_db, tmp_path):
    """Without ``device`` every entry point asks for the CUDA device and
    raises on a host without one."""
    ds = T.DenseDataset(small_db)
    path = str(tmp_path / "bf.npz")
    T.save_index(path, T.Scann(ds, device="cpu"))
    for call in (lambda: T.Scann(ds), lambda: T.ScannBuilder().build(ds),
                 lambda: T.Scann.brute_force(ds),
                 lambda: T.PartitionedSearcher(ds),
                 lambda: T.load_index(path)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- configs -------------------------------------------------------------------


def _every_setter(c):
    """Configs built through every with_* setter and predicate-relevant
    field, in the module ``c`` (either package's config module)."""
    m = T.DistanceMeasure.COSINE.value
    return [
        c.ScannConfig(),
        c.ScannConfig().with_num_neighbors(7).with_distance_measure(
            type(c.ScannConfig().distance_measure)(m)),
        c.ScannConfig().with_brute_force(),
        c.ScannConfig().with_brute_force(
            c.BruteForceConfig().with_scalar_quantization(4)),
        c.ScannConfig().with_brute_force(c.BruteForceConfig().with_block_sweep(
            pre_k=32, sweep_dtype="int8", top2=True)),
        c.ScannConfig().with_partitioning(
            c.PartitioningConfig().with_partitions_to_search(3)
            .with_spilling(0.2).with_levels(2)),
        c.ScannConfig().with_partitioning(
            c.PartitioningConfig(max_partition_size=None).with_soar(2.0)),
        c.ScannConfig().with_hashing(
            c.HashConfig().with_type(c.HashType.PRODUCT_QUANTIZATION)
            .with_buckets(16).with_blocks(8)
            .with_lut_format(c.LutFormat.FLOAT)
            .with_anisotropic_threshold(0.2)),
        c.ScannConfig().with_reordering(),
        c.ScannConfig().with_reordering(
            c.ExactReorderingConfig(num_candidates=30).with_quantized()),
        c.ScannConfig(exact_reordering=c.ExactReorderingConfig(
            rerank_dtype="bfloat16")),
    ]


def test_configs_serialize_to_the_jax_dicts():
    for got, want in zip(_every_setter(pcfg), _every_setter(jcfg)):
        assert got.to_dict() == want.to_dict()
        assert json.loads(got.to_json()) == json.loads(want.to_json())
        for method in ("has_partitioning", "has_hashing", "has_reordering"):
            assert getattr(got, method)() == getattr(want, method)()
    for qc in (pcfg.QueryConfig(), pcfg.QueryConfig(3, 4, 50, 0.5)):
        want = jcfg.QueryConfig(**dataclasses.asdict(qc))
        assert qc.to_dict() == want.to_dict()
        got_p, want_p = qc.to_search_parameters(), want.to_search_parameters()
        assert dataclasses.asdict(got_p) == dataclasses.asdict(want_p)


def test_each_package_reads_the_others_json():
    for p, j in zip(_every_setter(pcfg), _every_setter(jcfg)):
        assert pcfg.ScannConfig.from_json(j.to_json()) == p
        assert jcfg.ScannConfig.from_json(p.to_json()) == j
        assert pcfg.ScannConfig.from_dict(p.to_dict()) == p
    # an explicit None keeps its meaning against a non-None default
    d = pcfg.PartitioningConfig(max_partition_size=None).to_dict()
    assert pcfg.PartitioningConfig.from_dict(d).max_partition_size is None
    assert jcfg.PartitioningConfig.from_dict(d).max_partition_size is None
    # nested None is absent
    assert pcfg.ScannConfig.from_dict({"hash": None}).hash is None

"""The sharded flagship searchers of the PyTorch port against the JAX
package's, on the CPU. Mirrors every test of
``tests/test_sharded_flagship.py``: the JAX wrapper runs on its 8 virtual
CPU devices, the port's on a mesh of as many CPU shards
(``make_mesh(devices=[cpu] * n)``), both over one index that the JAX
package built and saved (``save_index``); the sharded builds run in each
package from the same data and config.

Off the TPU the JAX tree-x-AH wrapper scores leaves per pair in float32 and
the hasher's takes its plain score path, where the port's defaults are the
grouped scorer (#1) and the fused LUT16 sweep (#7): the parity tests pin
``force_kernel`` to the same path on both sides.

Tolerances: ids equal except where two results tie (within the distance
tolerance); distances within 1e-5 of ``||q||^2 + ||x||^2`` (the size of the
float32 terms the exact formula cancels, summed in another order; 2 for
cosine on unit rows); recall within 0.02 of JAX's for the builds, whose
k-means inits draw from different generators. Beside the JAX tests: the
per-shard layouts equal JAX's array for array, and ``save_layout`` files
load in both directions. The int8 re-rank store matches JAX's sharded
layout (each CSR row anchored on its own partition's centroid), not the
single-device store."""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

from scann_tpu import BruteForceSearcher as JaxBF
from scann_tpu import DenseDataset as JaxDataset
from scann_tpu import SearchParameters as JaxParams
from scann_tpu.hashes.hasher import AsymmetricHasher as JaxHasher
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.io import save_index
from scann_tpu.models.block_sweep import BlockSweepConfig as JaxSweepConfig
from scann_tpu.models.block_sweep import BlockSweepSearcher as JaxSweep
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig as JaxTreeConfig
from scann_tpu.models.tree_x_hybrid import TreeXHybridSearcher as JaxTree
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.parallel import sharded_flagship as jsf
from scann_tpu.parallel.mesh import make_mesh as jax_mesh
import scann_tpu_torch as T
from scann_tpu_torch.parallel import make_mesh
from scann_tpu_torch.parallel import sharded_flagship as psf

CPU = torch.device("cpu")
K = 10


def _recall(idx, gt):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                    for a, b in zip(idx, gt)])


def _mesh(n=8):
    return make_mesh(devices=[CPU] * n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(24, 32)).astype(np.float32) * 3.0
    assign = rng.integers(0, 24, size=3000)
    db = (centers[assign] + rng.normal(size=(3000, 32)) * 0.5).astype(
        np.float32)
    q = (centers[rng.integers(0, 24, size=16)]
         + rng.normal(size=(16, 32)) * 0.5).astype(np.float32)
    ds = JaxDataset(db)
    gt, _ = JaxBF(ds).search_batched_arrays(q, K)
    return db, q, ds, gt


@pytest.fixture(scope="module")
def saved(tmp_path_factory, data):
    """index(kind, **config) -> (JAX searcher, path of its save_index file,
    the port's searcher loaded from it on the CPU), built once a config."""
    db, _, ds, _ = data
    root = tmp_path_factory.mktemp("sharded")
    cache = {}

    def index(kind, **kw):
        key = (kind, tuple(sorted((k, repr(v)) for k, v in kw.items())))
        if key not in cache:
            hc = kw.pop("hash", {})
            if kind == "tree":
                j = JaxTree(JaxTreeConfig(
                    hash_config=JaxHashConfig(num_codes=16, num_subspaces=8,
                                              seed=5, **hc), **kw)).build(ds)
            else:
                j = JaxHasher(JaxHashConfig(seed=5, **kw)).build(ds)
            path = str(root / f"{kind}{len(cache)}.npz")
            save_index(path, j)
            cache[key] = (j, path, T.load_index(path, device="cpu"))
        return cache[key]

    return index


def _scale(q, db, ids, measure):
    """Size of the float32 terms of each result's exact distance."""
    if measure == "COSINE":
        return np.full(ids.shape, 2.0, np.float32)
    x = db[np.maximum(ids, 0)]
    qq = (q * q).sum(1)[:, None]
    xx = (x * x).sum(-1)
    return np.sqrt(qq * xx) if measure == "DOT_PRODUCT" else qq + xx


def _same(want, got, q, db, measure="SQUARED_L2"):
    """Ids equal away from ties, distances close (module docstring)."""
    wi, wd = want
    gi, gd = got
    assert gi.shape == wi.shape
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    tol = 1e-5 * (np.abs(wd) + _scale(q, db, wi, measure))
    err = np.abs(gd[fin] - wd[fin])
    assert np.all(err <= tol[fin]), float(err.max())
    for b, j in zip(*np.nonzero(gi != wi)):
        # a swap is allowed only between tied results
        tied = np.abs(wd[b] - wd[b, j]) <= tol[b, j]
        assert tied.sum() >= 2 or j == wi.shape[1] - 1, (b, j, wi[b], gi[b])
    assert np.mean(gi == wi) >= 0.98


def _exact_ok(q, db, idx, dists, measure="SQUARED_L2"):
    """Returned distances are exact in the measure's own units."""
    bf = JaxBF(JaxDataset(db), JaxMeasure[measure]).distances_to_all(q)
    m = idx >= 0
    np.testing.assert_allclose(
        dists[m], np.take_along_axis(bf, np.maximum(idx, 0), axis=1)[m],
        rtol=1e-3, atol=1e-3)


def _pair_tree(j, p, n=8, force="xla"):
    """The JAX sharded tree-x-AH wrapper and the port's, on one path."""
    return (jsf.ShardedTreeXHybridSearcher(
        j, jax_mesh(n, axis_names=("db",)), force_kernel=force),
        psf.ShardedTreeXHybridSearcher(p, _mesh(n), force_kernel=force))


def _pair_hasher(j, p, n=8, force="xla", **kw):
    return (jsf.ShardedAsymmetricHasher(
        j, jax_mesh(n, axis_names=("db",)), force_kernel=force, **kw),
        psf.ShardedAsymmetricHasher(p, _mesh(n), force_kernel=force, **kw))


def _both(pair, q, k, pre_k=None, **kw):
    """The two wrappers' results at the same parameters (epsilons and
    leaves through ``kw``)."""
    allow = kw.pop("allow_mask", None)
    jp = JaxParams(pre_reordering_num_neighbors=pre_k, **kw)
    pp = T.SearchParameters(pre_reordering_num_neighbors=pre_k, **kw)
    return (pair[0].search_batched_arrays(q, k, jp, allow_mask=allow),
            pair[1].search_batched_arrays(q, k, pp, allow_mask=allow))


def _bits(x):
    """A layout array as comparable numpy bits (bf16 as int16 views)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if str(x.dtype) == "bfloat16" else x


def _same_layout(want: dict, got: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if w is None or isinstance(w, (int, float, tuple, list)):
            assert g == w, key
            continue
        w, g = _bits(w), _bits(g)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


# -- the hasher ----------------------------------------------------------------


def test_sharded_ah_sweep_matches_single_device(data, saved):
    db, q, ds, gt = data
    j, _, p = saved("hasher", num_codes=16, num_subspaces=8)
    want, got = _both(_pair_hasher(j, p), q, K, pre_k=100)
    _same(want, got, q, db)
    i1, _ = p.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=100))
    # every shard keeps a full local pre_k: recall >= one device's
    assert _recall(got[0], gt) >= _recall(i1, gt) - 1e-9
    assert _recall(got[0], gt) >= 0.9
    _exact_ok(q, db, *got)


def test_sharded_tree_ah_matches_single_device(data, saved):
    db, q, ds, gt = data
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=8)
    pair = _pair_tree(j, p)
    want, got = _both(pair, q, K, pre_k=120)
    _same(want, got, q, db)
    i1, _ = p.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=120))
    r1, r2 = _recall(i1, gt), _recall(got[0], gt)
    assert r2 >= r1 - 0.02, (r1, r2)
    assert r2 >= 0.9
    _exact_ok(q, db, *got)
    ids, dists = pair[1].search_batched_tensors(
        torch.from_numpy(q), K, T.SearchParameters(
            pre_reordering_num_neighbors=120))
    np.testing.assert_array_equal(ids.numpy(), got[0])


def test_sharded_tree_ah_spilling_unique(data, saved):
    db, q, ds, gt = data
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=8,
                    spilling=True, spilling_threshold=0.6)
    assert p.partitioner.tokenization.max_multiplicity > 1
    want, got = _both(_pair_tree(j, p), q, K, pre_k=120)
    _same(want, got, q, db)
    for row in got[0]:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real), row
    i1, _ = p.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=120))
    r1, r2 = _recall(i1, gt), _recall(got[0], gt)
    assert r2 >= r1 - 0.02, (r1, r2)
    assert r2 >= 0.9


def test_sharded_tree_ah_uneven_mesh(data, saved):
    """3 shards: bin packing with a partition count not divisible by it."""
    db, q, ds, gt = data
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=8)
    want, got = _both(_pair_tree(j, p, n=3), q, K, pre_k=120)
    _same(want, got, q, db)
    assert _recall(got[0], gt) >= 0.9


# -- non-L2 measures -------------------------------------------------------------


@pytest.mark.parametrize("measure", ["COSINE", "DOT_PRODUCT"])
def test_sharded_ah_sweep_non_l2(data, saved, measure):
    db, q, ds, _ = data
    gt, _ = JaxBF(ds, JaxMeasure[measure]).search_batched_arrays(q, K)
    j, _, p = saved("hasher", num_codes=16, num_subspaces=8,
                    distance_measure=JaxMeasure[measure])
    want, got = _both(_pair_hasher(j, p), q, K, pre_k=100)
    _same(want, got, q, db, measure)
    i1, _ = p.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=100))
    r1, r2 = _recall(i1, gt), _recall(got[0], gt)
    assert r2 >= r1 - 1e-9, (measure, r1, r2)
    assert r2 >= 0.9, (measure, r2)
    _exact_ok(q, db, *got, measure)


@pytest.mark.parametrize("measure", ["COSINE", "DOT_PRODUCT"])
def test_sharded_tree_ah_non_l2(data, saved, measure):
    db, q, ds, _ = data
    gt, _ = JaxBF(ds, JaxMeasure[measure]).search_batched_arrays(q, K)
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=12,
                    distance_measure=JaxMeasure[measure])
    want, got = _both(_pair_tree(j, p), q, K, pre_k=120)
    _same(want, got, q, db, measure)
    i1, _ = p.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=120))
    r1, r2 = _recall(i1, gt), _recall(got[0], gt)
    assert r2 >= r1 - 0.02, (measure, r1, r2)
    assert r2 >= 0.85, (measure, r2)
    _exact_ok(q, db, *got, measure)


# -- restricts and epsilons ------------------------------------------------------


def test_sharded_ah_sweep_allow_mask(data, saved):
    db, q, ds, gt = data
    j, _, p = saved("hasher", num_codes=16, num_subspaces=8)
    allow = np.zeros(len(db), dtype=bool)
    allow[::2] = True
    # the port's default (the fused sweep) takes the plain path under a mask
    pair = _pair_hasher(j, p, force=None)
    want, got = _both(pair, q, K, pre_k=100, allow_mask=allow)
    _same(want, got, q, db)
    assert np.all(got[0][got[0] >= 0] % 2 == 0)
    gt_f, _ = JaxBF(ds).search_batched_arrays(q, K, allow_mask=allow)
    assert _recall(got[0], gt_f) >= 0.85


def test_sharded_tree_ah_allow_mask_and_epsilons(data, saved):
    db, q, ds, gt = data
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=12)
    pair = _pair_tree(j, p)
    allow = np.zeros(len(db), dtype=bool)
    allow[::2] = True
    want, got = _both(pair, q, K, pre_k=120, allow_mask=allow)
    _same(want, got, q, db)
    assert np.all(got[0][got[0] >= 0] % 2 == 0)
    gt_f, _ = JaxBF(ds).search_batched_arrays(q, K, allow_mask=allow)
    assert _recall(got[0], gt_f) >= 0.85

    # post-eps filters exactly the searcher's own > eps results
    _, (base_i, base_d) = _both(pair, q, K, pre_k=120)
    eps = float(np.median(base_d[:, 4]))
    want, got = _both(pair, q, K, pre_k=120, post_reordering_epsilon=eps)
    _same(want, got, q, db)
    valid = got[0] >= 0
    assert np.all(got[1][valid] <= eps + 1e-5)
    np.testing.assert_array_equal(valid, base_d <= eps + 1e-6)

    # a hostile pre-eps masks everything
    want, got = _both(pair, q, K, pre_k=120, pre_reordering_epsilon=-1.0)
    assert np.all(got[0] == -1) and np.all(np.isinf(got[1]))
    np.testing.assert_array_equal(got[0], want[0])


def test_sharded_cosine_pre_epsilon_units(data, saved):
    """A cosine pre-eps just above the true top-k distances must not
    filter: the approximate scores compare in the measure's units."""
    db, q, ds, _ = data
    gt, gt_dist = JaxBF(ds, JaxMeasure.COSINE).search_batched_arrays(q, K)
    j, _, p = saved("hasher", num_codes=256, num_subspaces=16,
                    distance_measure=JaxMeasure.COSINE)
    eps = float(gt_dist[:, 9].max()) * 1.3
    pair = _pair_hasher(j, p, force=None)
    assert not pair[1]._fused_ok      # 256 codes: the plain path
    want, got = _both(pair, q, K, pre_k=100, pre_reordering_epsilon=eps)
    _same(want, got, q, db, "COSINE")
    assert np.all(got[0] >= 0)
    assert np.all(got[1] <= eps + 1e-4)


# -- the kernels' paths in each shard ---------------------------------------------


def test_sharded_tree_ah_grouped_kernel_parity(data, saved):
    """The grouped scorer in every shard (the port's twin of #1, the JAX
    Pallas kernel in interpret mode): the same results on both sides, and
    the port's grouped path against its per-pair path."""
    db, q, ds, gt = data
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=8)
    pair = _pair_tree(j, p, force="grouped")
    assert pair[1]._use_grouped and pair[1]._packed
    want, got = _both(pair, q, K, pre_k=120)
    _same(want, got, q, db)
    default = psf.ShardedTreeXHybridSearcher(p, _mesh())
    assert default._use_grouped
    _, (i_x, d_x) = _both(_pair_tree(j, p), q, K, pre_k=120)
    i_g, d_g = got
    assert _recall(i_g, gt) >= _recall(i_x, gt) - 0.02
    assert _recall(i_g, gt) >= 0.9
    m = (i_x >= 0) & (i_g >= 0) & (i_x == i_g)
    np.testing.assert_allclose(d_g[m], d_x[m], rtol=1e-3, atol=1e-3)


def test_sharded_ah_fused_kernel_parity(data, saved):
    """The fused LUT16 sweep in every shard (the port's twin of #7, the
    JAX Pallas kernel in interpret mode) on 2 shards."""
    db, q, ds, gt = data
    j, _, p = saved("hasher", num_codes=16, num_subspaces=16)
    pair = _pair_hasher(j, p, n=2, force="fused", fused_r=8)
    assert pair[1]._use_fused(60, False)
    want, got = _both(pair, q, K, pre_k=60)
    _same(want, got, q, db)
    _, (i_x, d_x) = _both(_pair_hasher(j, p, n=2), q, K, pre_k=60)
    i_f, d_f = got
    # the fused sweep pays the one-candidate-per-r-block loss
    assert _recall(i_f, gt) >= 0.85
    assert _recall(i_f, gt) >= _recall(i_x, gt) - 0.05
    m = (i_x >= 0) & (i_f >= 0) & (i_x == i_f)
    np.testing.assert_allclose(d_f[m], d_x[m], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("rdt", ["bfloat16", "int8"])
def test_sharded_tree_ah_low_precision_rerank(data, saved, rdt):
    """The wrapped searcher's rerank_dtype reaches the per-shard store:
    bf16 rows, or int8 codes of each CSR row's residual against its own
    partition's centroid (JAX's sharded layout) with the per-row token
    table; the same results as the JAX wrapper."""
    db, q, ds, gt = data
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=8,
                    rerank_dtype=rdt)
    pair = _pair_tree(j, p)
    store = pair[1]._db[0]
    if rdt == "bfloat16":
        assert store.dtype == torch.bfloat16
    else:
        assert store[0].dtype == torch.uint8 and len(store) == 5
    want, got = _both(pair, q, K, pre_k=120)
    _same(want, got, q, db)
    i1, _ = p.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=120))
    r1, r2 = _recall(i1, gt), _recall(got[0], gt)
    assert r2 >= r1 - 0.02, (r1, r2)
    assert r2 >= 0.9


@pytest.mark.parametrize("rdt", ["bfloat16", "int8"])
def test_sharded_ah_sweep_low_precision_rerank(data, saved, rdt):
    db, q, ds, gt = data
    j, _, p = saved("hasher", num_codes=16, num_subspaces=8,
                    rerank_dtype=rdt)
    pair = _pair_hasher(j, p)
    store = pair[1]._db[0]
    if rdt == "bfloat16":
        assert store.dtype == torch.bfloat16
    else:
        assert store[0].dtype == torch.uint8
    want, got = _both(pair, q, K, pre_k=100)
    _same(want, got, q, db)
    i1, _ = p.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=100))
    r1, r2 = _recall(i1, gt), _recall(got[0], gt)
    assert r2 >= r1 - 0.02, (r1, r2)
    assert r2 >= 0.9


def test_sharded_ah_k_wider_than_shard_block(data, saved):
    """k larger than one shard's block: the merged output still has k
    columns, and with pre_k clamped to every local row the search is
    exact."""
    db, q, ds, gt = data
    j, _, p = saved("hasher", num_codes=16, num_subspaces=8)
    pair = _pair_hasher(j, p)
    k = 2000
    assert k > pair[1]._blk
    want, got = _both(pair, q, k)
    _same(want, got, q, db)
    assert got[0].shape == (len(q), k) and (got[0] >= 0).all()
    exact = np.sort(((q[:, None, :] - db[None, :, :]) ** 2).sum(-1),
                    axis=1)[:, :k]
    np.testing.assert_allclose(got[1], exact, rtol=1e-3, atol=1e-3)


def test_sharded_tree_ah_k_beyond_candidate_ceiling(data, saved):
    """k beyond n_shards * the per-shard candidate ceiling pads to the
    [B, k] contract."""
    db, q, ds, gt = data
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=2)
    k = 2500
    want, got = _both(_pair_tree(j, p), q, k)
    _same(want, got, q, db)
    idx, dists = got
    assert idx.shape == (len(q), k)
    assert (idx[:, 0] >= 0).all()
    pad = idx < 0
    assert pad.any() and np.all(np.isinf(dists[pad]))


def test_sharded_tree_ah_crowding(data, saved):
    """Crowding over the sharded searcher (the base class's over-fetch):
    the per-group cap holds on the merged results, which equal the JAX
    wrapper's and share >= 8 of 10 with the single-device crowded search."""
    from scann_tpu.restricts.crowding import (
        CrowdingConfig as JaxCrowdingConfig,
        CrowdingConstraint as JaxCrowding,
    )
    from scann_tpu_torch.restricts.crowding import (
        CrowdingConfig,
        CrowdingConstraint,
    )

    db, q, ds, gt = data
    attrs = (np.arange(len(db)) % 7).astype(np.int64)
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=12)
    pair = _pair_tree(j, p)
    res_j = pair[0].search_with_crowding(
        q, K, JaxCrowding(attrs, JaxCrowdingConfig(per_crowd_limit=2,
                                                   enabled=True)),
        JaxParams(pre_reordering_num_neighbors=120))
    c = CrowdingConstraint(attrs, CrowdingConfig(per_crowd_limit=2,
                                                 enabled=True))
    params = T.SearchParameters(pre_reordering_num_neighbors=120)
    res_sh = pair[1].search_with_crowding(q, K, c, params)
    res_1d = p.search_with_crowding(q, K, c, params)
    for r_sh, r_j, r_1d in zip(res_sh, res_j, res_1d):
        ids = [n.index for n in r_sh.neighbors if n.index >= 0]
        assert ids == [n.index for n in r_j.neighbors if n.index >= 0]
        _, counts = np.unique(attrs[ids], return_counts=True)
        assert counts.max() <= 2
        assert len(ids) == K
        ids_1d = [n.index for n in r_1d.neighbors if n.index >= 0]
        assert len(set(ids) & set(ids_1d)) >= 8


# -- the block sweep -------------------------------------------------------------


def _sweep_pair(db, n=8, **cfg_kw):
    """(JAX single, JAX sharded, port single, port sharded) at one config."""
    base = dict(tile_n=256, block_r=8, pre_reorder_k=48)
    jcfg = dict(base, **cfg_kw)
    pcfg = dict(base, **cfg_kw)
    if "distance_measure" in cfg_kw:
        jcfg["distance_measure"] = JaxMeasure[cfg_kw["distance_measure"]]
        pcfg["distance_measure"] = T.DistanceMeasure[
            cfg_kw["distance_measure"]]
    js = JaxSweep(JaxDataset(db), JaxSweepConfig(**jcfg))
    ps = T.BlockSweepSearcher(T.DenseDataset(db), T.BlockSweepConfig(**pcfg),
                              device="cpu")
    return (js, jsf.ShardedBlockSweepSearcher(js, jax_mesh(
        n, axis_names=("db",))), ps,
        psf.ShardedBlockSweepSearcher(ps, _mesh(n)))


def test_sharded_block_sweep_matches_single_device(data):
    db, q, ds, gt = data
    js, jsh, ps, psh = _sweep_pair(db)
    want = jsh.search_batched_arrays(q, K)
    got = psh.search_batched_arrays(q, K)
    _same(want, got, q, db)
    i1, _ = ps.search_batched_arrays(q, K)
    # every shard keeps a full local pre_k: recall >= one device's
    assert _recall(got[0], gt) >= _recall(i1, gt) - 1e-9
    assert _recall(got[0], gt) >= 0.9
    assert got[0].max() < ds.size and np.all(np.isfinite(got[1]))
    ids, _ = psh.search_batched_tensors(torch.from_numpy(q), K)
    np.testing.assert_array_equal(ids.numpy(), got[0])


@pytest.mark.parametrize("measure", ["COSINE", "DOT_PRODUCT"])
def test_sharded_block_sweep_measures(data, measure):
    db, q, ds, _ = data
    gt_m, _ = JaxBF(ds, distance_measure=JaxMeasure[measure]
                    ).search_batched_arrays(q, K)
    js, jsh, ps, psh = _sweep_pair(db, distance_measure=measure)
    got = psh.search_batched_arrays(q, K)
    _same(jsh.search_batched_arrays(q, K), got, q, db, measure)
    assert _recall(got[0], gt_m) >= 0.9
    _exact_ok(q, db, *got, measure)


def test_sharded_block_sweep_int8_and_rerank_dtype(data):
    db, q, ds, gt = data
    js, jsh, ps, psh = _sweep_pair(db, sweep_dtype="int8",
                                   rerank_dtype="bfloat16")
    assert psh._aug[0].dtype == torch.int8
    assert psh._rdb[0].dtype == torch.bfloat16
    got = psh.search_batched_arrays(q, K)
    _same(jsh.search_batched_arrays(q, K), got, q, db)
    assert _recall(got[0], gt) >= 0.9


def test_sharded_block_sweep_epsilons(data):
    db, q, ds, gt = data
    js, jsh, ps, psh = _sweep_pair(db)
    base_i, base_d = psh.search_batched_arrays(q, K)
    cut = float(np.median(base_d))
    got = psh.search_batched_arrays(
        q, K, params=T.SearchParameters(post_reordering_epsilon=cut))
    _same(jsh.search_batched_arrays(
        q, K, params=JaxParams(post_reordering_epsilon=cut)), got, q, db)
    kept = got[1][np.isfinite(got[1])]
    assert np.all(kept <= cut + 1e-5)
    assert (got[0] >= 0).sum() < (base_i >= 0).sum()


def test_sharded_block_sweep_top2(data):
    """The top-2 tournament in every shard: the JAX wrapper's results,
    recall >= one device's top-2, exact distances."""
    db, q, ds, gt = data
    js, jsh, ps, psh = _sweep_pair(db, top2=True)
    got = psh.search_batched_arrays(q, K)
    _same(jsh.search_batched_arrays(q, K), got, q, db)
    i1, _ = ps.search_batched_arrays(q, K)
    assert _recall(got[0], gt) >= _recall(i1, gt) - 1e-9
    assert _recall(got[0], gt) >= 0.9
    de = ((q[:, None, :] - db[got[0].clip(0)]) ** 2).sum(-1)
    m = got[0] >= 0
    np.testing.assert_allclose(got[1][m], de[m], rtol=1e-4, atol=1e-4)


def test_sharded_block_sweep_top2_narrow_prek(data):
    """With pre_k too small for one survivor a block to cover k, top-2's
    second survivor recovers recall."""
    db, q, ds, gt = data
    p = T.SearchParameters(pre_reordering_num_neighbors=12)
    _, jsh1, _, psh1 = _sweep_pair(db)
    _, jsh2, _, psh2 = _sweep_pair(db, top2=True)
    got1 = psh1.search_batched_arrays(q, K, p)
    got2 = psh2.search_batched_arrays(q, K, p)
    jp = JaxParams(pre_reordering_num_neighbors=12)
    _same(jsh1.search_batched_arrays(q, K, jp), got1, q, db)
    _same(jsh2.search_batched_arrays(q, K, jp), got2, q, db)
    assert _recall(got2[0], gt) >= _recall(got1[0], gt) - 1e-9


def test_sharded_block_sweep_no_shuffle(data):
    db, q, ds, gt = data
    js, jsh, ps, psh = _sweep_pair(db, shuffle=False)
    assert psh._inv is None
    got = psh.search_batched_arrays(q, K)
    _same(jsh.search_batched_arrays(q, K), got, q, db)
    assert _recall(got[0], gt) >= 0.9


def test_sharded_block_sweep_allow_mask(data):
    """The allowlist penalty fused into every shard's sweep: only allowed
    ids, the JAX wrapper's results, recall >= one device's."""
    db, q, ds, gt = data
    rng = np.random.default_rng(3)
    mask = rng.random(ds.size) < 0.05
    mask[:50] = True
    js, jsh, ps, psh = _sweep_pair(db)
    i1, _ = ps.search_batched_arrays(q, K, allow_mask=mask)
    got = psh.search_batched_arrays(q, K, allow_mask=mask)
    _same(jsh.search_batched_arrays(q, K, allow_mask=mask), got, q, db)
    v2 = got[0] >= 0
    assert v2.any() and np.all(mask[got[0][v2]])
    allowed = np.where(mask)[0]
    de = ((q[:, None, :] - db[None, allowed, :]) ** 2).sum(-1)
    gt_m = allowed[np.argsort(de, axis=1)[:, :K]]
    r1 = _recall(i1, gt_m)
    r2 = _recall(got[0], gt_m)
    assert r2 >= r1 - 1e-9
    assert r2 >= 0.9


# -- the sharded build -----------------------------------------------------------


def _builds(db, n=8, **cfg):
    """The JAX and the port sharded builds of one config (hash seed 42,
    8 iterations unless given)."""
    hc = dict(num_codes=16, num_subspaces=8, seed=42, max_iterations=8)
    hc.update(cfg.pop("hash", {}))
    jcfg, pcfg = dict(cfg), dict(cfg)
    if "distance_measure" in cfg:
        jcfg["distance_measure"] = JaxMeasure[cfg["distance_measure"]]
        pcfg["distance_measure"] = T.DistanceMeasure[cfg["distance_measure"]]
    j = jsf.ShardedTreeXHybridSearcher.build(
        JaxDataset(db), JaxTreeConfig(hash_config=JaxHashConfig(**hc),
                                      **jcfg), jax_mesh(n, axis_names=("db",)))
    pc = T.TreeXHybridConfig(hash_config=T.AsymmetricHasherConfig(**hc),
                             **pcfg)
    p = psf.ShardedTreeXHybridSearcher.build(T.DenseDataset(db), pc, _mesh(n))
    return j, p, pc


def _inertia(db, tp):
    toks = tp.tokenization.tokens.numpy()
    return float(((db - tp.centers.numpy()[toks]) ** 2).sum())


def _serve_both(j, p, q, pre_k=120, **kw):
    return (j.search_batched_arrays(q, K, JaxParams(
        pre_reordering_num_neighbors=pre_k, **kw)),
        p.search_batched_arrays(q, K, T.SearchParameters(
            pre_reordering_num_neighbors=pre_k, **kw)))


def _code_of(db, single, row, token):
    """The codebook argmin of one CSR row's residual on the host."""
    pt = int(single.partitioner.tokenization.point_indices[row])
    resid = db[pt] - single.partitioner.centers[token].numpy()
    cb = single.codebook.centroids.numpy()
    sub = resid.reshape(cb.shape[0], cb.shape[2])
    return np.argmin(((sub[:, None, :] - cb) ** 2).sum(-1),
                     axis=1).astype(np.uint8)


def test_sharded_build_end_to_end(data):
    """The port's sharded build (k-means, assignment and PQ encode with the
    rows only ever sharded): recall within 0.02 of the JAX sharded build's;
    inertia and recall beside the port's single-device build; the served
    results those of a single-device searcher over the same artifacts; a
    code spot-checked on the host."""
    db, q, ds, gt = data
    j, p, pc = _builds(db, num_partitions=24, partitions_to_search=12,
                       spilling=False)
    (i_j, _), (i_sh, d_sh) = _serve_both(j, p, q)
    assert _recall(i_sh, gt) >= 0.9
    assert abs(_recall(i_sh, gt) - _recall(i_j, gt)) <= 0.02

    single_build = T.TreeXHybridSearcher(pc, device="cpu").build(
        T.DenseDataset(db))
    assert _inertia(db, p._inner.partitioner) <= \
        _inertia(db, single_build.partitioner) * 1.25
    params = T.SearchParameters(pre_reordering_num_neighbors=120)
    i_1b, _ = single_build.search_batched_arrays(q, K, params)
    assert _recall(i_sh, gt) >= _recall(i_1b, gt) - 0.03

    i_1, d_1 = p._inner.search_batched_arrays(q, K, params)
    assert _recall(i_sh, i_1) >= 0.9
    m = i_sh == i_1
    np.testing.assert_allclose(d_sh[m], d_1[m], rtol=1e-4, atol=1e-4)

    tk = p._inner.partitioner.tokenization
    pt = int(tk.point_indices[0])
    np.testing.assert_array_equal(
        p._inner.codes[0].numpy(),
        _code_of(db, p._inner, 0, int(tk.tokens[pt])))


def test_sharded_build_soar_parity(data):
    """The SOAR build: every point gets a secondary, spilled copies dedup
    through the merge, quality beside the single-device SOAR build and the
    JAX sharded build, and a secondary CSR row encodes the residual against
    ITS partition's centroid."""
    db, q, ds, gt = data
    j, p, pc = _builds(db, num_partitions=24, partitions_to_search=12,
                       spilling=True, spilling_mode="soar")
    tk = p._inner.partitioner.tokenization
    assert tk.max_multiplicity > 1
    (i_j, _), (i_sh, _) = _serve_both(j, p, q)
    assert _recall(i_sh, gt) >= 0.9
    assert abs(_recall(i_sh, gt) - _recall(i_j, gt)) <= 0.02
    for row in i_sh:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    single = T.TreeXHybridSearcher(pc, device="cpu").build(T.DenseDataset(db))
    i_1, _ = single.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=120))
    assert _recall(i_sh, gt) >= _recall(i_1, gt) - 0.03
    assert _inertia(db, p._inner.partitioner) <= \
        _inertia(db, single.partitioner) * 1.25
    row_tokens = np.repeat(np.arange(tk.num_partitions),
                           tk.partition_sizes.numpy())
    pts = tk.point_indices.numpy()
    sec_rows = np.nonzero(row_tokens != tk.tokens.numpy()[pts])[0]
    assert len(sec_rows) > 0
    r = int(sec_rows[0])
    np.testing.assert_array_equal(p._inner.codes[r].numpy(),
                                  _code_of(db, p._inner, r, row_tokens[r]))


def test_sharded_build_distance_spilling(data):
    db, q, ds, gt = data
    j, p, _ = _builds(db, num_partitions=24, partitions_to_search=12,
                      spilling=True, spilling_mode="distance",
                      spilling_threshold=0.5)
    assert len(p._inner.partitioner.tokenization.point_indices) > len(db)
    (i_j, _), (i_sh, _) = _serve_both(j, p, q)
    assert _recall(i_sh, gt) >= 0.9
    assert abs(_recall(i_sh, gt) - _recall(i_j, gt)) <= 0.02
    for row in i_sh:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)


def test_sharded_build_hierarchical(data):
    """num_levels=2: a k-means tree's leaves seed the sharded Lloyd
    refinement."""
    db, q, ds, gt = data
    j, p, _ = _builds(db, num_partitions=25, partitions_to_search=12,
                      partition_num_levels=2)
    assert p._inner.partitioner.num_partitions >= 16
    (i_j, _), (i_sh, _) = _serve_both(j, p, q)
    assert _recall(i_sh, gt) >= 0.9
    assert abs(_recall(i_sh, gt) - _recall(i_j, gt)) <= 0.02


def test_sharded_build_avq_encode(data):
    """An anisotropic codebook encodes through the AVQ coordinate descent
    in every shard: the codes equal the codebook's own AVQ encode of the
    same residuals, with the raw rows as directions."""
    db, q, ds, gt = data
    j, p, _ = _builds(db, num_partitions=24, partitions_to_search=12,
                      hash=dict(anisotropic_threshold=0.2))
    single = p._inner
    assert single.codebook.eta is not None
    tk = single.partitioner.tokenization
    pts = tk.point_indices[:64]
    toks = torch.repeat_interleave(torch.arange(tk.num_partitions),
                                   tk.partition_sizes)[:64]
    x = torch.from_numpy(db)[pts]
    resid = x - single.partitioner.centers[toks]
    want = single.codebook.encode_dataset(resid, directions=x)
    np.testing.assert_array_equal(single.codes[:64].numpy(), want.numpy())
    (i_j, _), (i_sh, _) = _serve_both(j, p, q)
    assert _recall(i_sh, gt) >= 0.9
    assert abs(_recall(i_sh, gt) - _recall(i_j, gt)) <= 0.02


def test_sharded_build_cosine(data):
    db, q, ds, gt = data
    gt_c, _ = JaxBF(ds, distance_measure=JaxMeasure.COSINE
                    ).search_batched_arrays(q, K)
    j, p, _ = _builds(db, num_partitions=24, partitions_to_search=12,
                      distance_measure="COSINE")
    (i_j, _), (i_sh, _) = _serve_both(j, p, q)
    assert _recall(i_sh, gt_c) >= 0.9
    assert abs(_recall(i_sh, gt_c) - _recall(i_j, gt_c)) <= 0.02


def test_sharded_build_balance_cap():
    """Skewed data: the per-shard top-r tables and the host demote loop cap
    the partition sizes, as in the JAX sharded build."""
    rng = np.random.default_rng(13)
    big = rng.normal(size=(2400, 16)).astype(np.float32) * 0.3
    tail = rng.normal(size=(800, 16)).astype(np.float32) * 4.0 + 8.0
    db = np.concatenate([big, tail])
    hc = dict(num_codes=16, num_subspaces=8, seed=1, max_iterations=5)
    base = dict(num_partitions=16, partitions_to_search=16, hash=hc)
    _, uncapped, _ = _builds(db, max_partition_size=None, **dict(base))
    j_cap, capped, _ = _builds(db, max_partition_size="auto", **dict(base))
    mx_un = int(uncapped._inner.partitioner.tokenization.partition_sizes.max())
    mx_cap = int(capped._inner.partitioner.tokenization.partition_sizes.max())
    mx_jax = int(j_cap._inner.partitioner.tokenization.partition_sizes.max())
    cap = max(int(1.5 * 3200 / 16), 8)  # 300
    assert mx_cap <= mx_un
    assert mx_cap <= cap + 64 and mx_jax <= cap + 64
    q = db[rng.integers(0, len(db), size=16)]
    gt, _ = JaxBF(JaxDataset(db)).search_batched_arrays(q, K)
    n_c = capped._inner.partitioner.num_partitions
    n_u = uncapped._inner.partitioner.num_partitions
    i_c, _ = capped.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=400, num_leaves_to_search=n_c))
    i_u, _ = uncapped.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=400, num_leaves_to_search=n_u))
    assert _recall(i_c, gt) >= _recall(i_u, gt) - 0.05
    assert _recall(i_c, gt) >= 0.85


# -- layouts and their files ---------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(), dict(spilling=True, spilling_threshold=0.6),
    dict(rerank_dtype="bfloat16"), dict(rerank_dtype="int8")],
    ids=["plain", "spilled", "bf16", "int8"])
def test_tree_shard_layout_equals_jax(data, saved, cfg):
    """The per-shard tree layout (bin packing, 128-aligned local CSR,
    codes, perm, re-rank rows, the int8 anchor tokens and codec) is JAX's,
    array for array, on 8 and 3 shards."""
    _, _, _, _ = data
    j, _, p = saved("tree", num_partitions=24, partitions_to_search=8, **cfg)
    for n_sh in (8, 3):
        _same_layout(jsf._compute_tree_shard_layout(j, n_sh),
                     psf._compute_tree_shard_layout(p, n_sh))


@pytest.mark.parametrize("cfg", [
    dict(), dict(sweep_dtype="int8", rerank_dtype="bfloat16"),
    dict(rerank_dtype="int8", distance_measure="COSINE"),
    dict(shuffle=False, distance_measure="DOT_PRODUCT")],
    ids=["bf16", "int8-sweep", "int8-rerank-cosine", "noshuffle-dot"])
def test_sweep_shard_layout_equals_jax(data, cfg):
    """The per-shard block-sweep layout (the augmented sweep copy, the
    stored-order re-rank rows, the inverse permutation, the int8 scales)
    is JAX's, array for array."""
    db = data[0]
    js, jsh, ps, psh = _sweep_pair(db, **cfg)
    _same_layout(jsf._compute_sweep_shard_layout(js, 8),
                 psf._compute_sweep_shard_layout(ps, 8))


@pytest.mark.parametrize("kind", ["tree_ah", "block_sweep"])
def test_sharded_layout_files_load_both_ways(data, saved, tmp_path, kind):
    """A layout the JAX wrapper saved serves in the port with the JAX
    wrapper's results, and one the port saved loads in the JAX package
    with the port's results; both round trips bit-identical on their own
    side; a shard-count mismatch raises."""
    from scann_tpu.io import load_sharded_layout as jax_load_layout

    db, q, ds, gt = data
    if kind == "tree_ah":
        j, _, p = saved("tree", num_partitions=24, partitions_to_search=8,
                        rerank_dtype="int8")
        jw, pw = _pair_tree(j, p)
        kw = dict(force_kernel="xla")
    else:
        _, jw, _, pw = _sweep_pair(db, rerank_dtype="bfloat16")
        kw = {}
    want, got = _both((jw, pw), q, K, pre_k=120)
    jax_file, port_file = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jw.save_layout(jax_file)
    pw.save_layout(port_file)
    from_jax = type(pw).load_layout(jax_file, _mesh(), device="cpu", **kw)
    from_port = type(pw).load_layout(port_file, _mesh(), device="cpu", **kw)
    for loaded in (from_jax, from_port):
        back = loaded.search_batched_arrays(q, K, T.SearchParameters(
            pre_reordering_num_neighbors=120))
        np.testing.assert_array_equal(back[0], got[0])
        np.testing.assert_array_equal(back[1], got[1])
    in_jax = jax_load_layout(port_file, mesh=jax_mesh(8, axis_names=("db",)),
                             **kw)
    back = in_jax.search_batched_arrays(q, K, JaxParams(
        pre_reordering_num_neighbors=120))
    np.testing.assert_array_equal(back[0], want[0])
    np.testing.assert_array_equal(back[1], want[1])
    _same(want, got, q, db)
    with pytest.raises(T.ScannError, match="computed for 8 shards"):
        type(pw).load_layout(port_file, _mesh(4), device="cpu")
    with pytest.raises(T.ScannError, match="sharded serving layout"):
        T.load_index(port_file, device="cpu")

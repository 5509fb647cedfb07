"""Sharded exact search and k-means of the PyTorch port against the JAX
package's, on the CPU: the JAX programs on its 8 virtual CPU devices, the
port on meshes of CPU shards (``make_mesh(devices=[cpu] * n)``, the
counterpart of those devices). Mirrors ``tests/test_parallel.py``.

Tolerances: ids equal (both sides select exactly on tie-free data);
distances within 1e-5 of ``||q||^2 + ||x||^2`` (the size of the float32
terms both sides' formula cancels, in another summation order); the k-means
step within 1e-4 of JAX's from the same centres."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.models.brute_force import BruteForceSearcher as JaxBF
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.parallel import ShardedBruteForceSearcher as JaxShardedBF
from scann_tpu.parallel import make_mesh as jax_mesh
from scann_tpu.parallel import shard_rows as jax_shard_rows
from scann_tpu.parallel import sharded_kmeans_step as jax_kmeans_step
from scann_tpu.parallel.sharded import sharded_search_kernel as jax_kernel
import scann_tpu_torch as T
from scann_tpu_torch.parallel import (
    ShardedBruteForceSearcher,
    make_mesh,
    shard_rows,
    sharded_kmeans_step,
    sharded_search_kernel,
)
from scann_tpu_torch.ops.distances import squared_norms

CPU = torch.device("cpu")


def _cpu_mesh(n=8, **kw):
    return make_mesh(devices=[CPU] * n, **kw)


def _same(want, got, q, db):
    wi, wd = want
    gi, gd = got
    np.testing.assert_array_equal(gi, wi)
    scale = (q * q).sum(1)[:, None] + (db[np.maximum(wi, 0)] ** 2).sum(-1)
    np.testing.assert_array_less(np.abs(gd - wd), 1e-5 * (np.abs(wd) + scale))


def test_mesh_of_8_cpu_shards():
    """The port's 8-shard CPU mesh against JAX's 8 virtual devices; with no
    device list the mesh draws from the visible CUDA devices, and raises on
    a host without one, as every entry point of the port does."""
    mesh = _cpu_mesh()
    assert mesh.shape["db"] == jax_mesh().shape["db"] == 8
    assert mesh.devices.size == 8 and mesh.home() == CPU
    m2 = _cpu_mesh(axis_names=("q", "db"), shape=(2, 4))
    assert m2.shape == {"q": 2, "db": 4}
    with pytest.raises(T.ScannError, match="requested 9 devices"):
        make_mesh(9, devices=[CPU] * 8)
    if torch.cuda.is_available():
        assert make_mesh().devices.size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_sharded_search_matches_jax(rng):
    db = rng.normal(size=(1000, 16)).astype(np.float32)
    q = rng.normal(size=(12, 16)).astype(np.float32)
    want = JaxShardedBF(JaxDataset(db)).search_batched_arrays(q, 7)
    s = ShardedBruteForceSearcher(T.DenseDataset(db), mesh=_cpu_mesh())
    got = s.search_batched_arrays(q, 7)
    _same(want, got, q, db)
    gt_i, gt_d = JaxBF(JaxDataset(db)).search_batched_arrays(q, 7)
    np.testing.assert_array_equal(got[0], gt_i)
    ids, dists = s.search_batched_tensors(torch.from_numpy(q), 7)
    np.testing.assert_array_equal(ids.numpy(), got[0])


def test_sharded_search_n_not_divisible(rng):
    db = rng.normal(size=(1001, 8)).astype(np.float32)  # not divisible by 8
    q = rng.normal(size=(3, 8)).astype(np.float32)
    want = JaxShardedBF(JaxDataset(db)).search_batched_arrays(q, 5)
    got = ShardedBruteForceSearcher(T.DenseDataset(db),
                                    mesh=_cpu_mesh()).search_batched_arrays(
        q, 5)
    _same(want, got, q, db)
    assert (got[0] < 1001).all() and (got[0] >= 0).all()


def test_sharded_k_larger_than_shard(rng):
    """k bigger than one shard's row count: the local top-k clamps to the
    shard and the merge still returns k."""
    db = rng.normal(size=(64, 4)).astype(np.float32)  # 8 rows a shard
    q = rng.normal(size=(2, 4)).astype(np.float32)
    want = JaxShardedBF(JaxDataset(db)).search_batched_arrays(q, 20)
    got = ShardedBruteForceSearcher(T.DenseDataset(db),
                                    mesh=_cpu_mesh()).search_batched_arrays(
        q, 20)
    assert got[0].shape == (2, 20)
    _same(want, got, q, db)


def test_sharded_kmeans_step_matches_jax(rng):
    """501 rows (not a multiple of 8): padding rows join no cluster. New
    centres, counts and inertia within 1e-4 of JAX's sharded step from the
    same centres (both sum float32 rows)."""
    data = rng.normal(size=(501, 8)).astype(np.float32)
    centers = data[:10].copy()
    mesh = jax_mesh()
    data_sh, n = jax_shard_rows(mesh, jnp.asarray(data))
    w_c, w_counts, w_inertia = jax_kmeans_step(mesh, k=10)(
        data_sh, jnp.asarray(centers), jnp.int32(n))
    p_sh, pn = shard_rows(_cpu_mesh(), data)
    assert pn == 501 and p_sh.blk == 63 and p_sh.valid[-1] == 501 - 7 * 63
    g_c, g_counts, g_inertia = sharded_kmeans_step(_cpu_mesh(), 10)(
        p_sh, torch.from_numpy(centers), pn)
    assert float(g_counts.sum()) == 501
    np.testing.assert_allclose(g_c.numpy(), np.asarray(w_c), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(g_counts.numpy(), np.asarray(w_counts))
    np.testing.assert_allclose(float(g_inertia), float(w_inertia), rtol=1e-4)


def test_2d_mesh_query_sharding(rng):
    """Query-batch x database splitting on a 2 x 4 mesh."""
    db = rng.normal(size=(256, 8)).astype(np.float32)
    q = rng.normal(size=(16, 8)).astype(np.float32)
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax

    jm = jax_mesh(axis_names=("q", "db"), shape=(2, 4))
    kern = jax_kernel(jm, JaxMeasure.SQUARED_L2, 5, db_axis="db", q_axis="q")
    w_d, w_i = kern(
        jax.device_put(jnp.asarray(db), NamedSharding(jm, P("db", None))),
        jax.device_put(jnp.sum(jnp.asarray(db) ** 2, axis=1),
                       NamedSharding(jm, P("db"))),
        jnp.int32(256),
        jax.device_put(jnp.asarray(q), NamedSharding(jm, P("q", None))))
    mesh = _cpu_mesh(axis_names=("q", "db"), shape=(2, 4))
    db_sh, n = shard_rows(mesh, db)
    norms = [squared_norms(x) for x in db_sh]
    g_d, g_i = sharded_search_kernel(
        mesh, T.DistanceMeasure.SQUARED_L2, 5, db_axis="db", q_axis="q")(
        db_sh, norms, n, torch.from_numpy(q))
    _same((np.asarray(w_i), np.asarray(w_d)), (g_i.numpy(), g_d.numpy()),
          q, db)


def test_sharded_bf_honors_epsilon(rng):
    """The tighter of the two epsilons applies to the exact distances, as
    in the single-device brute force and JAX's sharded searcher."""
    db = rng.normal(size=(600, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    s = ShardedBruteForceSearcher(T.DenseDataset(db), mesh=_cpu_mesh())
    _, d_all = s.search_batched_arrays(q, 5)
    eps = float(np.median(d_all[:, 2]))
    got = s.search_batched_arrays(q, 5, T.SearchParameters(
        pre_reordering_epsilon=eps))
    want = JaxShardedBF(JaxDataset(db)).search_batched_arrays(
        q, 5, JaxParams(pre_reordering_epsilon=eps))
    np.testing.assert_array_equal(got[0], want[0])
    kept = got[0] >= 0
    assert kept.any() and (~kept).any()
    assert np.all(got[1][kept] <= eps + 1e-6)
    assert np.all(np.isinf(got[1][~kept]))


def test_sharded_kernel_rejects_unreachable_k(rng):
    """k beyond the gathered candidate width fails with a typed,
    explanatory error, before any scoring."""
    db = rng.normal(size=(64, 8)).astype(np.float32)
    mesh = _cpu_mesh()
    db_sh, n = shard_rows(mesh, db)
    norms = [squared_norms(x) for x in db_sh]
    kern = sharded_search_kernel(mesh, T.DistanceMeasure.SQUARED_L2, k=100)
    with pytest.raises(T.ScannError, match="exceeds the 64 gathered"):
        kern(db_sh, norms, n, torch.from_numpy(
            rng.normal(size=(2, 8)).astype(np.float32)))


def test_parallel_names_match_jax():
    """The port's ``parallel`` package exports the JAX package's names (and
    its ``Mesh`` class), and the top level the sharded-layout io."""
    import scann_tpu
    import scann_tpu.parallel as jp
    import scann_tpu_torch.parallel as pp

    assert set(jp.__all__) <= set(pp.__all__)
    assert set(pp.__all__) - set(jp.__all__) == {"Mesh"}
    for name in ("save_sharded_layout", "load_sharded_layout"):
        assert name in T.__all__ and name in scann_tpu.__all__
    from scann_tpu_torch.parallel import multihost

    assert callable(multihost.initialize_multihost)
    assert multihost.process_local_rows(10) == (0, 10)

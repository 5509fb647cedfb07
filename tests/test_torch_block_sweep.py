"""The block-sweep searcher of the PyTorch port against the JAX package's
``BlockSweepSearcher`` on the CPU (its interpret-mode row-major sweep; the
port's twins), one configuration at a time; a JAX-saved index served by the
port; and the port's default device.

Tolerances: ids must be equal (both sides select exactly, and the block
minima agree to float32 summation order); distances rtol 1e-5, because
both re-rank with the same float32 formula in another summation order."""

import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.io import save_index
from scann_tpu.models.block_sweep import (
    BlockSweepConfig as JaxConfig,
    BlockSweepSearcher as JaxSearcher,
)
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
import scann_tpu_torch as T
import scann_tpu_torch.io as tio
from scann_tpu_torch.hashes.codebook import Codebook
from scann_tpu_torch.partitioning.tree_partitioner import TreePartitioner
from scann_tpu_torch.trees.kmeans import KMeans

N, D, B, K = 2048, 16, 12, 10
BASE = dict(pre_reorder_k=64, block_r=8, tile_n=256)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    return db, q


def _pair(db, measure="SQUARED_L2", **cfg):
    """The JAX searcher and the port's (on the CPU) with one config."""
    kw = dict(BASE, **cfg)
    jax_s = JaxSearcher(JaxDataset(db), JaxConfig(
        distance_measure=JaxMeasure[measure], **kw))
    port = T.BlockSweepSearcher(T.DenseDataset(db), T.BlockSweepConfig(
        distance_measure=T.DistanceMeasure[measure], **kw), device="cpu")
    return jax_s, port


def _same(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("measure", ["SQUARED_L2", "DOT_PRODUCT", "COSINE",
                                     "GENERAL_INNER_PRODUCT"])
@pytest.mark.parametrize("cfg", [dict(), dict(top2=True),
                                 dict(sweep_dtype="int8"),
                                 dict(shuffle=False)],
                         ids=["base", "top2", "int8", "noshuffle"])
def test_searcher_matches_jax(data, measure, cfg):
    db, q = data
    jax_s, port = _pair(db, measure, **cfg)
    want = jax_s.search_batched_arrays(q, K)
    got = port.search_batched_arrays(q, K)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    _same(want, got)


@pytest.mark.parametrize("cfg", [dict(), dict(sweep_dtype="int8"),
                                 dict(top2=True)],
                         ids=["bf16", "int8", "top2"])
def test_allow_mask_matches_jax(data, cfg):
    """The allowlist fused into the sweep as its penalty stream."""
    db, q = data
    mask = np.random.default_rng(1).random(N) < 0.1
    jax_s, port = _pair(db, **cfg)
    want = jax_s.search_batched_arrays(q, K, allow_mask=mask)
    got = port.search_batched_arrays(q, K, allow_mask=mask)
    _same(want, got)
    assert np.all(mask[got[0][got[0] >= 0]])


def test_epsilons_and_pre_k_match_jax(data):
    db, q = data
    jax_s, port = _pair(db)
    base = port.search_batched_arrays(q, K)[1]
    for params in (dict(post_reordering_epsilon=float(np.median(base))),
                   dict(pre_reordering_epsilon=float(np.median(base))),
                   dict(pre_reordering_num_neighbors=128)):
        want = jax_s.search_batched_arrays(q, K, JaxParams(**params))
        got = port.search_batched_arrays(q, K, T.SearchParameters(**params))
        _same(want, got)
    assert np.isinf(got[1]).sum() == 0
    eps = port.search_batched_arrays(q, K, T.SearchParameters(
        post_reordering_epsilon=float(np.median(base))))
    assert np.isinf(eps[1]).any() and np.all(eps[0][np.isinf(eps[1])] == -1)


def test_odd_batch_max_batch_and_padding_match_jax(data):
    """An odd batch split by max_batch (halved under top2), and k above the
    block count: the output pads to k with (-1, inf)."""
    db, q = data
    for cfg in (dict(max_batch=8), dict(max_batch=8, top2=True)):
        jax_s, port = _pair(db, **cfg)
        _same(jax_s.search_batched_arrays(q[:7], K),
              port.search_batched_arrays(q[:7], K))
    small = db[:300]
    jax_s, port = _pair(small, block_r=32, tile_n=256)
    want = jax_s.search_batched_arrays(q[:3], 40)
    got = port.search_batched_arrays(q[:3], 40)
    _same(want, got)
    assert got[0].shape == (3, 40) and (got[0][:, -8:] == -1).all()


def test_tensor_search_and_memory_usage(data):
    db, q = data
    jax_s, port = _pair(db)
    idx, dists = port.search_batched_tensors(torch.from_numpy(q), K)
    assert idx.dtype == torch.int64 and dists.dtype == torch.float32
    want = port.search_batched_arrays(q, K)
    np.testing.assert_array_equal(idx.numpy(), want[0])
    jax_s._device_state()
    assert port.memory_usage() == jax_s.memory_usage() > 0


def test_unported_rerank_dtypes_raise(data):
    """Re-rank dtypes the JAX block sweep rejects raise; bfloat16 and int8
    are served (test_low_precision_rerank_matches_jax)."""
    db, _ = data
    for rdt in ("int16", "float16"):
        with pytest.raises(T.ScannError):
            T.BlockSweepSearcher(T.DenseDataset(db), T.BlockSweepConfig(
                rerank_dtype=rdt), device="cpu")


@pytest.mark.parametrize("rdt", ["bfloat16", "int8"])
@pytest.mark.parametrize("cfg", [dict(), dict(shuffle=False, top2=True)],
                         ids=["shuffled", "noshuffle-top2"])
def test_low_precision_rerank_matches_jax(data, rdt, cfg):
    """bf16 rows or the per-dimension int8 codec, in the sweep's stored
    order: the same store bytes as the JAX searcher's, the same results."""
    db, q = data
    jax_s, port = _pair(db, rerank_dtype=rdt, **cfg)
    want = jax_s.search_batched_arrays(q, K)
    got = port.search_batched_arrays(q, K)
    _same(want, got)
    exact = port.search_batched_arrays(q, K)[1]
    f32 = _pair(db, **cfg)[1].search_batched_arrays(q, K)[1]
    assert np.abs(exact - f32).max() > 0          # the store is not f32
    jax_s._device_state()
    assert port.memory_usage() == jax_s.memory_usage()


@pytest.mark.parametrize("cfg", [dict(), dict(sweep_dtype="int8", top2=True,
                                              shuffle=False)],
                         ids=["default", "int8-top2-noshuffle"])
def test_jax_saved_index_serves_through_port(data, tmp_path, cfg):
    """save_index by the JAX package -> the port's load_index: the same
    config and the same results."""
    db, q = data
    jax_s, _ = _pair(db, "COSINE", **cfg)
    path = str(tmp_path / "sweep.npz")
    save_index(path, jax_s)
    port = tio.load_index(path, device="cpu")
    assert isinstance(port, T.BlockSweepSearcher)
    assert port.config.distance_measure == T.DistanceMeasure.COSINE
    assert port.config.sweep_dtype == jax_s._config.sweep_dtype
    _same(jax_s.search_batched_arrays(q, K), port.search_batched_arrays(q, K))


# -- the port's default device ------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda ds: T.BlockSweepSearcher(ds),
    lambda ds: T.TreeXHybridSearcher(),
    lambda ds: TreePartitioner(),
    lambda ds: KMeans(),
    lambda ds: Codebook(),
], ids=["block_sweep", "tree_x_hybrid", "partitioner", "kmeans", "codebook"])
def test_entry_points_default_to_the_card(make):
    """Constructing needs no card: the default device is CUDA."""
    obj = make(T.DenseDataset(np.zeros((4, 2), np.float32)))
    assert obj.device.type == "cuda"


def test_default_device_without_a_card_raises(data, tmp_path, monkeypatch):
    """Where there is no CUDA device, the default raises a clear error at
    first use instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db, q = data
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.BlockSweepSearcher(T.DenseDataset(db)).search_batched_arrays(q, K)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeans().fit(db)
    jax_s, _ = _pair(db)
    path = str(tmp_path / "sweep.npz")
    save_index(path, jax_s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.load_index(path)

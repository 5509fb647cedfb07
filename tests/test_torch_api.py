"""Public names of the PyTorch port that a caller of the JAX package reaches:
the ``with_*`` methods of the search parameters, per-parameter searches,
the tree-x-AH config's ``with_*`` methods and memory count, the codebook's
point API, ``KMeans.with_clusters`` and
``DistanceMeasure.is_matmul_friendly``, each held against the JAX package
on the CPU.

Tolerances: ids equal; distances, reconstructions and tables within 1e-5
relative (float32 products in another summation order); counts exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.codebook import Codebook as JaxCodebook
from scann_tpu.hashes.codebook import CodebookConfig as JaxCodebookConfig
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.io import load_index as jax_load_index
from scann_tpu.io import save_index
from scann_tpu.models.brute_force import BruteForceSearcher as JaxBF
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig as JaxConfig
from scann_tpu.models.tree_x_hybrid import TreeXHybridSearcher as JaxTreeAH
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.trees.kmeans import KMeans as JaxKMeans
import scann_tpu_torch as T
from scann_tpu_torch import io as tio
from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig
from scann_tpu_torch.models.tree_x_hybrid import TreeXHybridConfig
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.trees.kmeans import KMeans

N, D, B, K = 300, 16, 6, 5
RTOL = 1e-5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


@pytest.mark.parametrize("name,arg", [
    ("with_num_neighbors", 7), ("with_pre_reordering_neighbors", 40),
    ("with_leaves_to_search", 3), ("with_epsilon", 2.5)])
def test_search_parameter_setters_match_jax(name, arg):
    """Each ``with_*`` method sets the JAX field, returns the same object and chains;
    the fields (crowding_enabled included) are the JAX ones."""
    port, ref = T.SearchParameters(), JaxParams()
    assert getattr(port, name)(arg) is port
    getattr(ref, name)(arg)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_crowding_enabled_raises_until_ported():
    """The field exists as in JAX; a search with it set names the ROADMAP
    item that brings crowding."""
    db, q = _data()
    s = T.BruteForceSearcher(T.DenseDataset(db), device="cpu")
    params = T.SearchParameters(num_neighbors=K, crowding_enabled=True)
    with pytest.raises(NotImplementedError, match="8d"):
        s.search_with_params(q[0], params)
    with pytest.raises(NotImplementedError, match="8d"):
        s.search_batched_tensors(torch.from_numpy(q), K, params)
    s.search_with_params(q[0], T.SearchParameters(num_neighbors=K,
                                                  crowding_enabled=False))


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.indices() == w.indices()
        np.testing.assert_allclose(g.distances(), w.distances(), rtol=RTOL,
                                   atol=1e-4)


@pytest.mark.parametrize("mixed", [False, True])
def test_search_with_params_matches_jax(mixed):
    """``search_with_params`` and ``search_batched_with_params`` (one batch
    for equal parameters, one search per query otherwise) return the JAX
    results."""
    db, q = _data(1)
    port = T.BruteForceSearcher(T.DenseDataset(db), device="cpu")
    ref = JaxBF(JaxDataset(db))
    ks = [K + (i % 3 if mixed else 0) for i in range(B)]
    pl = [T.SearchParameters().with_num_neighbors(k) for k in ks]
    jl = [JaxParams().with_num_neighbors(k) for k in ks]
    _same_results(port.search_batched_with_params(q, pl),
                  ref.search_batched_with_params(q, jl))
    _same_results([port.search_with_params(q[2], pl[2])],
                  [ref.search_with_params(q[2], jl[2])])
    with pytest.raises(T.ScannError):
        port.search_batched_with_params(q, pl[:-1])


def test_tree_ah_config_setters_match_jax():
    hc = T.AsymmetricHasherConfig(num_codes=16, num_subspaces=4)
    cfg = TreeXHybridConfig()
    assert cfg.with_hash(hc) is cfg and cfg.hash_config is hc
    assert cfg.with_residuals(False).with_pre_reorder(5.0) is cfg
    ref = JaxConfig().with_residuals(False).with_pre_reorder(5.0)
    assert (cfg.use_residuals, cfg.pre_reorder_multiplier) == (
        ref.use_residuals, ref.pre_reorder_multiplier)


@pytest.fixture(scope="module")
def tree_ah_index(tmp_path_factory):
    db, _ = _data(2)
    s = JaxTreeAH(JaxConfig(
        num_partitions=8, partitions_to_search=2, score_l_tile=128,
        max_partition_size=None,
        hash_config=JaxHashConfig(num_codes=16, num_subspaces=8, seed=0,
                                  max_iterations=4))).build(JaxDataset(db))
    path = str(tmp_path_factory.mktemp("api") / "index.npz")
    save_index(path, s)
    return path


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("l_tile", [128, 512])
def test_tree_ah_memory_usage_matches_jax(tree_ah_index, packed, l_tile):
    """Bytes as the JAX package counts them for its grouped serving layout
    (the port's only one; forced on this CPU instance), for the packed and
    the u8 slab and two L-tiles."""
    port = tio.load_index(tree_ah_index, device="cpu")
    ref = jax_load_index(tree_ah_index)
    ref._use_grouped_pallas = lambda: True
    for s in (port, ref):
        s.config.pack_codes = packed
        s.config.score_l_tile = l_tile
    assert port.memory_usage() == ref.memory_usage() > 0


@pytest.fixture(scope="module")
def codebooks():
    """(JAX codebook, port codebook with the same centroids, data)."""
    db, _ = _data(3)
    ref = JaxCodebook(JaxCodebookConfig(num_codes=8, num_subspaces=4,
                                        seed=0, max_iterations=5)).train(db)
    port = Codebook(CodebookConfig(num_codes=8, num_subspaces=4),
                    device="cpu")
    port.centroids = torch.from_numpy(np.asarray(ref.centroids, np.float32))
    return ref, port, db


def test_codebook_encode_decode_match_jax(codebooks):
    ref, port, db = codebooks
    got = port.encode(db[5])
    assert got.dtype == torch.uint8 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), ref.encode(db[5]))
    codes = ref.encode_dataset(db[:20])
    rec = port.decode(codes)
    assert rec.shape == (20, D)
    np.testing.assert_allclose(rec.numpy(), ref.decode(codes), rtol=RTOL)
    np.testing.assert_allclose(port.decode(codes[3]).numpy(),
                               ref.decode(codes[3]), rtol=RTOL)


def test_codebook_error_and_tables_match_jax(codebooks):
    ref, port, db = codebooks
    assert port.reconstruction_error(db) == pytest.approx(
        ref.reconstruction_error(db), rel=RTOL)
    for q in (db[:7], db[7]):
        got = port.lookup_tables(q)
        want = np.asarray(ref.lookup_tables(q))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
    with pytest.raises(T.ScannError):
        Codebook(device="cpu").decode(np.zeros((1, 4), np.uint8))


def test_kmeans_with_clusters_matches_jax():
    got = KMeans.with_clusters(12, device="cpu")
    assert got.device == torch.device("cpu")
    want = JaxKMeans.with_clusters(12).config
    assert {f.name: getattr(got.config, f.name).value
            if hasattr(getattr(got.config, f.name), "value")
            else getattr(got.config, f.name)
            for f in dataclasses.fields(got.config)} == {
        f.name: getattr(want, f.name).value
        if hasattr(getattr(want, f.name), "value") else getattr(want, f.name)
        for f in dataclasses.fields(want)}


@pytest.mark.parametrize("name", [m.name for m in JaxMeasure])
def test_is_matmul_friendly_matches_jax(name):
    assert DistanceMeasure[name].is_matmul_friendly == \
        JaxMeasure[name].is_matmul_friendly

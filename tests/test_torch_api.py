"""Public names of the PyTorch port that a caller of the JAX package reaches:
the ``with_*`` methods of the search parameters, per-parameter searches,
the tree-x-AH config's ``with_*`` methods, memory count and
``approx_selection_min_partitions``, the codebook's point API and
``centroids_device``, ``KMeans.with_clusters``,
``DistanceMeasure.is_matmul_friendly``, the exported result types,
``radius_search_mask``, ``ReorderingHelper``, ``unpack_codes_4bit_device``
and ``pad_rows``, each held against the JAX package on the CPU.

Tolerances: ids equal; distances, reconstructions and tables within 1e-5
relative (float32 products in another summation order); counts exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import scann_tpu
from scann_tpu import types as jax_types
from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes import lut16 as jax_lut16
from scann_tpu.hashes.codebook import Codebook as JaxCodebook
from scann_tpu.hashes.codebook import CodebookConfig as JaxCodebookConfig
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.io import load_index as jax_load_index
from scann_tpu.io import save_index
from scann_tpu.models.brute_force import BruteForceSearcher as JaxBF
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import TreeXHybridConfig as JaxConfig
from scann_tpu.models.tree_x_hybrid import TreeXHybridSearcher as JaxTreeAH
from scann_tpu.ops import topk as jax_topk
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.trees.kmeans import KMeans as JaxKMeans
from scann_tpu.utils.reordering import ReorderingHelper as JaxReordering
import scann_tpu_torch as T
from scann_tpu_torch import io as tio
from scann_tpu_torch import types as port_types
from scann_tpu_torch.hashes import lut16 as port_lut16
from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig
from scann_tpu_torch.models.tree_x_hybrid import TreeXHybridConfig
from scann_tpu_torch.ops import topk as port_topk
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.trees.kmeans import KMeans
from scann_tpu_torch.utils.reordering import ReorderingHelper

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


def test_crowding_enabled_matches_jax():
    """The field is accepted and not read, as in the JAX package: results
    with it set equal results without it, on both packages, and the two
    packages agree."""
    db, q = _data()
    port = T.BruteForceSearcher(T.DenseDataset(db), device="cpu")
    ref = JaxBF(JaxDataset(db))
    for with_flag in (True, False):
        got = port.search_batched(q, K, T.SearchParameters(
            num_neighbors=K, crowding_enabled=with_flag))
        want = ref.search_batched(q, K, JaxParams(
            num_neighbors=K, crowding_enabled=with_flag))
        _same_results(got, want)
    flagged = T.SearchParameters(num_neighbors=K, crowding_enabled=True)
    _same_results(port.search_batched(q, K, flagged),
                  port.search_batched(q, K, T.SearchParameters(
                      num_neighbors=K)))
    _same_results(ref.search_batched(q, K, JaxParams(
        num_neighbors=K, crowding_enabled=True)),
        ref.search_batched(q, K, JaxParams(num_neighbors=K)))
    got = port.search_batched_tensors(torch.from_numpy(q), K, flagged)
    want = port.search_batched_tensors(torch.from_numpy(q), K)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


# -- gaps repaired beside the row-major and top-2 sweep kernels ---------------


def test_approx_selection_field_is_accepted_and_selects_exactly(
        tree_ah_index):
    """The field exists with the JAX default; the port selects partitions
    exactly whatever its value, so its results are identical for any value
    and equal the JAX package's on the CPU (which selects exactly too)."""
    assert TreeXHybridConfig().approx_selection_min_partitions == \
        JaxConfig().approx_selection_min_partitions == 1024
    _, q = _data(4)
    results = []
    for value in (1, 8, 1024, 1 << 20):
        port = tio.load_index(tree_ah_index, device="cpu")
        port.config.approx_selection_min_partitions = value
        results.append(port.search_batched_arrays(q, K))
    for idx, dist in results[1:]:
        np.testing.assert_array_equal(idx, results[0][0])
        np.testing.assert_array_equal(dist, results[0][1])
    ref = jax_load_index(tree_ah_index)
    ref.config.approx_selection_min_partitions = 1
    want_i, want_d = ref.search_batched_arrays(q, K)
    np.testing.assert_array_equal(results[0][0], want_i)
    np.testing.assert_allclose(results[0][1], want_d, rtol=RTOL, atol=1e-5)


def test_result_types_are_exported_like_jax():
    for name in ("NNResult", "SearchResult"):
        assert name in T.__all__ and name in scann_tpu.__all__
    assert [f.name for f in dataclasses.fields(T.NNResult)] == \
        [f.name for f in dataclasses.fields(scann_tpu.NNResult)]
    nbs = [(3, 0.5), (7, 1.25)]
    got = T.SearchResult([T.NNResult(i, d) for i, d in nbs])
    want = scann_tpu.SearchResult([scann_tpu.NNResult(i, d) for i, d in nbs])
    assert len(got) == len(want) == 2
    assert got.indices() == want.indices()
    assert got.distances() == want.distances()
    assert [n.docid for n in got] == [n.docid for n in want]


@pytest.mark.parametrize("radius", [-1.0, 0.0, 0.5, 3.0])
def test_radius_search_mask_matches_jax(radius):
    rng = np.random.default_rng(6)
    d = np.round(rng.normal(size=(B, 40)), 1).astype(np.float32)
    got = port_topk.radius_search_mask(torch.from_numpy(d), radius)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_topk.radius_search_mask(d, radius)))


@pytest.mark.parametrize("measure", ["SQUARED_L2", "DOT_PRODUCT", "COSINE"])
@pytest.mark.parametrize("k", [4, 30])
def test_reordering_helper_matches_jax(measure, k):
    """Candidates with missing (-1) slots and a row with fewer real ones
    than k: ids equal away from ties, distances to 1e-5 relative, -1 and
    inf in the same places."""
    db, q = _data(5)
    rng = np.random.default_rng(7)
    cand = rng.integers(0, N, size=(B, 20))
    cand[:, ::5] = -1
    cand[1, 3:] = -1
    got_i, got_d = ReorderingHelper(DistanceMeasure[measure],
                                    device="cpu").reorder(
        T.DenseDataset(db), q, cand, k)
    want_i, want_d = JaxReordering(JaxMeasure[measure]).reorder(
        JaxDataset(db), q, cand, k)
    assert got_i.shape == want_i.shape == (B, min(k, 20))
    assert got_i.dtype == np.int32 and got_d.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(np.asarray(
        want_d)))
    tied = np.zeros_like(got_d, bool)
    tied[:, 1:] |= np.isclose(got_d[:, 1:], got_d[:, :-1], rtol=RTOL)
    tied[:, :-1] |= tied[:, 1:]
    np.testing.assert_array_equal(got_i[~tied], np.asarray(want_i)[~tied])
    finite = np.isfinite(got_d)
    np.testing.assert_allclose(got_d[finite], np.asarray(want_d)[finite],
                               rtol=RTOL, atol=1e-5)
    # one query as a vector
    one_i, one_d = ReorderingHelper(DistanceMeasure[measure],
                                    device="cpu").reorder(
        T.DenseDataset(db), q[2], cand[2], k)
    np.testing.assert_array_equal(one_i[0], got_i[2])


def test_centroids_device_matches_jax(codebooks):
    ref, port, _ = codebooks
    got = port.centroids_device()
    assert got is port.centroids and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.centroids_device()))
    with pytest.raises(T.ScannError):
        Codebook(device="cpu").centroids_device()


@pytest.mark.parametrize("s", [1, 7, 8, 25])
def test_unpack_codes_4bit_device_matches_jax(s):
    rng = np.random.default_rng(s)
    packed = jax_lut16.pack_codes_4bit(rng.integers(0, 16, size=(33, s)))
    got = port_lut16.unpack_codes_4bit_device(torch.from_numpy(packed), s)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_lut16.unpack_codes_4bit_device(
            packed, s)))


@pytest.mark.parametrize("shape,multiple,fill", [
    ((5, 3), 4, 0), ((8, 2), 4, 0), ((0, 3), 8, -1), ((7,), 16, 2.5),
    ((3, 2, 2), 2, 1)])
def test_pad_rows_matches_jax(shape, multiple, fill):
    arr = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = port_types.pad_rows(arr, multiple, fill)
    want = jax_types.pad_rows(arr, multiple, fill)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)

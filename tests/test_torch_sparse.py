"""Sparse search of the PyTorch port against the JAX package on the CPU:
``SparseDataset``, the five host ``*_sparse`` distances and
``SparseBruteForceSearcher`` over all five measures.

The JAX searcher densifies the dataset; the port scores the stored
nonzeros. Tolerances: set-measure distances to 1e-6 (they come out
bit-equal: integer counts and the same float32 formula), ids equal (ties
lower index first on both sides); WEIGHTED_JACCARD distances to 1e-5
absolute (the JAX form recovers Σ min from an L1 identity in float32, the
port sums it directly), ids equal away from ties within that tolerance.
"""

import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import SparseDataset as JaxSparseDataset
from scann_tpu.errors import ScannError as JaxError
from scann_tpu.models.sparse_brute_force import (
    SparseBruteForceSearcher as JaxSparse,
)
from scann_tpu.ops import distances as jd
from scann_tpu.ops.distances import DistanceMeasure as JM
from scann_tpu_torch.data.dataset import SparseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.models import sparse_brute_force as sbf
from scann_tpu_torch.models.sparse_brute_force import SparseBruteForceSearcher
from scann_tpu_torch.ops import distances as td
from scann_tpu_torch.ops.distances import DistanceMeasure as TM
from torch_threads import one_torch_thread  # noqa: F401

MEASURES = ["JACCARD", "DICE", "NON_ZERO_INTERSECT", "OVERLAP",
            "WEIGHTED_JACCARD"]
SET_ATOL, WEIGHTED_ATOL = 1e-6, 1e-5


def _points(rng, n, d, max_nnz=12):
    """Sparse points with the hazards of the JAX densification: empty sets,
    repeated indices with different values, unsorted indices, explicit
    zeros and signed values."""
    points = []
    for i in range(n):
        nnz = 0 if i % 17 == 3 else int(rng.integers(1, max_nnz))
        idx = rng.integers(0, d, nnz)
        if nnz > 2 and i % 3 == 0:
            idx[-1] = idx[0]                       # a repeated index
        vals = rng.normal(size=nnz).astype(np.float32)
        vals[rng.random(nnz) < 0.2] = 0.0          # explicit zeros
        points.append((idx, vals))
    return points


def _datasets(points, d):
    jds, tds = JaxSparseDataset(d), SparseDataset(d)
    for idx, vals in points:
        jds.append(idx, vals)
        tds.append(idx, vals)
    return jds, tds


def _queries(rng, b, d, density=0.15):
    q = (rng.random((b, d)) < density) * rng.normal(size=(b, d))
    q = q.astype(np.float32)
    q[0] = 0.0                                       # a query with no member
    q[1, : d // 4] = 0.0
    return q


def _searchers(points, d, name):
    jds, tds = _datasets(points, d)
    return (JaxSparse(jds, JM[name]),
            SparseBruteForceSearcher(tds, TM[name], device="cpu"))


def _assert_results(name, ji, jdist, ti, tdist):
    ji, ti = np.asarray(ji), np.asarray(ti)
    jdist, tdist = np.asarray(jdist), np.asarray(tdist)
    assert ti.shape == ji.shape and tdist.dtype == np.float32
    if name != "WEIGHTED_JACCARD":
        np.testing.assert_allclose(tdist, jdist, rtol=0, atol=SET_ATOL)
        np.testing.assert_array_equal(ti, ji)
        return
    np.testing.assert_allclose(tdist, jdist, rtol=0, atol=WEIGHTED_ATOL)
    for row_j, row_d, row_t in zip(ji, jdist, ti):
        for pos in range(len(row_j)):
            gaps = np.abs(np.delete(row_d, pos) - row_d[pos])
            # the last slot may tie with a result beyond k
            if pos < len(row_j) - 1 and gaps.min() > WEIGHTED_ATOL:
                assert row_t[pos] == row_j[pos]


@pytest.mark.parametrize("name", MEASURES)
@pytest.mark.parametrize("k", [1, 7])
def test_search_batched_arrays_matches_jax(name, k):
    rng = np.random.default_rng(11)
    d = 40
    points = _points(rng, 90, d)
    js, ts = _searchers(points, d, name)
    q = _queries(rng, 13, d)
    _assert_results(name, *js.search_batched_arrays(q, k),
                    *ts.search_batched_arrays(q, k))
    assert ts.search_batched_arrays(q, k)[0].dtype == np.int32


@pytest.mark.parametrize("name", MEASURES)
@pytest.mark.parametrize("with_values", [False, True])
def test_search_sparse_matches_jax(name, with_values):
    """``search_sparse`` does not binarize: for the set measures its values
    weight the intersection and the query size, as in the JAX package;
    repeated query indices keep their last value."""
    rng = np.random.default_rng(5)
    d = 32
    points = _points(rng, 70, d)
    js, ts = _searchers(points, d, name)
    for trial in range(6):
        nq = int(rng.integers(0, 9))
        idx = rng.integers(0, d, nq)
        vals = (rng.normal(size=nq).astype(np.float32) if with_values
                else None)
        if with_values and nq:
            vals[0] = 0.0
        want = js.search_sparse(idx, 6, values=vals)
        got = ts.search_sparse(idx, 6, values=vals)
        _assert_results(name, [want.indices()], [want.distances()],
                        [got.indices()], np.float32([got.distances()]))
        assert all(nb.docid is None for nb in got)


@pytest.mark.parametrize("name", MEASURES)
def test_duplicates_and_explicit_zeros_pinned(name):
    """A stored index counts as a member even with value 0; a repeated
    index counts once and, for WEIGHTED_JACCARD, keeps its last value in
    the point's stably sorted order (numpy's assignment); a query's zero is
    no member in ``search_batched_arrays``."""
    d = 8
    points = [
        (np.array([5, 1, 5, 2]), np.float32([3.0, 1.0, -0.5, 0.0])),
        (np.array([1, 2]), np.float32([1.0, 2.0])),
        (np.array([5, 5, 5]), np.float32([-4.0, 0.0, 2.0])),
        (np.array([], np.int64), np.float32([])),
        (np.array([2, 7, 2]), np.float32([0.0, 1.0, 0.0])),
    ]
    js, ts = _searchers(points, d, name)
    q = np.zeros((4, d), np.float32)
    q[0, [1, 2, 5]] = [1.0, 0.0, 2.0]
    q[1, [2]] = -3.0
    q[2, [5, 7]] = [0.5, 0.25]
    _assert_results(name, *js.search_batched_arrays(q, 5),
                    *ts.search_batched_arrays(q, 5))
    if name == "WEIGHTED_JACCARD":
        indptr, cols, vals = sbf.stored_nonzeros(ts._dataset)
        np.testing.assert_array_equal(indptr, [0, 3, 5, 6, 6, 8])
        np.testing.assert_array_equal(cols, [1, 2, 5, 1, 2, 5, 2, 7])
        np.testing.assert_array_equal(vals, [1, 0, 0.5, 1, 2, 2, 0, 1])


@pytest.mark.parametrize("name", MEASURES)
def test_k_past_the_dataset_and_one_point(name):
    rng = np.random.default_rng(3)
    d = 16
    points = _points(rng, 5, d)
    js, ts = _searchers(points, d, name)
    q = _queries(rng, 4, d, density=0.4)
    ji, jdist = js.search_batched_arrays(q, 50)
    ti, tdist = ts.search_batched_arrays(q, 50)
    assert ti.shape == (4, 5)
    _assert_results(name, ji, jdist, ti, tdist)
    js1, ts1 = _searchers(points[:1], d, name)
    _assert_results(name, *js1.search_batched_arrays(q, 3),
                    *ts1.search_batched_arrays(q, 3))


@pytest.mark.parametrize("name", MEASURES)
def test_empty_dataset_raises_failed_precondition(name):
    js = JaxSparse(JaxSparseDataset(10), JM[name])
    ts = SparseBruteForceSearcher(SparseDataset(10), TM[name], device="cpu")
    q = np.ones((2, 10), np.float32)
    with pytest.raises(JaxError) as want:
        js.search_batched_arrays(q, 3)
    with pytest.raises(ScannError) as got:
        ts.search_batched_arrays(q, 3)
    assert got.value.code.value == want.value.code.value
    with pytest.raises(ScannError) as got:
        ts.search_sparse([1, 2], 3)
    assert got.value.code.value == want.value.code.value
    with pytest.raises(ScannError) as got:
        ts.search(q[0], 3)
    assert got.value.code.value == want.value.code.value


@pytest.mark.parametrize("name", [m.name for m in JM
                                  if m.name not in MEASURES])
def test_dense_measures_rejected_like_jax(name):
    jds, tds = _datasets([(np.array([1]), np.float32([1.0]))], 4)
    with pytest.raises(JaxError) as want:
        JaxSparse(jds, JM[name])
    with pytest.raises(ScannError) as got:
        SparseBruteForceSearcher(tds, TM[name], device="cpu")
    assert got.value.code.value == want.value.code.value


@pytest.mark.parametrize("dim,ok", [(65536, True), (65537, False)])
def test_dimensionality_cap_like_jax(dim, ok):
    jds, tds = _datasets([(np.array([0, dim - 1]), np.float32([1, 2]))], dim)
    if ok:
        SparseBruteForceSearcher(tds, TM.JACCARD, device="cpu")
        return
    with pytest.raises(JaxError) as want:
        JaxSparse(jds, JM.JACCARD)
    with pytest.raises(ScannError) as got:
        SparseBruteForceSearcher(tds, TM.JACCARD, device="cpu")
    assert got.value.code.value == want.value.code.value


@pytest.mark.parametrize("name", MEASURES)
def test_object_api_and_query_chunks(name, monkeypatch):
    """``search`` / ``search_batched`` through the base class, and a query
    chunk of one row (the chunking never changes a result)."""
    rng = np.random.default_rng(9)
    d = 24
    points = _points(rng, 60, d)
    js, ts = _searchers(points, d, name)
    q = _queries(rng, 5, d)
    for want, got in zip(js.search_batched(q, 4), ts.search_batched(q, 4)):
        _assert_results(name, [want.indices()], [want.distances()],
                        [got.indices()], np.float32([got.distances()]))
    one = ts.search(q[2], 4)
    assert one.indices() == js.search(q[2], 4).indices()
    full = ts.search_batched_arrays(q, 4)
    monkeypatch.setattr(sbf, "QUERY_CHUNK_BYTES", 1)
    assert ts.query_chunk() == 1
    chunked = ts.search_batched_arrays(q, 4)
    np.testing.assert_array_equal(chunked[0], full[0])
    np.testing.assert_array_equal(chunked[1], full[1])
    with pytest.raises(ScannError):
        ts.search_batched_arrays(q[:, :-1], 4)


def test_wide_tied_jaccard_selects_like_jax():
    """At least ``VALUE_SELECT_MIN_N`` points of tiny sets: Jaccard
    distances tie across the k boundary in most rows, which the selection
    by value hands to the tie-free key; ids stay JAX's."""
    from scann_tpu_torch.ops import topk

    rng = np.random.default_rng(1)
    d, n = 48, topk.VALUE_SELECT_MIN_N + 500
    points = [(rng.integers(0, d, 2), np.ones(2, np.float32))
              for _ in range(n)]
    js, ts = _searchers(points, d, "JACCARD")
    q = _queries(rng, 6, d, density=0.1)
    before = topk.KEY_PATH_ROWS
    _assert_results("JACCARD", *js.search_batched_arrays(q, 10),
                    *ts.search_batched_arrays(q, 10))
    assert topk.KEY_PATH_ROWS > before


def test_sparse_dataset_matches_jax():
    rng = np.random.default_rng(2)
    d = 20
    points = _points(rng, 15, d)
    jds, tds = _datasets(points, d)
    assert len(tds) == len(jds) and tds.size == jds.size
    assert tds.dimensionality == jds.dimensionality
    for i in range(len(points)):
        np.testing.assert_array_equal(tds.get(i).indices, jds.get(i).indices)
        np.testing.assert_array_equal(tds.get(i).values, jds.get(i).values)
    np.testing.assert_array_equal(tds.to_dense().numpy(),
                                  jds.to_dense().numpy())
    for max_nnz in (None, 3):
        want = [np.asarray(a) for a in jds.to_padded_csr(max_nnz)]
        got = tds.to_padded_csr(max_nnz, device="cpu")
        for w, g in zip(want, got):
            assert isinstance(g, torch.Tensor) and g.dtype == {
                np.int32: torch.int32, np.float32: torch.float32}[
                    w.dtype.type]
            np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(JaxError) as want:
        jds.append([d], [1.0])
    with pytest.raises(ScannError) as got:
        tds.append([d], [1.0])
    assert got.value.code.value == want.value.code.value


def test_host_sparse_distances_match_jax():
    rng = np.random.default_rng(4)
    pairs = [([], []), ([1], []), ([], [2, 3])]
    for _ in range(40):
        pairs.append((rng.integers(0, 12, rng.integers(0, 8)),
                      rng.integers(0, 12, rng.integers(0, 8))))
    for a, b in pairs:
        for fn in ("jaccard_distance_sparse", "dice_distance_sparse",
                   "non_zero_intersect_sparse",
                   "overlap_coefficient_sparse"):
            assert getattr(td, fn)(a, b) == getattr(jd, fn)(a, b)
        av = rng.normal(size=len(a))
        bv = rng.normal(size=len(b))
        assert td.weighted_jaccard_distance_sparse(av, a, bv, b) == \
            jd.weighted_jaccard_distance_sparse(av, a, bv, b)

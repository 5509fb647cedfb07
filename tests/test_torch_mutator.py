"""The mutator of the PyTorch port against the JAX package on the CPU.

- The host core: both cores (the C++ one and the pure-Python one) of both
  packages go through the JAX package's ``tests/test_mutator.py``
  scenarios with the same inputs; snapshots, ``size``, ``total_rows`` and
  the flushed mutations must be equal. The port's library builds from its
  own copy of the source into ``scann_tpu_torch/_build/``.
- ``DynamicSearcher`` over ``BruteForceSearcher(device="cpu")``, with the
  same adds, updates and removes on both packages: ids equal away from
  exact ties, distances within the port's brute-force tolerance (1e-5
  relative, 1e-4 absolute).
- ``DynamicSearcher`` over tree-x-AH: the JAX package builds each main
  index; the port's factory loads the same index from its saved file (the
  packages' k-means draw other bits). Every probed candidate is re-ranked
  exactly, so ids compare away from distance ties.
- The measure fallback of the JAX package (a main index that keeps its
  measure only in its config rescores in squared L2), pinned.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from scann_tpu import mutator as jmut
from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.errors import ScannError as JaxError
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.io import save_index
from scann_tpu.models.brute_force import BruteForceSearcher as JaxBF
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import (
    TreeXHybridConfig as JaxTreeConfig,
    TreeXHybridSearcher as JaxTree,
)
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
import scann_tpu_torch as T
from scann_tpu_torch import io as tio
from scann_tpu_torch import mutator as pmut
from scann_tpu_torch import native_host
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.ops.distances import DistanceMeasure
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(params=["native", "python"])
def core(request, monkeypatch):
    """Which core both packages use: the C++ one, or the pure-Python one
    (each package's loader made to fail)."""
    if request.param == "python":
        monkeypatch.setattr(pmut, "load_native", lambda: None)
        monkeypatch.setattr(jmut, "load_native", lambda: None)
    return request.param


def _pair(dim):
    return pmut.MutableDataset(dim), jmut.MutableDataset(dim)


def _same_state(port, ref):
    assert port.native == ref.native
    assert port.size == ref.size
    assert port.total_rows == ref.total_rows
    pd, pdel = port.snapshot()
    rd, rdel = ref.snapshot()
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pdel, rdel)
    assert pd.dtype == np.float32 and pdel.dtype == np.uint8


def _same_mutations(got, want):
    assert [(m.kind.value, m.index, m.timestamp) for m in got] == \
        [(m.kind.value, m.index, m.timestamp) for m in want]
    for g, w in zip(got, want):
        if w.data is None:
            assert g.data is None
        else:
            np.testing.assert_array_equal(g.data, w.data)


def test_native_library_builds_into_the_port():
    """The host core builds from the port's own copy of the C++ source
    into ``scann_tpu_torch/_build/``, under a name that carries the
    source's hash, never beside the JAX package's source."""
    lib = native_host.load_native()
    assert lib is not None
    path = native_host.library_path()
    assert path.exists() and lib._name == str(path)
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "scann_tpu_torch"
    assert path.name.startswith("libscann_host-")
    assert native_host.SOURCE.parent.parent.name == "scann_tpu_torch"
    assert pmut.MutableDataset(4).native


def test_basic(core):
    port, ref = _pair(4)
    assert port.native == (core == "native")
    for m in (port, ref):
        assert m.add([1, 2, 3, 4]) == 0
        assert m.add([5, 6, 7, 8]) == 1
        m.update(0, [9, 9, 9, 9])
        m.remove(1)
    _same_state(port, ref)
    for i in range(-1, 3):
        pg, rg = port.get(i), ref.get(i)
        assert (pg is None) == (rg is None)
        if rg is not None:
            np.testing.assert_array_equal(pg, rg)
        assert port.exists(i) == ref.exists(i)
    for call, code in ((lambda m: m.remove(1), "NOT_FOUND"),
                       (lambda m: m.update(5, [0, 0, 0, 0]), "NOT_FOUND"),
                       (lambda m: m.add([1.0]), "INVALID_ARGUMENT"),
                       (lambda m: m.update(0, [1.0]), "INVALID_ARGUMENT")):
        with pytest.raises(JaxError) as want:
            call(ref)
        with pytest.raises(ScannError) as got:
            call(port)
        assert got.value.code.value == want.value.code.value == code
    _same_mutations(port.flush_mutations(), ref.flush_mutations())
    _same_state(port, ref)


def test_snapshot_and_compact(core):
    port, ref = _pair(2)
    for m in (port, ref):
        for i in range(10):
            m.add([i, i])
        for i in range(0, 10, 2):
            m.remove(i)
    _same_state(port, ref)
    assert port.compact() == ref.compact() == 5
    _same_state(port, ref)
    np.testing.assert_array_equal(port.snapshot()[0][:, 0], [1, 3, 5, 7, 9])
    assert port.flush_mutations() == [] == ref.flush_mutations()
    np.testing.assert_array_equal(port.to_dense_dataset().numpy(),
                                  ref.to_dense_dataset().numpy())


def test_growth_past_capacity(core):
    port, ref = _pair(3)
    for m in (port, ref):
        for i in range(500):   # the cores start with room for 64 rows
            m.add([i, i, i])
    _same_state(port, ref)
    np.testing.assert_array_equal(port.get(499), [499, 499, 499])


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 500])
def test_from_dataset_equals_adding_one_row_at_a_time(core, n):
    """The port's one bulk append gives the state of the JAX package's
    n single adds, and logs nothing, as they do not."""
    x = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
    port = pmut.MutableDataset.from_dataset(T.DenseDataset(x))
    ref = jmut.MutableDataset.from_dataset(JaxDataset(x))
    _same_state(port, ref)
    port.add(np.ones(6))
    ref.add(np.ones(6))
    _same_state(port, ref)
    _same_mutations(port.flush_mutations(), ref.flush_mutations())


@pytest.mark.parametrize("n", [0, 1, 200])
def test_add_many_after_compacting_to_zero_rows(core, n):
    """A core compacted down to no rows takes a bulk append (growing past
    its capacity where n asks for it) with the state of the JAX package's
    n single adds."""
    port, ref = _pair(3)
    for m in (port, ref):
        for i in range(5):
            m.add([i, i, i])
        for i in range(5):
            m.remove(i)
    assert port.compact() == ref.compact() == 0
    _same_state(port, ref)
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    assert port._core.add_many(x) == 0
    for row in x:
        ref.add(row)
    _same_state(port, ref)
    assert port.add([7, 7, 7]) == ref.add([7, 7, 7]) == n
    _same_state(port, ref)


def test_mutation_buffer(core):
    port, ref = pmut.MutationBuffer(4, dim=2), jmut.MutationBuffer(4, dim=2)
    for b in (port, ref):
        assert b.add(0, [1.0, 2.0]) and b.remove(0)
        assert b.update(1, [3.0, 4.0])
        assert len(b) == 3 and not b.should_flush()
        assert b.add(2, [0.0, 0.0]) and b.should_flush()
        assert not b.add(3, [0.0, 0.0])      # full
    out = port.flush(2)
    _same_mutations(out, ref.flush(2))
    assert [m.kind for m in out] == [
        pmut.MutationKind.ADD, pmut.MutationKind.REMOVE,
        pmut.MutationKind.UPDATE, pmut.MutationKind.ADD]
    assert port.is_empty and ref.is_empty


def test_mutation_buffer_learns_its_dim(core):
    """A buffer made without a dim returns the pushed vectors."""
    port, ref = pmut.MutationBuffer(64), jmut.MutationBuffer(64)
    for b in (port, ref):
        b.add(0, np.array([1.0, 2.0, 3.0], np.float32))
        b.remove(1)
        b.update(2, np.array([4.0, 5.0, 6.0], np.float32))
    got, want = port.flush(), ref.flush()
    _same_mutations(got, want)
    np.testing.assert_array_equal(got[2].data[:3], [4.0, 5.0, 6.0])


def _shrink_log(m, size):
    m._mutations.max_buffer_size = size
    if m._mutations._lib is not None:
        m._mutations._lib.mbuf_destroy(m._mutations._h)
        m._mutations._h = m._mutations._lib.mbuf_create(size)


def test_log_overflow_flag(core):
    """A full delta log is flagged and warned about once; the dataset
    still takes the change; a flush clears the flag."""
    port, ref = _pair(4)
    v = np.zeros(4, np.float32)
    for m in (port, ref):
        _shrink_log(m, 2)
        m.add(v)
        m.add(v)
        assert not m.mutation_log_overflowed
        with pytest.warns(RuntimeWarning, match="overflowed"):
            m.add(v)
        assert m.mutation_log_overflowed
    _same_state(port, ref)
    _same_mutations(port.flush_mutations(), ref.flush_mutations())
    assert not port.mutation_log_overflowed


def _hammer(m, threads=12, ops=200):
    """Mixed add / read / update from more threads than the host has
    cores; the per-thread operations are seeded, so the row count is fixed
    whatever the interleaving."""
    for i in range(100):
        m.add(np.full(8, i, np.float32))
    errors = []

    def worker(tid):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(ops):
                op = rng.integers(0, 3)
                if op == 0:
                    m.add(rng.normal(size=8).astype(np.float32))
                elif op == 1:
                    v = m.get(int(rng.integers(0, 100)))
                    assert v is None or v.shape == (8,)
                else:
                    m.update(int(rng.integers(0, 100)),
                             rng.normal(size=8).astype(np.float32))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool = [threading.Thread(target=worker, args=(t,))
                for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    assert not errors, errors
    return m


def test_concurrent_hammer(core):
    port, ref = _hammer(pmut.MutableDataset(8)), _hammer(
        jmut.MutableDataset(8))
    assert port.size == ref.size == port.total_rows == ref.total_rows
    assert port.size > 100
    data, deleted = port.snapshot()
    assert not deleted.any()
    # the first 100 rows hold their fill value or a whole update (no torn
    # row: an update writes Gaussian values, never the fill)
    for i in range(100):
        row = data[i]
        assert (row == i).all() or not (row == i).any()
    got = port.flush_mutations()
    want = ref.flush_mutations()
    assert sorted(m.kind.value for m in got) == \
        sorted(m.kind.value for m in want)
    assert sum(m.kind == pmut.MutationKind.ADD for m in got) == port.size
    assert sorted(m.timestamp for m in got) == list(range(len(got)))


def test_incremental_updater():
    for mod in (pmut, jmut):
        u = mod.IncrementalUpdater("index-v1", rebuild_threshold=2)
        assert u.load_index() == "index-v1"
        u.queue_mutation(mod.Mutation.add(0, [1.0]))
        assert not u.needs_rebuild()
        u.queue_mutation(mod.Mutation.remove(0))
        assert u.needs_rebuild()
        assert len(u.get_pending_mutations()) == 2
        u.store_index("index-v2")
        u.reset_rebuild_counter()
        assert u.load_index() == "index-v2" and not u.needs_rebuild()


# ---------------------------------------------------------------------------
# DynamicSearcher over brute force


def _kth_ties(d, k):
    s = np.sort(d[np.isfinite(d)])
    return len(s) > k and abs(s[k] - s[k - 1]) <= 1e-6 * max(abs(s[k]), 1)


def _same_results(got, want, k):
    gi, gd = got
    wi, wd = want
    assert gi.shape == wi.shape == gd.shape == wd.shape
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=RTOL, atol=ATOL)
    for b in range(len(wi)):
        if not _kth_ties(wd[b], k):
            assert set(gi[b].tolist()) == set(wi[b].tolist()), b
            sure = np.abs(np.diff(wd[b][fin[b]])) > 1e-5 * np.abs(
                wd[b][fin[b]][1:]).clip(1)
            # away from ties inside the list the order is the same
            if sure.all():
                np.testing.assert_array_equal(gi[b], wi[b])


class _Lockstep:
    """One mutation sequence applied to a JAX and a port dynamic searcher
    (the JAX one first: a port factory may load the index the JAX factory
    just built)."""

    def __init__(self, port, ref):
        self.port, self.ref = port, ref

    def add(self, v):
        i = self.ref.add(v)
        assert self.port.add(v) == i
        return i

    def update(self, i, v):
        self.ref.update(i, v)
        self.port.update(i, v)

    def remove(self, i):
        self.ref.remove(i)
        self.port.remove(i)

    def search(self, q, k, p_params=None, j_params=None, mask=None):
        got = self.port.search_batched_arrays(q, k, p_params,
                                              allow_mask=mask)
        want = self.ref.search_batched_arrays(q, k, j_params,
                                              allow_mask=mask)
        _same_results(got, want, k)
        return got


def _bf_pair(db, threshold=1000):
    return _Lockstep(
        pmut.DynamicSearcher(T.DenseDataset(db),
                             lambda d: T.BruteForceSearcher(d, device="cpu"),
                             rebuild_threshold=threshold, device="cpu"),
        jmut.DynamicSearcher(JaxDataset(db), lambda d: JaxBF(d),
                             rebuild_threshold=threshold))


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_dynamic_searcher_adds_updates_removes(rng):
    db = rng.normal(size=(300, 8)).astype(np.float32)
    s = _bf_pair(db)
    q = np.concatenate([db[7:8], rng.normal(size=(7, 8))]).astype(np.float32)
    s.search(q, 5)
    new = s.add(db[7] + 1e-4)
    got = s.search(q, 2)
    assert set(got[0][0]) == {7, new}
    s.remove(7)
    assert s.search(q, 1)[0][0, 0] == new
    s.update(3, db[7] + 5e-5)
    assert s.search(q, 1)[0][0, 0] == 3
    for _ in range(20):
        s.add(rng.normal(size=8).astype(np.float32))
    for i in range(40, 60):
        s.update(i, rng.normal(size=8).astype(np.float32))
    for i in range(100, 130):
        s.remove(i)
    s.search(q, 10)
    s.port.force_rebuild()
    s.ref.force_rebuild()
    s.search(q, 10)
    assert s.port.size == s.ref.size == 300 + 21 - 31


def test_dynamic_searcher_auto_rebuild(rng):
    db = rng.normal(size=(50, 4)).astype(np.float32)
    s = _bf_pair(db, threshold=10)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    for i in range(25):
        s.add(rng.normal(size=4).astype(np.float32))
        if i % 7 == 3:
            s.remove(i)
        if i % 6 == 5:     # searches between and across the rebuilds
            s.search(q, 5)
    s.search(q, 5)
    assert s.port._snapshot_rows == s.ref._snapshot_rows > 50
    assert s.port.size == s.ref.size


def test_dynamic_searcher_heavy_deletes(rng):
    """90% of the rows removed since the build: the adaptive fetch doubles
    until every query has k live candidates, on both packages alike; with
    fewer live rows than k, exactly the live rows come back."""
    n, d, k = 400, 8, 10
    db = rng.normal(size=(n, d)).astype(np.float32)
    s = _bf_pair(db, threshold=10_000)
    keep = set(rng.choice(n, size=n // 10, replace=False).tolist())
    for i in range(n):
        if i not in keep:
            s.remove(i)
    q = rng.normal(size=(4, d)).astype(np.float32)
    idx, _ = s.search(q, k)
    assert (idx >= 0).all() and set(idx.ravel().tolist()) <= keep
    small = _bf_pair(db[:20], threshold=10_000)
    for i in range(20):
        if i not in (3, 11):
            small.remove(i)
    idx2, _ = small.search(q[:1], 5)
    assert {int(i) for i in idx2[0] if i >= 0} == {3, 11}


def test_dynamic_searcher_allow_mask_and_epsilons(rng):
    db = rng.normal(size=(300, 8)).astype(np.float32)
    s = _bf_pair(db)
    q = db[7:8]
    a1 = s.add(db[7] + 1e-4)
    a2 = s.add(db[7] + 2e-4)
    s.update(20, db[7] + 3e-4)
    mask = np.ones(302, bool)
    mask[[7, a2]] = False
    idx, _ = s.search(q, 3, mask=mask)
    assert 7 not in idx[0] and a2 not in idx[0] and idx[0, 0] == a1
    eps = dict(p_params=T.SearchParameters(post_reordering_epsilon=1e-3),
               j_params=JaxParams(post_reordering_epsilon=1e-3))
    idx, dist = s.search(q, 5, **eps)
    assert set(idx[0][idx[0] >= 0]) == {7, a1, a2, 20}
    idx, _ = s.search(q, 5, mask=mask, **eps)
    assert set(idx[0][idx[0] >= 0]) == {a1, 20}
    idx, dist = s.search(q, 3, T.SearchParameters(
        pre_reordering_epsilon=-1.0), JaxParams(pre_reordering_epsilon=-1.0))
    assert (idx == -1).all() and np.isinf(dist).all()
    wide = rng.normal(size=(5, 8)).astype(np.float32)
    s.search(wide, 8, mask=rng.random(302) < 0.5)


def test_dynamic_searcher_slab_cached_between_mutations(rng):
    """The delta slab is built once per mutation epoch; an allowlist
    re-derives only its validity vector."""
    db = rng.normal(size=(100, 8)).astype(np.float32)
    s = _bf_pair(db)
    for _ in range(20):
        s.add(rng.normal(size=8).astype(np.float32))
    calls = {"n": 0}
    orig = s.port._mutable.get_batch

    def counting(ids):
        calls["n"] += 1
        return orig(ids)

    s.port._mutable.get_batch = counting
    q = rng.normal(size=(4, 8)).astype(np.float32)
    s.search(q, 5)
    s.search(q, 5)
    assert calls["n"] == 1
    cached = s.port._extra_cache[0]
    s.add(rng.normal(size=8).astype(np.float32))
    s.search(q, 5)
    assert calls["n"] == 2 and s.port._extra_cache[0] is not cached
    s.search(q, 5, mask=np.arange(121) % 3 != 0)
    assert calls["n"] == 2


def test_dynamic_searcher_refuses_a_missing_card(monkeypatch):
    """The default device is the card: without one the constructor raises
    before any work, instead of serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmut.DynamicSearcher(T.DenseDataset(np.zeros((4, 2), np.float32)),
                             built.append)
    assert built == []


def test_dynamic_merge_dedups_like_the_jax_broadcast(rng):
    """The merge's ``isin`` dedup against the JAX package's [B, F, E]
    broadcast, on the same inputs."""
    b, f, e, d, k = 6, 12, 9, 4, 7
    snap = torch.from_numpy(rng.normal(size=(40, d)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    cand = torch.from_numpy(rng.integers(-1, 40, size=(b, f)))
    extra_ids = torch.from_numpy(np.concatenate(
        [rng.choice(40, 5, replace=False), np.arange(40, 44)]))
    extra_rows = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    valid = torch.from_numpy(rng.random(e) < 0.7)
    vals, idx = pmut.dynamic_merge(q, snap, cand, extra_rows, extra_ids,
                                   valid, float("inf"), k=k,
                                   measure=DistanceMeasure.SQUARED_L2)
    # the JAX slab is padded to 256 rows, the padding invalid
    pad = 256 - e
    jv, ji = jmut._dynamic_search_kernel(
        q.numpy(), snap.numpy(), cand.numpy().astype(np.int32),
        np.pad(extra_rows.numpy(), ((0, pad), (0, 0))),
        np.pad(extra_ids.numpy().astype(np.int32), (0, pad)),
        np.pad(valid.numpy(), (0, pad)), np.float32(np.inf), k=k,
        measure=JaxMeasure.SQUARED_L2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# DynamicSearcher over tree-x-AH


TN, TD = 800, 16
# the k-means of every build train on this many rows, so a rebuild reuses
# the compiled programs of the first build
TRAIN = 640


def _tree_jax_cfg(measure="SQUARED_L2"):
    return JaxTreeConfig(
        num_partitions=8, partitions_to_search=8, max_partition_size=None,
        distance_measure=JaxMeasure[measure],
        partition_training_sample_size=TRAIN,
        hash_config=JaxHashConfig(num_codes=16, num_subspaces=8, seed=0,
                                  max_iterations=4,
                                  training_sample_size=TRAIN))


def _tree_pair(db, tmp_path, measure="SQUARED_L2", threshold=1000,
               port_measure=None, jax_measure=None):
    """Dynamic searchers over tree-x-AH: the JAX factory builds and saves
    each main index; the port's factory loads the same file (and checks it
    gets the same snapshot)."""
    built = []

    def jax_factory(ds):
        s = JaxTree(_tree_jax_cfg(measure)).build(ds)
        path = str(tmp_path / f"main{len(built)}.npz")
        save_index(path, s)
        built.append((path, ds.numpy()))
        return s

    def port_factory(ds):
        path, rows = built[-1]
        np.testing.assert_array_equal(ds.numpy(), rows)
        return tio.load_index(path, device="cpu")

    ref = jmut.DynamicSearcher(JaxDataset(db), jax_factory,
                               rebuild_threshold=threshold,
                               distance_measure=jax_measure)
    port = pmut.DynamicSearcher(T.DenseDataset(db), port_factory,
                                rebuild_threshold=threshold,
                                distance_measure=port_measure, device="cpu")
    return _Lockstep(port, ref), built


def _tree_data(seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, TD)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 8, TN)]
          + rng.normal(size=(TN, TD))).astype(np.float32)
    q = (centers[rng.integers(0, 8, 12)]
         + rng.normal(size=(12, TD))).astype(np.float32)
    return rng, db, q


def _full_params(n):
    """Every probed candidate re-ranked exactly: no bf16 boundary tie can
    change which rows come back."""
    return (T.SearchParameters(num_leaves_to_search=8,
                               pre_reordering_num_neighbors=n),
            JaxParams(num_leaves_to_search=8, pre_reordering_num_neighbors=n))


def test_dynamic_tree_ah_matches_jax(tmp_path):
    rng, db, q = _tree_data()
    s, built = _tree_pair(db, tmp_path, threshold=60)
    p, j = _full_params(TN)
    s.search(q, 10, p, j)
    for i in range(30):
        s.add(db[i] + rng.normal(size=TD).astype(np.float32) * 0.01)
    for i in range(100, 110):
        s.update(i, rng.normal(size=TD).astype(np.float32))
    for i in range(200, 215):
        s.remove(i)
    s.search(q, 10, p, j)
    s.search(q, 10, p, j, mask=np.arange(TN + 30) % 2 == 0)
    assert len(built) == 1
    for i in range(10):       # past the threshold: a rebuild on both
        s.add(rng.normal(size=TD).astype(np.float32))
    assert len(built) == 2
    s.search(q, 10, p, j)


def test_measure_of_main_falls_back_to_squared_l2(tmp_path):
    """Over a DOT_PRODUCT tree-x-AH, which keeps its measure only in its
    config, both packages rescore in squared L2 unless ``distance_measure``
    is passed (a JAX package hazard the port reproduces)."""
    _, db, q = _tree_data(6)
    p, j = _full_params(TN)
    s, _ = _tree_pair(db, tmp_path, measure="DOT_PRODUCT")
    assert s.port._measure_of_main() == DistanceMeasure.SQUARED_L2
    assert s.ref._measure_of_main() == JaxMeasure.SQUARED_L2
    idx, dist = s.search(q, 10, p, j)
    want = ((q[:, None, :] - db[idx]) ** 2).sum(-1)
    np.testing.assert_allclose(dist, want, rtol=1e-4, atol=1e-3)
    passed, _ = _tree_pair(db, tmp_path, measure="DOT_PRODUCT",
                           port_measure=DistanceMeasure.DOT_PRODUCT,
                           jax_measure=JaxMeasure.DOT_PRODUCT)
    assert passed.port._measure_of_main() == DistanceMeasure.DOT_PRODUCT
    idx, dist = passed.search(q, 10, p, j)
    np.testing.assert_allclose(dist, -(q[:, None, :] * db[idx]).sum(-1),
                               rtol=1e-4, atol=1e-3)

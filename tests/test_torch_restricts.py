"""Restricts, crowding and the host top-k structures of the PyTorch port
against the JAX package on the CPU.

- Every filter's ``to_mask`` and ``is_allowed``, the allow / deny lists,
  the sparse allowlist, the token map, ``apply_crowding`` and both
  crowding classes give the JAX package's answers on the same inputs.
- ``search_batched_with_filter`` and ``search_with_crowding`` equal the JAX
  package's on brute force (the mask path: the filter's mask is applied on
  the device) and on the asymmetric hasher (no mask: the host over-fetch).
  The hasher is the JAX package's index carried across in its saved file,
  searched with every row re-ranked exactly, so ids compare away from
  distance ties and distances within 1e-5 relative.
- ``TopK``, ``FixedTopK`` and ``FastTopNeighbors`` equal the JAX package's
  on pushes with ties and an epsilon.
"""

import numpy as np
import pytest

import scann_tpu.restricts as jr
from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.hasher import (
    AsymmetricHasher as JaxHasher,
    AsymmetricHasherConfig as JaxHashConfig,
)
from scann_tpu.io import save_index
from scann_tpu.models.brute_force import BruteForceSearcher as JaxBF
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.ops import topk_host as jth
import scann_tpu_torch as T
import scann_tpu_torch.restricts as pr
from scann_tpu_torch import io as tio
from scann_tpu_torch.ops import topk_host as pth
from torch_threads import one_torch_thread  # noqa: F401

N, D, B, K = 500, 12, 10, 6
RTOL, ATOL = 1e-5, 1e-4


def test_public_names_match_jax():
    assert pr.__all__ == jr.__all__
    for name in jr.__all__:
        assert hasattr(pr, name)


# name -> the same filter, made from either package's module
FILTERS = {
    "none": lambda m: m.NoRestrict(),
    "predicate": lambda m: m.PredicateFilter(lambda i: i % 7 in (1, 4)),
    "range": lambda m: m.RangeFilter(10, 60),
    "range_past_end": lambda m: m.RangeFilter(90, 500),
    "range_negative": lambda m: m.RangeFilter(-5, 3),
    "and": lambda m: m.AndFilter([m.RangeFilter(0, 80),
                                  m.PredicateFilter(lambda i: i % 2 == 0)]),
    "and_empty": lambda m: m.AndFilter(),
    "or": lambda m: m.OrFilter().add(m.RangeFilter(5, 9)).add(
        m.RangeFilter(50, 55)),
    "or_empty": lambda m: m.OrFilter(),
    "not": lambda m: m.NotFilter(m.RangeFilter(20, 40)),
    "allowlist": lambda m: m.AllowlistFilter(
        m.RestrictAllowlist.from_indices([1, 3, 5, 99, 150, -2], 100)),
    "denylist": lambda m: m.DenylistFilter(
        m.RestrictDenylist.from_indices([0, 2, 4, 130], 50)),
    "nested": lambda m: m.AndFilter([
        m.AllowlistFilter(m.RestrictAllowlist.from_indices(
            range(0, 120, 2), 120)),
        m.NotFilter(m.RangeFilter(0, 30)),
        m.OrFilter([m.RangeFilter(40, 70), m.PredicateFilter(
            lambda i: i > 100)])]),
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_filter_matches_jax(name):
    port, ref = FILTERS[name](pr), FILTERS[name](jr)
    for n in (0, 1, 50, 120, 200):
        got, want = port.to_mask(n), ref.to_mask(n)
        assert got.dtype == want.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
    for i in range(-3, 210):
        assert port.is_allowed(i) == ref.is_allowed(i)


def test_base_filter_mask_is_its_predicate():
    class Odd:
        def is_allowed(self, index):
            return index % 2 == 1

    for m in (pr, jr):
        f = type("OddFilter", (m.RestrictFilter,), {
            "is_allowed": lambda self, i: i % 2 == 1})()
        np.testing.assert_array_equal(
            f.to_mask(9), [Odd().is_allowed(i) for i in range(9)])
        with pytest.raises(NotImplementedError):
            m.RestrictFilter().is_allowed(0)


def _allowlist_ops(m):
    a = m.RestrictAllowlist.from_set({2, 4, 6, 200}, 64)
    a.add(10)
    a.add(64)
    a.remove(4)
    a.remove(1000)
    out = [a.indices(), a.count(), a.capacity, a.to_mask(30).tolist(),
           a.to_mask(80).tolist(), [a.is_allowed(i) for i in range(-1, 70)]]
    a.clear()
    return out + [a.count(), a.indices()]


def _denylist_ops(m):
    d = m.RestrictDenylist.from_indices([1, 3, 70, -4], 10)
    out = [d.capacity]
    d.deny(200)
    d.deny(-1)
    d.allow(3)
    d.allow(500)
    out += [d.capacity, d.to_mask(250).tolist(), d.to_mask(5).tolist(),
            [d.is_allowed(i) for i in range(-2, 260)]]
    d.clear()
    return out + [d.to_mask(12).tolist()]


def _sparse_ops(m):
    s = m.SparseAllowlist.from_indices([9, 1, 5, 5, 300])
    s.add(7)
    s.remove(1)
    s.remove(1000)
    return [list(s.indices()), s.to_mask(20).tolist(),
            [s.is_allowed(i) for i in range(0, 12)]]


def _token_ops(m):
    t = m.RestrictTokenMap(40)
    t.add_token(3, 1)
    t.set_tokens(5, [1, 2])
    t.set_tokens(30, [2, 9])
    a = t.create_allowlist([1, 9, 77])
    return [t.num_tokens, t.get_indices(1), t.get_indices(2),
            t.get_indices(5), a.indices(), a.capacity]


@pytest.mark.parametrize("ops", [_allowlist_ops, _denylist_ops, _sparse_ops,
                                 _token_ops])
def test_lists_match_jax(ops):
    assert ops(pr) == ops(jr)


def _sorted_candidates(rng, b=8, m=40, n=60):
    idx = rng.integers(-1, n, size=(b, m))
    dists = np.sort(rng.random((b, m)).astype(np.float32), axis=1)
    return idx, dists


@pytest.mark.parametrize("limit,k", [(1, 5), (2, 10), (3, 40), (100, 7)])
def test_apply_crowding_matches_jax(limit, k):
    rng = np.random.default_rng(limit + k)
    idx, dists = _sorted_candidates(rng)
    attrs = rng.integers(0, 6, size=50)       # rows past 50: attribute 0
    got = pr.apply_crowding(idx, dists, attrs, limit, k)
    want = jr.apply_crowding(idx, dists, attrs, limit, k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("enabled", [True, False])
def test_crowding_constraint_matches_jax(enabled):
    rng = np.random.default_rng(3)
    attrs = rng.integers(0, 4, size=30).tolist()

    def run(m):
        c = m.CrowdingConstraint(attrs, m.CrowdingConfig(
            per_crowd_limit=2, enabled=enabled))
        c.set_attribute(40, 3)
        results = [(int(i), float(d)) for i, d in zip(
            rng.permutation(45), np.linspace(0, 1, 45))]
        idx, dists = _sorted_candidates(np.random.default_rng(5), n=45)
        bi, bd = c.apply_batch(idx, dists, 6)
        return [c.get_attribute(3), c.get_attribute(35), c.get_attribute(-1),
                c.apply(results, 8), c.would_violate(40, results[:10]),
                c.would_violate(0, []), bi.tolist(), bd.tolist()]

    rng_state = rng.bit_generator.state
    got = run(pr)
    rng.bit_generator.state = rng_state
    assert got == run(jr)


def test_crowding_multidimensional_matches_jax():
    def run(m):
        rng = np.random.default_rng(9)
        c = m.CrowdingMultidimensional(2, 50)
        for i in range(50):
            c.set_attribute(0, i, int(rng.integers(0, 3)))
            c.set_attribute(1, i, int(rng.integers(0, 5)))
        c.set_limit(0, 3)
        c.set_limit(1, 2)
        results = [(int(i), float(j)) for j, i in enumerate(
            rng.permutation(60))]
        return c.apply(results, 10)

    assert run(pr) == run(jr)


# ---------------------------------------------------------------------------
# filtered and crowded search


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(10, D)).astype(np.float32) * 3
    labels = rng.integers(0, 10, N)
    x = (centers[labels] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 10, B)]
         + rng.normal(size=(B, D))).astype(np.float32)
    return x, q, labels


@pytest.fixture(scope="module")
def searchers(data, tmp_path_factory):
    """name -> (port searcher, JAX searcher, port params, JAX params)."""
    x, _, _ = data
    jax_h = JaxHasher(JaxHashConfig(num_codes=16, num_subspaces=6, seed=0,
                                    max_iterations=4)).build(JaxDataset(x))
    path = str(tmp_path_factory.mktemp("hashed") / "hasher.npz")
    save_index(path, jax_h)
    return {
        "brute_force": (T.BruteForceSearcher(T.DenseDataset(x),
                                             device="cpu"),
                        JaxBF(JaxDataset(x)), None, None),
        "hasher": (tio.load_index(path, device="cpu"), jax_h,
                   T.SearchParameters(pre_reordering_num_neighbors=N),
                   JaxParams(pre_reordering_num_neighbors=N)),
    }


def _results(rs):
    return ([r.indices() for r in rs], [r.distances() for r in rs])


def _kth_ties(d, k):
    s = np.sort(np.asarray(d))
    return len(s) >= k + 1 and abs(s[k] - s[k - 1]) <= 1e-6 * max(
        abs(s[k]), 1)


def _same(got, want, k=K):
    gi, gd = _results(got)
    wi, wd = _results(want)
    assert [len(r) for r in gi] == [len(r) for r in wi]
    for b in range(len(wi)):
        np.testing.assert_allclose(gd[b], wd[b], rtol=RTOL, atol=ATOL)
        if not _kth_ties(wd[b], k):
            assert gi[b] == wi[b], b


FILTER_CASES = {
    "allow_even_not_low": lambda m: m.AndFilter([
        m.AllowlistFilter(m.RestrictAllowlist.from_indices(
            range(0, N, 2), N)), m.NotFilter(m.RangeFilter(0, 100))]),
    "sparse": lambda m: m.AllowlistFilter(
        m.RestrictAllowlist.from_indices(range(0, N, 37), N)),
    "deny_range": lambda m: m.DenylistFilter(
        m.RestrictDenylist.from_indices(range(100, 400), N)),
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
@pytest.mark.parametrize("name", ["brute_force", "hasher"])
def test_filtered_search_matches_jax(searchers, data, name, case):
    """Brute force takes the mask on the device, the hasher over-fetches
    min(max(4k, k + 32), N) and filters on the host: both equal the JAX
    package's results, and every id passes the filter."""
    port, ref, pp, jp = searchers[name]
    _, q, _ = data
    assert port.supports_allow_mask() == ref.supports_allow_mask() == (
        name == "brute_force")
    pf, jf = FILTER_CASES[case](pr), FILTER_CASES[case](jr)
    got = port.search_batched_with_filter(q, K, pf, pp)
    _same(got, ref.search_batched_with_filter(q, K, jf, jp))
    assert all(pf.is_allowed(i) for r in got for i in r.indices())
    one = port.search_with_filter(q[0], K, pf, pp)
    assert one.indices() == got[0].indices()


@pytest.mark.parametrize("limit,over_fetch", [(1, 4), (2, 4), (2, 2)])
@pytest.mark.parametrize("name", ["brute_force", "hasher"])
def test_crowded_search_matches_jax(searchers, data, name, limit,
                                    over_fetch):
    """No query returns more than ``limit`` ids of one attribute, and the
    results equal the JAX package's, and ``apply_batch`` over the same
    over-fetched candidates."""
    port, ref, pp, jp = searchers[name]
    _, q, labels = data
    pc = pr.CrowdingConstraint(labels, pr.CrowdingConfig(limit, True))
    jc = jr.CrowdingConstraint(labels, jr.CrowdingConfig(limit, True))
    got = port.search_with_crowding(q, K, pc, pp, over_fetch=over_fetch)
    _same(got, ref.search_with_crowding(q, K, jc, jp, over_fetch=over_fetch))
    for r in got:
        counts = np.bincount(labels[r.indices()], minlength=10)
        assert counts.max() <= limit
    idx, dist = port.search_batched_arrays(q, K * over_fetch, pp)
    want_i, _ = pc.apply_batch(idx.astype(np.int64), dist, K)
    assert [r.indices() for r in got] == [
        [int(i) for i in row if i >= 0] for row in want_i]


# ---------------------------------------------------------------------------
# host top-k structures


def _threshold(top):
    """The threshold, or the exception it raises (k=0 in both packages)."""
    try:
        return top.threshold
    except IndexError as e:
        return type(e)


def _pushes(seed, n=200):
    rng = np.random.default_rng(seed)
    # few distinct values: many ties
    return [(int(i), float(d)) for i, d in zip(
        rng.permutation(n), rng.integers(0, 12, n) / 4.0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [0, 1, 5, 40])
def test_topk_matches_jax(seed, k):
    port, ref = pth.TopK(k), jth.TopK(k)
    for i, d in _pushes(seed):
        port.push(i, d)
        ref.push(i, d)
        assert _threshold(port) == _threshold(ref)
        assert len(port) == len(ref)
    assert port.drain_sorted() == ref.drain_sorted()
    assert len(port) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [0, 1, 5, 40])
def test_fixed_topk_matches_jax(seed, k):
    port, ref = pth.FixedTopK(k), jth.FixedTopK(k)
    for i, d in _pushes(seed):
        port.push(i, d)
        ref.push(i, d)
        assert _threshold(port) == _threshold(ref)
    assert port.results() == ref.results() and len(port) == len(ref)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k,eps", [(1, float("inf")), (5, 1.5), (20, 2.0),
                                   (40, 0.25)])
def test_fast_top_neighbors_matches_jax(seed, k, eps):
    port = pth.FastTopNeighbors(k, eps)
    ref = jth.FastTopNeighbors(k, eps)
    pushes = _pushes(seed)
    for i, d in pushes[:50]:
        port.push(i, d)
        ref.push(i, d)
        assert port.threshold == ref.threshold
    rest = pushes[50:]
    port.push_batch([i for i, _ in rest], np.array([d for _, d in rest]))
    ref.push_batch([i for i, _ in rest], np.array([d for _, d in rest]))
    assert port.threshold == ref.threshold
    assert port.results() == ref.results()

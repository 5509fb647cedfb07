"""Exact brute force of the PyTorch port against the JAX package on the CPU:
every dense measure of ``many_to_many`` and its relatives, the searcher
(ids, distances, allow masks, epsilons, k past N, duplicate rows, the
distance matrix, radius search, the object API, index loading), the fused
kernel's twin against the Pallas kernel in interpret mode, the fused gate's
decisions and the independence of results from the query chunking.

Tolerances: distances within 1e-5 relative (float32 products in another
summation order; an absolute 1e-4 where the formula cancels terms of size
~10^2 down to ~0); ids equal at every slot whose reference distance lies
more than that tolerance from its neighbours', and duplicate rows lowest
index first.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.io import save_index
from scann_tpu.models.brute_force import BruteForceSearcher as JaxBF
from scann_tpu.ops import distances as jd
from scann_tpu.ops.fused_bf_pallas import fused_bf_search_pallas
import scann_tpu_torch as T
from scann_tpu_torch import io as tio
from scann_tpu_torch.models import brute_force as pbf
from scann_tpu_torch.ops import distances as td
from scann_tpu_torch.ops import fused_bf as fb

DENSE = [m.name for m in jd.DistanceMeasure
         if m.name not in ("WEIGHTED_JACCARD", "OVERLAP")]
SEARCH_MEASURES = ["SQUARED_L2", "DOT_PRODUCT", "COSINE", "L2", "L1",
                   "LIMITED_INNER_PRODUCT"]
N, D, B, K = 400, 16, 24, 10
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def data():
    """Rows with repeated values and zeros (HAMMING, NON_ZERO_INTERSECT),
    norms both sides of 1 (LIMITED_INNER_PRODUCT), a zero row (COSINE) and
    two duplicated rows."""
    rng = np.random.default_rng(21)
    db = (np.round(rng.normal(size=(N, D)) * 2) / 8).astype(np.float32)
    db[5] = 0.0
    db[77] = db[300]
    db[150] = db[151]
    q = (np.round(rng.normal(size=(B, D)) * 2) / 8).astype(np.float32)
    q[0] = db[300]            # its nearest rows are the duplicates 77, 300
    q[1] = 0.0
    return db, q


def assert_results_match(got_i, got_d, want_i, want_d, rtol=RTOL, atol=ATOL):
    """Distances close; ids equal where the reference value is separated
    from its neighbours by more than the tolerance, and in every row whose
    distances are bit-identical (exact ties then go lowest index first on
    both sides)."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want_d))
    np.testing.assert_allclose(got_d, want_d, rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(np.where(np.isinf(want_d), 0, want_d))
    pad = np.full((len(want_d), 1), np.inf)
    ext = np.concatenate([-pad, want_d, pad], axis=1)
    with np.errstate(invalid="ignore"):
        gap = np.minimum(ext[:, 1:-1] - ext[:, :-2], ext[:, 2:] - ext[:, 1:-1])
        strict = (gap > tol) | np.isinf(want_d)
    np.testing.assert_array_equal(got_i[strict], want_i[strict])
    same = (got_d == want_d).all(axis=1)
    np.testing.assert_array_equal(got_i[same], want_i[same])


def _exact_l2(q, db):
    """Exact L2 distances of the fixture's rows: their squared distances
    are sums of multiples of 1/64, exact in float32, so the float64 root of
    the float64 squares is the correctly rounded distance."""
    sq = ((q.astype(np.float64)[:, None] - db[None].astype(np.float64)) ** 2
          ).sum(-1)
    return np.sqrt(sq).astype(np.float32)


def _torch_state(q, db):
    """The process-wide torch settings an earlier test file could leave
    behind, and where the port's L2 moved: the error of its squared
    distances against the exact squares, and the error of ``torch.sqrt``
    over those same squares against their float64 root."""
    # no getter for set_flush_denormal: a denormal input reads as 0 under it
    flush = float(torch.tensor([1e-39]) * 2.0) == 0.0
    sq = td.many_to_many(td.DistanceMeasure.SQUARED_L2, torch.from_numpy(q),
                         torch.from_numpy(db), chunk_size=96)
    exact_sq = ((q.astype(np.float64)[:, None]
                 - db[None].astype(np.float64)) ** 2).sum(-1)
    root64 = np.sqrt(sq.numpy().astype(np.float64)).astype(np.float32)
    return (f"cpu capability {torch.backends.cpu.get_cpu_capability()}, "
            f"{torch.get_num_threads()} threads, flush denormal {flush}, "
            f"mkldnn enabled {torch.backends.mkldnn.enabled}, float32 matmul "
            f"precision {torch.get_float32_matmul_precision()}; squares off "
            f"the exact squares by up to "
            f"{float(np.abs(sq.numpy() - exact_sq).max())}, torch.sqrt of "
            f"them off their float64 root by up to "
            f"{float(np.abs(sq.sqrt().numpy() - root64).max())}")


def _check_l2_against_exact(q, db, got, want):
    """The port's L2 within RTOL/ATOL of the exact root (stricter than the
    JAX comparison it replaces where JAX is off); JAX's result held to the
    port only where JAX itself agrees with the exact root. Whole-suite runs
    have seen this fail, its cause not reproduced (ROADMAP queue 3): a
    failure here names the port's error and JAX's, torch's process-wide
    settings and whether the squares or the root moved."""
    exact = _exact_l2(q, db)
    port_err = float(np.abs(got - exact).max())
    jax_err = float(np.abs(want - exact).max())
    np.testing.assert_allclose(
        got, exact, rtol=RTOL, atol=ATOL,
        err_msg=f"the port's L2 is off the exact root by up to {port_err} "
                f"(JAX's by {jax_err}); {_torch_state(q, db)}")
    if np.allclose(want, exact, rtol=RTOL, atol=ATOL):
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=ATOL,
            err_msg=f"both sides are near the exact root, the port off by "
                    f"up to {port_err} and JAX by {jax_err}; "
                    f"{_torch_state(q, db)}")
    else:
        warnings.warn(f"JAX's L2 is off the exact root by up to {jax_err} "
                      f"in this process (the port's by {port_err}); the "
                      f"port was held to the exact root")


@pytest.mark.parametrize("name", DENSE)
def test_many_to_many_every_dense_measure_matches_jax(data, name):
    db, q = data
    want = np.asarray(jd.many_to_many(jd.DistanceMeasure[name],
                                      jnp.asarray(q), jnp.asarray(db),
                                      chunk_size=96))
    got = td.many_to_many(td.DistanceMeasure[name], torch.from_numpy(q),
                          torch.from_numpy(db), chunk_size=96)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    if name == "L2":
        _check_l2_against_exact(q, db, got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=RTOL,
                                   atol=ATOL)
    if name in ("SQUARED_L2", "L1", "COSINE"):
        # the single-query, pairwise and scalar forms
        np.testing.assert_allclose(
            td.one_to_many(td.DistanceMeasure[name], torch.from_numpy(q[2]),
                           torch.from_numpy(db)).numpy(), want[2],
            rtol=RTOL, atol=ATOL)
        pw = np.asarray(jd.pairwise_distances(jd.DistanceMeasure[name],
                                              jnp.asarray(q)))
        np.testing.assert_allclose(
            td.pairwise_distances(td.DistanceMeasure[name],
                                  torch.from_numpy(q)).numpy(), pw,
            rtol=RTOL, atol=ATOL)
        assert abs(float(td.one_to_one(
            td.DistanceMeasure[name], torch.from_numpy(q[3]),
            torch.from_numpy(db[9]))) - want[3, 9]) <= ATOL + RTOL * abs(
                want[3, 9])


def _leaked_state(state, tmp_path):
    """Sets one process-wide setting that an earlier test file on the same
    worker could leave behind; returns the function that restores it."""
    if state == "torch_flush_denormal":
        torch.set_flush_denormal(True)
        return lambda: torch.set_flush_denormal(False)
    if state == "torch_one_thread":
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        return lambda: torch.set_num_threads(n)
    if state == "torch_matmul_medium":
        old = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("medium")
        return lambda: torch.set_float32_matmul_precision(old)
    if state == "mkldnn_off":
        torch.backends.mkldnn.enabled = False
        return lambda: setattr(torch.backends.mkldnn, "enabled", True)
    if state == "jax_matmul_bf16":
        jax.config.update("jax_default_matmul_precision", "bfloat16")
        return lambda: jax.config.update("jax_default_matmul_precision",
                                         None)
    # the persistent compilation cache scann_tpu turns on outside the
    # tests (SCANN_TPU_COMPILE_CACHE): every program written, then loaded
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    for k, v in zip(keys, (str(tmp_path), 0.0, -1)):
        jax.config.update(k, v)
    jax.clear_caches()

    def restore():
        for k, v in old.items():
            jax.config.update(k, v)
        jax.clear_caches()
    return restore


@pytest.mark.parametrize("state", [
    "torch_flush_denormal", "torch_one_thread", "torch_matmul_medium",
    "mkldnn_off", "jax_matmul_bf16", "jax_compile_cache"])
def test_l2_parity_holds_under_leaked_states(data, state, tmp_path):
    """The L2 case of the test above after each process-wide setting an
    earlier file on the worker could leave (ROADMAP queue 3: the one
    failure was not reproduced in whole-suite runs or behind any single
    file): both sides stay within RTOL/ATOL of the exact root, twice (the
    second call of the compile-cache case loads the cached programs)."""
    db, q = data
    restore = _leaked_state(state, tmp_path)
    try:
        for _ in range(2):
            want = np.asarray(jd.many_to_many(
                jd.DistanceMeasure.L2, jnp.asarray(q), jnp.asarray(db),
                chunk_size=96))
            got = td.many_to_many(td.DistanceMeasure.L2, torch.from_numpy(q),
                                  torch.from_numpy(db), chunk_size=96)
            exact = _exact_l2(q, db)
            np.testing.assert_allclose(got.numpy(), exact, rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(want, exact, rtol=RTOL, atol=ATOL)
            if state == "jax_compile_cache":
                jax.clear_caches()
    finally:
        restore()


@pytest.mark.parametrize("name", ["L2", "L1", "JACCARD", "DICE", "COSINE"])
def test_gathered_distances_new_measures_match_jax(data, name):
    db, q = data
    rows = db[np.random.default_rng(2).integers(0, N, size=(B, 7))]
    want = np.asarray(jd.gathered_distances(jd.DistanceMeasure[name],
                                            jnp.asarray(q),
                                            jnp.asarray(rows)))
    got = td.gathered_distances(td.DistanceMeasure[name], torch.from_numpy(q),
                                torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mask_padded_rows_and_sparse_measures(data):
    db, q = data
    d = np.arange(12, dtype=np.float32).reshape(2, 6)
    want = np.asarray(jd.mask_padded_rows(jnp.asarray(d), 4, 7.5))
    got = td.mask_padded_rows(torch.from_numpy(d), 4, 7.5)
    np.testing.assert_array_equal(got.numpy(), want)
    for name in ("WEIGHTED_JACCARD", "OVERLAP"):
        with pytest.raises(NotImplementedError,
                           match="SparseBruteForceSearcher"):
            td.many_to_many(td.DistanceMeasure[name], torch.from_numpy(q),
                            torch.from_numpy(db))


def _searchers(db, name):
    return (JaxBF(JaxDataset(db), jd.DistanceMeasure[name]),
            T.BruteForceSearcher(T.DenseDataset(db),
                                 T.DistanceMeasure[name], device="cpu"))


@pytest.mark.parametrize("name", SEARCH_MEASURES)
def test_searcher_matches_jax(data, name):
    db, q = data
    jax_s, port = _searchers(db, name)
    want_i, want_d = jax_s.search_batched_arrays(q, K)
    got_i, got_d = port.search_batched_arrays(q, K)
    assert got_i.dtype == np.int32 and got_d.dtype == np.float32
    assert_results_match(got_i, got_d, want_i, want_d)
    if name == "SQUARED_L2":
        # duplicate rows 77 and 300 tie exactly: lowest index first
        assert list(got_i[0, :2]) == [77, 300]
        assert got_d[0, 0] == got_d[0, 1]


def test_allow_mask_matches_jax(data):
    db, q = data
    jax_s, port = _searchers(db, "SQUARED_L2")
    allow = np.random.default_rng(8).random(N) < 0.3
    want_i, want_d = jax_s.search_batched_arrays(q, K, allow_mask=allow)
    got_i, got_d = port.search_batched_arrays(q, K, allow_mask=allow)
    assert_results_match(got_i, got_d, want_i, want_d)
    assert allow[got_i[got_i >= 0]].all()
    assert port.supports_allow_mask()


@pytest.mark.parametrize("which", ["pre", "post", "both"])
def test_epsilon_matches_jax(data, which):
    db, q = data
    jax_s, port = _searchers(db, "SQUARED_L2")
    all_d = jax_s.search_batched_arrays(q, K)[1]
    eps = float(np.median(all_d[:, 4]))
    kw = {"pre": dict(pre_reordering_epsilon=eps),
          "post": dict(post_reordering_epsilon=eps),
          "both": dict(pre_reordering_epsilon=eps * 2,
                       post_reordering_epsilon=eps)}[which]
    from scann_tpu.models.searcher import SearchParameters as JaxParams

    want_i, want_d = jax_s.search_batched_arrays(q, K, JaxParams(**kw))
    got_i, got_d = port.search_batched_arrays(q, K, T.SearchParameters(**kw))
    assert_results_match(got_i, got_d, want_i, want_d)
    assert (got_i == -1).any() and (got_d[got_i >= 0] <= eps).all()


def test_k_past_n_and_errors_match_jax(data):
    db, q = data
    jax_s, port = _searchers(db[:6], "SQUARED_L2")
    want_i, want_d = jax_s.search_batched_arrays(q, 50)
    got_i, got_d = port.search_batched_arrays(q, 50)
    assert got_i.shape == (B, 6)
    assert_results_match(got_i, got_d, want_i, want_d)
    with pytest.raises(T.ScannError):
        port.search_batched_arrays(q, 0)
    with pytest.raises(T.ScannError):
        port.search_batched_arrays(q[:, :3], 5)
    with pytest.raises(T.ScannError):
        T.BruteForceSearcher(db, device="cpu")


def test_distances_radius_and_object_api_match_jax(data):
    db, q = data
    jax_s, port = _searchers(db, "SQUARED_L2")
    want = jax_s.distances_to_all(q)
    got = port.distances_to_all(q)
    assert got.shape == (B, N)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    radius = float(np.sort(want[2])[15])
    want_r = jax_s.radius_search(q[2], radius, max_results=12)
    got_r = port.radius_search(q[2], radius, max_results=12)
    assert got_r.indices() == want_r.indices()
    np.testing.assert_allclose(got_r.distances(), want_r.distances(),
                               rtol=RTOL, atol=ATOL)
    one = port.search(q[0], 3)
    assert one.indices() == [77, 300, jax_s.search(q[0], 3).indices()[2]]
    assert all(nb.docid is None for nb in one)
    many = port.search_batched(q[:4], params=T.SearchParameters(
        num_neighbors=4))
    assert [len(r) for r in many] == [4] * 4
    assert many[2].indices() == jax_s.search_batched(q[:4], 4)[2].indices()


FUSED_CASES = {
    # the three cases of tests/test_fused_bf.py
    "oracle": dict(n=256, d=32, b=8, n_valid=256, k=5, zero_tail=False),
    "masks_padding": dict(n=64, d=8, b=8, n_valid=50, k=3, zero_tail=True),
    "k_exceeds_valid": dict(n=16, d=4, b=8, n_valid=2, k=5, zero_tail=False),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_twin_matches_pallas(case):
    c = FUSED_CASES[case]
    rng = np.random.default_rng(42)
    db = rng.normal(size=(c["n"], c["d"])).astype(np.float32)
    q = rng.normal(size=(c["b"], c["d"])).astype(np.float32)
    if c["zero_tail"]:
        db[c["n_valid"]:] = 0.0   # padding rows at the queries' location
        q[:] = 0.0
    norms = (db ** 2).sum(1).astype(np.float32)
    want_v, want_i = fused_bf_search_pallas(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(norms[None, :]),
        jnp.asarray([c["n_valid"]], jnp.int32), k=c["k"], interpret=True)
    got_v, got_i = fb.fused_bf_search(
        torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(norms),
        c["n_valid"], c["k"])
    assert got_i.dtype == torch.int32 and got_v.shape == (c["b"], c["k"])
    assert_results_match(got_i.numpy(), got_v.numpy(), np.asarray(want_i),
                         np.asarray(want_v))
    assert (got_i.numpy() < c["n_valid"]).all()
    stats = fb.check_against_twin(
        torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(norms),
        c["n_valid"], c["k"], got_v, got_i)
    assert stats["max_abs_err"] == 0.0


@pytest.mark.parametrize("n,d,b,k,name,masked", [
    (10_000, 64, 100, 10, "SQUARED_L2", False),    # bench.py's B=100: fused
    (10_000, 64, 200, 10, "SQUARED_L2", False),
    (10_000, 64, 6400, 10, "SQUARED_L2", False),   # bench.py's B=6400
    (20_000, 64, 200, 10, "SQUARED_L2", False),    # the JAX test's 17.8M
    (20_000, 64, 8, 16, "SQUARED_L2", False),
    (20_000, 64, 8, 17, "SQUARED_L2", False),
    (5_000, 32, 16, 10, "DOT_PRODUCT", False),
    (5_000, 32, 16, 10, "SQUARED_L2", True),
])
def test_fused_gate_matches_jax(monkeypatch, n, d, b, k, name, masked):
    """The port keeps the JAX package's batch-aware estimate and its 14 MB
    budget: the same workloads take the fused kernel (the JAX gate read as
    if on a TPU)."""
    import scann_tpu.types as jtypes

    monkeypatch.setattr(jtypes, "is_tpu", lambda: True)
    db = np.zeros((n, d), np.float32)
    jax_s, port = _searchers(db, name)
    mask = np.ones(n, bool) if masked else None
    assert port._use_fused(k, mask, b) == jax_s._use_fused_vmem(k, mask, b)
    assert fb.resident_limit_bytes() == 14 * 1024 * 1024


def test_fused_path_equals_composed_path(monkeypatch):
    """On the CPU the fused path's twin and the composed path give the same
    results; the gate picks the fused path at bench.py's B=100."""
    rng = np.random.default_rng(42)
    db = rng.random((10_000, 64), dtype=np.float32)
    q = rng.random((100, 64), dtype=np.float32)
    port = T.BruteForceSearcher(T.DenseDataset(db), device="cpu")
    assert port._use_fused(K, None, 100)
    calls = []
    real = pbf.fused_bf_search
    monkeypatch.setattr(pbf, "fused_bf_search",
                        lambda *a: calls.append(1) or real(*a))
    fused = port.search_batched_arrays(q, K)
    assert calls == [1]
    monkeypatch.setattr(port, "_use_fused", lambda *a: False)
    composed = port.search_batched_arrays(q, K)
    np.testing.assert_array_equal(fused[0], composed[0])
    np.testing.assert_array_equal(fused[1], composed[1])
    gt = np.argsort(((q[:, None] - db[None]) ** 2).sum(-1), axis=1)[:, :K]
    assert all(set(a) == set(g) for a, g in zip(fused[0], gt))
    assert fb.LAUNCHES == 0


@pytest.mark.parametrize("searcher", ["brute_force", "int8"])
def test_results_independent_of_query_chunking(data, monkeypatch, searcher):
    db, q = data
    if searcher == "brute_force":
        s = T.BruteForceSearcher(T.DenseDataset(db), T.DistanceMeasure.L2,
                                 device="cpu")
        n_cols = N
    else:
        s = T.ScalarQuantizedBruteForceSearcher(T.DenseDataset(db),
                                                device="cpu")
        n_cols = N
    whole = s.search_batched_arrays(q, K)
    monkeypatch.setattr(pbf, "QUERY_CHUNK_BYTES", 4 * n_cols * 5)
    assert pbf.query_chunk(n_cols) == 5
    chunked = s.search_batched_arrays(q, K)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])


def test_load_jax_saved_index(data, tmp_path):
    db, q = data
    jax_s = JaxBF(JaxDataset(db), jd.DistanceMeasure.COSINE)
    path = str(tmp_path / "bf.npz")
    save_index(path, jax_s)
    port = tio.load_index(path, device="cpu")
    assert isinstance(port, T.BruteForceSearcher)
    assert port.distance_measure == T.DistanceMeasure.COSINE
    want_i, want_d = jax_s.search_batched_arrays(q, K)
    got_i, got_d = port.search_batched_arrays(q, K)
    assert_results_match(got_i, got_d, want_i, want_d)


def test_default_device_without_a_card_raises(data, tmp_path):
    db, q = data
    s = T.BruteForceSearcher(T.DenseDataset(db))
    assert s.device.type == "cuda"
    path = str(tmp_path / "bf.npz")
    save_index(path, JaxBF(JaxDataset(db)))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.search_batched_arrays(q, K)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.load_index(path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.from_numpy_state(arrays, meta)

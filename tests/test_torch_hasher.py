"""The asymmetric hasher of the PyTorch port against the JAX package on the
CPU: a JAX-built index saved with ``save_index`` and served by the port,
each search path against the JAX pipeline function on the same state (the
Pallas kernels in interpret mode), epsilons, the dispatch rule, a port build
against a JAX build, and the port's options and defaults.

Tolerances:
  - the fused path selects on exact integers: ids equal for every query
    with no tie at the pre_k-th combined block minimum (the port selects
    lower index first, ``lax.approx_min_k`` on the CPU its own way); those
    with one are counted, at most 1%; distances within 1e-5 relative (the
    same float32 re-rank in another summation order);
  - the LUT16 score paths sum bf16 entries in another order than XLA and
    select among scores that tie often in bf16: ids equal for every query
    whose approximate scores agree bit for bit and hold no tie at the
    selection boundary; the other queries are counted, at most 1%;
  - builds draw other random bits (``torch.Generator`` against
    ``jax.random``): recall@10 within the margins stated in the test.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.hasher import (
    AsymmetricHasher as JaxHasher,
    AsymmetricHasherConfig as JaxConfig,
    ah_search_fused_kernel,
    ah_search_kernel,
    ah_search_reorder_kernel,
)
from scann_tpu.hashes.lut16 import pack_codes_4bit
from scann_tpu.io import save_index
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
import scann_tpu_torch as T
from scann_tpu_torch import io as tio
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes import hasher as ph
from scann_tpu_torch.ops import scoring_kernels as sk
from scann_tpu_torch.utils.benchmarking import recall_at_k

N, D, B, K, S = 2048, 16, 200, 10, 8
MEASURES = ["SQUARED_L2", "COSINE", "DOT_PRODUCT"]
# the fused sweep needs N_pad / 32 = 64 >= 2 * pre_k
FUSED_PRE_K, REORDER_PRE_K = 30, 100


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    return db, q


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """measure -> (JAX hasher, port hasher loaded from its saved file)."""
    db, _ = data
    out = {}
    for m in MEASURES:
        jax_h = JaxHasher(JaxConfig(
            num_codes=16, num_subspaces=S, seed=1, max_iterations=8,
            distance_measure=JaxMeasure[m])).build(JaxDataset(db))
        path = str(tmp_path_factory.mktemp("hashed") / f"{m}.npz")
        save_index(path, jax_h)
        out[m] = (jax_h, tio.load_index(path, device="cpu"))
    return out


def _jax_queries(q, measure):
    """The queries the JAX searcher hands its pipeline (cosine: unit)."""
    if measure == "COSINE":
        qn = np.sqrt(np.einsum("bd,bd->b", q, q))
        return q / np.maximum(qn, 1e-30)[:, None]
    return q


def _jax_state(jax_h):
    cent = jax_h.codebook.centroids_device()
    rows = jax_h._dataset.numpy()
    codes_t = np.zeros((S, 2048), np.uint8)                # JAX pads to 2048
    codes_t[:, :N] = jax_h.codes.T
    return cent, jnp.asarray(rows), jnp.asarray((rows ** 2).sum(1)), codes_t


def _boundary_tie(row: np.ndarray, width: int) -> bool:
    """Does the ``width``-th smallest value of ``row`` tie with a value left
    out of the smallest ``width``? Selection may then differ by tie order."""
    top = np.sort(row)[:width]
    return bool((row == top[-1]).sum() > (top == top[-1]).sum())


def _port_queries(port, q, measure):
    qt = torch.from_numpy(q)
    return ph._normalize(qt) if measure == "COSINE" else qt


def _explained_mismatches(port, q, got_ids, want_ids, width, measure,
                          fused=False, out_dtype=torch.float32):
    """Queries whose ids differ, each checked to have a reason: a tie at the
    ``width``-th selection score (the boundary; the port selects lower index
    first, ``lax.approx_min_k`` on the CPU its own way) or, for the LUT16
    score, approximate scores that differ from the JAX kernel's. Returns the
    count."""
    from scann_tpu.hashes.hasher import _ah_luts as jax_luts
    from scann_tpu.ops.pallas_kernels import lut16_score_pallas
    from scann_tpu_torch.hashes.lut import (
        luts_i8_evenfirst,
        quantize_luts_u8_device,
    )

    bad = np.flatnonzero((got_ids != want_ids).any(1))
    if len(bad) == 0:
        return 0
    luts = ph._ah_luts(_port_queries(port, q[bad], measure),
                       port.codebook.centroids, T.DistanceMeasure[measure])
    if fused:
        i8 = luts_i8_evenfirst(quantize_luts_u8_device(luts)[0])
        mine = sk.lut16_fused_sweep(i8, port._device_codes_packed_t(), N,
                                    r=port.FUSED_R).T.numpy()
        theirs = mine
    else:
        mine = sk.lut16_score(luts, port._device_codes_t(),
                              out_dtype).float().numpy()
        jl = jax_luts(jnp.asarray(_jax_queries(q[bad], measure)),
                      jnp.asarray(port.codebook.centroids.numpy()),
                      JaxMeasure[measure])
        codes_t = np.zeros((S, 2048), np.uint8)
        codes_t[:, :N] = port.codes.numpy().T
        theirs = np.asarray(lut16_score_pallas(
            jl, jnp.asarray(codes_t), interpret=True,
            out_dtype=getattr(jnp, str(out_dtype).split(".")[1])
        ).astype(jnp.float32))[:, :N]
    for i, row in enumerate(mine):
        assert _boundary_tie(row, width) or not np.array_equal(
            row, theirs[i]), (
            f"query {bad[i]}: ids differ with equal scores and no tie")
    return len(bad)


# -- state ------------------------------------------------------------------------


@pytest.mark.parametrize("measure", MEASURES)
def test_jax_saved_index_loads(indexes, measure):
    jax_h, port = indexes[measure]
    assert isinstance(port, T.AsymmetricHasher)
    assert port.config.distance_measure is T.DistanceMeasure[measure]
    np.testing.assert_array_equal(port.codes.numpy(), jax_h.codes)
    np.testing.assert_array_equal(port.codebook.centroids.numpy(),
                                  jax_h.codebook.centroids)
    assert (port.dataset_size(), port.dimensionality()) == (N, D)
    assert port.memory_usage() == jax_h.memory_usage()
    np.testing.assert_array_equal(port._dataset.numpy(),
                                  jax_h._dataset.numpy())
    jfields = {f.name for f in dataclasses.fields(JaxConfig)}
    assert {f.name for f in dataclasses.fields(T.AsymmetricHasherConfig)} \
        == jfields


def test_hash_config_reads_the_measure_as_enum():
    cfg = tio._hash_config({"num_codes": 16, "distance_measure": "Cosine",
                            "not_a_field": 1})
    assert cfg.distance_measure is T.DistanceMeasure.COSINE
    assert cfg.num_codes == 16


# -- each path against the JAX pipeline --------------------------------------------


@pytest.mark.parametrize("measure", MEASURES)
def test_fused_path_matches_jax(indexes, data, measure, monkeypatch):
    jax_h, port = indexes[measure]
    _, q = data
    calls = []
    monkeypatch.setattr(ph, "lut16_fused_sweep",
                        lambda *a, **kw: calls.append(1)
                        or sk.lut16_fused_sweep(*a, **kw))
    got_i, got_d = port.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=FUSED_PRE_K))
    assert calls, "the fused sweep was not taken"
    cent, rows, norms, _ = _jax_state(jax_h)
    packed = jnp.asarray(pack_codes_4bit(jax_h.codes).T)
    want_d, want_i = ah_search_fused_kernel(
        cent, packed, rows, norms, jnp.int32(N),
        jnp.asarray(_jax_queries(q, measure)), pre_k=FUSED_PRE_K, k=K,
        measure=JaxMeasure[measure], interpret=True)
    want_i = np.asarray(want_i)
    off = _explained_mismatches(port, q, got_i, want_i, FUSED_PRE_K, measure,
                                fused=True)
    assert off <= 0.01 * B, off
    same = (got_i == want_i).all(1)
    np.testing.assert_allclose(got_d[same], np.asarray(want_d)[same],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("measure", MEASURES)
def test_approximate_path_matches_jax(indexes, data, measure):
    jax_h, port = indexes[measure]
    _, q = data
    got_i, got_d = port.search_batched_arrays(q, K)
    cent, _, _, codes_t = _jax_state(jax_h)
    want_d, want_i = ah_search_kernel(
        cent, jnp.asarray(codes_t), jnp.int32(N),
        jnp.asarray(_jax_queries(q, measure)), k=K, codes_transposed=True,
        measure=JaxMeasure[measure])
    want_i = np.asarray(want_i)
    off = _explained_mismatches(port, q, got_i, want_i, K, measure)
    assert off <= 0.01 * B, off
    same = (got_i == want_i).all(1)
    np.testing.assert_allclose(got_d[same], np.asarray(want_d)[same],
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("measure", MEASURES)
def test_reorder_path_matches_jax(indexes, data, measure, monkeypatch):
    jax_h, port = indexes[measure]
    _, q = data
    dtypes = []
    monkeypatch.setattr(ph, "lut16_score",
                        lambda *a, **kw: dtypes.append(kw.get("out_dtype"))
                        or sk.lut16_score(*a, **kw))
    got_i, got_d = port.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=REORDER_PRE_K))
    assert dtypes == [torch.bfloat16]
    cent, rows, norms, codes_t = _jax_state(jax_h)
    want_d, want_i = ah_search_reorder_kernel(
        cent, jnp.asarray(codes_t), rows, norms, jnp.int32(N),
        jnp.asarray(_jax_queries(q, measure)), pre_k=REORDER_PRE_K, k=K,
        measure=JaxMeasure[measure], codes_transposed=True)
    want_i = np.asarray(want_i)
    off = _explained_mismatches(port, q, got_i, want_i, REORDER_PRE_K,
                                measure, out_dtype=torch.bfloat16)
    assert off <= 0.01 * B, off
    same = (got_i == want_i).all(1)
    np.testing.assert_allclose(got_d[same], np.asarray(want_d)[same],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rdt", ["bfloat16", "int8"])
def test_low_precision_rerank_matches_jax(indexes, data, rdt):
    """The re-rank store in bfloat16 or the per-dimension int8 codec:
    re-ranking every row (pre_k = N) over the store gives the JAX
    searcher's ids exactly and its distances to float32 rounding; the
    fused path re-ranks its candidates from the same store."""
    jax_h, _ = indexes["SQUARED_L2"]
    db, q = data
    jax_s = JaxHasher(dataclasses.replace(
        jax_h.config, rerank_dtype=rdt)).build(JaxDataset(db))
    port = T.AsymmetricHasher(T.AsymmetricHasherConfig(
        num_codes=16, num_subspaces=S, seed=1, max_iterations=8,
        rerank_dtype=rdt), device="cpu").build(T.DenseDataset(db))
    want_i, want_d = jax_s.search_batched_arrays(q, K, JaxParams(
        pre_reordering_num_neighbors=N))
    got_i, got_d = port.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=N))
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    assert np.abs(got_d - ((q[:, None] - db[got_i]) ** 2).sum(-1)).max() > 0
    fused_i, fused_d = port.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=FUSED_PRE_K))
    store = port._rerank_state()
    rows = ph.gather_rerank_rows(store, torch.from_numpy(fused_i).long())
    np.testing.assert_allclose(
        fused_d, ((torch.from_numpy(q)[:, None] - rows) ** 2).sum(-1).numpy(),
        rtol=1e-4, atol=1e-4)


# -- epsilons -------------------------------------------------------------------------


def test_fused_path_epsilons_match_jax(indexes, data):
    jax_h, port = indexes["SQUARED_L2"]
    _, q = data
    base_i, base_d = port.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=FUSED_PRE_K))
    post = float(np.median(base_d[:, K // 2]))
    pre = float(np.median(base_d[:, K - 1])) * 1.2
    got_i, got_d = port.search_batched_arrays(q, K, T.SearchParameters(
        pre_reordering_num_neighbors=FUSED_PRE_K, pre_reordering_epsilon=pre,
        post_reordering_epsilon=post))
    assert np.all((got_d <= post) | np.isinf(got_d))
    assert np.all((got_i >= 0) == np.isfinite(got_d))
    assert np.isinf(got_d).any() and np.isfinite(got_d).any()
    cent, rows, norms, _ = _jax_state(jax_h)
    packed = jnp.asarray(pack_codes_4bit(jax_h.codes).T)
    want_d, want_i = ah_search_fused_kernel(
        cent, packed, rows, norms, jnp.int32(N), jnp.asarray(q),
        jnp.float32(pre), jnp.float32(post), pre_k=FUSED_PRE_K, k=K,
        measure=JaxMeasure.SQUARED_L2, interpret=True)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("which", ["pre", "post", "both"])
def test_approximate_path_applies_the_tighter_epsilon(indexes, data, which):
    """No re-rank: the search is both stages, so min(pre, post) masks the
    approximate results (on the device, before any host copy)."""
    _, port = indexes["SQUARED_L2"]
    _, q = data
    base_i, base_d = port.search_batched_arrays(q, K)
    lo = float(np.median(base_d[:, 3]))
    hi = float(np.median(base_d[:, 7]))
    params = T.SearchParameters(
        pre_reordering_epsilon={"pre": lo, "post": None, "both": hi}[which],
        post_reordering_epsilon={"pre": None, "post": lo, "both": lo}[which])
    assert params.effective_epsilon() == lo
    got_i, got_d = port.search_batched_arrays(q, K, params)
    over = base_d > lo
    np.testing.assert_array_equal(got_i, np.where(over, -1, base_i))
    np.testing.assert_array_equal(got_d, np.where(over, np.inf, base_d))
    assert over.any() and (~over).any()
    assert T.SearchParameters().effective_epsilon() == float("inf")


# -- dispatch ----------------------------------------------------------------------------


def _spy(monkeypatch):
    """Records which scorer each search reaches."""
    seen = []
    for name, tag in (("lut16_fused_sweep", "fused"), ("lut16_score", None),
                      ("lut_score", "lut_score")):
        orig = getattr(ph, name)

        def wrap(*a, _orig=orig, _tag=tag, **kw):
            seen.append(_tag or f"lut16_score/{kw.get('out_dtype', 'f32')}")
            return _orig(*a, **kw)
        monkeypatch.setattr(ph, name, wrap)
    return seen


@pytest.mark.parametrize("c,pre_k,want", [
    (16, None, "lut16_score/f32"),
    (16, FUSED_PRE_K, "fused"),
    (16, 33, f"lut16_score/{torch.bfloat16}"),    # 64 blocks < 2 * 33
    (256, None, "lut_score"),
    (256, FUSED_PRE_K, "lut_score"),
])
def test_dispatch_rule(data, monkeypatch, c, pre_k, want):
    db, q = data
    h = T.AsymmetricHasher(T.AsymmetricHasherConfig(
        num_codes=c, num_subspaces=4, seed=0, max_iterations=3),
        device="cpu").build(T.DenseDataset(db))
    assert h._use_kernels() == (c <= 16)
    seen = _spy(monkeypatch)
    params = T.SearchParameters(pre_reordering_num_neighbors=pre_k)
    h.search_batched_arrays(q[:8], K, params)
    assert seen == [want]


def test_large_code_count_matches_jax_lut_score(data):
    """C=256 serves through lut_score (float32 gather) on both sides."""
    db, q = data
    jax_h = JaxHasher(JaxConfig(num_codes=256, num_subspaces=4, seed=0,
                                max_iterations=3)).build(JaxDataset(db))
    arrays = {"codes": jax_h.codes, "codebook": jax_h.codebook.centroids,
              "data": jax_h._dataset.numpy()}
    meta = {"kind": "hashed", "dim": D,
            "config": {"num_codes": 256, "num_subspaces": 4}}
    port = tio.from_numpy_state(arrays, meta, device="cpu")
    want_i, want_d = jax_h.search_batched_arrays(q, K)
    got_i, got_d = port.search_batched_arrays(q, K)
    assert (got_i == want_i).all(1).mean() >= 0.99
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)


# -- build ----------------------------------------------------------------------------


def test_build_recall_close_to_jax_build():
    """Both packages build from the same data and the same training sample
    (numpy draws it in both); the codebooks differ with the k-means bits.
    recall@10 against exact ground truth on the paths both take on the CPU
    (the JAX package never takes its fused sweep there): within 0.05
    approximate-only, within 0.02 re-ranked from pre_k=100 (the port's
    non-fused path: 128 blocks < 2 * 100)."""
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(24, 32)).astype(np.float32) * 3.0
    x = (centers[rng.integers(0, 24, 4000)]
         + rng.normal(size=(4000, 32))).astype(np.float32)
    q = (x[rng.choice(4000, 200, replace=False)]
         + 0.5 * rng.normal(size=(200, 32))).astype(np.float32)
    gt = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :K]
    cfg = dict(num_codes=16, num_subspaces=16, seed=3, max_iterations=10,
               training_sample_size=2000)
    jax_h = JaxHasher(JaxConfig(**cfg)).build(JaxDataset(x))
    port = T.AsymmetricHasher(T.AsymmetricHasherConfig(**cfg),
                              device="cpu").build(T.DenseDataset(x))
    assert port.codes.dtype == torch.uint8 and port.codes.shape == (4000, 16)
    assert port.memory_usage() == jax_h.memory_usage() == 4000 * 8
    from scann_tpu.models.searcher import SearchParameters as JaxParams

    for pre_k, margin, floor in ((None, 0.05, 0.3), (100, 0.02, 0.95)):
        got = recall_at_k(port.search_batched_arrays(q, K, T.SearchParameters(
            pre_reordering_num_neighbors=pre_k))[0], gt)
        want = recall_at_k(jax_h.search_batched_arrays(q, K, JaxParams(
            pre_reordering_num_neighbors=pre_k))[0], gt)
        assert abs(got - want) <= margin, (pre_k, got, want)
        assert got >= floor, (pre_k, got)


# -- API, options, devices ------------------------------------------------------------


def test_no_kernel_launches_on_cpu(indexes, data):
    _, port = indexes["SQUARED_L2"]
    _, q = data
    before = dict(sk.LAUNCHES)
    for pre_k in (None, FUSED_PRE_K, REORDER_PRE_K):
        port.search_batched_arrays(q[:16], K, T.SearchParameters(
            pre_reordering_num_neighbors=pre_k))
    assert sk.LAUNCHES == before


def test_tensor_search_and_reordering_agree(indexes, data):
    _, port = indexes["COSINE"]
    _, q = data
    params = T.SearchParameters(pre_reordering_num_neighbors=FUSED_PRE_K)
    ids, dists = port.search_batched_tensors(torch.from_numpy(q), K, params)
    assert ids.dtype == torch.int64 and dists.dtype == torch.float32
    arr_i, arr_d = port.search_batched_arrays(q, K, params)
    np.testing.assert_array_equal(ids.numpy(), arr_i)
    one_i, one_d = port.search_with_reordering(q[3], K, FUSED_PRE_K)
    np.testing.assert_array_equal(one_i, arr_i[3])
    np.testing.assert_array_equal(one_d, arr_d[3])
    single_i, _ = port.search_batched_tensors(torch.from_numpy(q[3]), K,
                                              params)
    np.testing.assert_array_equal(single_i.numpy()[0], arr_i[3])


def test_options_raise():
    with pytest.raises(ScannError):
        T.AsymmetricHasher(T.AsymmetricHasherConfig(rerank_dtype="float16"),
                           device="cpu")
    x = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    with pytest.raises(ScannError):
        T.AsymmetricHasher(T.AsymmetricHasherConfig(
            distance_measure=T.DistanceMeasure.L1),
            device="cpu").build(T.DenseDataset(x))
    with pytest.raises(ScannError):
        T.AsymmetricHasher(device="cpu").search_batched_arrays(x[:2], 3)


def test_anisotropic_build_serves():
    """``anisotropic_threshold`` trains and encodes the codebook by the
    score-aware loss (``hashes/avq.py``; parity in ``test_torch_avq.py``):
    the codebook carries eta, the codes are its anisotropic encoding, and
    the build serves the re-rank path."""
    x = np.random.default_rng(0).normal(size=(300, 32)).astype(np.float32)
    h = T.AsymmetricHasher(T.AsymmetricHasherConfig(
        num_codes=16, num_subspaces=8, anisotropic_threshold=0.2,
        max_iterations=5, distance_measure=T.DistanceMeasure.DOT_PRODUCT),
        device="cpu").build(T.DenseDataset(x))
    assert h.codebook.eta == pytest.approx(31 * 0.04 / 0.96)
    np.testing.assert_array_equal(
        h.codes.numpy(),
        h.codebook.encode_dataset(torch.from_numpy(x)).numpy())
    idx, dists = h.search_batched_arrays(x[:4], 5, T.SearchParameters(
        pre_reordering_num_neighbors=300))
    want = np.argsort(-(x[:4] @ x.T), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(dists, -np.take_along_axis(
        x[:4] @ x.T, want, axis=1), rtol=1e-5, atol=1e-5)


def test_unstored_dataset_serves_approximate_only():
    x = np.random.default_rng(1).normal(size=(500, 8)).astype(np.float32)
    h = T.AsymmetricHasher(T.AsymmetricHasherConfig(
        num_codes=16, num_subspaces=4, max_iterations=3, store_dataset=False),
        device="cpu").build(T.DenseDataset(x))
    idx, _ = h.search_batched_arrays(x[:4], 5)
    assert idx.shape == (4, 5) and (idx >= 0).all()
    with pytest.raises(ScannError, match="not stored"):
        h.search_batched_arrays(x[:4], 5, T.SearchParameters(
            pre_reordering_num_neighbors=20))


def test_default_device_is_the_card():
    """Without a card a default-constructed hasher raises at build instead
    of running on the CPU."""
    h = T.AsymmetricHasher(T.AsymmetricHasherConfig(num_codes=16,
                                                    num_subspaces=4))
    assert h.device.type == "cuda"
    if torch.cuda.is_available():
        return
    x = np.zeros((64, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        h.build(T.DenseDataset(x))

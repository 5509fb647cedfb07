"""The block-min sweep of the PyTorch port (``scann_tpu_torch/ops/sweep.py``)
against the JAX package's ``ops/sweep_pallas.py``: the host builders bit
for bit, the plain twins of the four Pallas kernels against those kernels
in interpret mode (as tests/test_block_sweep.py runs them, at its shapes),
the tournament's tie order, the dispatch rule and the whole pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops import sweep_pallas as jsw
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu_torch.ops import sweep as sw
from scann_tpu_torch.ops.distances import DistanceMeasure

MEASURES = ["SQUARED_L2", "DOT_PRODUCT", "COSINE", "GENERAL_INNER_PRODUCT"]


def _bits(x) -> np.ndarray:
    """bf16 bit patterns of a port tensor or a JAX/ml_dtypes array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("measure", MEASURES[:3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_build_augmented_db_bit_identical(measure, shuffle):
    rng = np.random.default_rng(1)
    db = (rng.normal(size=(900, 20)) * 3).astype(np.float32)
    n_valid = 850
    stride = sw.shuffle_stride_for(n_valid) if shuffle else 0
    kw = dict(tile_n=256, shuffle_stride=stride)
    got = sw.build_augmented_db(db, n_valid, DistanceMeasure[measure], **kw)
    want = jsw.build_augmented_db(db, n_valid, JaxMeasure[measure], **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("measure", MEASURES[:3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_build_int8_augmented_db_bit_identical(measure, shuffle):
    rng = np.random.default_rng(2)
    db = (rng.normal(size=(700, 13)) * 5).astype(np.float32)
    n_valid = 690
    stride = sw.shuffle_stride_for(n_valid) if shuffle else 0
    kw = dict(tile_n=128, shuffle_stride=stride)
    codes, scales, sn = sw.build_int8_augmented_db(
        db, n_valid, DistanceMeasure[measure], **kw)
    w_codes, w_scales, w_sn = jsw.build_int8_augmented_db(
        db, n_valid, JaxMeasure[measure], **kw)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), w_codes)
    np.testing.assert_array_equal(scales.numpy(), w_scales)
    assert sn == w_sn
    assert sw.int8_mask_cut(sn) == jsw.int8_mask_cut(w_sn)


def test_shuffle_stride_and_digits_match_jax():
    for n in (1, 2, 7, 1000, 4096, 1_183_514):
        assert sw.shuffle_stride_for(n) == jsw.shuffle_stride_for(n)
    m = np.concatenate([np.arange(0, 3000),
                        [sw.INT8_NORM_DIGIT_MAX, 400_000, 123_457]])
    for got, want in zip(sw._encode_norm_digits(m),
                         jsw._encode_norm_digits(m)):
        np.testing.assert_array_equal(got, want)
    assert sw.augmented_dim(100) == jsw.augmented_dim(100) == 104
    for n, b, r in ((8192, 1024, 32), (8192 + 2048, 1024, 32),
                    (2 ** 20, 8192, 64), (1_187_840, 1024, 64),
                    (1_196_032, 1024, 128), (1_245_184, 128, 512)):
        assert sw.qmajor_supported(n, b, r) == jsw.qmajor_supported(n, b, r)


@pytest.mark.parametrize("measure", MEASURES)
def test_augmented_queries_bit_identical(measure):
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(9, 20)) * 2).astype(np.float32)
    got = sw._augment_queries(torch.from_numpy(q), DistanceMeasure[measure],
                              24)
    want = jsw._augment_queries(jnp.asarray(q), JaxMeasure[measure], 24)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    scales = (rng.random(20) + 0.1).astype(np.float32)
    got = sw._augment_queries_int8(torch.from_numpy(q),
                                   DistanceMeasure[measure],
                                   torch.from_numpy(scales), 4.0, 24)
    want = jsw._augment_queries_int8(jnp.asarray(q), JaxMeasure[measure],
                                     jnp.asarray(scales), 4.0, 24)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_allow_penalty_bit_identical():
    rng = np.random.default_rng(4)
    mask = rng.random(1000) < 0.3
    inv = rng.permutation(1000)
    for kw in (dict(), dict(inv_perm=inv), dict(mask_value=1234.5)):
        got = sw.build_allow_penalty(mask, 1024, 8, **kw)
        want = jsw.build_allow_penalty(mask, 1024, 8, **kw)
        assert tuple(got.shape) == (128, 8)
        np.testing.assert_array_equal(_bits(got), _bits(want))


# -- the twins against the Pallas kernels in interpret mode ------------------

def _inputs(seed, *, n, d, b, r, tile_n, n_valid, int8_rows, penalty):
    """The same augmented rows, queries and penalty for both packages."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    measure = DistanceMeasure.SQUARED_L2
    if int8_rows:
        aug, scales, sn = sw.build_int8_augmented_db(db, n_valid, measure,
                                                     tile_n=tile_n)
        q_aug = sw._augment_queries_int8(torch.from_numpy(q), measure,
                                         scales, sn, aug.shape[1])
        mask_value = 4.0 * sw.INT8_NORM_DIGIT_MAX * sn
    else:
        aug = sw.build_augmented_db(db, n_valid, measure, tile_n=tile_n)
        q_aug = sw._augment_queries(torch.from_numpy(q), measure,
                                    aug.shape[1])
        mask_value = 4 * sw.BLOCK_MASK_VALUE
    pen = None
    if penalty:
        pen = sw.build_allow_penalty(rng.random(n_valid) < 0.2, aug.shape[0],
                                     r, mask_value=mask_value)

    def jax_of(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    return (q_aug, aug, pen), (jax_of(q_aug), jax_of(aug), jax_of(pen))


def _scores(q_aug, aug, pen, r):
    """[N/r, r, B] float64 scores, the reference both are held to."""
    s = aug.double().numpy() @ q_aug.double().numpy().T
    if pen is not None:
        s = s + pen.double().numpy().reshape(-1)[:, None]
    return s.reshape(-1, r, s.shape[1])


def _assert_minima(vals, locs, want_vals, s3, *, tol=1e-5):
    """Values within float32 summation-order error of the float64 minima;
    offsets compared by the score they achieve (rounding may pick either of
    two near-equal rows)."""
    np.testing.assert_allclose(vals, want_vals, rtol=tol, atol=tol)
    pick = np.take_along_axis(s3, locs[:, None, :].astype(np.int64),
                              axis=1)[:, 0]
    np.testing.assert_allclose(pick, want_vals, rtol=tol, atol=tol)


ROWMAJOR = dict(n=1024, d=24, b=16, r=8, tile_n=256, n_valid=924)
TOP2 = dict(n=512, d=16, b=16, r=8, tile_n=128, n_valid=512)


@pytest.mark.parametrize("int8_rows,penalty", [(False, False), (False, True),
                                               (True, False), (True, True)])
def test_block_min_twin_matches_pallas(int8_rows, penalty):
    (q_aug, aug, pen), (jq, ja, jp) = _inputs(
        0, int8_rows=int8_rows, penalty=penalty, **ROWMAJOR)
    r = ROWMAJOR["r"]
    vals, locs = sw.block_min_sweep(q_aug, aug, r=r, penalty=pen)
    jv, jl = jsw.block_min_sweep_pallas(jq, ja, tile_n=ROWMAJOR["tile_n"],
                                        r=r, interpret=True, penalty=jp)
    assert vals.dtype == torch.float32 and locs.dtype == torch.int32
    s3 = _scores(q_aug, aug, pen, r)
    _assert_minima(vals.numpy(), locs.numpy(), s3.min(axis=1), s3)
    _assert_minima(np.asarray(jv), np.asarray(jl), s3.min(axis=1), s3)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("int8_rows,penalty", [(False, False), (True, True)])
def test_block_min2_twin_matches_pallas(int8_rows, penalty):
    (q_aug, aug, pen), (jq, ja, jp) = _inputs(
        1, int8_rows=int8_rows, penalty=penalty, **TOP2)
    r = TOP2["r"]
    got = [t.numpy() for t in sw.block_min2_sweep(q_aug, aug, r=r,
                                                  penalty=pen)]
    want = [np.asarray(t) for t in jsw.block_min2_sweep_pallas(
        jq, ja, tile_n=TOP2["tile_n"], r=r, interpret=True, penalty=jp)]
    s3 = _scores(q_aug, aug, pen, r)
    srt = np.sort(s3, axis=1)
    for v1, l1, v2, l2 in (got, want):
        _assert_minima(v1, l1, srt[:, 0], s3)
        _assert_minima(v2, l2, srt[:, 1], s3)
        assert np.all(l1 != l2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,int8_rows,penalty", [
    (dict(n=8192, d=48, b=8, r=32, tile_n=4096, n_valid=8192), False, False),
    (dict(n=8192, d=48, b=8, r=32, tile_n=4096, n_valid=8192), True, False),
    (dict(n=2048, d=24, b=8, r=8, tile_n=1024, n_valid=2048), False, True),
    (dict(n=2048, d=24, b=8, r=8, tile_n=1024, n_valid=2048), True, True),
])
def test_block_min_qmajor_twins_match_pallas(shape, int8_rows, penalty):
    """The q-major forms, float32 and compact, at the only batch shapes
    whose interpret mode runs (sweep_pallas.py:582-585). Compact values are
    the float32 minima rounded to nearest even: within 1 bf16 ulp of the
    Pallas kernel's, offsets equal where the float32 ones are."""
    (q_aug, aug, pen), (jq, ja, jp) = _inputs(
        2, int8_rows=int8_rows, penalty=penalty, **shape)
    r = shape["r"]
    assert sw.qmajor_supported(shape["n"], shape["b"], r)
    vals, locs = sw.block_min_sweep_qmajor(q_aug, aug, r=r, penalty=pen)
    jv, jl = jsw.block_min_sweep_qmajor_pallas(jq, ja, r=r, interpret=True,
                                               penalty=jp)
    assert tuple(vals.shape) == (shape["b"], shape["n"] // r)
    s3 = _scores(q_aug, aug, pen, r)
    _assert_minima(vals.numpy().T, locs.numpy().T, s3.min(axis=1), s3)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    cv, cl = sw.block_min_sweep_qmajor(q_aug, aug, r=r, penalty=pen,
                                       compact=True)
    jcv, jcl = jsw.block_min_sweep_qmajor_pallas(
        jq, ja, r=r, interpret=True, compact=True, penalty=jp)
    assert cv.dtype == torch.bfloat16 and cl.dtype == torch.uint8
    jax_compact = torch.from_numpy(np.array(jcv).view(np.int16)).view(
        torch.bfloat16)
    ulp = np.abs(sw._bf16_order(cv).numpy() -
                 sw._bf16_order(jax_compact).numpy())
    assert ulp.max() <= 1
    np.testing.assert_array_equal(cl.numpy().astype(np.int32), locs.numpy())
    _assert_minima(vals.numpy().T, np.asarray(jcl).T.astype(np.int32),
                   s3.min(axis=1), s3)


def test_ties_follow_the_jax_order():
    """Exact ties (all scores exact in bf16 and float32): top-1 takes the
    lowest offset (jnp.argmin), the tournament's second follows its own
    pairing — for [1, 1, 5, 1] offset 3, where a sort would say 1."""
    d1, r = 8, 4
    col = np.array([1, 1, 5, 1, 2, 2, 2, 2, 7, 3, 3, 9, 4, 0, 0, 4],
                   np.float32)
    db = np.zeros((len(col), d1), np.float32)
    db[:, 0] = col
    q = np.zeros((2, d1), np.float32)
    q[0, 0], q[1, 0] = 1.0, 2.0
    aug = torch.from_numpy(db).to(torch.bfloat16)
    q_aug = torch.from_numpy(q).to(torch.bfloat16)
    ja = jnp.asarray(db).astype(jnp.bfloat16)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    got = [t.numpy() for t in sw.block_min2_sweep(q_aug, aug, r=r)]
    want = [np.asarray(t) for t in jsw.block_min2_sweep_pallas(
        jq, ja, tile_n=len(col), r=r, interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][0, 0] == 0 and got[3][0, 0] == 3
    vals, locs = sw.block_min_sweep(q_aug, aug, r=r)
    jv, jl = jsw.block_min_sweep_pallas(jq, ja, tile_n=len(col), r=r,
                                        interpret=True)
    np.testing.assert_array_equal(locs.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# -- dispatch and pipeline ----------------------------------------------------

@pytest.mark.parametrize("n,b,r,top2,want", [
    (1_187_840, 1024, 64, False, ("qmajor", True)),
    (1_196_032, 1024, 128, False, ("rowmajor", None)),
    (1_245_184, 128, 512, False, ("qmajor", False)),
    (1_187_840, 512, 64, True, ("top2", None)),
    (8192 + 2048, 1024, 32, False, ("rowmajor", None)),
])
def test_dispatch_rule_on_the_card(monkeypatch, n, b, r, top2, want):
    """The JAX package's rule on a non-CPU device (meta tensors stand in for
    the card): top2 -> tournament; q-major where qmajor_supported, compact
    for r <= 256; else row-major. The 1024-query batch at r=128 overflows
    the VMEM cap and takes the row-major form."""
    calls = []
    monkeypatch.setattr(sw, "block_min_sweep",
                        lambda *a, **k: calls.append(("rowmajor", None)))
    monkeypatch.setattr(sw, "block_min2_sweep",
                        lambda *a, **k: calls.append(("top2", None)))
    monkeypatch.setattr(sw, "block_min_sweep_qmajor",
                        lambda *a, compact, **k: calls.append(
                            ("qmajor", compact)))
    q_aug = torch.empty(b, 104, dtype=torch.bfloat16, device="meta")
    aug = torch.empty(n, 104, dtype=torch.bfloat16, device="meta")
    form, _ = sw.block_minima(q_aug, aug, r=r, top2=top2)
    assert calls == [want] and form == want[0]


def test_cpu_takes_the_twins_and_counts_no_launch():
    sw.reset_launches()
    (q_aug, aug, _), _ = _inputs(5, int8_rows=False, penalty=False,
                                 n=1024, d=16, b=8, r=64, tile_n=1024,
                                 n_valid=1000)
    form, _ = sw.block_minima(q_aug, aug, r=64)
    assert form == "rowmajor"       # the JAX package's interpret branch
    sw.block_min_sweep_qmajor(q_aug, aug, r=64, compact=True)
    sw.block_min2_sweep(q_aug, aug, r=64)
    assert all(v == 0 for v in sw.LAUNCHES.values())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sw.block_min_sweep(q_aug.to("meta"), aug.to("meta"), r=64)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("top2", [False, True])
def test_sweep_search_matches_jax_kernel(measure, top2):
    """The whole pipeline against ``sweep_search_kernel`` (interpret mode):
    ids equal, distances to float32 summation order (rtol 1e-5)."""
    rng = np.random.default_rng(6)
    n, d, b, r = 2048, 16, 12, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    stride = sw.shuffle_stride_for(n)
    pos = (np.arange(n) * stride) % n
    inv = np.empty(n, np.int64)
    inv[pos] = np.arange(n)
    aug = sw.build_augmented_db(db, n, DistanceMeasure[measure], tile_n=256,
                                shuffle_stride=stride)
    dists, idx = sw.sweep_search(
        aug, torch.from_numpy(db[inv]), torch.from_numpy(q),
        inv_perm=torch.from_numpy(inv), pre_k=64, k=10,
        measure=DistanceMeasure[measure], r=r, top2=top2)
    ja = jnp.asarray(jsw.build_augmented_db(db, n, JaxMeasure[measure],
                                            tile_n=256,
                                            shuffle_stride=stride))
    jd, ji = jsw.sweep_search_kernel(
        ja, jnp.asarray(db[inv]), None, jnp.int32(n), jnp.asarray(q),
        inv_perm=jnp.asarray(inv.astype(np.int32)), pre_k=64, k=10,
        measure=JaxMeasure[measure], r=r, tile_n=256, interpret=True,
        top2=top2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(dists.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)

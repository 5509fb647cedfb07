"""Helpers of the PyTorch port against the JAX package on the CPU: the
Gaussian mixture, the stacked and additive quantizers, the host bit and
sampling utilities, and the prelude's and ``hashes``' exports.

Tolerances: a GMM fitted from the same host start agrees in weights,
means, covariances and log-likelihood to 1e-3 relative (float32 sums in
another order); a carried GMM predicts equal components away from
near-ties and samples bit for bit (both draw on the host from
``np.random.default_rng``). Quantizers with carried codebooks give equal
codes and decode to 1e-6; trained on each side, their reconstruction
errors agree within 10% (the port's k-means draws from a
``torch.Generator``, so its centroids differ).
"""

import numpy as np
import pytest
import torch

import scann_tpu.hashes as jax_hashes
import scann_tpu.prelude as jax_prelude
import scann_tpu.utils.bits as jbits
import scann_tpu.utils.random as jrandom
import scann_tpu_torch.hashes as torch_hashes
import scann_tpu_torch.prelude as torch_prelude
import scann_tpu_torch.utils.bits as tbits
import scann_tpu_torch.utils.random as trandom
from scann_tpu.errors import ScannError as JaxError
from scann_tpu.hashes.stacked import AdditiveQuantizer as JaxAdditive
from scann_tpu.hashes.stacked import StackedQuantizer as JaxStacked
from scann_tpu.hashes.stacked import StackedQuantizerConfig as JaxStackedCfg
from scann_tpu.utils import gmm as jgmm
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.stacked import (
    AdditiveQuantizer,
    StackedQuantizer,
    StackedQuantizerConfig,
)
from scann_tpu_torch.utils import gmm as tgmm
from torch_threads import one_torch_thread  # noqa: F401

GMM_RTOL = 1e-3
COV_TYPES = ["FULL", "DIAGONAL", "SPHERICAL"]


def _blobs(n=240, d=4, k=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 4.0
    x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)) * \
        np.linspace(0.5, 1.5, d)
    return x.astype(np.float32)


def _same_error(port_call, jax_call):
    with pytest.raises(JaxError) as want:
        jax_call()
    with pytest.raises(ScannError) as got:
        port_call()
    assert got.value.code.value == want.value.code.value


def _gmm_pair(cov, **kw):
    cfg = {**dict(num_components=3, max_iterations=60, seed=7), **kw}
    j = jgmm.GaussianMixture(jgmm.GmmConfig(
        covariance_type=jgmm.CovarianceType[cov], **cfg))
    t = tgmm.GaussianMixture(tgmm.GmmConfig(
        covariance_type=tgmm.CovarianceType[cov], **cfg), device="cpu")
    return j, t


@pytest.mark.parametrize("cov", COV_TYPES)
def test_gmm_fit_matches_jax(cov):
    x = _blobs()
    j, t = _gmm_pair(cov)
    j.fit(x)
    t.fit(x)
    for got, want in ((t.weights, j.weights), (t.means, j.means),
                      (t.covariances, j.covariances)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=GMM_RTOL,
                                   atol=GMM_RTOL * np.abs(want).max())
    assert t._log_likelihood == pytest.approx(j._log_likelihood,
                                              rel=GMM_RTOL)
    assert t.converged == j.converged
    assert abs(t.num_iterations - j.num_iterations) <= 1
    assert t.score(x) == pytest.approx(j.score(x), rel=GMM_RTOL)
    assert t.bic(x) == pytest.approx(j.bic(x), rel=GMM_RTOL)
    assert t.aic(x) == pytest.approx(j.aic(x), rel=GMM_RTOL)


@pytest.mark.parametrize("cov", COV_TYPES)
def test_carried_gmm_infers_and_samples_like_jax(cov):
    x = _blobs()
    j, _ = _gmm_pair(cov)
    j.fit(x)
    t = tgmm.GaussianMixture.from_numpy(j.weights, j.means, j.covariances,
                                        device="cpu")
    assert t.config.covariance_type.name == cov
    q = _blobs(60, seed=3)
    proba_j = j.predict_proba(q)
    proba_t = t.predict_proba(q).numpy()
    np.testing.assert_allclose(proba_t, proba_j, atol=1e-5)
    top2 = np.sort(proba_j, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    pred = t.predict(q)
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy()[clear], j.predict(q)[clear])
    assert t.score(q) == pytest.approx(j.score(q), rel=1e-5)
    assert t.bic(q) == pytest.approx(j.bic(q), rel=1e-5)
    assert t.aic(q) == pytest.approx(j.aic(q), rel=1e-5)
    for seed in (0, 11):
        got = t.sample(50, seed=seed)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), j.sample(50, seed=seed))


def test_gmm_errors_match_jax():
    x = _blobs(20)
    j, t = _gmm_pair("DIAGONAL")
    _same_error(lambda: t.predict(x), lambda: j.predict(x))
    _same_error(lambda: t.sample(3), lambda: j.sample(3))
    _same_error(lambda: t.fit(x[:2]), lambda: j.fit(x[:2]))
    bad = x.copy()
    bad[0, 0] = np.nan            # never finite, whatever the regularizer
    j, t = _gmm_pair("FULL", max_iterations=3)
    _same_error(lambda: t.fit(bad), lambda: j.fit(bad))


def _residual_data(n=300, d=8, seed=0):
    return _blobs(n, d, k=6, seed=seed)


@pytest.mark.parametrize("kind", ["stacked", "additive"])
def test_carried_quantizer_codes_match_jax(kind):
    x = _residual_data()
    if kind == "stacked":
        j = JaxStacked(JaxStackedCfg(num_levels=3, num_codes=8,
                                     num_subspaces=4, max_iterations=8,
                                     seed=1)).train(x)
    else:
        j = JaxAdditive(num_levels=3, num_codes=16, max_iterations=8,
                        seed=1).train(x)
    t = StackedQuantizer.from_numpy(
        [np.asarray(cb.centroids) for cb in j.levels], device="cpu")
    assert t.is_trained and t.dimensionality == j.dimensionality
    codes = t.encode(x)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), j.encode(x))
    np.testing.assert_array_equal(t.encode(x[5]).numpy(), j.encode(x[5]))
    want = j.decode(j.encode(x))
    np.testing.assert_allclose(t.decode(codes).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(t.decode(codes[5]).numpy(), want[5],
                               atol=1e-6)
    assert t.reconstruction_error(x) == pytest.approx(
        j.reconstruction_error(x), rel=1e-5)


@pytest.mark.parametrize("kind", ["stacked", "additive"])
def test_trained_quantizer_error_near_jax(kind):
    x = _residual_data(400)
    if kind == "stacked":
        cfg = dict(num_levels=2, num_codes=8, num_subspaces=4,
                   max_iterations=10, seed=0)
        j = JaxStacked(JaxStackedCfg(**cfg)).train(x)
        t = StackedQuantizer(StackedQuantizerConfig(**cfg),
                             device="cpu").train(x)
    else:
        j = JaxAdditive(num_levels=2, num_codes=16, max_iterations=10,
                        seed=0).train(x)
        t = AdditiveQuantizer(num_levels=2, num_codes=16, max_iterations=10,
                              seed=0, device="cpu").train(x)
    assert [cb.config.seed for cb in t.levels] == [0, 1000]
    got, want = t.reconstruction_error(x), j.reconstruction_error(x)
    assert abs(got - want) <= 0.1 * want
    # each level lowers the error
    one = StackedQuantizer.from_numpy([t.levels[0].centroids.numpy()],
                                      device="cpu")
    assert t.reconstruction_error(x) < one.reconstruction_error(x)


def test_quantizer_errors_match_jax():
    x = _residual_data(20)
    j, t = JaxStacked(), StackedQuantizer(device="cpu")
    _same_error(lambda: t.encode(x), lambda: j.encode(x))
    _same_error(lambda: t.decode(np.zeros((2, 2, 8), np.uint8)),
                lambda: j.decode(np.zeros((2, 2, 8), np.uint8)))
    _same_error(lambda: t.train(x[:0]), lambda: j.train(x[:0]))
    assert not t.is_trained


def test_bits_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 37).astype(np.uint8)
    b = rng.integers(0, 256, 37).astype(np.uint8)
    db = rng.integers(0, 256, (9, 37)).astype(np.uint8)
    flags = rng.random(45) < 0.4
    for x in (0, 1, 255, 2 ** 40 + 7):
        assert tbits.popcount(x) == jbits.popcount(x)
        assert tbits.next_power_of_two(x) == jbits.next_power_of_two(x)
        assert tbits.log2_ceil(x) == jbits.log2_ceil(x)
    assert tbits.popcount_bytes(a) == jbits.popcount_bytes(a)
    assert tbits.hamming_distance_bytes(a, b) == \
        jbits.hamming_distance_bytes(a, b)
    np.testing.assert_array_equal(tbits.hamming_distance_batch(a, db),
                                  jbits.hamming_distance_batch(a, db))
    packed = tbits.pack_bits(flags)
    np.testing.assert_array_equal(packed, jbits.pack_bits(flags))
    np.testing.assert_array_equal(tbits.unpack_bits(packed, 45),
                                  jbits.unpack_bits(packed, 45))
    assert list(tbits.BitIterator(a)) == list(jbits.BitIterator(a))


def test_random_equal_jax():
    t, j = trandom.RandomSampler(5), jrandom.RandomSampler.with_seed(5)
    np.testing.assert_array_equal(t.sample_indices(50, 10),
                                  j.sample_indices(50, 10))
    np.testing.assert_array_equal(t.sample_indices(5, 10),
                                  j.sample_indices(5, 10))
    np.testing.assert_array_equal(t.sample_with_replacement(9, 20),
                                  j.sample_with_replacement(9, 20))
    assert t.random_f32() == j.random_f32()
    assert t.shuffle(list(range(12))) == j.shuffle(list(range(12)))
    rt, rj = trandom.ReservoirSampler(7, seed=3), \
        jrandom.ReservoirSampler(7, seed=3)
    rt.extend(range(100))
    rj.extend(range(100))
    assert rt.items == rj.items and rt.seen == rj.seen == 100


def test_prelude_and_hashes_export_jax_names():
    assert torch_prelude.__all__ == jax_prelude.__all__
    assert len(torch_prelude.__all__) == 38
    for name in torch_prelude.__all__:
        assert type(getattr(torch_prelude, name)).__name__ == \
            type(getattr(jax_prelude, name)).__name__
        assert getattr(torch_prelude, name).__module__.startswith(
            "scann_tpu_torch")
    assert torch_hashes.__all__ == jax_hashes.__all__
    for name in torch_hashes.__all__:
        assert hasattr(torch_hashes, name)

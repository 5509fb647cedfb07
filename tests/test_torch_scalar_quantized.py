"""Scalar-quantized brute force of the PyTorch port against the JAX package
on the CPU: asymmetric scoring for its five measures in both code layouts,
the int8-dots kernel's twin against the Pallas kernel in interpret mode
(and the affine fold around it), the searcher for all five storages,
``from_quantized``, and indexes saved by the JAX package.

Tolerances:
  - the int8-dots twin (a float32 product) against the Pallas kernel:
    |diff| <= 1e-5 * sum_d |q_d * c_d| per entry (two float32 summation
    orders of the same exact products);
  - distances within 1e-5 relative, 1e-4 absolute where the fold cancels
    terms of size ~10^2; ids equal at every slot whose reference distance
    lies more than that from its neighbours' (the searchers quantize to the
    same bytes, so only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.io import save_index
from scann_tpu.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher as JaxSQ,
    ScalarQuantizedConfig as JaxSQConfig,
)
from scann_tpu.ops import asymmetric as jasym
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.ops.pallas_kernels import int8_dots_pallas
from scann_tpu.quantization import scalar as jsc
import scann_tpu_torch as T
from scann_tpu_torch import io as tio
from scann_tpu_torch.ops import asymmetric as pasym
from scann_tpu_torch.ops import scoring_kernels as sk

from test_torch_brute_force import assert_results_match

MEASURES = ["SQUARED_L2", "L2", "DOT_PRODUCT", "COSINE",
            "GENERAL_INNER_PRODUCT"]
STORAGES = ["int8", "int4", "bf16", "fp8_e4m3", "fp8_e5m2"]
N, D, B, K = 600, 24, 20, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    db = (rng.normal(size=(N, D)) * 1.5 + 0.25).astype(np.float32)
    q = (rng.normal(size=(B, D)) * 1.5).astype(np.float32)
    q[0] = 0.0        # zero norm: cosine similarity 0
    return db, q


@pytest.fixture(scope="module")
def quantized(data):
    """(JAX quantized dataset, port quantized dataset) of the same codes."""
    db, _ = data
    jqd = jsc.QuantizedDataset.from_dataset(JaxDataset(db))
    pqd = T.QuantizedDataset.from_dataset(T.DenseDataset(db),
                                          T.ScalarQuantizer(device="cpu"))
    np.testing.assert_array_equal(pqd.codes, jqd.codes)
    return jqd, pqd


def _close(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("name", MEASURES)
def test_asymmetric_scoring_matches_jax(data, quantized, name, transposed):
    """Both layouts: [N, D] codes through the float32 product, [D, N_pad]
    codes through int8_dots (its twin here; the Pallas kernel in interpret
    mode on the JAX side)."""
    _, q = data
    jqd, pqd = quantized
    scale, offset = jqd.quantizer.scale, jqd.quantizer.min_value
    if transposed:
        codes, norms, n = jqd.device_transposed()
    else:
        codes, norms, n = jqd.device()
    want = np.asarray(jasym.asymmetric_many_to_many(
        JaxMeasure[name], jnp.asarray(q), codes, norms, jnp.float32(scale),
        jnp.float32(offset), codes_transposed=transposed))
    got = pasym.asymmetric_many_to_many(
        T.DistanceMeasure[name], torch.from_numpy(q),
        torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(norms)),
        scale, offset, codes_transposed=transposed)
    assert got.shape == want.shape
    _close(got.numpy()[:, :n], want[:, :n])


def test_asymmetric_scoring_other_measures_raise(data, quantized):
    _, q = data
    _, pqd = quantized
    codes, norms, _ = pqd.device("cpu")
    with pytest.raises(NotImplementedError, match="asymmetric"):
        pasym.asymmetric_many_to_many(T.DistanceMeasure.L1,
                                      torch.from_numpy(q), codes, norms)


@pytest.mark.parametrize("b,d,n", [(3, 32, 256), (1, 13, 384), (7, 100, 128)])
def test_int8_dots_twin_matches_pallas(b, d, n):
    rng = np.random.default_rng(b + d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, d)).astype(np.uint8)
    want = np.asarray(int8_dots_pallas(jnp.asarray(q), jnp.asarray(codes.T),
                                       tile_n=128, interpret=True))
    got = sk.int8_dots(torch.from_numpy(q), torch.from_numpy(codes.T.copy()))
    assert got.dtype == torch.float32 and got.shape == (b, n)
    bound = 1e-5 * (np.abs(q) @ codes.astype(np.float32).T)
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert sk.LAUNCHES["int8_dots"] == 0


def test_int8_dots_affine_fold(rng):
    """The case of tests/test_pallas_kernels.py's affine test: the twin's
    raw dots folded by ``fold_affine`` give squared L2 against the
    dequantized rows, as the Pallas dots do."""
    db = rng.normal(size=(128, 16)).astype(np.float32)
    jqd = jsc.QuantizedDataset.from_dataset(JaxDataset(db))
    scale, offset = jqd.quantizer.scale, jqd.quantizer.min_value
    codes, norms, n = jqd.device()
    q = rng.normal(size=(2, 16)).astype(np.float32)
    raw_j = np.asarray(int8_dots_pallas(jnp.asarray(q),
                                        jnp.asarray(np.asarray(codes).T),
                                        tile_n=128, interpret=True))
    raw_p = sk.int8_dots(torch.from_numpy(q),
                         torch.from_numpy(np.asarray(codes).T.copy()))
    d_got = pasym.fold_affine(T.DistanceMeasure.SQUARED_L2,
                              torch.from_numpy(q), raw_p,
                              torch.from_numpy(np.asarray(norms)), scale,
                              offset).numpy()[:, :n]
    dots = scale * raw_j + offset * q.sum(1, keepdims=True)
    d_jax = (q ** 2).sum(1, keepdims=True) + np.asarray(norms)[None, :n] \
        - 2 * dots[:, :n]
    deq = jqd.dequantize_all()
    d_want = ((q[:, None, :] - deq[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(d_got, d_jax, rtol=1e-5, atol=1e-4)


def _pair(db, storage, name="SQUARED_L2"):
    return (JaxSQ(JaxDataset(db), JaxSQConfig(
                distance_measure=JaxMeasure[name], storage=storage)),
            T.ScalarQuantizedBruteForceSearcher(T.DenseDataset(db),
                                                T.ScalarQuantizedConfig(
                distance_measure=T.DistanceMeasure[name], storage=storage),
                device="cpu"))


@pytest.mark.parametrize("storage", STORAGES)
def test_searcher_matches_jax(data, storage):
    db, q = data
    jax_s, port = _pair(db, storage)
    want_i, want_d = jax_s.search_batched_arrays(q, K)
    got_i, got_d = port.search_batched_arrays(q, K)
    assert_results_match(got_i, got_d, want_i, want_d)
    assert port.memory_usage() == jax_s.memory_usage()
    assert port.compression_ratio() == jax_s.compression_ratio()
    assert not port.uses_kernel()


@pytest.mark.parametrize("name", ["DOT_PRODUCT", "COSINE", "L2"])
def test_searcher_measures_match_jax(data, name):
    db, q = data
    jax_s, port = _pair(db, "int8", name)
    want_i, want_d = jax_s.search_batched_arrays(q, K)
    got_i, got_d = port.search_batched_arrays(q, K)
    assert_results_match(got_i, got_d, want_i, want_d)


def test_kernel_layout_equals_product_layout(data, monkeypatch):
    """The transposed codes (padded to the kernel's tile) through
    ``int8_dots``, as a CUDA searcher runs them, give the [N, D] product
    path's results; padded columns never surface, even for k past N."""
    db, q = data
    port = T.ScalarQuantizedBruteForceSearcher(T.DenseDataset(db[:37]),
                                               device="cpu")
    product = port.search_batched_arrays(q, 50)
    monkeypatch.setattr(port, "uses_kernel", lambda: True)
    codes, _, n, transposed = port.device_codes()
    assert transposed and codes.shape == (D, sk.INT8_DOTS_TILE_N) and n == 37
    kernel = port.search_batched_arrays(q, 50)
    assert kernel[0].shape == (B, 37) and (kernel[0] < 37).all()
    assert_results_match(kernel[0], kernel[1], product[0], product[1])


def test_from_quantized_and_epsilon_match_jax(data, quantized):
    db, q = data
    jqd, pqd = quantized
    jax_s = JaxSQ.from_quantized(jqd, JaxMeasure.SQUARED_L2)
    port = T.ScalarQuantizedBruteForceSearcher.from_quantized(
        pqd, T.DistanceMeasure.SQUARED_L2, device="cpu")
    assert port.quantized_dataset is pqd
    want_i, want_d = jax_s.search_batched_arrays(q, K)
    got_i, got_d = port.search_batched_arrays(q, K)
    assert_results_match(got_i, got_d, want_i, want_d)
    from scann_tpu.models.searcher import SearchParameters as JaxParams

    eps = float(np.median(want_d[:, 3]))
    want_i, want_d = jax_s.search_batched_arrays(
        q, K, JaxParams(post_reordering_epsilon=eps))
    got_i, got_d = port.search_batched_arrays(
        q, K, T.SearchParameters(post_reordering_epsilon=eps))
    assert_results_match(got_i, got_d, want_i, want_d)
    assert (got_i == -1).any()


@pytest.mark.parametrize("storage", STORAGES)
def test_load_jax_saved_index(data, tmp_path, storage):
    """Codes (int8 / int4) carry across with the calibration rebuilt from
    scale and min; bf16 / fp8 files hold the float32 data, re-encoded."""
    db, q = data
    jax_s, _ = _pair(db, storage)
    path = str(tmp_path / f"{storage}.npz")
    save_index(path, jax_s)
    port = tio.load_index(path, device="cpu")
    assert isinstance(port, T.ScalarQuantizedBruteForceSearcher)
    want_i, want_d = jax_s.search_batched_arrays(q, K)
    got_i, got_d = port.search_batched_arrays(q, K)
    assert_results_match(got_i, got_d, want_i, want_d)
    if storage in ("int8", "int4"):
        jq, pq = jax_s.quantized_dataset.quantizer, \
            port.quantized_dataset.quantizer
        np.testing.assert_array_equal(port.quantized_dataset.codes,
                                      jax_s.quantized_dataset.codes)
        assert pq.num_levels == (1 << (4 if storage == "int4" else 8)) - 1
        assert pq.max_value == pq.min_value + pq.scale * pq.num_levels
        assert pq.inv_scale == 1.0 / jq.scale


def test_unknown_storage_and_default_device(data):
    db, q = data
    with pytest.raises(T.ScannError):
        T.ScalarQuantizedBruteForceSearcher(
            T.DenseDataset(db), T.ScalarQuantizedConfig(storage="int2"),
            device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ScalarQuantizedBruteForceSearcher(T.DenseDataset(db))

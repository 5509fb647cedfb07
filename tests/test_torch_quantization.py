"""Quantization of the PyTorch port against the JAX package on the CPU:
statistics, the int8 / int4 codec (host path and device path), the
dequantization, the per-query table, the dataset layouts and the bf16 and
fp8 datasets, on the same numpy-seeded inputs.

Tolerances: codes and stored float bytes are compared for equality; the
float64 statistics and norms to 1e-12 and 1e-6 relative; the float32
dequantized squared norms, summed in another order, to 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.quantization import bfloat16 as jbf
from scann_tpu.quantization import fp8 as jfp8
from scann_tpu.quantization import scalar as jsc
from scann_tpu.quantization.stats import QuantizationStats as JaxStats
import scann_tpu_torch as T
from scann_tpu_torch.ops.scoring_kernels import INT8_DOTS_TILE_N
from scann_tpu_torch.quantization import (
    BFloat16Dataset,
    Fp8Dataset,
    Fp8Format,
    Fp8Quantizer,
    PrecomputedQuery,
    QuantizationStats,
)
from scann_tpu_torch.quantization import scalar as psc

CALIBRATIONS = {
    "mean_3sd": dict(),
    "symmetric": dict(symmetric=True),
    "explicit": dict(min_value=-1.5, max_value=2.25),
}


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 24)).astype(np.float32) * 1.7 + 0.3
    x[0, :4] = [10.0, -10.0, 0.0, 2.25]   # outside and on the range edges
    return x


@pytest.fixture(scope="module")
def large():
    """2**22 values: the codec's device path in both packages."""
    rng = np.random.default_rng(6)
    return rng.normal(size=(1 << 16, 64)).astype(np.float32)


def _pair(bits, calibration, data):
    """(JAX quantizer, port quantizer) calibrated on ``data``."""
    kw = dict(bits=bits, **CALIBRATIONS[calibration])
    jq = jsc.ScalarQuantizer(jsc.ScalarQuantizerConfig(**kw))
    pq = T.ScalarQuantizer(T.ScalarQuantizerConfig(**kw), device="cpu")
    return jq.calibrate_from_array(data), pq.calibrate_from_array(data)


@pytest.mark.parametrize("shape,fill", [((300, 24), None), ((1,), 2.5),
                                        ((0,), None), ((7, 3), 1.0)])
def test_stats_match_jax(shape, fill):
    rng = np.random.default_rng(1)
    x = (np.full(shape, fill, np.float32) if fill is not None
         else rng.normal(size=shape).astype(np.float32) * 3 - 1)
    want, got = JaxStats.from_array(x), QuantizationStats.from_array(x)
    for f in ("min_value", "max_value", "mean", "std_dev"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("calibration", list(CALIBRATIONS))
@pytest.mark.parametrize("path", ["host", "device"])
def test_codes_byte_equal_to_jax(small, large, bits, calibration, path):
    """Calibration to the last bit, then the same code bytes: the host path
    below 2**22 values, the device path at 2**22 (JAX's jit codec against
    the port's float32 torch codec on the CPU)."""
    data = small if path == "host" else large
    jq, pq = _pair(bits, calibration, data)
    for f in ("min_value", "max_value", "scale", "inv_scale", "zero_point"):
        assert getattr(pq, f) == getattr(jq, f), f
    got = pq.quantize(data)
    assert got.dtype == np.uint8 and got.max() <= (1 << bits) - 1
    np.testing.assert_array_equal(got, jq.quantize(data))
    if path == "device":
        # and the port's two codecs agree with each other
        np.testing.assert_array_equal(pq._quantize_device(small),
                                      pq.quantize(small))


def test_dequantize_and_precomputed_query_match_jax(small):
    jq, pq = _pair(8, "mean_3sd", small)
    codes = jq.quantize(small)
    np.testing.assert_array_equal(pq.dequantize(codes), jq.dequantize(codes))
    np.testing.assert_array_equal(pq.dequantize(codes.view(np.int8)),
                                  jq.dequantize(codes.view(np.int8)))
    assert pq.quantize_value(0.7) == jq.quantize_value(0.7)
    assert pq.dequantize_value(200) == jq.dequantize_value(200)
    want = jsc.PrecomputedQuery(small[1], jq)
    got = PrecomputedQuery(small[1], pq)
    np.testing.assert_array_equal(got.dequant_table, want.dequant_table)
    for row in codes[:5]:
        assert got.squared_l2_to_codes(row) == want.squared_l2_to_codes(row)


def test_quantized_dataset_layouts_match_jax(small):
    jqd = jsc.QuantizedDataset.from_dataset(JaxDataset(small))
    pqd = T.QuantizedDataset.from_dataset(
        T.DenseDataset(small), T.ScalarQuantizer(device="cpu"))
    np.testing.assert_array_equal(pqd.codes, jqd.codes)
    np.testing.assert_array_equal(pqd.raw_data_i8(), jqd.raw_data_i8())
    np.testing.assert_array_equal(pqd.dequantize_all(), jqd.dequantize_all())
    np.testing.assert_array_equal(pqd.dequantize_row(3), jqd.dequantize_row(3))
    assert pqd.memory_usage_bytes() == jqd.memory_usage_bytes()
    assert pqd.compression_ratio() == jqd.compression_ratio()
    n = small.shape[0]
    codes, norms, size = pqd.device("cpu")
    j_codes, j_norms, _ = jqd.device()
    assert size == n and codes.shape == (n, small.shape[1])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes)[:n])
    np.testing.assert_allclose(norms.numpy(), np.asarray(j_norms)[:n],
                               rtol=1e-5)
    codes_t, norms_t, _ = pqd.device_transposed("cpu")
    n_pad = -(-n // INT8_DOTS_TILE_N) * INT8_DOTS_TILE_N
    assert codes_t.shape == (small.shape[1], n_pad)
    np.testing.assert_array_equal(codes_t.numpy()[:, :n], jqd.codes.T)
    assert not codes_t[:, n:].any()
    j_codes_t, j_norms_t, _ = jqd.device_transposed()
    np.testing.assert_allclose(norms_t.numpy(), np.asarray(j_norms_t)[:n_pad],
                               rtol=1e-5)


def _float_data(seed, scale):
    """Values over five decades, signs mixed, inside the fp8 E4M3 range."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-4, np.log10(scale), size=(200, 20))
    return (mag * rng.choice([-1.0, 1.0], size=mag.shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ["bf16", "E4M3", "E5M2"])
def test_float_datasets_byte_equal_to_jax(kind):
    data = _float_data(3, 400.0)
    if kind == "bf16":
        want, got = jbf.BFloat16Dataset.from_f32(data), \
            BFloat16Dataset.from_f32(data)
        want_bytes = want._data.view(np.uint16)
        got_bytes = got._data.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got.get(4), want.get(4))
    else:
        want = jfp8.Fp8Dataset(data, jfp8.Fp8Format[kind])
        got = Fp8Dataset(data, Fp8Format[kind])
        want_bytes, got_bytes = want.raw_bytes(), got.raw_bytes()
    np.testing.assert_array_equal(got_bytes, want_bytes)
    np.testing.assert_array_equal(got.to_f32(), want.to_f32())
    assert got.memory_usage_bytes() == want.memory_usage_bytes()
    assert got.compression_ratio() == want.compression_ratio()
    codes, norms, n = got.device("cpu")
    _, want_norms, _ = want.device()
    assert n == data.shape[0] and codes.shape == data.shape
    np.testing.assert_allclose(norms.numpy(), np.asarray(want_norms)[:n],
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["E4M3", "E5M2"])
def test_fp8_bits_over_every_byte_match_jax(kind):
    want = jfp8.Fp8Quantizer(jfp8.Fp8Format[kind])
    got = Fp8Quantizer(Fp8Format[kind])
    checked = 0
    for bits in range(256):
        value = want.decode_bits(bits)
        if np.isnan(value):
            continue
        assert got.decode_bits(bits) == value or (
            np.isinf(value) and got.decode_bits(bits) == value), bits
        assert got.encode_bits(value) == want.encode_bits(value), bits
        checked += 1
    assert checked >= 250


@pytest.mark.parametrize("kind", ["E4M3", "E5M2"])
def test_fp8_quantizer_saturates_like_jax(kind):
    data = np.concatenate([_float_data(4, 400.0).ravel(),
                           np.array([1e6, -1e6, 470.0, -70000.0, 0.0],
                                    np.float32)])
    want = jfp8.Fp8Quantizer(jfp8.Fp8Format[kind])
    got = Fp8Quantizer(Fp8Format[kind])
    codes = got.quantize(data)
    np.testing.assert_array_equal(codes.view(torch.uint8).numpy(),
                                  want.quantize(data).view(np.uint8))
    np.testing.assert_array_equal(got.dequantize(codes),
                                  want.dequantize(want.quantize(data)))


def test_device_codec_without_a_card_raises(large):
    """The quantizer's device defaults to the card: the 2**22-value path
    raises where there is none instead of running elsewhere."""
    q = T.ScalarQuantizer()
    assert q.device.type == "cuda"
    if torch.cuda.is_available():
        return
    q.calibrate_from_array(large[:10])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        q.quantize(large)
    assert psc.DEVICE_CODEC_MIN_VALUES == large.size

"""LUT16 modules of the PyTorch port against the JAX package on the CPU:
nibble packing, the u8 table codec and its even-first int8 layout, the
twins of the two LUT16 kernels against the Pallas kernels in interpret mode,
and the kernel-free scorer.

Tolerances:
  - packing, the u8 tables and the fused sweep are integer results: equal
    bit for bit; the codec's multiplier and bias within 1 float32 ulp;
  - the LUT16 score twin sums bf16 table entries in float32 in ascending s,
    the Pallas kernel in XLA's order: |port - jax| <= 1e-6 * Σ|terms| for
    float32 output, 1 bf16 ulp after the bf16 cast;
  - ``lut_score`` likewise (bf16 entries for C <= 32, float32 for C > 32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.hashes import lut as jax_lut
from scann_tpu.hashes import lut16 as jax_lut16
from scann_tpu.hashes.codebook import lut_kernel as jax_lut_kernel
from scann_tpu.ops.lut16_scoring import lut_score as jax_lut_score
from scann_tpu.ops.pallas_kernels import (
    INVALID_COMBINED as JAX_INVALID,
    lut16_fused_sweep_pallas,
    lut16_score_pallas,
)
from scann_tpu_torch.hashes import lut, lut16
from scann_tpu_torch.hashes.codebook import lut_kernel
from scann_tpu_torch.ops import scoring_kernels as sk
from scann_tpu_torch.ops.lut16_scoring import lut_score, lut_score_gathered


def _bf16_order(x: torch.Tensor) -> torch.Tensor:
    """bf16 values -> int32 keys whose differences count bf16 ulps."""
    bits = x.contiguous().view(torch.int16).int()
    mag = bits & 0x7FFF
    return torch.where(bits < 0, -mag, mag)


def _ulp32(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 ulps between two same-sign arrays."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


# -- packing ---------------------------------------------------------------------


@pytest.mark.parametrize("s", [8, 7, 1])
def test_pack_unpack_bit_identical(s):
    rng = np.random.default_rng(s)
    codes = rng.integers(0, 16, size=(37, s)).astype(np.uint8)
    want = jax_lut16.pack_codes_4bit(codes)
    got = lut16.pack_codes_4bit(codes)
    assert got.dtype == np.uint8 and got.shape == (37, (s + 1) // 2)
    np.testing.assert_array_equal(got, want)
    if s % 2:
        assert not (got[:, -1] >> 4).any()        # last high nibble 0
    dev = lut16.pack_codes_4bit_device(torch.from_numpy(codes))
    np.testing.assert_array_equal(dev.numpy(), want)
    np.testing.assert_array_equal(lut16.unpack_codes_4bit(want, s),
                                  jax_lut16.unpack_codes_4bit(want, s))
    np.testing.assert_array_equal(lut16.unpack_codes_4bit(want, s), codes)
    pc, jpc = (lut16.PackedCodes4Bit.from_codes(codes),
               jax_lut16.PackedCodes4Bit.from_codes(codes))
    np.testing.assert_array_equal(pc.raw_bytes(), jpc.raw_bytes())
    assert pc.bytes_per_point == jpc.bytes_per_point
    np.testing.assert_array_equal(pc.get_codes(5), jpc.get_codes(5))
    np.testing.assert_array_equal(pc.unpack_all(), codes)


def test_pack_rejects_wide_codes():
    from scann_tpu_torch.errors import ScannError

    with pytest.raises(ScannError):
        lut16.pack_codes_4bit(np.array([[3, 16]], np.uint8))


def test_simd_tables_and_host_luts_match_jax():
    rng = np.random.default_rng(3)
    tables = rng.normal(size=(7, 16)).astype(np.float32) * 3
    codes = rng.integers(0, 16, size=(50, 7)).astype(np.uint8)
    packed = jax_lut16.pack_codes_4bit(codes)
    got = lut16.Lut16SimdTables.from_float_tables(tables)
    want = jax_lut16.Lut16SimdTables.from_float_tables(tables)
    np.testing.assert_array_equal(got.packed_tables, want.packed_tables)
    assert (got.bias, got.multiplier) == (want.bias, want.multiplier)
    np.testing.assert_array_equal(got.compute_distances_batch(packed, 50),
                                  want.compute_distances_batch(packed, 50))
    t, jt = lut.LookupTable(tables), jax_lut.LookupTable(tables)
    np.testing.assert_array_equal(t.compute_distances_batch(codes),
                                  jt.compute_distances_batch(codes))
    assert t.compute_distance(codes[0]) == jt.compute_distance(codes[0])
    q8, jq8 = t.to_int8(), jt.to_int8()
    np.testing.assert_array_equal(q8.distances, jq8.distances)
    assert q8.compute_distance(codes[1]) == jq8.compute_distance(codes[1])
    assert q8.compute_distance_raw(codes[1]) == jq8.compute_distance_raw(
        codes[1])


# -- the u8 codec ------------------------------------------------------------------


def _real_luts(b=64, s=10, c=16, dsub=3, seed=0):
    """Tables as the searcher makes them: one codebook, queries near it."""
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(s, c, dsub)).astype(np.float32)
    q = rng.normal(size=(b, s * dsub)).astype(np.float32) * 1.5
    return cent, q


@pytest.mark.parametrize("s", [10, 7])
def test_quantize_and_evenfirst_match_jax(s):
    """u8 tables equal (every mismatch reported), multiplier and bias
    within 1 float32 ulp, the even-first int8 layout equal."""
    cent, q = _real_luts(s=s)
    luts = lut_kernel(torch.from_numpy(q), torch.from_numpy(cent))
    jluts = np.array(jax_lut_kernel(jnp.asarray(q), jnp.asarray(cent)))
    # one set of tables into both codecs: the codec is what is compared
    luts = torch.from_numpy(jluts)
    luts[3] = 0.25                                      # degenerate range
    jluts = luts.numpy()
    q_u8, mult, bias = lut.quantize_luts_u8_device(luts)
    jq, jm, jb = jax_lut.quantize_luts_u8_device(jnp.asarray(jluts))
    diff = np.argwhere(q_u8.numpy() != np.asarray(jq))
    assert len(diff) == 0, f"{len(diff)} u8 entries differ, first {diff[:5]}"
    assert _ulp32(mult.numpy(), np.asarray(jm)) <= 1
    assert _ulp32(bias.numpy(), np.asarray(jb)) <= 1
    assert float(mult[3]) == 1.0 and not q_u8[3].any()
    host = lut.quantize_luts_u8(jluts)
    jhost = jax_lut.quantize_luts_u8(jluts)
    for a, b in zip(host, jhost):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(host[0], q_u8.numpy())
    i8 = lut.luts_i8_evenfirst(q_u8)
    ji8 = np.asarray(jax_lut.luts_i8_evenfirst(jnp.asarray(q_u8.numpy())))
    assert i8.dtype == torch.int8 and i8.shape == (64, (s + s % 2) * 16)
    np.testing.assert_array_equal(i8.numpy(), ji8)


# -- #7: the fused sweep twin against the Pallas kernel ------------------------------


@pytest.mark.parametrize("s", [8, 7])
@pytest.mark.parametrize("r", [16, 32])
@pytest.mark.parametrize("valid", ["inside_block", "last_block_invalid",
                                   "ties"])
def test_fused_sweep_twin_matches_pallas(s, r, valid):
    """Bit-identical combined minima, the tie order (lowest row first) and
    the INVALID_COMBINED blocks included."""
    rng = np.random.default_rng(s * 100 + r)
    b, c, n = 5, 16, 512
    n_valid = {"inside_block": 405, "last_block_invalid": n - r - r // 2,
               "ties": n}[valid]
    top = 3 if valid == "ties" else 256           # tiny range: many ties
    luts_u8 = rng.integers(0, top, size=(b, s, c)).astype(np.uint8)
    codes = rng.integers(0, c, size=(n, s)).astype(np.uint8)
    packed_t = np.ascontiguousarray(jax_lut16.pack_codes_4bit(codes).T)
    ji8 = jax_lut.luts_i8_evenfirst(jnp.asarray(luts_u8))
    want = np.asarray(lut16_fused_sweep_pallas(
        ji8, jnp.asarray(packed_t), jnp.int32(n_valid), tile_n=128, r=r,
        interpret=True))
    i8 = lut.luts_i8_evenfirst(torch.from_numpy(luts_u8))
    before = dict(sk.LAUNCHES)
    got = sk.lut16_fused_sweep(i8, torch.from_numpy(packed_t), n_valid, r=r)
    assert sk.LAUNCHES == before                   # CPU: the twin
    assert got.dtype == torch.float32 and got.shape == (n // r, b)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    invalid = np.arange(n // r) * r >= n_valid
    assert (got.numpy()[invalid] == sk.INVALID_COMBINED).all()
    assert sk.INVALID_COMBINED == JAX_INVALID
    if valid == "last_block_invalid":
        assert invalid[-1] and not invalid[-2]


def test_fused_sweep_twin_chunks_and_decodes(monkeypatch):
    """The twin's N chunks do not change its result, and the decode gives
    each block's smallest quantized sum and the lowest row reaching it."""
    rng = np.random.default_rng(9)
    b, s, c, n, r, n_valid = 4, 6, 16, 1024, 32, 1000
    luts_u8 = rng.integers(0, 256, size=(b, s, c)).astype(np.uint8)
    codes = rng.integers(0, c, size=(n, s)).astype(np.uint8)
    packed_t = torch.from_numpy(
        np.ascontiguousarray(lut16.pack_codes_4bit(codes).T))
    i8 = lut.luts_i8_evenfirst(torch.from_numpy(luts_u8))
    whole = sk.lut16_fused_sweep_reference(i8, packed_t, n_valid, r)
    monkeypatch.setattr(sk, "_TWIN_ELEMS", 3 * r * b)
    chunked = sk.lut16_fused_sweep_reference(i8, packed_t, n_valid, r)
    assert torch.equal(whole, chunked)
    sums = luts_u8.astype(np.int64)[np.arange(b)[:, None, None],
                                    np.arange(s)[None, :, None],
                                    codes.T[None]].sum(1)        # [B, N]
    sums = np.where(np.arange(n) < n_valid, sums, 10 ** 9)
    iv = whole.numpy().T.astype(np.int64)                        # [B, N/r]
    blocks = sums.reshape(b, n // r, r)
    np.testing.assert_array_equal(iv // r, blocks.min(2))
    np.testing.assert_array_equal(iv % r, blocks.argmin(2))


def test_fused_sweep_rejects_inexact_combined():
    i8 = torch.zeros(1, 2058 * 16, dtype=torch.int8)     # S_pad = 2058
    codes = torch.zeros(1029, 64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        sk.lut16_fused_sweep(i8, codes, 64, r=32)
    with pytest.raises(ValueError, match="multiple of r"):
        sk.lut16_fused_sweep(torch.zeros(1, 32, dtype=torch.int8),
                             torch.zeros(1, 40, dtype=torch.uint8), 40, r=32)


# -- #8: the score twin against the Pallas kernel ---------------------------------------


def _score_inputs(seed, b=5, s=8, c=16, n=512):
    rng = np.random.default_rng(seed)
    luts = (rng.normal(size=(b, s, c)) * 3 + 4).astype(np.float32)
    codes_t = rng.integers(0, c, size=(s, n)).astype(np.uint8)
    return luts, codes_t


def _abs_sums(luts: np.ndarray, codes_t: np.ndarray, bf16: bool):
    """Σ_s |table entry| per [b, n], the scale of the summation error."""
    t = torch.from_numpy(luts)
    if bf16:
        t = t.to(torch.bfloat16).float()
    t = t.abs().numpy()
    s = luts.shape[1]
    return t[:, np.arange(s)[:, None], codes_t.astype(np.int64)].sum(1)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [8, 5])
def test_score_twin_matches_pallas(out_dtype, s):
    luts, codes_t = _score_inputs(s, s=s)
    jdt = jnp.float32 if out_dtype == "float32" else jnp.bfloat16
    want = lut16_score_pallas(jnp.asarray(luts), jnp.asarray(codes_t),
                              tile_n=128, interpret=True, out_dtype=jdt)
    before = dict(sk.LAUNCHES)
    got = sk.lut16_score(torch.from_numpy(luts), torch.from_numpy(codes_t),
                         out_dtype=getattr(torch, out_dtype))
    assert sk.LAUNCHES == before                   # CPU: the twin
    assert got.shape == (5, 512) and got.dtype == getattr(torch, out_dtype)
    if out_dtype == "float32":
        tol = 1e-6 * _abs_sums(luts, codes_t, bf16=True)
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= tol).all(), float((err - tol).max())
    else:
        want_t = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
            torch.bfloat16)
        ulps = (_bf16_order(got) - _bf16_order(want_t)).abs()
        assert int(ulps.max()) <= 1


def test_score_twin_is_ascending_bf16_sum_and_chunks(monkeypatch):
    """The twin adds bf16(entry) in ascending s in float32, chunk by chunk:
    equal, bit for bit, to that loop written out in numpy."""
    luts, codes_t = _score_inputs(11, s=6, n=300)
    t = torch.from_numpy(luts).to(torch.bfloat16).float().numpy()
    want = np.zeros((5, 300), np.float32)
    for si in range(6):
        want += t[:, si, codes_t[si].astype(np.int64)]
    monkeypatch.setattr(sk, "_TWIN_ELEMS", 5 * 7)
    got = sk.lut16_score_reference(torch.from_numpy(luts),
                                   torch.from_numpy(codes_t))
    np.testing.assert_array_equal(got.numpy(), want)
    bf = sk.lut16_score_reference(torch.from_numpy(luts),
                                  torch.from_numpy(codes_t), torch.bfloat16)
    assert torch.equal(bf, torch.from_numpy(want).to(torch.bfloat16))


# -- the kernel-free scorer ------------------------------------------------------------


@pytest.mark.parametrize("c,chunk", [(16, 16384), (16, 100), (256, 16384),
                                     (256, 77)])
def test_lut_score_matches_jax(c, chunk):
    """C=16 takes the bf16 one-hot arithmetic, C=256 the float32 gather."""
    rng = np.random.default_rng(c + chunk)
    b, s, n = 6, 8, 700
    luts = (rng.normal(size=(b, s, c)) * 2).astype(np.float32)
    codes = rng.integers(0, c, size=(n, s)).astype(np.uint8)
    want = np.asarray(jax_lut_score(jnp.asarray(luts), jnp.asarray(codes),
                                    chunk_size=256))
    got = lut_score(torch.from_numpy(luts), torch.from_numpy(codes),
                    chunk_size=chunk)
    assert got.shape == (b, n) and got.dtype == torch.float32
    tol = 1e-6 * _abs_sums(luts, codes.T, bf16=c <= 32) + 1e-30
    err = np.abs(got.numpy() - want)
    assert (err <= tol).all(), float((err - tol).max())
    if c > 32:
        # the gather path keeps float32 entries: it is not the bf16 sum
        bf = sk.lut16_score_reference(torch.from_numpy(luts),
                                      torch.from_numpy(np.ascontiguousarray(
                                          codes.T)))
        assert not torch.equal(bf, got)


def test_lut_score_gathered_matches_jax():
    from scann_tpu.ops.lut16_scoring import (
        lut_score_gathered as jax_gathered,
    )

    rng = np.random.default_rng(4)
    b, s, c, t = 3, 5, 16, 50
    luts = rng.normal(size=(b, s, c)).astype(np.float32)
    cpq = rng.integers(0, c, size=(b, t, s)).astype(np.uint8)
    want = np.asarray(jax_gathered(jnp.asarray(luts), jnp.asarray(cpq),
                                   chunk_t=16))
    got = lut_score_gathered(torch.from_numpy(luts), torch.from_numpy(cpq),
                             chunk_t=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

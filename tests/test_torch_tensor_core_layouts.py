"""The Python side of the two tensor-core kernels, against the JAX package on
the CPU: what the wrappers lay out in plain PyTorch for the card, and the
arithmetic the kernels do with it, emulated step by step.

- int8 dots (#9, ``csrc/int8_dots.cu``): the bf16 x 3 split of the queries,
  their shared-memory image as wgmma's B operand, and the three products.
- the fused LUT16 sweep (#7, ``csrc/lut16_scoring.cu``): the int8 tables
  re-laid as 32-byte k32 slices and as wgmma's B operand (tiles of 128 or
  64 queries), the one-hot product over them, then the combine and the
  block minimum; the tile plan each S_pad takes.

Tolerances:
  - the split sums back to q exactly (float64 sum of the parts == q);
  - the three float32 products of the parts with the codes against the
    Pallas kernel in interpret mode: |diff| <= 1e-5 * sum_d |q_d * c_d| per
    entry (exact products, two float32 summation orders);
  - image layouts and the one-hot sums are integers or copies: equal;
  - the fused sweep's combined minima: bit for bit against the port's twin
    and the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.hashes import lut as jax_lut
from scann_tpu.hashes import lut16 as jax_lut16
from scann_tpu.ops.pallas_kernels import (
    int8_dots_pallas,
    lut16_fused_sweep_pallas,
)
from scann_tpu_torch.hashes import lut
from scann_tpu_torch.ops import scoring_kernels as sk

# -- #9: int8 dots ---------------------------------------------------------------


def _queries(rng, b, d, scale):
    """float32 queries whose magnitudes lie in [scale, 2 scale): at 1e-30
    the last part's bits stay above the float32 normal range."""
    mag = rng.uniform(1.0, 2.0, size=(b, d)) * scale
    sign = rng.choice([-1.0, 1.0], size=(b, d))
    return (mag * sign).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 3.7e-3])
def test_bf16x3_split_sums_back_exactly(scale):
    rng = np.random.default_rng(11)
    q = torch.from_numpy(_queries(rng, 37, 100, scale))
    parts = sk.split_bf16x3(q)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 37, 100)
    assert torch.equal(parts.double().sum(0), q.double())
    # each part has at most 8 significant bits: its product with a code
    # below 256 is exact in float32
    p = parts.float()
    assert torch.equal(p.to(torch.bfloat16).float(), p)


@pytest.mark.parametrize("b,d,n", [(3, 32, 256), (7, 100, 384), (129, 13, 128)])
def test_bf16x3_products_match_pallas(b, d, n):
    """Three float32 products of the parts with the codes, summed, as the
    kernel's tensor cores compute them."""
    rng = np.random.default_rng(b + d + n)
    q = rng.normal(size=(b, d)).astype(np.float32)
    codes = rng.integers(0, 256, size=(d, n)).astype(np.uint8)
    want = np.asarray(int8_dots_pallas(jnp.asarray(q), jnp.asarray(codes),
                                       tile_n=128, interpret=True))
    parts = sk.split_bf16x3(torch.from_numpy(q)).float()
    c = torch.from_numpy(codes).float()
    got = (parts[0] @ c + parts[1] @ c + parts[2] @ c).numpy()
    bound = 1e-5 * (np.abs(q) @ codes.astype(np.float32))
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("b,d", [(5, 100), (130, 8), (128, 128)])
def test_int8_dots_query_image_is_the_descriptor_layout(b, d):
    """Every bf16 of the image sits where wgmma's K-major B descriptor
    (8 x 16-byte core matrices, 128 bytes between the two k halves, 256
    between groups of 8 queries) reads part p, query n, dimension k; zero
    past B and D."""
    rng = np.random.default_rng(b * d)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    img = sk.int8_dots_query_image(q).view(torch.int16).numpy()
    nks = -(-d // 16)
    qt = -(-b // 128)
    assert img.size * 2 == qt * 3 * nks * 4096
    parts = torch.zeros(3, qt * 128, nks * 16, dtype=torch.bfloat16)
    parts[:, :b, :d] = sk.split_bf16x3(q)
    want = parts.view(torch.int16).numpy()
    p, n, k = np.meshgrid(np.arange(3), np.arange(qt * 128),
                          np.arange(nks * 16), indexing="ij")
    step = ((n // 128) * 3 + p) * nks + k // 16
    off = (step * 4096 + (n % 128 // 8) * 256 + (k % 16 // 8) * 128
           + (n % 8) * 16 + (k % 8) * 2)
    np.testing.assert_array_equal(img[off // 2], want)


# -- #7: the fused LUT16 sweep ------------------------------------------------------


def _fused_case(s, b, n, seed):
    rng = np.random.default_rng(seed)
    luts_u8 = rng.integers(0, 256, size=(b, s, 16)).astype(np.uint8)
    codes = rng.integers(0, 16, size=(n, s)).astype(np.uint8)
    packed_t = np.ascontiguousarray(jax_lut16.pack_codes_4bit(codes).T)
    return luts_u8, packed_t


def _emulate_products(image, packed_t, b, sh, q_tile):
    """[N, B] int32 sums of the kernel's one-hot product: for each packed
    byte j, the one-hot [rows, 32] (k = low nibble, 16 + high nibble) times
    the [32, B] slice of the tables that the B descriptor reads from the
    image (q_tile / 8 groups of 8 queries x 2 core matrices of 8 x 16
    bytes)."""
    img = image.view(torch.int8).numpy().astype(np.int64)
    qt = -(-b // q_tile)
    n_idx, k = np.meshgrid(np.arange(qt * q_tile), np.arange(32),
                           indexing="ij")
    codes = packed_t.astype(np.int64)
    sums = np.zeros((packed_t.shape[1], qt * q_tile), np.int64)
    rows = np.arange(packed_t.shape[1])
    for j in range(sh):
        off = ((n_idx // q_tile * sh + j) * q_tile * 32
               + (n_idx % q_tile // 8) * 256 + (k // 16) * 128
               + (n_idx % 8) * 16 + k % 16)
        table = img[off].T                                    # [32, Bpad]
        onehot = np.zeros((len(rows), 32), np.int64)
        onehot[rows, codes[j] & 0xF] = 1
        onehot[rows, 16 + (codes[j] >> 4)] = 1
        sums += onehot @ table
    return sums[:, :b]


@pytest.mark.parametrize("s,r,b,n,n_valid,q_tile", [
    (50, 32, 130, 1024, 1000, 128),  # the main path's S and r; B past a tile
    (7, 8, 5, 512, 333, 128),        # r = 8, odd S, n_valid inside a block
    (9, 16, 20, 512, 512, 128),      # sh odd
    (12, 64, 3, 512, 450, 128),      # r spanning warps in the old design
    (4, 1024, 2, 2048, 1500, 128),   # r = 1024
    (100, 32, 70, 512, 500, 64),     # wide codes: 64-query tiles, B past one
    (150, 8, 9, 256, 200, 64),       # the widest S_pad the kernel takes
])
def test_fused_k32_emulation_matches_twin_and_pallas(s, r, b, n, n_valid,
                                                     q_tile):
    """The re-laid tables through the emulated k32 steps give the twin's
    int32 sums; combined and reduced they equal the Pallas kernel bit for
    bit."""
    luts_u8, packed_t = _fused_case(s, b, n, seed=s + r + b)
    i8 = lut.luts_i8_evenfirst(torch.from_numpy(luts_u8))
    sh = packed_t.shape[0]
    k32 = sk.lut16_fused_k32_tables(i8, sh)
    assert k32.shape == (b, sh, 32)
    t = i8.view(b, 2 * sh, 16)
    assert torch.equal(k32[:, :, :16], t[:, :sh])      # row j: low nibble
    assert torch.equal(k32[:, :, 16:], t[:, sh:])      # row sh + j: high
    image = sk.lut16_fused_table_image(i8, sh, q_tile)
    assert image.numel() == -(-b // q_tile) * sh * q_tile * 32
    sums = _emulate_products(image, packed_t, b, sh, q_tile)
    bias = 128 * 2 * sh
    # r = 1 turns the twin's combined value into the plain sum + bias
    twin = sk.lut16_fused_sweep_reference(i8, torch.from_numpy(packed_t), n,
                                          r=1)
    np.testing.assert_array_equal(twin.numpy().astype(np.int64), sums + bias)
    rows = np.arange(n)[:, None]
    comb = np.where(rows < n_valid, (sums + bias) * r + rows % r,
                    np.iinfo(np.int64).max)
    mins = comb.reshape(n // r, r, b).min(1)
    got = np.where(mins == np.iinfo(np.int64).max, sk.INVALID_COMBINED,
                   mins).astype(np.float32)
    want = np.asarray(lut16_fused_sweep_pallas(
        jax_lut.luts_i8_evenfirst(jnp.asarray(luts_u8)), jnp.asarray(packed_t),
        jnp.int32(n_valid), tile_n=min(n, 1024), r=r, interpret=True))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fused_tables_pad_small_code_counts():
    """C < 16: each table row is padded to 16 zero entries in the k32
    slices, which the codes (below C) never select."""
    rng = np.random.default_rng(4)
    b, s, c = 3, 5, 6
    luts_u8 = torch.from_numpy(rng.integers(0, 256, size=(b, s, c)).astype(
        np.uint8))
    i8 = lut.luts_i8_evenfirst(luts_u8)
    sh = (s + 1) // 2
    k32 = sk.lut16_fused_k32_tables(i8, sh)
    t = i8.view(b, 2 * sh, c)
    assert torch.equal(k32[:, :, :c], t[:, :sh])
    assert torch.equal(k32[:, :, 16:16 + c], t[:, sh:])
    assert not k32[:, :, c:16].any() and not k32[:, :, 16 + c:].any()


@pytest.mark.parametrize("s,plan", [
    (50, (128, 2)), (74, (128, 2)), (75, (64, 2)), (112, (64, 2)),
    (113, (64, 1)), (150, (64, 1)), (151, None), (300, None)])
def test_fused_tile_plan(s, plan):
    """128 queries' tables (4 KB per packed byte) and two code stages per
    warpgroup fit a block's 232,448 bytes up to S_pad = 74, 64 queries' up
    to 112, and with one stage per warpgroup up to 150; the wrapper raises
    past it."""
    sh = (s + 1) // 2
    assert sk.lut16_fused_plan(sh) == plan
    if plan is not None:
        assert sk.lut16_fused_smem_bytes(sh, *plan) <= sk.MAX_SHARED_MEMORY

"""Grouped leaf scorer of the PyTorch port against the JAX package: the
grouping must be identical, and the plain PyTorch scorer must match the
Pallas kernel (interpret mode) within one bf16 ulp with bf16 tables, and
exactly with int8 tables (int16 sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops.tree_ah_grouped import (
    group_pairs_by_partition as jax_group_pairs,
    tree_ah_grouped_scores_pallas,
)
from scann_tpu_torch.ops import tree_ah_grouped as tag
from scann_tpu_torch.types import MASKED_DISTANCE


@pytest.mark.parametrize("b,p,t,q_cap", [
    (16, 5, 12, 4), (16, 4, 40, 8), (8, 3, 2, 16), (16, 8, 64, 1),
])
def test_group_pairs_matches_jax(b, p, t, q_cap):
    parts = np.random.default_rng(b * p + t).integers(
        0, t, size=(b, p)).astype(np.int32)
    want_part, want_slot, want_ng = jax_group_pairs(jnp.asarray(parts), t,
                                                    q_cap)
    got_part, got_slot, got_ng = tag.group_pairs_by_partition(
        torch.from_numpy(parts), t, q_cap)
    assert got_ng == want_ng
    np.testing.assert_array_equal(got_part.numpy(), np.asarray(want_part))
    np.testing.assert_array_equal(got_slot.numpy(), np.asarray(want_slot))


def _grouped_inputs(rng, *, s_pad, packed, q_cap, l_tile, b=16, p=3, t=7,
                    c=16, s_logical=None):
    """Random CSR slab + grouped LUTs laid out as leaf_scores_grouped lays
    them out (unused groups get size 0)."""
    l_cap = 2 * l_tile
    sizes = rng.integers(1, l_cap + 1, size=t).astype(np.int32)
    sizes[0] = l_cap                     # one full partition: both tiles
    aligned = np.zeros(t + 1, np.int64)
    aligned[1:] = np.cumsum(((sizes + 127) // 128) * 128)
    n_csr = int(aligned[-1]) + l_cap
    codes = rng.integers(0, c, size=(s_pad, n_csr)).astype(np.uint8)
    luts = rng.normal(size=(b * p, s_pad, c)).astype(np.float32) * 4
    if s_logical is not None:
        codes[s_logical:] = 0
        luts[:, s_logical:] = 0.0
    parts = rng.integers(0, t, size=(b, p)).astype(np.int32)
    grp_part, slot, ng = jax_group_pairs(jnp.asarray(parts), t, q_cap)
    grp_part = np.asarray(grp_part)
    safe = np.maximum(grp_part, 0)
    grp_off = aligned[:-1].astype(np.int32)[safe]
    grp_size = np.where(grp_part >= 0, sizes[safe], 0).astype(np.int32)
    pair_of_slot = np.zeros(ng * q_cap, np.int64)
    pair_of_slot[np.asarray(slot)] = np.arange(b * p)
    if packed:
        codes = (codes[0::2] | (codes[1::2] << 4)).astype(np.uint8)
        luts = np.concatenate([luts[:, 0::2], luts[:, 1::2]], axis=1)
    luts_grouped = luts.reshape(b * p, -1)[pair_of_slot]
    return luts_grouped, codes, grp_off, grp_size, l_cap


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("q_cap,l_tile", [(1, 128), (4, 128), (8, 256),
                                          (16, 128)])
def test_reference_scorer_matches_pallas(packed, q_cap, l_tile):
    rng = np.random.default_rng(q_cap * 1000 + l_tile + packed)
    s_pad = 16 if packed else 32
    luts_g, codes, grp_off, grp_size, l_cap = _grouped_inputs(
        rng, s_pad=s_pad, packed=packed, q_cap=q_cap, l_tile=l_tile,
        s_logical=13)
    want = np.asarray(tree_ah_grouped_scores_pallas(
        jnp.asarray(luts_g), jnp.asarray(codes), jnp.asarray(grp_off),
        jnp.asarray(grp_size), l_cap=l_cap, l_tile=l_tile, q_cap=q_cap,
        interpret=True, packed=packed)).astype(np.float32)
    got_t = tag.tree_ah_grouped_scores(
        torch.from_numpy(luts_g), torch.from_numpy(codes),
        torch.from_numpy(grp_off), torch.from_numpy(grp_size), l_cap=l_cap,
        l_tile=l_tile, q_cap=q_cap, packed=packed)
    assert got_t.dtype == torch.bfloat16
    got = got_t.float().numpy()
    # rows of group slots beyond each group's pairs hold LUT row 0's scores
    # on both sides; compare every row
    masked = want >= MASKED_DISTANCE / 2
    np.testing.assert_array_equal(got >= MASKED_DISTANCE / 2, masked)
    np.testing.assert_array_equal(got[masked], want[masked])
    # both round a float32 sum to bf16; summation order may differ, so the
    # results may sit one bf16 ulp apart (relative 2**-7 at worst)
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=2**-7)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("q_cap,l_tile", [(1, 128), (4, 128), (8, 256),
                                          (16, 128)])
def test_int8_reference_scorer_matches_pallas_exactly(packed, q_cap, l_tile):
    """The int8-LUT branch: int16 sums equal the Pallas int8 branch's bit
    for bit (both sum integers exactly), masked slots I16_MASK."""
    rng = np.random.default_rng(q_cap * 100 + l_tile + packed + 7)
    s_pad = 16 if packed else 32
    luts_g, codes, grp_off, grp_size, l_cap = _grouped_inputs(
        rng, s_pad=s_pad, packed=packed, q_cap=q_cap, l_tile=l_tile,
        s_logical=13)
    luts_i8 = np.clip(np.round(luts_g * 10), -128, 127).astype(np.int8)
    want = np.asarray(tree_ah_grouped_scores_pallas(
        jnp.asarray(luts_i8), jnp.asarray(codes), jnp.asarray(grp_off),
        jnp.asarray(grp_size), l_cap=l_cap, l_tile=l_tile, q_cap=q_cap,
        interpret=True, packed=packed))
    got = tag.tree_ah_grouped_scores(
        torch.from_numpy(luts_i8), torch.from_numpy(codes),
        torch.from_numpy(grp_off), torch.from_numpy(grp_size), l_cap=l_cap,
        l_tile=l_tile, q_cap=q_cap, packed=packed)
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == tag.I16_MASK).any()


def test_unused_groups_are_masked_without_codes():
    """A group of size 0 must come back fully masked even when its offset
    points at real codes."""
    luts = torch.ones(2 * 4, 16 * 16)
    codes = torch.zeros(8, 512, dtype=torch.uint8)
    out = tag.tree_ah_grouped_scores(
        luts, codes, torch.tensor([0, 0], dtype=torch.int32),
        torch.tensor([200, 0], dtype=torch.int32), l_cap=256, l_tile=128,
        q_cap=4, packed=True)
    out = out.float()
    assert torch.all(out[4:] >= MASKED_DISTANCE / 2)
    assert torch.all(out[:4, :200] == 16.0)
    assert torch.all(out[:4, 200:] >= MASKED_DISTANCE / 2)


def test_scorer_validates_shapes():
    luts = torch.zeros(8, 16 * 16)
    codes = torch.zeros(8, 512, dtype=torch.uint8)
    off = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of l_tile"):
        tag.tree_ah_grouped_scores(luts, codes, off, off, l_cap=200,
                                   l_tile=128, q_cap=4, packed=True)
    with pytest.raises(ValueError, match="q_cap"):
        tag.tree_ah_grouped_scores(luts, codes, off, off, l_cap=256,
                                   l_tile=128, q_cap=3, packed=True)
    # int8 tables: S_pad * 255 must stay below the int16 sentinel
    with pytest.raises(ValueError, match="S_pad"):
        tag.tree_ah_grouped_scores(
            torch.zeros(8, 256 * 16, dtype=torch.int8),
            torch.zeros(128, 512, dtype=torch.uint8), off, off, l_cap=256,
            l_tile=128, q_cap=4, packed=True)


def test_cpu_tensors_never_launch_the_kernel():
    before = tag.LAUNCHES
    luts = torch.ones(4, 16 * 16)
    codes = torch.zeros(8, 384, dtype=torch.uint8)
    one = torch.ones(1, dtype=torch.int32)
    tag.tree_ah_grouped_scores(luts, codes, 0 * one, 100 * one, l_cap=256,
                               l_tile=128, q_cap=4, packed=True)
    assert tag.LAUNCHES == before

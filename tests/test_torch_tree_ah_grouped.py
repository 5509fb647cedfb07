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
from scann_tpu_torch.types import MASKED_DISTANCE, MAX_SHARED_MEMORY


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


@pytest.mark.parametrize("q_cap,s_pad,c,int8,packed,l_cap", [
    (8, 64, 16, False, True, 6144),     # the main cell
    (8, 64, 16, True, True, 2048),      # the SOAR int8 cell
    (1, 64, 16, False, True, 512),
    (16, 64, 16, False, True, 2560),
    (32, 64, 16, True, True, 1536),
    (8, 32, 256, False, False, 512),    # C=256 unpacked
    (8, 56, 256, False, False, 640),    # room for two 2-row stages only
    (1, 512, 227, False, False, 256),   # tables fill the shared memory
    (8, 113, 256, True, False, 256),
    (4, 13, 7, False, False, 150),
])
def test_kernel_plan_matches_count(q_cap, s_pad, c, int8, packed, l_cap):
    """The CUDA kernel's plan against a count made here: columns a thread,
    the ring that fits beside the tables, shared bytes and column ranges."""
    plan = tag.kernel_plan(q_cap, s_pad, c, int8=int8, packed=packed,
                           l_cap=l_cap)
    assert plan.cols == min(4, 32 // q_cap) and q_cap * plan.cols <= 32
    assert plan.tile_cols == tag.THREADS * plan.cols
    table = -(-(q_cap * s_pad * c * (1 if int8 else 2)) // 16) * 16
    assert plan.table_bytes == table
    s_rows = s_pad // 2 if packed else s_pad
    rows = np.minimum(tag.STAGE_ROWS, s_rows)
    ring = tag.RING_STAGES * rows * (plan.tile_cols + 16) + 16
    fits = np.flatnonzero(table + ring <= MAX_SHARED_MEMORY)
    if fits.size:
        i = fits[0]
        assert (plan.stage_rows, plan.stages) == (rows[i], tag.RING_STAGES)
        assert plan.smem_bytes == table + ring[i]
    else:
        assert (plan.stage_rows, plan.stages) == (s_rows, 0)
        assert plan.smem_bytes == table
    assert plan.smem_bytes <= MAX_SHARED_MEMORY
    tiles = -(-l_cap // plan.tile_cols)
    assert plan.range_cols % plan.tile_cols == 0
    assert plan.range_cols >= min(2, tiles) * plan.tile_cols
    assert plan.ranges == -(-l_cap // plan.range_cols) <= tag.MAX_RANGES
    # a group of size n stages its tables once per live range
    sizes = np.array([0, 1, plan.range_cols, plan.range_cols + 1, l_cap])
    live = -(-np.minimum(sizes, l_cap) // plan.range_cols)
    assert live.tolist() == [0, 1, 1, min(2, plan.ranges), plan.ranges]


def test_kernel_plan_refuses_tables_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tag.kernel_plan(32, 64, 256, int8=False, packed=False, l_cap=512)


def _biased_lane_sums(entries: np.ndarray) -> np.ndarray:
    """The int8 branch's sums as csrc/tree_ah_grouped.cu forms them:
    entries [q_cap, S_pad] int8 staged as u8 v+128, four queries a 32-bit
    word (bytes b0..b3). Accumulator 2k adds word k whole, 2k+1 adds its
    b1 and b3 as u16 lanes, both in u32 arithmetic (mod 2**32); b0's and
    b2's lanes are the whole-word sum less the odd sums shifted by 8. Each
    lane less 128*S_pad is the sum."""
    q_cap, s_pad = entries.shape
    words = max(1, q_cap // 4)
    staged = np.zeros((s_pad, 4 * words), np.uint64)
    staged[:, :q_cap] = entries.T.astype(np.int64) + 128
    packed = (staged.reshape(s_pad, words, 4)
              << np.array([0, 8, 16, 24], np.uint64)).sum(-1)
    mod = np.uint64(1 << 32)
    whole = np.zeros(words, np.uint64)
    odd = np.zeros(words, np.uint64)
    for s in range(s_pad):
        whole = (whole + packed[s]) % mod
        odd = (odd + ((packed[s] >> np.uint64(8)) & np.uint64(0xff))
               + (((packed[s] >> np.uint64(24)) & np.uint64(0xff))
                  << np.uint64(16))) % mod
    even = (whole - ((odd << np.uint64(8)) % mod)) % mod
    out = []
    for q in range(q_cap):
        a = (odd if q & 1 else even)[q // 4]
        lane = (a >> np.uint64(16)) if q & 2 else a
        out.append(int(lane & np.uint64(0xffff)) - 128 * s_pad)
    return np.array(out)


@pytest.mark.parametrize("q_cap", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("fill", ["-128", "127", "random"])
def test_biased_u16_lane_sums_are_exact(q_cap, fill):
    """At S_pad 64 (and 128, the int8 branch's largest) no lane carries
    into its neighbour: the biased sums equal the int32 sums."""
    for s_pad in (64, 128):
        if fill == "random":
            entries = np.random.default_rng(q_cap + s_pad).integers(
                -128, 128, size=(q_cap, s_pad)).astype(np.int8)
        else:
            entries = np.full((q_cap, s_pad), int(fill), np.int8)
        want = entries.astype(np.int32).sum(1)
        np.testing.assert_array_equal(_biased_lane_sums(entries), want)


# the widest deployment the benchmark serves: 1536-d rows, 768 subspaces of
# 16 codes, packed
WIDE_S_PAD = 768


@pytest.mark.parametrize("rule", [8, 16, 32])
def test_fit_q_cap_at_768_subspaces_plans_a_block_that_fits(rule):
    """At S_pad 768, C 16 one group of 16 queries' bf16 tables needs
    393,216 bytes; the fit takes 8 (196,608 bytes and a 16-row ring)."""
    with pytest.raises(ValueError, match="shared memory"):
        tag.kernel_plan(16, WIDE_S_PAD, 16, int8=False, packed=True,
                        l_cap=1536)
    q = tag.fit_q_cap(rule, WIDE_S_PAD, 16, int8=False)
    assert q == 8
    plan = tag.kernel_plan(q, WIDE_S_PAD, 16, int8=False, packed=True,
                           l_cap=1536)
    assert plan.table_bytes == 196_608
    assert (plan.stage_rows, plan.stages) == (16, tag.RING_STAGES)
    assert plan.smem_bytes == 196_608 + 2 * 16 * (512 + 16) + 16
    assert plan.smem_bytes <= MAX_SHARED_MEMORY
    # int8 tables take half the bytes: 16 queries fit
    assert tag.fit_q_cap(rule, WIDE_S_PAD, 16, int8=True) == min(rule, 16)


@pytest.mark.parametrize("rule", [8, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_fit_q_cap_keeps_the_rule_where_the_tables_fit(rule, int8):
    """S_pad 64: glove's 50 subspaces padded, and sift's 64."""
    assert tag.fit_q_cap(rule, 64, 16, int8=int8) == rule


def test_fit_q_cap_lowers_to_what_fits_and_refuses_what_cannot():
    assert tag.fit_q_cap(16, WIDE_S_PAD, 16, int8=False) == 8
    assert tag.fit_q_cap(8, WIDE_S_PAD, 16, int8=False) == 8
    # 3 is no kernel instance: the largest below it that fits
    assert tag.fit_q_cap(3, 64, 16, int8=False) == 2
    # S_pad 1536 at C 16: 4 queries' tables fit, 8 do not
    assert tag.fit_q_cap(16, 1536, 16, int8=False) == 4
    with pytest.raises(ValueError, match="shared memory"):
        tag.fit_q_cap(8, 8192, 16, int8=False)


def _pairs_scored(rng_seed, q_cap, *, b=8, p=4, t=5, l_tile=128):
    """[B*p, l_cap] scores of each (query, partition) pair at S_pad 768 from
    the twin, grouped at ``q_cap``; every draw is independent of q_cap."""
    rng = np.random.default_rng(rng_seed)
    c = 16
    l_cap = 2 * l_tile
    sizes = rng.integers(1, l_cap + 1, size=t).astype(np.int32)
    aligned = np.zeros(t + 1, np.int64)
    aligned[1:] = np.cumsum(((sizes + 127) // 128) * 128)
    n_csr = int(aligned[-1]) + l_cap
    codes = rng.integers(0, c, size=(WIDE_S_PAD, n_csr)).astype(np.uint8)
    luts = rng.normal(size=(b * p, WIDE_S_PAD, c)).astype(np.float32)
    parts = torch.from_numpy(rng.integers(0, t, size=(b, p)))
    grp_part, slot, ng = tag.group_pairs_by_partition(parts, t, q_cap)
    safe = grp_part.clamp_min(0).numpy()
    grp_off = torch.from_numpy(aligned[:-1].astype(np.int32)[safe])
    grp_size = torch.from_numpy(
        np.where(grp_part.numpy() >= 0, sizes[safe], 0).astype(np.int32))
    pair_of_slot = torch.zeros(ng * q_cap, dtype=torch.int64)
    pair_of_slot[slot] = torch.arange(b * p)
    packed = torch.from_numpy(codes[0::2] | (codes[1::2] << 4))
    even_first = np.concatenate([luts[:, 0::2], luts[:, 1::2]], axis=1)
    luts_g = torch.from_numpy(even_first.reshape(b * p, -1))[pair_of_slot]
    out = tag.tree_ah_grouped_scores(
        luts_g, packed, grp_off, grp_size, l_cap=l_cap, l_tile=l_tile,
        q_cap=q_cap, packed=True)
    return out[slot]


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_scores_at_768_subspaces_are_bit_identical_across_q_cap(seed):
    """Lowering q_cap from the rule's 16 to the fit's 8 regroups the pairs
    but sums each one's entries in the same order: the same bits."""
    wide = _pairs_scored(seed, 16)
    fitted = _pairs_scored(seed, 8)
    assert wide.dtype == torch.bfloat16
    assert torch.equal(wide.view(torch.int16), fitted.view(torch.int16))
    assert bool((wide.float() < MASKED_DISTANCE / 2).any())


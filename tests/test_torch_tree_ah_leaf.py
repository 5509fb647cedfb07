"""Per-pair float32 leaf scorer of the PyTorch port (the twin of
``csrc/tree_ah_leaf.cu``) against the JAX package's Pallas kernel
``tree_ah_leaf_scores_pallas`` in interpret mode, at the shapes of
``tests/test_tree_ah_pallas.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops.tree_ah_pallas import tree_ah_leaf_scores_pallas
from scann_tpu_torch.ops import tree_ah_leaf as tal
from scann_tpu_torch.types import MASKED_DISTANCE


def _both(luts, codes_t, offsets, sizes, l_cap):
    want = np.asarray(tree_ah_leaf_scores_pallas(
        jnp.asarray(luts), jnp.asarray(codes_t), jnp.asarray(offsets),
        jnp.asarray(sizes), l_cap=l_cap, interpret=True))
    got = tal.tree_ah_leaf_scores(
        torch.from_numpy(luts), torch.from_numpy(codes_t),
        torch.from_numpy(offsets), torch.from_numpy(sizes), l_cap=l_cap)
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


def _check(got, want, luts, sizes, l_cap):
    """Masks equal; scores equal within 1e-6 of the pair's largest possible
    sum of |entries| (the Pallas kernel reduces S*C one-hot products in
    another order than the twin's ascending-s float32 sum)."""
    valid = np.arange(l_cap)[None, None, :] < sizes[:, :, None]
    assert (got[~valid] == want[~valid]).all()
    assert (got[~valid] >= MASKED_DISTANCE / 2).all()
    tol = 1e-6 * np.abs(luts).max(axis=-1).sum(axis=-1)[:, :, None]
    assert (np.abs(got - want) <= tol)[valid].all()


@pytest.mark.parametrize("seed", [0, 1])
def test_leaf_scores_match_pallas_ragged_offsets(seed):
    """b=3, p=4, S=8, C=16, l_cap=64 over ragged partitions whose CSR
    starts are NOT 128-aligned (as in tests/test_tree_ah_pallas.py)."""
    rng = np.random.default_rng(seed)
    b, p, s, c, l_cap, n_parts = 3, 4, 8, 16, 64, 10
    sizes_all = rng.integers(5, l_cap, size=n_parts)
    offsets_all = np.zeros(n_parts + 1, np.int32)
    np.cumsum(sizes_all, out=offsets_all[1:])
    n = int(offsets_all[-1])
    codes = rng.integers(0, c, size=(n + l_cap, s)).astype(np.uint8)
    parts = rng.integers(0, n_parts, size=(b, p))
    offsets = offsets_all[parts].astype(np.int32)
    sizes = sizes_all[parts].astype(np.int32)
    luts = rng.uniform(0, 4, size=(b, p, s, c)).astype(np.float32)
    got, want = _both(luts, codes.T.copy(), offsets, sizes, l_cap)
    _check(got, want, luts, sizes, l_cap)
    # and against the definition, pair by pair
    for bi in range(b):
        for pi in range(p):
            off, sz = offsets[bi, pi], sizes[bi, pi]
            blk = codes[off:off + sz].astype(int)
            ref = luts[bi, pi][np.arange(s)[None, :], blk].sum(-1)
            np.testing.assert_allclose(got[bi, pi, :sz], ref, rtol=1e-6)


def test_leaf_scores_full_partitions():
    """Partitions exactly l_cap long: nothing masked."""
    rng = np.random.default_rng(2)
    b, p, s, c, l_cap = 2, 2, 4, 16, 32
    codes = rng.integers(0, c, size=(5 * l_cap, s)).astype(np.uint8)
    offsets = np.array([[0, l_cap], [2 * l_cap, 3 * l_cap]], np.int32)
    sizes = np.full((b, p), l_cap, np.int32)
    luts = rng.uniform(0, 2, size=(b, p, s, c)).astype(np.float32)
    got, want = _both(luts, codes.T.copy(), offsets, sizes, l_cap)
    assert (got < MASKED_DISTANCE / 2).all()
    _check(got, want, luts, sizes, l_cap)


def test_pad_subspaces_add_nothing():
    """Tables of S subspaces over codes padded to S_pad=32 (pad codes 0):
    the tables get zero rows, as the Pallas wrapper pads them."""
    rng = np.random.default_rng(3)
    b, p, s, c, l_cap = 4, 3, 10, 16, 128
    codes = np.zeros((32, 6 * l_cap), np.uint8)
    codes[:s] = rng.integers(0, c, size=(s, 6 * l_cap))
    offsets = rng.integers(0, 5 * l_cap, size=(b, p)).astype(np.int32)
    sizes = rng.integers(0, l_cap + 1, size=(b, p)).astype(np.int32)
    luts = rng.normal(size=(b, p, s, c)).astype(np.float32)
    got, want = _both(luts, codes, offsets, sizes, l_cap)
    _check(got, want, luts, sizes, l_cap)


def test_cpu_tensors_never_launch_the_kernel():
    before = tal.LAUNCHES
    tal.tree_ah_leaf_scores(
        torch.ones(1, 1, 4, 16), torch.zeros(4, 256, dtype=torch.uint8),
        torch.zeros(1, 1, dtype=torch.int32),
        torch.full((1, 1), 100, dtype=torch.int32), l_cap=128)
    assert tal.LAUNCHES == before


@pytest.mark.parametrize("s_pad,c", [(64, 16), (32, 16), (13, 256), (64, 256),
                                     (200, 256), (8, 16)])
def test_pairs_per_block_follows_the_shared_memory_budget(s_pad, c):
    """Q: as many float32 tables as fit a quarter of the shared memory
    beside the kernel's fixed bytes, between 1 and 8; 8 for the 4 KB tables
    of S_pad 64, C=16, fewer for C=256."""
    table = 4 * s_pad * c
    want = max(1, min(8, (232_448 // 4 - tal.FIXED_SHARED_BYTES) // table))
    assert tal.pairs_per_block(s_pad, c) == want
    if (s_pad, c) == (64, 16):
        assert want == 8
    if c == 256:
        assert want < 8


def test_pairs_per_block_raises_past_one_table():
    """A table that does not fit a block beside the code ring raises."""
    with pytest.raises(ValueError, match="shared memory"):
        tal.pairs_per_block(256, 256)          # 256 KB
    with pytest.raises(ValueError, match="shared memory"):
        tal.pairs_per_block(220, 256)          # 220 KB + the ring
    assert tal.pairs_per_block(190, 256) == 1


@pytest.mark.parametrize("seed,parts_count", [(0, 1), (1, 3), (2, 50),
                                              (3, 1000)])
def test_pair_order_is_a_stable_sort_of_offsets(seed, parts_count):
    """The kernel's pair order: a stable argsort of the flat offsets (as
    numpy's), int32; pairs of one partition become neighbours in pair
    order."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(1 << 20, size=parts_count, replace=False))
    offsets = starts[rng.integers(0, parts_count, size=(64, 30))]
    order = tal.pair_order(torch.from_numpy(offsets.astype(np.int32)))
    assert order.dtype == torch.int32 and order.shape == (64 * 30,)
    np.testing.assert_array_equal(
        order.numpy(), np.argsort(offsets.reshape(-1), kind="stable"))
    flat = offsets.reshape(-1)[order.numpy()]
    assert (np.diff(flat) >= 0).all()

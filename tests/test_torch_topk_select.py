"""The exact bf16 top-k of ``scann_tpu_torch/ops/topk.py``: which rows the
selection kernel (``csrc/topk_select.cu``) takes and in what layout, the
plain twin it must equal (``_top_k_by_key``) against the JAX package's
selections, and, on the card, the kernel against the twin bit for bit.

This file imports neither JAX nor the JAX package at the top (the tests
against JAX import it inside), so its card tests also run where JAX is
not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_topk_select.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from scann_tpu_torch.ops import topk as pt
from scann_tpu_torch.types import MASKED_DISTANCE

W_LEAF = 102_400          # p * l_cap of the benchmark's tree-x-AH cells
W_HASHER = 1_183_514      # the hasher's LUT16 scores over glove's rows


class _Rows:
    """What ``select_kernel_takes`` reads of a tensor (dtype and device),
    for any device, without memory."""

    def __init__(self, dtype=torch.bfloat16, device="cuda"):
        self.dtype, self.device = dtype, torch.device(device)


@pytest.mark.parametrize("rows,takes", [
    (_Rows(), True),
    (_Rows(device="cuda:1"), True),
    # other dtypes and devices keep their paths
    (_Rows(dtype=torch.float32), False),
    (_Rows(dtype=torch.float16), False),
    (_Rows(device="cpu"), False),
    (_Rows(device="meta"), False),
])
def test_select_kernel_routing(rows, takes):
    """Every bf16 tensor on a CUDA device goes to the kernel, whatever its
    shape, layout, k or width; nothing else does."""
    assert pt.select_kernel_takes(rows) is takes


def _layouts():
    """(name, tensor, whether the kernel's rows are a view of it)."""
    base = torch.arange(6 * 40, dtype=torch.float32).reshape(6, 40)
    base = (base.sin() * 4).round().bfloat16()
    return [
        ("contiguous", base, True),
        ("column_slice", base[:, 3:35], True),
        ("row_slice", base[1:5], True),
        ("transposed", base.t(), False),
        ("strided_columns", base[:, ::2], False),
        ("one_row", base[2], True),
        ("three_d", base.reshape(2, 3, 40), True),
        ("three_d_transposed", base.reshape(2, 3, 40).transpose(0, 1),
         False),
        ("no_rows", base[:0], True),
    ]


@pytest.mark.parametrize("name,x,view", _layouts(),
                         ids=[c[0] for c in _layouts()])
def test_kernel_rows_layouts(name, x, view):
    """``kernel_rows`` gives the kernel [rows, n] with unit column stride:
    the rows of ``x`` in order, a view wherever the layout allows (any row
    stride kept), a copy otherwise."""
    rows = pt.kernel_rows(x, 4)
    n = x.shape[-1]
    assert rows.dim() == 2 and rows.shape[1] == n
    assert rows.stride(-1) == 1 or rows.shape[0] <= 1
    assert torch.equal(rows, x.reshape(-1, n))
    if rows.numel():
        assert (rows.data_ptr() == x.data_ptr()) is view


@pytest.mark.parametrize("shape,k", [
    ((4, 30), 31), ((4, 30), -1), ((30,), 31),
    ((2, pt.SELECT_MAX_N + 1), 100)])
def test_kernel_rows_refuses_what_no_selection_takes(shape, k):
    """A k past the width, a negative k and a row wider than the kernel's
    32-bit columns raise instead of reaching the kernel."""
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="top-k selection"):
        pt.kernel_rows(x, k)


@pytest.mark.parametrize("k,cap,shared", [
    (1, 4096, True), (100, 4096, True), (1000, 4096, True),
    (4096, 4096, True), (4097, 8192, True), (5000, 8192, True),
    (16384, 16384, True), (16385, 32768, False), (100_000, 131072, False)])
def test_key_capacity(k, cap, shared):
    """The kernel's key buffer: a power of two, at least 4,096 and k, in
    shared memory up to 16,384 keys (128 KB), else a global scratch; k =
    5000 is SOAR's pre_k 2500 x multiplicity 2."""
    assert pt.key_capacity(k) == (cap, shared)
    assert cap >= k and cap & (cap - 1) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_rows_take_the_twin_and_count_nothing(dtype):
    """CPU rows never reach the kernel and move neither counter; the
    result is the key's."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 700)).astype(np.float32)).to(dtype)
    before = (pt.SELECT_KERNEL_ROWS, pt.SELECT_LAUNCHES)
    got = pt.top_k_smallest(x, 50)
    assert (pt.SELECT_KERNEL_ROWS, pt.SELECT_LAUNCHES) == before
    want = pt._top_k_by_key(x, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _nan_inf(rng, rows, width):
    """Normal rows with NaNs of both signs (two payloads), +inf, -inf,
    +0.0 and -0.0."""
    x = torch.from_numpy(rng.normal(size=(rows, width)).astype(np.float32)
                         ).bfloat16().view(torch.int16)
    x[:, 0::97] = 0x7FC1                   # a NaN with a payload
    x[:, 5::89] = -61                      # 0xFFC3, a NaN with its sign set
    x[:, 7::101] = 0x7F80                  # +inf
    x[:, 9::103] = -128                    # 0xFF80, -inf
    x[:, 11::37] = 0
    x[:, 13::41] = -32768                  # 0x8000, -0.0
    return x.view(torch.bfloat16)


def _leaf_like(rng, rows, width, *, levels, neg_share, zero_share,
               masked_from):
    """bf16 rows as leaf scores look: values on a coarse grid (heavy ties),
    a share negative (inner-product tables), +0.0 and -0.0 scattered, and a
    MASKED_DISTANCE tail from column ``masked_from`` (slots past a
    partition's size)."""
    x = rng.integers(1, levels + 1, size=(rows, width)) / 8.0
    x = np.where(rng.random((rows, width)) < neg_share, -x, x)
    zeros = rng.random((rows, width))
    x[zeros < zero_share] = 0.0
    x[zeros > 1 - zero_share] = -0.0
    x[:, masked_from:] = MASKED_DISTANCE
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def _assert_like_jax(x, k, vals, idx):
    """``(vals, idx)`` equal the JAX package's exact ``top_k_smallest``
    (``lax.top_k``'s order: -0.0 before +0.0, ties lower index first,
    NaNs with a set sign bit first and the others last): the same
    indices, the same value bits but for NaN payloads, which JAX makes
    canonical."""
    import jax.numpy as jnp

    from scann_tpu.ops.topk import top_k_smallest as jax_top_k

    want_v, want_i = jax_top_k(
        jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    got = vals.view(torch.int16).numpy()
    want = np.asarray(want_v.view(jnp.int16))
    nan = np.isnan(vals.float().numpy())
    assert np.array_equal(nan, np.isnan(np.asarray(want_v, np.float32)))
    np.testing.assert_array_equal(got[~nan], want[~nan])


def _assert_like_jax_approx(x, k, vals):
    """``vals`` equal the JAX package's ``approx_top_k_smallest`` as its
    CPU backend runs it (``lax.approx_min_k``, exact there) IEEE-wise
    (-0.0 == +0.0): the same k smallest values. It takes equal values in
    an order of its own, not lower index first, so its indices are only
    held to distinct columns of the row that hold its values; the order
    the port keeps is its exact ``top_k_smallest``'s (``_assert_like_jax``).
    """
    import jax.numpy as jnp

    from scann_tpu.ops.topk import approx_top_k_smallest as jax_approx

    want_v, want_i = jax_approx(
        jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16), k)
    want_v = np.asarray(want_v, np.float32)
    want_i = np.asarray(want_i).astype(np.int64)
    np.testing.assert_array_equal(vals.float().numpy(), want_v)
    np.testing.assert_array_equal(
        np.take_along_axis(x.float().numpy(), want_i, -1), want_v)
    assert all(len(set(r)) == k for r in want_i.tolist())


@settings(max_examples=3, deadline=None, database=None)
@given(seed=st.integers(0, 2**63 - 1), levels=st.sampled_from([4, 40, 400]),
       neg_share=st.sampled_from([0.0, 0.5, 1.0]),
       zero_share=st.sampled_from([0.0, 0.01, 0.2]),
       masked_share=st.floats(0.0, 0.6))
@pytest.mark.parametrize("k", [100, 1000])
def test_key_twin_equals_jax_top_k(k, seed, levels, neg_share, zero_share,
                                   masked_share):
    """The kernel's twin, ``_top_k_by_key`` at the preselect's width, gives
    the JAX package's smallest k: its exact ``top_k_smallest`` (the order
    the port keeps: -0.0 before +0.0, ties lower index first) bit for bit,
    and its ``approx_top_k_smallest`` as the CPU backend runs it in values,
    up to the sign of zero and the choice among ties."""
    rng = np.random.default_rng(seed)
    masked_from = W_LEAF - int(masked_share * W_LEAF)
    x = _leaf_like(rng, 8, W_LEAF, levels=levels, neg_share=neg_share,
                   zero_share=zero_share, masked_from=masked_from)
    vals, idx = pt._top_k_by_key(x, k)
    _assert_like_jax(x, k, vals, idx)
    _assert_like_jax_approx(x, k, vals)


@pytest.mark.parametrize("width,k", [(300, 17), (1000, 100), (61_440, 1000),
                                     (70_000, 250)])
def test_key_twin_orders_nan_and_inf_as_jax(width, k):
    """NaNs of both signs, +-inf and signed zeros, narrow rows too: the
    twin (and so the kernel, which equals it on the card) orders them as
    the JAX package's exact ``top_k_smallest``, and returns the input's
    bits, NaN payloads included."""
    x = _nan_inf(np.random.default_rng(width), 4, width)
    vals, idx = pt._top_k_by_key(x, k)
    _assert_like_jax(x, k, vals, idx)
    assert torch.equal(vals.view(torch.int16),
                       x.view(torch.int16).gather(-1, idx))


# --- on the card -----------------------------------------------------------

def _case(name, rng):
    """(rows on the host, k) of each card case."""
    if name == "leaf_k100":
        return _leaf_like(rng, 1024, W_LEAF, levels=400, neg_share=0.5,
                          zero_share=0.01, masked_from=60_000), 100
    if name == "leaf_k1000":
        return _leaf_like(rng, 1024, W_LEAF, levels=400, neg_share=1.0,
                          zero_share=0.0, masked_from=59_000), 1000
    if name == "normal_k1000":
        return torch.from_numpy(rng.normal(size=(1024, W_LEAF)).astype(
            np.float32)).bfloat16(), 1000
    if name == "k_w_minus_1":
        return _leaf_like(rng, 16, 3001, levels=40, neg_share=0.5,
                          zero_share=0.1, masked_from=2500), 3000
    if name == "k_equals_w":
        return _leaf_like(rng, 16, 3000, levels=40, neg_share=0.5,
                          zero_share=0.1, masked_from=2500), 3000
    if name == "k_4096":
        return _leaf_like(rng, 16, 4097, levels=40, neg_share=0.5,
                          zero_share=0.1, masked_from=4000), 4096
    # past 4,096 keys: shared memory beyond 48 KB (SOAR's pre_k 2500 x 2),
    # the largest shared buffer, then the global scratch, ties at the
    # boundary in each
    if name == "k_5000":
        return _leaf_like(rng, 64, W_LEAF, levels=40, neg_share=0.5,
                          zero_share=0.01, masked_from=60_000), 5000
    if name == "k_16384":
        return _leaf_like(rng, 32, W_LEAF, levels=400, neg_share=0.5,
                          zero_share=0.01, masked_from=60_000), 16384
    if name == "k_20000_global":
        return _leaf_like(rng, 32, W_LEAF, levels=40, neg_share=0.5,
                          zero_share=0.01, masked_from=60_000), 20_000
    if name == "all_equal_global":
        return torch.full((8, W_LEAF), -2.5, dtype=torch.bfloat16), 40_000
    if name == "odd_width":
        return _leaf_like(rng, 64, W_LEAF - 3, levels=400, neg_share=0.5,
                          zero_share=0.01, masked_from=W_LEAF - 100), 1000
    if name == "narrow":
        return _leaf_like(rng, 64, 61_440, levels=40, neg_share=0.5,
                          zero_share=0.05, masked_from=50_000), 100
    if name == "all_equal":
        return torch.full((64, W_LEAF), 1.5, dtype=torch.bfloat16), 1000
    if name == "few_real":
        return _leaf_like(rng, 64, W_LEAF, levels=40, neg_share=0.5,
                          zero_share=0.0, masked_from=300), 1000
    if name == "nan_inf":
        return _nan_inf(rng, 64, W_LEAF), 1000
    if name == "nan_inf_narrow":
        return _nan_inf(rng, 64, 1000), 100
    if name == "hasher":
        return _leaf_like(rng, 8, W_HASHER, levels=400, neg_share=1.0,
                          zero_share=0.0, masked_from=W_HASHER - 30), 1000
    raise ValueError(name)


def _assert_same_as_twin(x, k, got):
    """(values, indices) equal to the int64 key's bit for bit: the
    indices, and the values' bits (the input's, NaN payloads kept)."""
    want_v, want_i = pt._top_k_by_key(x, k)
    got_v, got_i = got
    assert got_v.dtype == torch.bfloat16 and got_i.dtype == torch.int64
    assert got_v.shape == got_i.shape == want_i.shape
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int16), want_v.view(torch.int16))


CARD_CASES = [
    "leaf_k100", "leaf_k1000", "normal_k1000", "k_w_minus_1", "k_equals_w",
    "k_4096", "k_5000", "k_16384", "k_20000_global", "all_equal_global",
    "odd_width", "narrow", "all_equal", "few_real", "nan_inf",
    "nan_inf_narrow", "hasher"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_select_kernel_matches_twin(name):
    """The kernel's (values, int64 positions) equal the int64 key's, bit
    for bit, its rows and one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, k = _case(name, np.random.default_rng(sum(map(ord, name))))
    x = x.cuda()
    before = (pt.SELECT_KERNEL_ROWS, pt.SELECT_LAUNCHES)
    got = pt.top_k_smallest(x, k)
    torch.cuda.synchronize()
    assert (pt.SELECT_KERNEL_ROWS, pt.SELECT_LAUNCHES) == (
        before[0] + x.shape[0], before[1] + 1)
    _assert_same_as_twin(x, k, got)


@pytest.mark.cuda
def test_select_kernel_non_contiguous_rows():
    """Every layout reaches the kernel and equals the twin on the same
    values: a column slice (row stride past the width, rows off the
    16-byte grid) as a view, a transposed view and strided columns as a
    copy, one row, a 3-D batch; k = 0 and no rows launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    wide = _leaf_like(rng, 256, W_LEAF + 16, levels=400, neg_share=0.5,
                      zero_share=0.01, masked_from=W_LEAF).cuda()
    for x, k in ((wide[:, 3:3 + W_LEAF], 1000), (wide[:, :5000].t(), 100),
                 (wide[:, ::3], 1000), (wide[7], 1000),
                 (wide[:, :W_LEAF].reshape(4, 64, W_LEAF), 100)):
        rows = x.numel() // x.shape[-1]
        before = (pt.SELECT_KERNEL_ROWS, pt.SELECT_LAUNCHES)
        got = pt.top_k_smallest(x, k)
        assert (pt.SELECT_KERNEL_ROWS, pt.SELECT_LAUNCHES) == (
            before[0] + rows, before[1] + 1)
        _assert_same_as_twin(x.contiguous(), k, got)
    before = (pt.SELECT_KERNEL_ROWS, pt.SELECT_LAUNCHES)
    for x, k in ((wide, 0), (wide[:0], 10)):
        vals, idx = pt.top_k_smallest(x, k)
        assert vals.shape == idx.shape == (x.shape[0], k)
    assert (pt.SELECT_KERNEL_ROWS, pt.SELECT_LAUNCHES) == before
    with pytest.raises(ValueError, match="top-k selection"):
        pt.top_k_smallest(wide, W_LEAF + 17)

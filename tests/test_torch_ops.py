"""Distances and top-k of the PyTorch port against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops import distances as jd
from scann_tpu.ops.topk import top_k_smallest as jax_top_k
from scann_tpu_torch.ops import distances as td
from scann_tpu_torch.ops.topk import approx_top_k_smallest, top_k_smallest

MEASURES = [("SQUARED_L2", td.DistanceMeasure.SQUARED_L2),
            ("DOT_PRODUCT", td.DistanceMeasure.DOT_PRODUCT)]


@pytest.fixture
def arrays():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(16, 32)).astype(np.float32),
            rng.normal(size=(300, 32)).astype(np.float32) * 2,
            rng.normal(size=(16, 40, 32)).astype(np.float32))


@pytest.mark.parametrize("name,measure", MEASURES)
def test_many_to_many_matches_jax(arrays, name, measure):
    q, db, _ = arrays
    want = np.asarray(jd.many_to_many(jd.DistanceMeasure[name],
                                      jnp.asarray(q), jnp.asarray(db)))
    got = td.many_to_many(measure, torch.from_numpy(q), torch.from_numpy(db))
    # float32 products in another summation order; distances ~ 10^2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name,measure", MEASURES)
def test_gathered_distances_matches_jax(arrays, name, measure):
    q, _, rows = arrays
    want = np.asarray(jd.gathered_distances(jd.DistanceMeasure[name],
                                            jnp.asarray(q),
                                            jnp.asarray(rows)))
    got = td.gathered_distances(measure, torch.from_numpy(q),
                                torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_squared_norms_and_units(arrays):
    q, _, _ = arrays
    np.testing.assert_allclose(
        td.squared_norms(torch.from_numpy(q)).numpy(),
        np.asarray(jd.squared_norms(jnp.asarray(q))), rtol=1e-6)
    x = torch.tensor([2.0, 4.0])
    assert torch.equal(td.approx_to_measure_units(
        x, td.DistanceMeasure.COSINE), x * 0.5)
    assert torch.equal(td.approx_to_measure_units(
        x, td.DistanceMeasure.SQUARED_L2), x)


def test_unported_measures_raise(arrays):
    q, db, _ = arrays
    with pytest.raises(NotImplementedError,
                       match="SparseBruteForceSearcher"):
        td.many_to_many(td.DistanceMeasure.WEIGHTED_JACCARD,
                        torch.from_numpy(q), torch.from_numpy(db))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_top_k_matches_lax_top_k_with_ties(dtype, k):
    """Coarse values force many ties; the selection must equal lax.top_k's
    (ties lower index first) in values and indices."""
    rng = np.random.default_rng(k)
    x = np.round(rng.normal(size=(8, 1000)) * 4) / 4
    x[:, ::7] = -x[:, ::7]
    xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
    want_v, want_i = jax_top_k(jnp.asarray(xt.float().numpy()), k)
    got_v, got_i = top_k_smallest(xt, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(want_v))
    a_v, a_i = approx_top_k_smallest(xt, k)
    assert torch.equal(a_i, got_i) and torch.equal(a_v, got_v)


def test_top_k_wide_bf16_rows_take_the_int64_key():
    """Rows wider than 2**16 cannot pack the column into a float32; the
    selection must still match lax.top_k."""
    rng = np.random.default_rng(3)
    x = (np.round(rng.normal(size=(2, 70_000)) * 2) / 2).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want_v, want_i = jax_top_k(jnp.asarray(xt.float().numpy()), 20)
    got_v, got_i = top_k_smallest(xt, 20)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(want_v))


@pytest.mark.parametrize("ties", ["none", "inside", "boundary", "signed_zero"])
def test_wide_float32_rows_select_by_value_like_lax_top_k(ties):
    """float32 rows past VALUE_SELECT_MIN_N select on their values and fall
    back to the key where a tie crosses the k-th place; either way the
    result is the key's alone and the JAX package's, ties lower index first.
    (Signed zeros: the key orders -0.0 first; the JAX package's k-rounds
    selection at this width takes them as equal, so that case is held to
    the key only.)"""
    from scann_tpu_torch.ops import topk as tk

    rng = np.random.default_rng(len(ties))
    n, k = tk.VALUE_SELECT_MIN_N + 37, 10
    x = np.abs(rng.normal(size=(6, n))).astype(np.float32) + 1.0
    if ties == "inside":        # equal values among the k smallest
        x[:, [5, 900, 30_000]] = -1.0
    elif ties == "boundary":    # a tie group across the k-th place
        x[:3, :2000:100] = -2.0
    elif ties == "signed_zero":  # -0.0 orders before +0.0, as in lax.top_k
        x[:, 7:20] = 0.0
        x[:, 3] = -0.0
        x[2:, 500] = -0.0
    got_v, got_i = top_k_smallest(torch.from_numpy(x), k)
    key_v, key_i = tk._top_k_by_key(torch.from_numpy(x), k)
    assert torch.equal(key_i, got_i)
    assert torch.equal(key_v.view(torch.int32), got_v.view(torch.int32))
    if ties != "signed_zero":
        want_v, want_i = jax_top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    else:
        assert list(got_i[2, :3].numpy()) == [3, 500, 7]
    # a leading batch dimension and a transposed view select the same
    got3 = top_k_smallest(torch.from_numpy(x)[None], k)[1][0]
    assert torch.equal(got3, got_i)
    got_t = top_k_smallest(torch.from_numpy(x.T.copy()).T, k)[1]
    assert torch.equal(got_t, got_i)

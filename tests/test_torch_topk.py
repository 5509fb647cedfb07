"""The dedup selections of the PyTorch port's ``ops/topk.py`` against the
JAX package's, with ties: candidate lists where ids repeat (spilling puts a
point in several partitions) and values repeat (bf16 leaf scores)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops import topk as jt
from scann_tpu.types import MASKED_DISTANCE
from scann_tpu_torch.ops import topk as pt


def _spilled(seed, b=6, width=60, n_ids=25, levels=7, masked=0.2):
    """[b, width] candidate values on a coarse grid (many ties) and ids
    drawn with repeats; a share of the slots masked (MASKED_DISTANCE, as a
    masked approximate slot; its id stays a real id, as in the searcher)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, levels, size=(b, width)).astype(np.float32) / 4
    ids = rng.integers(0, n_ids, size=(b, width)).astype(np.int32)
    vals[rng.random((b, width)) < masked] = MASKED_DISTANCE
    return vals, ids


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("out_k", [1, 10, 30])
def test_keep_best_per_id_matches_jax(seed, out_k):
    """Values and ids equal: the stable (id, value) order, masked entries
    behind real copies of their id, lower index first among equal values."""
    vals, ids = _spilled(seed)
    want_v, want_i = jt.keep_best_per_id(jnp.asarray(vals), jnp.asarray(ids),
                                         out_k)
    got_v, got_i = pt.keep_best_per_id(torch.from_numpy(vals),
                                       torch.from_numpy(ids), out_k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # each returned id once, with its best value
    for row_v, row_i, v, i in zip(got_v.numpy(), got_i.numpy(), vals, ids):
        real = row_i[row_i >= 0]
        assert len(set(real)) == len(real)
        for val, j in zip(row_v, row_i):
            if j >= 0:
                assert val == v[i == j].min()


def test_keep_best_per_id_payload_and_negative_ids():
    """A payload rides to the same slots; ids of -1 never dedup."""
    vals = np.array([[0.5, 0.5, 0.25, 1.0, 0.25, 2.0]], np.float32)
    ids = np.array([[3, -1, 3, -1, 7, 7]], np.int32)
    pay = np.arange(6, dtype=np.int32)[None] * 10
    want = jt.keep_best_per_id(jnp.asarray(vals), jnp.asarray(ids), 4,
                               payload=jnp.asarray(pay))
    got = pt.keep_best_per_id(torch.from_numpy(vals), torch.from_numpy(ids),
                              4, payload=torch.from_numpy(pay))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [1, 5, 12])
def test_dedup_top_k_matches_jax(seed, k):
    vals, ids = _spilled(seed, masked=0.0)
    order = np.argsort(vals, axis=1, kind="stable")
    vals = np.take_along_axis(vals, order, 1)
    ids = np.take_along_axis(ids, order, 1)
    ids[:, ::7] = -1                      # missing slots stay
    want = jt.dedup_top_k(jnp.asarray(vals), jnp.asarray(ids), k)
    got = pt.dedup_top_k(torch.from_numpy(vals), torch.from_numpy(ids), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k,mult", [(5, 2), (10, 2), (4, 3)])
def test_top_k_unique_matches_jax(seed, k, mult):
    vals, ids = _spilled(seed, masked=0.1)
    want = jt.top_k_unique(jnp.asarray(vals), jnp.asarray(ids), k, mult)
    got = pt.top_k_unique(torch.from_numpy(vals), torch.from_numpy(ids), k,
                          mult)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_threshold_and_merge_match_jax():
    vals, ids = _spilled(5, masked=0.0)
    eps = float(np.quantile(vals, 0.05))
    want = jt.top_k_with_threshold(jnp.asarray(vals), 8, eps)
    got = pt.top_k_with_threshold(torch.from_numpy(vals), 8, eps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy() == -1).any()
    want = jt.merge_top_k(jnp.asarray(vals), jnp.asarray(ids), 9)
    got = pt.merge_top_k(torch.from_numpy(vals), torch.from_numpy(ids), 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

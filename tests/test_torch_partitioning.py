"""Balancing and spilling of the PyTorch port's partitioner against the JAX
package's on equal inputs (the host numpy steps return its arrays exactly;
the device top-r steps agree up to float32 rounding of near ties), and the
whole balanced SOAR build held by its invariants and by recall against the
JAX build."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import (
    TreeXHybridConfig as JaxConfig,
    TreeXHybridSearcher as JaxSearcher,
)
from scann_tpu.partitioning import tree_partitioner as jtp
from scann_tpu.partitioning.partitioner import (
    DatabaseTokenization as JaxTokenization,
)
from scann_tpu_torch import (
    AsymmetricHasherConfig,
    DenseDataset,
    SearchParameters,
    TreeXHybridConfig,
    TreeXHybridSearcher,
)
from scann_tpu_torch.partitioning import tree_partitioner as ptp
from scann_tpu_torch.partitioning.partitioner import DatabaseTokenization
from scann_tpu_torch.utils.benchmarking import recall_at_k


def _skewed(seed, n=3000, d=16, clusters=10):
    """Clustered rows with Zipf-like cluster masses, so a few partitions
    overflow any cap."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 3
    w = 1.0 / np.arange(1, clusters + 1)
    lab = rng.choice(clusters, size=n, p=w / w.sum())
    x = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
    return x, rng


def _pair(x, k, **cfg):
    """A JAX and a port partitioner holding the same k centers (rows of x)
    and the same config; the tokens of x under those centers."""
    rng = np.random.default_rng(k)
    centers = x[rng.choice(len(x), k, replace=False)].copy()
    j = jtp.TreePartitioner(jtp.TreePartitionerConfig(num_partitions=k,
                                                      seed=7, **cfg))
    j.centers = centers.copy()
    j._centers_dev = jnp.asarray(centers)
    p = ptp.TreePartitioner(ptp.TreePartitionerConfig(num_partitions=k,
                                                      seed=7, **cfg),
                            device="cpu")
    p.centers = torch.from_numpy(centers.copy())
    tokens = ((x[:, None] - centers[None]) ** 2).sum(-1).argmin(1)
    return j, p, tokens.astype(np.int32)


@pytest.mark.parametrize("cap", [150, 400])
def test_lbg_grow_centers_matches_jax(cap):
    x, _ = _skewed(0)
    _, _, tokens = _pair(x, 12)
    centers = x[:12].copy()
    want = jtp.lbg_grow_centers(x, tokens, centers, cap,
                                np.random.default_rng(3))
    got = ptp.lbg_grow_centers(x, tokens, centers, cap,
                               np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] % 256 == 0
    assert ptp.lbg_grow_centers(x, tokens, centers, len(x),
                                np.random.default_rng(3)) is None


@pytest.mark.parametrize("cap,rounds", [(200, 12), (300, 2), (250, 0)])
def test_demote_to_cap_matches_jax(cap, rounds):
    x, rng = _skewed(1)
    d = ((x[:, None] - x[rng.choice(len(x), 20, replace=False)][None]) ** 2
         ).sum(-1)
    choices = np.argsort(d, axis=1, kind="stable")[:, :6]
    dists = np.take_along_axis(d, choices, 1).astype(np.float32)
    want = jtp.demote_to_cap(dists, choices, cap, rounds)
    got = ptp.demote_to_cap(dists, choices, cap, rounds)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("cap", [100, 260])
def test_enforce_cap_and_split_stragglers_match_jax(cap):
    """The demote loop over the device top-r, then the principal-axis
    split: equal tokens and centers (the top-r distances agree to float32
    rounding; equal inputs to the host loop give equal outputs), and
    every partition at or under the cap after the split."""
    x, _ = _skewed(2)
    j, p, tokens = _pair(x, 24, cap_enforce_rounds=12,
                         cap_enforce_choices=6)
    want = j._enforce_cap(jnp.asarray(x), tokens, cap)
    got = p._enforce_cap(torch.from_numpy(x), tokens, cap)
    assert np.mean(got == want) >= 0.995
    want_s = j._split_stragglers(x, want, cap)
    got_s = p._split_stragglers(x, want, cap)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(p.centers.numpy(), j.centers)
    assert np.bincount(got_s).max() <= cap


def test_cap_value_matches_jax():
    for cap in ("auto", 64, 1000):
        j, p, _ = _pair(np.zeros((40, 2), np.float32), 4,
                        max_partition_size=cap)
        for n in (10, 5000, 1_183_514):
            assert p._cap_value(n) == j._cap_value(n)


@pytest.mark.parametrize("lam", [0.0, 1.0, 4.0])
def test_soar_select_matches_jax(lam):
    """The SOAR secondary: argmin over the r nearest centers (primary
    excluded) of |r2|^2 + lam <r2, r1_hat>^2, first minimum on ties."""
    x, _ = _skewed(3, n=1500)
    _, p, tokens = _pair(x, 32)
    centers = p.centers.numpy()
    want = np.asarray(jtp.soar_select_kernel(
        jnp.asarray(centers), jnp.asarray(x), jnp.asarray(tokens),
        jnp.float32(lam), r=8))
    got = ptp.soar_select(p.centers, torch.from_numpy(x),
                          torch.from_numpy(tokens).long(), lam, r=8).numpy()
    assert np.mean(got == want) >= 0.998
    assert (got != tokens).all()


def test_spill_pairs_and_cap_secondaries_match_jax():
    x, _ = _skewed(4, n=2000)
    j, p, tokens = _pair(x, 32, max_partition_size=90)
    xt = torch.from_numpy(x)
    want = j._spill_pairs(x, tokens, 0.3)
    got = p._spill_pairs(xt, 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    want = j._spill_pairs_soar(jnp.asarray(x), tokens, 1.0, 8)
    got = p._spill_pairs_soar(xt, torch.from_numpy(tokens).long(), 1.0,
                              8).numpy()
    assert np.mean(got == want) >= 0.998
    capped = p._cap_secondaries(want.astype(np.int64), tokens, len(x))
    np.testing.assert_array_equal(
        capped, j._cap_secondaries(want.astype(np.int64), tokens, len(x)))
    prim = np.bincount(tokens, minlength=32)
    sec = np.bincount(capped[:, 1], minlength=32)
    assert (prim + sec <= np.maximum(2 * p._cap_value(len(x)), prim)).all()


def test_tokenization_with_extra_pairs_matches_jax():
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 9, size=200)
    extra = np.stack([rng.choice(200, 60, replace=False),
                      rng.integers(0, 9, size=60)], axis=1)
    want = JaxTokenization(tokens, 9, extra_pairs=extra)
    got = DatabaseTokenization(torch.from_numpy(tokens), 9,
                               extra_pairs=torch.from_numpy(extra))
    for name in ("offsets", "point_indices", "partition_sizes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name))
    assert got.max_multiplicity == want.max_multiplicity == 2
    back = DatabaseTokenization.from_csr(got.tokens, got.offsets,
                                         got.point_indices)
    np.testing.assert_array_equal(back.partition_sizes.numpy(),
                                  want.partition_sizes)
    assert back.max_multiplicity == 2


@pytest.fixture(scope="module")
def soar_builds():
    """A balanced SOAR index built by each package from the same data
    (different k-means random bits), with queries and ground truth."""
    x, rng = _skewed(6, n=4000, d=32, clusters=16)
    q = (x[rng.choice(len(x), 64, replace=False)]
         + 0.5 * rng.normal(size=(64, 32))).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    hc = dict(num_codes=16, num_subspaces=8, seed=3, max_iterations=8,
              training_sample_size=2000)
    common = dict(num_partitions=40, partitions_to_search=4,
                  spilling=True, spilling_mode="soar", score_l_tile=128)
    jax_s = JaxSearcher(JaxConfig(hash_config=JaxHashConfig(**hc),
                                  **common)).build(JaxDataset(x))
    port = TreeXHybridSearcher(TreeXHybridConfig(
        hash_config=AsymmetricHasherConfig(**hc), **common),
        device="cpu").build(DenseDataset(x))
    return x, q, gt, jax_s, port


def test_soar_build_invariants(soar_builds):
    """Balanced to the cap (at most 2 * cap with secondaries), one
    secondary per point in another partition than its primary (some
    dropped by the secondary cap), codes per assignment."""
    x, _, _, _, port = soar_builds
    tp = port.partitioner
    tk = tp.tokenization
    cap = tp._cap_value(len(x))
    assert cap == int(1.5 * len(x) / 40)
    prim = torch.bincount(tk.tokens, minlength=tk.num_partitions)
    assert int(prim.max()) <= cap
    assert tk.max_partition_size <= 2 * cap
    assert tk.max_multiplicity == 2
    m = len(tk.point_indices)
    assert len(x) < m <= 2 * len(x)
    row_tok = torch.repeat_interleave(torch.arange(tk.num_partitions),
                                      tk.partition_sizes)
    pts = tk.point_indices
    secondary = row_tok != tk.tokens[pts]
    assert int(secondary.sum()) == m - len(x)
    assert len(torch.unique(pts[secondary])) == m - len(x)
    assert port.codes.shape == (m, 8)
    assert tp.num_partitions >= 40


def test_soar_build_recall_close_to_jax(soar_builds):
    """recall@10 of the two builds within 0.03 of each other (the k-means
    random bits differ). Balancing pads K to 256, so p=16 of 256."""
    _, q, gt, jax_s, port = soar_builds
    want, _ = jax_s.search_batched_arrays(q, 10, JaxParams(
        num_leaves_to_search=16, pre_reordering_num_neighbors=100))
    got, _ = port.search_batched_arrays(q, 10, SearchParameters(
        num_leaves_to_search=16, pre_reordering_num_neighbors=100))
    r_jax, r_port = recall_at_k(want, gt), recall_at_k(got, gt)
    assert r_port >= 0.9, (r_port, r_jax)
    assert abs(r_port - r_jax) <= 0.03, (r_port, r_jax)

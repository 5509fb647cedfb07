"""The partitioned searcher, the partitioner's query API and hierarchical
(k-means tree) partitioning of the PyTorch port against the JAX package on
the CPU. Index state crosses through ``scann_tpu.io.save_index`` and the
port's loader, so no comparison rests on two k-means runs agreeing.

Tolerances:
  - search over a carried index: ids equal for every query without a tie
    at the k-th distance (the port selects lower index first, the JAX
    package's selection on the CPU also does, but the two float32
    distances of a near tie may round apart), distances within 1e-5
    relative (the same float32 arithmetic in another summation order);
  - partition selection: tokens equal for every query without a tie at
    the p-th centroid distance, distances within 1e-5 relative;
  - the measure-dependent build steps (cap demotion, distance spilling)
    from equal centres: at least 99.5% of the tokens equal (top-r choices
    of near-equal centres may round apart), as
    ``test_torch_partitioning.py`` holds them under squared L2;
  - hierarchical builds draw other random bits (``torch.Generator``
    against ``jax.random``): recall@10 within 0.02 of the JAX build's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.io import load_index as jax_load_index
from scann_tpu.io import save_index
from scann_tpu.models.partitioned import PartitionedSearcher as JaxSearcher
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.partitioning import tree_partitioner as jtp
import scann_tpu_torch as T
from scann_tpu_torch import io as tio
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.partitioning import tree_partitioner as ptp
from scann_tpu_torch.trees.kmeans_tree import (
    KMeansTree,
    KMeansTreeConfig,
    KMeansTreeNode,
)
from scann_tpu_torch.utils.benchmarking import recall_at_k

N, D, B, K, NP, P = 3000, 32, 32, 10, 32, 4
# every measure the exact gathered scoring serves (HAMMING, LIMITED_INNER_
# PRODUCT and NON_ZERO_INTERSECT have none in either package)
DENSE = ["SQUARED_L2", "L2", "L1", "COSINE", "DOT_PRODUCT",
         "GENERAL_INNER_PRODUCT", "JACCARD", "DICE"]
RTOL = 1e-5


def _clustered(seed, n=N, d=D, clusters=24, b=B):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, clusters, n)]
         + rng.normal(size=(n, d))).astype(np.float32)
    q = (centers[rng.integers(0, clusters, b)]
         + rng.normal(size=(b, d))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def data():
    return _clustered(0)


@pytest.fixture(scope="module")
def flat(data):
    """A flat JAX partitioner over the data (32 partitions, no balancing),
    shared by the per-measure searchers: k-means trains in squared L2
    under every measure, the measure selects partitions at search."""
    x, _ = data
    return jtp.TreePartitioner(jtp.TreePartitionerConfig(
        num_partitions=NP, seed=0, max_iterations=10)).build(JaxDataset(x))


def _carry(jax_searcher, tmp_path):
    """The port's searcher over the JAX searcher's saved state."""
    path = str(tmp_path / "index.npz")
    save_index(path, jax_searcher)
    return tio.load_index(path, device="cpu")


def _kth_tie(dists_row, k):
    """Does the row's k-th smallest value tie (to 1e-6 relative) with the
    next one?"""
    s = np.sort(dists_row[np.isfinite(dists_row)])
    return len(s) > k and abs(s[k] - s[k - 1]) <= 1e-6 * max(abs(s[k]), 1)


def _assert_same(got, want, all_dists=None, k=K):
    """ids equal away from k-th distance ties, distances within RTOL."""
    gi, gd = got
    wi, wd = want
    assert gi.shape == wi.shape and gd.shape == wd.shape
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=RTOL, atol=1e-5)
    for row in range(len(gi)):
        if all_dists is not None and _kth_tie(all_dists[row], k):
            continue
        np.testing.assert_array_equal(gi[row], wi[row])


@pytest.mark.parametrize("measure", DENSE)
def test_search_matches_jax_in_every_dense_measure(measure, data, flat,
                                                   tmp_path):
    x, q = data
    js = JaxSearcher(JaxDataset(x), partitioner=flat,
                     num_partitions_to_search=P,
                     distance_measure=JaxMeasure[measure])
    ps = _carry(js, tmp_path)
    assert isinstance(ps, T.PartitionedSearcher)
    assert ps.distance_measure == T.DistanceMeasure[measure]
    _assert_same(ps.search_batched_arrays(q, K),
                 js.search_batched_arrays(q, K))
    params = (T.SearchParameters(num_leaves_to_search=NP),
              JaxParams(num_leaves_to_search=NP))
    _assert_same(ps.search_batched_arrays(q, K, params[0]),
                 js.search_batched_arrays(q, K, params[1]))


@pytest.mark.parametrize("mode,measure", [
    ("distance", "SQUARED_L2"), ("soar", "SQUARED_L2"),
    ("distance", "COSINE")])
def test_spilled_search_matches_jax(mode, measure, data, tmp_path):
    """Spilled CSR tables (a point in several leaves): the over-fetch and
    dedup selection; a balanced COSINE build takes the measure through
    its cap and spilling."""
    x, q = data
    tp = jtp.TreePartitioner(jtp.TreePartitionerConfig(
        num_partitions=NP, seed=1, max_iterations=8, spilling=True,
        spilling_mode=mode, spilling_threshold=0.3,
        max_partition_size="auto" if measure != "SQUARED_L2" else None,
        distance_measure=JaxMeasure[measure])).build(JaxDataset(x))
    js = JaxSearcher(JaxDataset(x), partitioner=tp,
                     num_partitions_to_search=P,
                     distance_measure=JaxMeasure[measure])
    ps = _carry(js, tmp_path)
    assert ps.partitioner.tokenization.max_multiplicity == \
        tp.tokenization.max_multiplicity > 1
    got = ps.search_batched_arrays(q, K)
    _assert_same(got, js.search_batched_arrays(q, K))
    ids = got[0]
    for row in ids:
        real = row[row >= 0]
        assert len(np.unique(real)) == len(real)


@pytest.mark.parametrize("measure", ["DOT_PRODUCT", "L1", "COSINE"])
def test_measure_dependent_build_steps_match_jax(measure, data):
    """Cap demotion and distance spilling choose centres in the configured
    measure: from equal centres and tokens both packages pick the same."""
    x, _ = data
    rng = np.random.default_rng(3)
    centers = x[rng.choice(len(x), NP, replace=False)].copy()
    cfg = dict(num_partitions=NP, seed=7, cap_enforce_choices=6)
    j = jtp.TreePartitioner(jtp.TreePartitionerConfig(
        distance_measure=JaxMeasure[measure], **cfg))
    j.centers = centers.copy()
    j._centers_dev = jnp.asarray(centers)
    p = ptp.TreePartitioner(ptp.TreePartitionerConfig(
        distance_measure=T.DistanceMeasure[measure], **cfg), device="cpu")
    p.centers = torch.from_numpy(centers.copy())
    tokens = ((x[:, None] - centers[None]) ** 2).sum(-1).argmin(1).astype(
        np.int32)
    cap = 80
    want = j._enforce_cap(jnp.asarray(x), tokens, cap)
    got = p._enforce_cap(torch.from_numpy(x), tokens, cap)
    assert np.mean(got == want) >= 0.995
    # distance spilling keeps d2 <= d1 * (1 + threshold); under the negated
    # dot product (d1 < 0) a threshold below 0 admits the near seconds
    thr = -0.3 if measure == "DOT_PRODUCT" else 0.3
    want = j._spill_pairs(x, tokens, thr)
    got = p._spill_pairs(torch.from_numpy(x), thr).numpy()
    assert len(got) == len(want) > 0
    assert np.mean(got == want) >= 0.995


def test_epsilon_matches_jax(data, flat, tmp_path):
    x, q = data
    js = JaxSearcher(JaxDataset(x), partitioner=flat,
                     num_partitions_to_search=P)
    ps = _carry(js, tmp_path)
    _, d = js.search_batched_arrays(q, K)
    eps = float(np.median(d))
    for pre, post in ((eps, None), (None, eps), (2 * eps, eps)):
        got = ps.search_batched_arrays(q, K, T.SearchParameters(
            pre_reordering_epsilon=pre, post_reordering_epsilon=post))
        want = js.search_batched_arrays(q, K, JaxParams(
            pre_reordering_epsilon=pre, post_reordering_epsilon=post))
        _assert_same(got, want)
        kept = got[0] >= 0
        assert kept.any() and (~kept).any()
        assert (got[1][kept] <= eps).all()


def test_k_beyond_candidate_ceiling_pads_like_jax(tmp_path):
    """p * leaf_cap below k (``tests/test_epsilon_semantics.py:233-247``):
    the [B, k] contract is kept with (-1, inf) slots, where JAX puts them."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2000, 8)).astype(np.float32)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    js = JaxSearcher(JaxDataset(x), num_partitions_to_search=2)
    ps = _carry(js, tmp_path)
    k = 400
    got = ps.search_batched_arrays(q, k)
    want = js.search_batched_arrays(q, k)
    assert got[0].shape == (4, k) and (got[0][:, 0] >= 0).all()
    assert (got[0] < 0).any()
    assert np.isinf(got[1][got[0] < 0]).all()
    np.testing.assert_array_equal(got[0] < 0, want[0] < 0)
    _assert_same(got, want, k=k)
    ids, dists = ps.search_batched_tensors(torch.from_numpy(q), k)
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (4, k)


def test_partition_api_matches_jax(data, flat, tmp_path):
    """partition_batch / partition (tokens equal away from ties at the
    p-th distance), padded_leaves, partition_lists, sizes, centroids,
    indices; an unbuilt partitioner raises."""
    x, q = data
    js = JaxSearcher(JaxDataset(x), partitioner=flat,
                     num_partitions_to_search=P,
                     distance_measure=JaxMeasure.DOT_PRODUCT)
    tp = _carry(js, tmp_path).partitioner
    # both loaders give the partitioner the searcher's measure
    jax_tp = jax_load_index(str(tmp_path / "index.npz")).partitioner
    want = jax_tp.partition_batch(q, P)
    got = tp.partition_batch(q, P)
    cd = -(q @ flat.centers.T)
    for row, (g, w) in enumerate(zip(got, want)):
        assert g.tokens.dtype == np.int32 and g.distances.dtype == np.float32
        np.testing.assert_allclose(g.distances, w.distances, rtol=RTOL,
                                   atol=1e-5)
        if not _kth_tie(cd[row], P):
            np.testing.assert_array_equal(g.tokens, w.tokens)
    one = tp.partition(q[3], P)
    np.testing.assert_array_equal(one.tokens, got[3].tokens)
    assert one.top_token() == int(got[3].tokens[0])
    tk, jtk = tp.tokenization, flat.tokenization
    for mult in (8, 32):
        np.testing.assert_array_equal(tk.padded_leaves(mult).numpy(),
                                      np.asarray(jtk.padded_leaves(mult)))
    assert tk.padded_leaves(8) is tk.padded_leaves(8)
    for a, b in zip(tk.partition_lists(), jtk.partition_lists()):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tp.partition_sizes().numpy(),
                                  flat.partition_sizes())
    np.testing.assert_array_equal(tp.partition_centroid(5).numpy(),
                                  flat.partition_centroid(5))
    np.testing.assert_array_equal(tp.partition_indices(5).numpy(),
                                  flat.partition_indices(5))
    np.testing.assert_array_equal(tp.centers_device().numpy(), flat.centers)
    empty = ptp.TreePartitioner(device="cpu")
    for call in (lambda: empty.partition_sizes(),
                 lambda: empty.partition_batch(q, 2),
                 lambda: empty.centers_device()):
        with pytest.raises(ScannError):
            call()
    with pytest.raises(ScannError):
        tp.partition_batch(q, 0)


def test_port_build_under_every_dense_measure_serves(data):
    """The port's own build no longer refuses a measure: a balanced
    partitioned searcher per measure returns each query's own row first."""
    x, _ = data
    for measure in ("L1", "COSINE", "DOT_PRODUCT"):
        s = T.PartitionedSearcher(
            T.DenseDataset(x), config=ptp.TreePartitionerConfig(
                num_partitions=16, max_iterations=5,
                max_partition_size="auto"),
            num_partitions_to_search=16,
            distance_measure=T.DistanceMeasure[measure], device="cpu")
        assert s.partitioner.config.distance_measure.name == measure
        idx, _ = s.search_batched_arrays(x[:8], 3)
        if measure != "DOT_PRODUCT":
            np.testing.assert_array_equal(idx[:, 0], np.arange(8))
        assert (idx >= 0).all()


# -- hierarchical partitioning ----------------------------------------------


def _port_node(jnode):
    """The port's copy of a JAX tree node (centres, leaf points, ids)."""
    node = KMeansTreeNode(torch.from_numpy(np.asarray(jnode.center)),
                          jnode.depth)
    node.leaf_id = jnode.leaf_id
    if jnode.indices is not None:
        node.indices = torch.from_numpy(np.asarray(jnode.indices)).long()
    node.children = [_port_node(c) for c in jnode.children]
    return node


def _port_tree(jtree):
    tree = KMeansTree(KMeansTreeConfig(**vars(jtree.config)), device="cpu")
    tree.root = _port_node(jtree.root)
    leaves = []

    def walk(n):
        if n.is_leaf:
            leaves.append(n)
        for c in n.children:
            walk(c)

    walk(tree.root)
    tree._leaves = sorted(leaves, key=lambda n: n.leaf_id)
    tree.num_leaves = len(leaves)
    return tree


@pytest.fixture(scope="module")
def jax_hierarchical(data):
    """A JAX partitioned searcher over a two-level 16-leaf tree (fan-out
    4); its tree also serves the node-level comparisons."""
    x, _ = data
    return JaxSearcher(JaxDataset(x), config=jtp.TreePartitionerConfig(
        num_partitions=16, num_levels=2, max_iterations=8),
        num_partitions_to_search=4)


def test_kmeans_tree_search_matches_jax_on_its_nodes(data, jax_hierarchical):
    """A JAX tree's nodes carried across: equal leaf assignments, leaf
    centres, best-first leaves and candidates."""
    x, q = data
    jt = jax_hierarchical.partitioner.tree
    pt = _port_tree(jt)
    assert pt.num_leaves == jt.num_leaves
    np.testing.assert_array_equal(pt.leaf_assignments(N).numpy(),
                                  jt.leaf_assignments(N))
    np.testing.assert_array_equal(pt.leaf_centers().numpy(),
                                  jt.leaf_centers())
    for qq in q[:8]:
        for nl in (0, 1, 5, 40):
            assert pt.search_leaves(qq, nl) == jt.search_leaves(qq, nl)
        for kk in (0, 10, 400):
            np.testing.assert_array_equal(
                pt.search_candidates(qq, kk).numpy(),
                jt.search_candidates(qq, kk))
    with pytest.raises(ScannError):
        KMeansTree(device="cpu").search_leaves(q[0], 3)


@pytest.mark.parametrize("levels", [2, 3])
def test_hierarchical_build_follows_the_jax_rules(levels, data):
    """Fan-out ceil(k ** (1 / levels)), at least 2; leaves in build order
    are the partitions; a node stops at max depth or at <= fan points."""
    x, _ = data
    k = 64
    tp = ptp.TreePartitioner(ptp.TreePartitionerConfig(
        num_partitions=k, num_levels=levels, max_iterations=5, seed=2),
        device="cpu").build(torch.from_numpy(x))
    fan = max(int(np.ceil(k ** (1.0 / levels))), 2)
    tree = tp.tree
    assert tree.config.num_children == fan and tree.config.max_depth == levels
    assert tp.num_partitions == tree.num_leaves <= fan ** levels
    for i, leaf in enumerate(tree.leaves()):
        assert leaf.leaf_id == i
        assert leaf.depth == levels or len(leaf.indices) <= fan
    np.testing.assert_array_equal(tp.centers.numpy(),
                                  tree.leaf_centers().numpy())
    tk = tp.tokenization
    assert int(tk.partition_sizes.sum()) == N and int(tk.tokens.min()) >= 0
    for t in range(tk.num_partitions):
        np.testing.assert_array_equal(
            np.sort(tk.partition_indices(t).numpy()),
            np.sort(tree.leaves()[t].indices.numpy()))


def test_hierarchical_recall_close_to_jax(data, jax_hierarchical):
    """Both packages build a two-level 16-leaf partitioned searcher on the
    same clustered data (other random bits); recall@10 at p=4 within
    0.02."""
    x, q = data
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :K]
    ps = T.PartitionedSearcher(
        T.DenseDataset(x), config=ptp.TreePartitionerConfig(
            num_partitions=16, num_levels=2, max_iterations=8),
        num_partitions_to_search=4, device="cpu")
    assert ps.partitioner.num_partitions == \
        jax_hierarchical.partitioner.num_partitions
    r_jax = recall_at_k(jax_hierarchical.search_batched_arrays(q, K)[0],
                        gt, K)
    r_port = recall_at_k(ps.search_batched_arrays(q, K)[0], gt, K)
    assert abs(r_port - r_jax) <= 0.02, (r_port, r_jax)
    assert r_port >= 0.9

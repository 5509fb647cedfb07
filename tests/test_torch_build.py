"""Index build of the PyTorch port against the JAX package: Lloyd's from the
same initial centers, the PQ encode and LUT kernels on the same codebook,
seeded k-means quality, and end-to-end recall of the two builds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.codebook import encode_kernel as jax_encode
from scann_tpu.hashes.codebook import lut_kernel as jax_lut
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import (
    TreeXHybridConfig as JaxConfig,
    TreeXHybridSearcher as JaxSearcher,
)
from scann_tpu.trees.kmeans import KMeans as JaxKMeans
from scann_tpu.trees.kmeans import KMeansConfig as JaxKMeansConfig
from scann_tpu.trees.kmeans import KMeansInit as JaxInit
from scann_tpu_torch import (
    AsymmetricHasherConfig,
    DenseDataset,
    SearchParameters,
    TreeXHybridConfig,
    TreeXHybridSearcher,
)
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.hashes.codebook import encode_kernel, lut_kernel
from scann_tpu_torch.partitioning.tree_partitioner import (
    TreePartitioner,
    TreePartitionerConfig,
)
from scann_tpu_torch.trees.kmeans import KMeans, KMeansConfig, KMeansInit
from scann_tpu_torch.utils.benchmarking import recall_at_k


def _clustered(seed, n=2000, d=32, clusters=8, spread=3.0, noise=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * spread
    x = centers[rng.integers(0, clusters, n)] + noise * rng.normal(
        size=(n, d)).astype(np.float32)
    return x.astype(np.float32), rng


@pytest.mark.parametrize("k,iters", [(8, 5), (16, 10)])
def test_lloyd_from_provided_init_matches_jax(k, iters):
    """Same data, same initial centers: the same assignment and update
    arithmetic (float32 distances, per-cluster sums of bf16-rounded rows)
    gives the same centers up to float32 summation order."""
    x, rng = _clustered(k)
    init = x[rng.choice(len(x), k, replace=False)]
    jax_res = JaxKMeans(JaxKMeansConfig(
        num_clusters=k, max_iterations=iters,
        init_method=JaxInit.PROVIDED)).fit(x, init_centers=init)
    res = KMeans(KMeansConfig(
        num_clusters=k, max_iterations=iters,
        init_method=KMeansInit.PROVIDED), device="cpu").fit(
            x, init_centers=init)
    assert res.num_iterations == jax_res.num_iterations
    np.testing.assert_allclose(res.centers.numpy(), jax_res.centers,
                               atol=1e-4)
    np.testing.assert_array_equal(res.assignments.numpy(),
                                  jax_res.assignments)
    np.testing.assert_allclose(res.inertia, jax_res.inertia, rtol=1e-4)


@pytest.mark.parametrize("s,c", [(8, 16), (16, 16), (4, 256)])
def test_encode_and_lut_kernels_match_jax(s, c):
    """Given one codebook, codes must be identical and LUTs equal to
    float32 rounding (both take squared distances as
    |q|^2 + |c|^2 - 2 q.c in float32)."""
    rng = np.random.default_rng(s * c)
    d = 32
    codebook = rng.normal(size=(s, c, d // s)).astype(np.float32)
    data = rng.normal(size=(1500, d)).astype(np.float32)
    queries = rng.normal(size=(16, d)).astype(np.float32)
    want_codes = np.asarray(jax_encode(jnp.asarray(data),
                                       jnp.asarray(codebook)))
    got_codes = encode_kernel(torch.from_numpy(data),
                              torch.from_numpy(codebook), chunk_size=512)
    np.testing.assert_array_equal(got_codes.numpy(), want_codes)
    want_lut = np.asarray(jax_lut(jnp.asarray(queries),
                                  jnp.asarray(codebook)))
    got_lut = lut_kernel(torch.from_numpy(queries),
                         torch.from_numpy(codebook))
    # near-zero entries lose their relative precision to the cancellation
    # in that form: allow 1e-5 absolute, a few float32 ulps of |q|^2
    np.testing.assert_allclose(got_lut.numpy(), want_lut, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_kmeans_inertia_close_to_jax(seed):
    """k-means++ draws other random bits than jax.random with the same
    seed, so the two runs are held to quality: inertia within 5%. Tight
    clusters make k-means++ find every cluster on both sides."""
    x, _ = _clustered(100 + seed, clusters=12, noise=0.1)
    cfg = dict(num_clusters=12, max_iterations=20, seed=seed)
    jax_res = JaxKMeans(JaxKMeansConfig(**cfg)).fit(x)
    res = KMeans(KMeansConfig(**cfg), device="cpu").fit(x)
    assert abs(res.inertia - jax_res.inertia) <= 0.05 * jax_res.inertia
    assert res.cluster_sizes.sum() == len(x)


def test_random_init_above_pp_limit_and_reseed():
    """k > KMEANS_PP_MAX_K takes random init; with more clusters than
    distinct points, empty clusters are reseeded and k-means still
    returns k centers covering every point."""
    x, _ = _clustered(3, n=600, d=8)
    res = KMeans(KMeansConfig(num_clusters=300, max_iterations=3,
                              seed=0), device="cpu").fit(x)
    assert res.centers.shape == (300, 8)
    assert int(res.cluster_sizes.sum()) == 600
    assert torch.isfinite(res.centers).all()


def test_partitioner_tokenization_is_csr_of_nearest_centers():
    x, _ = _clustered(4, n=1500)
    tp = TreePartitioner(TreePartitionerConfig(
        num_partitions=10, seed=1, training_sample_size=700),
        device="cpu").build(torch.from_numpy(x))
    tk = tp.tokenization
    d = ((x[:, None, :] - tp.centers.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(tk.tokens.numpy(), d.argmin(1))
    assert int(tk.offsets[-1]) == len(x)
    for t in range(tk.num_partitions):
        pts = tk.partition_indices(t).numpy()
        assert np.all(tk.tokens.numpy()[pts] == t)
        assert np.all(np.diff(pts) > 0)            # stable sort by token


@pytest.mark.parametrize("config,error", [
    (dict(partition_num_levels=2), NotImplementedError),
    (dict(partition_num_levels=3), NotImplementedError),
    (dict(rerank_dtype="float16"), ScannError),
    (dict(rerank_layout="rows"), ScannError),
    (dict(spilling=True, spilling_mode="nearest"), ScannError),
], ids=[f"config{i}" for i in range(5)])
def test_unported_options_raise(config, error):
    """What the port does not serve raises when the searcher is made:
    hierarchical trees name their ROADMAP item; values the JAX package has
    no meaning for are invalid arguments. (Balancing, spilling, the
    low-precision stores and the csr layout are served: the tests of
    ``test_torch_partitioning.py`` and ``test_torch_tree_x_hybrid.py``.)"""
    with pytest.raises(error, match="ROADMAP" if error is
                       NotImplementedError else "must be"):
        TreeXHybridSearcher(TreeXHybridConfig(**config), device="cpu")


def test_build_recall_close_to_jax_build():
    """Both packages build from the same data (different random bits);
    recall@10 against exact ground truth must agree within 0.02."""
    x, rng = _clustered(5, clusters=24, spread=3.0)
    centers_q = x[rng.choice(len(x), 256, replace=False)]
    q = (centers_q + 0.5 * rng.normal(size=centers_q.shape)).astype(
        np.float32)
    gt = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    hc = dict(num_codes=16, num_subspaces=8, seed=3, max_iterations=10,
              training_sample_size=1000)
    common = dict(num_partitions=16, partitions_to_search=3,
                  max_partition_size=None, score_l_tile=128)
    jax_s = JaxSearcher(JaxConfig(hash_config=JaxHashConfig(**hc),
                                  **common)).build(JaxDataset(x))
    s = TreeXHybridSearcher(TreeXHybridConfig(
        hash_config=AsymmetricHasherConfig(**hc), **common),
        device="cpu").build(DenseDataset(x))
    # pre_k=50 keeps recall off its ceiling, where a build difference shows
    jax_idx, _ = jax_s.search_batched_arrays(q, 10, JaxParams(
        num_leaves_to_search=3, pre_reordering_num_neighbors=50))
    idx, dists = s.search_batched_arrays(q, 10, SearchParameters(
        num_leaves_to_search=3, pre_reordering_num_neighbors=50))
    jax_recall = recall_at_k(jax_idx, gt)
    recall = recall_at_k(idx, gt)
    assert recall >= 0.85
    assert abs(recall - jax_recall) <= 0.02, (recall, jax_recall)
    assert s.codes.dtype == torch.uint8 and s.codes.shape == (len(x), 8)

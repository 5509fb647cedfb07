"""Tree-x-AH search of the PyTorch port against the JAX package on one
index: the JAX package builds and saves it, the port loads the file and
serves it. The JAX grouped serving program (Pallas kernel in interpret mode)
and the JAX searcher's CPU path are the references."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.io import load_index as jax_load_index
from scann_tpu.io import save_index
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import (
    TreeXHybridConfig as JaxConfig,
    TreeXHybridSearcher as JaxSearcher,
    tree_ah_grouped_kernel,
)
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
import scann_tpu_torch.io as tio
from scann_tpu_torch.models.searcher import SearchParameters

N, D, B, K, P = 2000, 32, 16, 10, 4


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """(path of the saved JAX index, queries)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 24, N)]
          + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 24, B)]
         + rng.normal(size=(B, D))).astype(np.float32)
    s = JaxSearcher(JaxConfig(
        num_partitions=16, partitions_to_search=P, score_l_tile=128,
        max_partition_size=None,
        hash_config=JaxHashConfig(num_codes=16, num_subspaces=8, seed=0,
                                  max_iterations=8))).build(JaxDataset(db))
    path = str(tmp_path_factory.mktemp("tree_ah") / "index.npz")
    save_index(path, s)
    return path, q


def _jax_grouped(path, q, *, pre_k, packed=True, q_cap=8):
    """The JAX grouped serving program over the saved index (interpret
    mode), with the TPU serving layout forced on this CPU instance."""
    s = jax_load_index(path)
    s._use_grouped_pallas = lambda: True
    s.config.pack_codes = packed
    _, codes_csr, off, sizes, perm, l_cap = s._csr_state()
    db, norms, n_valid = s._device_state()
    dists, idx = tree_ah_grouped_kernel(
        db, norms, s.partitioner.centers_device(), codes_csr, off, sizes,
        perm, s.codebook.centroids_device(), jnp.asarray(q),
        jnp.int32(n_valid), None, jnp.float32(np.inf), jnp.float32(np.inf),
        p=P, pre_k=pre_k, k=K, l_cap=l_cap, use_residuals=True,
        measure=JaxMeasure.SQUARED_L2, multiplicity=1, q_cap=q_cap,
        l_tile=s.config.score_l_tile, interpret=True, packed=packed,
        csr_store=False)
    return np.asarray(idx), np.asarray(dists), l_cap


def _port(path, q, *, pre_k, packed=True, q_cap=None, l_tile=None):
    s = tio.load_index(path, device="cpu")
    s.config.pack_codes = packed
    if q_cap is not None:
        s.config.group_q_cap = q_cap
    if l_tile is not None:
        s.config.score_l_tile = l_tile
    idx, dists = s.search_batched_arrays(q, K, SearchParameters(
        num_leaves_to_search=P, pre_reordering_num_neighbors=pre_k))
    return idx, dists, s._csr_state()[4]


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / K for x, y in zip(a, b)])


@pytest.mark.parametrize("packed", [True, False])
def test_full_rerank_matches_jax_grouped_exactly(index, packed):
    """pre_k = p*l_cap re-ranks every candidate, so bf16 ties in the leaf
    scores cannot change the result: ids must be identical and distances
    equal to float32 rounding."""
    path, q = index
    l_cap = _port(path, q[:1], pre_k=K, packed=packed)[2]
    want_i, want_d, jax_l_cap = _jax_grouped(path, q, pre_k=P * l_cap,
                                             packed=packed)
    assert l_cap == jax_l_cap
    got_i, got_d, _ = _port(path, q, pre_k=P * l_cap, packed=packed)
    assert got_i.dtype == np.int32 and got_d.dtype == np.float32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)


def test_short_rerank_overlaps_jax(index):
    """pre_k = 3k: bf16 ties at the pre_k boundary may pick other
    candidates (torch.topk and lax.top_k order ties differently), so ids
    need only overlap >= 0.98 with the JAX grouped program and with the JAX
    searcher's own CPU path (float32 leaf scores)."""
    path, q = index
    got_i, got_d, _ = _port(path, q, pre_k=3 * K)
    grouped_i, _, _ = _jax_grouped(path, q, pre_k=3 * K)
    assert _overlap(got_i, grouped_i) >= 0.98
    xla_i, _ = jax_load_index(path).search_batched_arrays(
        q, K, JaxParams(num_leaves_to_search=P,
                        pre_reordering_num_neighbors=3 * K))
    assert _overlap(got_i, xla_i) >= 0.98
    exact = ((q[:, None, :] - jax_load_index(path)._dataset.numpy()[got_i])
             ** 2).sum(-1)
    np.testing.assert_allclose(got_d, exact, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q_cap", [4, 8, 16])
@pytest.mark.parametrize("l_tile", [128, 256])
def test_results_invariant_to_kernel_shape(index, q_cap, l_tile):
    """q_cap and l_tile change how the scorer is tiled, never the result."""
    path, q = index
    base_i, base_d, _ = _port(path, q, pre_k=3 * K, q_cap=8, l_tile=128)
    got_i, got_d, l_cap = _port(path, q, pre_k=3 * K, q_cap=q_cap,
                                l_tile=l_tile)
    assert l_cap % l_tile == 0
    np.testing.assert_array_equal(got_i, base_i)
    np.testing.assert_array_equal(got_d, base_d)


def test_tensor_search_matches_array_search(index):
    path, q = index
    s = tio.load_index(path, device="cpu")
    params = SearchParameters(num_leaves_to_search=P,
                              pre_reordering_num_neighbors=3 * K)
    idx, dists = s.search_batched_tensors(torch.from_numpy(q), K, params)
    want_i, want_d = s.search_batched_arrays(q, K, params)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(dists.numpy(), want_d)


def test_post_epsilon_masks_far_results(index):
    """Results beyond post_reordering_epsilon come back as (-1, inf), as in
    the JAX package."""
    path, q = index
    s = tio.load_index(path, device="cpu")
    idx, dists = s.search_batched_arrays(q, K, SearchParameters(
        num_leaves_to_search=P, pre_reordering_num_neighbors=3 * K))
    eps = float(np.median(dists))
    e_idx, e_dists = s.search_batched_arrays(q, K, SearchParameters(
        num_leaves_to_search=P, pre_reordering_num_neighbors=3 * K,
        post_reordering_epsilon=eps))
    keep = dists <= eps
    np.testing.assert_array_equal(e_idx[keep], idx[keep])
    assert np.all(e_idx[~keep] == -1) and np.all(np.isinf(e_dists[~keep]))


def test_loader_rejects_unported_state(index):
    path, _ = index
    with np.load(path, allow_pickle=False) as z:
        import json

        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tio.from_numpy_state(arrays, dict(meta, measure="DotProduct"),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tio.from_numpy_state(arrays, dict(meta, rerank_dtype="int8"),
                             device="cpu")
    spilled = dict(arrays)
    spilled["csr_points"] = np.concatenate([arrays["csr_points"], [0]])
    spilled["csr_offsets"] = arrays["csr_offsets"].copy()
    spilled["csr_offsets"][-1] += 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tio.from_numpy_state(spilled, meta, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tio.from_numpy_state(arrays, dict(meta, kind="partitioned"),
                             device="cpu")
    s = tio.from_numpy_state(arrays, meta, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.search_batched_arrays(np.zeros((1, D), np.float32), K,
                                allow_mask=np.ones(N, bool))

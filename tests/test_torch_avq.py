"""Anisotropic vector quantization (AVQ) of the PyTorch port against the
JAX package's ``hashes/avq.py`` on the CPU, and its builds through the
codebook, the hasher, tree-x-AH and ``load_index``.

Tolerances:
  - ``anisotropic_eta``: exact (the same float64 formula);
  - ``avq_refine`` from equal initial centroids: codes equal on at least
    99.5% of the entries and the loss within 1e-3 relative (float32
    products and segment sums in another order move near-equal
    candidates; each code changes the next step's input, so a few
    differences carry forward);
  - ``avq_encode`` against equal fixed centroids: codes equal on at least
    99.9% (no feedback through centroid updates);
  - builds draw other random bits (k-means): the JAX test's MIPS recall
    gain (AVQ above plain PQ at equal bits, ``tests/test_avq.py:77-88``)
    must hold on the port's own builds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes import avq as javq
from scann_tpu.hashes.codebook import (
    Codebook as JaxCodebook,
    CodebookConfig as JaxCodebookConfig,
)
from scann_tpu.hashes.hasher import (
    AsymmetricHasher as JaxHasher,
    AsymmetricHasherConfig as JaxHashConfig,
)
from scann_tpu.io import save_index
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
import scann_tpu_torch as T
from scann_tpu_torch import io as tio
from scann_tpu_torch.hashes import avq as pavq
from scann_tpu_torch.hashes.codebook import Codebook, CodebookConfig

N, D, S, C = 4000, 32, 16, 16


@pytest.fixture(scope="module")
def heavy_tailed():
    """Rows with log-normal norms, where parallel quantization error moves
    inner-product rankings (the JAX test's data at this file's size)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x *= np.exp(rng.standard_normal((N, 1)) * 0.5).astype(np.float32)
    q = rng.standard_normal((128, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def start(heavy_tailed):
    """Plain PQ centroids from the JAX codebook: both packages refine from
    these."""
    x, _ = heavy_tailed
    cb = JaxCodebook(JaxCodebookConfig(num_codes=C, num_subspaces=S,
                                       max_iterations=10, seed=1)).train(x)
    return np.asarray(cb.centroids)


def _mips_recall(x, q, centroids, codes, k=10):
    rec = np.asarray(centroids)[np.arange(S), np.asarray(codes)].reshape(
        len(codes), D)
    true = np.argsort(-(q @ x.T), axis=1)[:, :k]
    approx = np.argsort(-(q @ rec.T), axis=1)[:, :k]
    return float(np.mean([len(set(a) & set(t)) / k
                          for a, t in zip(approx, true)]))


def test_eta_matches_jax():
    for t, d in ((0.2, 100), (0.5, 5), (0.2, 1), (0.9, 32), (0.05, 2)):
        assert pavq.anisotropic_eta(t, d) == javq.anisotropic_eta(t, d)
    for bad in (0.0, 1.0, -1.0):
        with pytest.raises(ValueError):
            pavq.anisotropic_eta(bad, 100)


def test_unit_directions_match_jax(heavy_tailed):
    x, _ = heavy_tailed
    x = x.copy()
    x[::97] = 0.0
    got = pavq.unit_directions(x).numpy()
    np.testing.assert_allclose(got, np.asarray(javq.unit_directions(x)),
                               rtol=1e-6, atol=1e-7)
    assert (got[::97] == 0).all()


def test_refine_lowers_the_loss_on_the_port(heavy_tailed, start):
    x, _ = heavy_tailed
    eta = pavq.anisotropic_eta(0.2, D)
    h = pavq.unit_directions(x)
    losses = [pavq.avq_refine(torch.from_numpy(x), h,
                              torch.from_numpy(start), eta, iters=i)[2]
              for i in (0, 3, 8)]
    assert losses[1] < losses[0]
    assert losses[2] <= losses[1] * 1.001


def test_zero_rows_stay_finite():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    x[::7] = 0.0
    cb = Codebook(CodebookConfig(num_codes=8, num_subspaces=4,
                                 max_iterations=5, seed=2,
                                 anisotropic_threshold=0.3),
                  device="cpu").train(x)
    assert torch.isfinite(cb.centroids).all()
    assert cb.eta == pavq.anisotropic_eta(0.3, 16)


def test_codebook_avq_beats_plain_pq_on_mips(heavy_tailed):
    """The deliverable of ``tests/test_avq.py:77-88`` on the port's own
    codebooks: at equal bits AVQ codes rank inner products better."""
    x, q = heavy_tailed
    cfg = dict(num_codes=C, num_subspaces=S, max_iterations=10, seed=1)
    avq = Codebook(CodebookConfig(anisotropic_threshold=0.2, **cfg),
                   device="cpu").train(x)
    plain = Codebook(CodebookConfig(**cfg), device="cpu").train(x)
    assert avq.eta is not None and avq.eta > 1.0 and plain.eta is None
    codes = avq.encode_dataset(torch.from_numpy(x))
    assert codes.shape == (N, S) and codes.dtype == torch.uint8
    r_avq = _mips_recall(x, q, avq.centroids.numpy(), codes.numpy())
    r_pq = _mips_recall(x, q, plain.centroids.numpy(),
                        plain.encode_dataset(torch.from_numpy(x)).numpy())
    assert r_avq > r_pq, (r_avq, r_pq)


def test_tree_x_ah_threads_original_directions(heavy_tailed):
    """Tree-x-AH with AVQ quantizes residuals weighted by the ORIGINAL
    points' directions: the codebook equals one trained on the residuals
    with the raw rows as directions, and the build serves."""
    x, q = heavy_tailed
    x, q = x[:2000], q[:32]
    cfg = T.TreeXHybridConfig(
        num_partitions=16, partitions_to_search=16, max_partition_size=None,
        distance_measure=T.DistanceMeasure.DOT_PRODUCT,
        hash_config=T.AsymmetricHasherConfig(
            num_codes=16, num_subspaces=S, seed=1, max_iterations=5,
            distance_measure=T.DistanceMeasure.DOT_PRODUCT,
            anisotropic_threshold=0.2))
    s = T.TreeXHybridSearcher(cfg, device="cpu").build(T.DenseDataset(x))
    tk = s.partitioner.tokenization
    pts = tk.point_indices
    rows = torch.from_numpy(x)[pts]
    toks = torch.repeat_interleave(torch.arange(tk.num_partitions),
                                   tk.partition_sizes)
    resid = rows - s.partitioner.centers[toks]
    ref = Codebook(CodebookConfig(num_codes=16, num_subspaces=S,
                                  max_iterations=5, seed=1,
                                  anisotropic_threshold=0.2),
                   device="cpu").train(resid, directions=rows)
    np.testing.assert_allclose(s.codebook.centroids.numpy(),
                               ref.centroids.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        s.codes.numpy(), ref.encode_dataset(resid, directions=rows).numpy())
    gt = np.argsort(-(q @ x.T), axis=1)[:, :10]
    idx, _ = s.search_batched_arrays(q, 10, T.SearchParameters(
        pre_reordering_num_neighbors=200))
    assert np.mean([len(set(a) & set(g)) / 10 for a, g in zip(idx, gt)]) \
        >= 0.9


@pytest.mark.parametrize("iters", [0, 3])
def test_refine_matches_jax(iters, heavy_tailed, start):
    x, _ = heavy_tailed
    eta = javq.anisotropic_eta(0.2, D)
    jc, jcodes, jloss = javq.avq_refine_kernel(
        jnp.asarray(x), javq.unit_directions(x), jnp.asarray(start), eta,
        iters=iters)
    pc, pcodes, ploss = pavq.avq_refine(
        torch.from_numpy(x), pavq.unit_directions(x),
        torch.from_numpy(start), eta, iters=iters)
    assert pcodes.shape == (N, S) and pcodes.dtype == torch.int64
    assert np.mean(pcodes.numpy() == np.asarray(jcodes)) >= 0.995
    assert ploss == pytest.approx(float(jloss), rel=1e-3)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("chunk", [8192, 1000])
def test_encode_matches_jax(chunk, heavy_tailed, start):
    """Against fixed centroids, whatever the chunking."""
    x, _ = heavy_tailed
    eta = javq.anisotropic_eta(0.2, D)
    want = np.asarray(javq.avq_encode_kernel(
        jnp.asarray(x), javq.unit_directions(x), jnp.asarray(start), eta,
        passes=2))
    got = pavq.avq_encode(torch.from_numpy(x), pavq.unit_directions(x),
                          torch.from_numpy(start), eta, passes=2,
                          chunk_size=chunk).numpy()
    assert np.mean(got == want) >= 0.999


def test_jax_avq_index_loads_with_eta(heavy_tailed, tmp_path):
    """A JAX AVQ hasher's file: the port gets eta back and serves the same
    results (the codes and the exact re-rank decide them)."""
    x, q = heavy_tailed
    x, q = x[:2000], q[:16]
    h = JaxHasher(JaxHashConfig(
        num_codes=C, num_subspaces=S, seed=1, max_iterations=5,
        distance_measure=JaxMeasure.DOT_PRODUCT,
        anisotropic_threshold=0.2)).build(JaxDataset(x))
    path = str(tmp_path / "avq.npz")
    save_index(path, h)
    p = tio.load_index(path, device="cpu")
    assert p.codebook.eta == pytest.approx(h.codebook.eta)
    assert p.codebook.config.anisotropic_threshold == 0.2
    np.testing.assert_array_equal(p.codes.numpy(), h.codes)
    gi, gd = p.search_batched_arrays(q, 10, T.SearchParameters(
        pre_reordering_num_neighbors=2000))
    wi, wd = h.search_batched_arrays(q, 10, JaxParams(
        pre_reordering_num_neighbors=2000))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    # re-encoding through the loaded codebook stays score-aware
    again = p.codebook.encode_dataset(torch.from_numpy(x))
    assert np.mean(again.numpy() == h.codes) >= 0.999

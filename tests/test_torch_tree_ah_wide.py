"""Tree-x-AH at the widths of today's text embeddings: 1536-d unit rows
by inner product, 768 subspaces of 16 codes (the benchmark's
dbpedia-openai-1000k-angular deployment, cut to a few thousand rows).

One group of 16 queries' bf16 tables is then larger than a block's shared
memory, so the q_cap the JAX package's rule gives is lowered by
``ops/tree_ah_grouped.fit_q_cap``; at the benchmark's other widths the
rule stands. The facade's answers are held against the benchmark's plain
reference (``portbench/reference/exact.py``) as its runs hold them, and a
JAX-built index of that width is served by both packages: the JAX grouped
program at the rule's q_cap 16 (Pallas kernel in interpret mode) and the
port at the fitted 8 give the same leaf scores and the same answers."""

import json
import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scann_tpu_torch as T
import scann_tpu_torch.io as tio
from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.io import _deserialize_index, save_index
from scann_tpu.models import tree_x_hybrid as jtx
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import (
    TreeXHybridConfig as JaxTreeXHybridConfig,
    TreeXHybridSearcher as JaxTreeXHybridSearcher,
)
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu_torch.models import tree_x_hybrid as ptx
from scann_tpu_torch.models.searcher import SearchParameters
from scann_tpu_torch.models.tree_x_hybrid import TreeXHybridSearcher
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.types import MASKED_DISTANCE
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.datagen import mixture  # noqa: E402
from portbench.reference.exact import (  # noqa: E402
    distances_of,
    exact_top_k,
)

DIM, ROWS, QUERIES, K = 1536, 3000, 64, 10
# the JAX-built index: 2,000 rows in 6 partitions, 2 probed
JAX_ROWS, JAX_P = 2000, 2


def _stub(subspaces, partitions):
    """An unbuilt port searcher with the index shape the rule reads."""
    s = TreeXHybridSearcher(device="cpu")
    s.partitioner = types.SimpleNamespace(num_partitions=partitions)
    s.codebook = types.SimpleNamespace(
        centroids=torch.zeros(subspaces, 16, 2), num_codes=16)
    return s


def _jax_rule(b, p, partitions):
    holder = types.SimpleNamespace(
        config=types.SimpleNamespace(group_q_cap=None),
        partitioner=types.SimpleNamespace(num_partitions=partitions))
    return JaxTreeXHybridSearcher.effective_q_cap(holder, b, p)


@pytest.mark.parametrize("subspaces", [50, 64])   # glove, sift
@pytest.mark.parametrize("b", [1024, 128])
@pytest.mark.parametrize("partitions", [2000, 2150])
def test_q_cap_of_the_benchmarks_narrow_cells_is_the_jax_rules(
        subspaces, b, partitions):
    got = _stub(subspaces, partitions).effective_q_cap(b, 100)
    assert got == _jax_rule(b, 100, partitions)


def test_q_cap_at_768_subspaces_is_lowered_to_fit():
    s = _stub(768, 2000)
    assert _jax_rule(1024, 100, 2000) == 16
    assert s.effective_q_cap(1024, 100) == 8
    # below the density threshold the rule's 8 already fits
    assert s.effective_q_cap(128, 100) == _jax_rule(128, 100, 2000) == 8
    # an explicit value is the caller's
    s.config.group_q_cap = 4
    assert s.effective_q_cap(1024, 100) == 4


@pytest.fixture(scope="module")
def wide():
    data = {"kind": "gaussian_mixture", "rows": ROWS, "dim": DIM,
            "clusters": 6, "spread": 2.5, "noise": 1.0, "normalize": True,
            "queries": QUERIES}
    rows, queries = mixture(data, 2147500123, torch.device("cpu"))
    cfg = T.ScannConfig.from_dict({
        "num_neighbors": K, "distance_measure": "DotProduct",
        # no balancing: the six partitions stay six, so 64 queries probing
        # two each are the rule's dense case
        "partitioning": {"num_partitions": 6, "num_partitions_to_search": 2,
                         "training_sample_size": ROWS,
                         "max_training_iterations": 10,
                         "max_partition_size": None},
        "hash": {"num_blocks": DIM // 2, "num_buckets": 16,
                 "anisotropic_threshold": 0.2},
        "exact_reordering": {"num_candidates": 100}})
    searcher = T.Scann(T.DenseDataset(rows.numpy()), cfg, device="cpu")
    assert searcher.search_mode == T.SearchMode.TREE_AH
    return rows, queries, searcher


def test_facade_at_1536_dims_against_the_exact_reference(wide):
    rows, queries, searcher = wide
    impl = searcher.impl
    assert impl.codebook.centroids.shape == (DIM // 2, 16, 2)
    assert impl._pack_codes()
    p = impl.config.partitions_to_search
    # the rule asks 16 queries a group (64 x 2 pairs over 6 partitions);
    # their bf16 tables would need 393,216 bytes
    assert _jax_rule(QUERIES, p, impl.partitioner.num_partitions) == 16
    assert impl.effective_q_cap(QUERIES, p) == 8
    ids, dists = searcher.search_batched_tensors(queries)

    want_ids, _ = exact_top_k(rows, queries, K, "DotProduct")
    hit = (ids[:, :, None] == want_ids[:, None, :]).any(-1).sum()
    recall = float(hit) / want_ids.numel()
    assert recall >= 0.9, recall
    assert bool((ids >= 0).all())
    exact, scale = distances_of(rows, queries, ids, "DotProduct")
    gap = ((dists.double() - exact).abs() / scale).max()
    assert float(gap) <= 1e-4, float(gap)


@pytest.fixture(scope="module")
def jax_wide(tmp_path_factory):
    """(JAX searcher, port searcher, queries) over one saved JAX index of
    1536-d unit rows: DotProduct, 768 subspaces of 16 codes, AVQ 0.2."""
    data = {"kind": "gaussian_mixture", "rows": JAX_ROWS, "dim": DIM,
            "clusters": 6, "spread": 2.5, "noise": 1.0, "normalize": True,
            "queries": QUERIES}
    rows, queries = mixture(data, 2147500123, torch.device("cpu"))
    built = JaxTreeXHybridSearcher(JaxTreeXHybridConfig(
        num_partitions=6, partitions_to_search=JAX_P, score_l_tile=128,
        max_partition_size=None, distance_measure=JaxMeasure.DOT_PRODUCT,
        hash_config=JaxHashConfig(num_codes=16, num_subspaces=DIM // 2,
                                  seed=0, max_iterations=8,
                                  anisotropic_threshold=0.2))).build(
                                      JaxDataset(rows.numpy()))
    path = str(tmp_path_factory.mktemp("wide") / "index.npz")
    save_index(path, built)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    jax_s = _deserialize_index(meta, arrays)
    # the JAX grouped serving program (the TPU layout) on this CPU
    jax_s._use_grouped_pallas = lambda: True
    port = tio.from_numpy_state(arrays, meta, device="cpu")
    assert jax_s.effective_q_cap(QUERIES, JAX_P) == 16
    assert port.effective_q_cap(QUERIES, JAX_P) == 8
    return jax_s, port, queries


def test_full_rerank_at_1536_dims_matches_jax_grouped_exactly(jax_wide):
    """pre_k = p*l_cap re-ranks every candidate of the probed partitions:
    a pair that the regrouping lost or scored against another partition's
    rows would change the ids."""
    jax_s, port, queries = jax_wide
    pre_k = JAX_P * port._csr_state()[4]
    want_i, want_d = jax_s.search_batched_arrays(
        queries.numpy(), K, JaxParams(num_leaves_to_search=JAX_P,
                                      pre_reordering_num_neighbors=pre_k))
    got_i, got_d = port.search_batched_arrays(
        queries.numpy(), K, SearchParameters(
            num_leaves_to_search=JAX_P, pre_reordering_num_neighbors=pre_k))
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)


def test_leaf_scores_at_1536_dims_match_jax_bit_for_bit(jax_wide):
    """Given the same float32 tables, the port's grouped scorer at q_cap 8
    and the JAX package's at 16 give the same bf16 leaf scores, masked
    slots included."""
    jax_s, port, queries = jax_wide
    _, codes_csr, off, sizes, _, l_cap = jax_s._csr_state()
    p_codes, p_off, p_sizes, _, p_l_cap = port._csr_state()
    np.testing.assert_array_equal(p_codes.numpy(), np.asarray(codes_csr))
    assert p_l_cap == l_cap
    cent = port.partitioner.centers
    measure = DistanceMeasure.DOT_PRODUCT
    parts = ptx._select_partitions(cent, queries, p=JAX_P, measure=measure)
    luts = ptx._residual_luts(queries, cent, parts, port.codebook.centroids,
                              s_pad=2 * p_codes.shape[0],
                              use_residuals=port.config.use_residuals,
                              measure=measure)
    want, _ = jtx.leaf_scores_grouped(
        jnp.asarray(luts.numpy()), jnp.asarray(parts.numpy().astype(np.int32)),
        codes_csr, off, sizes, p=JAX_P, l_cap=l_cap, q_cap=16, l_tile=128,
        interpret=True, packed=True)
    got = ptx.leaf_scores_grouped(luts, parts, p_codes, p_off, p_sizes,
                                  p=JAX_P, l_cap=l_cap, q_cap=8, l_tile=128,
                                  packed=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (want < MASKED_DISTANCE / 2).any()
    assert (want > MASKED_DISTANCE / 2).any()


def test_leaf_scores_from_the_per_query_source_match_jax_bit_for_bit(
        jax_wide):
    """The port's per-query source (one table a query, the partition term
    a bias on subspace 0) scored by its grouped path at q_cap 8 gives the
    bf16 leaf scores that the JAX package's own per-pair tables
    (``_residual_luts``) give its grouped scorer at 16, masked slots
    included."""
    jax_s, port, queries = jax_wide
    _, codes_csr, off, sizes, _, l_cap = jax_s._csr_state()
    p_codes, p_off, p_sizes, _, _ = port._csr_state()
    cent = port.partitioner.centers
    measure = DistanceMeasure.DOT_PRODUCT
    use_residuals = port.config.use_residuals
    assert use_residuals
    parts = ptx._select_partitions(cent, queries, p=JAX_P, measure=measure)
    src = ptx._lut_source(queries, cent, parts, port.codebook.centroids,
                          use_residuals=use_residuals, measure=measure)
    assert src.per_query and src.bias is not None
    j_parts = jnp.asarray(parts.numpy().astype(np.int32))
    j_luts = jtx._residual_luts(
        jnp.asarray(queries.numpy()), jnp.asarray(cent.numpy()), j_parts,
        jnp.asarray(port.codebook.centroids.numpy()),
        s_pad=2 * p_codes.shape[0], use_residuals=use_residuals,
        measure=JaxMeasure.DOT_PRODUCT)
    want, _ = jtx.leaf_scores_grouped(
        j_luts, j_parts, codes_csr, off, sizes, p=JAX_P, l_cap=l_cap,
        q_cap=16, l_tile=128, interpret=True, packed=True)
    got = ptx.leaf_scores_grouped(src, parts, p_codes, p_off, p_sizes,
                                  p=JAX_P, l_cap=l_cap, q_cap=8, l_tile=128,
                                  packed=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (want < MASKED_DISTANCE / 2).any()

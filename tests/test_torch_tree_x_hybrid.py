"""Tree-x-AH search of the PyTorch port against the JAX package on one
index: the JAX package builds and saves it, the port loads the file and
serves it. The JAX grouped serving program (Pallas kernel in interpret mode)
and the JAX searcher's CPU path are the references.

Beside the plain index: a balanced SOAR index (spilled CSR tables, K grown
by balancing) served with every re-rank dtype and layout and with
restricts, DOT_PRODUCT and COSINE indexes, the int8-LUT grouped path and
the per-pair path (``tree_ah_search``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.hasher import AsymmetricHasherConfig as JaxHashConfig
from scann_tpu.io import _deserialize_index
from scann_tpu.io import load_index as jax_load_index
from scann_tpu.io import save_index
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models import tree_x_hybrid as jtx
from scann_tpu.models.tree_x_hybrid import (
    TreeXHybridConfig as JaxConfig,
    TreeXHybridSearcher as JaxSearcher,
    tree_ah_grouped_kernel,
)
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
import scann_tpu_torch.io as tio
from scann_tpu_torch.models import tree_x_hybrid as ptx
from scann_tpu_torch.models.searcher import SearchParameters
from scann_tpu_torch.types import MASKED_DISTANCE as MASKED

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


def test_loader_rejects_unported_state(index, tmp_path):
    """What the port cannot serve yet (a sharded serving layout) still
    raises naming its ROADMAP item; the index's state read as a
    partitioned index, other measures, low-precision stores, spilled CSR
    tables and restricts load and serve."""
    path, q = index
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    sharded = str(tmp_path / "sharded.npz")
    np.savez_compressed(sharded, __meta__=np.frombuffer(json.dumps(
        dict(meta, sharded_kind="tree_ah")).encode(), dtype=np.uint8),
        **arrays)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tio.load_index(sharded, device="cpu")
    part = tio.from_numpy_state(arrays, dict(meta, kind="partitioned", p=P),
                                device="cpu")
    idx, dists = part.search_batched_arrays(q, K)
    db = arrays["data"]
    exact = ((q[:, None] - db[idx]) ** 2).sum(-1)
    np.testing.assert_allclose(dists, exact, rtol=1e-4, atol=1e-4)
    assert (idx >= 0).all()
    for m in (dict(measure="DotProduct"), dict(rerank_dtype="int8")):
        s = tio.from_numpy_state(arrays, dict(meta, **m), device="cpu")
        assert s.search_batched_arrays(q, K)[0].shape == (B, K)
    spilled = dict(arrays)
    spilled["csr_points"] = np.concatenate([arrays["csr_points"], [0]])
    spilled["csr_offsets"] = arrays["csr_offsets"].copy()
    spilled["csr_offsets"][-1] += 1
    spilled["codes"] = np.concatenate([arrays["codes"], arrays["codes"][:1]])
    s = tio.from_numpy_state(spilled, meta, device="cpu")
    assert s.partitioner.tokenization.max_multiplicity == 2
    idx, _ = s.search_batched_arrays(q, K, allow_mask=np.arange(N) < N // 2)
    assert (idx < N // 2).all()


def test_default_config_balances_like_jax():
    """The port's default config builds the JAX package's index: balanced
    to 1.5x the mean size, stragglers split."""
    cfg, jax_cfg = ptx.TreeXHybridConfig(), JaxConfig()
    for name in ("max_partition_size", "split_stragglers", "spilling",
                 "spilling_threshold", "spilling_mode", "soar_lambda",
                 "spill_dedup", "rerank_dtype", "rerank_layout",
                 "score_l_tile", "group_q_cap", "pack_codes"):
        assert getattr(cfg, name) == getattr(jax_cfg, name), name
    assert cfg.max_partition_size == "auto"


# -- the variants: a balanced SOAR index, other measures ---------------------

SN, SP = 3000, 12


def _clustered(seed, n, d=D, clusters=30):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 3
    db = (centers[rng.integers(0, clusters, n)]
          + rng.normal(size=(n, d))).astype(np.float32)
    q = (centers[rng.integers(0, clusters, B)]
         + rng.normal(size=(B, d))).astype(np.float32)
    return db, q


def _save(tmp_path_factory, name, db, **cfg):
    s = JaxSearcher(JaxConfig(
        num_partitions=24, partitions_to_search=SP, score_l_tile=128,
        hash_config=JaxHashConfig(num_codes=16, num_subspaces=8, seed=0,
                                  max_iterations=8), **cfg)).build(
                                      JaxDataset(db))
    path = str(tmp_path_factory.mktemp(name) / "index.npz")
    save_index(path, s)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return arrays, meta


@pytest.fixture(scope="module")
def soar(tmp_path_factory):
    """(arrays, meta, queries) of a JAX-saved SOAR index: balanced ("auto"
    cap), one SOAR secondary per point."""
    db, q = _clustered(1, SN)
    arrays, meta = _save(tmp_path_factory, "soar", db, spilling=True,
                         spilling_mode="soar")
    return arrays, meta, q


def _both(arrays, meta, **overrides):
    """The JAX searcher (its CPU path) and the port's, from one file."""
    meta = dict(meta, **overrides)
    return (_deserialize_index(meta, arrays),
            tio.from_numpy_state(arrays, meta, device="cpu"))


def _full(port, p=SP):
    """pre_k = every candidate of the probed partitions: the re-rank sees
    them all, so leaf-score rounding cannot change the result."""
    return p * port._csr_state()[4]


def _match(want, got, rtol=1e-5):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=rtol, atol=1e-5)


def test_soar_index_loads_with_its_spilled_tables(soar):
    arrays, meta, _ = soar
    jax_s, port = _both(arrays, meta)
    tk, jtk = port.partitioner.tokenization, jax_s.partitioner.tokenization
    assert tk.max_multiplicity == jtk.max_multiplicity == 2
    assert port.partitioner.num_partitions == len(arrays["centers"]) > 24
    np.testing.assert_array_equal(tk.partition_sizes.numpy(),
                                  jtk.partition_sizes)
    assert port._csr_state()[4] == jax_s._csr_state()[5]


@pytest.mark.parametrize("spill_dedup", [True, False])
def test_soar_search_matches_jax(soar, spill_dedup):
    """Full re-rank: ids equal, distances to float32 rounding, with the
    keep-best-per-id dedup before the gather or the legacy dedup after."""
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta)
    jax_s.config.spill_dedup = port.config.spill_dedup = spill_dedup
    pre_k = _full(port)
    params = dict(num_leaves_to_search=SP, pre_reordering_num_neighbors=pre_k)
    want = jax_s.search_batched_arrays(q, K, JaxParams(**params))
    got = port.search_batched_arrays(q, K, SearchParameters(**params))
    _match(want, got)
    assert (got[0] >= 0).all()
    for row in got[0]:
        assert len(set(row)) == K


def test_soar_short_rerank_overlaps_jax(soar):
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta)
    params = dict(num_leaves_to_search=SP, pre_reordering_num_neighbors=30)
    want, _ = jax_s.search_batched_arrays(q, K, JaxParams(**params))
    got, _ = port.search_batched_arrays(q, K, SearchParameters(**params))
    assert _overlap(got, want) >= 0.95


@pytest.mark.parametrize("layout", ["id", "csr"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int16"])
def test_rerank_stores_match_jax(soar, dtype, layout):
    """Every re-rank dtype in both layouts on the spilled index, against
    the single-device JAX searcher with the same explicit layout (its id
    layout keeps the anchored int8 / int16 codec's per-row primary token;
    its csr layout calibrates on primary residuals and encodes each CSR row
    against its own partition). The sharded JAX layout is not the
    reference. Full re-rank: ids equal, distances to float32 rounding of
    the same dequantized rows."""
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta, rerank_dtype=dtype,
                        rerank_layout=layout)
    pre_k = _full(port)
    params = dict(num_leaves_to_search=SP, pre_reordering_num_neighbors=pre_k)
    want = jax_s.search_batched_arrays(q, K, JaxParams(**params))
    got = port.search_batched_arrays(q, K, SearchParameters(**params))
    _match(want, got)
    assert port._rerank_layout() == layout


@pytest.mark.parametrize("change", [dict(rerank_dtype="int8"),
                                    dict(rerank_layout="csr")])
def test_with_rerank_store_serves_like_the_loaded_store(soar, change):
    """with_rerank_store re-serves a built index under another re-rank
    store: the same ids and distances (to 1e-5 absolute) as the index
    loaded with that store, while the original searcher keeps its own."""
    from scann_tpu_torch.errors import ScannError

    arrays, meta, q = soar
    _, port = _both(arrays, meta)
    _, loaded = _both(arrays, meta, **change)
    params = SearchParameters(num_leaves_to_search=SP,
                              pre_reordering_num_neighbors=_full(port))
    config = port.config
    before = port.search_batched_arrays(q, K, params)
    other = port.with_rerank_store(**change)
    _match(loaded.search_batched_arrays(q, K, params),
           other.search_batched_arrays(q, K, params), rtol=0)
    _match(before, port.search_batched_arrays(q, K, params), rtol=0)
    assert port.config is config
    with pytest.raises(ScannError):
        port.with_rerank_store(num_partitions=3)


def test_allow_mask_matches_jax(soar):
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta)
    allow = np.random.default_rng(2).random(SN) < 0.3
    pre_k = _full(port)
    params = dict(num_leaves_to_search=SP, pre_reordering_num_neighbors=pre_k)
    want = jax_s.search_batched_arrays(q, K, JaxParams(**params),
                                       allow_mask=allow)
    got = port.search_batched_arrays(q, K, SearchParameters(**params),
                                     allow_mask=allow)
    _match(want, got)
    assert allow[got[0][got[0] >= 0]].all()


@pytest.mark.parametrize("measure", ["DotProduct", "Cosine",
                                     "GeneralInnerProduct"])
def test_other_measures_match_jax(tmp_path_factory, measure):
    """A JAX-built index under the measure (cosine rows normalized at
    build, queries at search; MIPS tables with the centroid term in
    subspace 0, partitions by dot product): full re-rank ids equal."""
    db, q = _clustered(2, 2000)
    arrays, meta = _save(tmp_path_factory, measure, db,
                         distance_measure=JaxMeasure(measure),
                         max_partition_size=None)
    jax_s, port = _both(arrays, meta)
    pre_k = _full(port, p=6)
    params = dict(num_leaves_to_search=6, pre_reordering_num_neighbors=pre_k)
    want = jax_s.search_batched_arrays(q, K, JaxParams(**params))
    got = port.search_batched_arrays(q, K, SearchParameters(**params))
    _match(want, got, rtol=1e-4)
    short = dict(num_leaves_to_search=6, pre_reordering_num_neighbors=30)
    w, _ = jax_s.search_batched_arrays(q, K, JaxParams(**short))
    g, _ = port.search_batched_arrays(q, K, SearchParameters(**short))
    assert _overlap(g, w) >= 0.95


def _jax_state(jax_s, grouped):
    """The JAX searcher's serving state, with the TPU layout (transposed,
    packed slab) forced when ``grouped``."""
    if grouped:
        jax_s._use_grouped_pallas = lambda: True
        jax_s._csr_cache = None
    rows, codes_csr, off, sizes, perm, l_cap = jax_s._csr_state()
    db, norms, n_valid = jax_s._device_state()
    return rows, codes_csr, off, sizes, perm, l_cap, db, norms, n_valid


def test_int8_lut_scores_match_jax_exactly(soar):
    """Given the same float32 tables: the same per-batch affine, the same
    int8 tables and int16 sums, and the same restored float32 scores."""
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta)
    _, codes_csr, off, sizes, _, l_cap, _, _, _ = _jax_state(jax_s, True)
    p_codes, p_off, p_sizes, _, p_l_cap = port._csr_state()
    np.testing.assert_array_equal(p_codes.numpy(), np.asarray(codes_csr))
    assert p_l_cap == l_cap
    cent = port.partitioner.centers
    parts = ptx._select_partitions(cent, torch.from_numpy(q), p=SP)
    s_pad = 2 * p_codes.shape[0]
    luts = ptx._residual_luts(torch.from_numpy(q), cent, parts,
                              port.codebook.centroids, s_pad=s_pad,
                              use_residuals=True)
    want, _ = jtx.leaf_scores_grouped(
        jnp.asarray(luts.numpy()), jnp.asarray(parts.numpy().astype(np.int32)),
        codes_csr, off, sizes, p=SP, l_cap=l_cap, q_cap=8, l_tile=128,
        interpret=True, int8_luts=True, packed=True)
    got = ptx.leaf_scores_grouped(luts, parts, p_codes, p_off, p_sizes, p=SP,
                                  l_cap=l_cap, q_cap=8, l_tile=128,
                                  packed=True, int8_luts=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pre_k", [30, None])
def test_int8_lut_search_matches_jax(soar, pre_k):
    """tree_ah_search_grouped(int8_luts=True) against the JAX grouped
    program (interpret mode) on the spilled index: ids overlap >= 0.98 at a
    short re-rank (the two packages' float32 tables may round an entry to
    the other int8 level), equal at the full re-rank."""
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta)
    _, codes_csr, off, sizes, perm, l_cap, db, norms, n_valid = _jax_state(
        jax_s, True)
    pre_k = pre_k or SP * l_cap
    want_d, want_i = jtx.tree_ah_search_grouped(
        db, norms, jax_s.partitioner.centers_device(), codes_csr, off, sizes,
        perm, jax_s.codebook.centroids_device(), jnp.asarray(q),
        jnp.int32(n_valid), None, jnp.float32(np.inf), jnp.float32(np.inf),
        p=SP, pre_k=pre_k, k=K, l_cap=l_cap, use_residuals=True,
        measure=JaxMeasure.SQUARED_L2, multiplicity=2, q_cap=8, l_tile=128,
        interpret=True, int8_luts=True, packed=True)
    p_codes, p_off, p_sizes, p_perm, _ = port._csr_state()
    got_d, got_i = ptx.tree_ah_search_grouped(
        port._device_state(), port.partitioner.centers, p_codes, p_off,
        p_sizes, p_perm, port.codebook.centroids, torch.from_numpy(q),
        float("inf"), float("inf"), p=SP, pre_k=pre_k, k=K, l_cap=l_cap,
        use_residuals=True, q_cap=8, l_tile=128, packed=True, multiplicity=2,
        int8_luts=True)
    if pre_k == SP * l_cap:
        _match((np.asarray(want_i), np.asarray(want_d)),
               (got_i.numpy(), got_d.numpy()))
    else:
        assert _overlap(got_i.numpy(), np.asarray(want_i)) >= 0.98


def test_per_pair_leaf_scores_match_jax(soar):
    """leaf_scores_per_pair (the per-pair kernel's twin over the unpacked
    slab) against leaf_scores_xla over its row-major transpose: masks
    equal, scores within 1e-6 of the tables' largest sum of |entries|."""
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta)
    rows, _, off, sizes, _, l_cap, _, _, _ = _jax_state(jax_s, False)
    codes_u, p_off, p_sizes, _, _ = port._csr_state(packed=False)
    np.testing.assert_array_equal(codes_u.numpy().T, np.asarray(rows))
    cent = port.partitioner.centers
    parts = ptx._select_partitions(cent, torch.from_numpy(q), p=SP)
    luts = ptx._residual_luts(torch.from_numpy(q), cent, parts,
                              port.codebook.centroids,
                              s_pad=codes_u.shape[0], use_residuals=True)
    want, _ = jtx.leaf_scores_xla(
        jnp.asarray(luts.numpy()), jnp.asarray(parts.numpy().astype(np.int32)),
        rows, off, sizes, p=SP, l_cap=l_cap, c=16)
    got = ptx.leaf_scores_per_pair(luts, parts, codes_u, p_off, p_sizes,
                                   p=SP, l_cap=l_cap, c=16).numpy()
    want = np.asarray(want)
    masked = want >= MASKED / 2
    np.testing.assert_array_equal(got >= MASKED / 2, masked)
    tol = 1e-6 * float(luts.abs().reshape(len(luts), -1, 16).amax(-1)
                       .sum(-1).max())
    assert np.abs(got - want)[~masked].max() <= tol


@pytest.mark.parametrize("pre_k", [30, None])
def test_per_pair_search_matches_jax(soar, pre_k):
    """tree_ah_search (the per-pair path) against the JAX package's
    tree_ah_search (its searcher's CPU path): ids equal at the full
    re-rank, overlapping >= 0.98 at a short one (float32 leaf scores
    summed in another order may tie-break the pre_k boundary otherwise)."""
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta)
    pre_k = pre_k or _full(port)
    params = dict(num_leaves_to_search=SP, pre_reordering_num_neighbors=pre_k)
    want = jax_s.search_batched_arrays(q, K, JaxParams(**params))
    codes_u, off, sizes, perm, l_cap = port._csr_state(packed=False)
    got_d, got_i = ptx.tree_ah_search(
        port._device_state(), port.partitioner.centers, codes_u, off, sizes,
        perm, port.codebook.centroids, torch.from_numpy(q), float("inf"),
        float("inf"), p=SP, pre_k=pre_k, k=K, l_cap=l_cap, use_residuals=True,
        multiplicity=2)
    if pre_k == _full(port):
        _match(want, (got_i.numpy(), got_d.numpy()))
    else:
        assert _overlap(got_i.numpy(), want[0]) >= 0.98


def test_reorder_false_returns_approximate_scores(soar):
    """reorder=False: the approximate top-k, deduplicated, in the JAX
    program's units; ids overlap the JAX grouped program's."""
    arrays, meta, q = soar
    jax_s, port = _both(arrays, meta)
    _, codes_csr, off, sizes, perm, l_cap, db, norms, n_valid = _jax_state(
        jax_s, True)
    want_d, want_i = jtx.tree_ah_search_grouped(
        db, norms, jax_s.partitioner.centers_device(), codes_csr, off, sizes,
        perm, jax_s.codebook.centroids_device(), jnp.asarray(q),
        jnp.int32(n_valid), None, jnp.float32(np.inf), jnp.float32(np.inf),
        p=SP, pre_k=30, k=K, l_cap=l_cap, use_residuals=True,
        measure=JaxMeasure.SQUARED_L2, multiplicity=2, q_cap=8, l_tile=128,
        interpret=True, packed=True, reorder=False)
    p_codes, p_off, p_sizes, p_perm, _ = port._csr_state()
    got_d, got_i = ptx.tree_ah_search_grouped(
        port._device_state(), port.partitioner.centers, p_codes, p_off,
        p_sizes, p_perm, port.codebook.centroids, torch.from_numpy(q),
        float("inf"), float("inf"), p=SP, pre_k=30, k=K, l_cap=l_cap,
        use_residuals=True, q_cap=8, l_tile=128, packed=True, multiplicity=2,
        reorder=False)
    assert _overlap(got_i.numpy(), np.asarray(want_i)) >= 0.9
    np.testing.assert_allclose(np.sort(got_d.numpy(), 1)[:, 0],
                               np.sort(np.asarray(want_d), 1)[:, 0],
                               rtol=1e-2)

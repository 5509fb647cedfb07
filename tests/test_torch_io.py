"""``save_index`` / ``load_index`` of the PyTorch port against the JAX
package's, in both directions, for every index kind the port serves and
for facade files: a JAX file serves on the port and re-saves to the very
file the JAX package writes of it; a port file loads in the JAX package and serves its
results; a port file loads back in the port bit for bit; both packages
write the same array names, dtypes and header keys.

Tolerance: equal ids and distances within 1e-5 relative (the same
float32 arithmetic in another order), for every kind. The kinds that
select candidates on approximate scores before an exact re-rank (hashed,
tree-AH, block sweep) score those candidates another way on each side (the
port's LUT16 twin and grouped leaf scorer in bf16, the JAX CPU paths in
float32), which can move a candidate that ties at the pre_k boundary
(ROADMAP queue 3, "boundary ties"); these data hold no such tie in either
direction, so their ids are equal too. The paths' tie-level comparisons
against the JAX pipeline functions are ``test_torch_hasher.py``,
``test_torch_tree_x_hybrid.py`` and ``test_torch_block_sweep.py``.
"""

import json

import numpy as np
import pytest
import torch

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.hashes.hasher import (
    AsymmetricHasher as JaxHasher,
    AsymmetricHasherConfig as JaxHashConfig,
)
from scann_tpu.io import load_index as jax_load_index
from scann_tpu.io import save_index as jax_save_index
from scann_tpu.models.block_sweep import (
    BlockSweepConfig as JaxSweepConfig,
    BlockSweepSearcher as JaxSweep,
)
from scann_tpu.models.brute_force import BruteForceSearcher as JaxBrute
from scann_tpu.models.partitioned import PartitionedSearcher as JaxPartitioned
from scann_tpu.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher as JaxSQ,
    ScalarQuantizedConfig as JaxSQConfig,
)
from scann_tpu.config import ScannConfig as JaxScannConfig
from scann_tpu.models.scann import Scann as JaxScann
from scann_tpu.models.scann import SearchMode as JaxMode
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import (
    TreeXHybridConfig as JaxTreeConfig,
    TreeXHybridSearcher as JaxTree,
)
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.partitioning.tree_partitioner import (
    TreePartitionerConfig as JaxTPConfig,
)
import scann_tpu_torch as T
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.partitioning.tree_partitioner import TreePartitionerConfig
from torch_threads import one_torch_thread  # noqa: F401

N, D, B, K = 1024, 16, 16, 5
RTOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(12, D)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 12, N)]
          + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 12, B)]
         + rng.normal(size=(B, D))).astype(np.float32)
    return db, q


def _jax_build(kind, db):
    ds = JaxDataset(db)
    hc = JaxHashConfig(num_codes=16, num_subspaces=8, seed=42,
                       max_iterations=5)
    return {
        "brute_force": lambda: JaxBrute(ds, JaxMeasure.COSINE),
        "sq_int8": lambda: JaxSQ(ds),
        "sq_int4": lambda: JaxSQ(ds, JaxSQConfig(storage="int4")),
        "sq_bf16": lambda: JaxSQ(ds, JaxSQConfig(storage="bf16")),
        "partitioned": lambda: JaxPartitioned(ds, config=JaxTPConfig(
            num_partitions=8, seed=42, max_iterations=5, spilling=True,
            spilling_threshold=0.5), num_partitions_to_search=4),
        "hashed": lambda: JaxHasher(hc).build(ds),
        "tree_ah": lambda: JaxTree(JaxTreeConfig(
            num_partitions=8, partitions_to_search=4, hash_config=hc,
            partition_max_iterations=5)).build(ds),
        "block_sweep": lambda: JaxSweep(ds, JaxSweepConfig(
            pre_reorder_k=64, block_r=8, tile_n=128, top2=True)),
        "facade": lambda: JaxScann.partitioned(ds, 8, 4),
    }[kind]()


def _port_build(kind, db):
    ds = T.DenseDataset(db)
    hc = T.AsymmetricHasherConfig(num_codes=16, num_subspaces=8, seed=42,
                                  max_iterations=5)
    cpu = dict(device="cpu")
    return {
        "brute_force": lambda: T.BruteForceSearcher(
            ds, T.DistanceMeasure.COSINE, **cpu),
        "sq_int8": lambda: T.ScalarQuantizedBruteForceSearcher(ds, **cpu),
        "sq_int4": lambda: T.ScalarQuantizedBruteForceSearcher(
            ds, T.ScalarQuantizedConfig(storage="int4"), **cpu),
        "sq_bf16": lambda: T.ScalarQuantizedBruteForceSearcher(
            ds, T.ScalarQuantizedConfig(storage="bf16"), **cpu),
        "partitioned": lambda: T.PartitionedSearcher(
            ds, config=TreePartitionerConfig(
                num_partitions=8, seed=42, max_iterations=5, spilling=True,
                spilling_threshold=0.5), num_partitions_to_search=4, **cpu),
        "hashed": lambda: T.AsymmetricHasher(hc, **cpu).build(ds),
        "tree_ah": lambda: T.TreeXHybridSearcher(T.TreeXHybridConfig(
            num_partitions=8, partitions_to_search=4, hash_config=hc,
            partition_max_iterations=5), **cpu).build(ds),
        "block_sweep": lambda: T.BlockSweepSearcher(ds, T.BlockSweepConfig(
            pre_reorder_k=64, block_r=8, tile_n=128, top2=True), **cpu),
        "facade": lambda: T.Scann.partitioned(ds, 8, 4, **cpu),
    }[kind]()


KINDS = ["brute_force", "sq_int8", "sq_int4", "sq_bf16", "partitioned",
         "hashed", "tree_ah", "block_sweep", "facade"]
# the searcher class each kind loads as (a facade file: its inner searcher)
LOADS_AS = {"brute_force": "BruteForceSearcher",
            "sq_int8": "ScalarQuantizedBruteForceSearcher",
            "sq_int4": "ScalarQuantizedBruteForceSearcher",
            "sq_bf16": "ScalarQuantizedBruteForceSearcher",
            "partitioned": "PartitionedSearcher",
            "hashed": "AsymmetricHasher", "tree_ah": "TreeXHybridSearcher",
            "block_sweep": "BlockSweepSearcher",
            "facade": "PartitionedSearcher"}


def _search(searcher, q, jax_side):
    """k=5; the hashed kind re-ranks 100 candidates (its exact path)."""
    if isinstance(searcher, (JaxHasher, T.AsymmetricHasher)):
        params = (JaxParams if jax_side else T.SearchParameters)(
            pre_reordering_num_neighbors=100)
        return searcher.search_batched_arrays(q, K, params)
    return searcher.search_batched_arrays(q, K)


def _agree(got, want):
    gi, gd = got
    wi, wd = want
    assert gi.shape == wi.shape == (B, K)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=1e-5)


def _read(path):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        return meta, {k: z[k] for k in z.files if k != "__meta__"}


@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_serves_on_the_port_and_saves_back_unchanged(
        kind, data, tmp_path):
    db, q = data
    js = _jax_build(kind, db)
    path = str(tmp_path / "jax.npz")
    jax_save_index(path, js)
    ps = T.load_index(path, device="cpu")
    assert type(ps).__name__ == LOADS_AS[kind]
    jinner = js.impl if kind == "facade" else js
    _agree(_search(ps, q, False), _search(jinner, q, True))
    # the port's file of the carried state is the file the JAX package
    # writes of its own loaded state (a loaded int4 index writes storage
    # "int8" in both: the codes, not the storage name, carry the bits)
    jback = jax_load_index(path)
    if kind == "facade":
        meta, _ = _read(path)
        ps = T.Scann(T.DenseDataset(db),
                     T.ScannConfig.from_dict(meta["scann_config"]),
                     _impl=ps, _mode=T.SearchMode.PARTITIONED, device="cpu")
        jback = JaxScann(JaxDataset(db),
                         JaxScannConfig.from_dict(meta["scann_config"]),
                         _impl=jback, _mode=JaxMode.PARTITIONED)
    jax_save_index(str(tmp_path / "jax_again.npz"), jback)
    T.save_index(str(tmp_path / "port.npz"), ps)
    want_meta, want = _read(str(tmp_path / "jax_again.npz"))
    got_meta, got = _read(str(tmp_path / "port.npz"))
    assert got_meta == want_meta
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_serves_on_jax(kind, data, tmp_path):
    db, q = data
    ps = _port_build(kind, db)
    path = str(tmp_path / "port.npz")
    T.save_index(path, ps)
    js = jax_load_index(path)
    assert type(js).__name__ == LOADS_AS[kind]
    pinner = ps.impl if kind == "facade" else ps
    _agree(_search(pinner, q, False), _search(js, q, True))


@pytest.mark.parametrize("kind", KINDS)
def test_port_round_trip_is_bit_identical(kind, data, tmp_path):
    db, q = data
    ps = _port_build(kind, db)
    path = str(tmp_path / "port.npz")
    T.save_index(path, ps)
    back = T.load_index(path, device="cpu")
    inner = ps.impl if kind == "facade" else ps
    gi, gd = _search(back, q, False)
    wi, wd = _search(inner, q, False)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("kind", KINDS)
def test_file_layout_matches_jax(kind, data, tmp_path):
    """Each package's own build writes the same array names and dtypes and
    the same header keys (values of trained state differ: other random
    bits)."""
    db, _ = data
    jax_save_index(str(tmp_path / "jax.npz"), _jax_build(kind, db))
    T.save_index(str(tmp_path / "port.npz"), _port_build(kind, db))
    want_meta, want = _read(str(tmp_path / "jax.npz"))
    got_meta, got = _read(str(tmp_path / "port.npz"))
    assert set(got_meta) == set(want_meta)
    assert got_meta["format_version"] == 1
    assert got_meta["facade"] == (kind == "facade")
    for key in ("kind", "measure", "storage", "bits", "p", "dim",
                "assignment_codes", "scann_config"):
        if key in want_meta:
            assert got_meta[key] == want_meta[key], key
    for sub in ("config", "hash_config"):
        if sub in want_meta:
            assert set(got_meta[sub]) == set(want_meta[sub])
    assert {k: (v.dtype, v.ndim) for k, v in got.items()} == \
        {k: (v.dtype, v.ndim) for k, v in want.items()}


def test_tensors_from_any_device_save_as_numpy(data, tmp_path):
    """save_index writes the searcher's tensors as numpy arrays: a searcher
    whose state is non-contiguous or int64 still writes the JAX dtypes."""
    db, _ = data
    ps = _port_build("partitioned", db)
    tk = ps.partitioner.tokenization
    assert tk.point_indices.dtype == torch.int64
    path = str(tmp_path / "p.npz")
    T.save_index(path, ps)
    _, arrays = _read(path)
    assert arrays["csr_points"].dtype == np.int32
    np.testing.assert_array_equal(arrays["csr_points"],
                                  tk.point_indices.numpy())


def test_loader_rejects_foreign_files(data, tmp_path):
    db, _ = data
    path = str(tmp_path / "bf.npz")
    T.save_index(path, _port_build("brute_force", db))
    meta, arrays = _read(path)
    for bad_meta, err in ((dict(meta, format_version=2), ScannError),
                          ({k: v for k, v in meta.items() if k != "kind"},
                           ScannError),
                          (dict(meta, sharded_kind="tree_ah"),
                           ScannError),
                          (dict(meta, kind="nonsense"), ScannError)):
        bad = str(tmp_path / "bad.npz")
        np.savez_compressed(bad, __meta__=np.frombuffer(
            json.dumps(bad_meta).encode(), dtype=np.uint8), **arrays)
        with pytest.raises(err) as got:
            T.load_index(bad, device="cpu")
        if "sharded_kind" in bad_meta:
            # a sharded serving layout names its loader, in JAX's words
            from scann_tpu.errors import ScannError as JaxError

            with pytest.raises(JaxError) as want:
                jax_load_index(bad)
            assert str(got.value) == str(want.value)
            assert "load_sharded_layout" in str(got.value)
    with pytest.raises(ScannError):
        T.save_index(str(tmp_path / "x.npz"), object())

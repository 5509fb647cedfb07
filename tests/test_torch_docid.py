"""Docids of the PyTorch port against the JAX package on the CPU:
``DocIdCollection`` (the same answers and error codes), and every searcher
and the ``Scann`` facade built on a dataset with docids returning the JAX
package's (index, docid) lists.

The searchers that select approximately search here with every partition
probed and every candidate re-ranked, so both packages return the exact
neighbours: ids must be equal (seeded Gaussian rows have no distance
ties), and each docid must be the one the dataset gave that index.
"""

import numpy as np
import pytest

from scann_tpu.data.dataset import DenseDataset as JaxDataset
from scann_tpu.data.docid import DocIdCollection as JaxDocIds
from scann_tpu.errors import ScannError as JaxError
from scann_tpu.hashes.hasher import (
    AsymmetricHasher as JaxHasher,
    AsymmetricHasherConfig as JaxHashConfig,
)
from scann_tpu.models.block_sweep import (
    BlockSweepConfig as JaxSweepConfig,
    BlockSweepSearcher as JaxSweep,
)
from scann_tpu.models.brute_force import BruteForceSearcher as JaxBF
from scann_tpu.models.partitioned import PartitionedSearcher as JaxPartitioned
from scann_tpu.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher as JaxSQ,
)
from scann_tpu.models.scann import Scann as JaxScann
from scann_tpu.models.searcher import SearchParameters as JaxParams
from scann_tpu.models.tree_x_hybrid import (
    TreeXHybridConfig as JaxTreeConfig,
    TreeXHybridSearcher as JaxTree,
)
from scann_tpu.ops.distances import DistanceMeasure as JaxMeasure
from scann_tpu.partitioning.tree_partitioner import (
    TreePartitionerConfig as JaxPartConfig,
)
import scann_tpu_torch as T
from scann_tpu_torch.data.docid import DocIdCollection
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.partitioning.tree_partitioner import (
    TreePartitionerConfig as PortPartConfig,
)
from torch_threads import one_torch_thread  # noqa: F401

N, D, B, K = 600, 16, 8, 5


def _both(docids):
    return DocIdCollection(docids), JaxDocIds(docids)


@pytest.mark.parametrize("docids", [
    None, [], ["a", "b", "c"], [7, 3, 11, 0], ["x", 1, "y", 2],
    [f"doc{i}" for i in range(50)]])
def test_collection_answers_match_jax(docids):
    port, ref = _both(docids)
    assert len(port) == len(ref)
    assert list(port) == list(ref)
    assert port.to_list() == ref.to_list()
    for i in range(len(ref)):
        assert port.get(i) == ref.get(i)
    for d in list(ref) + ["missing", -1, 99]:
        assert port.index_of(d) == ref.index_of(d)
        assert port.contains(d) == ref.contains(d)
    assert port.add("new") == ref.add("new")
    assert port.to_list() == ref.to_list()


@pytest.mark.parametrize("op,arg", [
    ("add", "a"), ("get", -1), ("get", 2), ("get", 100)])
def test_collection_errors_match_jax(op, arg):
    """An existing docid raises ALREADY_EXISTS, an index out of range
    OUT_OF_RANGE, in both packages."""
    port, ref = _both(["a", "b"])
    with pytest.raises(JaxError) as want:
        getattr(ref, op)(arg)
    with pytest.raises(ScannError) as got:
        getattr(port, op)(arg)
    assert got.value.code.value == want.value.code.value
    assert got.value.message == want.value.message


def test_duplicate_docids_refused_at_construction():
    with pytest.raises(JaxError) as want:
        JaxDocIds(["a", "b", "a"])
    with pytest.raises(ScannError) as got:
        DocIdCollection(["a", "b", "a"])
    assert got.value.code.value == want.value.code.value == "ALREADY_EXISTS"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(8, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 8, N)]
         + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 8, B)]
         + rng.normal(size=(B, D))).astype(np.float32)
    docids = [f"doc{i}" for i in range(N)]
    return x, q, docids


def _pairs(results):
    return [[(nb.index, nb.docid) for nb in r] for r in results]


def _tree_cfgs(measure):
    common = dict(num_partitions=4, partitions_to_search=4,
                  max_partition_size=None)
    hash_kw = dict(num_codes=16, num_subspaces=8, seed=0, max_iterations=4)
    return (T.TreeXHybridConfig(
        distance_measure=T.DistanceMeasure[measure],
        hash_config=T.AsymmetricHasherConfig(**hash_kw), **common),
            JaxTreeConfig(distance_measure=JaxMeasure[measure],
                          hash_config=JaxHashConfig(**hash_kw), **common))


def _hash_cfgs(measure):
    kw = dict(num_codes=16, num_subspaces=8, seed=0, max_iterations=4)
    return (T.AsymmetricHasherConfig(distance_measure=T.DistanceMeasure[
        measure], **kw),
            JaxHashConfig(distance_measure=JaxMeasure[measure], **kw))


# name: (port searcher from a port dataset, JAX searcher from a JAX
#        dataset, search parameters for both (port, JAX))
SEARCHERS = {
    "brute_force": (lambda ds: T.BruteForceSearcher(ds, device="cpu"),
                    lambda ds: JaxBF(ds), (None, None)),
    "scalar_quantized": (
        lambda ds: T.ScalarQuantizedBruteForceSearcher(ds, device="cpu"),
        lambda ds: JaxSQ(ds), (None, None)),
    "block_sweep": (
        lambda ds: T.BlockSweepSearcher(ds, T.BlockSweepConfig(
            block_r=8, pre_reorder_k=N), device="cpu"),
        lambda ds: JaxSweep(ds, JaxSweepConfig(block_r=8, pre_reorder_k=N)),
        (None, None)),
    "partitioned": (
        lambda ds: T.PartitionedSearcher(
            ds, config=PortPartConfig(num_partitions=4, seed=0),
            num_partitions_to_search=4, device="cpu"),
        lambda ds: JaxPartitioned(
            ds, config=JaxPartConfig(num_partitions=4, seed=0),
            num_partitions_to_search=4),
        (None, None)),
    "hasher": (
        lambda ds: T.AsymmetricHasher(_hash_cfgs("SQUARED_L2")[0],
                                      device="cpu").build(ds),
        lambda ds: JaxHasher(_hash_cfgs("SQUARED_L2")[1]).build(ds),
        (T.SearchParameters(pre_reordering_num_neighbors=N),
         JaxParams(pre_reordering_num_neighbors=N))),
    "hasher_cosine": (
        lambda ds: T.AsymmetricHasher(_hash_cfgs("COSINE")[0],
                                      device="cpu").build(ds),
        lambda ds: JaxHasher(_hash_cfgs("COSINE")[1]).build(ds),
        (T.SearchParameters(pre_reordering_num_neighbors=N),
         JaxParams(pre_reordering_num_neighbors=N))),
    "tree_ah": (
        lambda ds: T.TreeXHybridSearcher(_tree_cfgs("SQUARED_L2")[0],
                                         device="cpu").build(ds),
        lambda ds: JaxTree(_tree_cfgs("SQUARED_L2")[1]).build(ds),
        (T.SearchParameters(pre_reordering_num_neighbors=N),
         JaxParams(pre_reordering_num_neighbors=N))),
    "tree_ah_cosine": (
        lambda ds: T.TreeXHybridSearcher(_tree_cfgs("COSINE")[0],
                                         device="cpu").build(ds),
        lambda ds: JaxTree(_tree_cfgs("COSINE")[1]).build(ds),
        (T.SearchParameters(pre_reordering_num_neighbors=N),
         JaxParams(pre_reordering_num_neighbors=N))),
    "facade": (lambda ds: T.Scann(ds, device="cpu"), lambda ds: JaxScann(ds),
               (None, None)),
}


@pytest.mark.parametrize("name", list(SEARCHERS))
def test_searchers_return_the_jax_docids(name, data):
    """``NNResult.docid`` is the dataset's docid of ``NNResult.index``, and
    the (index, docid) lists equal the JAX package's."""
    x, q, docids = data
    make_port, make_jax, (p_params, j_params) = SEARCHERS[name]
    port = make_port(T.DenseDataset(x, docids=docids))
    ref = make_jax(JaxDataset(x, docids=docids))
    got = _pairs(port.search_batched(q, K, p_params))
    want = _pairs(ref.search_batched(q, K, j_params))
    assert got == want
    assert all(d == f"doc{i}" for row in got for i, d in row)
    assert all(len(row) == K for row in got)
    one = port.search(q[0], K, p_params)
    assert [(nb.index, nb.docid) for nb in one] == got[0]


def test_searchers_without_docids_return_none(data):
    x, q, _ = data
    s = T.BruteForceSearcher(T.DenseDataset(x), device="cpu")
    assert all(nb.docid is None for r in s.search_batched(q, K)
               for nb in r)

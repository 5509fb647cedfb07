"""The stage spans of the port's tree-x-AH search (``utils/trace.span``):
a shared no-op without a profiler, and under a CPU ``torch.profiler`` the
spans of every stage, nested under ``scann.search`` and
``tree_ah.search``, in the order the search runs them, once per request,
with the results unchanged. The benchmark's reader
(``portbench/stages.py``) matches these names, so a rename fails here."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import scann_tpu_torch as T
from scann_tpu_torch.models import tree_x_hybrid as ptx
from scann_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, K = 12, 5

FACADE = ["scann.search", "tree_ah.search"]
STAGES = ["tree_ah.partitions", "tree_ah.luts", "tree_ah.group",
          "tree_ah.leaf", "tree_ah.preselect", "tree_ah.rerank"]
WITH_MASK = STAGES[:4] + ["tree_ah.mask"] + STAGES[4:]
# the grouped scorer's launch alone, inside tree_ah.leaf
LEAF_SCORE = "tree_ah.leaf.score"


def _stages_module():
    """``portbench/stages.py``, loaded by its path."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "portbench_stages_under_test", ROOT / "portbench" / "stages.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(12, 16)).astype(np.float32) * 3
    db = (centers[rng.integers(0, 12, 1500)]
          + rng.normal(size=(1500, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 12, B)]
         + rng.normal(size=(B, 16))).astype(np.float32)
    return db, torch.from_numpy(q)


def _facade(db, measure):
    cfg = T.ScannConfig.from_dict({
        "num_neighbors": K, "distance_measure": measure,
        "partitioning": {"num_partitions": 12, "num_partitions_to_search": 4,
                         "training_sample_size": 1500,
                         "max_training_iterations": 8},
        "hash": {"num_blocks": 8, "num_buckets": 16,
                 "training_sample_size": 1500},
        "exact_reordering": {"num_candidates": 20}})
    return T.Scann(T.DenseDataset(db), cfg, device="cpu")


@pytest.fixture(scope="module", params=["DotProduct", "SquaredL2"])
def facade(request, data):
    s = _facade(data[0], request.param)
    assert s.search_mode == T.SearchMode.TREE_AH
    return s


def _profiled(fn):
    """(fn's result, [(name, start, end)] of the program's spans, by start
    and outer first, [(start, end)] of the ATen operations) under a CPU
    profiler."""
    names = set(FACADE + WITH_MASK)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans, ops = [], []
    for e in prof.profiler.kineto_results.events():
        a = int(e.start_ns())
        b = a + int(e.duration_ns())
        if e.is_user_annotation() and e.name() in names:
            spans.append((e.name(), a, b))
        elif e.name().startswith("aten::"):
            ops.append((a, b))
    spans.sort(key=lambda s: (s[1], -s[2]))
    return out, spans, ops


def _spans(fn):
    out, spans, _ = _profiled(fn)
    return out, spans


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _check_requests(spans, top, stages, requests):
    """``requests`` times: ``top`` spans (each inside the one before), then
    ``stages`` in order, each inside the innermost ``top`` span."""
    per = len(top) + len(stages)
    assert [n for n, *_ in spans] == (top + stages) * requests
    for r in range(requests):
        req = spans[r * per:(r + 1) * per]
        for i in range(1, len(top)):
            assert _inside(req[i], req[i - 1])
        for s in req[len(top):]:
            assert _inside(s, req[len(top) - 1])
        # stages run one after another
        for a, b in zip(req[len(top):], req[len(top) + 1:]):
            assert a[2] <= b[1]


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch, facade,
                                                   data):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first, second = trace.span("tree_ah.leaf"), trace.span("scann.search")
    assert first is second
    with first as entered:
        assert entered is None
    ids, dists = facade.search_batched_tensors(data[1])
    assert ids.shape == (B, K) and dists.shape == (B, K)


def test_span_is_the_profilers_annotation_when_one_runs():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("tree_ah.luts"):
            torch.ones(3).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names == ["tree_ah.luts"]
    assert trace.span("tree_ah.luts") is trace.span("x")


def test_facade_search_spans_every_stage_once_a_request(facade, data):
    def two_requests():
        return [facade.search_batched_tensors(data[1]) for _ in range(2)]

    _, spans, ops = _profiled(two_requests)
    _check_requests(spans, FACADE, STAGES, 2)
    # each stage's span holds the stage's work
    for name, a, b in spans:
        assert any(a <= s and e <= b for s, e in ops), name


def test_mask_span_only_with_an_allowlist(facade, data):
    impl = facade.impl
    allow = np.arange(impl.dataset_size()) % 2 == 0
    (ids, _), spans = _spans(
        lambda: impl.search_batched_tensors(data[1], K, allow_mask=allow))
    _check_requests(spans, ["tree_ah.search"], WITH_MASK, 1)
    got = ids[ids >= 0]
    assert got.numel() > 0 and bool((got % 2 == 0).all())
    _, spans = _spans(lambda: impl.search_batched_tensors(data[1], K))
    _check_requests(spans, ["tree_ah.search"], STAGES, 1)


def test_results_are_bit_identical_under_a_profiler(facade, data):
    plain = facade.search_batched_tensors(data[1])
    (traced_ids, traced_dists), _ = _spans(
        lambda: facade.search_batched_tensors(data[1]))
    assert torch.equal(plain[0], traced_ids)
    assert torch.equal(plain[1], traced_dists)


@pytest.mark.parametrize("reorder", [True, False])
def test_per_pair_path_spans(facade, data, reorder):
    """The per-pair leaf scorer's search: its scores in ``tree_ah.leaf``
    with no grouping; without a re-rank the approximate top-k is all of
    ``tree_ah.rerank``."""
    impl = facade.impl
    codes_u, off, sizes, perm, l_cap = impl._csr_state(packed=False)
    measure = impl.config.distance_measure

    def search():
        return ptx.tree_ah_search(
            impl._device_state(), impl.partitioner.centers, codes_u, off,
            sizes, perm, impl.codebook.centroids, data[1], float("inf"),
            float("inf"), p=4, pre_k=20, k=K, l_cap=l_cap,
            use_residuals=True, measure=measure, reorder=reorder)

    plain = search()
    traced, spans = _spans(search)
    stages = ["tree_ah.partitions", "tree_ah.luts", "tree_ah.leaf"]
    stages += ["tree_ah.preselect", "tree_ah.rerank"] if reorder else [
        "tree_ah.rerank"]
    assert [n for n, *_ in spans] == stages
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1]
    assert torch.equal(plain[0], traced[0])
    assert torch.equal(plain[1], traced[1])


def test_sharded_search_runs_the_stages_once_a_shard(facade, data):
    """On a CPU mesh of two shards the sharded searcher runs the
    single-device stages: partitions and tables once for the one device,
    then each shard's scoring, ``tree_ah.preselect`` and ``tree_ah.rerank``
    over its own slab, with the results unchanged under the profiler."""
    from scann_tpu_torch.parallel import (
        ShardedTreeXHybridSearcher,
        make_mesh,
    )

    sh = ShardedTreeXHybridSearcher(
        facade.impl, make_mesh(devices=[torch.device("cpu")] * 2))
    plain = sh.search_batched_tensors(data[1], K)
    traced, spans = _spans(lambda: sh.search_batched_tensors(data[1], K))
    names = [n for n, *_ in spans]
    assert names == STAGES[:2] + STAGES[2:] * 2
    assert names.count("tree_ah.preselect") == 2
    assert names.count("tree_ah.rerank") == 2
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1]
    assert torch.equal(plain[0], traced[0])
    assert torch.equal(plain[1], traced[1])


def test_span_names_are_the_benchmark_readers():
    stages = _stages_module()
    assert stages.DISPATCH_SPAN == "scann.search"
    assert stages.SEARCHER_SPAN == "tree_ah.search"
    assert list(stages.STAGE_SPANS) == WITH_MASK
    assert set(stages.PROGRAM_SPANS) == set(FACADE + WITH_MASK)
    for name in ("partitions", "luts", "group", "leaf", "preselect",
                 "rerank"):
        src = (ROOT / "portbench" / "metrics"
               / f"{name}_ms_per_batch.py").read_text()
        assert f'"tree_ah.{name}"' in src
    src = (ROOT / "portbench" / "metrics"
           / "leaf_score_ms_per_batch.py").read_text()
    assert f'"{LEAF_SCORE}"' in src


def test_program_span_names_are_the_recorded_ones(facade, data):
    """Every program span a search records is one the stage reader knows,
    or the leaf scorer's span that ``leaf_score_ms_per_batch`` reads."""
    stages = _stages_module()
    impl = facade.impl
    allow = np.ones(impl.dataset_size(), dtype=bool)
    names = set(stages.PROGRAM_SPANS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        facade.search_batched_tensors(data[1])
        impl.search_batched_tensors(data[1], K, allow_mask=allow)
    recorded = {e.name() for e in prof.profiler.kineto_results.events()
                if e.is_user_annotation()}
    assert recorded == names | {LEAF_SCORE}


def test_leaf_score_span_holds_the_scorer_once_a_search(facade, data):
    """``tree_ah.leaf.score`` opens once a request, inside ``tree_ah.leaf``,
    around the grouped scorer's call alone: the leaf-major reorder of its
    scores falls after it, still inside ``tree_ah.leaf``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            facade.search_batched_tensors(data[1])
    events = [(e.name(), int(e.start_ns()),
               int(e.start_ns()) + int(e.duration_ns()))
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()
              or e.name().startswith("aten::")]
    leaves = sorted(e for e in events if e[0] == "tree_ah.leaf")
    scores = sorted(e for e in events if e[0] == LEAF_SCORE)
    assert len(leaves) == len(scores) == 2
    for leaf, score in zip(leaves, scores):
        assert _inside(score, leaf)
        # the reorder's index and transpose run after the scorer, in the
        # leaf span
        after = [e for e in events if e[0].startswith("aten::")
                 and score[2] <= e[1] and e[2] <= leaf[2]]
        assert any(n == "aten::index" for n, *_ in after)

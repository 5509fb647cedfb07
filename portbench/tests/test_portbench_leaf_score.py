"""The leaf scorer's own span: ``leaf_score_ms_per_batch`` on synthetic
profiler events."""

import types

import pytest

from portbench import spec, stages, tracing
from portbench.tests.test_portbench_trace import Ev

SCORE = "tree_ah.leaf.score"
KERNEL = "tree_ah_grouped_kernel<8,true,false,16>"


def _events(score_span=True, drop=None):
    """Two requests in a [1000, 3000] window, each enqueuing in
    ``tree_ah.leaf`` the grouped scorer (inside ``tree_ah.leaf.score``
    where it is marked) and then the leaf-major reorder's gather; the
    first also a kernel in ``tree_ah.group`` before them."""
    ev = [
        (tracing.WINDOW_SPAN, 1000, 3000, "user_annotation"),
        (tracing.BATCH_SPAN, 1005, 1400, "user_annotation"),
        (tracing.BATCH_SPAN, 1405, 1800, "user_annotation"),
        ("scann.search", 1010, 1300, "user_annotation"),
        ("tree_ah.search", 1015, 1295, "user_annotation"),
        ("tree_ah.group", 1020, 1040, "user_annotation"),
        ("tree_ah.leaf", 1050, 1100, "user_annotation"),
        ("scann.search", 1410, 1700, "user_annotation"),
        ("tree_ah.search", 1415, 1695, "user_annotation"),
        ("tree_ah.leaf", 1450, 1500, "user_annotation"),
        ("cudaLaunchKernel", 1025, 1027, "cuda_runtime"),
        ("cudaLaunchKernel", 1060, 1062, "cuda_runtime"),
        ("cudaLaunchKernel", 1080, 1082, "cuda_runtime"),
        ("cudaLaunchKernel", 1460, 1462, "cuda_runtime"),
        ("cudaLaunchKernel", 1480, 1482, "cuda_runtime"),
        ("index_kernel", 1030, 1050, "kernel"),
        (KERNEL, 1065, 1265, "kernel"),
        ("index_elementwise_kernel", 1265, 1305, "kernel"),
        (KERNEL, 1465, 1765, "kernel"),
        ("index_elementwise_kernel", 1765, 1805, "kernel"),
    ]
    if score_span:
        ev += [(SCORE, 1055, 1070, "user_annotation"),
               (SCORE, 1455, 1470, "user_annotation")]
    if drop is not None:
        ev = [e for e in ev if e[0] != drop]
    return ev


def _run(**kw):
    return types.SimpleNamespace(
        trace=tracing.from_events([Ev(*e) for e in _events(**kw)]))


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_score_time_is_the_scorers_alone():
    run = _run()
    # 200 + 300 ns of the scorer over two requests; the reorder's gathers
    # stay with tree_ah.leaf
    assert _read("leaf_score_ms_per_batch", run) == pytest.approx(
        500e-6 / 2)
    assert _read("leaf_ms_per_batch", run) == pytest.approx(
        (200 + 40 + 300 + 40) * 1e-6 / 2)
    # the stage reader does not know the new span: its stages keep their
    # time
    by_span = stages.attribute(run.trace)
    assert SCORE not in by_span
    assert by_span["tree_ah.leaf"] == pytest.approx(580e-9)


def test_without_the_span_nothing_is_read():
    run = _run(score_span=False)
    assert _read("leaf_score_ms_per_batch", run) is None
    # the accepted readers still read the trace
    assert _read("leaf_ms_per_batch", run) is not None


def test_a_count_mismatch_reads_nothing():
    run = _run(drop="index_kernel")
    assert _read("leaf_score_ms_per_batch", run) is None


def test_untraced_runs_read_nothing():
    run = types.SimpleNamespace(trace=None, index=None)
    assert _read("leaf_score_ms_per_batch", run) is None


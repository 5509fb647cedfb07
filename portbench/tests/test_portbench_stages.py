"""Device time by program stage and the dispatch idle share, from
synthetic profiler events (``portbench/stages.py``)."""

import types

import pytest

from portbench import spec, stages, tracing
from portbench.tests.test_portbench_trace import Ev

STAGE_METRICS = ("partitions", "luts", "group", "leaf", "preselect",
                 "rerank")
NEW_METRICS = tuple(f"{s}_ms_per_batch" for s in STAGE_METRICS) + (
    "dispatch_idle_pct",)


def _events(spans=True, drop=None):
    """Two requests in a [1000, 3000] window. The first enqueues a kernel
    in ``tree_ah.partitions``, a kernel and a fill in ``tree_ah.luts``, a
    kernel in ``tree_ah.leaf`` (under an ATen op), a kernel in
    ``tree_ah.search`` outside every stage, and the harness copies its
    results outside every program span; the second enqueues nothing."""
    ev = [
        (tracing.WINDOW_SPAN, 1000, 3000, "user_annotation"),
        (tracing.BATCH_SPAN, 1005, 1140, "user_annotation"),
        (tracing.BATCH_SPAN, 1145, 1400, "user_annotation"),
        ("cudaLaunchKernel", 1022, 1024, "cuda_runtime"),
        ("cudaLaunchKernel", 1032, 1034, "cuda_runtime"),
        ("cudaMemsetAsync", 1040, 1041, "cuda_runtime"),
        ("aten::index", 1052, 1060, "cpu_op"),
        ("cuLaunchKernel", 1055, 1057, "cuda_driver"),
        ("cudaLaunchKernel", 1090, 1092, "cuda_runtime"),
        ("cudaMemcpyAsync", 1105, 1107, "cuda_runtime"),
        ("cudaStreamSynchronize", 1110, 1138, "cuda_runtime"),
        # another thread's launch is not the window's
        ("cudaLaunchKernel", 1030, 1031, "cuda_runtime", 2),
        # device, in enqueue order: busy [1025, 1072] and [1085, 1170]
        ("select_kernel", 1025, 1060, "kernel"),
        ("lut_kernel", 1060, 1070, "kernel"),
        ("Memset (Device)", 1070, 1072, "gpu_memset"),
        ("tree_ah_grouped_kernel", 1085, 1150, "kernel"),
        ("searcher_kernel", 1150, 1160, "kernel"),
        ("Memcpy DtoH (Device -> Pinned)", 1160, 1170, "gpu_memcpy"),
    ]
    if spans:
        ev += [
            ("scann.search", 1010, 1100, "user_annotation"),
            ("tree_ah.search", 1015, 1095, "user_annotation"),
            ("tree_ah.partitions", 1020, 1030, "user_annotation"),
            ("tree_ah.luts", 1030, 1045, "user_annotation"),
            ("tree_ah.leaf", 1050, 1080, "user_annotation"),
            ("scann.search", 1150, 1300, "user_annotation"),
            ("tree_ah.search", 1155, 1295, "user_annotation"),
        ]
    if drop is not None:
        ev = [e for e in ev if e[0] != drop]
    return ev


def _run(**kw):
    t = tracing.from_events([Ev(*e) for e in _events(**kw)])
    return types.SimpleNamespace(trace=t, index=None)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_operations_go_to_the_innermost_span_of_their_enqueue_call():
    by_span = stages.attribute(_run().trace)
    assert by_span == pytest.approx({
        "tree_ah.partitions": 35e-9, "tree_ah.luts": 12e-9,
        "tree_ah.leaf": 65e-9, "tree_ah.search": 10e-9, None: 10e-9})


def test_stage_metrics_per_request():
    run = _run()
    want = {"partitions": 35, "luts": 12, "group": 0, "leaf": 65,
            "preselect": 0, "rerank": 0}
    for name, ns in want.items():
        got = _read(f"{name}_ms_per_batch", run)
        assert got == pytest.approx(ns * 1e-6 / 2), name


def test_the_harness_copies_count_for_no_stage():
    run = _run()
    staged = sum(_read(f"{s}_ms_per_batch", run) for s in STAGE_METRICS)
    busy_ms = run.trace.busy_s() * 1e3 / run.trace.batches
    # the searcher's own kernel and the result copy are the remainder
    assert busy_ms - staged == pytest.approx((10 + 10) * 1e-6 / 2)


@pytest.mark.parametrize("drop", ["cudaMemsetAsync", "cuLaunchKernel",
                                  "Memcpy DtoH (Device -> Pinned)"])
def test_a_count_mismatch_leaves_every_stage_metric_out(drop):
    run = _run(drop=drop)
    assert stages.attribute(run.trace) is None
    for s in STAGE_METRICS:
        assert _read(f"{s}_ms_per_batch", run) is None
    assert _read("dispatch_idle_pct", run) is not None


def test_dispatch_idle_is_idle_time_inside_the_facade_span():
    # gaps [1000, 1025], [1072, 1085], [1170, 3000] against the spans
    # [1010, 1100] and [1150, 1300]: 15 (a gap across the span's start)
    # + 13 + 130 (a gap across the second span's end), of 2000
    got = _read("dispatch_idle_pct", _run())
    assert got == pytest.approx(100.0 * (15 + 13 + 130) / 2000)
    assert stages.dispatch_idle_s(_run().trace) == pytest.approx(158e-9)


def test_interval_intersection():
    xs = [(0, 10), (20, 30), (40, 50)]
    ys = [(5, 25), (28, 45), (49, 60)]
    assert stages._intersection(xs, ys) == 5 + 5 + 2 + 5 + 1
    assert stages._intersection(xs, []) == 0
    assert stages._intersection([(0, 100)], ys) == 20 + 17 + 11


def test_a_trace_without_program_spans_reports_none_of_the_new_metrics():
    run = _run(spans=False)
    assert stages.attribute(run.trace) is None
    for name in NEW_METRICS:
        assert _read(name, run) is None
    # the accepted readers still read it
    assert _read("launches_per_batch", run) == 2.0


def test_untraced_runs_report_none_of_the_new_metrics():
    run = types.SimpleNamespace(trace=None, index=None)
    for name in NEW_METRICS:
        assert _read(name, run) is None


def test_the_new_metrics_are_declared_for_the_four_cells():
    bench = spec.load_benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_METRICS:
        m = declared[name]
        assert m["source"] == "device_trace" and m["workloads"] == cells
        assert m["moves"] == ("batch_p95_ms" if name == "dispatch_idle_pct"
                              else "qps")
    for cell in cells:
        reported = {m["name"] for m in spec.cell(cell).per_layer}
        assert set(NEW_METRICS) <= reported

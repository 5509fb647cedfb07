"""Idle share, launches, selection time and idle gaps from synthetic
profiler events."""

import types

import pytest

from portbench import spec, tracing
from portbench.stats import gaps, union_length


class Ev:
    def __init__(self, name, start, end, kind, thread=1):
        self._n, self._a, self._b, self._k, self._t = (name, start, end,
                                                       kind, thread)

    def device_type(self):
        gpu = self._k in ("kernel", "gpu_memcpy", "gpu_memset",
                          "gpu_user_annotation")
        return "DeviceType.CUDA" if gpu else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._k.endswith("user_annotation")

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def activity_type(self):
        return self._k

    def start_thread_id(self):
        return self._t


class EvWithoutKind(Ev):
    """An event of a profiler whose events give no activity type."""

    activity_type = None


def _trace(event=Ev):
    ev = [
        (tracing.WINDOW_SPAN, 1000, 2000, "user_annotation"),
        (tracing.BATCH_SPAN, 1000, 1500, "user_annotation"),
        (tracing.BATCH_SPAN, 1500, 2000, "user_annotation"),
        # overlapping device work: union [1100, 1300] + [1400, 1450]
        # + [1600, 1900] = 550 of 1000 ns
        ("tree_ah_grouped_kernel<16, true, false, 1>", 1100, 1250,
         "kernel"),
        ("void at::native::sbtopk::gatherTopK<float>", 1200, 1300,
         "kernel"),
        ("Memcpy DtoH (Device -> Pageable)", 1400, 1450, "gpu_memcpy"),
        ("void at::native::bitonicSortKVInPlace", 1600, 1900, "kernel"),
        ("gpu annotation", 1000, 2000, "gpu_user_annotation"),
        ("outside", 100, 900, "kernel"),
        # host: a sync around the first gap's middle, nested in an op
        ("aten::item", 1310, 1395, "cpu_op"),
        ("cudaStreamSynchronize", 1320, 1390, "cuda_runtime"),
        ("aten::other_thread", 1460, 1590, "cpu_op", 2),
    ]
    return tracing.from_events([event(*e) for e in ev])


def test_union_and_gaps():
    iv = [(5, 10), (0, 3), (8, 12), (20, 25)]
    assert union_length(iv, 0, 30) == 3 + 7 + 5
    assert gaps(iv, 0, 30) == [(3, 5), (12, 20), (25, 30)]
    assert union_length(iv, 9, 21) == 3 + 1


@pytest.mark.parametrize("event", [Ev, EvWithoutKind])
def test_window_batches_and_busy_time(event):
    t = _trace(event)
    assert t.window == (1000, 2000) and t.batches == 2
    assert len(t.kernels()) == 3
    assert t.busy_s() == pytest.approx(550e-9)
    assert [n for n, *_ in t.host] == ["aten::item",
                                       "cudaStreamSynchronize"]


def test_per_layer_readers_on_the_trace():
    run = types.SimpleNamespace(trace=_trace(), index=None)
    idle = spec.metric_reader("device_idle_pct")(run)
    assert idle == pytest.approx(45.0)
    assert spec.metric_reader("launches_per_batch")(run) == 1.5
    sel = spec.metric_reader("select_ms_per_batch")(run)
    assert sel == pytest.approx((100 + 300) * 1e-6 / 2)
    assert spec.metric_reader("leaf_roofline")(run) is None


def test_idle_gaps_named_by_the_innermost_host_op():
    gaps_ = {}
    for name, secs in _trace().idle_gaps():
        gaps_[name] = gaps_.get(name, 0.0) + secs
    assert gaps_["cudaStreamSynchronize"] == pytest.approx(100e-9)
    # [1000, 1100], [1900, 2000] and [1450, 1600], where only another
    # thread's op runs
    assert gaps_["python"] == pytest.approx(100e-9 + 100e-9 + 150e-9)
    br = _trace().breakdown()
    assert br["device_ops"][0][0] == "void at::native::bitonicSortKVInPlace"
    assert len(br["idle_gaps"]) == 2

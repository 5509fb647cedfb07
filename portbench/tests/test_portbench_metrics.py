"""The end-to-end arithmetic over a synthetic window."""

import types

import numpy as np
import pytest
import torch

from portbench import spec, stats


def _run(**kw):
    base = dict(trace=None, window_s=2.0, queries=4096,
                latencies_s=[0.01] * 19 + [0.03], recall=0.95,
                index_bytes=512.5, setup_s=20.0, build_s=9.0, index=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_qps_is_all_queries_over_the_whole_window():
    assert spec.metric_reader("qps")(_run()) == pytest.approx(2048.0)


def test_batch_p95_ms_is_the_95th_percentile_of_every_request():
    lat = list(np.linspace(0.001, 0.1, 200))
    got = spec.metric_reader("batch_p95_ms")(_run(latencies_s=lat))
    assert got == pytest.approx(np.percentile(lat, 95) * 1e3)


def test_end_to_end_metrics_leave_the_traced_run():
    run = _run(trace=object())
    assert spec.metric_reader("qps")(run) is None
    assert spec.metric_reader("batch_p95_ms")(run) is None


def test_recall_index_bytes_setup_and_build():
    run = _run()
    assert spec.metric_reader("recall")(run) == 0.95
    assert spec.metric_reader("index_bytes")(run) == 512.5
    assert spec.metric_reader("setup_s")(run) == 20.0
    assert spec.metric_reader("build_s")(run) == 9.0
    assert spec.metric_reader("index_bytes")(_run(index_bytes=0)) is None


def test_read_metrics_leaves_out_what_finds_nothing():
    metrics = [{"name": "qps", "unit": "queries/s"},
               {"name": "device_idle_pct", "unit": "%"}]
    assert spec.read_metrics(metrics, _run()) == {
        "qps": {"value": 2048.0, "unit": "queries/s"}}


def test_hits_match_the_frozen_recall_at_k():
    rng = np.random.default_rng(3)
    gt = np.stack([rng.permutation(50)[:10] for _ in range(30)])
    ids = np.where(rng.random((30, 10)) < 0.7, gt,
                   rng.integers(50, 60, (30, 10)))
    ids[:, [0, 1]] = ids[:, [1, 0]]
    ids[3] = -1
    got = float(stats.hits(torch.from_numpy(ids),
                           torch.from_numpy(gt)).sum()) / (30 * 10)
    assert got == pytest.approx(stats.recall_at_k(ids, gt, 10))


def test_percentile_of_one_value():
    assert stats.percentile([0.5], 95) == 0.5

"""Whole runs of a CPU-sized cell: the result line's schema, the verdict
of a sound program, of the control and of faults planted under the timed
path, and the import check."""

import json
import math
import pathlib
import subprocess
import sys

import pytest
import torch

from portbench.guard import forbidden_modules
from portbench.program import Program
from portbench.reference.control import Control
from portbench.tests.tiny import run_tiny, tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ["glove-100-angular.b1024.k10", "sift-128-euclidean.b1024.k100"]


class Faulty(Program):
    """The program with a fault planted where its answers are produced."""

    def __init__(self, fault):
        self.fault = fault

    def call(self, searcher, k, reorder):
        inner = super().call(searcher, k, reorder)

        def call(queries):
            ids, dists = inner(queries)
            h = queries.shape[0] // 2
            if self.fault == "half_batch_left_out":
                return ids[:h], dists[:h]
            if self.fault == "half_batch_answered_by_the_rest":
                return (torch.cat([ids[:h], ids[:h]]),
                        torch.cat([dists[:h], dists[:h]]))
            if self.fault == "answer_altered":
                ids = ids.clone()
                ids[:, 0] = (ids[:, 0] + 1) % searcher.size
                return ids, dists
            raise ValueError(self.fault)

        return call


def _numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield obj


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_with_the_last_line_schema(name):
    cell = tiny_cell(name)
    result, verdict = run_tiny(cell)
    assert verdict.correct and result["correct"] is True
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "compared"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) <= {m["name"] for m in cell.end_to_end}
    assert {"qps", "batch_p95_ms", "recall", "setup_s"} <= set(
        result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["compared"]) == {"invalid", "duplicates", "disorder",
                                       "dist_gap", "recall"}
    line = json.dumps(result)
    assert json.loads(line) == result
    assert all(math.isfinite(x) for x in _numbers(result))


def test_traced_run_reports_per_layer_metrics_and_breakdown():
    cell = tiny_cell()
    result, verdict = run_tiny(cell, trace=True)
    assert verdict.correct
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "compared"]
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "build_s" in result["metrics"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    result, verdict = run_tiny(tiny_cell(name), program=Control())
    assert not verdict.correct and result["correct"] is False
    gap = verdict.numbers["dist_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("fault", ["half_batch_left_out",
                                   "half_batch_answered_by_the_rest",
                                   "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    result, verdict = run_tiny(tiny_cell(name), program=Faulty(fault))
    assert not verdict.correct and result["correct"] is False
    assert result["failed"] > 0


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules(["scann_tpu_torch", "scann_tpu_torch.ops",
                              "numpy", "jaxtyping", "scann_tpu_torchx"]) == []
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "flax",
                              "scann_tpu", "scann_tpu.ops"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "scann_tpu",
        "scann_tpu.ops"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from portbench.tests.tiny import run_tiny, tiny_cell;"
            "r, v = run_tiny(tiny_cell(), trace=True); assert v.correct;"
            "from portbench.guard import forbidden_modules;"
            "found = forbidden_modules(); print(found); assert not found")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is not reachable")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr

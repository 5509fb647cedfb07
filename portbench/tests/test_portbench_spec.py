"""Cells, configurations, mixes, limits and metrics are found by name."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_its_config_mix_limits_and_metrics(name):
    cell = spec.cell(name)
    work = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert cell.config["name"] == work["config"]
    assert cell.mix["batch"] > 0 and cell.mix["k"] > 0
    assert cell.mix["reorder"] >= cell.mix["k"]
    assert 0 < cell.limits["dist_gap"] < 1
    assert [m["name"] for m in cell.end_to_end] == [
        m["name"] for m in BENCH["end_to_end"]]
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in BENCH["per_layer"]}
    assert cell.chips == 1


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def test_metrics_listing_cells_report_only_there():
    per_layer = [{"name": "a", "moves": "qps", "workloads": ["x"]},
                 {"name": "b", "moves": "qps"},
                 {"name": "c", "moves": "train_tokens_per_s"}]
    got = [m["name"] for m in per_layer
           if spec._reports(m, "y", ["qps", "setup_s"])]
    assert got == ["b"]


def test_benchmark_file_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert spec.load_json(spec.ROOT / c["file"])["reduced"] == \
            c["reduced"]
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)

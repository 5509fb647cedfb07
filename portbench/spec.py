"""Finds a cell's files by the names in ``BENCHMARK.json``.

A configuration, a traffic mix, a cell's limits and each metric's reader
are files of their own; adding one needs no edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, mix and limits
    loaded, and the metrics it reports with ``--trace 0`` and ``--trace
    1``."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """Whether a cell reports ``metric``: the cells its ``workloads`` key
    lists, or without one, every cell that reports the end-to-end metric
    it ``moves`` (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


def cell(name: str) -> Cell:
    """The cell called ``name``; ``KeyError`` if ``BENCHMARK.json`` has no
    such cell."""
    bench = load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=load_json(ROOT / cfg_entry["file"]),
        mix=load_json(HERE / "mixes" / f"{work['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``, loaded by its path (a
    metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read; a reader that returns None is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

"""A cell small enough for the CPU: the real cells' recipes with their
scale cut, for the tests of the harness."""

from __future__ import annotations

import copy
import time

import torch

from portbench import spec
from portbench.harness import run_cell

CPU = torch.device("cpu")


def tiny_cell(name: str = "glove-100-angular.b1024.k10") -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json at 3,000 rows of 16 dimensions
    (8 blocks), 24 partitions requested (balancing grows them), 40
    searched, 256 queries in requests of 64; its measure, mix shape (k,
    re-rank ratio) and limits unchanged."""
    cell = spec.cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["data"].update(rows=3000, dim=16, clusters=24, queries=256)
    cfg["scann"]["partitioning"].update(
        num_partitions=24, num_partitions_to_search=40,
        training_sample_size=2000, max_training_iterations=10)
    cfg["scann"]["hash"].update(num_blocks=8, training_sample_size=2000)
    cell.config = cfg
    cell.mix = dict(cell.mix, batch=64, warmup_batches=1)
    return cell


def run_tiny(cell: spec.Cell, *, seed: int = 7, seconds: float = 0.3,
             trace: bool = False, program=None):
    return run_cell(cell, seed, seconds, trace, CPU, time.perf_counter(),
                    program=program)

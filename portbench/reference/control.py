"""The control: the reference put in the program's place, one precision
down.

The configurations state an exact float32 re-rank, so the control is the
exact search computed in bfloat16 (rows, queries and distances), with the
program's interface (``build`` and ``search_batched_tensors``). The
comparison of ``compare.py`` has to find it not correct; ``readings.py``
runs it on the card at a cell's own size.
"""

from __future__ import annotations

import torch

from portbench.reference.exact import block_scores


class Bf16ExactSearcher:
    def __init__(self, rows: torch.Tensor, measure: str):
        self.measure = measure
        self.rows = rows.to(torch.bfloat16)
        self.rows_sq = (self.rows * self.rows).sum(-1)

    def search_batched_tensors(self, queries: torch.Tensor, k: int):
        d = block_scores(self.measure, queries.to(torch.bfloat16), self.rows,
                         self.rows_sq)
        vals, ids = torch.topk(d.float(), k, dim=-1, largest=False)
        return ids, vals


class Control:
    """The program's stand-in for ``harness.run_cell``."""

    name = "control: exact search in bfloat16"

    def prepare(self, rows: torch.Tensor) -> torch.Tensor:
        return rows

    def build(self, config: dict, rows: torch.Tensor, device):
        return Bf16ExactSearcher(rows.to(device),
                                 config["scann"]["distance_measure"])

    def call(self, searcher, k: int, reorder: int):
        return lambda queries: searcher.search_batched_tensors(queries, k)

    def index_view(self, searcher, config: dict):
        return None

"""The system under test: ``scann_tpu_torch``'s ``Scann`` facade.

The only module of the benchmark that imports the program. It builds the
facade from a configuration's ``scann`` entry (a ``ScannConfig`` as a
dict), sends each request through ``Scann.search_batched_tensors`` with
the mix's k and re-rank depth as a ``QueryConfig``, and hands the leaf
count the built index's partition centres and sizes (read-only).
"""

from __future__ import annotations

import pathlib
from typing import Optional

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _checkout_program() -> None:
    """The program must be the checkout's own, not one installed
    elsewhere."""
    import scann_tpu_torch

    where = pathlib.Path(scann_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"scann_tpu_torch was loaded from {where}, "
                           f"outside the checkout {ROOT}")


class Program:
    name = "scann_tpu_torch.Scann"

    def prepare(self, rows: torch.Tensor):
        """The dataset handed to the program: a host copy of ``rows``, from
        which the program makes its own card copy (it does not alias the
        benchmark's)."""
        _checkout_program()
        from scann_tpu_torch.data.dataset import DenseDataset

        return DenseDataset(rows.cpu().numpy())

    def build(self, config: dict, dataset, device):
        """The facade built from the configuration's ``scann`` entry."""
        from scann_tpu_torch.config import ScannConfig
        from scann_tpu_torch.models.scann import Scann

        return Scann(dataset, ScannConfig.from_dict(config["scann"]),
                     device=device)

    def call(self, searcher, k: int, reorder: int):
        """One request: queries -> (ids, distances) on the device."""
        from scann_tpu_torch.config import QueryConfig

        qc = QueryConfig(num_neighbors=k, reordering_num_candidates=reorder)
        return lambda queries: searcher.search_batched_tensors(
            queries, query_config=qc)

    def index_view(self, searcher, config: dict) -> Optional[dict]:
        """What the leaf count reads of a tree-x-AH index: centres,
        partition sizes, subspaces and codes; None for other searchers."""
        impl = getattr(searcher, "impl", searcher)
        part = getattr(impl, "partitioner", None)
        book = getattr(impl, "codebook", None)
        if part is None or book is None:
            return None
        s, c, _ = book.centroids.shape
        return {
            "centers": part.centers.detach().clone(),
            "sizes": part.tokenization.partition_sizes.detach().clone(),
            "subspaces": int(s),
            "codes": int(c),
            "p": int(config["scann"]["partitioning"]
                     ["num_partitions_to_search"]),
            "measure": config["scann"]["distance_measure"],
        }

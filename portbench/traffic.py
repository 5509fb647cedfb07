"""The one generator of requests, driven by a mix file.

A mix (``mixes/<traffic>.json``) gives:

- ``loop``: "closed" (the only kind so far): ``clients`` callers, each
  sending its next request when the last one's results are on the host;
- ``batch``: queries a request;
- ``order``: "cycle" (the query set in order, batch after batch, from the
  start again when it runs out);
- ``k``: neighbours a query; ``reorder``: candidates the exact re-rank
  takes (the facade's ``reordering_num_candidates``);
- ``warmup_batches``: requests of the same shape sent in set-up (at
  least one).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass
class Schedule:
    batches: List[torch.Tensor]   # the query set cut into requests
    k: int
    reorder: int
    warmup: int

    def request(self, i: int) -> int:
        """The slice of the ``i``-th request."""
        return i % len(self.batches)


def schedule(mix: dict, queries: torch.Tensor) -> Schedule:
    if mix.get("loop") != "closed" or int(mix.get("clients", 1)) != 1:
        raise ValueError(f"unsupported loop in mix {mix}")
    if mix.get("order") != "cycle":
        raise ValueError(f"unsupported order in mix {mix}")
    b = int(mix["batch"])
    if queries.shape[0] % b:
        raise ValueError(f"{queries.shape[0]} queries do not split into "
                         f"batches of {b}")
    warmup = int(mix["warmup_batches"])
    if warmup < 1:
        raise ValueError("a mix warms up with at least one request")
    return Schedule(batches=list(torch.split(queries, b)), k=int(mix["k"]),
                    reorder=int(mix["reorder"]), warmup=warmup)

"""Asymmetric-hasher configuration (counterpart of the config half of
``scann_tpu/hashes/hasher.py``). The hasher searcher itself waits for
ROADMAP.md queue 1, item 6."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class AsymmetricHasherConfig:
    num_codes: int = 256
    num_subspaces: int = 8
    seed: Optional[int] = None
    max_iterations: int = 25
    training_sample_size: int = 100_000
    # score-aware (AVQ) training: not ported yet (ROADMAP.md queue 1,
    # item 3); builds raise when it is set. An index trained with it
    # serves like any other.
    anisotropic_threshold: Optional[float] = None

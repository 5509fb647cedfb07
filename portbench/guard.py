"""The check that a run loaded neither JAX nor the JAX package.

Module names are compared by their top-level name (the part before the
first dot), whole: ``scann_tpu_torch`` is the program under test and
passes; ``scann_tpu``, ``jax``, ``jaxlib`` and ``flax`` do not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "scann_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)

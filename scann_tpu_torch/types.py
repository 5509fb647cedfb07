"""Shared numeric helpers (counterpart of ``scann_tpu/types.py``).

The GPU has no (sublane, lane) register tiling to pad for; what the port
keeps is the masked-slot sentinel and the alignment helper its CSR layout
uses.
"""

from __future__ import annotations

import numpy as np

# Sentinel distance for masked-out (padded / filtered) candidates. A large
# finite value instead of +inf keeps top-k well-defined and avoids NaN from
# inf-inf arithmetic in fused score transforms.
MASKED_DISTANCE = np.float32(3.4e38) / 2


def align_up(x: int, alignment: int) -> int:
    """Round ``x`` up to a multiple of ``alignment``."""
    if alignment <= 0:
        raise ValueError(f"alignment must be positive, got {alignment}")
    return ((x + alignment - 1) // alignment) * alignment

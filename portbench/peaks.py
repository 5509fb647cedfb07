"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates) and the least time a count of work can take on it.

Frozen copies of ``chip_smoke.py``'s table. The rates assume the card's
full 700 W power limit; a run records the card's limit beside them.
"""

from __future__ import annotations

PEAK_HBM_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 adds outside the tensor cores: the float32 peak counts an FMA as
# two operations, a plain add is one a lane a clock on the 128 float32 lanes
# of an SM (132 SMs x 128 x 1.98 GHz)
PEAK_F32_ADDS_S = PEAK_F32_FLOPS / 2


def least_s(ops: float, ops_peak: float, nbytes: float) -> float:
    """Least seconds for the work: the larger of operations over their
    peak and bytes over the memory's bandwidth."""
    return max(ops / ops_peak, nbytes / PEAK_HBM_BYTES_S)

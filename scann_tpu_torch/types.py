"""Shared numeric helpers (counterpart of ``scann_tpu/types.py``).

The GPU has no (sublane, lane) register tiling to pad for; what the port
keeps is the masked-slot sentinel, the alignment helpers and the one place
where a device is checked before use (the JAX package's ``is_tpu`` probe
has the same role there).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

# Sentinel distance for masked-out (padded / filtered) candidates. A large
# finite value instead of +inf keeps top-k well-defined and avoids NaN from
# inf-inf arithmetic in fused score transforms.
MASKED_DISTANCE = np.float32(3.4e38) / 2

# Every entry point of the port runs on the current CUDA device unless the
# caller names another device (the CPU tests pass device="cpu").
DEFAULT_DEVICE = "cuda"

# Shared memory one thread block may use on Hopper (bytes), the limit every
# kernel wrapper checks before a launch.
MAX_SHARED_MEMORY = 232_448


def align_up(x: int, alignment: int) -> int:
    """Round ``x`` up to a multiple of ``alignment``."""
    if alignment <= 0:
        raise ValueError(f"alignment must be positive, got {alignment}")
    return ((x + alignment - 1) // alignment) * alignment


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def require_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``, checked before any tensor moves
    there: a CUDA device where none is available raises instead of letting
    the work carry on elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"scann_tpu_torch runs on {device} by default, but no CUDA "
            f"device is available; pass device='cpu' to run on the CPU")
    return device


def on_card(t: torch.Tensor, fn_name: str) -> bool:
    """Where a kernel wrapper sends ``t``: True for a CUDA tensor (the
    kernel), False for a CPU tensor (its plain twin); any other device
    raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{fn_name} runs on CPU or CUDA tensors, got "
                         f"{t.device}")
    return True


def pad_rows(arr: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    """Pad the leading dimension of ``arr`` up to a multiple of ``multiple``
    (numpy, as the JAX package pads host arrays)."""
    n = arr.shape[0]
    n_pad = align_up(max(n, 1), multiple)
    if n_pad == n:
        return arr
    pad_widths = [(0, n_pad - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_widths, constant_values=fill)

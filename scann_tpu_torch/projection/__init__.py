"""Projections: dimensionality reduction and rotations applied before
hashing (counterpart of ``scann_tpu/projection``).

Every projection shares one interface: ``project(x [.., D_in]) ->
[.., D_out]`` as a batched product on the projection's device, optional
``inverse_project``, and a ``ProjectionFactory`` keyed by name. Inputs may
be numpy arrays or tensors; outputs are float32 tensors on the device.
"""

from scann_tpu_torch.projection.base import (
    IdentityProjection,
    Projection,
    ProjectionFactory,
)
from scann_tpu_torch.projection.chunking import (
    ChunkingConfig,
    ChunkingProjection,
)
from scann_tpu_torch.projection.opq import OpqConfig, OpqProjection
from scann_tpu_torch.projection.pca import PcaProjection
from scann_tpu_torch.projection.random import (
    RandomGaussianProjection,
    RandomOrthogonalProjection,
)
from scann_tpu_torch.projection.truncate import TruncateProjection

__all__ = [
    "Projection",
    "IdentityProjection",
    "ProjectionFactory",
    "PcaProjection",
    "RandomOrthogonalProjection",
    "RandomGaussianProjection",
    "OpqProjection",
    "OpqConfig",
    "TruncateProjection",
    "ChunkingProjection",
    "ChunkingConfig",
]

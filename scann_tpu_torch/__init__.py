"""scann_tpu_torch — the PyTorch and CUDA port of scann_tpu for one NVIDIA
Hopper GPU (H100).

It mirrors ``scann_tpu``'s module layout and names: each module sits where
its JAX counterpart sits. Plain tensor code is PyTorch; every Pallas kernel
of the JAX package on a ported path becomes a CUDA kernel in ``csrc/``,
built with ``nvcc`` at first use, with a plain PyTorch twin beside it that
CPU tensors take. The package never imports JAX.

Entry points run on the current CUDA device unless the caller names another
device (``device="cpu"``). The port serves the tree-x-AH search (partitions,
residual PQ with packed int4 codes, exact re-rank) and builds its index, the
block-sweep search (bf16 block-min sweep, exact re-rank), the
asymmetric-hashing search (PQ with LUT16 scoring: the fused int8 sweep over
packed nibbles, exact re-rank), exact brute force (every dense measure; one
fused kernel for small databases) and brute force over int8, int4, bf16 or
fp8 copies of the rows (the int8-dots kernel for the integer codes).
"""

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ErrorCode, ScannError
from scann_tpu_torch.hashes.hasher import (
    AsymmetricHasher,
    AsymmetricHasherConfig,
)
from scann_tpu_torch.io import from_numpy_state, load_index
from scann_tpu_torch.models.block_sweep import (
    BlockSweepConfig,
    BlockSweepSearcher,
)
from scann_tpu_torch.models.brute_force import BruteForceSearcher
from scann_tpu_torch.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher,
    ScalarQuantizedConfig,
)
from scann_tpu_torch.models.searcher import (
    NNResult,
    SearchParameters,
    SearchResult,
)
from scann_tpu_torch.models.tree_x_hybrid import (
    TreeXHybridConfig,
    TreeXHybridSearcher,
)
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.quantization.scalar import (
    QuantizedDataset,
    ScalarQuantizer,
    ScalarQuantizerConfig,
)

__all__ = [
    "AsymmetricHasher",
    "AsymmetricHasherConfig",
    "BlockSweepConfig",
    "BlockSweepSearcher",
    "BruteForceSearcher",
    "DenseDataset",
    "DistanceMeasure",
    "ErrorCode",
    "NNResult",
    "QuantizedDataset",
    "ScalarQuantizedBruteForceSearcher",
    "ScalarQuantizedConfig",
    "ScalarQuantizer",
    "ScalarQuantizerConfig",
    "ScannError",
    "SearchParameters",
    "SearchResult",
    "TreeXHybridConfig",
    "TreeXHybridSearcher",
    "from_numpy_state",
    "load_index",
]

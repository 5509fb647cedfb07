"""scann_tpu_torch — the PyTorch and CUDA port of scann_tpu for one NVIDIA
Hopper GPU (H100).

It mirrors ``scann_tpu``'s module layout and names: each module sits where
its JAX counterpart sits. Plain tensor code is PyTorch; every Pallas kernel
of the JAX package on a ported path becomes a CUDA kernel in ``csrc/``,
built with ``nvcc`` at first use, with a plain PyTorch twin beside it that
CPU tensors take. The package never imports JAX.

Entry points run on the current CUDA device unless the caller names another
device (``device="cpu"``). The ``Scann`` facade and ``ScannBuilder`` route
a ``ScannConfig`` to one of six searchers: the tree-x-AH search (partitions,
residual PQ with packed int4 codes, exact re-rank), the partitioned exact
search (flat or hierarchical k-means partitions), the block-sweep search
(bf16 block-min sweep, exact re-rank), the asymmetric-hashing search (PQ
with LUT16 scoring: the fused int8 sweep over packed nibbles, exact
re-rank; plain or anisotropic codebooks), exact brute force (every dense
measure; one fused kernel for small databases) and brute force over int8,
int4, bf16 or fp8 copies of the rows (the int8-dots kernel for the integer
codes). ``save_index`` and ``load_index`` write and read the JAX package's
index files.
"""

from scann_tpu_torch.config import (
    BruteForceConfig,
    ExactReorderingConfig,
    HashConfig,
    PartitioningConfig,
    QueryConfig,
    ScannConfig,
)
from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ErrorCode, ScannError
from scann_tpu_torch.hashes.hasher import (
    AsymmetricHasher,
    AsymmetricHasherConfig,
)
from scann_tpu_torch.io import from_numpy_state, load_index, save_index
from scann_tpu_torch.models.block_sweep import (
    BlockSweepConfig,
    BlockSweepSearcher,
)
from scann_tpu_torch.models.brute_force import BruteForceSearcher
from scann_tpu_torch.models.partitioned import PartitionedSearcher
from scann_tpu_torch.models.scalar_quantized import (
    ScalarQuantizedBruteForceSearcher,
    ScalarQuantizedConfig,
)
from scann_tpu_torch.models.scann import (
    Scann,
    ScannBuilder,
    SearchMode,
    auto_config,
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
    "BruteForceConfig",
    "BruteForceSearcher",
    "DenseDataset",
    "DistanceMeasure",
    "ErrorCode",
    "ExactReorderingConfig",
    "HashConfig",
    "NNResult",
    "PartitionedSearcher",
    "PartitioningConfig",
    "QuantizedDataset",
    "QueryConfig",
    "ScalarQuantizedBruteForceSearcher",
    "ScalarQuantizedConfig",
    "ScalarQuantizer",
    "ScalarQuantizerConfig",
    "Scann",
    "ScannBuilder",
    "ScannConfig",
    "ScannError",
    "SearchMode",
    "SearchParameters",
    "SearchResult",
    "TreeXHybridConfig",
    "TreeXHybridSearcher",
    "auto_config",
    "from_numpy_state",
    "load_index",
    "save_index",
]

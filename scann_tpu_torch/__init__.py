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
index files. Datasets carry docids into every result; ``mutator``
serves a dataset under adds, updates and removes, ``restricts`` filters
and crowds results (both imported by module path, as in the JAX package).
``SparseBruteForceSearcher`` serves the set measures and weighted Jaccard
over a ``SparseDataset`` from its nonzeros; ``projection``, ``utils.gmm``
and ``hashes.stacked`` hold the projections, the Gaussian mixture and the
residual quantizers, and ``prelude`` re-exports the common names.
``Scann.auto`` chooses and tunes a config from the card's profile
(``utils.chip_profile``), sample statistics (``utils.advisor``) and a
recall target (``utils.autotune``); ``harness.ann_benchmark`` is the
ANN-Benchmarks-style runner.
"""

from scann_tpu_torch.config import (
    BruteForceConfig,
    ExactReorderingConfig,
    HashConfig,
    PartitioningConfig,
    QueryConfig,
    ScannConfig,
)
from scann_tpu_torch.data.dataset import DenseDataset, SparseDataset
from scann_tpu_torch.data.docid import DocIdCollection
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
from scann_tpu_torch.models.sparse_brute_force import SparseBruteForceSearcher
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
from scann_tpu_torch.utils.advisor import (
    advise_build,
    advise_config,
    dataset_stats,
)
from scann_tpu_torch.utils.autotune import (
    AutotuneResult,
    SweepAutotuneResult,
    autotune,
    autotune_block_sweep,
)
from scann_tpu_torch.utils.chip_profile import (
    ChipProfile,
    calibrate,
    load_profile,
)

__all__ = [
    "AsymmetricHasher",
    "AsymmetricHasherConfig",
    "AutotuneResult",
    "BlockSweepConfig",
    "BlockSweepSearcher",
    "BruteForceConfig",
    "BruteForceSearcher",
    "ChipProfile",
    "DenseDataset",
    "DistanceMeasure",
    "DocIdCollection",
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
    "SparseBruteForceSearcher",
    "SparseDataset",
    "SweepAutotuneResult",
    "TreeXHybridConfig",
    "TreeXHybridSearcher",
    "advise_build",
    "advise_config",
    "auto_config",
    "autotune",
    "autotune_block_sweep",
    "calibrate",
    "dataset_stats",
    "from_numpy_state",
    "load_index",
    "load_profile",
    "save_index",
]

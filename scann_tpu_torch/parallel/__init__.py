"""Scale-out over a mesh of devices (counterpart of
``scann_tpu/parallel``).

  - **database sharding**: the rows, codes and partition tables split over
    the mesh's devices; each shard keeps a local top-k and the [B, k]
    partials merge on the mesh's home device;
  - **query-batch splitting**: on a 2-D ("q", "db") mesh the batch splits
    over the second axis (the sharded exact search).

A mesh is a numpy array of ``torch.device`` with named axes
(:func:`make_mesh`); it may name one device several times, so several
shards can share one card (or the CPU, in tests). Across processes the
merge runs on ``torch.distributed`` (:mod:`.multihost`).
"""

from scann_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_rows,
)
from scann_tpu_torch.parallel.sharded import (
    ShardedBruteForceSearcher,
    sharded_kmeans_step,
    sharded_search_kernel,
)
from scann_tpu_torch.parallel.sharded_flagship import (
    ShardedAsymmetricHasher,
    ShardedBlockSweepSearcher,
    ShardedTreeXHybridSearcher,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_rows",
    "replicate",
    "ShardedBruteForceSearcher",
    "ShardedAsymmetricHasher",
    "ShardedBlockSweepSearcher",
    "ShardedTreeXHybridSearcher",
    "sharded_kmeans_step",
    "sharded_search_kernel",
]

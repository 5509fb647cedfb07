"""Worker process of ``tests/test_torch_multihost.py``.

Run as: python torch_multihost_worker.py <process_id> <num_processes> <port>

Each process holds 2 CPU shards; ``torch.distributed`` with gloo joins the
processes into one 2 x 2-shard mesh (``global_mesh``). The database rows
are sharded across every process's shards (each process places only its
own rows, the range ``process_local_rows`` gives it), queries replicate,
and the sharded searches' merges cross the process boundary. Imports
neither JAX nor the JAX package.
"""

import os
import sys

proc_id, num_procs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

import numpy as np
import torch

torch.set_num_threads(1)

from scann_tpu_torch import (
    AsymmetricHasherConfig,
    DenseDataset,
    DistanceMeasure,
    SearchParameters,
    TreeXHybridConfig,
    TreeXHybridSearcher,
)
from scann_tpu_torch.ops.distances import squared_norms
from scann_tpu_torch.parallel.mesh import shard_rows
from scann_tpu_torch.parallel.multihost import (
    global_mesh,
    initialize_multihost,
    process_local_rows,
)
from scann_tpu_torch.parallel.sharded import sharded_search_kernel
from scann_tpu_torch.parallel.sharded_flagship import (
    ShardedTreeXHybridSearcher,
)

CPU = torch.device("cpu")
got = initialize_multihost(f"127.0.0.1:{port}", num_procs, proc_id,
                           device="cpu")
assert got == proc_id, (got, proc_id)
# a second call returns the group already joined
assert initialize_multihost(f"127.0.0.1:{port}", num_procs, proc_id,
                            device="cpu") == proc_id
assert torch.distributed.get_world_size() == num_procs

mesh = global_mesh(local_devices=[CPU, CPU])
assert mesh.devices.size == 2 * num_procs, mesh
assert sum(mesh.axis_local("db")) == 2

# deterministic data: every process can compute the whole array for the
# exact answer, but places only its own row range in its shards
N, D, K = 512, 24, 8
rng = np.random.default_rng(1234)
full = rng.normal(size=(N, D)).astype(np.float32)
queries = rng.normal(size=(16, D)).astype(np.float32)

lo, hi = process_local_rows(N)
assert hi - lo == N // num_procs, (lo, hi)
db, n = shard_rows(mesh, full[lo:hi], process_local=True)
assert n == N
assert sum(x is not None for x in db) == 2
norms = [None if x is None else squared_norms(x) for x in db]
kernel = sharded_search_kernel(mesh, DistanceMeasure.SQUARED_L2, K)
dists, idx = kernel(db, norms, N, torch.from_numpy(queries))
idx_np, dists_np = idx.numpy(), dists.numpy()

d2 = ((queries[:, None, :] - full[None, :, :]) ** 2).sum(-1)
gt = np.argsort(d2, axis=1, kind="stable")[:, :K]
for i in range(len(queries)):
    assert set(idx_np[i]) == set(gt[i]), (proc_id, i, idx_np[i], gt[i])
np.testing.assert_allclose(dists_np, np.sort(d2, axis=1)[:, :K], rtol=1e-4,
                           atol=1e-4)
print(f"proc {proc_id}: multihost sharded search OK", flush=True)

# ---------------------------------------------------------------------------
# tree-x-AH across the process boundary: every process builds the same
# index (a seeded build), the wrapper places each shard's partitions on the
# process that owns the shard, and the [k] partials merge across processes
# ---------------------------------------------------------------------------
tree = TreeXHybridSearcher(TreeXHybridConfig(
    num_partitions=8, partitions_to_search=8,
    hash_config=AsymmetricHasherConfig(num_codes=16, num_subspaces=6,
                                       seed=7, max_iterations=5),
), device="cpu").build(DenseDataset(full))
sharded_tree = ShardedTreeXHybridSearcher(tree, mesh)
assert sum(c is not None for c in sharded_tree._codes) == 2
params = SearchParameters(pre_reordering_num_neighbors=64)
idx_t, dists_t = sharded_tree.search_batched_arrays(queries, K, params)
idx_1, _ = tree.search_batched_arrays(queries, K, params)


def recall(ids):
    return np.mean([len(set(map(int, ids[i])) & set(map(int, gt[i]))) / K
                    for i in range(len(queries))])


# every shard keeps a full local pre_k: recall >= one device's
assert recall(idx_t) >= recall(idx_1) - 1e-9, (proc_id, recall(idx_t),
                                              recall(idx_1))
assert recall(idx_t) >= 0.9, (proc_id, recall(idx_t))
m = idx_t >= 0
d_ret = ((queries[:, None, :] - full[np.maximum(idx_t, 0)]) ** 2).sum(-1)
np.testing.assert_allclose(dists_t[m], d_ret[m], rtol=1e-4, atol=1e-4)
print(f"proc {proc_id}: multihost sharded tree-AH OK", flush=True)

# ---------------------------------------------------------------------------
# warm start across the process boundary: each process saves and loads its
# own file (layouts are deterministic) into the same mesh placement
# ---------------------------------------------------------------------------
path = os.path.join(sys.argv[4], f"layout_{proc_id}.npz")
sharded_tree.save_layout(path)
reloaded = ShardedTreeXHybridSearcher.load_layout(path, mesh, device="cpu")
idx_r, dists_r = reloaded.search_batched_arrays(queries, K, params)
np.testing.assert_array_equal(idx_r, idx_t)
np.testing.assert_array_equal(dists_r, dists_t)
os.unlink(path)
print(f"proc {proc_id}: multihost warm-start OK", flush=True)
torch.distributed.destroy_process_group()

"""Hierarchical k-means tree (counterpart of
``scann_tpu/trees/kmeans_tree.py``).

Recursive k-means: each internal node clusters its points with the
device k-means and recurses; a node becomes a leaf when depth >=
max_depth, or it holds <= min_leaf_size points, or <= num_children points
(the reference's stop rules, kmeans_tree.rs:224-226). A child's seed is its
parent's + 17 * (c + 1), as in the JAX package. Leaves are numbered in
build order, so the tree doubles as a partitioner (leaf id = partition
token). Search is greedy best-first over node centres with an early stop
after k*2 leaf candidates.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Union

import numpy as np
import torch

from scann_tpu_torch.data.dataset import DenseDataset
from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.trees.kmeans import KMeans, KMeansConfig, KMeansInit
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


@dataclasses.dataclass
class KMeansTreeConfig:
    """The JAX package's ``KMeansTreeConfig``, field for field."""

    num_children: int = 100
    max_depth: int = 1
    min_leaf_size: int = 1
    max_iterations: int = 25
    seed: int = 42


class KMeansTreeNode:
    """A node: its centre [D] float32, depth, children, and for a leaf its
    point ids [n] int64 and leaf id."""

    def __init__(self, center: torch.Tensor, depth: int):
        self.center = center
        self.depth = depth
        self.children: List["KMeansTreeNode"] = []
        self.indices: Optional[torch.Tensor] = None
        self.leaf_id: int = -1
        self._child_centers: Optional[torch.Tensor] = None

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def child_centers(self) -> torch.Tensor:
        """[children, D] centres of the children, stacked once."""
        if self._child_centers is None:
            self._child_centers = torch.stack(
                [ch.center for ch in self.children])
        return self._child_centers


class KMeansTree:
    """Hierarchical k-means on ``device``."""

    def __init__(self, config: Optional[KMeansTreeConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or KMeansTreeConfig()
        self.device = torch.device(device)
        self.root: Optional[KMeansTreeNode] = None
        self.num_leaves = 0
        self._leaves: List[KMeansTreeNode] = []

    def build(self, data) -> "KMeansTree":
        """Build over ``data`` [N, D] (a DenseDataset, numpy or a tensor,
        moved to the tree's device)."""
        device = require_device(self.device)
        if isinstance(data, DenseDataset):
            data = data.device_tensor(device)
        x = torch.as_tensor(data, dtype=torch.float32, device=device)
        if x.shape[0] == 0:
            raise ScannError.invalid_argument(
                "cannot build tree on empty dataset")
        self._leaves = []
        self.root = self._build_node(
            x, torch.arange(len(x), device=x.device), x.mean(dim=0),
            depth=0, seed=self.config.seed)
        self.num_leaves = len(self._leaves)
        return self

    def _make_leaf(self, node: KMeansTreeNode, indices: torch.Tensor
                   ) -> KMeansTreeNode:
        node.indices = indices
        node.leaf_id = len(self._leaves)
        self._leaves.append(node)
        return node

    def _build_node(self, data: torch.Tensor, indices: torch.Tensor,
                    center: torch.Tensor, depth: int, seed: int
                    ) -> KMeansTreeNode:
        cfg = self.config
        node = KMeansTreeNode(center.float(), depth)
        n = len(indices)
        if (depth >= cfg.max_depth or n <= cfg.min_leaf_size
                or n <= cfg.num_children):
            return self._make_leaf(node, indices)
        k = min(cfg.num_children, n)
        res = KMeans(KMeansConfig(
            num_clusters=k, max_iterations=cfg.max_iterations,
            init_method=KMeansInit.KMEANS_PLUS_PLUS, seed=seed,
        ), device=data.device).fit(data[indices])
        for c in range(k):
            sub = indices[res.assignments == c]
            if len(sub) == 0:
                continue
            node.children.append(self._build_node(
                data, sub, res.centers[c], depth + 1, seed + 17 * (c + 1)))
        if not node.children:
            return self._make_leaf(node, indices)
        return node

    # -- introspection ------------------------------------------------------
    def leaves(self) -> List[KMeansTreeNode]:
        return list(self._leaves)

    def leaf_centers(self) -> torch.Tensor:
        """[leaves, D] float32 centres, in leaf id order."""
        return torch.stack([leaf.center for leaf in self._leaves])

    def leaf_assignments(self, n: int) -> torch.Tensor:
        """[n] int64 leaf id per datapoint (-1 for a point in no leaf)."""
        out = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        for leaf in self._leaves:
            out[leaf.indices.to(out.device)] = leaf.leaf_id
        return out

    # -- search --------------------------------------------------------------
    def _walk(self, query, stop):
        """Best-first traversal of the leaves, nearest centre first (ties
        in push order); ``stop(leaf)`` is called on each leaf and ends the
        walk when it returns True."""
        if self.root is None:
            raise ScannError.failed_precondition("tree not built")
        q = torch.as_tensor(np.asarray(query, np.float32))
        heap = [(0.0, 0, self.root)]
        tie = 1
        while heap:
            _, _, node = heapq.heappop(heap)
            if node.is_leaf:
                if stop(node):
                    return
                continue
            cc = node.child_centers()
            d = ((q.to(cc.device) - cc) ** 2).sum(dim=1).tolist()
            for dist, ch in zip(d, node.children):
                heapq.heappush(heap, (dist, tie, ch))
                tie += 1

    def search_leaves(self, query, num_leaves: int) -> List[int]:
        """Leaf ids nearest-first, at most ``num_leaves``."""
        out: List[int] = []
        if num_leaves <= 0:
            return out

        def take(leaf):
            out.append(leaf.leaf_id)
            return len(out) >= num_leaves

        self._walk(query, take)
        return out

    def search_candidates(self, query, k: int) -> torch.Tensor:
        """Point ids of the nearest leaves until >= k*2 are collected (the
        reference's early stop), int64."""
        cand: List[torch.Tensor] = []
        total = [0]
        if 2 * k <= 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device)

        def take(leaf):
            cand.append(leaf.indices)
            total[0] += len(leaf.indices)
            return total[0] >= 2 * k

        self._walk(query, take)
        return (torch.cat(cand) if cand
                else torch.zeros(0, dtype=torch.int64, device=self.device))

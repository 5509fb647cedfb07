"""K-means tree partitioner (counterpart of
``scann_tpu/partitioning/tree_partitioner.py``).

Build = k-means over the dataset (or a seeded training sample of it), every
row assigned to its nearest centroid, then optionally:

  - balancing (``max_partition_size``): LBG splits of oversized partitions
    with Lloyd refinement, demotion of the lowest-regret members of
    partitions still over the cap to their next-nearest centre, and a
    principal-axis split of the stragglers that leaves every partition at
    or under the cap;
  - spilling: a second assignment for points near a boundary ("distance")
    or for every point by the SOAR loss ("soar"), the secondaries capped
    per partition when balancing is on.

The LBG picks, the demote loop, the straggler split and the secondary cap
run on the host in numpy with the JAX package's ``np.random.default_rng``
draws, so on equal inputs they return its arrays exactly; the Lloyd steps,
the tokenization and every top-r selection run on the device.

k-means trains and tokenizes in squared L2 under every measure; the
configured measure decides the cap's demotion choices, distance spilling
and the query-side selection (``partition_batch``), as in the JAX package.
``num_levels > 1`` builds a hierarchical k-means tree
(``trees/kmeans_tree.py``) whose leaves become the partitions: fan-out
ceil(k ** (1 / levels)), at least 2, no balancing or spilling.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.ops.distances import DistanceMeasure, many_to_many
from scann_tpu_torch.ops.topk import top_k_smallest
from scann_tpu_torch.partitioning.partitioner import (
    DatabaseTokenization,
    PartitionResult,
)
from scann_tpu_torch.trees.kmeans import (
    KMeans,
    KMeansConfig,
    KMeansInit,
    adaptive_row_chunk,
    assign_clusters,
    lloyd_step,
)
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device


@dataclasses.dataclass
class TreePartitionerConfig:
    """The JAX package's ``TreePartitionerConfig``, field for field."""

    num_partitions: int = 100
    max_iterations: int = 100
    convergence_threshold: float = 1e-5
    seed: int = 42
    distance_measure: DistanceMeasure = DistanceMeasure.SQUARED_L2
    num_levels: int = 1
    training_sample_size: Optional[int] = None
    # spilling: also assign a point to its 2nd-nearest partition when
    # d2 <= d1 * (1 + spilling_threshold) ("distance"), or give EVERY point
    # one secondary chosen by ||r2||^2 + lambda * <r2, r1_hat>^2 ("soar")
    spilling: bool = False
    spilling_threshold: float = 0.1
    spilling_mode: str = "distance"
    soar_lambda: float = 1.0
    soar_candidates: int = 8
    # balance cap: None = off, "auto" = 1.5 x the mean size at the
    # configured partition count
    max_partition_size: Optional[object] = None
    balance_rounds: int = 4
    cap_enforce_rounds: int = 12
    cap_enforce_choices: int = 12
    # principal-axis split of partitions the demote rounds left oversized
    split_stragglers: bool = True


def select_partitions(centers: torch.Tensor, x: torch.Tensor, *,
                      measure: DistanceMeasure, p: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-p centroid distances [B, p], tokens [B, p]) of rows ``x``."""
    return top_k_smallest(many_to_many(measure, x, centers), p)


def lbg_grow_centers(data: np.ndarray, tokens: np.ndarray,
                     centers: np.ndarray, cap: int,
                     rng: np.random.Generator) -> Optional[np.ndarray]:
    """One LBG splitting step: add jittered member copies of every
    oversized centroid, then pad K to a multiple of 256 with random dataset
    rows. Returns the grown [K', D] centers, or None when no partition
    exceeds ``cap``. The JAX package's function, draw for draw."""
    sizes = np.bincount(tokens, minlength=centers.shape[0])
    if sizes.max() <= cap:
        return None
    n = len(data)
    new_centers = [centers]
    for t in np.nonzero(sizes > cap)[0]:
        members = np.nonzero(tokens == t)[0]
        n_extra = min(int(sizes[t] // cap), len(members))
        if n_extra <= 0:
            continue
        picks = rng.choice(members, size=n_extra, replace=False)
        new_centers.append(
            data[picks] + rng.normal(size=(n_extra, data.shape[1])
                                     ).astype(np.float32) * 1e-4)
    centers = np.concatenate(new_centers, axis=0)
    k_pad = ((centers.shape[0] + 255) // 256) * 256
    if k_pad > centers.shape[0]:
        pad_n = k_pad - centers.shape[0]
        extra = rng.choice(n, size=pad_n, replace=pad_n > n)
        centers = np.concatenate([centers, data[extra]], axis=0)
    return centers


def demote_to_cap(dists: np.ndarray, choices: np.ndarray, cap: int,
                  rounds: int) -> np.ndarray:
    """Host demote loop of the balance cap: given each point's top-r
    nearest centers (``dists`` [N, r] ascending, ``choices`` [N, r]), move
    the lowest-regret members of oversized partitions to their next choice
    until every partition is <= cap or the choices run out. The JAX
    package's function."""
    r = choices.shape[1]
    nn = len(choices)
    rows = np.arange(nn)
    choice_idx = np.zeros(nn, np.int32)
    for _ in range(max(rounds, 0)):
        cur_t = choices[rows, choice_idx]
        cur_d = dists[rows, choice_idx]
        nxt_d = dists[rows, np.minimum(choice_idx + 1, r - 1)]
        regret = np.where(choice_idx < r - 1, nxt_d - cur_d, np.inf)
        order = np.lexsort((-regret, cur_t))
        sorted_t = cur_t[order]
        newrun = np.empty(nn, bool)
        newrun[0] = True
        np.not_equal(sorted_t[1:], sorted_t[:-1], out=newrun[1:])
        run_start = np.maximum.accumulate(np.where(newrun, rows, 0))
        rank = np.empty(nn, np.int64)
        rank[order] = rows - run_start
        demote = (rank >= cap) & (choice_idx < r - 1)
        if not demote.any():
            break
        choice_idx = np.where(demote, choice_idx + 1, choice_idx)
    return choices[rows, choice_idx].astype(np.int32)


def soar_select(centers: torch.Tensor, x: torch.Tensor,
                primary: torch.Tensor, lam: float, *, r: int
                ) -> torch.Tensor:
    """SOAR secondary tokens [B] of rows ``x`` [B, D] with primary tokens
    ``primary`` [B]: the argmin over the r nearest centers (the primary
    excluded) of ||x - c_j||^2 + lam * <x - c_j, r1_hat>^2, r1 = x - c1.
    The first minimum wins, as ``jnp.argmin``; ``lam`` is float32."""
    _, cand = select_partitions(centers, x,
                                measure=DistanceMeasure.SQUARED_L2, p=r)
    r1 = x - centers[primary]
    r1h = r1 / torch.linalg.norm(r1, dim=-1, keepdim=True).clamp_min(1e-30)
    r2 = x[:, None, :] - centers[cand]                        # [B, r, D]
    base = torch.sum(r2 * r2, dim=-1)
    par = torch.einsum("brd,bd->br", r2, r1h)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=x.device)
    loss = base + lam_t * par * par
    loss = torch.where(cand == primary[:, None], float("inf"), loss)
    return torch.gather(cand, 1, torch.argmin(loss, dim=-1, keepdim=True))[:, 0]


class TreePartitioner:
    """Flat k-means partitioner on ``device``."""

    def __init__(self, config: Optional[TreePartitionerConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or TreePartitionerConfig()
        self.device = torch.device(device)
        self.centers: Optional[torch.Tensor] = None      # [K, D] float32
        self.tokenization: Optional[DatabaseTokenization] = None
        self.tree = None                                 # num_levels > 1

    def build(self, data: torch.Tensor,
              host: Optional[np.ndarray] = None) -> "TreePartitioner":
        """Train centroids on ``data`` [N, D] (a device tensor) and tokenize
        every row. ``host`` is the same rows in numpy, if the caller has
        them; balancing reads members from the host copy (made here when
        not given)."""
        cfg = self.config
        data = torch.as_tensor(data).to(require_device(self.device)).float()
        n = data.shape[0]
        if n == 0:
            raise ScannError.invalid_argument("cannot partition empty dataset")
        k = min(cfg.num_partitions, n)
        if cfg.num_levels > 1:
            return self._build_hierarchical(data, k)

        train = data
        if cfg.training_sample_size is not None and cfg.training_sample_size < n:
            gen = torch.Generator(device=data.device)
            gen.manual_seed(cfg.seed)
            sel = torch.randperm(n, generator=gen, device=data.device)
            train = data[sel[:cfg.training_sample_size]]

        result = KMeans(KMeansConfig(
            num_clusters=k,
            max_iterations=cfg.max_iterations,
            convergence_threshold=cfg.convergence_threshold,
            init_method=KMeansInit.KMEANS_PLUS_PLUS,
            seed=cfg.seed,
        ), device=data.device).fit(train)
        self.centers = result.centers
        tokens = result.assignments if train is data else self.tokenize(data)

        if cfg.max_partition_size is not None:
            if host is None:
                host = data.cpu().numpy()
            tokens = self._balance(data, host, tokens)

        extra = None
        if cfg.spilling:
            if cfg.spilling_mode == "soar":
                extra = self._spill_pairs_soar(data, tokens, cfg.soar_lambda,
                                               cfg.soar_candidates)
            else:
                extra = self._spill_pairs(data, cfg.spilling_threshold)
            if cfg.max_partition_size is not None:
                extra = torch.from_numpy(self._cap_secondaries(
                    extra.cpu().numpy(), tokens.cpu().numpy(), n)).to(
                        data.device)
        self.tokenization = DatabaseTokenization(
            tokens, self.centers.shape[0], extra_pairs=extra)
        return self

    def _build_hierarchical(self, data: torch.Tensor,
                            k: int) -> "TreePartitioner":
        """num_levels > 1: a k-means tree with fan-out ceil(k ** (1 /
        levels)), at least 2, whose leaves (in build order) are the
        partitions."""
        from scann_tpu_torch.trees.kmeans_tree import (
            KMeansTree,
            KMeansTreeConfig,
        )

        cfg = self.config
        fan = max(int(np.ceil(k ** (1.0 / cfg.num_levels))), 2)
        tree = KMeansTree(KMeansTreeConfig(
            num_children=fan, max_depth=cfg.num_levels,
            max_iterations=cfg.max_iterations, seed=cfg.seed,
        ), device=data.device).build(data)
        self.tree = tree
        self.centers = tree.leaf_centers().float()
        self.tokenization = DatabaseTokenization(
            tree.leaf_assignments(data.shape[0]), tree.num_leaves)
        return self

    # -- balancing -------------------------------------------------------------
    def _cap_value(self, n: int) -> int:
        """Balance cap, fixed from the CONFIGURED partition count (balance
        rounds grow the live K; a cap recomputed from it would shrink every
        round)."""
        cap = self.config.max_partition_size
        if cap == "auto":
            k0 = max(min(self.config.num_partitions, n), 1)
            cap = max(int(1.5 * n / k0), 8)
        return int(cap)

    def _balance(self, data: torch.Tensor, host: np.ndarray,
                 tokens: torch.Tensor) -> torch.Tensor:
        """LBG rounds (grow centers, 3 Lloyd steps on the device,
        re-tokenize) until no partition exceeds the cap or
        ``balance_rounds`` run out, then the demote rounds and the
        straggler split."""
        cfg = self.config
        cap = self._cap_value(len(host))
        rng = np.random.default_rng(cfg.seed)
        tokens_np = tokens.cpu().numpy()
        for _ in range(max(cfg.balance_rounds, 0)):
            grown = lbg_grow_centers(host, tokens_np,
                                     self.centers.cpu().numpy(), cap, rng)
            if grown is None:
                break
            centers = torch.from_numpy(grown).to(data.device).float()
            for _ in range(3):
                centers, _ = lloyd_step(data, centers)
            self.centers = centers
            tokens_np = self.tokenize(data).cpu().numpy()
        tokens_np = self._enforce_cap(data, tokens_np, cap)
        if cfg.split_stragglers:
            tokens_np = self._split_stragglers(host, tokens_np, cap)
        return torch.from_numpy(tokens_np).to(data.device).long()

    def _enforce_cap(self, data: torch.Tensor, tokens: np.ndarray,
                     cap: int) -> np.ndarray:
        """Demote members of oversized partitions to their next-nearest
        centers (:func:`demote_to_cap`); the top-r candidates are chunked
        device work, the demote loop host numpy."""
        cfg = self.config
        k = self.centers.shape[0]
        r = min(max(cfg.cap_enforce_choices, 1), k)
        rounds = max(cfg.cap_enforce_rounds, 0)
        if rounds == 0 or r <= 1:
            return tokens
        if np.bincount(tokens, minlength=k).max() <= cap:
            return tokens
        n = data.shape[0]
        chunk = adaptive_row_chunk(131072, n, k)
        dists = np.empty((n, r), np.float32)
        choices = np.empty((n, r), np.int64)
        for lo in range(0, n, chunk):
            d, t = select_partitions(self.centers, data[lo:lo + chunk],
                                     measure=cfg.distance_measure, p=r)
            dists[lo:lo + chunk] = d.cpu().numpy()
            choices[lo:lo + chunk] = t.cpu().numpy()
        return demote_to_cap(dists, choices, cap, rounds)

    def _split_stragglers(self, data: np.ndarray, tokens: np.ndarray,
                          cap: int) -> np.ndarray:
        """Cut every partition still over the cap along its members'
        principal axis (8 power iterations from a seeded start) into equal
        chunks of <= cap, each with its own mean centroid (K grows). The
        JAX package's host computation."""
        centers_np = self.centers.cpu().numpy()
        sizes = np.bincount(tokens, minlength=centers_np.shape[0])
        over = np.nonzero(sizes > cap)[0]
        if len(over) == 0:
            return tokens
        tokens = tokens.copy()
        centers = [centers_np.copy()]
        next_tok = centers_np.shape[0]
        for t in over:
            members = np.nonzero(tokens == t)[0]
            x = data[members].astype(np.float32)
            mu = x.mean(axis=0)
            xc = x - mu
            rng = np.random.default_rng(self.config.seed + int(t))
            v = rng.normal(size=x.shape[1]).astype(np.float32)
            for _ in range(8):
                v = xc.T @ (xc @ v)
                nv = float(np.linalg.norm(v))
                if nv < 1e-30:
                    break
                v /= nv
            order = np.argsort(xc @ v, kind="stable")
            n_child = -(-len(members) // cap)
            chunks = np.array_split(order, n_child)
            centers[0][t] = mu + xc[chunks[0]].mean(axis=0)
            for c in chunks[1:]:
                tokens[members[c]] = next_tok
                centers.append((mu + xc[c].mean(axis=0))[None, :])
                next_tok += 1
        self.centers = torch.from_numpy(
            np.concatenate(centers, axis=0).astype(np.float32)).to(
                self.centers.device)
        return tokens

    # -- spilling ------------------------------------------------------------
    def _spill_pairs(self, data: torch.Tensor, threshold: float,
                     chunk: int = 65536) -> torch.Tensor:
        """[E, 2] (point, token) rows for 2nd-nearest partitions within the
        distance ratio threshold."""
        out = []
        chunk = adaptive_row_chunk(chunk, data.shape[0], self.centers.shape[0])
        for lo in range(0, data.shape[0], chunk):
            d2, t2 = select_partitions(self.centers, data[lo:lo + chunk],
                                       measure=self.config.distance_measure,
                                       p=2)
            ok = d2[:, 1] <= d2[:, 0] * (1.0 + threshold)
            pts = torch.nonzero(ok)[:, 0] + lo
            out.append(torch.stack([pts, t2[ok, 1]], dim=1))
        return torch.cat(out)

    def _spill_pairs_soar(self, data: torch.Tensor, tokens: torch.Tensor,
                          lam: float, r: int, chunk: int = 65536
                          ) -> torch.Tensor:
        """[N, 2] (point, SOAR secondary token) rows, one per point
        (:func:`soar_select` over the r nearest centers)."""
        r = min(max(r, 2), self.centers.shape[0])
        n = data.shape[0]
        chunk = adaptive_row_chunk(chunk, n, self.centers.shape[0])
        sec = torch.cat([
            soar_select(self.centers, data[lo:lo + chunk],
                        tokens[lo:lo + chunk], lam, r=r)
            for lo in range(0, n, chunk)])
        return torch.stack([torch.arange(n, device=data.device), sec], dim=1)

    def _cap_secondaries(self, extra: np.ndarray, tokens: np.ndarray,
                         n: int) -> np.ndarray:
        """Keep at most 2*cap - primaries secondaries per partition; the
        excess drops in a seeded random order (those points keep only their
        primary). The JAX package's host computation."""
        cap = self._cap_value(n)
        prim = np.bincount(tokens, minlength=self.centers.shape[0])
        room = np.maximum(2 * cap - prim, 0)
        rng = np.random.default_rng(self.config.seed)
        order = rng.permutation(len(extra))
        toks = extra[order, 1].astype(np.int64)
        sorter = np.argsort(toks, kind="stable")
        sorted_toks = toks[sorter]
        grp_start = np.r_[0, np.flatnonzero(np.diff(sorted_toks)) + 1]
        group_first = np.repeat(
            grp_start, np.diff(np.r_[grp_start, len(toks)]))
        rank = np.empty(len(toks), np.int64)
        rank[sorter] = np.arange(len(toks)) - group_first
        keep = np.zeros(len(extra), dtype=bool)
        keep[order] = rank < room[toks]
        return extra[keep]

    # -- query ---------------------------------------------------------------
    def tokenize(self, data: torch.Tensor) -> torch.Tensor:
        """[N] int64 nearest-centroid token of every row (chunked so the
        [chunk, K] distance block stays bounded)."""
        return assign_clusters(data.float(), self.centers)[0]

    @property
    def num_partitions(self) -> int:
        return 0 if self.centers is None else self.centers.shape[0]

    def _check_built(self) -> None:
        if self.centers is None:
            raise ScannError.failed_precondition("partitioner not built")

    def partition_centroid(self, token: int) -> torch.Tensor:
        self._check_built()
        return self.centers[token]

    def partition_indices(self, token: int) -> torch.Tensor:
        self._check_built()
        return self.tokenization.partition_indices(token)

    def partition_sizes(self) -> torch.Tensor:
        self._check_built()
        return self.tokenization.partition_sizes

    def centers_device(self) -> torch.Tensor:
        """The [K, D] centres, already on the partitioner's device."""
        self._check_built()
        return self.centers

    def partition_batch(self, queries, num_to_search: int
                        ) -> List[PartitionResult]:
        """Each query's ``num_to_search`` nearest partitions in the
        configured measure, nearest first (ties lower token first)."""
        self._check_built()
        p = min(int(num_to_search), self.num_partitions)
        if p <= 0:
            raise ScannError.invalid_argument(
                "num_to_search must be positive")
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(
            self.centers.device)
        if q.dim() == 1:
            q = q[None, :]
        dists, toks = select_partitions(
            self.centers, q, measure=self.config.distance_measure, p=p)
        dists = dists.cpu().numpy().astype(np.float32)
        toks = toks.cpu().numpy().astype(np.int32)
        return [PartitionResult(tokens=t, distances=d)
                for t, d in zip(toks, dists)]

    def partition(self, query, num_to_search: int) -> PartitionResult:
        """One query's selection (:meth:`partition_batch`)."""
        return self.partition_batch(np.asarray(query)[None, :],
                                    num_to_search)[0]

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scann_tpu_torch``) on one GPU.

Drives the port's five serving paths once at GloVe-100 shape, over
1,183,514 x 100 seeded synthetic clustered vectors and 10 batches of 1024
queries:

- tree-x-AH: builds the index on the card, checks the CUDA grouped
  leaf-scoring kernel against its plain PyTorch twin bit for bit on the
  first batch's real inputs, serves the batches through
  ``TreeXHybridSearcher.search_batched_tensors`` and holds recall@10 against
  exact ground truth;
- block sweep: builds the bf16 augmented copy and the re-rank state on the
  card (``BlockSweepConfig(block_r=64, pre_reorder_k=64)``, bench.py's
  configuration), checks the four forms of the CUDA block-min kernels
  against their twins on the first batch's real augmented queries and the
  full augmented copy (with an allowlist penalty and int8 rows as well): the
  main compact, row-major (r=128), top-2 (r=64, B=512) and float32 q-major
  (r=512, B=128) calls through the wgmma kernel of ``block_min_compact.cu``,
  their int8 + penalty calls through ``block_min_sweep.cu``, as
  ``ops/sweep.sweep_plan`` routes them; serves the batches through
  ``BlockSweepSearcher.search_batched_tensors`` (recall@10 >= 0.99, every
  compact launch on the new kernel), drives the other three forms through
  the searcher (top2 and block_r=128 with recall@10 >= 0.99, block_r=512 at
  B=128, each on the new kernel alone, with its batch median on both
  kernels), and times #3, #4, #5 and #6 beside the old kernel's instances
  of the same calls in turns;
- asymmetric hashing: builds the PQ index on the card (S=50, C=16, the JAX
  package's bench.py configuration), checks the fused int8 LUT16 sweep
  kernel and the query-tiled LUT16 score kernel (at B=1024 bf16, B=128
  float32 and the 16,384-row hasher's call) against their twins bit for
  bit on the first batch's real tables, serves the batches through
  ``AsymmetricHasher.search_batched_tensors`` with pre_k=300 (the fused
  sweep, recall@10 >= 0.9), drives the score kernel through the
  approximate-only path (B=128, float32 scores) and a 16,384-row hasher's
  re-rank path (bf16 scores), and times the score kernel and both paths
  beside the one-column-a-thread kernel it replaced, in turns;
- exact brute force: serves the batches through
  ``BruteForceSearcher.search_batched_tensors`` (the composed path,
  recall@10 >= 0.999), then at the JAX package's bench.py headline shape
  (10,000 x 64 uniform rows, seed 42, k=10) checks the fused small-database
  kernel (the cluster kernel, and the first port's kernel kept as a
  yardstick) against its twin at B=100, serves B=100 through it (recall
  1.0, every launch on the cluster kernel) and B=6400 through the composed
  path; both fused kernels also run, checked against the twin and timed in
  turns, on the two searches the gate refuses (B=1024 over the 1.18M rows,
  B=6400 at the headline shape), and at the headline in turns, back to
  back at k = 1, 10 and 16, with their wrappers' host time;
- scalar-quantized brute force: builds the int8 codes on the card, checks
  the int8-dots kernel against its twin on the first batch and the full
  transposed codes, serves the batches through
  ``ScalarQuantizedBruteForceSearcher`` (recall@10 >= 0.9, ids equal to the
  exact top-10 over the dequantized rows away from ties), and one batch
  each with int4 codes (the same kernel) and bf16 and fp8 storage (the
  float32 product);
- SOAR tree-x-AH (the JAX package's bench.py SOAR row): builds a balanced
  index with one SOAR secondary assignment per point on the card, checks
  the int8-LUT grouped scorer and the per-pair float32 leaf scorer against
  their twins bit for bit on the first batch's real inputs, serves the
  batches through three paths, each counted from zero: the searcher (bf16
  grouped scorer, recall@10 >= 0.95), ``tree_ah_search_grouped`` with int8
  tables (>= 0.9) and ``tree_ah_search`` over the unpacked slab (per-pair
  kernel, >= 0.95); then one batch each of the bf16 / int8 / int16 re-rank
  stores, the id-embedded CSR store on the first tree-x-AH index, an
  allowlist of the even ids, and DOT_PRODUCT and COSINE indexes over the
  first 100,000 rows;
- the ``Scann`` facade (phases 24-28): the JAX package's quick start
  (``ScannBuilder().num_neighbors(10).tree(2000, 10).hash(50, 16)
  .reorder(100)``) built on the 1.18M rows and served (recall@10 >= 0.9,
  ids equal to its tree-x-AH searcher's, #1 launched a batch, timed beside
  the searcher); ``Scann.partitioned(ds, 2000, 10)`` at full width
  (recall@10 >= 0.9, exact distances, stages select, gather, score,
  top-k); every facade mode on the first 100,000 rows (and brute force at
  the headline shape), each with the JAX facade's mode and searcher class,
  its searcher's ids and its kernel (#2, #5, #7, #9) launched;
  ``save_index`` / ``load_index`` round trips on the card (bit-identical);
  a two-level 256-leaf partitioned build and a DOT_PRODUCT tree-x-AH
  build with and without AVQ (recall recorded, no floor);
- dynamic serving (phase 29): a ``DynamicSearcher`` over phase 4's
  tree-x-AH configuration on the 1.18M rows, its rows in the C++ host
  core (required), takes 8,192 adds from the same clusters, 2,048 updates
  to fresh points and 2,048 removes (the exact top-1 of the first 256
  queries among them) and serves the 10 batches (p=10, pre_k=100):
  recall@10 >= 0.9 against exact ground truth over the live rows with
  their current values, no removed id, every distance equal to the exact
  one to the row's current value (1e-3 relative), 1,024 added rows each
  found first by its own vector, #1 launched in every batch; times beside
  the main index searched directly at the same fetch and the stages (main
  fetch, delta slab, merge); then ``force_rebuild()`` and the same checks;
- restricts, crowding and docids (phases 30-32): an allowlist of the even
  ids without [0, 1000) through ``search_batched_with_filter`` on phase
  4's tree-x-AH index (the mask on the card, #1; recall@10 >= 0.9 against
  the filtered exact top-10), on the block sweep (#5 with the allowlist
  penalty, >= 0.99) and the hasher (host over-fetch, #7, >= 0.9) of phase
  26 on the first 100,000 rows, every id allowed, each beside its
  unfiltered time; ``search_with_crowding`` on tree-x-AH with two
  attributes, each row's generating cluster (a query's candidates mostly
  share one) and a hash of its id into 16 groups (they mix within every
  query's candidates; every query must keep 10 results and some must
  change), at most 2 an attribute, equal to ``apply_batch`` and to a plain
  greedy pass over the same candidates, with as many results as those
  candidates' groups allow; docids ``doc<i>`` through
  ``Scann.brute_force`` and the quick-start tree-x-AH facade;
- sparse search (phase 33): 74,962 synthetic sets over 27,983 items (the
  shape of ANN-Benchmarks kosarak-jaccard) with signed values, a
  ``SparseBruteForceSearcher`` for each of the five measures, 500 queries
  a batch: the four set measures through ``search_batched_arrays``
  (distances bit-equal to a host ``scipy.sparse`` count with the same
  float32 formula, ids equal, ties lower index first), WEIGHTED_JACCARD
  through it and ``search_sparse`` (distances within 1e-5 of a float64
  host reference, ids equal where the 10th and 11th differ by more); build
  s, bytes on the card, per-batch CUDA-event ms, the score and select
  stages beside ``torch.topk`` and the rows the selection sent to its key;
- projections and helpers (phase 34) on the 1.18M rows: ``fit_pca`` to 64
  dimensions (rows orthonormal), random orthogonal (orthonormal, distances
  kept on 1,000 pairs) and Gaussian (norms within the JL spread)
  projections, OPQ with 10 subspaces and 10 iterations (a rotation),
  truncation and chunking shapes, a 16-component diagonal Gaussian mixture
  (finite log-likelihood, not below its start's) and a two-level stacked
  quantizer of 50 x 16 codes trained on 100,000 rows and encoding all (the
  second level lowers the error);
- tuning and the harness (phases 35-38): ``calibrate`` on the card (the
  block sweep at 200,000 and 800,000 Gaussian rows and tree-x-AH at
  800,000, device time through ``chained``; the profile saved, loaded
  back equal and ``auto_config`` taking the branch it implies);
  ``Scann.auto`` at full width under the default profile (its mode's
  kernel launched, its floor), ``ScannBuilder().auto()`` the same mode,
  ``Scann.auto(target_recall=0.9)`` meeting the target on the first 256
  queries and >= 0.89 on all 10,240 with no explicit params, on the
  default route and, under a profile that puts N past both the sweep and
  the skew route's ceiling, the tree route (#1); ``autotune`` on phase
  4's index (36 grid points, target 0.95) and ``autotune_block_sweep`` on
  the first 100,000 rows (32 points, target 0.99 on 9,216 held-out
  queries; #5, #6 and ``block_min_sweep.cu`` launched); the harness's
  five algorithms on its default synthetic data (each recall floor; #2,
  #5, #1 launched), tree-x-AH on the 1.18M rows with
  ``--autotune-target 0.9``, a ``--save-index`` / ``--load-index`` round
  trip, ``--pipeline 4``, ``--profile-dir`` and the CLI in a subprocess,
  each report printed as JSON;
- sharding (phases 39-43) on a mesh of 4 shards of the one card
  (``make_mesh(devices=[cuda:0] * 4)``): phase 4's index served through
  ``ShardedTreeXHybridSearcher`` (#1 bit for bit against its twin on shard
  0's first batch, launched on every shard in every batch, recall@10 at
  least the single device's less 0.02 and >= 0.9, exact distances, timed
  beside the single-device searcher and at 1 and 2 shards, a
  ``save_layout`` / ``load_layout`` round trip on the first 100,000 rows,
  cut for time); ``ShardedTreeXHybridSearcher.build`` at full width
  (>= 0.9, #1 on every shard); the block sweep (#5, >= 0.99) and the
  hasher (#7, >= 0.9) sharded at full width, each with a filtered batch;
  ``Scann.auto(mesh=...)`` under [36]'s 200 MB tree-route profile (the
  sharded route, JAX's decision keys, >= 0.89 at target 0.9);
  ``torch.distributed`` on NCCL at world size 1 (``initialize_multihost``,
  ``global_mesh`` of 4 local shards, the sharded exact search's ids equal
  to the single-device brute force's) and the harness's ``--shards 4``
  raising as the JAX harness does on a one-card host. The kernels' JSON
  records of #1, #5 and #7 list these launches under
  ``sharded_launches``; every shard's preselect rows go to the exact
  bf16 top-k kernel;
- the exact bf16 top-k (phase 44, after [7]): ``csrc/topk_select.cu``
  bit-identical to the int64 key it replaced and timed against it in
  turns (L2 flushed), beside ``torch.topk`` on the values, at the
  benchmark's preselect shape ([1024, 102,400] leaf-like scores, k = 100
  and 1,000) and on phase 4's own leaf scores; [26] logs the rows each
  facade mode sent to it;

then times every kernel against its twin (L2 flushed) and the search stages
with CUDA events (the grouped and per-pair SOAR paths also at twice the
batch, past the pair density where groups widen). The grouped scorer's
times (#1 on both indexes, #1b) stand beside its output contract's
traffic floor and its shared-memory lookup floors; [2] reports registers
and spills of every instance of #1/#1b, #2 (and fails on a stack frame or
a spill in the cluster kernel), #8, #10 and the four forms of
``block_min_compact.cu`` (#3, #4, #5, #6).

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (the kernels are built from
``scann_tpu_torch/csrc`` at first use, all sources at once). Exits non-zero,
printing no result, when there is no CUDA device or any phase fails. The
line before the last is the kernels' JSON record; the last line is the
device JSON.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N, D, CLUSTERS, SPREAD = 1_183_514, 100, 2000, 2.5
BATCH, BATCHES, K = 1024, 10, 10
P, PRE_K = 10, 100
RECALL_FLOOR = 0.9
SWEEP_R, SWEEP_PRE_K, SWEEP_RECALL_FLOOR = 64, 64, 0.99
SEED = 0
AH_S, AH_C, AH_PRE_K, AH_RECALL_FLOOR = 50, 16, 300, 0.9
AH_SMALL_N, AH_APPROX_B = 16_384, 128
BF_RECALL_FLOOR, SQ_RECALL_FLOOR = 0.999, 0.9
# bench.py's headline: 10,000 x 64 uniform [0, 1) rows, seed 42, B=100 (the
# fused kernel) and B=6400 (the composed path)
HEAD_N, HEAD_D, HEAD_B, HEAD_B_SAT = 10_000, 64, 100, 6400
SOAR_P, SOAR_PRE_K, SOAR_FLOOR, SOAR_INT8_FLOOR = 30, 300, 0.95, 0.9
SIDE_N = 100_000
# [29]: mutations of the dynamic searcher, above them its rebuild threshold;
# the added rows queried by their own vectors
DYN_ADDS, DYN_UPDATES, DYN_REMOVES, DYN_SELF = 8192, 2048, 2048, 1024
DYN_REBUILD = 100_000
# [31]: results an attribute may place in one query's top-k; the groups of
# the attribute that mixes within a query's candidates
CROWD_LIMIT, CROWD_GROUPS = 2, 16
# [33]: sets with the shape of ANN-Benchmarks kosarak-jaccard (74,962 sets
# over 27,983 items; its file is not in the repo): items of Zipf popularity
# (weight 1 / rank), sizes 20 plus a Pareto(1.5) tail of scale 20 drawn with
# repeats and capped at kosarak's largest set, 2,498; 500 queries a batch,
# timed SP_REPS times; weighted distances within SP_TOL of float64
SP_N, SP_D, SP_B, SP_MIN, SP_MAX, SP_TAIL = 74_962, 27_983, 500, 20, 2498, 1.5
SP_REPS, SP_TOL = 5, 1e-5
SP_MEASURES = ("JACCARD", "DICE", "NON_ZERO_INTERSECT", "OVERLAP",
               "WEIGHTED_JACCARD")
# [34]: PCA width, mixture components, stacked quantizer levels and its
# training sample
PCA_OUT, GMM_K, SQ_LEVELS, SQ_SAMPLE = 64, 16, 2, 100_000
# [35]-[38]: calibrate's probe size; Scann.auto's recall target, its slack
# (the JAX test's, tests/test_autotune.py:210) and its tuning queries; the
# profile that sends auto to its tree route (sweep_max_n below N, and a
# float32 budget whose skew-route ceiling, 0.5 * 3 * budget / 304 bytes a
# row, is below N too); the autotuners' targets and the block-sweep
# tuner's sample
CAL_N, AUTO_TARGET, AUTO_SLACK, TUNE_Q = 200_000, 0.9, 0.01, 256
AUTO_TREE_MAX_N, AUTO_TREE_F32_BYTES = 1_000_000, 200_000_000
TREE_TUNE_TARGET, SWEEP_TUNE_TARGET, SWEEP_TUNE_Q = 0.95, 0.99, 1024
# [38]: the harness on its default synthetic data (10,000 x 64 uniform,
# seed 42, 200 queries, B=100): extra flags, recall@10 floor and the
# kernels the run must launch. Uniform rows partition poorly: the floors
# sit below what the port's harness reached on the CPU at this shape
# (block sweep 0.9865, one survivor a 32-row block; partitioned at p=40 of
# 100 0.8465; hashed with a re-rank of 100 0.9945; tree-x-AH at p=40 and
# 16 PQ blocks 0.7065; two seeds within 0.02)
HARNESS_RUNS = {
    "brute-force": ((), BF_RECALL_FLOOR, ("#2",)),
    "block-sweep": ((), 0.97, ("#5",)),
    "partitioned": (("--partitions-to-search", "40"), 0.78, ()),
    "hashed": (("--reorder", "100"), 0.98, ()),
    "tree-ah": (("--partitions-to-search", "40", "--reorder", "100"), 0.65,
                ("#1",)),
}
# [39]-[43]: shards of one mesh, all on the one card (the host has one
# GPU); the sharded block sweep's and hasher's filtered batch
SHARDS = 4
KERNEL_SOURCES = ("tree_ah_grouped", "block_min_sweep", "block_min_compact",
                  "lut16_scoring", "int8_dots", "fused_bf", "tree_ah_leaf",
                  "topk_select")
# [44]: the exact bf16 top-k at the benchmark's preselect shape: 1,024 rows
# of p * l_cap = 100 * 1,024 leaf scores, of which about 59,000 are real
# (1.18M rows / 2000 partitions * 100 searched) and the rest masked
SEL_W, SEL_REAL, SEL_KS = 102_400, 59_000, (100, 1000)
SEL_HASHER_W = 1_183_514
# published H100 SXM peaks (dense): bf16 tensor cores, int8 tensor cores,
# float32 outside the tensor cores, HBM3
PEAK_BF16, PEAK_INT8, PEAK_F32, PEAK_HBM = 989e12, 1979e12, 67e12, 3.35e12
# int32 adds outside the tensor cores: 64 INT32 lanes per SM (Hopper white
# paper), half the 128 float32 lanes behind PEAK_F32 (which counts an FMA
# as 2), two adds per lane per clock (IADD3 sums three operands):
# 132 SMs x 64 x 2 x 1.98 GHz
PEAK_I32_ADD = PEAK_F32 / 2
# float32 adds outside the tensor cores: PEAK_F32 counts an FMA as two
# operations, a plain add is one a lane a clock on the 128 float32 lanes of
# an SM: 132 SMs x 128 x 1.98 GHz (the LUT sums of #1, #8 and #10)
PEAK_F32_ADD = PEAK_F32 / 2


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(ops: float, ops_peak: float, nbytes: float):
    """(least ms for the work on the card, what bounds it)."""
    t_ops, t_bytes = ops / ops_peak, nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def leaf_bound(parts, part_sizes, *, s, c, entry_bytes, row_bytes,
               out_bytes, l_cap, index_bytes, peak):
    """(bound ms, bound by, bytes, adds) of a tree-x-AH leaf scorer on one
    batch, counting only what the batch needs: each real (query, partition)
    pair's S x C table read once (no padded subspaces, no empty group
    slots), each probed partition's codes read once (``row_bytes`` a row),
    ``index_bytes`` of offsets and sizes, each pair's ``l_cap`` scores
    written once; one add per real subspace per (pair, row) the pair's
    partition holds."""
    import torch

    pairs = parts.numel()
    probed = torch.unique(parts)
    nbytes = (pairs * s * c * entry_bytes
              + int(part_sizes[probed].sum()) * row_bytes + index_bytes
              + pairs * l_cap * out_bytes)
    adds = int(part_sizes[parts].sum()) * s
    return (*bound(adds, peak, nbytes), nbytes, adds)


def kernel_ptxas(build_log: str, kernel: str, label):
    """'<label>: N registers, S bytes spill stores, L bytes spill loads' for
    each instance of ``kernel`` in an ``nvcc -Xptxas -v`` log; ``label``
    names an instance from its integer and bool template arguments (none
    for a kernel that is no template)."""
    out, args, spill = [], None, ""
    for ln in build_log.splitlines():
        if "Function properties for" in ln:
            m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", ln)
            args = ([int(v) for v in re.findall(r"L[ib](\d+)E", m.group(1))]
                    if m else [] if re.search(r"\d" + kernel + "E", ln)
                    else None)
        elif "spill stores" in ln:
            spill = ", ".join(x.strip() for x in ln.split(",")
                              if "spill" in x or "stack" in x)
        elif "Used" in ln and "registers" in ln and args is not None:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{label(*args)}: {regs} registers, {spill}")
            args = None
    return out


def grouped_floor_line(tag_, name, kernel_ms, grp_size, *, smi, **kw):
    """[tag] line of the grouped scorer's traffic and lookup floors."""
    nbytes, t_ms, entries, f32_ms, fq_ms, ranges = grouped_floors(grp_size,
                                                                  **kw)
    return (f"[{tag_}] tree_ah_grouped {name}: contract traffic {nbytes} "
            f"bytes (every output slot, codes once a group, tables once a "
            f"live column range: {ranges} ranges) -> floor {t_ms:.4f} ms at "
            f"3.35 TB/s; {entries} table entries -> lookup floor "
            f"{f32_ms:.4f} ms at one entry a load (32 a clock), {fq_ms:.4f} "
            f"ms at q_cap {kw['q_cap']} entries a load (128 B a clock), "
            f"{kw['sms']} SMs at {kw['mhz']:.0f} MHz; kernel {kernel_ms:.4f} "
            f"ms = {t_ms / kernel_ms:.3f} of the traffic floor ({smi})")


def card_clock(dev):
    """(SMs, MHz at clocks.max.sm) of the card."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    return sms, mhz


def grouped_floors(grp_size, *, q_cap, s_pad, c, l_cap, int8, packed, sms,
                   mhz):
    """What the grouped scorer's contract and lookups cost on one call:
    (traffic bytes, traffic-floor ms, table entries looked up, lookup floor
    ms at one entry a shared load (32 a clock per SM), lookup floor ms at
    the kernel's q_cap entries a load (128 shared bytes a clock), live
    column ranges). The traffic is every output slot written once, each
    group's code columns read once and its tables once per live column
    range of ``ops/tree_ah_grouped.kernel_plan``, 8 index bytes a group."""
    from scann_tpu_torch.ops import tree_ah_grouped as tag

    plan = tag.kernel_plan(q_cap, s_pad, c, int8=int8, packed=packed,
                           l_cap=l_cap)
    size = grp_size.long().clamp(0, l_cap)
    ng, entry = size.numel(), 1 if int8 else 2
    ranges = int(((size + plan.range_cols - 1) // plan.range_cols).sum())
    rows = s_pad // 2 if packed else s_pad
    nbytes = (ng * q_cap * l_cap * 2 + int(size.sum()) * rows
              + ranges * q_cap * s_pad * c * entry + ng * 8)
    entries = int(size.sum()) * q_cap * s_pad
    clocks = sms * mhz * 1e6
    per_clock = min(32 * min(q_cap, 16 // entry), 128 // entry)
    return (nbytes, nbytes / PEAK_HBM * 1e3, entries,
            entries / (32 * clocks) * 1e3, entries / (per_clock * clocks)
            * 1e3, ranges)


def leaf_schedule(p_off, p_size, *, q, s_pad, l_cap):
    """What #10's partition-order schedule does on a batch: (code bytes it
    reads = each chunk's distinct partitions x their sizes x S_pad, table
    lookups = each run's pairs x its longest size x S_pad, runs, chunks).
    Chunks are Q consecutive pairs of the stable offset order; a run is a
    chunk's pairs of one offset."""
    import torch

    from scann_tpu_torch.ops import tree_ah_leaf as tal

    order = tal.pair_order(p_off).long()
    off = p_off.reshape(-1).long()[order]
    size = p_size.reshape(-1).long()[order].clamp(0, l_cap)
    chunk = torch.arange(off.numel(), device=off.device) // q
    new = torch.ones_like(off, dtype=torch.bool)
    new[1:] = (off[1:] != off[:-1]) | (chunk[1:] != chunk[:-1])
    run = torch.cumsum(new.long(), 0) - 1
    runs = int(run[-1]) + 1
    run_len = torch.zeros(runs, dtype=torch.long, device=off.device)
    run_len.scatter_reduce_(0, run, size, "amax")
    run_nq = torch.bincount(run, minlength=runs)
    return (int(run_len.sum()) * s_pad, int((run_len * run_nq).sum()) * s_pad,
            runs, int(chunk[-1]) + 1)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from scann_tpu_torch import (
        AsymmetricHasherConfig,
        DenseDataset,
        SearchParameters,
        TreeXHybridConfig,
        TreeXHybridSearcher,
        native,
    )
    from scann_tpu_torch.models import tree_x_hybrid as tx
    from scann_tpu_torch.ops import topk
    from scann_tpu_torch.ops import tree_ah_grouped as tag
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    # -- 1. device -------------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{kind} x{torch.cuda.device_count()}; float32 matmul TF32 off")
    log(smi)

    # -- 2. kernel build: one nvcc per source, all started together -------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        list(ex.map(native.load, KERNEL_SOURCES))
    build_kernel_s = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        if name in native.build_logs:
            ptxas = [ln.split("ptxas info    :")[-1].strip() for ln in
                     native.build_logs[name].splitlines()
                     if "registers" in ln or "spill" in ln]
            log(f"[2 kernel build] nvcc built {name}.cu for sm_90a; ptxas "
                f"per instance: {' | '.join(ptxas)}")
        else:
            log(f"[2 kernel build] loaded the {name} library already built "
                f"from this source")
    log(f"[2 kernel build] {build_kernel_s:.2f}s for {len(KERNEL_SOURCES)} "
        f"sources")
    log("[2 kernel build] tree_ah_leaf (#10), ptxas: " + "; ".join(
        kernel_ptxas(native.saved_logs.get("tree_ah_leaf", ""),
                     "tree_ah_leaf_kernel", lambda c: f"C={c}")))
    forms = ("compact #5", "rowmajor #3", "top2 #6", "qmajor #4")
    compact_ptxas = kernel_ptxas(
        native.saved_logs.get("block_min_compact", ""),
        "block_min_compact_kernel",
        lambda ks, rt, p, f: f"{forms[f]} KS={ks} r={rt}"
        f"{'+' if rt == 128 else ''}{' penalty' if p else ''}")
    log("[2 kernel build] block_min_compact (#3, #4, #5, #6), ptxas: "
        + "; ".join(compact_ptxas))
    log("[2 kernel build] block_min_compact main instances (D1 104, KS=8), "
        "ptxas: " + "; ".join(
            ln for ln in compact_ptxas for want in (
                "compact #5 KS=8 r=64:", "rowmajor #3 KS=8 r=128+:",
                "top2 #6 KS=8 r=64:", "qmajor #4 KS=8 r=128+:",
                "compact #5 KS=8 r=64 penalty:",
                "rowmajor #3 KS=8 r=128+ penalty:",
                "top2 #6 KS=8 r=64 penalty:",
                "qmajor #4 KS=8 r=128+ penalty:") if ln.startswith(want)))
    score_log = native.saved_logs.get("lut16_scoring", "")
    log("[2 kernel build] lut16_score (#8) query-tiled instances (the main "
        "ones: 128 queries a tile, float32 and bf16 out), ptxas: "
        + "; ".join(kernel_ptxas(
            score_log, "lut16_score_tiled_kernel",
            lambda qs, bf: f"q_tile {8 * qs} {'bf16' if bf else 'float32'}"))
        + "; the one-column-a-thread yardstick: " + "; ".join(kernel_ptxas(
            score_log, "lut16_score_kernel",
            lambda bf: f"{'bf16' if bf else 'float32'}")))
    fused_log = native.saved_logs.get("fused_bf", "")
    fused_ptxas = kernel_ptxas(
        fused_log, "fused_bf_cluster_kernel",
        lambda qt, v16: f"q_tile {qt} {16 if v16 else 4}-byte copies")
    log("[2 kernel build] fused_bf (#2) cluster kernel, ptxas: "
        + "; ".join(fused_ptxas) + "; the first port's kernel: "
        + "; ".join(kernel_ptxas(fused_log, "fused_bf_kernel",
                                 lambda: "fused_bf_kernel")))
    if len(fused_ptxas) != 4 or not all(
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
            in ln for ln in fused_ptxas):
        raise AssertionError("an instance of the fused_bf cluster kernel "
                             "has a stack frame or spills")
    log("[2 kernel build] tree_ah_grouped (#1, #1b), ptxas: " + "; ".join(
        kernel_ptxas(native.saved_logs.get("tree_ah_grouped", ""),
                     "tree_ah_grouped_kernel",
                     lambda q, p, i, c: f"q_cap {q} "
                     f"{'packed' if p else 'unpacked'} "
                     f"{'int8' if i else 'bf16'}{' C=16' if c else ''}")))

    # -- 3. data -----------------------------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    centers = rng.standard_normal((CLUSTERS, D), dtype=np.float32) * SPREAD
    labels = rng.integers(0, CLUSTERS, N)      # each row's cluster ([31])
    db = centers[labels]
    db += rng.standard_normal((N, D), dtype=np.float32)
    q_np = centers[rng.integers(0, CLUSTERS, BATCH * BATCHES)]
    q_np += rng.standard_normal(q_np.shape, dtype=np.float32)
    log(f"[3 data] {N} x {D} f32 clustered ({CLUSTERS} clusters, spread "
        f"{SPREAD}, unit noise, seed {SEED}), {len(q_np)} queries in "
        f"{time.perf_counter() - t0:.2f}s")

    # -- 4. build ----------------------------------------------------------------
    cfg = TreeXHybridConfig(
        num_partitions=2000, partitions_to_search=P,
        hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=50, seed=42, max_iterations=12,
            training_sample_size=100_000),
        max_partition_size=None)
    ds = DenseDataset(db)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    searcher = TreeXHybridSearcher(cfg, device=dev).build(ds)
    codes_csr, csr_offsets, part_sizes, perm, l_cap = searcher._csr_state()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    packed = searcher._pack_codes()
    s_pad = 2 * codes_csr.shape[0] if packed else codes_csr.shape[0]
    log(f"[4 build] {build_s:.2f}s on the card: partitions "
        f"{searcher.partitioner.num_partitions}, max size "
        f"{searcher.partitioner.tokenization.max_partition_size}, l_cap "
        f"{l_cap}, s_pad {s_pad}, packed {packed}, slab "
        f"{codes_csr.numel()} bytes {list(codes_csr.shape)}")

    queries = torch.from_numpy(q_np).to(dev)
    db_dev = ds.device_tensor(dev)
    cent = searcher.partitioner.centers
    cb = searcher.codebook.centroids
    q_cap = searcher.effective_q_cap(BATCH, P)
    l_tile = cfg.score_l_tile

    # -- 5. kernel vs plain twin on the first batch's grouped inputs ---------------
    q0 = queries[:BATCH]
    parts = tx._select_partitions(cent, q0, p=P)
    luts_flat = tx._residual_luts(q0, cent, parts, cb, s_pad=s_pad,
                                  use_residuals=True)
    luts_g, grp_off, grp_size, slot = tx._group_luts(
        luts_flat, parts, csr_offsets, part_sizes, s_pad=s_pad, q_cap=q_cap,
        packed=packed)
    kargs = (luts_g, codes_csr, grp_off, grp_size)
    kkw = dict(l_cap=l_cap, l_tile=l_tile, q_cap=q_cap, packed=packed)
    got = tag.tree_ah_grouped_scores(*kargs, **kkw)
    torch.cuda.synchronize()
    want = tag.tree_ah_grouped_scores_reference(*kargs, **kkw)
    masked_w = want.float() >= tx.MASKED_DISTANCE / 2
    masked_g = got.float() >= tx.MASKED_DISTANCE / 2
    if not torch.equal(masked_w, masked_g):
        raise AssertionError("kernel and twin disagree on masked slots")
    if not torch.equal(got[masked_w], want[masked_w]):
        raise AssertionError("masked slots differ from bf16(MASKED_DISTANCE)")
    # scores are sums of squared distances (>= 0), so the bf16 bit patterns
    # order like the values and their difference counts ulps
    ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    max_ulp = int(ulps[~masked_w].max()) if (~masked_w).any() else 0
    max_abs_err = float((got.float() - want.float())[~masked_w].abs().max())
    n_groups = luts_g.shape[0] // q_cap
    same = torch.equal(got, want)
    log(f"[5 kernel check] NG {n_groups}, q_cap {q_cap}, l_tile {l_tile}, "
        f"out {list(got.shape)} bf16: masked slots equal "
        f"({int(masked_w.sum())}), unmasked max {max_ulp} bf16 ulp, max abs "
        f"err {max_abs_err:.6g}, bit-identical {same} (tolerance: bit for "
        f"bit, float32 sums in the twin's order)")
    if not same:
        raise AssertionError(f"kernel differs from its twin by up to "
                             f"{max_ulp} ulp")

    # -- 6. search: the main path, counted ------------------------------------------
    params = SearchParameters(num_leaves_to_search=P,
                              pre_reordering_num_neighbors=PRE_K)
    tag.LAUNCHES = 0
    topk.SELECT_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [searcher.search_batched_tensors(
        queries[i * BATCH:(i + 1) * BATCH], K, params)
        for i in range(BATCHES)]
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = tag.LAUNCHES
    select_launches = topk.SELECT_LAUNCHES
    idx = torch.cat([r[0] for r in results])
    dists = torch.cat([r[1] for r in results])

    gt_np = exact_top_k(queries, db_dev)
    recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    dist_err = check_results(idx, dists, queries, db_dev, BATCH * BATCHES)
    log(f"[6 search] {BATCHES} x B={BATCH}, p={P}, pre_k={PRE_K}, k={K}: "
        f"recall@10 {recall:.4f} (floor {RECALL_FLOOR}), kernel launches "
        f"{launches}, selection kernel launches {select_launches}, returned "
        f"vs recomputed distances max rel err {dist_err:.3g}, host wall "
        f"{search_s:.3f}s")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall@10 {recall} < {RECALL_FLOOR}")
    if launches <= 0:
        raise AssertionError("the search never launched the CUDA kernel")
    if select_launches != BATCHES:
        raise AssertionError(f"the preselect launched the selection kernel "
                             f"{select_launches} times in {BATCHES} batches")

    # -- 7. timings (CUDA events; for the record) ------------------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def cold_ms(fn, reps):
        """Mean ms of fn with L2 flushed before each call."""
        fn()
        total = 0.0
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    def turns(kernel, plain, k_reps=20, p_reps=5):
        """(kernel ms, plain ms) timed plain, kernel, kernel, plain."""
        p1 = cold_ms(plain, p_reps)
        k1 = cold_ms(kernel, k_reps)
        k2 = cold_ms(kernel, k_reps)
        return (k1 + k2) / 2, (p1 + cold_ms(plain, p_reps)) / 2

    kernel_ms, plain_ms = turns(
        lambda: tag.tree_ah_grouped_scores(*kargs, **kkw),
        lambda: tag.tree_ah_grouped_scores_reference(*kargs, **kkw))
    n_sub = searcher.codebook.num_subspaces
    tree_bound, tree_by, tree_bytes, tree_ops = leaf_bound(
        parts, part_sizes, s=n_sub, c=cb.shape[1], entry_bytes=2,
        row_bytes=(n_sub + 1) // 2 if packed else n_sub, out_bytes=2,
        l_cap=l_cap, index_bytes=n_groups * 8, peak=PEAK_F32_ADD)
    log(f"[7 kernel time] grouped leaf scorer, L2 flushed: kernel "
        f"{kernel_ms:.4f} ms, plain twin {plain_ms:.4f} ms, bound "
        f"{tree_bound:.4f} ms, bound by {tree_by} ({tree_bytes} bytes, "
        f"{tree_ops} float32 adds) -> {tree_bound / kernel_ms:.3f} of the "
        f"bound ({smi})")
    sms, mhz = card_clock(dev)
    log(grouped_floor_line("7 kernel floors", "#1", kernel_ms, grp_size,
                           q_cap=q_cap, s_pad=s_pad, c=cb.shape[1],
                           l_cap=l_cap, int8=False, packed=packed, sms=sms,
                           mhz=mhz, smi=smi))

    def staged(qb, score_fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        parts = tx._select_partitions(cent, qb, p=P)
        ev[1].record()
        luts = tx._residual_luts(qb, cent, parts, cb, s_pad=s_pad,
                                 use_residuals=True)
        ev[2].record()
        lg, go, gs, sl = tx._group_luts(luts, parts, csr_offsets, part_sizes,
                                        s_pad=s_pad, q_cap=q_cap,
                                        packed=packed)
        ev[3].record()
        sg = score_fn(lg, codes_csr, go, gs, **kkw)
        ev[4].record()
        flat = tx._leaf_major(sg, sl, b=qb.shape[0], p=P, l_cap=l_cap)
        tx._finalize(db_dev, qb, flat, parts, csr_offsets, codes_csr.shape[1],
                     perm, float("inf"), float("inf"), pre_k=PRE_K, k=K, p=P,
                     measure=cfg.distance_measure)
        ev[5].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

    names = ("select", "lut", "group", "leaf", "finalize")
    for label, fn in (("kernel", tag.tree_ah_grouped_scores),
                      ("plain", tag.tree_ah_grouped_scores_reference)):
        staged(q0, fn)
        rows = np.array([staged(queries[i * BATCH:(i + 1) * BATCH], fn)
                         for i in range(BATCHES)])
        split = dict(zip(names, rows.mean(0).tolist()))
        log(f"[7 stages/{label}] per batch ms: " + ", ".join(
            f"{n} {v:.4f}" for n, v in split.items())
            + f", sum {rows.sum(1).mean():.4f}")
    med, top = event_ms(lambda qb: searcher.search_batched_tensors(
        qb, K, params), queries, BATCH, BATCHES)
    log(f"[7 search time] search_batched_tensors, B={BATCH}, n={3 * BATCHES} "
        f"batches: median {med:.4f} ms, max {top:.4f} ms -> "
        f"{BATCH / med * 1e3:.0f} queries/s at recall@10 {recall:.4f} "
        f"({smi})")
    records = [{
        "name": "tree_ah_grouped",
        "route": "cuda",
        "source": "scann_tpu_torch/csrc/tree_ah_grouped.cu",
        "replaces": "scann_tpu/ops/tree_ah_grouped.py:86",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": tree_bound,
        "bound_by": tree_by,
        "library_ms": None,
    }]

    # phase 4's own leaf scores for [44]
    sel_lg, sel_go, sel_gs, sel_sl = tx._group_luts(
        tx._residual_luts(q0, cent, parts, cb, s_pad=s_pad,
                          use_residuals=True),
        parts, csr_offsets, part_sizes, s_pad=s_pad, q_cap=q_cap,
        packed=packed)
    records.append(select_phase(tx._leaf_major(
        tag.tree_ah_grouped_scores(sel_lg, codes_csr, sel_go, sel_gs, **kkw),
        sel_sl, b=q0.shape[0], p=P, l_cap=l_cap), select_launches, cold_ms,
        smi))
    del sel_lg, sel_go, sel_gs, sel_sl
    records += block_sweep_phases(ds, queries, db_dev, gt_np, cold_ms, turns,
                                  smi)
    records += hasher_phases(ds, queries, db_dev, gt_np, cold_ms, turns, smi)
    records += brute_force_phases(ds, queries, db_dev, gt_np, cold_ms, turns,
                                  smi)
    records += soar_phases(ds, queries, db_dev, gt_np, cold_ms, turns, smi,
                           searcher)
    facade_phases(ds, queries, db_dev, gt_np, smi)
    dynamic_phase(ds, queries, q_np, gt_np, smi, cfg, centers)
    restrict_phases(ds, queries, q_np, db_dev, smi, searcher, labels)
    sparse_phase(dev, smi)
    projection_phases(db_dev, smi)
    tuning_phases(ds, queries, q_np, db_dev, gt_np, smi, searcher)
    sharded = sharded_phases(ds, queries, q_np, db_dev, gt_np, smi,
                             searcher, cfg)
    del searcher
    for rec in records:
        if rec["name"] in sharded:
            rec["sharded_launches"] = sharded[rec["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def select_phase(phase4_scores, launches, cold_ms, smi):
    """[44]: the exact top-k over bf16 rows (``csrc/topk_select.cu``)
    against the int64 key it replaced, bit for bit, then timed in turns
    (key, kernel, kernel, key; L2 flushed) beside ``torch.topk`` on the
    values (no tie rule), at the benchmark's preselect shape, on phase 4's
    own leaf scores (its p = P), and at the hasher's bf16 LUT16 shapes of
    [15] (all the rows, and the re-rank's 16,384) at its pre_k. Returns the
    kernel's record, with ``launches`` the kernel's launches in [6]."""
    import torch

    from scann_tpu_torch.ops import topk as tk
    from scann_tpu_torch.types import MASKED_DISTANCE

    dev = phase4_scores.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # inner-product leaf scores around -0.6, then the masked slots
    leaf = torch.randn(BATCH, SEL_W, device=dev, generator=gen) * 0.1 - 0.6
    leaf[:, SEL_REAL:] = float(MASKED_DISTANCE)
    leaf = leaf.bfloat16()
    cases = [(f"[{BATCH}, {SEL_W}]", leaf, k) for k in SEL_KS]
    cases.append((f"phase 4 [{BATCH}, {phase4_scores.shape[1]}]",
                  phase4_scores, PRE_K))
    # the hasher's LUT16 scores: inner products of unit rows, one block a
    # row over 1,183,514 columns (three passes over 2.4 MB a row)
    for width in (AH_SMALL_N, SEL_HASHER_W):
        ah = torch.randn(BATCH, width, device=dev, generator=gen) * 0.1 - 0.3
        cases.append((f"hasher [{BATCH}, {width}]", ah.bfloat16(),
                      AH_PRE_K))
        del ah
    times = {}
    for label, x, k in cases:
        before = tk.SELECT_KERNEL_ROWS
        got = tk.top_k_smallest(x, k)
        torch.cuda.synchronize()
        want = tk._top_k_by_key(x, k)
        if tk.SELECT_KERNEL_ROWS != before + x.shape[0]:
            raise AssertionError(f"[44 select] {label} k={k}: the kernel "
                                 f"did not take the rows")
        if not (torch.equal(got[1], want[1]) and torch.equal(
                got[0].view(torch.int16), want[0].view(torch.int16))):
            raise AssertionError(f"[44 select] {label} k={k}: the kernel "
                                 f"differs from the int64 key")
        key1 = cold_ms(lambda: tk._top_k_by_key(x, k), 5)
        ker = (cold_ms(lambda: tk._top_k_by_kernel(x, k), 20)
               + cold_ms(lambda: tk._top_k_by_kernel(x, k), 20)) / 2
        key = (key1 + cold_ms(lambda: tk._top_k_by_key(x, k), 5)) / 2
        lib = cold_ms(lambda: torch.topk(x, k, dim=-1, largest=False), 5)
        nbytes = x.numel() * 2 + x.shape[0] * k * (2 + 8)
        bound = nbytes / PEAK_HBM * 1e3
        times[(label, k)] = (ker, key, lib, bound)
        log(f"[44 select] {label} bf16, k={k}: kernel {ker:.4f} ms, the "
            f"int64 key it replaced {key:.4f} ms ({key / ker:.2f}x), "
            f"torch.topk on the values (no tie rule) {lib:.4f} ms; bound "
            f"{bound:.4f} ms ({nbytes} bytes) -> {bound / ker:.3f} of the "
            f"bound; bit-identical to the key, {x.shape[0]} kernel rows "
            f"counted ({smi})")
    ker, key, lib, bound = times[(cases[0][0], SEL_KS[0])]
    return {
        "name": "topk_select",
        "route": "cuda",
        "source": "scann_tpu_torch/csrc/topk_select.cu",
        "replaces": None,
        "launches": launches,
        "max_abs_err": 0.0,
        "ms": ker,
        "plain_ms": key,
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": lib,
    }


def check_results(idx, dists, queries, db_dev, rows, exact_check=True):
    """Shape, ids >= 0, finite ascending distances that equal recomputed
    exact squared-L2 distances to 1e-3 relative (unless ``exact_check`` is
    off, for approximate results)."""
    import torch

    if tuple(idx.shape) != (rows, K) or bool((idx < 0).any()):
        raise AssertionError(f"bad result ids: shape {tuple(idx.shape)}")
    if not bool(torch.isfinite(dists).all()):
        raise AssertionError("non-finite result distances")
    if bool((dists[:, 1:] < dists[:, :-1]).any()):
        raise AssertionError("result distances not ascending")
    if not exact_check:
        return float("nan")
    exact = ((queries[:rows, None, :] - db_dev[idx]) ** 2).sum(-1)
    err = float(((dists - exact).abs() / exact.clamp_min(1e-6)).max())
    if err > 1e-3:
        raise AssertionError(f"returned distances off by {err} (relative)")
    return err


def event_ms(search, queries, batch, batches, reps=3):
    """(median, max) CUDA-event ms of ``search`` over reps x batches."""
    import numpy as np
    import torch

    times = []
    for _ in range(reps):
        for i in range(batches):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            qb = queries[i * batch:(i + 1) * batch]
            a.record()
            search(qb)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    return float(np.median(times)), float(np.max(times))


def back_to_back_ms(launch, reps):
    """ms a call of ``launch`` (a kernel's C entry with its arguments bound)
    takes back to back on the stream, L2 warm: the kernel's own time,
    without the wrapper's host work between launches."""
    import torch

    if launch() != 0:
        raise AssertionError("the raw launch failed")
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_us(call, reps=200):
    """Microseconds of host time a call takes on an input small enough
    that the card never holds the host back."""
    import torch

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def twin_chunks(fb, q, db, norms, n_valid, k, vals, idx, chunk=128):
    """Largest abs value error of a fused kernel's result against its twin
    (``fused_bf.check_against_twin``, which raises where they disagree),
    ``chunk`` queries at a time so the twin's [chunk, N] distances fit."""
    return max(fb.check_against_twin(
        q[i:i + chunk], db, norms, n_valid, k, vals[i:i + chunk],
        idx[i:i + chunk])["max_abs_err"] for i in range(0, len(q), chunk))


def block_sweep_phases(ds, queries, db_dev, gt_np, cold_ms, turns, smi):
    """Phases 8-11, the block sweep; returns the kernels' JSON records."""
    import numpy as np
    import torch

    from scann_tpu_torch import BlockSweepConfig, BlockSweepSearcher
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.ops.distances import DistanceMeasure
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    dev = queries.device
    measure = DistanceMeasure.SQUARED_L2

    # -- 8. build: augmented copy + stored-order re-rank rows on the card --------
    def build(**kw):
        s = BlockSweepSearcher(ds, BlockSweepConfig(
            pre_reorder_k=SWEEP_PRE_K, **kw), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug, rows, _ = s.device_state()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"[8 sweep build] {kw}: {secs:.2f}s, aug {list(aug.shape)} "
            f"{aug.dtype} {aug.numel() * aug.element_size()} bytes, re-rank "
            f"rows {list(rows.shape)} {rows.numel() * 4} bytes, inverse "
            f"permutation {s._inv_perm.numel() * 8} bytes, memory_usage "
            f"{s.memory_usage()}")
        return s

    main_s = build(block_r=SWEEP_R)
    top2_s = build(block_r=SWEEP_R, top2=True)
    r128_s = build(block_r=128)
    r512_s = build(block_r=512)
    aug64, rows64, _ = main_s.device_state()
    n_pad, d1 = aug64.shape

    # -- 9. each kernel form against its twin on real inputs -------------------------
    q0 = queries[:BATCH]
    q_aug, _ = sw.augment_for_sweep(q0, aug64, measure)
    errs = {}

    def check(name, form, got, q, aug, r, pen=None, label=""):
        torch.cuda.synchronize()
        rep = sw.check_against_twin(form, got, q, aug, r=r, penalty=pen)
        errs[name] = max(errs.get(name, 0.0), rep["max_abs_err"])
        # the kernel that served the call, counted from zero
        served = [k for k, v in sw.LAUNCHES_BY_KERNEL[name].items() if v]
        sw.reset_launches()
        label += f" ({'+'.join(served)}.cu)"
        log(f"[9 kernel check] {name}{label}: B={q.shape[0]}, r={r}, "
            f"{aug.dtype} rows {list(aug.shape)}: max abs err "
            f"{rep['max_abs_err']:.6g} (tolerance 1e-5 * sum|terms| + 1e-5; "
            f"compact 1 bf16 ulp, max {rep['max_ulp']}, {rep['ulp_over_1']} "
            f"values past 1 ulp near 0 within tolerance), offsets "
            f"bit-identical {rep['loc_equal']:.6f} of {rep['checked']}, the "
            f"rest reach the twin's minimum within tolerance")
        return served

    aug128 = r128_s.device_state()[0]
    aug512 = r512_s.device_state()[0]
    q_top2 = q_aug[:BATCH // 2]
    q_512 = q_aug[:128]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {  # the main calls of the forms block_min_compact.cu serves
        "block_min_qmajor_compact": sw.sweep_plan(
            "compact", n_pad, BATCH, d1, SWEEP_R, False, sms),
        "block_min": sw.sweep_plan("rowmajor", aug128.shape[0], BATCH, d1,
                                   128, False, sms),
        "block_min2": sw.sweep_plan("top2", n_pad, BATCH // 2, d1, SWEEP_R,
                                    False, sms),
        "block_min_qmajor": sw.sweep_plan("qmajor", aug512.shape[0], 128,
                                          d1, 512, False, sms)}
    for name, plan in plans.items():
        log(f"[9 sweep plan] {name}: {plan}")
        if plan is None:
            raise AssertionError(f"the main {name} call is not planned for "
                                 f"block_min_compact.cu")

    def check_served(want, name, *args):
        served = check(name, *args)
        if served != [want]:
            raise AssertionError(f"{name}{args[-1]}: served by {served}, not "
                                 f"{want}.cu alone")

    sw.reset_launches()
    check_served("block_min_compact", "block_min_qmajor_compact", "compact",
                 sw.block_min_sweep_qmajor(q_aug, aug64, r=SWEEP_R,
                                           compact=True),
                 q_aug, aug64, SWEEP_R, None, "")
    check_served("block_min_compact", "block_min", "rowmajor",
                 sw.block_min_sweep(q_aug, aug128, r=128), q_aug, aug128, 128,
                 None, "")
    check_served("block_min_compact", "block_min_qmajor", "qmajor",
                 sw.block_min_sweep_qmajor(q_512, aug512, r=512), q_512,
                 aug512, 512, None, "")
    check_served("block_min_compact", "block_min2", "top2",
                 sw.block_min2_sweep(q_top2, aug64, r=SWEEP_R), q_top2, aug64,
                 SWEEP_R, None, "")
    # the allowlist penalty (half the ids allowed) and the int8 layout
    allow = np.random.default_rng(SEED + 1).random(ds.size) < 0.5
    pen64 = main_s._allow_penalty(allow, n_pad).to(dev)
    pen128 = r128_s._allow_penalty(allow, aug128.shape[0]).to(dev)
    pen512 = r512_s._allow_penalty(allow, aug512.shape[0]).to(dev)
    check_served("block_min_compact", "block_min_qmajor", "qmajor",
                 sw.block_min_sweep_qmajor(q_512, aug512, r=512,
                                           penalty=pen512),
                 q_512, aug512, 512, pen512, " + penalty")
    check_served("block_min_compact", "block_min", "rowmajor",
                 sw.block_min_sweep(q_aug, aug128, r=128, penalty=pen128),
                 q_aug, aug128, 128, pen128, " + penalty")
    check_served("block_min_compact", "block_min2", "top2",
                 sw.block_min2_sweep(q_top2, aug64, r=SWEEP_R, penalty=pen64),
                 q_top2, aug64, SWEEP_R, pen64, " + penalty")
    codes, scales, sn = sw.build_int8_augmented_db(
        ds.numpy(), ds.size, measure, tile_n=n_pad,
        shuffle_stride=sw.shuffle_stride_for(ds.size))
    aug8 = codes.to(dev)
    q_aug8, _ = sw.augment_for_sweep(q0, aug8, measure, scales.to(dev), sn)

    def pen_int8(r):
        return sw.build_allow_penalty(
            allow, n_pad, r, inv_perm=main_s._inv_host,
            mask_value=4.0 * sw.INT8_NORM_DIGIT_MAX * sn).to(dev)

    pen8, pen8_128, pen8_512 = pen_int8(SWEEP_R), pen_int8(128), pen_int8(512)
    label8 = " + int8 rows + penalty"
    check_served("block_min_sweep", "block_min_qmajor", "qmajor",
                 sw.block_min_sweep_qmajor(q_aug8[:128], aug8, r=512,
                                           penalty=pen8_512),
                 q_aug8[:128], aug8, 512, pen8_512, label8)
    check_served("block_min_sweep", "block_min_qmajor_compact", "compact",
                 sw.block_min_sweep_qmajor(q_aug8, aug8, r=SWEEP_R,
                                           compact=True, penalty=pen8),
                 q_aug8, aug8, SWEEP_R, pen8, label8)
    check_served("block_min_sweep", "block_min", "rowmajor",
                 sw.block_min_sweep(q_aug8, aug8, r=128, penalty=pen8_128),
                 q_aug8, aug8, 128, pen8_128, label8)
    check_served("block_min_sweep", "block_min2", "top2",
                 sw.block_min2_sweep(q_aug8[:BATCH // 2], aug8, r=SWEEP_R,
                                     penalty=pen8),
                 q_aug8[:BATCH // 2], aug8, SWEEP_R, pen8, label8)

    # -- 10. search: each path counted from zero ------------------------------------
    launches = {}

    def run(s, qs, batch, kernel, label, floor=None):
        sw.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [s.search_batched_tensors(qs[i:i + batch], K)
               for i in range(0, len(qs), batch)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sw.LAUNCHES)
        launches[kernel] = counts[kernel]
        idx = torch.cat([x[0] for x in res])
        dists = torch.cat([x[1] for x in res])
        err = check_results(idx, dists, qs, db_dev, len(qs))
        recall = recall_at_k(idx.cpu().numpy(), gt_np[:len(qs)], K)
        log(f"[10 sweep search/{label}] {len(qs)} queries in calls of "
            f"{batch}: recall@10 {recall:.4f}"
            + (f" (floor {floor})" if floor else "")
            + f", launches {counts}, returned vs recomputed distances max "
            f"rel err {err:.3g}, host wall {wall:.3f}s")
        if counts[kernel] <= 0:
            raise AssertionError(f"{label}: {kernel} was never launched")
        if floor is not None and recall < floor:
            raise AssertionError(f"{label}: recall@10 {recall} < {floor}")
        return recall

    recall = run(main_s, queries, BATCH, "block_min_qmajor_compact",
                 "main r=64", SWEEP_RECALL_FLOOR)
    if sw.COMPACT_LAUNCHES != {"block_min_compact": BATCHES,
                               "block_min_sweep": 0}:
        raise AssertionError(f"main r=64: compact launches by kernel "
                             f"{sw.COMPACT_LAUNCHES}, not {BATCHES} of "
                             f"block_min_compact.cu")
    log(f"[10 sweep search/main r=64] compact launches by kernel "
        f"{dict(sw.COMPACT_LAUNCHES)}")
    launcher = sw._launch
    side_medians = {}
    for s, name, label, want, batch, floor in (
            (top2_s, "block_min2", "top2 r=64", 2, BATCH, SWEEP_RECALL_FLOOR),
            (r128_s, "block_min", "r=128", 1, BATCH, SWEEP_RECALL_FLOOR),
            (r512_s, "block_min_qmajor", "r=512 B=128", 1, 128, None)):
        side_recall = run(s, queries[:batch], batch, name, label, floor)
        by_kernel = dict(sw.LAUNCHES_BY_KERNEL[name])
        if by_kernel != {"block_min_compact": want, "block_min_sweep": 0}:
            raise AssertionError(f"{label}: launches by kernel {by_kernel}, "
                                 f"not {want} of block_min_compact.cu")
        # the same searcher with its sweep on the old kernel (the wrapper's
        # launcher called with mma_sync=True), in turns new, old, old, new
        meds = []
        for old_kernel in (False, True, True, False):
            if old_kernel:
                sw._launch = functools.partial(launcher, mma_sync=True)
            try:
                meds.append(event_ms(
                    lambda qb: s.search_batched_tensors(qb, K), queries,
                    batch, BATCHES))
            finally:
                sw._launch = launcher
        med = float(np.median([meds[0][0], meds[3][0]]))
        side_medians[label] = med
        log(f"[10 sweep search/{label}] launches by kernel {by_kernel}; "
            f"search_batched_tensors, B={batch}, n={3 * BATCHES} batches a "
            f"turn, median (max) ms on block_min_compact.cu "
            f"{meds[0][0]:.4f} ({meds[0][1]:.4f}), {meds[3][0]:.4f} "
            f"({meds[3][1]:.4f}), on the old kernel {meds[1][0]:.4f} "
            f"({meds[1][1]:.4f}), {meds[2][0]:.4f} ({meds[2][1]:.4f}) -> "
            f"{batch / med * 1e3:.0f} queries/s at recall@10 "
            f"{side_recall:.4f} ({smi})")

    # -- 11. timings -----------------------------------------------------------------
    forms = [  # name, source line, kernel, twin, (B, rows, r, out bytes)
        ("block_min", 247,
         lambda: sw.block_min_sweep(q_aug, aug128, r=128),
         lambda: sw.block_min_sweep_reference(q_aug, aug128, r=128),
         (BATCH, aug128, 128, 8)),
        ("block_min_qmajor", 270,
         lambda: sw.block_min_sweep_qmajor(q_512, aug512, r=512),
         lambda: sw.block_min_sweep_qmajor_reference(q_512, aug512, r=512),
         (128, aug512, 512, 8)),
        ("block_min_qmajor_compact", 300,
         lambda: sw.block_min_sweep_qmajor(q_aug, aug64, r=SWEEP_R,
                                           compact=True),
         lambda: sw.block_min_sweep_qmajor_reference(q_aug, aug64, r=SWEEP_R,
                                                     compact=True),
         (BATCH, aug64, SWEEP_R, 3)),
        ("block_min2", 395,
         lambda: sw.block_min2_sweep(q_top2, aug64, r=SWEEP_R),
         lambda: sw.block_min2_sweep_reference(q_top2, aug64, r=SWEEP_R),
         (BATCH // 2, aug64, SWEEP_R, 16)),
    ]
    records = []
    for name, line, kernel, plain, (b, aug, r, out_b) in forms:
        k_ms, p_ms = turns(kernel, plain, 20, 3)
        n_rows, width = aug.shape
        ops = 2 * b * width * n_rows
        nbytes = (aug.numel() * aug.element_size() + b * width * 2
                  + (n_rows // r) * b * out_b)
        b_ms, b_by = bound(ops, PEAK_BF16, nbytes)
        # [9] and [10] asserted the kernel that serves each form
        source = "block_min_compact" if name in plans else "block_min_sweep"
        log(f"[11 kernel time] {name} ({source}.cu): B={b}, r={r}, "
            f"rows {n_rows}, L2 "
            f"flushed: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms, bound by {b_by} ({ops} bf16 FLOP, {nbytes} "
            f"bytes) -> "
            f"{ops / k_ms / 1e9:.1f} TFLOP/s, {b_ms / k_ms:.3f} of the bound "
            f"({smi})")
        if name in plans:
            # the same call on the mma.sync kernel it replaces, same run
            q, top2 = {"block_min": (q_aug, False),
                       "block_min2": (q_top2, True),
                       "block_min_qmajor": (q_512, False)}.get(
                           name, (q_aug, False))
            compact = name == "block_min_qmajor_compact"
            qmajor = compact or name == "block_min_qmajor"
            old_ms, new_ms = turns(
                lambda: sw._launch(name, q, aug, r, None, qmajor=qmajor,
                                   compact=compact, top2=top2,
                                   mma_sync=True),
                kernel, 20, 20)
            log(f"[11 kernel time] {name} yardstick, L2 flushed, in turns: "
                f"block_min_sweep.cu instance {old_ms:.4f} ms "
                f"({b_ms / old_ms:.3f} of the bound), block_min_compact.cu "
                f"{new_ms:.4f} ms ({b_ms / new_ms:.3f} of the bound), "
                f"{old_ms / new_ms:.2f}x; plan {plans[name]} ({smi})")
        if name == "block_min_qmajor":
            # the kernels alone, launched back to back through their C
            # entries (the wrapper's host work, which the cold timings
            # above include where it outlasts the card's, left out), in
            # turns new, old, old, new; and the wrappers' host time a call
            plan4 = plans[name]
            v4 = torch.empty(128, n_rows // r, device=dev)
            l4 = torch.empty(128, n_rows // r, dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            new4 = functools.partial(
                sw._compact_kernel_fn(), aug.data_ptr(), q.data_ptr(),
                None, v4.data_ptr(), l4.data_ptr(), n_rows, 128, width, r,
                plan4.stages, plan4.run_tiles, plan4.cluster,
                sw.SWEEP_FORMS.index("qmajor"), None, None, stream)
            old4 = functools.partial(
                sw._kernel_fn(), aug.data_ptr(), q.data_ptr(), None,
                v4.data_ptr(), l4.data_ptr(), None, None, n_rows, 128, width,
                r, 0, 0, 1, 0, stream)
            raw = [back_to_back_ms(f, 20) for f in (new4, old4, old4, new4)]
            q8, aug8r = q[:8].contiguous(), aug[:128 * r]
            h_new = host_us(lambda: sw.block_min_sweep_qmajor(q8, aug8r,
                                                              r=r))
            h_old = host_us(lambda: sw._launch(
                name, q8, aug8r, r, None, qmajor=True, compact=False,
                top2=False, mma_sync=True))
            log(f"[11 kernel time] block_min_qmajor back to back, L2 warm, "
                f"in turns: block_min_compact.cu {raw[0]:.4f}, "
                f"{raw[3]:.4f} ms ({b_ms / raw[0]:.3f}, {b_ms / raw[3]:.3f} "
                f"of the bound), block_min_sweep.cu {raw[1]:.4f}, "
                f"{raw[2]:.4f} ms; host time a call of the wrapper (B=8, "
                f"{128 * r} rows): {h_new:.1f} us on block_min_compact.cu, "
                f"{h_old:.1f} us on block_min_sweep.cu ({smi})")
        records.append({
            "name": name, "route": "cuda",
            "source": f"scann_tpu_torch/csrc/{source}.cu",
            "replaces": f"scann_tpu/ops/sweep_pallas.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    mm_ms = cold_ms(lambda: torch.matmul(aug64, q_aug.T), 10)
    log(f"[11 aside] torch.matmul(db_aug, q_aug.T) bf16 [{n_pad}, {BATCH}] "
        f"at the main shapes: {mm_ms:.4f} ms (product only, not the same "
        f"function; the port never calls it) ({smi})")

    aug, rows, _ = main_s.device_state()
    inv = main_s._inv_perm
    inf = float("inf")

    def staged(qb):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        qa, cut = sw.augment_for_sweep(qb, aug, measure)
        ev[1].record()
        form, outs = sw.block_minima(qa, aug, r=SWEEP_R)
        ev[2].record()
        pv, cand = sw.candidates_from_minima(form, outs, pre_k=SWEEP_PRE_K,
                                             r=SWEEP_R)
        ev[3].record()
        exact = sw.rerank_candidates(rows, qb, pv, cand, measure, inf, cut)
        ev[4].record()
        sw.finalize_results(exact, cand, K, inf, inv)
        ev[5].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]

    staged(q0)
    split = np.array([staged(queries[i * BATCH:(i + 1) * BATCH])
                      for i in range(BATCHES)])
    log("[11 sweep stages] per batch ms: " + ", ".join(
        f"{n} {v:.4f}" for n, v in zip(
            ("augment", "sweep", "select", "gather+rerank", "finalize"),
            split.mean(0))) + f", sum {split.sum(1).mean():.4f} ({smi})")
    med, top = event_ms(lambda qb: main_s.search_batched_tensors(qb, K),
                        queries, BATCH, BATCHES)
    log(f"[11 sweep search time] search_batched_tensors, r={SWEEP_R}, "
        f"pre_k={SWEEP_PRE_K}, B={BATCH}, n={3 * BATCHES} batches: median "
        f"{med:.4f} ms, max {top:.4f} ms -> {BATCH / med * 1e3:.0f} "
        f"queries/s at recall@10 {recall:.4f} ({smi})")
    log("[11 sweep search time] side paths on block_min_compact.cu, median "
        "per batch: " + ", ".join(
            f"{n} {v:.4f} ms" for n, v in side_medians.items())
        + f" ({smi})")
    return records


def hasher_phases(ds, queries, db_dev, gt_np, cold_ms, turns, smi):
    """Phases 12-15, the asymmetric hasher; returns the kernels' JSON
    records."""
    import numpy as np
    import torch

    from scann_tpu_torch import (
        AsymmetricHasher,
        AsymmetricHasherConfig,
        DenseDataset,
        SearchParameters,
    )
    from scann_tpu_torch.hashes import hasher as ah
    from scann_tpu_torch.ops import scoring_kernels as sk
    from scann_tpu_torch.ops import topk
    from scann_tpu_torch.ops.distances import DistanceMeasure
    from scann_tpu_torch.ops.sweep import finalize_results
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    dev = queries.device
    measure = DistanceMeasure.SQUARED_L2
    inf = float("inf")
    cfg = AsymmetricHasherConfig(num_codes=AH_C, num_subspaces=AH_S, seed=42,
                                 max_iterations=12,
                                 training_sample_size=100_000)

    # -- 12. build: codebook, codes and both device layouts on the card ----------
    def build(dataset, label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = AsymmetricHasher(cfg, device=dev).build(dataset)
        packed, codes_t = h._device_codes_packed_t(), h._device_codes_t()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rows = dataset.device_tensor(dev)
        log(f"[12 hasher build/{label}] {secs:.2f}s on the card: codes "
            f"{list(h.codes.shape)} u8, packed codes {list(packed.shape)} "
            f"{packed.numel()} bytes, transposed codes {list(codes_t.shape)} "
            f"{codes_t.numel()} bytes, float32 re-rank rows "
            f"{list(rows.shape)} {rows.numel() * 4} bytes, memory_usage "
            f"{h.memory_usage()}")
        return h

    h = build(ds, "main")
    small = build(DenseDataset(ds.numpy()[:AH_SMALL_N]), f"{AH_SMALL_N} rows")
    n = h.dataset_size()
    packed_t, codes_t = h._device_codes_packed_t(), h._device_codes_t()
    cent = h.codebook.centroids

    # -- 13. each kernel against its twin on the first batch's real tables -------
    q0 = queries[:BATCH]
    luts = ah._ah_luts(q0, cent, measure)                     # [B, S, C] f32
    luts_i8, mult, bias = ah.quantized_tables(luts)
    got = sk.lut16_fused_sweep(luts_i8, packed_t, n, r=h.FUSED_R)
    torch.cuda.synchronize()
    want = sk.lut16_fused_sweep_reference(luts_i8, packed_t, n, h.FUSED_R)
    fused_err = float((got - want).abs().max())
    log(f"[13 kernel check] lut16_fused_sweep: B={BATCH}, S_pad "
        f"{2 * packed_t.shape[0]}, r={h.FUSED_R}, packed codes "
        f"{list(packed_t.shape)} -> minima {list(got.shape)}: bit-identical "
        f"{torch.equal(got.view(torch.int32), want.view(torch.int32))}, max "
        f"abs err {fused_err} (tolerance: bit for bit), invalid blocks "
        f"{int((want >= sk.INVALID_COMBINED / 2).sum())}, "
        f"{sk.lut16_fused_smem_bytes(packed_t.shape[0])} bytes of shared "
        f"memory per CTA")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("lut16_fused_sweep differs from its twin")
    del got, want

    def order(x):
        """Values -> integer keys whose differences count ulps of x's
        type."""
        bits = x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16
                                   else torch.int32).long()
        mag = bits & (0x7FFF if x.dtype == torch.bfloat16 else 0x7FFFFFFF)
        return torch.where(bits < 0, -mag, mag)

    # the 16,384-row hasher's tables and codes (its own codebook)
    luts_small = ah._ah_luts(q0, small.codebook.centroids, measure)
    codes_small = small._device_codes_t()
    score_err = 0.0
    for label, lb, ct, dtype in (
            ("timing shape", luts, codes_t, torch.bfloat16),
            ("approximate only", luts[:AH_APPROX_B], codes_t, torch.float32),
            (f"{AH_SMALL_N} rows re-rank", luts_small, codes_small,
             torch.bfloat16)):
        sk.reset_launches()
        got = sk.lut16_score(lb, ct, dtype)
        torch.cuda.synchronize()
        served = dict(sk.SCORE_LAUNCHES)
        want = sk.lut16_score_reference(lb, ct, dtype)
        same = torch.equal(got, want)
        ulp = 0 if same else int((order(got) - order(want)).abs().max())
        err = float((got.float() - want.float()).abs().max())
        score_err = max(score_err, err)
        log(f"[13 kernel check] lut16_score ({label}): B={lb.shape[0]}, "
            f"{dtype}, codes {list(ct.shape)} -> {list(got.shape)}, plan "
            f"{sk.lut16_score_plan(lb.shape[0], AH_S, AH_C, ct.shape[1])}, "
            f"launches by kernel {served}: bit-identical {same}, max {ulp} "
            f"ulp, max abs err {err} (tolerance: bit for bit, both add bf16 "
            f"entries in ascending s in float32)")
        if not same:
            raise AssertionError(f"lut16_score ({dtype}) differs from its "
                                 f"twin by up to {ulp} ulp")
        if served != {"query_tiled": 1, "column_per_thread": 0}:
            raise AssertionError(f"lut16_score ({label}) served by {served}, "
                                 f"not the query-tiled kernel alone")
        del got, want

    # -- 14. search through the entry point: each path counted from zero ---------
    launches = {}

    def run(s, qs, batch, params, kernel, label, gt, floor=None,
            exact=True):
        sk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [s.search_batched_tensors(qs[i:i + batch], K, params)
               for i in range(0, len(qs), batch)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sk.LAUNCHES)
        launches[label] = counts[kernel]
        idx = torch.cat([x[0] for x in res])
        dists = torch.cat([x[1] for x in res])
        rows = s._dataset.device_tensor(dev)
        err = check_results(idx, dists, qs, rows, len(qs), exact_check=exact)
        recall = recall_at_k(idx.cpu().numpy(), gt, K)
        log(f"[14 hasher search/{label}] {len(qs)} queries in calls of "
            f"{batch}: recall@10 {recall:.4f}"
            + (f" (floor {floor})" if floor else "")
            + f", launches {counts}, returned vs recomputed distances max "
            f"rel err {err:.3g}, host wall {wall:.3f}s")
        if counts[kernel] <= 0:
            raise AssertionError(f"{label}: {kernel} was never launched")
        if kernel == "lut16_score" and sk.SCORE_LAUNCHES != {
                "query_tiled": counts[kernel], "column_per_thread": 0}:
            raise AssertionError(f"{label}: lut16_score launches by kernel "
                                 f"{sk.SCORE_LAUNCHES}, not all query-tiled")
        if floor is not None and recall < floor:
            raise AssertionError(f"{label}: recall@10 {recall} < {floor}")
        return recall

    params = SearchParameters(pre_reordering_num_neighbors=AH_PRE_K)
    recall = run(h, queries, BATCH, params, "lut16_fused_sweep", "main fused",
                 gt_np, AH_RECALL_FLOOR)
    run(h, queries[:AH_APPROX_B], AH_APPROX_B, None, "lut16_score",
        "approximate only", gt_np[:AH_APPROX_B], exact=False)
    small_rows = small._dataset.device_tensor(dev)
    q_small = queries[:BATCH]
    small_gt = torch.topk(
        (q_small * q_small).sum(1)[:, None] + (small_rows * small_rows).sum(1)
        - 2.0 * (q_small @ small_rows.T), K, dim=1,
        largest=False).indices.cpu().numpy()
    run(small, q_small, BATCH, params, "lut16_score",
        f"{AH_SMALL_N} rows re-rank", small_gt, AH_RECALL_FLOOR)

    # -- 15. timings -------------------------------------------------------------
    s_pad = 2 * packed_t.shape[0]
    n_pad = packed_t.shape[1]
    r = h.FUSED_R
    f_ms, f_plain = turns(
        lambda: sk.lut16_fused_sweep(luts_i8, packed_t, n, r=r),
        lambda: sk.lut16_fused_sweep_reference(luts_i8, packed_t, n, r),
        20, 3)
    # operations as the TPU kernel's one-hot product counts them; bytes:
    # packed codes and tables read once, the minima written once
    f_ops = 2 * BATCH * s_pad * AH_C * n_pad
    f_bytes = packed_t.numel() + luts_i8.numel() + (n_pad // r) * BATCH * 4
    f_bound, f_by = bound(f_ops, PEAK_INT8, f_bytes)
    log(f"[15 kernel time] lut16_fused_sweep: B={BATCH}, rows {n_pad}, L2 "
        f"flushed: kernel {f_ms:.4f} ms, plain twin {f_plain:.4f} ms, bound "
        f"{f_bound:.4f} ms, bound by {f_by} ({f_ops} int8 ops, {f_bytes} "
        f"bytes) -> {f_ops / f_ms / 1e9:.1f} TOPS, {f_bound / f_ms:.3f} of "
        f"the bound ({smi})")
    score = {}
    for label, lb, ct, dtype, reps in (
            ("approximate only", luts[:AH_APPROX_B], codes_t, torch.float32,
             10),
            (f"{AH_SMALL_N} rows re-rank", luts_small, codes_small,
             torch.bfloat16, 50),
            ("timing shape", luts, codes_t, torch.bfloat16, 10)):
        k_ms, p_ms = turns(lambda: sk.lut16_score(lb, ct, dtype),
                           lambda: sk.lut16_score_reference(lb, ct, dtype),
                           reps, 2)
        # the same call on the one-column-a-thread kernel it replaced, in
        # turns new, old, old, new
        old_ms, new_ms = turns(
            lambda: sk._score_launch(lb, ct, dtype, per_column=True),
            lambda: sk.lut16_score(lb, ct, dtype), reps, reps)
        # the kernel looks entries up and sums them: one float32 add per
        # table entry per column and query, as for the grouped scorer
        b, cols = lb.shape[0], ct.shape[1]
        ops = b * AH_S * cols
        nbytes = (ct.numel() + lb.numel() * 4
                  + b * cols * (2 if dtype == torch.bfloat16 else 4))
        b_ms, b_by = bound(ops, PEAK_F32_ADD, nbytes)
        score[label] = (k_ms, p_ms, b_ms, b_by)
        log(f"[15 kernel time] lut16_score ({label}): B={b}, {dtype}, "
            f"columns {cols}, L2 flushed: kernel {k_ms:.4f} ms, plain twin "
            f"{p_ms:.4f} ms, bound {b_ms:.4f} ms, bound by {b_by} ({ops} "
            f"float32 adds at {PEAK_F32_ADD:.4g}/s, {nbytes} bytes) -> "
            f"{b_ms / k_ms:.3f} of the bound; yardstick in turns: "
            f"one-column-a-thread kernel {old_ms:.4f} ms ({b_ms / old_ms:.3f} "
            f"of the bound), query-tiled {new_ms:.4f} ms "
            f"({b_ms / new_ms:.3f}), {old_ms / new_ms:.2f}x; plan "
            f"{sk.lut16_score_plan(b, AH_S, AH_C, cols)} ({smi})")
    # the 16,384-row call's kernels alone, back to back through their C
    # entries, in turns new, old, old, new; and the wrappers' host time
    score_fn, _, tiled_fn = sk._kernel_fns()
    plan8 = sk.lut16_score_plan(BATCH, AH_S, AH_C, codes_small.shape[1])
    img8 = sk.lut16_score_table_image(luts_small, plan8.q_tile)
    table8 = luts_small.to(torch.bfloat16).contiguous()
    out8 = torch.empty(BATCH, codes_small.shape[1], dtype=torch.bfloat16,
                       device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    codes8 = codes_small.contiguous()
    dims8 = (BATCH, AH_S, AH_C, codes8.shape[1], 1)
    new8 = functools.partial(tiled_fn, img8.data_ptr(), codes8.data_ptr(),
                             out8.data_ptr(), *dims8, plan8.q_tile,
                             plan8.stage_rows, stream)
    old8 = functools.partial(score_fn, table8.data_ptr(), codes8.data_ptr(),
                             out8.data_ptr(), *dims8, stream)
    raw = [back_to_back_ms(f, 50) for f in (new8, old8, old8, new8)]
    l8, c8 = luts_small[:8], codes_small[:, :256]
    h_new = host_us(lambda: sk.lut16_score(l8, c8, torch.bfloat16))
    h_old = host_us(lambda: sk._score_launch(l8, c8, torch.bfloat16,
                                             per_column=True))
    b_small = score[f"{AH_SMALL_N} rows re-rank"][2]
    log(f"[15 kernel time] lut16_score ({AH_SMALL_N} rows re-rank) back to "
        f"back, L2 warm, in turns: query-tiled {raw[0]:.4f}, {raw[3]:.4f} ms "
        f"({b_small / raw[0]:.3f}, {b_small / raw[3]:.3f} of the bound), "
        f"one-column-a-thread {raw[1]:.4f}, {raw[2]:.4f} ms; host time a "
        f"call of the wrapper (B=8, 256 columns): {h_new:.1f} us "
        f"query-tiled, {h_old:.1f} us one-column-a-thread ({smi})")
    del img8, table8, out8
    # the two search paths that launch #8, with #8 on the query-tiled
    # kernel and on the kernel it replaced, in turns new, old, old, new
    tiled = ah.lut16_score

    def per_column(lt, ct, out_dtype=torch.float32):
        return sk._score_launch(lt, ct, out_dtype, per_column=True)

    for s_, label, batch, prm in (
            (h, "approximate only", AH_APPROX_B, None),
            (small, f"{AH_SMALL_N} rows re-rank", BATCH, params)):
        sel0 = topk.SELECT_KERNEL_ROWS
        meds = []
        for old_kernel in (False, True, True, False):
            if old_kernel:
                ah.lut16_score = per_column
            try:
                meds.append(event_ms(
                    lambda qb: s_.search_batched_tensors(qb, K, prm),
                    queries, batch, BATCHES))
            finally:
                ah.lut16_score = tiled
        log(f"[15 hasher search time/{label}] search_batched_tensors, "
            f"B={batch}, n={3 * BATCHES} batches a turn, median (max) ms "
            f"with #8 query-tiled {meds[0][0]:.4f} ({meds[0][1]:.4f}), "
            f"{meds[3][0]:.4f} ({meds[3][1]:.4f}), one-column-a-thread "
            f"{meds[1][0]:.4f} ({meds[1][1]:.4f}), {meds[2][0]:.4f} "
            f"({meds[2][1]:.4f}); bf16 rows to the selection kernel "
            f"{topk.SELECT_KERNEL_ROWS - sel0} ({smi})")
    onehot = torch.nn.functional.one_hot(h.codes.long(), AH_C).reshape(
        n, AH_S * AH_C).to(torch.bfloat16)
    lut_bf = luts.reshape(BATCH, -1).to(torch.bfloat16)
    mm_ms = cold_ms(lambda: torch.matmul(lut_bf, onehot.T), 5)
    log(f"[15 aside] torch.matmul of the materialised bf16 one-hot, "
        f"[{BATCH}, {AH_S * AH_C}] x [{AH_S * AH_C}, {n}] -> bf16: "
        f"{mm_ms:.4f} ms (the one-hot alone is {onehot.numel() * 2} bytes; "
        f"the port never calls it) ({smi})")
    del onehot

    def staged(qb):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        lt = ah._ah_luts(qb, cent, measure)
        ev[1].record()
        i8, mu, bi = ah.quantized_tables(lt)
        ev[2].record()
        comb = sk.lut16_fused_sweep(i8, packed_t, n, r=r)
        ev[3].record()
        cand, valid = ah.fused_candidates(comb, mu, bi, AH_S, pre_k=AH_PRE_K,
                                          r=r, measure=measure)
        ev[4].record()
        exact = ah.rerank_exact(db_dev, qb, cand, valid, measure)
        ev[5].record()
        finalize_results(exact, cand, K, inf)
        ev[6].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]

    staged(q0)
    split = np.array([staged(queries[i * BATCH:(i + 1) * BATCH])
                      for i in range(BATCHES)])
    log("[15 hasher stages] per batch ms: " + ", ".join(
        f"{nm} {v:.4f}" for nm, v in zip(
            ("lut", "quantise", "sweep", "select", "gather+rerank",
             "finalize"), split.mean(0)))
        + f", sum {split.sum(1).mean():.4f} ({smi})")
    med, top = event_ms(lambda qb: h.search_batched_tensors(qb, K, params),
                        queries, BATCH, BATCHES)
    log(f"[15 hasher search time] search_batched_tensors, S={AH_S}, "
        f"pre_k={AH_PRE_K}, B={BATCH}, n={3 * BATCHES} batches: median "
        f"{med:.4f} ms, max {top:.4f} ms -> {BATCH / med * 1e3:.0f} "
        f"queries/s at recall@10 {recall:.4f} ({smi})")
    k_ms, p_ms, b_ms, b_by = score["approximate only"]
    return [
        {"name": "lut16_fused_sweep", "route": "cuda",
         "source": "scann_tpu_torch/csrc/lut16_scoring.cu",
         "replaces": "scann_tpu/ops/pallas_kernels.py:109",
         "launches": launches["main fused"], "max_abs_err": fused_err,
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": None},
        {"name": "lut16_score", "route": "cuda",
         "source": "scann_tpu_torch/csrc/lut16_scoring.cu",
         "replaces": "scann_tpu/ops/pallas_kernels.py:40",
         "launches": (launches["approximate only"]
                      + launches[f"{AH_SMALL_N} rows re-rank"]),
         "max_abs_err": score_err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None},
    ]


def check_quantized(idx, dists, queries, rows, label):
    """Holds quantized-search results against the exact top-k over the
    stored (dequantized) ``rows`` [N, D] float32: returned distances equal
    the rows' recomputed distances and the exact k smallest to 1e-5 of the
    terms |q|^2 + |x|^2 the formula cancels; ids equal the exact ids at
    every slot whose exact distance lies farther than that from its
    neighbours' (the (k+1)-th included). Returns (max abs err, slots
    compared, queries with a tie inside the tolerance)."""
    import torch

    if tuple(idx.shape) != (len(queries), K) or bool((idx < 0).any()):
        raise AssertionError(f"{label}: bad result ids")
    x_sq = (rows * rows).sum(1)
    ev, ei = [], []
    for i in range(0, len(queries), 256):
        qb = queries[i:i + 256]
        dd = (qb * qb).sum(1)[:, None] + x_sq[None, :] - 2.0 * (qb @ rows.T)
        v, j = torch.topk(dd.clamp_min(0.0), K + 1, dim=1, largest=False)
        ev.append(v)
        ei.append(j)
    ev, ei = torch.cat(ev), torch.cat(ei)
    tol = 1e-5 * ((queries * queries).sum(1) + x_sq[ei].amax(1))[:, None]
    here = ((queries[:, None, :] - rows[idx]) ** 2).sum(-1)
    err = torch.maximum((dists - here).abs(), (dists - ev[:, :K]).abs())
    if bool((err > tol).any()):
        raise AssertionError(f"{label}: distances off the exact ones by up "
                             f"to {float(err.max())}")
    ext = torch.cat([torch.full_like(ev[:, :1], -float("inf")), ev], 1)
    gap = torch.minimum(ext[:, 1:K + 1] - ext[:, :K],
                        ext[:, 2:K + 2] - ext[:, 1:K + 1])
    strict = gap > tol
    if not torch.equal(idx[strict], ei[:, :K][strict]):
        raise AssertionError(f"{label}: ids differ from the exact top-{K} "
                             f"away from ties")
    return (float(err.max()), int(strict.sum()),
            int((~strict).any(1).sum()))


def brute_force_phases(ds, queries, db_dev, gt_np, cold_ms, turns, smi):
    """Phases 16-19, exact and scalar-quantized brute force; returns the
    kernels' JSON records."""
    import numpy as np
    import torch

    from scann_tpu_torch import (
        BruteForceSearcher,
        DenseDataset,
        ScalarQuantizedBruteForceSearcher,
        ScalarQuantizedConfig,
    )
    from scann_tpu_torch.models import brute_force as pbf
    from scann_tpu_torch.ops import asymmetric as asym
    from scann_tpu_torch.ops import fused_bf as fb
    from scann_tpu_torch.ops import scoring_kernels as sk
    from scann_tpu_torch.ops import topk as tk
    from scann_tpu_torch.ops.distances import (
        DistanceMeasure,
        many_to_many,
        mask_padded_rows,
    )
    from scann_tpu_torch.ops.topk import top_k_smallest
    from scann_tpu_torch.types import MASKED_DISTANCE
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    dev = queries.device
    measure = DistanceMeasure.SQUARED_L2

    def serve(s, qs, batch):
        """(ids, distances, host wall s, fused launches, int8-dots
        launches) of ``s`` over ``qs`` in calls of ``batch``, counted from
        zero."""
        fb.reset_launches()
        sk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [s.search_batched_tensors(qs[i:i + batch], K)
               for i in range(0, len(qs), batch)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res]),
                wall, fb.LAUNCHES, sk.LAUNCHES["int8_dots"])

    # -- 16. exact brute force over the 1.18M rows: the composed path ---------
    bf = BruteForceSearcher(ds, device=dev)
    if bf._use_fused(K, None, BATCH):
        raise AssertionError("the 1.18M-row search passed the fused gate")
    idx, dists, wall, f_l, _ = serve(bf, queries, BATCH)
    bf_recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    err = check_results(idx, dists, queries, db_dev, len(queries))
    chunk = pbf.query_chunk(ds.size)
    log(f"[16 brute force] {BATCHES} x B={BATCH}, k={K}, query chunk {chunk}: "
        f"recall@10 {bf_recall:.4f} (floor {BF_RECALL_FLOOR}), fused "
        f"launches {f_l}, returned vs recomputed distances max rel err "
        f"{err:.3g}, host wall {wall:.3f}s")
    if bf_recall < BF_RECALL_FLOOR:
        raise AssertionError(f"brute force recall@10 {bf_recall} < "
                             f"{BF_RECALL_FLOOR}")
    if f_l:
        raise AssertionError("the composed path launched the fused kernel")
    db, norms, n = bf._device_state()
    q0 = queries[:BATCH]

    def bf_staged(qb):
        t = np.zeros(2)
        for lo in range(0, len(qb), chunk):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            dd = many_to_many(measure, qb[lo:lo + chunk], db, norms)
            ev[1].record()
            top_k_smallest(dd, K)
            ev[2].record()
            torch.cuda.synchronize()
            t += [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])]
        return t

    bf_staged(q0)
    split = np.array([bf_staged(queries[i * BATCH:(i + 1) * BATCH])
                      for i in range(BATCHES)])
    log(f"[16 brute force stages] per batch ms, {-(-BATCH // chunk)} chunks: "
        f"distances {split[:, 0].mean():.4f}, select {split[:, 1].mean():.4f}"
        f", sum {split.sum(1).mean():.4f} ({smi})")
    # aside: the port's selection (the k + 1 smallest float32 values, the
    # tie-free int64 key only to order them) against the key over whole rows
    dd = many_to_many(measure, q0[:chunk], db, norms)
    by_value, by_key = turns(lambda: top_k_smallest(dd, K),
                             lambda: tk._top_k_by_key(dd, K), 10, 10)
    if not torch.equal(top_k_smallest(dd, K)[1], tk._top_k_by_key(dd, K)[1]):
        raise AssertionError("the two selections disagree")
    log(f"[16 aside] top-{K} of one chunk [{dd.shape[0]}, {dd.shape[1]}] "
        f"float32, L2 flushed: by value {by_value:.4f} ms, by the int64 key "
        f"over the whole row {by_key:.4f} ms, same ids ({smi})")
    del dd
    # aside for the fused gate: both fused kernels on this search, which the
    # JAX package's 14 MB gate sends to the composed path
    got_v, got_i = fb.fused_bf_search(q0, db, norms, n, K)
    torch.cuda.synchronize()
    check_results(got_i.long(), got_v, q0, db_dev, BATCH)
    f_recall = recall_at_k(got_i.cpu().numpy(), gt_np[:BATCH], K)
    old_v, old_i = fb._launch(q0, db, norms, n, K, scratch_merge=True)
    aside_err = [twin_chunks(fb, q0, db, norms, n, K, v, i)
                 for v, i in ((got_v, got_i), (old_v, old_i))]
    del old_v, old_i
    f_ms, o_ms = turns(lambda: fb.fused_bf_search(q0, db, norms, n, K),
                       lambda: fb._launch(q0, db, norms, n, K,
                                          scratch_merge=True), 3, 3)
    c_ms = cold_ms(lambda: bf.search_batched_tensors(q0, K), 3)
    log(f"[16 aside] the fused kernels on one batch of this search "
        f"(B={BATCH}, {n} rows; the gate refuses it; plan "
        f"{fb._device_plan(dev.index or 0, BATCH, n, D, K)}): recall@10 "
        f"{f_recall:.4f}, max abs err against the twin {aside_err[0]:.6g} "
        f"(the first port's kernel {aside_err[1]:.6g}); L2 flushed, in turns:"
        f" cluster kernel {f_ms:.4f} ms, the first port's kernel {o_ms:.4f} "
        f"ms; the composed path {c_ms:.4f} ms ({smi})")
    med, top = event_ms(lambda qb: bf.search_batched_tensors(qb, K), queries,
                        BATCH, BATCHES)
    log(f"[16 brute force search time] search_batched_tensors, B={BATCH}, "
        f"n={3 * BATCHES} batches: median {med:.4f} ms, max {top:.4f} ms -> "
        f"{BATCH / med * 1e3:.0f} queries/s at recall@10 {bf_recall:.4f} "
        f"({smi})")
    del bf, db, norms

    # -- 17. the fused kernel at bench.py's headline shape --------------------
    rng = np.random.default_rng(42)
    h_ds = DenseDataset(rng.random((HEAD_N, HEAD_D), dtype=np.float32))
    hq = torch.from_numpy(rng.random((HEAD_B, HEAD_D),
                                     dtype=np.float32)).to(dev)
    hsat = torch.from_numpy(rng.random((HEAD_B_SAT, HEAD_D),
                                       dtype=np.float32)).to(dev)
    hs = BruteForceSearcher(h_ds, device=dev)
    hdb, hnorms, hn = hs._device_state()
    if not hs._use_fused(K, None, HEAD_B) or hs._use_fused(K, None,
                                                           HEAD_B_SAT):
        raise AssertionError("the gate should pass B=100 and refuse B=6400")
    got_v, got_i = fb.fused_bf_search(hq, hdb, hnorms, hn, K)
    torch.cuda.synchronize()
    rep = fb.check_against_twin(hq, hdb, hnorms, hn, K, got_v, got_i)
    head_plan = fb._device_plan(dev.index or 0, HEAD_B, hn, HEAD_D, K)
    old_v, old_i = fb._launch(hq, hdb, hnorms, hn, K, scratch_merge=True)
    torch.cuda.synchronize()
    rep_old = fb.check_against_twin(hq, hdb, hnorms, hn, K, old_v, old_i)
    log(f"[17 kernel check] fused_bf cluster kernel: B={HEAD_B}, {HEAD_N} x "
        f"{HEAD_D}, k={K}, plan {head_plan} (ring stages of "
        f"{fb.slab_width(head_plan.q_tile, HEAD_D)} d): max abs err "
        f"{rep['max_abs_err']:.6g}, max rel err {rep['max_rel_err']:.3g} "
        f"(tolerance 1e-5 of |q|^2 + |x|^2), ids equal at "
        f"{rep['ids_compared']} of {HEAD_B * K} slots away from ties; the "
        f"first port's kernel: max abs err {rep_old['max_abs_err']:.6g}")
    exact = torch.cat([torch.topk(((hq[i:i + 25, None, :] - hdb[None]) ** 2)
                                  .sum(-1), K, dim=1, largest=False).indices
                       for i in range(0, HEAD_B, 25)]).cpu().numpy()
    head = {}
    for label, qs in (("fused", hq), ("composed", hsat)):
        idx, dists, wall, f_l, _ = serve(hs, qs, len(qs))
        check_results(idx, dists, qs, hdb, len(qs))
        if label == "fused":
            head_recall = recall_at_k(idx.cpu().numpy(), exact, K)
            fused_launches = fb.LAUNCHES_BY_KERNEL["cluster"]
            if (head_recall < 1.0 or f_l <= 0 or fused_launches != f_l
                    or fb.LAUNCHES_BY_KERNEL["scratch_merge"]):
                raise AssertionError(
                    f"fused path: recall {head_recall}, launches {f_l}, by "
                    f"kernel {fb.LAUNCHES_BY_KERNEL}")
        elif f_l:
            raise AssertionError("B=6400 launched the fused kernel")
        head[label] = event_ms(lambda qb: hs.search_batched_tensors(qb, K),
                               qs, len(qs), 1, reps=30)
        log(f"[17 headline/{label}] B={len(qs)}: launches of fused_bf {f_l}"
            + (f" (the cluster kernel {fused_launches})"
               if label == "fused" else "")
            + (f", recall@10 {head_recall:.4f}" if label == "fused" else "")
            + f"; per-batch median {head[label][0]:.4f} ms, max "
            f"{head[label][1]:.4f} ms -> {len(qs) / head[label][0] * 1e3:.0f}"
            f" queries/s ({smi})")

    # aside for the fused gate: both kernels at B=6400, which the gate
    # refuses
    got_v, got_i = fb.fused_bf_search(hsat, hdb, hnorms, hn, K)
    old_v, old_i = fb._launch(hsat, hdb, hnorms, hn, K, scratch_merge=True)
    torch.cuda.synchronize()
    sat = fb.check_against_twin(hsat, hdb, hnorms, hn, K, got_v, got_i)
    sat_old = fb.check_against_twin(hsat, hdb, hnorms, hn, K, old_v, old_i)
    f_ms, o_ms = turns(
        lambda: fb.fused_bf_search(hsat, hdb, hnorms, hn, K),
        lambda: fb._launch(hsat, hdb, hnorms, hn, K, scratch_merge=True),
        10, 10)
    c_ms = cold_ms(lambda: hs.search_batched_tensors(hsat, K), 10)
    log(f"[17 aside] the fused kernels at B={HEAD_B_SAT} (the gate refuses "
        f"it; plan "
        f"{fb._device_plan(dev.index or 0, HEAD_B_SAT, hn, HEAD_D, K)}): "
        f"max abs err against the twin {sat['max_abs_err']:.6g} (the "
        f"first port's kernel {sat_old['max_abs_err']:.6g}); L2 flushed, in "
        f"turns: cluster kernel {f_ms:.4f} ms, the first port's kernel "
        f"{o_ms:.4f} ms; the composed path {c_ms:.4f} ms ({smi})")

    # -- 18. scalar-quantized int8 over the 1.18M rows ------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sq = ScalarQuantizedBruteForceSearcher(ds, ScalarQuantizedConfig(
        storage="int8"), device=dev)
    codes_t, norms_t, n, transposed = sq.device_codes()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    quant = sq.quantized_dataset.quantizer
    if not transposed:
        raise AssertionError("int8 codes on the card must take the kernel")
    log(f"[18 sq build] int8: {build_s:.2f}s (host statistics, codec on the "
        f"card, both layouts), range [{quant.min_value:.4f}, "
        f"{quant.max_value:.4f}], scale {quant.scale:.6f}, transposed codes "
        f"{list(codes_t.shape)} {codes_t.numel()} bytes, memory_usage "
        f"{sq.memory_usage()}")
    got = sk.int8_dots(q0, codes_t)
    torch.cuda.synchronize()
    dots_err = dots_ratio = 0.0
    for lo in range(0, codes_t.shape[1], 1 << 17):
        c = codes_t[:, lo:lo + (1 << 17)]
        want = sk.int8_dots_reference(q0, c)
        diff = (got[:, lo:lo + c.shape[1]] - want).abs()
        tol = 1e-5 * (q0.abs() @ c.float())
        if bool((diff > tol).any()):
            raise AssertionError("int8_dots differs from its twin past "
                                 "1e-5 * sum|q c|")
        dots_err = max(dots_err, float(diff.max()))
        dots_ratio = max(dots_ratio, float((diff / tol).max()))
    del got, want, diff, tol
    log(f"[18 kernel check] int8_dots: B={BATCH}, codes {list(codes_t.shape)}"
        f" -> [{BATCH}, {codes_t.shape[1]}]: max abs err {dots_err:.6g}, "
        f"at most {dots_ratio:.4f} of the tolerance (1e-5 * sum_d |q_d c_d| "
        f"per entry); {sk.int8_dots_smem_bytes(D)} bytes of shared memory "
        f"per CTA")
    scale = torch.tensor(quant.scale, dtype=torch.float32, device=dev)
    lo_v = torch.tensor(quant.min_value, dtype=torch.float32, device=dev)
    deq = (codes_t[:, :n].T.float() * scale + lo_v).contiguous()
    idx, dists, wall, _, sq_launches = serve(sq, queries, BATCH)
    sq_recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    q_err, q_cmp, q_ties = check_quantized(idx, dists, queries, deq, "int8")
    log(f"[18 sq search/int8] {BATCHES} x B={BATCH}: recall@10 "
        f"{sq_recall:.4f} (floor {SQ_RECALL_FLOOR}) against float32 exact, "
        f"int8_dots launches {sq_launches}; against the exact top-{K} over "
        f"the dequantized rows: max abs err {q_err:.4g}, ids equal at "
        f"{q_cmp} slots, {q_ties} queries with a tie inside the tolerance; "
        f"host wall {wall:.3f}s")
    if sq_recall < SQ_RECALL_FLOOR or sq_launches <= 0:
        raise AssertionError(f"int8: recall {sq_recall}, launches "
                             f"{sq_launches}")
    del deq

    # -- 19. side paths (one batch each), then timings ------------------------
    for storage in ("int4", "bf16", "fp8_e4m3"):
        side = ScalarQuantizedBruteForceSearcher(ds, ScalarQuantizedConfig(
            storage=storage), device=dev)
        c, _, sn, tr = side.device_codes()
        if tr:
            qz = side.quantized_dataset.quantizer
            rows = (c[:, :sn].T.float() * torch.tensor(
                qz.scale, dtype=torch.float32, device=dev) + torch.tensor(
                qz.min_value, dtype=torch.float32, device=dev)).contiguous()
        else:
            rows = c.float()
        idx, dists, _, _, s_l = serve(side, q0, BATCH)
        s_err, s_cmp, s_ties = check_quantized(idx, dists, q0, rows, storage)
        s_recall = recall_at_k(idx.cpu().numpy(), gt_np[:BATCH], K)
        log(f"[19 sq search/{storage}] B={BATCH}: recall@10 {s_recall:.4f} "
            f"(no floor), int8_dots launches {s_l}, memory_usage "
            f"{side.memory_usage()}; against the exact top-{K} over the "
            f"stored values: max abs err {s_err:.4g}, ids equal at {s_cmp} "
            f"slots, {s_ties} queries with a tie inside the tolerance")
        if (s_l > 0) != tr:
            raise AssertionError(f"{storage}: int8_dots launches {s_l}")
        del side, c, rows

    records = []
    k9, p9 = turns(lambda: sk.int8_dots(q0, codes_t),
                   lambda: sk.int8_dots_reference(q0, codes_t), 10, 3)
    codes_f = codes_t.float()
    lib9 = cold_ms(lambda: torch.matmul(q0, codes_f), 5)
    n_pad = codes_t.shape[1]
    q_chunk = q0[:pbf.query_chunk(n_pad)]
    k9c = cold_ms(lambda: sk.int8_dots(q_chunk, codes_t), 10)
    lib9c = cold_ms(lambda: torch.matmul(q_chunk, codes_f), 5)
    del codes_f
    b9c, by9c = bound(6 * len(q_chunk) * D * n_pad, PEAK_BF16,
                      D * n_pad + 4 * len(q_chunk) * (D + n_pad))
    log(f"[19 aside] int8_dots at the searcher's query chunk, "
        f"B={len(q_chunk)}, L2 flushed: kernel {k9c:.4f} ms (the wrapper's "
        f"query split and layout included), torch.matmul of float codes "
        f"{lib9c:.4f} ms, bound {b9c:.4f} ms, bound by {by9c} -> "
        f"{b9c / k9c:.3f} of the bound ({smi})")
    # the kernel's work as the tensor cores do it: three bf16 products of
    # the split queries with the codes
    ops9 = 3 * 2 * BATCH * D * n_pad
    bytes9 = D * n_pad + 4 * BATCH * D + 4 * BATCH * n_pad
    b9, by9 = bound(ops9, PEAK_BF16, bytes9)
    f32_b9, _ = bound(ops9 // 3, PEAK_F32, bytes9)
    log(f"[19 kernel time] int8_dots: B={BATCH}, D={D}, N_pad {n_pad}, L2 "
        f"flushed: kernel {k9:.4f} ms, plain twin {p9:.4f} ms, torch.matmul "
        f"of float codes made beforehand {lib9:.4f} ms, bound {b9:.4f} ms, "
        f"bound by {by9} ({ops9} bf16 FLOP of the three split products, "
        f"{bytes9} bytes; the float32 FMA form on the CUDA cores "
        f"{f32_b9:.4f} ms) -> {ops9 / k9 / 1e9:.1f} TFLOP/s, "
        f"{b9 / k9:.3f} of the bound ({smi})")
    records.append({
        "name": "int8_dots", "route": "cuda",
        "source": "scann_tpu_torch/csrc/int8_dots.cu",
        "replaces": "scann_tpu/ops/pallas_kernels.py:204",
        "launches": sq_launches, "max_abs_err": dots_err, "ms": k9,
        "plain_ms": p9, "bound_ms": b9, "bound_by": by9, "library_ms": lib9})

    sq_chunk = pbf.query_chunk(n_pad)

    def sq_staged(qb):
        t = np.zeros(3)
        for lo in range(0, len(qb), sq_chunk):
            qc = qb[lo:lo + sq_chunk]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            raw = sk.int8_dots(qc, codes_t)
            ev[1].record()
            dd = asym.fold_affine(measure, qc, raw, norms_t, quant.scale,
                                  quant.min_value)
            ev[2].record()
            top_k_smallest(mask_padded_rows(dd, n, MASKED_DISTANCE), K)
            ev[3].record()
            torch.cuda.synchronize()
            t += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        return t

    sq_staged(q0)
    split = np.array([sq_staged(queries[i * BATCH:(i + 1) * BATCH])
                      for i in range(BATCHES)])
    log(f"[19 sq stages] int8, per batch ms, query chunk {sq_chunk} "
        f"({-(-BATCH // sq_chunk)} chunks): dots {split[:, 0].mean():.4f}, "
        f"fold {split[:, 1].mean():.4f}, select {split[:, 2].mean():.4f}, sum "
        f"{split.sum(1).mean():.4f} ({smi})")
    med, top = event_ms(lambda qb: sq.search_batched_tensors(qb, K), queries,
                        BATCH, BATCHES)
    log(f"[19 sq search time] int8 search_batched_tensors, B={BATCH}, "
        f"n={3 * BATCHES} batches: median {med:.4f} ms, max {top:.4f} ms -> "
        f"{BATCH / med * 1e3:.0f} queries/s at recall@10 {sq_recall:.4f} "
        f"({smi})")

    k2, p2 = turns(lambda: fb.fused_bf_search(hq, hdb, hnorms, hn, K),
                   lambda: fb.fused_bf_search_reference(hq, hdb, hnorms, hn,
                                                        K), 50, 20)
    # the cluster kernel beside the first port's in turns (new, old, old,
    # new), each through its wrapper
    k2t, o2t = turns(lambda: fb.fused_bf_search(hq, hdb, hnorms, hn, K),
                     lambda: fb._launch(hq, hdb, hnorms, hn, K,
                                        scratch_merge=True), 50, 50)
    ops2 = 2 * HEAD_B * HEAD_N * HEAD_D
    bytes2 = 4 * (HEAD_B * HEAD_D + HEAD_N * HEAD_D + HEAD_N) + 8 * HEAD_B * K
    b2, by2 = bound(ops2, PEAK_F32, bytes2)
    log(f"[19 kernel time] fused_bf: B={HEAD_B}, {HEAD_N} x {HEAD_D}, k={K}, "
        f"L2 flushed: cluster kernel {k2:.4f} ms, plain twin (the composed "
        f"path: product, mask, tie-free top-k) {p2:.4f} ms, bound {b2:.4f} "
        f"ms, bound by {by2} ({ops2} float32 FLOP, {bytes2} bytes) -> "
        f"{b2 / k2:.3f} of the bound; in turns: cluster kernel {k2t:.4f} ms,"
        f" the first port's kernel {o2t:.4f} ms, {o2t / k2t:.2f}x ({smi})")
    # aside: each kernel alone, launched back to back through its C entry
    # point with the outputs (and the first port's scratch) allocated once,
    # for k = 1, 10, 16, in turns new, old, old, new; the wrappers' host time
    search2, _, old2 = fb._kernel_fns()
    per_split, n_splits = fb.split_plan(
        HEAD_B, HEAD_N, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    counters = torch.zeros(-(-HEAD_B // 32), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dk2 = fb.slab_width(head_plan.q_tile, HEAD_D)
    raw = []
    for kk in (1, K, fb.MAX_K):
        out_v = torch.empty(HEAD_B, kk, device=dev)
        out_i = torch.empty(HEAD_B, kk, dtype=torch.int32, device=dev)
        part = torch.empty(HEAD_B * n_splits * kk, dtype=torch.int64,
                           device=dev)

        def new_launch():
            return search2(hq.data_ptr(), hdb.data_ptr(), hnorms.data_ptr(),
                           hn, HEAD_B, HEAD_D, kk, head_plan.q_tile,
                           head_plan.cluster, head_plan.rows_per_cta, dk2,
                           out_v.data_ptr(), out_i.data_ptr(), stream)

        def old_launch():
            counters.zero_()
            return old2(hq.data_ptr(), hdb.data_ptr(), hnorms.data_ptr(), hn,
                        HEAD_B, HEAD_D, HEAD_N, kk, per_split, n_splits,
                        part.data_ptr(), counters.data_ptr(),
                        out_v.data_ptr(), out_i.data_ptr(), stream)

        for launch in (new_launch, old_launch):
            if launch():
                raise AssertionError("fused_bf launch failed")
            torch.cuda.synchronize()
            fb.check_against_twin(hq, hdb, hnorms, hn, kk, out_v, out_i)
        t = [back_to_back_ms(f, 300) for f in (new_launch, old_launch,
                                               old_launch, new_launch)]
        raw.append((kk, (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t))
    reset_ms = back_to_back_ms(lambda: (counters.zero_(), 0)[1], 300)
    hq8, hdb8, hn8 = hq[:8], hdb[:64], hnorms[:64]
    h_new = host_us(lambda: fb.fused_bf_search(hq8, hdb8, hn8, 64, K))
    h_old = host_us(lambda: fb._launch(hq8, hdb8, hn8, 64, K,
                                       scratch_merge=True))
    log(f"[19 aside] fused_bf launched back to back, B={HEAD_B}, L2 warm, in "
        f"turns (new, old, old, new): " + "; ".join(
            f"k={kk} cluster kernel {nm:.4f} ms ({t[0]:.4f}, {t[3]:.4f}), "
            f"the first port's {om:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), "
            f"{om / nm:.2f}x" for kk, nm, om, t in raw)
        + f"; k=16 / k=1: cluster kernel {raw[2][1] / raw[0][1]:.2f}, the "
        f"first port's {raw[2][2] / raw[0][2]:.2f}; of the first port's "
        f"times its counter reset {reset_ms:.4f} ms; host time a call of the "
        f"wrapper (B=8, 64 rows): {h_new:.1f} us cluster kernel, {h_old:.1f} "
        f"us the first port's ({smi})")
    records.append({
        "name": "fused_bf_cluster", "route": "cuda",
        "source": "scann_tpu_torch/csrc/fused_bf.cu",
        "replaces": "scann_tpu/ops/fused_bf_pallas.py:28",
        "launches": fused_launches, "max_abs_err": rep["max_abs_err"],
        "ms": k2, "plain_ms": p2, "bound_ms": b2, "bound_by": by2,
        "library_ms": None})
    return records


def soar_phases(ds, queries, db_dev, gt_np, cold_ms, turns, smi, base):
    """Phases 20-23, SOAR tree-x-AH and the tree-x-AH variants; returns the
    JSON records of kernels #1b and #10. ``base`` is phase 4's index."""
    import numpy as np
    import torch

    from scann_tpu_torch import (
        AsymmetricHasherConfig,
        DenseDataset,
        DistanceMeasure,
        SearchParameters,
        TreeXHybridConfig,
        TreeXHybridSearcher,
    )
    from scann_tpu_torch.models import tree_x_hybrid as tx
    from scann_tpu_torch.ops import tree_ah_grouped as tag
    from scann_tpu_torch.ops import tree_ah_leaf as tal
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    dev = queries.device
    inf = float("inf")

    # -- 20. SOAR build on the card ---------------------------------------------
    cfg = TreeXHybridConfig(
        num_partitions=2000, partitions_to_search=SOAR_P,
        max_partition_size="auto", spilling=True, spilling_mode="soar",
        soar_lambda=1.0, hash_config=AsymmetricHasherConfig(
            num_codes=16, num_subspaces=50, seed=42, max_iterations=12,
            training_sample_size=100_000))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = TreeXHybridSearcher(cfg, device=dev).build(ds)
    codes_p, off, sizes, perm, l_cap = s._csr_state()
    codes_u = s._csr_state(packed=False)[0]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tk = s.partitioner.tokenization
    cap = s.partitioner._cap_value(ds.size)
    mult = tk.max_multiplicity
    log(f"[20 soar build] {build_s:.2f}s on the card: K "
        f"{s.partitioner.num_partitions} (configured 2000), cap {cap}, "
        f"largest partition {tk.max_partition_size} (<= 2 * cap = "
        f"{2 * cap}), multiplicity {mult}, assignments "
        f"{len(tk.point_indices)}, l_cap {l_cap}, packed slab "
        f"{codes_p.numel()} bytes {list(codes_p.shape)}, unpacked slab "
        f"{codes_u.numel()} bytes {list(codes_u.shape)}")
    if tk.max_partition_size > 2 * cap or mult != 2:
        raise AssertionError(f"SOAR build: largest partition "
                             f"{tk.max_partition_size}, cap {cap}, "
                             f"multiplicity {mult}")

    # -- 21. #1b and #10 against their twins on the first batch's inputs ------
    cent, cb = s.partitioner.centers, s.codebook.centroids
    q0 = queries[:BATCH]
    q_cap = s.effective_q_cap(BATCH, SOAR_P)
    l_tile = cfg.score_l_tile
    s_pad = 2 * codes_p.shape[0]
    if codes_u.shape[0] != s_pad:
        raise AssertionError("packed and unpacked slabs pad S differently")
    parts = tx._select_partitions(cent, q0, p=SOAR_P)
    luts_flat = tx._residual_luts(q0, cent, parts, cb, s_pad=s_pad,
                                  use_residuals=True)
    luts_i8, _, _ = tx.quantize_luts_int8(luts_flat)
    lg8, go, gs, _ = tx._group_luts(luts_i8, parts, off, sizes, s_pad=s_pad,
                                    q_cap=q_cap, packed=True)
    args8 = (lg8, codes_p, go, gs)
    kw8 = dict(l_cap=l_cap, l_tile=l_tile, q_cap=q_cap, packed=True)
    got = tag.tree_ah_grouped_scores(*args8, **kw8)
    torch.cuda.synchronize()
    want = tag.tree_ah_grouped_scores_reference(*args8, **kw8)
    if got.dtype != torch.int16 or not torch.equal(got, want):
        raise AssertionError("int8 grouped kernel differs from its twin")
    err8 = float((got.float() - want.float()).abs().max())
    n_groups = lg8.shape[0] // q_cap
    log(f"[21 kernel check] tree_ah_grouped int8 (#1b): NG {n_groups}, q_cap "
        f"{q_cap}, l_tile {l_tile}, out {list(got.shape)} int16: "
        f"bit-identical True, max abs err {err8} (tolerance: bit for bit, "
        f"exact integer sums), masked slots {int((want == tag.I16_MASK).sum())}")
    del got, want
    luts4 = luts_flat.reshape(BATCH, SOAR_P, s_pad, -1)
    p_off = off[parts].int().contiguous()
    p_size = sizes[parts].int().contiguous()
    args10 = (luts4, codes_u, p_off, p_size)
    got = tal.tree_ah_leaf_scores(*args10, l_cap=l_cap)
    torch.cuda.synchronize()
    want = tal.tree_ah_leaf_scores_reference(*args10, l_cap=l_cap)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"per-pair leaf kernel differs from its twin "
                             f"at {bad} slots")
    err10 = float((got - want).abs().max())
    log(f"[21 kernel check] tree_ah_leaf (#10): pairs {BATCH} x {SOAR_P}, "
        f"S_pad {s_pad}, l_cap {l_cap}, out {list(got.shape)} float32: "
        f"bit-identical True, max abs err {err10} (tolerance: bit for bit, "
        f"float32 sums in ascending s on both sides), masked slots "
        f"{int((want >= tx.MASKED_DISTANCE / 2).sum())}")
    del got, want

    # -- 22. searches: three paths, each counted from zero ------------------------
    params = SearchParameters(num_leaves_to_search=SOAR_P,
                              pre_reordering_num_neighbors=SOAR_PRE_K)
    db_f32 = s._device_state()
    common = dict(p=SOAR_P, pre_k=SOAR_PRE_K, k=K, l_cap=l_cap,
                  use_residuals=True, multiplicity=mult)
    def searcher_path(qb):
        ids, dists = s.search_batched_tensors(qb, K, params)
        return dists, ids

    paths = {  # label: (search returning (dists, ids), launch counter, floor)
        "searcher (bf16 grouped, #1)": (searcher_path, tag, SOAR_FLOOR),
        "tree_ah_search_grouped int8_luts (#1b)": (
            lambda qb: tx.tree_ah_search_grouped(
                db_f32, cent, codes_p, off, sizes, perm, cb, qb, inf, inf,
                q_cap=q_cap, l_tile=l_tile, packed=True, int8_luts=True,
                **common), tag, SOAR_INT8_FLOOR),
        "tree_ah_search per pair (#10)": (
            lambda qb: tx.tree_ah_search(
                db_f32, cent, codes_u, off, sizes, perm, cb, qb, inf, inf,
                **common), tal, SOAR_FLOOR),
    }
    launches, recalls = {}, {}
    for label, (fn, mod, floor) in paths.items():
        mod.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [fn(queries[i * BATCH:(i + 1) * BATCH]) for i in range(BATCHES)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = mod.LAUNCHES
        dists = torch.cat([r[0] for r in res])
        idx = torch.cat([r[1] for r in res])
        err = check_results(idx, dists, queries, db_dev, BATCH * BATCHES)
        recalls[label] = recall_at_k(idx.cpu().numpy(), gt_np, K)
        log(f"[22 soar search/{label}] {BATCHES} x B={BATCH}, p={SOAR_P}, "
            f"pre_k={SOAR_PRE_K}, k={K}: recall@10 {recalls[label]:.4f} "
            f"(floor {floor}), kernel launches {launches[label]}, returned "
            f"vs recomputed distances max rel err {err:.3g}, host wall "
            f"{wall:.3f}s")
        if recalls[label] < floor:
            raise AssertionError(f"{label}: recall@10 {recalls[label]} < "
                                 f"{floor}")
        if launches[label] <= 0:
            raise AssertionError(f"{label}: its kernel was never launched")

    def side(srch, qs, gt, prm=params):
        ids, dists = srch.search_batched_tensors(qs, K, prm)
        check_results(ids, dists, qs, None, len(qs), exact_check=False)
        return ids, dists, recall_at_k(ids.cpu().numpy(), gt, K)

    g0 = gt_np[:BATCH]
    for dt in ("bfloat16", "int8", "int16"):
        v = s.with_rerank_store(rerank_dtype=dt)
        ids, dists, rec = side(v, q0, g0)
        exact = ((q0[:, None, :] - db_dev[ids]) ** 2).sum(-1)
        rel = float(((dists - exact).abs() / exact.clamp_min(1e-6)).max())
        store = v._device_state()
        t = store[0] if isinstance(store, tuple) else store
        log(f"[22 soar side/rerank {dt}] B={BATCH}: recall@10 {rec:.4f} (no "
            f"floor), returned vs exact float32 distances max rel err "
            f"{rel:.3g}, store {t.numel() * t.element_size()} bytes "
            f"{t.dtype}")
    p4 = SearchParameters(num_leaves_to_search=P,
                          pre_reordering_num_neighbors=PRE_K)
    csr4 = base.with_rerank_store(rerank_layout="csr")
    i_id, d_id = base.search_batched_tensors(q0, K, p4)
    i_csr, d_csr = csr4.search_batched_tensors(q0, K, p4)
    same = torch.equal(i_id, i_csr) and torch.equal(d_id, d_csr)
    log(f"[22 soar side/rerank csr] phase 4's index, B={BATCH}, p={P}: ids and "
        f"distances equal to the id layout's: {same}")
    if not same:
        raise AssertionError("csr and id layouts disagree at one assignment")
    even = np.arange(ds.size) % 2 == 0
    ids, _ = s.search_batched_tensors(q0, K, params, even)
    odd = int(((ids >= 0) & (ids % 2 == 1)).sum())
    filled = float((ids >= 0).float().mean())
    log(f"[22 soar side/allow even ids] B={BATCH}: odd ids returned {odd}, "
        f"slots filled {filled:.4f}")
    if odd:
        raise AssertionError(f"the allowlist let {odd} odd ids through")
    sub = DenseDataset(ds.numpy()[:SIDE_N])
    sub_db = db_dev[:SIDE_N]
    for measure in (DistanceMeasure.DOT_PRODUCT, DistanceMeasure.COSINE):
        t0 = time.perf_counter()
        ms = TreeXHybridSearcher(TreeXHybridConfig(
            num_partitions=200, partitions_to_search=10,
            distance_measure=measure, hash_config=cfg.hash_config),
            device=dev).build(sub)
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        if measure == DistanceMeasure.DOT_PRODUCT:
            score = q0 @ sub_db.T
        else:
            score = ((q0 / q0.norm(dim=1, keepdim=True))
                     @ (sub_db / sub_db.norm(dim=1, keepdim=True)).T)
        gt_m = torch.topk(score, K, dim=1).indices.cpu().numpy()
        _, _, rec = side(ms, q0, gt_m, SearchParameters(
            num_leaves_to_search=10, pre_reordering_num_neighbors=SOAR_PRE_K))
        log(f"[22 soar side/{measure.value}] {SIDE_N} rows, K "
            f"{ms.partitioner.num_partitions} (configured 200), "
            f"p=10, pre_k={SOAR_PRE_K}: build {b_s:.2f}s, recall@10 {rec:.4f}"
            f" against exact {measure.value} (no floor)")
        del ms

    # -- 23. timings -----------------------------------------------------------------
    k8, p8 = turns(lambda: tag.tree_ah_grouped_scores(*args8, **kw8),
                   lambda: tag.tree_ah_grouped_scores_reference(*args8, **kw8),
                   20, 2)
    n_sub = s.codebook.num_subspaces
    b8, by8, bytes8, ops8 = leaf_bound(
        parts, sizes, s=n_sub, c=cb.shape[1], entry_bytes=1,
        row_bytes=(n_sub + 1) // 2, out_bytes=2, l_cap=l_cap,
        index_bytes=n_groups * 8, peak=PEAK_I32_ADD)
    log(f"[23 kernel time] tree_ah_grouped int8 (#1b), L2 flushed: kernel "
        f"{k8:.4f} ms, plain twin {p8:.4f} ms, bound {b8:.4f} ms, bound by "
        f"{by8} ({bytes8} bytes, {ops8} int32 adds at {PEAK_I32_ADD:.4g}/s) "
        f"-> {b8 / k8:.3f} of the bound ({smi})")
    sms, mhz = card_clock(dev)
    log(grouped_floor_line("23 kernel floors", "int8 (#1b)", k8, gs,
                           q_cap=q_cap, s_pad=s_pad, c=cb.shape[1],
                           l_cap=l_cap, int8=True, packed=True, sms=sms,
                           mhz=mhz, smi=smi))
    # #1 alone at the SOAR shape: the searcher's bf16 tables, same groups
    lg1 = tx._group_luts(luts_flat, parts, off, sizes, s_pad=s_pad,
                         q_cap=q_cap, packed=True)[0]
    args1 = (lg1, codes_p, go, gs)
    same1 = torch.equal(tag.tree_ah_grouped_scores(*args1, **kw8),
                        tag.tree_ah_grouped_scores_reference(*args1, **kw8))
    if not same1:
        raise AssertionError("bf16 grouped kernel differs from its twin at "
                             "the SOAR shape")
    k1, p1 = turns(lambda: tag.tree_ah_grouped_scores(*args1, **kw8),
                   lambda: tag.tree_ah_grouped_scores_reference(*args1, **kw8),
                   20, 2)
    b1, by1, bytes1, _ = leaf_bound(
        parts, sizes, s=n_sub, c=cb.shape[1], entry_bytes=2,
        row_bytes=(n_sub + 1) // 2, out_bytes=2, l_cap=l_cap,
        index_bytes=n_groups * 8, peak=PEAK_F32_ADD)
    log(f"[23 kernel time] tree_ah_grouped bf16 (#1) at the SOAR shape, L2 "
        f"flushed: bit-identical {same1}, kernel {k1:.4f} ms, plain twin "
        f"{p1:.4f} ms, bound {b1:.4f} ms, bound by {by1} ({bytes1} bytes) -> "
        f"{b1 / k1:.3f} of the bound ({smi})")
    log(grouped_floor_line("23 kernel floors", "bf16 (#1) at the SOAR shape",
                           k1, gs, q_cap=q_cap, s_pad=s_pad, c=cb.shape[1],
                           l_cap=l_cap, int8=False, packed=True, sms=sms,
                           mhz=mhz, smi=smi))
    del lg1, args1
    k10, p10 = turns(lambda: tal.tree_ah_leaf_scores(*args10, l_cap=l_cap),
                     lambda: tal.tree_ah_leaf_scores_reference(*args10,
                                                               l_cap=l_cap),
                     20, 2)
    b10, by10, bytes10, ops10 = leaf_bound(
        parts, sizes, s=n_sub, c=cb.shape[1], entry_bytes=4, row_bytes=n_sub,
        out_bytes=4, l_cap=l_cap, index_bytes=BATCH * SOAR_P * 8,
        peak=PEAK_F32_ADD)
    log(f"[23 kernel time] tree_ah_leaf (#10), L2 flushed: kernel {k10:.4f} "
        f"ms, plain twin {p10:.4f} ms, bound {b10:.4f} ms, bound by {by10} "
        f"({bytes10} bytes, {ops10} float32 adds) -> {b10 / k10:.3f} of the "
        f"bound ({smi})")
    q10 = tal.pairs_per_block(s_pad, cb.shape[1])
    read10, lookups10, runs10, chunks10 = leaf_schedule(
        p_off, p_size, q=q10, s_pad=s_pad, l_cap=l_cap)
    per_pair = int(p_size.long().clamp(0, l_cap).sum()) * s_pad
    floor10 = lookups10 / (32 * sms * mhz * 1e6) * 1e3
    log(f"[23 schedule] tree_ah_leaf (#10): Q {q10} pairs a block, "
        f"{chunks10} chunks, {runs10} runs ({runs10 / chunks10:.3f} "
        f"partitions a chunk); code bytes read {read10} (one read per pair "
        f"would be {per_pair}; the bound counts the probed partitions once "
        f"at S=50); {lookups10} shared-memory table lookups -> lookup floor "
        f"{floor10:.4f} ms at 32 a clock on {sms} SMs at {mhz:.0f} MHz "
        f"(clocks.max.sm), {floor10 / k10:.3f} of the kernel's time; bytes "
        f"bound {b10:.4f} ms ({smi})")

    def staged(qb, leaf):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        pt = tx._select_partitions(cent, qb, p=SOAR_P)
        ev[1].record()
        lf = tx._residual_luts(qb, cent, pt, cb, s_pad=s_pad,
                               use_residuals=True)
        ev[2].record()
        flat = leaf(lf, pt)
        ev[3].record()
        tx._finalize(db_f32, qb, flat, pt, off, codes_p.shape[1], perm, inf,
                     inf, pre_k=SOAR_PRE_K, k=K, p=SOAR_P,
                     measure=cfg.distance_measure, multiplicity=mult)
        ev[4].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    leaves = {
        "bf16 grouped #1": lambda lf, pt: tx.leaf_scores_grouped(
            lf, pt, codes_p, off, sizes, p=SOAR_P, l_cap=l_cap, q_cap=q_cap,
            l_tile=l_tile, packed=True),
        "int8 grouped #1b": lambda lf, pt: tx.leaf_scores_grouped(
            lf, pt, codes_p, off, sizes, p=SOAR_P, l_cap=l_cap, q_cap=q_cap,
            l_tile=l_tile, packed=True, int8_luts=True),
        "per pair #10": lambda lf, pt: tx.leaf_scores_per_pair(
            lf, pt, codes_u, off, sizes, p=SOAR_P, l_cap=l_cap,
            c=cb.shape[1]),
    }
    for (label, leaf), (search, _, _) in zip(leaves.items(), paths.values()):
        staged(q0, leaf)
        rows = np.array([staged(queries[i * BATCH:(i + 1) * BATCH], leaf)
                         for i in range(BATCHES)])
        med, top = event_ms(search, queries, BATCH, BATCHES)
        log(f"[23 soar stages/{label}] per batch ms: " + ", ".join(
            f"{n} {v:.4f}" for n, v in zip(
                ("select", "lut", "leaf", "finalize"),
                rows.mean(0))) + f", sum {rows.sum(1).mean():.4f}; whole "
            f"path median {med:.4f} ms, max {top:.4f} ms -> "
            f"{BATCH / med * 1e3:.0f} queries/s ({smi})")
    by_layout = {}
    for label, srch in (("id", base), ("csr", csr4)):
        by_layout[label] = event_ms(
            lambda qb: srch.search_batched_tensors(qb, K, p4), queries,
            BATCH, BATCHES)
    log(f"[23 aside] phase 4's index, search_batched_tensors per batch: id "
        f"layout median {by_layout['id'][0]:.4f} ms (max "
        f"{by_layout['id'][1]:.4f}), csr layout median "
        f"{by_layout['csr'][0]:.4f} ms (max {by_layout['csr'][1]:.4f}) "
        f"({smi})")
    # aside: the served grouped path against the per-pair path at twice the
    # batch, where the pair density B*p/K passes the q_cap rule's 12
    kparts = s.partitioner.num_partitions
    big = 2 * BATCH
    by_density = {label: event_ms(paths[label][0], queries, big, BATCHES // 2)
                  for label in ("searcher (bf16 grouped, #1)",
                                "tree_ah_search per pair (#10)")}
    log(f"[23 aside] pair density B*p/K {BATCH * SOAR_P / kparts:.2f} at "
        f"B={BATCH} (q_cap {q_cap}; stages above), "
        f"{big * SOAR_P / kparts:.2f} at B={big} (q_cap "
        f"{s.effective_q_cap(big, SOAR_P)}), per batch of {big}: "
        + "; ".join(f"{label} median {m:.4f} ms (max {t:.4f})"
                    for label, (m, t) in by_density.items()) + f" ({smi})")
    return [
        {"name": "tree_ah_grouped_int8", "route": "cuda",
         "source": "scann_tpu_torch/csrc/tree_ah_grouped.cu",
         "replaces": "scann_tpu/ops/tree_ah_grouped.py:137",
         "launches": launches["tree_ah_search_grouped int8_luts (#1b)"],
         "max_abs_err": err8, "ms": k8, "plain_ms": p8, "bound_ms": b8,
         "bound_by": by8, "library_ms": None},
        {"name": "tree_ah_leaf", "route": "cuda",
         "source": "scann_tpu_torch/csrc/tree_ah_leaf.cu",
         "replaces": "scann_tpu/ops/tree_ah_pallas.py:36",
         "launches": launches["tree_ah_search per pair (#10)"],
         "max_abs_err": err10, "ms": k10, "plain_ms": p10, "bound_ms": b10,
         "bound_by": by10, "library_ms": None},
    ]


def facade_phases(ds, queries, db_dev, gt_np, smi):
    """Phases 24-28: the ``Scann`` facade, the partitioned searcher, every
    facade mode, ``save_index`` / ``load_index`` and the hierarchical and
    AVQ builds. Each mode must pick the JAX facade's search mode and inner
    searcher class (``scann_tpu/models/scann.py``'s routing) and return the
    ids of its inner searcher searched with the parameters the facade
    implies; each kernel on a mode's path must have launched there."""
    import os
    import tempfile

    import numpy as np
    import torch

    from scann_tpu_torch import (
        BruteForceConfig,
        DenseDataset,
        DistanceMeasure,
        HashConfig,
        PartitioningConfig,
        Scann,
        ScannBuilder,
        ScannConfig,
        SearchParameters,
        load_index,
        save_index,
    )
    from scann_tpu_torch.models import partitioned as pm
    from scann_tpu_torch.ops import fused_bf as fb
    from scann_tpu_torch.ops import scoring_kernels as sk
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.ops import topk
    from scann_tpu_torch.ops import tree_ah_grouped as tag
    from scann_tpu_torch.ops.distances import gathered_distances
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    t_phases = time.perf_counter()
    dev = queries.device

    def timed(build):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def serve(search, qs, batch):
        res = [search(qs[i:i + batch]) for i in range(0, len(qs), batch)]
        return torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res])

    def same_ids(got, want, label):
        if not torch.equal(got, want):
            bad = int((got != want).any(1).sum())
            raise AssertionError(f"{label}: the facade's ids differ from its "
                                 f"searcher's on {bad} queries")

    def routed(scann, mode, impl, label):
        if scann.search_mode.value != mode or \
                type(scann.impl).__name__ != impl:
            raise AssertionError(
                f"{label}: mode {scann.search_mode.value} / "
                f"{type(scann.impl).__name__}, the JAX facade picks {mode} / "
                f"{impl}")

    # -- 24. the README's quick start at the cell's shape ---------------------
    scann, build_s = timed(lambda: ScannBuilder().num_neighbors(K).tree(
        2000, P).hash(num_blocks=50, num_buckets=16).reorder(PRE_K).build(
            ds, device=dev))
    routed(scann, "TreeAH", "TreeXHybridSearcher", "[24]")
    impl = scann.impl
    log(f"[24 facade tree-AH] ScannBuilder().num_neighbors({K}).tree(2000, "
        f"{P}).hash(num_blocks=50, num_buckets=16).reorder({PRE_K}): "
        f"{scann.describe()}; built in {build_s:.2f}s: partitions "
        f"{impl.partitioner.num_partitions}, max size "
        f"{impl.partitioner.tokenization.max_partition_size} (cap "
        f"{impl.partitioner._cap_value(ds.size)}), pre_reorder_multiplier "
        f"{impl.config.pre_reorder_multiplier}")
    tag.LAUNCHES = 0
    f_idx, f_dists = serve(scann.search_batched_tensors, queries, BATCH)
    torch.cuda.synchronize()
    f_launches = tag.LAUNCHES
    tag.LAUNCHES = 0
    d_idx, _ = serve(lambda qb: impl.search_batched_tensors(qb, K, None),
                     queries, BATCH)
    torch.cuda.synchronize()
    d_launches = tag.LAUNCHES
    same_ids(f_idx, d_idx, "[24]")
    recall = recall_at_k(f_idx.cpu().numpy(), gt_np, K)
    err = check_results(f_idx, f_dists, queries, db_dev, BATCH * BATCHES)
    if recall < RECALL_FLOOR:
        raise AssertionError(f"[24] recall@10 {recall} < {RECALL_FLOOR}")
    if f_launches < BATCHES or f_launches != d_launches:
        raise AssertionError(f"[24] tree_ah_grouped launches {f_launches} "
                             f"through the facade, {d_launches} direct")
    med = {}
    for label, fn in (("direct", lambda qb: impl.search_batched_tensors(
            qb, K, None)), ("facade", scann.search_batched_tensors)) * 2:
        med.setdefault(label, []).append(
            event_ms(fn, queries, BATCH, BATCHES))
    log(f"[24 facade tree-AH] {BATCHES} x B={BATCH}: recall@10 {recall:.4f} "
        f"(floor {RECALL_FLOOR}), ids equal to impl.search_batched_tensors("
        f"q, {K}, None) (p={impl.config.partitions_to_search}, pre_k "
        f"{int(np.ceil(K * impl.config.pre_reorder_multiplier))}), "
        f"tree_ah_grouped (#1) launches {f_launches} (direct "
        f"{d_launches}), distances vs recomputed max rel err {err:.3g}; per "
        f"batch, direct / facade / direct / facade: " + ", ".join(
            f"{m:.4f} (max {t:.4f})" for pair in zip(med["direct"],
                                                     med["facade"])
            for m, t in pair) + f" ms ({smi})")
    del scann, impl

    # -- 25. the partitioned searcher at full width ---------------------------
    scann, build_s = timed(lambda: Scann.partitioned(ds, 2000, P, device=dev))
    routed(scann, "Partitioned", "PartitionedSearcher", "[25]")
    ps = scann.impl
    leaves = ps.partitioner.tokenization.padded_leaves()
    n_cand = P * leaves.shape[1]
    step = pm.gather_chunk(n_cand, D)
    log(f"[25 facade partitioned] Scann.partitioned(ds, 2000, {P}): built in "
        f"{build_s:.2f}s: partitions {ps.partitioner.num_partitions}, leaf "
        f"width L {leaves.shape[1]}, {n_cand} candidates a query, query "
        f"chunks of {step} (largest chunk's rows {step * n_cand * D * 4} "
        f"bytes)")
    p_idx, p_dists = serve(scann.search_batched_tensors, queries, BATCH)
    p_recall = recall_at_k(p_idx.cpu().numpy(), gt_np, K)
    p_err = check_results(p_idx, p_dists, queries, db_dev, BATCH * BATCHES)
    if p_recall < RECALL_FLOOR:
        raise AssertionError(f"[25] recall@10 {p_recall} < {RECALL_FLOOR}")
    p_med, p_top = event_ms(scann.search_batched_tensors, queries, BATCH,
                            BATCHES)
    db_p, norms_p = ps.device_state()
    centers = ps.partitioner.centers_device()

    def stages(qb):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        cand = pm.select_candidates(centers, leaves, qb,
                                    measure=ps.distance_measure, p=P)
        ev[1].record()
        t = [0.0, 0.0, 0.0]
        for lo in range(0, qb.shape[0], step):
            qc, cc = qb[lo:lo + step], cand[lo:lo + step]
            e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            e[0].record()
            safe = cc.clamp_min(0)
            rows = db_p[safe]
            e[1].record()
            dd = torch.where(cc >= 0, gathered_distances(
                ps.distance_measure, qc, rows, norms_p[safe]),
                float(pm.MASKED_DISTANCE))
            e[2].record()
            pm.select_results(dd, cc, K, multiplicity=1, eps=float("inf"))
            e[3].record()
            torch.cuda.synchronize()
            for i in range(3):
                t[i] += e[i].elapsed_time(e[i + 1])
        torch.cuda.synchronize()
        return [ev[0].elapsed_time(ev[1])] + t

    stages(queries[:BATCH])
    split = np.array([stages(queries[i * BATCH:(i + 1) * BATCH])
                      for i in range(BATCHES)]).mean(0)
    log(f"[25 facade partitioned] {BATCHES} x B={BATCH}, p={P}: recall@10 "
        f"{p_recall:.4f} (floor {RECALL_FLOOR}), returned vs recomputed "
        f"distances max rel err {p_err:.3g}; per batch median {p_med:.4f} "
        f"ms, max {p_top:.4f} ms -> {BATCH / p_med * 1e3:.0f} queries/s; "
        f"stages select {split[0]:.4f}, gather {split[1]:.4f}, score "
        f"{split[2]:.4f}, top-k {split[3]:.4f} ms ({smi})")
    del scann, ps, db_p, norms_p

    # -- 26. every facade mode, one batch each on SIDE_N rows -----------------
    sub = DenseDataset(ds.numpy()[:SIDE_N])
    q0 = queries[:BATCH]
    rng = np.random.default_rng(42)
    head = DenseDataset(rng.random((HEAD_N, HEAD_D), dtype=np.float32))
    hq = torch.from_numpy(rng.random((HEAD_B, HEAD_D),
                                     dtype=np.float32)).to(dev)
    sub_db = db_dev[:SIDE_N]
    gt_sub = exact_top_k(q0, sub_db)
    modes = {
        # label: (dataset, queries, build, JAX mode, JAX impl class,
        #         the parameters the facade implies, counter, kernel)
        "brute force": (sub, q0, lambda d: Scann(d, device=dev), "BruteForce",
                        "BruteForceSearcher", None, None, None),
        "block sweep": (sub, q0, lambda d: Scann(d, ScannConfig(
            ).with_brute_force(BruteForceConfig().with_block_sweep()),
            device=dev), "BruteForce", "BlockSweepSearcher", None,
                        lambda: sw.COMPACT_LAUNCHES["block_min_compact"],
                        "#5 block_min_compact"),
        "scalar-quantized 8 bits": (
            sub, q0, lambda d: Scann(d, ScannConfig().with_brute_force(
                BruteForceConfig().with_scalar_quantization(8)), device=dev),
            "BruteForce",
            "ScalarQuantizedBruteForceSearcher", None,
            lambda: sk.LAUNCHES["int8_dots"], "#9 int8_dots"),
        "hashed": (sub, q0, lambda d: ScannBuilder().hash(
            num_blocks=50, num_buckets=16).reorder(300).build(d, device=dev),
            "Hashed", "AsymmetricHasher",
            SearchParameters(pre_reordering_num_neighbors=300),
            lambda: sk.LAUNCHES["lut16_fused_sweep"],
            "#7 lut16_fused_sweep"),
        "brute force, headline": (head, hq, lambda d: Scann.brute_force(
            d, device=dev), "BruteForce", "BruteForceSearcher", None,
            lambda: fb.LAUNCHES, "#2 fused_bf"),
    }
    built = {}
    for label, (d, qb, build, mode, cls, params, count, kname) in \
            modes.items():
        scann, b_s = timed(lambda: build(d))
        routed(scann, mode, cls, f"[26 {label}]")
        fb.reset_launches()
        sk.reset_launches()
        sw.reset_launches()
        sel0 = topk.SELECT_KERNEL_ROWS
        torch.cuda.synchronize()
        idx, dists = scann.search_batched_tensors(qb)
        torch.cuda.synchronize()
        moved = count() if count is not None else None
        sel_rows = topk.SELECT_KERNEL_ROWS - sel0
        w_idx, _ = scann.impl.search_batched_tensors(qb, K, params)
        same_ids(idx, w_idx, f"[26 {label}]")
        if count is not None and not moved:
            raise AssertionError(f"[26 {label}] {kname} never launched")
        gt = gt_sub if d is sub else exact_top_k(qb, d.device_tensor(dev))
        rec = recall_at_k(idx.cpu().numpy(), gt, K)
        med, top = event_ms(scann.search_batched_tensors, qb, qb.shape[0], 1)
        built[label] = (scann, qb, params)
        log(f"[26 facade modes/{label}] {d.size} x {d.dimensionality}, "
            f"B={qb.shape[0]}: {scann.describe()['search_mode']} / "
            f"{type(scann.impl).__name__} (as the JAX facade), built in "
            f"{b_s:.2f}s, ids equal to the searcher's, "
            + (f"{kname} launches {moved}, " if count is not None else "")
            + f"selection kernel rows {sel_rows}, "
            + f"recall@10 against exact {rec:.4f}, batch median "
            f"{med:.4f} ms (max {top:.4f}) ({smi})")
    scann, b_s = timed(lambda: Scann.partitioned(sub, 200, P, device=dev))
    built["partitioned"] = (scann, q0, None)
    p_ids = scann.search_batched_tensors(q0)[0].cpu().numpy()
    log(f"[26 facade modes/partitioned] {SIDE_N} rows, 200 partitions: "
        f"built in {b_s:.2f}s, recall@10 against exact "
        f"{recall_at_k(p_ids, gt_sub, K):.4f}")

    # -- 27. save_index / load_index round trips on the card ------------------
    here = __file__.rsplit("/", 1)[0] if "/" in __file__ else "."
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        for label, (scann, qb, params) in built.items():
            path = f"{tmp}/{label.replace(' ', '_').replace(',', '')}.npz"
            _, save_s = timed(lambda: save_index(path, scann))
            back, load_s = timed(lambda: load_index(path, device=dev))
            got = back.search_batched_tensors(qb, K, params)
            want = scann.impl.search_batched_tensors(qb, K, params)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"[27 io/{label}] the loaded index's "
                                     f"results differ")
            log(f"[27 io/{label}] save_index -> load_index(device={dev}) "
                f"({type(back).__name__}): results bit-identical; file "
                f"{os.path.getsize(path)} bytes, save {save_s:.2f}s, load "
                f"{load_s:.2f}s")
    del built, scann

    # -- 28. hierarchical partitions and AVQ, recall recorded -----------------
    scann, b_s = timed(lambda: Scann(sub, ScannConfig().with_partitioning(
        PartitioningConfig(num_partitions=256, num_partitions_to_search=P,
                           num_levels=2)), device=dev))
    h_ids = serve(scann.search_batched_tensors, queries[:BATCH], BATCH)[0]
    tree = scann.impl.partitioner.tree
    log(f"[28 hierarchical] num_levels=2, 256 partitions over {SIDE_N} rows:"
        f" fan-out {tree.config.num_children}, {tree.num_leaves} leaves, "
        f"built in {b_s:.2f}s; p={P}: recall@10 against exact "
        f"{recall_at_k(h_ids.cpu().numpy(), gt_sub, K):.4f} (no floor)")
    del scann
    gt_mips = torch.topk(q0 @ sub_db.T, K, dim=1).indices.cpu().numpy()
    out = {}
    for label, thr in (("plain PQ", None), ("AVQ T=0.2", 0.2)):
        cfg = ScannConfig(distance_measure=DistanceMeasure.DOT_PRODUCT,
                          num_neighbors=K).with_partitioning(
            PartitioningConfig(num_partitions=200,
                               num_partitions_to_search=P)).with_hashing(
            HashConfig(num_blocks=50, num_buckets=16,
                       anisotropic_threshold=thr)).with_reordering()
        scann, b_s = timed(lambda: Scann(sub, cfg, device=dev))
        ids = scann.search_batched_tensors(q0)[0].cpu().numpy()
        # pre_k = k: the codes' own ranking picks the k that are re-ranked
        codes_ids = scann.search_batched_tensors(q0, K, SearchParameters(
            pre_reordering_num_neighbors=K))[0].cpu().numpy()
        out[label] = (recall_at_k(ids, gt_mips, K),
                      recall_at_k(codes_ids, gt_mips, K), b_s,
                      scann.impl.codebook.eta)
        del scann
    log("[28 AVQ] DOT_PRODUCT tree-x-AH over " + f"{SIDE_N} rows (200 "
        f"partitions, p={P}, S=50, C=16): " + "; ".join(
            f"{label}: recall@10 against exact MIPS {r:.4f} with the "
            f"re-rank of 100, {rc:.4f} with pre_k = k, built in {b:.2f}s, "
            f"eta {e}" for label, (r, rc, b, e) in out.items())
        + " (no floor)")
    log(f"[24-28] wall {time.perf_counter() - t_phases:.2f}s")


def exact_top_k(queries, rows, allowed=None, chunk=256):
    """Exact squared-L2 top-K ids ([B, K] numpy) of ``queries`` over
    ``rows`` on the card, rows where ``allowed`` is False left out."""
    import torch

    x_sq = (rows * rows).sum(1)
    if allowed is not None:
        x_sq = torch.where(allowed, x_sq, float("inf"))
    out = []
    for i in range(0, len(queries), chunk):
        qb = queries[i:i + chunk]
        dd = (qb * qb).sum(1)[:, None] + x_sq[None, :] - 2.0 * (qb @ rows.T)
        out.append(torch.topk(dd, K, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def host_batches(search, q_np, batch, batches):
    """(outputs, seconds of each call): host clock around each numpy call,
    started after a synchronize."""
    import torch

    outs, secs = [], []
    for i in range(batches):
        qb = q_np[i * batch:(i + 1) * batch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(search(qb))
        secs.append(time.perf_counter() - t0)
    return outs, secs


def crowd_reference(cand_i, attributes, limit, k):
    """The plain greedy crowding pass over [B, M] candidates in order: a
    candidate is kept while fewer than ``limit`` earlier ones share its
    attribute. The first k kept ids a query (-1 padded), and how many of
    its candidates the limit would keep."""
    import numpy as np

    valid = cand_i >= 0
    attr = np.where(valid, attributes[np.clip(cand_i, 0, None)], -1)
    m = cand_i.shape[1]
    earlier = np.tril(np.ones((m, m), dtype=bool), -1)
    before = ((attr[:, :, None] == attr[:, None, :]) & valid[:, None, :]
              & earlier).sum(-1)
    keep = valid & (before < limit)
    cols = np.argsort(~keep, axis=1, kind="stable")[:, :k]
    ids = np.where(np.take_along_axis(keep, cols, axis=1),
                   np.take_along_axis(cand_i, cols, axis=1), -1)
    return ids, keep.sum(1)


def ms_line(secs):
    import numpy as np

    return (f"median {np.median(secs) * 1e3:.4f} ms, max "
            f"{np.max(secs) * 1e3:.4f} ms")


def dynamic_phase(ds, queries, q_np, gt_np, smi, cfg, centers):
    """Phase 29: ``DynamicSearcher`` over phase 4's tree-x-AH configuration
    at full width, on the C++ host core: adds, updates and removes, then
    the batches served against exact ground truth over the live rows with
    their current values, before and after ``force_rebuild()``; #1 must
    launch in every batch."""
    import numpy as np
    import torch

    from scann_tpu_torch import DistanceMeasure, SearchParameters
    from scann_tpu_torch import TreeXHybridSearcher
    from scann_tpu_torch.mutator import (
        DynamicSearcher,
        MutableDataset,
        dynamic_merge,
    )
    from scann_tpu_torch.ops import tree_ah_grouped as tag
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    t_phase = time.perf_counter()
    dev = queries.device
    t0 = time.perf_counter()
    probe = MutableDataset.from_dataset(ds)
    from_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe.snapshot()
    snap_s = time.perf_counter() - t0
    del probe
    builds = []

    def factory(d):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = TreeXHybridSearcher(cfg, device=dev).build(d)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return s

    t0 = time.perf_counter()
    dyn = DynamicSearcher(ds, factory, rebuild_threshold=DYN_REBUILD,
                          distance_measure=DistanceMeasure.SQUARED_L2,
                          device=dev)
    ctor_s = time.perf_counter() - t0
    if not dyn._mutable.native:
        raise AssertionError("[29] the mutable rows are not in the C++ core")
    log(f"[29 dynamic tree-AH] DynamicSearcher over phase 4's tree-x-AH "
        f"({N} x {D}), C++ host core {dyn._mutable.native}: from_dataset "
        f"{from_s:.3f}s, snapshot {snap_s:.3f}s (each alone), build "
        f"{builds[0]:.2f}s, constructor {ctor_s:.2f}s in all ({smi})")

    # -- mutations: adds from the clusters, updates to fresh points, removes
    # that include the exact top-1 of the first 256 queries
    rng = np.random.default_rng(SEED + 29)

    def fresh(n):
        return (centers[rng.integers(0, CLUSTERS, n)] + rng.standard_normal(
            (n, D), dtype=np.float32)).astype(np.float32)

    adds = fresh(DYN_ADDS)
    top1 = np.unique(gt_np[:256, 0])
    if len(top1) > DYN_REMOVES:
        raise AssertionError("[29] more top-1 rows than removes")
    others = rng.permutation(N)
    others = others[~np.isin(others, top1)]
    n_more = DYN_REMOVES - len(top1)
    removes = np.concatenate([top1, others[:n_more]])
    updates = others[n_more:n_more + DYN_UPDATES]
    new_rows = fresh(DYN_UPDATES)
    t0 = time.perf_counter()
    added = [dyn.add(v) for v in adds]
    for i, v in zip(updates, new_rows):
        dyn.update(int(i), v)
    for i in removes:
        dyn.remove(int(i))
    mut_s = time.perf_counter() - t0
    if added != list(range(N, N + DYN_ADDS)):
        raise AssertionError("[29] added rows got unexpected ids")
    data, deleted = dyn._mutable.snapshot()
    cur = torch.from_numpy(data).to(dev)
    live = torch.from_numpy(deleted == 0).to(dev)
    gt_live = exact_top_k(queries, cur, live)
    log(f"[29 dynamic tree-AH] {DYN_ADDS} adds, {DYN_UPDATES} updates, "
        f"{DYN_REMOVES} removes ({len(top1)} of them the exact top-1 of the "
        f"first 256 queries) in {mut_s:.3f}s; live rows {dyn.size}, rows "
        f"{len(data)}, no rebuild (threshold {DYN_REBUILD}) ({smi})")

    params = SearchParameters(num_leaves_to_search=P,
                              pre_reordering_num_neighbors=PRE_K)
    fetches = []

    def count_fetches():
        main = dyn._main
        plain = main.search_batched_arrays

        def counted(*args, **kw):
            fetches.append(args[1])
            return plain(*args, **kw)

        main.search_batched_arrays = counted
        return plain

    def serve_and_check(label):
        fetches.clear()
        tag.LAUNCHES = 0
        outs, secs = host_batches(
            lambda qb: dyn.search_batched_arrays(qb, K, params), q_np,
            BATCH, BATCHES)
        launches = tag.LAUNCHES
        idx = np.concatenate([o[0] for o in outs])
        dists = np.concatenate([o[1] for o in outs])
        recall = recall_at_k(idx, gt_live, K)
        if recall < RECALL_FLOOR:
            raise AssertionError(f"[29 {label}] recall@10 {recall} < "
                                 f"{RECALL_FLOOR}")
        if np.isin(idx, removes).any():
            raise AssertionError(f"[29 {label}] a removed row was returned")
        err = check_results(torch.from_numpy(idx).to(dev),
                            torch.from_numpy(dists).to(dev), queries, cur,
                            BATCH * BATCHES)
        if launches < BATCHES:
            raise AssertionError(f"[29 {label}] tree_ah_grouped launched "
                                 f"{launches} times in {BATCHES} batches")
        return secs, recall, err, launches, len(fetches) - BATCHES

    plain_main = count_fetches()
    secs, recall, err, launches, refetch = serve_and_check("served")
    own_i, own_d = dyn.search_batched_arrays(adds[:DYN_SELF], K, params)
    first = own_i[:, 0]
    not_self = np.nonzero(first != np.arange(N, N + DYN_SELF))[0]
    if (own_d[:, 0] > 1e-3).any() or any(
            not np.array_equal(data[first[j]], adds[j]) for j in not_self):
        raise AssertionError("[29] an added row, queried by its own vector, "
                             "did not come back first")
    log(f"[29 dynamic tree-AH] {BATCHES} x B={BATCH}, p={P}, pre_k={PRE_K}, "
        f"k={K}: recall@10 {recall:.4f} against exact over the live rows "
        f"(floor {RECALL_FLOOR}), no removed id, returned vs current rows' "
        f"distances max rel err {err:.3g}, tree_ah_grouped (#1) launches "
        f"{launches}, re-fetches {refetch}; {DYN_SELF} added rows queried by "
        f"their own vectors: first at distance <= {float(own_d[:, 0].max()):.3g}"
        f" ({len(not_self)} ties with an equal row); per batch {ms_line(secs)}"
        f" ({smi})")

    # -- the stages, and the main index searched directly at the same fetch
    fetch = min(max(2 * K, K + 8), dyn._snapshot_rows)
    main_secs = host_batches(
        lambda qb: plain_main(qb, fetch, params), q_np, BATCH, BATCHES)[1]
    slab_secs = []
    for _ in range(3):
        dyn._extra_cache = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slab = dyn._extra_slab(D)
        torch.cuda.synchronize()
        slab_secs.append(time.perf_counter() - t0)
    snap_db = dyn._snapshot_ds.device(dev)[0]
    merge_ms = []
    for i in range(BATCHES):
        qb = q_np[i * BATCH:(i + 1) * BATCH]
        ci, _ = plain_main(qb, fetch, params)
        ci = np.asarray(ci, np.int64)
        ok = (ci >= 0) & ~dyn._cand_invalid[np.clip(ci, 0, None)]
        cand = torch.from_numpy(np.where(ok, ci, -1)).to(dev)
        qd = torch.from_numpy(qb).to(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dynamic_merge(qd, snap_db, cand, *slab[:3], float("inf"), k=K,
                      measure=DistanceMeasure.SQUARED_L2)
        b.record()
        torch.cuda.synchronize()
        merge_ms.append(a.elapsed_time(b))
    log(f"[29 dynamic tree-AH] main index searched directly at fetch "
        f"{fetch}: {ms_line(main_secs)}; stages: main fetch (the same), "
        f"delta slab of {len(slab[3])} rows {ms_line(slab_secs)} (built "
        f"once a mutation epoch), merge (CUDA events) median "
        f"{np.median(merge_ms):.4f} ms, max {np.max(merge_ms):.4f} ms "
        f"({smi})")

    # -- force_rebuild folds the delta in
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dyn.force_rebuild()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    count_fetches()
    secs, recall, err, launches, refetch = serve_and_check("rebuilt")
    log(f"[29 dynamic tree-AH] force_rebuild() {rebuild_s:.2f}s (build "
        f"{builds[-1]:.2f}s over {dyn._snapshot_rows} rows): recall@10 "
        f"{recall:.4f} (floor {RECALL_FLOOR}), no removed id, distances max "
        f"rel err {err:.3g}, #1 launches {launches}, re-fetches {refetch}; "
        f"per batch {ms_line(secs)} ({smi})")
    log(f"[29] wall {time.perf_counter() - t_phase:.2f}s ({smi})")


def restrict_phases(ds, queries, q_np, db_dev, smi, searcher, labels):
    """Phases 30-32: filtered search (tree-x-AH with the mask on the card at
    full width; the block sweep's allowlist penalty and the hasher's host
    over-fetch on the first SIDE_N rows), crowded search on tree-x-AH, and
    docids through the facade."""
    import numpy as np
    import torch

    from scann_tpu_torch import (
        BruteForceConfig,
        DenseDataset,
        Scann,
        ScannBuilder,
        ScannConfig,
        SearchParameters,
    )
    from scann_tpu_torch.ops import scoring_kernels as sk
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.ops import tree_ah_grouped as tag
    from scann_tpu_torch.restricts import (
        AllowlistFilter,
        AndFilter,
        CrowdingConfig,
        CrowdingConstraint,
        NotFilter,
        RangeFilter,
        RestrictAllowlist,
    )
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    t_phases = time.perf_counter()
    dev = queries.device
    params = SearchParameters(num_leaves_to_search=P,
                              pre_reordering_num_neighbors=PRE_K)

    def ids_of(results, label):
        if any(len(r) != K for r in results):
            raise AssertionError(f"{label}: a query got fewer than {K} "
                                 f"results")
        return np.array([r.indices() for r in results])

    # -- 30. restricts --------------------------------------------------------
    filt = AndFilter([AllowlistFilter(RestrictAllowlist.from_indices(
        range(0, N, 2), N)), NotFilter(RangeFilter(0, 1000))])
    allowed = torch.from_numpy(filt.to_mask(N)).to(dev)
    gt_f = exact_top_k(queries, db_dev, allowed)
    tag.LAUNCHES = 0
    outs, f_secs = host_batches(
        lambda qb: searcher.search_batched_with_filter(qb, K, filt, params),
        q_np, BATCH, BATCHES)
    launches = tag.LAUNCHES
    idx = ids_of([r for o in outs for r in o], "[30 tree-AH]")
    recall = recall_at_k(idx, gt_f, K)
    if recall < RECALL_FLOOR:
        raise AssertionError(f"[30 tree-AH] recall@10 {recall} < "
                             f"{RECALL_FLOOR}")
    if not all(filt.is_allowed(int(i)) for i in idx.ravel()):
        raise AssertionError("[30 tree-AH] a returned id fails the filter")
    if launches < BATCHES:
        raise AssertionError(f"[30 tree-AH] #1 launched {launches} times")
    u_secs = host_batches(lambda qb: searcher.search_batched(qb, K, params),
                          q_np, BATCH, BATCHES)[1]
    log(f"[30 restricts/tree-AH] AndFilter([even ids, not [0, 1000)]) "
        f"({int(allowed.sum())} of {N} rows allowed), the mask on the card: "
        f"{BATCHES} x B={BATCH}: recall@10 {recall:.4f} against the filtered "
        f"exact top-10 (floor {RECALL_FLOOR}), every id allowed, #1 launches "
        f"{launches}; search_batched_with_filter {ms_line(f_secs)}, "
        f"unfiltered search_batched {ms_line(u_secs)} ({smi})")

    sub = DenseDataset(ds.numpy()[:SIDE_N])
    q0_np = q_np[:BATCH]
    gt_sub = exact_top_k(queries[:BATCH], db_dev[:SIDE_N],
                         torch.from_numpy(filt.to_mask(SIDE_N)).to(dev))
    block = Scann(sub, ScannConfig().with_brute_force(
        BruteForceConfig().with_block_sweep()), device=dev).impl
    hashed = ScannBuilder().hash(num_blocks=50, num_buckets=16).reorder(
        300).build(sub, device=dev).impl
    cases = (
        ("block sweep", block, None, SWEEP_RECALL_FLOOR, True,
         lambda: sw.COMPACT_LAUNCHES["block_min_compact"],
         "#5 block_min_compact with the allowlist penalty"),
        ("hasher", hashed, SearchParameters(pre_reordering_num_neighbors=300),
         RECALL_FLOOR, False, lambda: sk.LAUNCHES["lut16_fused_sweep"],
         "#7 lut16_fused_sweep"),
    )
    for label, s, p, floor, takes_mask, count, kname in cases:
        if s.supports_allow_mask() != takes_mask:
            raise AssertionError(f"[30 {label}] allow-mask support "
                                 f"{s.supports_allow_mask()}")
        sw.reset_launches()
        sk.reset_launches()
        res = s.search_batched_with_filter(q0_np, K, filt, p)
        torch.cuda.synchronize()
        moved = count()
        ids = ids_of(res, f"[30 {label}]")
        rec = recall_at_k(ids, gt_sub, K)
        if rec < floor:
            raise AssertionError(f"[30 {label}] recall@10 {rec} < {floor}")
        if not all(filt.is_allowed(int(i)) for i in ids.ravel()):
            raise AssertionError(f"[30 {label}] a returned id fails the "
                                 f"filter")
        if not moved:
            raise AssertionError(f"[30 {label}] {kname} never launched")
        fs = host_batches(lambda qb: s.search_batched_with_filter(
            qb, K, filt, p), np.tile(q0_np, (5, 1)), BATCH, 5)[1]
        us = host_batches(lambda qb: s.search_batched(qb, K, p),
                          np.tile(q0_np, (5, 1)), BATCH, 5)[1]
        log(f"[30 restricts/{label}] {SIDE_N} rows (phase 26's facade "
            f"configuration), B={BATCH}, "
            + ("the mask on the card" if takes_mask else
               f"host over-fetch of {min(max(4 * K, K + 32), SIDE_N)}")
            + f": recall@10 {rec:.4f} against the filtered exact top-10 "
            f"(floor {floor}), every id allowed, {kname} launches {moved}; "
            f"filtered {ms_line(fs)}, unfiltered {ms_line(us)} ({smi})")
    del block, hashed

    # -- 31. crowding -----------------------------------------------------------
    # two attributes: the generating cluster (a query's candidates mostly
    # share one), and a hash of the row id into CROWD_GROUPS groups (they
    # mix within every query's candidates)
    row_ids = np.arange(N, dtype=np.uint64)
    attributes = (("the generating cluster", labels),
                  (f"a hash of the row id into {CROWD_GROUPS} groups",
                   ((row_ids * np.uint64(2654435761) % np.uint64(2 ** 32)
                     * np.uint64(CROWD_GROUPS)) >> np.uint64(32)
                    ).astype(np.int64)))
    crowds = [CrowdingConstraint(attr, CrowdingConfig(
        per_crowd_limit=CROWD_LIMIT, enabled=True)) for _, attr in attributes]
    c_secs = [[] for _ in attributes]
    crowded, kept, full = ([0] * len(attributes) for _ in range(3))
    for i in range(BATCHES):
        qb = q_np[i * BATCH:(i + 1) * BATCH]
        cand_i, cand_d = searcher.search_batched_arrays(qb, 4 * K, params)
        plain = cand_i[:, :K]
        for a, ((name, attr), crowd) in enumerate(zip(attributes, crowds)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = searcher.search_with_crowding(qb, K, crowd, params)
            c_secs[a].append(time.perf_counter() - t0)
            want_i, _ = crowd.apply_batch(cand_i.astype(np.int64), cand_d, K)
            got = [r.indices() for r in res]
            if got != [[int(j) for j in row if j >= 0] for row in want_i]:
                raise AssertionError(f"[31 {name}] crowded results differ "
                                     f"from apply_batch over the same "
                                     f"candidates")
            ref_i, can_keep = crowd_reference(cand_i, attr, CROWD_LIMIT, K)
            if got != [[int(j) for j in row if j >= 0] for row in ref_i]:
                raise AssertionError(f"[31 {name}] crowded results differ "
                                     f"from the plain greedy pass")
            counts = np.array([len(r) for r in got])
            if not np.array_equal(counts, np.minimum(K, can_keep)):
                raise AssertionError(f"[31 {name}] a query got fewer "
                                     f"results than its candidates' groups "
                                     f"allow")
            for r in got:
                if r and np.bincount(attr[r]).max() > CROWD_LIMIT:
                    raise AssertionError(f"[31 {name}] a query has more "
                                         f"than {CROWD_LIMIT} ids of one "
                                         f"attribute")
            kept[a] += int(counts.sum())
            full[a] += int((counts == K).sum())
            crowded[a] += int(sum(r != plain[j].tolist()
                                  for j, r in enumerate(got)))
    if not crowded[1] or full[1] != BATCH * BATCHES:
        raise AssertionError(f"[31] the mixed attribute changed "
                             f"{crowded[1]} queries, {full[1]} got {K} "
                             f"results")
    for a, (name, _) in enumerate(attributes):
        log(f"[31 crowding] tree-x-AH, per-attribute limit {CROWD_LIMIT}, "
            f"attribute {name}, {BATCHES} x B={BATCH}, over-fetch {4 * K}: "
            f"no query over the limit, results equal apply_batch and the "
            f"plain greedy pass over the same candidates, {crowded[a]} of "
            f"{BATCH * BATCHES} queries changed by crowding, {full[a]} with "
            f"{K} results, {kept[a] / (BATCH * BATCHES):.2f} results a "
            f"query; search_with_crowding {ms_line(c_secs[a])} ({smi})")

    # -- 32. docids through the facade -------------------------------------------
    docs = DenseDataset(ds.numpy()[:SIDE_N],
                        docids=[f"doc{i}" for i in range(SIDE_N)])
    for label, build in (
            ("Scann.brute_force", lambda: Scann.brute_force(docs,
                                                             device=dev)),
            ("quick-start tree-x-AH", lambda: ScannBuilder().num_neighbors(
                K).tree(2000, P).hash(num_blocks=50, num_buckets=16).reorder(
                    PRE_K).build(docs, device=dev))):
        res = build().search_batched(q0_np, K)
        ids_of(res, f"[32 {label}]")
        if not all(nb.docid == f"doc{nb.index}" for r in res for nb in r):
            raise AssertionError(f"[32 {label}] a docid differs from "
                                 f"doc<index>")
        log(f"[32 docids/{label}] {SIDE_N} rows with docids doc0..doc"
            f"{SIDE_N - 1}, B={BATCH}: every NNResult.docid equals "
            f"f\"doc{{index}}\" ({BATCH * K} results)")
    log(f"[30-32] wall {time.perf_counter() - t_phases:.2f}s ({smi})")


def sparse_sets(rng, sizes):
    """(indptr [n + 1], items) of ``len(sizes)`` sets of distinct items,
    sorted within a set: ``sizes[i]`` draws with repeats from the Zipf
    popularity (weight 1 / rank), and sets that repeats leave below SP_MIN
    items topped up from the same popularity."""
    import numpy as np

    def unique(key):
        # sort-based: numpy 2.3's np.unique hashes integers, ten times
        # slower at these sizes
        key = np.sort(key)
        return key[np.concatenate([[True], key[1:] != key[:-1]])]

    pop = 1.0 / np.arange(1, SP_D + 1)
    pop /= pop.sum()
    n = len(sizes)
    key = unique(np.repeat(np.arange(n), sizes) * SP_D
                 + rng.choice(SP_D, int(sizes.sum()), p=pop))
    while True:
        count = np.bincount(key // SP_D, minlength=n)
        short = np.flatnonzero(count < SP_MIN)
        if not len(short):
            break
        extra = np.repeat(short, SP_MIN - count[short])
        key = unique(np.concatenate(
            [key, extra * SP_D + rng.choice(SP_D, len(extra), p=pop)]))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key // SP_D, minlength=n), out=indptr[1:])
    return indptr, key % SP_D


def host_top_k(d, k):
    """(ids [B, k], values) of the k smallest of each row of ``d`` on the
    host, equal values lower index first."""
    import numpy as np

    kth = np.partition(d, k - 1, axis=1)[:, k - 1]
    ids = np.empty((len(d), k), np.int64)
    for r in range(len(d)):
        cand = np.flatnonzero(d[r] <= kth[r])
        ids[r] = cand[np.argsort(d[r, cand], kind="stable")[:k]]
    return ids, np.take_along_axis(d, ids, axis=1)


def host_set_distances(inter, a, b, name):
    """The JAX package's float32 set-measure formulas on the host: [B, N]
    from intersections, set sizes a [1, N] and query sizes b [B, 1]."""
    import numpy as np

    one, zero = np.float32(1), np.float32(0)
    if name == "JACCARD":
        union = a + b - inter
        return np.where(union > 0, one - inter / np.maximum(union, one), zero)
    if name == "DICE":
        total = a + b
        return np.where(total > 0, one - np.float32(2) * inter
                        / np.maximum(total, one), zero)
    if name == "NON_ZERO_INTERSECT":
        return -inter
    m = np.minimum(a, b)
    return np.where(m > 0, one - inter / np.maximum(m, one), one)


def check_weighted(label, ids, dists, d64, ref_ids, ref_d):
    """Weighted-Jaccard results against the float64 reference: distances
    within SP_TOL of the float64 distance of the same id, and the ids equal
    as a set where the reference's 10th and 11th distances differ by more
    than SP_TOL. Returns (max error, rows checked for ids)."""
    import numpy as np

    if ids.shape != (SP_B, K) or (ids < 0).any():
        raise AssertionError(f"{label}: bad ids, shape {ids.shape}")
    err = float(np.abs(dists - np.take_along_axis(d64, ids, 1)).max())
    if err > SP_TOL:
        raise AssertionError(f"{label}: distances off float64 by {err}")
    clear = ref_d[:, K] - ref_d[:, K - 1] > SP_TOL
    for r in np.flatnonzero(clear):
        if set(ids[r]) != set(ref_ids[r, :K]):
            raise AssertionError(f"{label}: query {r} ids differ from the "
                                 f"float64 reference")
    return err, int(clear.sum())


def sparse_phase(dev, smi):
    """Phase 33: sparse search at kosarak width, every measure against a
    host reference written apart from the port (``scipy.sparse`` counts
    with the JAX float32 formulas; float64 sums of minima)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from scann_tpu_torch import (
        DistanceMeasure,
        SparseBruteForceSearcher,
        SparseDataset,
    )
    from scann_tpu_torch.ops import topk

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)

    def sizes(n):
        return np.minimum(
            SP_MIN + (rng.pareto(SP_TAIL, n) * SP_MIN).astype(np.int64),
            SP_MAX)

    indptr, items = sparse_sets(rng, sizes(SP_N))
    values = rng.standard_normal(len(items), dtype=np.float32)
    q_ptr, q_items = sparse_sets(rng, sizes(SP_B))
    q_vals = rng.standard_normal(len(q_items), dtype=np.float32)
    q_dense = np.zeros((SP_B, SP_D), np.float32)
    q_dense[np.repeat(np.arange(SP_B), np.diff(q_ptr)), q_items] = q_vals
    sets_s = time.perf_counter() - t_phase
    ds = SparseDataset(SP_D)
    for i in range(SP_N):
        ds.append(items[indptr[i]:indptr[i + 1]],
                  values[indptr[i]:indptr[i + 1]])
    lens, q_lens = np.diff(indptr), np.diff(q_ptr)
    log(f"[33 sparse data] {SP_N} sets over {SP_D} items (kosarak-jaccard's "
        f"shape; Zipf popularity, sizes {SP_MIN} + Pareto({SP_TAIL}) x "
        f"{SP_MIN} drawn with repeats, cap {SP_MAX}, seed {SEED}), signed "
        f"N(0, 1) values: set size mean {lens.mean():.2f}, largest "
        f"{lens.max()}, smallest {lens.min()}, {len(items)} nonzeros; "
        f"{SP_B} queries, size mean {q_lens.mean():.2f}, largest "
        f"{q_lens.max()}; sets drawn in {sets_s:.2f}s, the SparseDataset "
        f"appended in {time.perf_counter() - t_phase - sets_s:.2f}s")

    # host references, written apart from the port
    t0 = time.perf_counter()
    inc = sp.csr_matrix((np.ones(len(items), np.float32), items, indptr),
                        shape=(SP_N, SP_D))
    inter = (sp.csr_matrix((q_dense != 0).astype(np.float32))
             @ inc.T).toarray().astype(np.float32)
    a = lens.astype(np.float32)[None, :]
    b = (q_dense != 0).sum(1).astype(np.float32)[:, None]
    absx = np.abs(values).astype(np.float64)
    by_item = sp.csr_matrix((absx, items, indptr),
                            shape=(SP_N, SP_D)).tocsc()
    min_sum = np.empty((SP_B, SP_N))
    for j in range(SP_B):
        part = by_item[:, q_items[q_ptr[j]:q_ptr[j + 1]]]
        part.data = np.minimum(part.data, np.repeat(
            np.abs(q_vals[q_ptr[j]:q_ptr[j + 1]]).astype(np.float64),
            np.diff(part.indptr)))
        min_sum[j] = np.asarray(part.sum(axis=1)).ravel()
    max_sum = (np.add.reduceat(np.abs(q_vals).astype(np.float64),
                               q_ptr[:-1])[:, None]
               + np.add.reduceat(absx, indptr[:-1])[None, :] - min_sum)
    d64 = np.where(max_sum > 0, 1.0 - min_sum / max_sum, 0.0)
    cand = np.argpartition(d64, K, axis=1)[:, :K + 1]
    w_ids = np.take_along_axis(cand, np.argsort(
        np.take_along_axis(d64, cand, 1), axis=1, kind="stable"), 1)
    w_d = np.take_along_axis(d64, w_ids, 1)
    log(f"[33 sparse reference] scipy.sparse intersections and float64 "
        f"sums of minima for {SP_B} queries on the host: "
        f"{time.perf_counter() - t0:.2f}s")

    qd = torch.from_numpy(q_dense).to(dev)
    for name in SP_MEASURES:
        measure = DistanceMeasure[name]
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        s = SparseBruteForceSearcher(ds, measure, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated(dev) - mem0
        ids, dists = s.search_batched_arrays(q_dense, K)
        if name == "WEIGHTED_JACCARD":
            err, rows = check_weighted(f"[33 {name}]", ids, dists, d64,
                                       w_ids, w_d)
            t0 = time.perf_counter()
            res = [s.search_sparse(q_items[q_ptr[j]:q_ptr[j + 1]], K,
                                   values=q_vals[q_ptr[j]:q_ptr[j + 1]])
                   for j in range(SP_B)]
            one_s = (time.perf_counter() - t0) / SP_B
            err1, _ = check_weighted(
                f"[33 {name} search_sparse]",
                np.array([r.indices() for r in res]),
                np.array([r.distances() for r in res], np.float32), d64,
                w_ids, w_d)
            verdict = (f"distances within {max(err, err1):.3g} of float64 "
                       f"(tolerance {SP_TOL}) through search_batched_arrays "
                       f"and search_sparse, ids equal on the {rows} queries "
                       f"whose 10th and 11th float64 distances differ by "
                       f"more; search_sparse {one_s * 1e3:.4f} ms a query "
                       f"(host clock)")
        else:
            ref_ids, ref_d = host_top_k(
                host_set_distances(inter, a, b, name), K)
            if not np.array_equal(ids, ref_ids):
                raise AssertionError(f"[33 {name}] ids differ from the host "
                                     f"reference")
            if not np.array_equal(dists, ref_d):
                raise AssertionError(f"[33 {name}] distances are not "
                                     f"bit-equal to the host reference")
            verdict = ("ids equal to the host reference (ties lower index "
                       "first) and distances bit-equal")
        key0 = topk.KEY_PATH_ROWS
        med, top = event_ms(lambda qb: s.search_batched_tensors(qb, K), qd,
                            SP_B, 1, reps=SP_REPS)
        key_rows = (topk.KEY_PATH_ROWS - key0) / SP_REPS
        # one query chunk's stages: the product and formula, the selection,
        # and torch.topk on the same distances (no tie rule)
        qc = qd[:s.query_chunk()]
        qc = qc.abs() if name == "WEIGHTED_JACCARD" else (qc != 0).float()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        dd = s._distances(qc)
        stage_ms = []
        for _ in range(SP_REPS):
            ev[0].record()
            dd = s._distances(qc)
            ev[1].record()
            topk.top_k_smallest(dd, K)
            ev[2].record()
            torch.topk(dd, K, dim=1, largest=False)
            ev[3].record()
            torch.cuda.synchronize()
            stage_ms.append([ev[i].elapsed_time(ev[i + 1])
                                      for i in range(3)])
        score_ms, select_ms, plain_ms = np.median(stage_ms, 0)
        log(f"[33 sparse/{name}] {SP_B} queries, k={K}: {verdict}; build "
            f"{build_s:.3f}s, {held} bytes on the card; search_batched_"
            f"tensors over {SP_REPS} batches of {SP_B}: median {med:.4f} ms, "
            f"max {top:.4f} ms; a chunk of {len(qc)} queries: score "
            f"{score_ms:.4f} ms, top_k_smallest {select_ms:.4f} ms against "
            f"torch.topk {plain_ms:.4f} ms; {key_rows:.1f} of {SP_B} rows a "
            f"batch sent to the int64 key ({smi})")
        del s, dd
    log(f"[33] wall {time.perf_counter() - t_phase:.2f}s ({smi})")


def projection_phases(db_dev, smi):
    """Phase 34: projections, PCA, OPQ, the Gaussian mixture and the stacked
    quantizer on the 1.18M rows on the card."""
    import numpy as np
    import torch

    from scann_tpu_torch.hashes.stacked import (
        StackedQuantizer,
        StackedQuantizerConfig,
    )
    from scann_tpu_torch.projection import (
        ChunkingConfig,
        ChunkingProjection,
        OpqConfig,
        OpqProjection,
        RandomGaussianProjection,
        RandomOrthogonalProjection,
        TruncateProjection,
    )
    from scann_tpu_torch.utils.gmm import (
        CovarianceType,
        GaussianMixture,
        GmmConfig,
    )
    from scann_tpu_torch.utils.linear_algebra import fit_pca

    t_phase = time.perf_counter()
    dev = db_dev.device
    rng = np.random.default_rng(SEED)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def off_identity(m):
        return float((m @ m.T - torch.eye(len(m), device=dev)).abs().max())

    pca, pca_s = timed(lambda: fit_pca(db_dev, PCA_OUT, device=dev))
    pca_orth = off_identity(pca.components)
    if pca_orth > 1e-4:
        raise AssertionError(f"[34 PCA] components off orthonormal by "
                             f"{pca_orth}")
    log(f"[34 PCA] fit_pca({N} x {D} -> {PCA_OUT}) on the card: "
        f"{pca_s:.3f}s, explained variance ratio "
        f"{float(pca.explained_variance_ratio.sum()):.4f}, rows orthonormal "
        f"to {pca_orth:.3g} (limit 1e-4) ({smi})")

    ro = RandomOrthogonalProjection(D, seed=SEED, device=dev)
    ro_orth = off_identity(ro.matrix)
    i, j = (torch.from_numpy(a).to(dev)
            for a in rng.integers(0, N, (2, 1000)))
    before = ((db_dev[i] - db_dev[j]) ** 2).sum(1)
    after = ((ro.project(db_dev[i]) - ro.project(db_dev[j])) ** 2).sum(1)
    kept = float(((after - before).abs() / before.clamp_min(1e-6)).max())
    gp = RandomGaussianProjection(D, PCA_OUT, seed=SEED, device=dev)
    ratio = (gp.project(db_dev) ** 2).sum(1) / (db_dev ** 2).sum(1)
    sigma = (2 / PCA_OUT) ** 0.5
    inside = float(((ratio - 1).abs() <= 3 * sigma).float().mean())
    mean_ratio = float(ratio.mean())
    if ro_orth > 1e-5 or kept > 1e-4:
        raise AssertionError(f"[34 random orthogonal] off orthonormal by "
                             f"{ro_orth}, distances by {kept}")
    if abs(mean_ratio - 1) > 0.1 or inside < 0.98:
        raise AssertionError(f"[34 random Gaussian] squared-norm ratio "
                             f"mean {mean_ratio}, {inside} within 3 sigma")
    log(f"[34 random] RandomOrthogonalProjection({D}): rows orthonormal to "
        f"{ro_orth:.3g} (limit 1e-5), squared distances of 1,000 pairs kept "
        f"to {kept:.3g} relative (limit 1e-4); RandomGaussianProjection({D}, "
        f"{PCA_OUT}) over the {N} rows: squared-norm ratio mean "
        f"{mean_ratio:.4f}, std {float(ratio.std()):.4f} (JL sigma "
        f"{sigma:.4f}), {inside:.4f} within 3 sigma (limits: mean within "
        f"0.1 of 1, 0.98 within)")

    opq, opq_s = timed(lambda: OpqProjection(OpqConfig(
        dim=D, num_subspaces=10, num_iterations=10, seed=SEED),
        device=dev).train(db_dev))
    opq_orth = off_identity(opq.rotation)
    if opq_orth > 1e-4:
        raise AssertionError(f"[34 OPQ] rotation off orthogonal by "
                             f"{opq_orth}")
    shapes = (TruncateProjection(D, PCA_OUT, offset=10,
                                 device=dev).project(db_dev[:1000]).shape,
              ChunkingProjection(ChunkingConfig(
                  input_dim=D, num_chunks=10).with_projection(5),
                  device=dev).project(db_dev[:1000]).shape)
    if shapes != ((1000, PCA_OUT), (1000, 50)):
        raise AssertionError(f"[34 truncate, chunking] shapes {shapes}")
    log(f"[34 OPQ] OpqProjection(dim={D}, num_subspaces=10, "
        f"num_iterations=10) on the {N} rows: {opq_s:.3f}s, rotation "
        f"orthogonal to {opq_orth:.3g} (limit 1e-4); TruncateProjection({D}, "
        f"{PCA_OUT}, offset=10) and ChunkingProjection(10 chunks, 5 each) of "
        f"1,000 rows: shapes {[list(x) for x in shapes]} ({smi})")

    def gmm(iters):
        return GaussianMixture(GmmConfig(
            num_components=GMM_K, covariance_type=CovarianceType.DIAGONAL,
            max_iterations=iters, seed=SEED), device=dev).fit(db_dev)

    start = gmm(1)
    fit, gmm_s = timed(lambda: gmm(100))
    ll, ll0 = fit._log_likelihood, start._log_likelihood
    # EM does not lower the likelihood; at convergence two readings may
    # differ by less than the convergence threshold (1e-4) either way
    if not np.isfinite(ll) or ll < ll0 - 1e-4:
        raise AssertionError(f"[34 GMM] log-likelihood {ll} (start {ll0})")
    log(f"[34 GMM] GaussianMixture({GMM_K} components, DIAGONAL) on all "
        f"{N} rows: {gmm_s:.3f}s, {fit.num_iterations} iterations, converged "
        f"{fit.converged}, mean log-likelihood {ll:.6f} (start {ll0:.6f}) "
        f"({smi})")

    sample = db_dev[torch.from_numpy(
        rng.choice(N, SQ_SAMPLE, replace=False)).to(dev)]
    sq, sq_s = timed(lambda: StackedQuantizer(StackedQuantizerConfig(
        num_levels=SQ_LEVELS, num_codes=16, num_subspaces=50, seed=SEED),
        device=dev).train(sample))
    codes, enc_s = timed(lambda: sq.encode(db_dev))
    rec, errs = torch.zeros_like(db_dev), []
    for li, cb in enumerate(sq.levels):
        rec += cb.decode(codes[:, li])
        errs.append(float(((db_dev - rec) ** 2).sum(1).mean()))
    if not errs[1] < errs[0]:
        raise AssertionError(f"[34 stacked] errors by level {errs}")
    if not torch.allclose(sq.decode(codes), rec, atol=1e-5):
        raise AssertionError("[34 stacked] decode differs from the levels' "
                             "sum")
    log(f"[34 stacked] StackedQuantizer({SQ_LEVELS} levels of 50 x 16) "
        f"trained on {SQ_SAMPLE} sampled rows in {sq_s:.3f}s, all {N} rows "
        f"encoded in {enc_s:.3f}s: mean squared error "
        f"{errs[0]:.4f} after level 1, {errs[1]:.4f} after level 2 ({smi})")
    log(f"[34] wall {time.perf_counter() - t_phase:.2f}s ({smi})")


def tuning_phases(ds, queries, q_np, db_dev, gt_np, smi, searcher):
    """Phases 35-38: the chip profile, ``Scann.auto``, the autotuners and
    the ANN-Benchmarks harness on the card. ``searcher`` is phase 4's
    tree-x-AH index. Each phase counts the launches of the kernels its
    path reaches from zero and fails if one of them never launched."""
    import os
    import tempfile

    import numpy as np
    import torch

    from scann_tpu_torch import (
        BlockSweepSearcher,
        DenseDataset,
        Scann,
        ScannBuilder,
        auto_config,
        autotune,
        autotune_block_sweep,
    )
    from scann_tpu_torch.harness import ann_benchmark as hb
    from scann_tpu_torch.ops import fused_bf as fb
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.ops import tree_ah_grouped as tag
    from scann_tpu_torch.utils import advisor as padv
    from scann_tpu_torch.utils import autotune as at
    from scann_tpu_torch.utils import chip_profile as cp
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    dev = queries.device
    here = os.path.dirname(os.path.abspath(__file__))

    def reset():
        tag.LAUNCHES = 0
        fb.reset_launches()
        sw.reset_launches()

    def counts():
        by = sw.LAUNCHES_BY_KERNEL
        return {"#1": tag.LAUNCHES, "#2": fb.LAUNCHES_BY_KERNEL["cluster"],
                "#5": by["block_min_qmajor_compact"]["block_min_compact"],
                "#6": by["block_min2"]["block_min_compact"],
                "block_min_sweep.cu": sum(v["block_min_sweep"]
                                          for v in by.values())}

    def require(label, got, kernels):
        missing = [k for k in kernels if not got[k]]
        if missing:
            raise AssertionError(f"{label}: {', '.join(missing)} never "
                                 f"launched ({got})")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def serve(search, qs):
        res = [search(qs[i:i + BATCH]) for i in range(0, len(qs), BATCH)]
        torch.cuda.synchronize()
        return torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res])

    def with_profile(path, fn):
        old = os.environ.get(cp.PROFILE_ENV)
        os.environ[cp.PROFILE_ENV] = path
        try:
            return fn()
        finally:
            if old is None:
                del os.environ[cp.PROFILE_ENV]
            else:
                os.environ[cp.PROFILE_ENV] = old

    tune_s = []
    real_autotune = at.autotune

    def timed_autotune(*args, **kw):
        out, secs = timed(lambda: real_autotune(*args, **kw))
        tune_s.append(secs)
        return out

    # -- 35. chip profile --------------------------------------------------------
    t_phase = time.perf_counter()
    cal = cp.measure_calibration(n_probe=CAL_N, dim=D, batch=BATCH,
                                 device=dev)
    prof = cal.profile()
    log(f"[35 chip profile] calibrate(n_probe={CAL_N}, dim={D}, B={BATCH}) "
        f"on {cal.device_name}, block sweep (block_r=64, pre_k=100) and "
        f"tree-x-AH ({cal.n_big // 600} partitions, p=10, pre_k=150) "
        f"through chained: t({cal.n_probe}) {cal.t_small * 1e3:.4f} ms, "
        f"t({cal.n_big}) {cal.t_big * 1e3:.4f} ms, a {cal.a * 1e3:.4f} ms, "
        f"b {cal.b * 1e9:.4f} ns a row, t_tree {cal.t_tree * 1e3:.4f} ms; "
        f"fit n {cal.n_fit}, HBM cap n {cal.n_hbm} ({cal.bytes_per_point} "
        f"bytes a row of {cal.hbm_bytes}) -> sweep_max_n "
        f"{prof.sweep_max_n}, f32_rerank_max_bytes "
        f"{prof.f32_rerank_max_bytes} ({smi})")
    default = cp.ChipProfile()
    log(f"[35 chip profile] the port's defaults: sweep_max_n "
        f"{default.sweep_max_n}, f32_rerank_max_bytes "
        f"{default.f32_rerank_max_bytes}, source {default.source!r}")
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        path = os.path.join(tmp, "profile.json")
        cp.save_profile(prof, path)
        back = cp.load_profile(path)
        if back != prof:
            raise AssertionError(f"[35] the saved profile loads back as "
                                 f"{back}")
        cfg = with_profile(path, lambda: auto_config(N, D))
    sweep_branch = N <= prof.sweep_max_n
    if (cfg.brute_force is not None) != sweep_branch:
        raise AssertionError(f"[35] auto_config({N}, {D}) under the "
                             f"calibrated profile took the other branch")
    log(f"[35 chip profile] saved and loaded back equal; auto_config({N}, "
        f"{D}) under it: {'block sweep' if sweep_branch else 'tree-x-AH'}, "
        f"as N {'<=' if sweep_branch else '>'} sweep_max_n")
    log(f"[35] wall {time.perf_counter() - t_phase:.2f}s ({smi})")

    # -- 36. Scann.auto at full width --------------------------------------------
    t_phase = time.perf_counter()
    sweep_default = N <= default.sweep_max_n
    want = (("BruteForce", "BlockSweepSearcher", "#5", SWEEP_RECALL_FLOOR)
            if sweep_default else
            ("TreeAH", "TreeXHybridSearcher", "#1", RECALL_FLOOR))
    scann, b_s = timed(lambda: Scann.auto(ds, device=dev))
    got_mode = (scann.search_mode.value, type(scann.impl).__name__)
    if got_mode != want[:2]:
        raise AssertionError(f"[36] Scann.auto picked {got_mode}, the "
                             f"default profile implies {want[:2]}")
    reset()
    idx, dists = serve(scann.search_batched_tensors, queries)
    moved = counts()
    require("[36 auto]", moved, [want[2]])
    recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    check_results(idx, dists, queries, db_dev, BATCH * BATCHES)
    if recall < want[3]:
        raise AssertionError(f"[36] Scann.auto recall@10 {recall} < "
                             f"{want[3]}")
    med, top = event_ms(scann.search_batched_tensors, queries, BATCH,
                        BATCHES)
    log(f"[36 auto] Scann.auto(ds) under the default profile: "
        f"{scann.describe()}, built in {b_s:.2f}s; {BATCHES} x B={BATCH}: "
        f"recall@10 {recall:.4f} (floor {want[3]}), {want[2]} launches "
        f"{moved[want[2]]}, batch median {med:.4f} ms (max {top:.4f}) "
        f"({smi})")
    del scann
    built, b_s = timed(lambda: ScannBuilder().auto().build(ds, device=dev))
    if (built.search_mode.value, type(built.impl).__name__) != want[:2]:
        raise AssertionError("[36] ScannBuilder().auto() picked another "
                             "mode than Scann.auto")
    log(f"[36 auto] ScannBuilder().auto().build(ds): "
        f"{built.search_mode.value} / {type(built.impl).__name__}, the same "
        f"as Scann.auto, built in {b_s:.2f}s")
    del built

    def auto_target(label, kernel):
        tune_s.clear()
        at.autotune = timed_autotune
        try:
            scann, b_s = timed(lambda: Scann.auto(
                ds, target_recall=AUTO_TARGET, tune_queries=q_np[:TUNE_Q],
                device=dev))
        finally:
            at.autotune = real_autotune
        res = scann.autotune_result
        if not res.target_met:
            raise AssertionError(f"[36 {label}] autotune missed "
                                 f"{AUTO_TARGET}: {res.recall}")
        reset()
        idx, dists = serve(scann.search_batched_tensors, queries)
        moved = counts()
        require(f"[36 {label}]", moved, [kernel])
        recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
        cfg = scann.config
        # bfloat16 re-rank rows return bfloat16-rounded distances
        check_results(idx, dists, queries, db_dev, BATCH * BATCHES,
                      exact_check=cfg.exact_reordering is None
                      or cfg.exact_reordering.rerank_dtype == "float32")
        if recall < AUTO_TARGET - AUTO_SLACK:
            raise AssertionError(f"[36 {label}] recall@10 {recall} < "
                                 f"{AUTO_TARGET - AUTO_SLACK}")
        med, top = event_ms(scann.search_batched_tensors, queries, BATCH,
                            BATCHES)
        knobs = (f"partitions {cfg.partitioning.num_partitions}, spilling "
                 f"{cfg.partitioning.spilling}, re-rank "
                 f"{cfg.exact_reordering.rerank_dtype}, l_cap "
                 f"{scann.impl._csr_state()[-1]}, "
                 if cfg.partitioning is not None else
                 f"sweep {cfg.brute_force.block_sweep_dtype}, top2 "
                 f"{cfg.brute_force.block_sweep_top2}, ")
        log(f"[36 {label}] Scann.auto(ds, target_recall={AUTO_TARGET}, "
            f"tune_queries=the first {TUNE_Q}): {scann.describe()}; "
            f"{knobs}built and tuned in {b_s:.2f}s, of which autotune "
            f"{sum(tune_s):.2f}s over {len(res.table)} grid points (sample "
            f"recall {res.recall:.4f}); all {BATCHES * BATCH} queries with no "
            f"explicit params: recall@10 {recall:.4f} (floor "
            f"{AUTO_TARGET - AUTO_SLACK}), {kernel} launches {moved[kernel]}, "
            f"batch median {med:.4f} ms (max {top:.4f}) ({smi})")

    auto_target("auto target", want[2])
    sample = ds.numpy()[np.random.default_rng(0).choice(N, min(N, 20_000),
                                                        replace=False)]
    stats = padv.dataset_stats(sample, device=dev)
    log(f"[36 auto] the advisor's statistics of Scann.auto's 20,000-row "
        f"sample (seed 0): {dataclasses.asdict(stats)}, skewed "
        f"{stats.skewed}")
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        path = os.path.join(tmp, "profile.json")
        # below N both where the sweep stops and where the skew route's
        # compact sweep copies stop fitting: the tree either way
        cp.save_profile(dataclasses.replace(
            default, sweep_max_n=AUTO_TREE_MAX_N,
            f32_rerank_max_bytes=AUTO_TREE_F32_BYTES,
            source="chip_smoke [36]: the tree route"), path)
        with_profile(path, lambda: auto_target("auto tree route", "#1"))
    log(f"[36] wall {time.perf_counter() - t_phase:.2f}s ({smi})")

    # -- 37. autotune and autotune_block_sweep -------------------------------------
    t_phase = time.perf_counter()
    reset()
    res, tune = timed(lambda: autotune(searcher, q_np[:TUNE_Q], k=K,
                                       target_recall=TREE_TUNE_TARGET))
    moved = counts()
    require("[37 autotune]", moved, ["#1"])
    if len(res.table) != 36 or not res.target_met:
        raise AssertionError(f"[37 autotune] {len(res.table)} grid points, "
                             f"target met {res.target_met}")
    chosen = [e for e in res.table if e.params == res.params][0]
    idx, _ = serve(lambda qb: searcher.search_batched_tensors(
        qb, K, res.params), queries)
    recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    log(f"[37 autotune] phase 4's tree-x-AH index, the first {TUNE_Q} "
        f"queries, target {TREE_TUNE_TARGET}: {len(res.table)} grid points "
        f"in {tune:.2f}s (#1 launches {moved['#1']}); chosen p="
        f"{res.params.num_leaves_to_search}, pre_k="
        f"{res.params.pre_reordering_num_neighbors}, cost {chosen.cost:.0f}, "
        f"sample recall {res.recall:.4f}; on all {BATCHES * BATCH} queries "
        f"recall@10 {recall:.4f} ({smi})")
    if recall < TREE_TUNE_TARGET - AUTO_SLACK:
        raise AssertionError(f"[37 autotune] recall@10 {recall} on all "
                             f"queries")
    sub = DenseDataset(ds.numpy()[:SIDE_N])
    reset()
    sres, tune = timed(lambda: autotune_block_sweep(
        sub, q_np[:SWEEP_TUNE_Q], k=K, target_recall=SWEEP_TUNE_TARGET,
        device=dev))
    moved = counts()
    require("[37 autotune_block_sweep]", moved,
            ["#5", "#6", "block_min_sweep.cu"])
    if len(sres.table) != 32 or not sres.target_met:
        raise AssertionError(f"[37 autotune_block_sweep] "
                             f"{len(sres.table)} grid points, target met "
                             f"{sres.target_met}")
    held = queries[SWEEP_TUNE_Q:]
    s = BlockSweepSearcher(sub, sres.config, device=dev)
    idx, _ = serve(lambda qb: s.search_batched_tensors(qb, K, sres.params),
                   held)
    held_recall = recall_at_k(idx.cpu().numpy(),
                              exact_top_k(held, db_dev[:SIDE_N]), K)
    c = sres.config
    log(f"[37 autotune_block_sweep] the first {SIDE_N} rows, the first "
        f"{SWEEP_TUNE_Q} queries, target {SWEEP_TUNE_TARGET}: "
        f"{len(sres.table)} grid points in {tune:.2f}s (#5 launches "
        f"{moved['#5']}, #6 {moved['#6']}, block_min_sweep.cu "
        f"{moved['block_min_sweep.cu']}); chosen block_r={c.block_r}, "
        f"sweep_dtype={c.sweep_dtype}, top2={c.top2}, pre_k="
        f"{c.pre_reorder_k}, sample recall {sres.recall:.4f}; held-out "
        f"{len(held)} queries recall@10 {held_recall:.4f} (floor "
        f"{SWEEP_TUNE_TARGET}) ({smi})")
    if held_recall < SWEEP_TUNE_TARGET:
        raise AssertionError(f"[37 autotune_block_sweep] held-out recall "
                             f"{held_recall} < {SWEEP_TUNE_TARGET}")
    del s, sub
    log(f"[37] wall {time.perf_counter() - t_phase:.2f}s ({smi})")

    # -- 38. the harness ---------------------------------------------------------
    t_phase = time.perf_counter()

    def bench(algorithm, data, *extra, kernels=()):
        args = hb.make_parser().parse_args(
            ["--device", str(dev), "--algorithm", algorithm, *extra])
        reset()
        report = hb.run_benchmark(algorithm, data, args)
        moved = counts()
        require(f"[38 {algorithm}]", moved, kernels)
        print(json.dumps(dataclasses.asdict(report)), flush=True)
        return report, moved

    data = hb.generate_synthetic_dataset(device=dev)
    for algorithm, (extra, floor, kernels) in HARNESS_RUNS.items():
        report, moved = bench(algorithm, data, *extra, kernels=kernels)
        log(f"[38 harness/{algorithm}] {data.source} {' '.join(extra)}: "
            f"recall@{K} {report.recall_at_k:.4f} (floor {floor}), QPS "
            f"{report.qps:.1f} at B={report.batch_size}, build "
            f"{report.build_seconds:.3f}s, host round trip "
            f"{report.host_roundtrip_seconds * 1e6:.1f} us"
            + "".join(f", {k} launches {moved[k]}" for k in kernels)
            + f" ({smi})")
        if report.recall_at_k < floor:
            raise AssertionError(f"[38 {algorithm}] recall "
                                 f"{report.recall_at_k} < {floor}")
    full = hb.BenchmarkData(ds.numpy(), q_np, gt_np.astype(np.int32),
                            f"chip_smoke_clustered_n{N}_q{len(q_np)}_d{D}",
                            D)
    report, moved = bench(
        "tree-ah", full, "--num-partitions", "2000", "--num-blocks", "50",
        "--batch-size", str(BATCH), "--autotune-target", str(AUTO_TARGET),
        kernels=["#1"])
    log(f"[38 harness/tree-ah full] {N} x {D}, {len(q_np)} queries, 2000 "
        f"partitions, 50 blocks, --autotune-target {AUTO_TARGET}: chosen p="
        f"{report.autotuned_num_leaves_to_search}, pre_k="
        f"{report.autotuned_pre_reordering_num_neighbors} (sample recall "
        f"{report.autotune_sample_recall:.4f}, {report.autotune_seconds:.2f}"
        f"s); recall@{K} {report.recall_at_k:.4f} (floor "
        f"{AUTO_TARGET - AUTO_SLACK}), QPS {report.qps:.1f} at B={BATCH}, "
        f"build {report.build_seconds:.2f}s, #1 launches {moved['#1']} "
        f"({smi})")
    if report.recall_at_k < AUTO_TARGET - AUTO_SLACK:
        raise AssertionError(f"[38 tree-ah full] recall "
                             f"{report.recall_at_k}")
    del full
    small = ("--num-partitions", "100", "--partitions-to-search", "40",
             "--reorder", "100")
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        path = os.path.join(tmp, "tree_ah.npz")
        trace_dir = os.path.join(tmp, "trace")
        built, _ = bench("tree-ah", data, *small, "--save-index", path,
                         kernels=["#1"])
        served, _ = bench("tree-ah", data, "--load-index", path,
                          "--profile-dir", trace_dir, kernels=["#1"])
        piped, _ = bench("tree-ah", data, "--load-index", path,
                         "--pipeline", "4", kernels=["#1"])
        trace = os.path.join(trace_dir, "search_trace.json")
        trace_bytes = os.path.getsize(trace) if os.path.exists(trace) else 0
        if served.recall_at_k != built.recall_at_k:
            raise AssertionError(f"[38 io] loaded recall "
                                 f"{served.recall_at_k}, built "
                                 f"{built.recall_at_k}")
        if piped.recall_at_k != served.recall_at_k:
            raise AssertionError(f"[38 pipeline] --pipeline 4 recall "
                                 f"{piped.recall_at_k}, serial "
                                 f"{served.recall_at_k}")
        if trace_bytes <= 0:
            raise AssertionError("[38 profile] no trace written")
        log(f"[38 harness/io, pipeline, profile] tree-ah {' '.join(small)}: "
            f"--save-index then --load-index recall {served.recall_at_k:.4f}"
            f" (built {built.recall_at_k:.4f}), load {served.build_seconds:.3f}"
            f"s; --pipeline 4 recall {piped.recall_at_k:.4f}, QPS "
            f"{piped.qps:.1f} (serial {served.qps:.1f}); --profile-dir wrote "
            f"{trace_bytes} bytes")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "scann_tpu_torch.harness.ann_benchmark",
         "--algorithm", "brute-force", "--device", str(dev)], cwd=here,
        capture_output=True,
        text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"[38 cli] exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    cli = json.loads(out.stdout)
    if cli["recall_at_k"] < HARNESS_RUNS["brute-force"][1]:
        raise AssertionError(f"[38 cli] recall {cli['recall_at_k']}")
    print(json.dumps(cli), flush=True)
    log(f"[38 harness/cli] python -m scann_tpu_torch.harness.ann_benchmark "
        f"--algorithm brute-force --device {dev}: one JSON report, recall@{K} "
        f"{cli['recall_at_k']:.4f}, QPS {cli['qps']:.1f}, in "
        f"{time.perf_counter() - t0:.2f}s ({smi})")
    log(f"[38] wall {time.perf_counter() - t_phase:.2f}s ({smi})")


def device_ms(search, queries):
    """(kernel ms, kernels) a batch of ``search`` on the card: the device
    time of every kernel torch.profiler saw over BATCHES batches, summed,
    and their count, each divided by BATCHES."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    search(queries[:BATCH])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(BATCHES):
            search(queries[i * BATCH:(i + 1) * BATCH])
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            total_us += us
            count += e.count
    return total_us / 1e3 / BATCHES, count / BATCHES


def same_ids_or_tied(got, want, got_d, label, tol=1e-5):
    """Ids equal except where two results of a row tie within ``tol``
    relative (the two searches sum their float32 products in another
    order); returns how many slots swapped within a tie."""
    import numpy as np

    swapped = 0
    for b, j in zip(*np.nonzero(got != want)):
        tied = np.abs(got_d[b] - got_d[b, j]) <= tol * abs(got_d[b, j])
        if tied.sum() < 2 and j != got.shape[1] - 1:
            raise AssertionError(f"{label}: query {b} slot {j} id "
                                 f"{got[b, j]} against {want[b, j]}, no tie")
        swapped += 1
    return swapped


def sharded_phases(ds, queries, q_np, db_dev, gt_np, smi, searcher, cfg):
    """Phases 39-43: the sharded searchers on a mesh of ``SHARDS`` shards of
    the one card (``make_mesh(devices=[cuda:0] * SHARDS)``), the sharded
    build, ``Scann.auto`` over the mesh and ``torch.distributed`` at world
    size 1. ``searcher`` and ``cfg`` are phase 4's index and config.
    Returns {kernel record name: {phase: launches}} of the runs that must
    launch #1, #5 and #7 on every shard in every batch."""
    import os
    import socket
    import tempfile

    import numpy as np
    import torch

    from scann_tpu_torch import (
        AsymmetricHasher,
        AsymmetricHasherConfig,
        BlockSweepConfig,
        BlockSweepSearcher,
        BruteForceSearcher,
        DenseDataset,
        Scann,
        ScannError,
        SearchParameters,
        TreeXHybridSearcher,
    )
    from scann_tpu_torch.harness import ann_benchmark as hb
    from scann_tpu_torch.models import tree_x_hybrid as tx
    from scann_tpu_torch.ops import scoring_kernels as sk
    from scann_tpu_torch.ops import sweep as sw
    from scann_tpu_torch.ops import topk
    from scann_tpu_torch.ops import tree_ah_grouped as tag
    from scann_tpu_torch.parallel import (
        ShardedAsymmetricHasher,
        ShardedBlockSweepSearcher,
        ShardedBruteForceSearcher,
        ShardedTreeXHybridSearcher,
        make_mesh,
    )
    from scann_tpu_torch.parallel import multihost as mh
    from scann_tpu_torch.utils import chip_profile as cp
    from scann_tpu_torch.utils.benchmarking import recall_at_k

    dev = queries.device
    here = os.path.dirname(os.path.abspath(__file__))
    mesh = make_mesh(devices=[dev] * SHARDS)
    params = SearchParameters(num_leaves_to_search=P,
                              pre_reordering_num_neighbors=PRE_K)
    out = {"tree_ah_grouped": {}, "block_min_qmajor_compact": {},
           "lut16_fused_sweep": {}}
    every = SHARDS * BATCHES

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def serve(search, qs=queries):
        res = [search(qs[i:i + BATCH]) for i in range(0, len(qs), BATCH)]
        torch.cuda.synchronize()
        return torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res])

    def store_bytes(st):
        ts = st if isinstance(st, tuple) else (st,)
        return sum(t.numel() * t.element_size() for t in ts)

    def tree_serve(label, sh, single_recall):
        """#1 on every shard in every batch, recall, exact distances, and
        the selection kernel on every shard's preselect rows."""
        tag.LAUNCHES = 0
        sel0 = topk.SELECT_KERNEL_ROWS
        idx, dists = serve(lambda qb: sh.search_batched_tensors(qb, K,
                                                                params))
        launches = tag.LAUNCHES
        sel_rows = topk.SELECT_KERNEL_ROWS - sel0
        if sel_rows < every * BATCH:
            raise AssertionError(f"{label}: the selection kernel took "
                                 f"{sel_rows} rows, not a batch a shard "
                                 f"({every * BATCH})")
        log(f"{label} selection kernel rows {sel_rows} ({every} shard "
            f"batches of {BATCH})")
        recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
        err = check_results(idx, dists, queries, db_dev, BATCH * BATCHES)
        if launches != every:
            raise AssertionError(f"{label}: #1 launched {launches} times, "
                                 f"not once a shard a batch ({every})")
        floor = max(RECALL_FLOOR, single_recall - 0.02)
        if recall < floor:
            raise AssertionError(f"{label}: recall@10 {recall} < {floor}")
        return idx, dists, launches, recall, err

    # -- 39. sharded tree-x-AH over phase 4's index -------------------------------
    t_phase = time.perf_counter()
    s_idx, _ = serve(lambda qb: searcher.search_batched_tensors(qb, K,
                                                                params))
    single_recall = recall_at_k(s_idx.cpu().numpy(), gt_np, K)
    mem0 = torch.cuda.memory_allocated(dev)
    sh, lay_s = timed(lambda: ShardedTreeXHybridSearcher(searcher, mesh))
    mem1 = torch.cuda.memory_allocated(dev)
    rows = [c.shape[1] for c in sh._codes]
    per_shard = [c.numel() + p.numel() * 8 + store_bytes(d)
                 + o.numel() * 8 for c, p, d, o in
                 zip(sh._codes, sh._perm, sh._db, sh._offs)]
    owned = [int((z > 0).sum()) for z in sh._sizes]
    log(f"[39 sharded tree-AH] ShardedTreeXHybridSearcher(phase 4's index, "
        f"make_mesh(devices=[{dev}] * {SHARDS})): layout and upload "
        f"{lay_s:.2f}s; partitions a shard {owned}, CSR rows a shard {rows} "
        f"(l_cap {sh._l_cap}), bytes a shard on the card (codes, perm, "
        f"re-rank rows, offsets and sizes) {per_shard}, memory_allocated "
        f"+{mem1 - mem0} bytes")

    # #1 against its twin on shard 0's real first-batch inputs
    q0 = queries[:BATCH]
    cent, cb = sh._cent[dev], sh._cb[dev]
    codes0, offs0, sizes0 = sh._codes[0], sh._offs[0], sh._sizes[0]
    s_pad = 2 * codes0.shape[0] if sh._packed else codes0.shape[0]
    q_cap = searcher.effective_q_cap(BATCH, P)
    parts = tx._select_partitions(cent, q0, p=P)
    luts = tx._residual_luts(q0, cent, parts, cb, s_pad=s_pad,
                             use_residuals=True)
    luts_g, grp_off, grp_size, _ = tx._group_luts(
        luts, parts, offs0, sizes0, s_pad=s_pad, q_cap=q_cap,
        packed=sh._packed)
    kkw = dict(l_cap=sh._l_cap, l_tile=cfg.score_l_tile, q_cap=q_cap,
               packed=sh._packed)
    got = tag.tree_ah_grouped_scores(luts_g, codes0, grp_off, grp_size, **kkw)
    torch.cuda.synchronize()
    want = tag.tree_ah_grouped_scores_reference(luts_g, codes0, grp_off,
                                                grp_size, **kkw)
    live = int((grp_size > 0).sum())
    if not torch.equal(got, want):
        raise AssertionError("[39] #1 differs from its twin on shard 0")
    log(f"[39 kernel check] #1 on shard 0's first-batch inputs: NG "
        f"{len(grp_size)} ({live} with rows on the shard), q_cap {q_cap}, "
        f"out {list(got.shape)} bf16: bit-identical to its twin (tolerance: "
        f"bit for bit)")
    del got, want, luts_g, luts

    idx, dists, launches, recall, err = tree_serve("[39]", sh, single_recall)
    out["tree_ah_grouped"]["[39] sharded tree-x-AH"] = launches
    sh_med, sh_top = event_ms(lambda qb: sh.search_batched_tensors(
        qb, K, params), queries, BATCH, BATCHES)
    one_med, one_top = event_ms(lambda qb: searcher.search_batched_tensors(
        qb, K, params), queries, BATCH, BATCHES)
    log(f"[39 sharded tree-AH] {BATCHES} x B={BATCH}, p={P}, pre_k={PRE_K}: "
        f"recall@10 {recall:.4f} (single device {single_recall:.4f}; floor "
        f"max({RECALL_FLOOR}, single - 0.02)), distances vs recomputed max "
        f"rel err {err:.3g}, #1 launches {launches} ({SHARDS} shards x "
        f"{BATCHES} batches); batch median {sh_med:.4f} ms (max "
        f"{sh_top:.4f}) against the single-device searcher's {one_med:.4f} "
        f"ms (max {one_top:.4f}) ({smi})")
    del sh, s_idx
    # the shards of one card run one after another: the batch by shard
    # count (1 and 2 shards of the same index beside [39]'s 4)
    by_count = {SHARDS: sh_med}
    for n_sh in (1, 2):
        sub = ShardedTreeXHybridSearcher(searcher, make_mesh(
            devices=[dev] * n_sh))
        by_count[n_sh] = event_ms(lambda qb: sub.search_batched_tensors(
            qb, K, params), queries, BATCH, BATCHES)[0]
        if n_sh == 1:
            one_shard = sub
        else:
            del sub
    log(f"[39 aside] sharded tree-x-AH batch median by shard count on the "
        f"one card: " + ", ".join(f"{n} -> {by_count[n]:.4f} ms"
                                  for n in sorted(by_count))
        + f"; the single-device searcher {one_med:.4f} ms ({smi})")
    # one shard against the single-device searcher: batch medians in turns,
    # and the card's own time a batch (torch.profiler's kernel time, summed)
    turns_ms = [event_ms(lambda qb: s_.search_batched_tensors(qb, K, params),
                         queries, BATCH, BATCHES)[0]
                for s_ in (searcher, one_shard, one_shard, searcher)]
    dev_ms = [device_ms(lambda qb: s_.search_batched_tensors(qb, K, params),
                        queries) for s_ in (searcher, one_shard)]
    log(f"[39 aside] in turns, single / 1 shard / 1 shard / single: "
        + " / ".join(f"{t:.4f}" for t in turns_ms) + " ms a batch; kernel "
        f"time a batch (torch.profiler, {BATCHES} batches): single "
        f"{dev_ms[0][0]:.4f} ms in {dev_ms[0][1]:.0f} kernels, 1 shard "
        f"{dev_ms[1][0]:.4f} ms in {dev_ms[1][1]:.0f} kernels ({smi})")
    del one_shard
    # the file round trip on the first SIDE_N rows, cut for time: a
    # full-width layout is about 1 GB of compressed npz (the JAX package's
    # format), some 60 s to write at numpy's zlib rate
    side = TreeXHybridSearcher(dataclasses.replace(
        cfg, num_partitions=round(2000 * SIDE_N / N)), device=dev).build(
        DenseDataset(ds.numpy()[:SIDE_N]))
    sh = ShardedTreeXHybridSearcher(side, mesh)
    gt_side = exact_top_k(queries, db_dev[:SIDE_N])
    idx, dists = serve(lambda qb: sh.search_batched_tensors(qb, K, params))
    side_recall = recall_at_k(idx.cpu().numpy(), gt_side, K)
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        path = os.path.join(tmp, "layout.npz")
        _, save_s = timed(lambda: sh.save_layout(path))
        back, load_s = timed(lambda: ShardedTreeXHybridSearcher.load_layout(
            path, mesh))
        size = os.path.getsize(path)
    b_idx, b_dists = serve(lambda qb: back.search_batched_tensors(qb, K,
                                                                  params))
    if not (torch.equal(b_idx, idx) and torch.equal(b_dists, dists)):
        raise AssertionError("[39] the loaded layout serves other results")
    log(f"[39 sharded tree-AH io] the first {SIDE_N} rows (cut for time), "
        f"{side.partitioner.num_partitions} partitions, {SHARDS} shards, "
        f"recall@10 {side_recall:.4f}: save_layout {save_s:.2f}s ({size} "
        f"bytes), load_layout {load_s:.2f}s, the {BATCHES} batches "
        f"bit-identical")
    del sh, back, b_idx, b_dists, side
    torch.cuda.empty_cache()
    log(f"[39] wall {time.perf_counter() - t_phase:.2f}s ({smi})")

    # -- 40. the sharded build at full width ----------------------------------------
    t_phase = time.perf_counter()
    built, b_s = timed(lambda: ShardedTreeXHybridSearcher.build(ds, cfg,
                                                                mesh))
    tk = built._inner.partitioner.tokenization
    _, _, launches, recall, err = tree_serve("[40]", built, RECALL_FLOOR)
    out["tree_ah_grouped"]["[40] sharded build"] = launches
    med, top = event_ms(lambda qb: built.search_batched_tensors(
        qb, K, params), queries, BATCH, BATCHES)
    log(f"[40 sharded build] ShardedTreeXHybridSearcher.build(the {N} rows, "
        f"phase 4's config, {SHARDS} shards): {b_s:.2f}s, partitions "
        f"{tk.num_partitions}, max size {tk.max_partition_size}; "
        f"{BATCHES} x B={BATCH}: recall@10 {recall:.4f} (floor "
        f"{RECALL_FLOOR}), distances max rel err {err:.3g}, #1 launches "
        f"{launches}, batch median {med:.4f} ms (max {top:.4f}) ({smi})")
    del built, tk
    torch.cuda.empty_cache()
    log(f"[40] wall {time.perf_counter() - t_phase:.2f}s ({smi})")

    # -- 41. sharded block sweep and sharded hasher at full width --------------------
    t_phase = time.perf_counter()
    allow = np.zeros(N, dtype=bool)
    allow[::2] = True
    allow[:1000] = False
    gt_f = exact_top_k(queries[:BATCH], db_dev,
                       torch.from_numpy(allow).to(dev))

    def filtered(label, s, p, floor):
        f_idx, f_dists = s.search_batched_tensors(queries[:BATCH], K, p,
                                                  allow_mask=allow)
        ids = f_idx.cpu().numpy()
        if not allow[ids[ids >= 0]].all() or (ids < 0).any():
            raise AssertionError(f"{label}: a filtered result is denied or "
                                 f"missing")
        f_recall = recall_at_k(ids, gt_f, K)
        if f_recall < floor:
            raise AssertionError(f"{label}: filtered recall@10 {f_recall} "
                                 f"< {floor}")
        return f_recall

    sweep = BlockSweepSearcher(ds, BlockSweepConfig(
        block_r=SWEEP_R, pre_reorder_k=SWEEP_PRE_K), device=dev)
    ssw, lay_s = timed(lambda: ShardedBlockSweepSearcher(sweep, mesh))
    sw.reset_launches()
    idx, dists = serve(lambda qb: ssw.search_batched_tensors(qb, K))
    c5 = sw.COMPACT_LAUNCHES["block_min_compact"]
    recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    err = check_results(idx, dists, queries, db_dev, BATCH * BATCHES)
    if c5 != every:
        raise AssertionError(f"[41 block sweep] #5 launched {c5} times, not "
                             f"once a shard a batch ({every})")
    if recall < SWEEP_RECALL_FLOOR:
        raise AssertionError(f"[41 block sweep] recall@10 {recall}")
    out["block_min_qmajor_compact"]["[41] sharded block sweep"] = c5
    med, top = event_ms(lambda qb: ssw.search_batched_tensors(qb, K),
                        queries, BATCH, BATCHES)
    f_recall = filtered("[41 block sweep]", ssw, None, SWEEP_RECALL_FLOOR)
    log(f"[41 sharded block sweep] block_r={SWEEP_R}, pre_k={SWEEP_PRE_K}, "
        f"{SHARDS} shards of {ssw._blk} rows (aug "
        f"{[a.numel() * a.element_size() for a in ssw._aug]} bytes, re-rank "
        f"{[store_bytes(r) for r in ssw._rdb]} bytes), layout {lay_s:.2f}s; "
        f"{BATCHES} x B={BATCH}: recall@10 {recall:.4f} (floor "
        f"{SWEEP_RECALL_FLOOR}), distances max rel err {err:.3g}, #5 "
        f"launches {c5}, batch median {med:.4f} ms (max {top:.4f}); one "
        f"filtered batch (even ids without [0, 1000), the penalty stream): "
        f"recall@10 {f_recall:.4f} against the filtered exact top-10, every "
        f"id allowed ({smi})")
    del ssw, sweep
    torch.cuda.empty_cache()

    hasher, h_s = timed(lambda: AsymmetricHasher(AsymmetricHasherConfig(
        num_codes=AH_C, num_subspaces=AH_S, seed=42, max_iterations=12,
        training_sample_size=100_000), device=dev).build(ds))
    shh, lay_s = timed(lambda: ShardedAsymmetricHasher(hasher, mesh))
    hp = SearchParameters(pre_reordering_num_neighbors=AH_PRE_K)
    sk.reset_launches()
    idx, dists = serve(lambda qb: shh.search_batched_tensors(qb, K, hp))
    c7 = sk.LAUNCHES["lut16_fused_sweep"]
    recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    err = check_results(idx, dists, queries, db_dev, BATCH * BATCHES)
    if c7 != every:
        raise AssertionError(f"[41 hasher] #7 launched {c7} times, not once "
                             f"a shard a batch ({every})")
    if recall < AH_RECALL_FLOOR:
        raise AssertionError(f"[41 hasher] recall@10 {recall}")
    out["lut16_fused_sweep"]["[41] sharded hasher"] = c7
    med, top = event_ms(lambda qb: shh.search_batched_tensors(qb, K, hp),
                        queries, BATCH, BATCHES)
    f_recall, f_s = timed(lambda: filtered("[41 hasher]", shh, hp,
                                           AH_RECALL_FLOOR))
    log(f"[41 sharded hasher] S={AH_S}, C={AH_C}, pre_k={AH_PRE_K}, built "
        f"in {h_s:.2f}s, {SHARDS} shards of {shh._blk} rows (packed codes "
        f"{[c.numel() for c in shh._codes_packed]} bytes), layout "
        f"{lay_s:.2f}s; {BATCHES} x B={BATCH}: recall@10 {recall:.4f} (floor "
        f"{AH_RECALL_FLOOR}), distances max rel err {err:.3g}, #7 launches "
        f"{c7}, batch median {med:.4f} ms (max {top:.4f}); one filtered batch "
        f"through the plain score path (the only one that takes a mask): "
        f"recall@10 {f_recall:.4f}, every id allowed, {f_s:.2f}s ({smi})")
    del shh, hasher
    torch.cuda.empty_cache()
    log(f"[41] wall {time.perf_counter() - t_phase:.2f}s ({smi})")

    # -- 42. Scann.auto over the mesh under [36]'s tree-route profile ---------------
    t_phase = time.perf_counter()
    old = os.environ.get(cp.PROFILE_ENV)
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        path = os.path.join(tmp, "profile.json")
        cp.save_profile(dataclasses.replace(
            cp.ChipProfile(), sweep_max_n=AUTO_TREE_MAX_N,
            f32_rerank_max_bytes=AUTO_TREE_F32_BYTES,
            source="chip_smoke [42]: the tree route over a mesh"), path)
        os.environ[cp.PROFILE_ENV] = path
        try:
            scann, a_s = timed(lambda: Scann.auto(
                ds, target_recall=AUTO_TARGET, tune_queries=q_np[:TUNE_Q],
                mesh=mesh, device=dev))
        finally:
            if old is None:
                del os.environ[cp.PROFILE_ENV]
            else:
                os.environ[cp.PROFILE_ENV] = old
    dec = scann.describe()["auto"]
    keys = {"sharded", "shards", "shards_needed", "serving_bytes",
            "per_chip_budget", "reason"}
    if not isinstance(scann.impl, ShardedTreeXHybridSearcher) or \
            set(dec) != keys or not dec["sharded"] or \
            not 1 < dec["shards_needed"] <= SHARDS:
        raise AssertionError(f"[42] Scann.auto over the mesh: "
                             f"{type(scann.impl).__name__}, {dec}")
    tag.LAUNCHES = 0
    idx, dists = serve(scann.search_batched_tensors)
    launches = tag.LAUNCHES
    recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    check_results(idx, dists, queries, db_dev, BATCH * BATCHES,
                  exact_check=scann.config.exact_reordering.rerank_dtype
                  == "float32")
    if recall < AUTO_TARGET - AUTO_SLACK or launches < every:
        raise AssertionError(f"[42] recall@10 {recall}, #1 launches "
                             f"{launches}")
    out["tree_ah_grouped"]["[42] Scann.auto over the mesh"] = launches
    pc = scann.config.partitioning
    log(f"[42 auto over the mesh] Scann.auto(ds, target_recall="
        f"{AUTO_TARGET}, mesh of {SHARDS}) under sweep_max_n "
        f"{AUTO_TREE_MAX_N}, f32_rerank_max_bytes {AUTO_TREE_F32_BYTES}: "
        f"{dec}; partitions {pc.num_partitions}, spilling {pc.spilling}, "
        f"re-rank {scann.config.exact_reordering.rerank_dtype}; built and "
        f"tuned in {a_s:.2f}s (sample recall "
        f"{scann.autotune_result.recall:.4f}, p="
        f"{scann.default_params.num_leaves_to_search}, pre_k="
        f"{scann.default_params.pre_reordering_num_neighbors}); all "
        f"{BATCHES * BATCH} queries with no explicit params: recall@10 "
        f"{recall:.4f} (floor {AUTO_TARGET - AUTO_SLACK}), #1 launches "
        f"{launches} ({smi})")
    del scann
    torch.cuda.empty_cache()
    log(f"[42] wall {time.perf_counter() - t_phase:.2f}s ({smi})")

    # -- 43. torch.distributed at world size 1 ---------------------------------------
    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rank = mh.initialize_multihost(f"127.0.0.1:{port}", 1, 0, device=dev)
    try:
        backend = torch.distributed.get_backend()
        gmesh = mh.global_mesh(local_devices=[dev] * SHARDS)
        if rank != 0 or backend != "nccl" or gmesh.devices.size != SHARDS \
                or sum(gmesh.axis_local()) != SHARDS:
            raise AssertionError(f"[43] rank {rank}, backend {backend}, "
                                 f"mesh {gmesh}")
        sbf, lay_s = timed(lambda: ShardedBruteForceSearcher(ds, mesh=gmesh))
        # the first batch also sets up NCCL's communicator (its first
        # collective); the second is the search alone
        _, first_s = timed(lambda: sbf.search_batched_tensors(q0, K))
        (g_idx, g_d), q_s = timed(lambda: sbf.search_batched_tensors(q0, K))
        w_idx, _ = BruteForceSearcher(ds, device=dev).search_batched_tensors(
            q0, K)
        swapped = same_ids_or_tied(g_idx.cpu().numpy(), w_idx.cpu().numpy(),
                                   g_d.cpu().numpy(), "[43]")
        lo, hi = mh.process_local_rows(N)
        log(f"[43 torch.distributed] initialize_multihost('127.0.0.1:"
            f"{port}', 1, 0) on {backend}: rank {rank}; global_mesh: "
            f"{gmesh.devices.size} local shards, process_local_rows({N}) = "
            f"[{lo}, {hi}); ShardedBruteForceSearcher over it "
            f"(all_gather on {backend} in the merge) in {lay_s:.2f}s, one "
            f"batch of {BATCH} in {first_s:.3f}s the first time (NCCL's "
            f"set-up in it), {q_s:.3f}s the second: ids equal to the "
            f"single-device brute "
            f"force's ({swapped} slots swapped within a float32 tie) ({smi})")
        del sbf
    finally:
        torch.distributed.destroy_process_group()
    data = hb.generate_synthetic_dataset(device=dev)
    args = hb.make_parser().parse_args(
        ["--device", str(dev), "--algorithm", "brute-force", "--shards",
         str(SHARDS)])
    try:
        hb.run_benchmark("brute-force", data, args)
    except ScannError as e:
        want = f"requested {SHARDS} devices, only " \
            f"{torch.cuda.device_count()} available"
        if want not in str(e):
            raise AssertionError(f"[43] harness --shards: {e}") from e
        log(f"[43 harness] --shards {SHARDS} on this {torch.cuda.device_count()}"
            f"-card host raises as the JAX harness does: {e}")
    else:
        if torch.cuda.device_count() < SHARDS:
            raise AssertionError(f"[43] harness --shards {SHARDS} ran on "
                                 f"{torch.cuda.device_count()} cards")
    log(f"[43] wall {time.perf_counter() - t_phase:.2f}s ({smi})")
    return out


if __name__ == "__main__":
    sys.exit(main())

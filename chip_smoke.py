#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scann_tpu_torch``) on one GPU.

Drives the port's three serving paths once at GloVe-100 shape, over
1,183,514 x 100 seeded synthetic clustered vectors and 10 batches of 1024
queries:

- tree-x-AH: builds the index on the card, checks the CUDA grouped
  leaf-scoring kernel against its plain PyTorch twin on the first batch's
  real inputs, serves the batches through
  ``TreeXHybridSearcher.search_batched_tensors`` and holds recall@10 against
  exact ground truth;
- block sweep: builds the bf16 augmented copy and the re-rank state on the
  card (``BlockSweepConfig(block_r=64, pre_reorder_k=64)``, bench.py's
  configuration), checks the four forms of the CUDA block-min kernel against
  their twins on the first batch's real augmented queries and the full
  augmented copy (with an allowlist penalty and int8 rows as well), serves
  the batches through ``BlockSweepSearcher.search_batched_tensors`` (recall@10
  >= 0.99), and drives the other three forms through the searcher: top2,
  block_r=128 and block_r=512 at B=128;
- asymmetric hashing: builds the PQ index on the card (S=50, C=16, the JAX
  package's bench.py configuration), checks the fused int8 LUT16 sweep
  kernel (bit for bit) and the LUT16 score kernel against their twins on the
  first batch's real tables, serves the batches through
  ``AsymmetricHasher.search_batched_tensors`` with pre_k=300 (the fused
  sweep, recall@10 >= 0.9), and drives the score kernel through the
  approximate-only path (B=128, float32 scores) and a 16,384-row hasher's
  re-rank path (bf16 scores);

then times every kernel against its twin (L2 flushed) and the search stages
with CUDA events.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (the kernels are built from
``scann_tpu_torch/csrc`` at first use, all sources at once). Exits non-zero,
printing no result, when there is no CUDA device or any phase fails. The
line before the last is the kernels' JSON record; the last line is the
device JSON.
"""

from __future__ import annotations

import json
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
KERNEL_SOURCES = ("tree_ah_grouped", "block_min_sweep", "lut16_scoring")
# published H100 SXM peaks (dense): bf16 tensor cores, int8 tensor cores,
# float32 outside the tensor cores, HBM3
PEAK_BF16, PEAK_INT8, PEAK_F32, PEAK_HBM = 989e12, 1979e12, 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(ops: float, ops_peak: float, nbytes: float):
    """(least ms for the work on the card, what bounds it)."""
    t_ops, t_bytes = ops / ops_peak, nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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

    # -- 3. data -----------------------------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    centers = rng.standard_normal((CLUSTERS, D), dtype=np.float32) * SPREAD
    db = centers[rng.integers(0, CLUSTERS, N)]
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
    log(f"[5 kernel check] NG {n_groups}, q_cap {q_cap}, l_tile {l_tile}, "
        f"out {list(got.shape)} bf16: masked slots equal "
        f"({int(masked_w.sum())}), unmasked max {max_ulp} bf16 ulp, max abs "
        f"err {max_abs_err:.6g} (tolerance: 1 ulp)")
    if max_ulp > 1:
        raise AssertionError(f"kernel differs from its twin by {max_ulp} ulp")

    # -- 6. search: the main path, counted ------------------------------------------
    params = SearchParameters(num_leaves_to_search=P,
                              pre_reordering_num_neighbors=PRE_K)
    tag.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [searcher.search_batched_tensors(
        queries[i * BATCH:(i + 1) * BATCH], K, params)
        for i in range(BATCHES)]
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = tag.LAUNCHES
    idx = torch.cat([r[0] for r in results])
    dists = torch.cat([r[1] for r in results])

    gt = []
    x_sq = (db_dev * db_dev).sum(1)
    for i in range(0, len(queries), 256):
        qb = queries[i:i + 256]
        dd = (qb * qb).sum(1)[:, None] + x_sq[None, :] - 2.0 * (qb @ db_dev.T)
        gt.append(torch.topk(dd, K, dim=1, largest=False).indices)
    gt = torch.cat(gt)
    gt_np = gt.cpu().numpy()
    recall = recall_at_k(idx.cpu().numpy(), gt_np, K)
    dist_err = check_results(idx, dists, queries, db_dev, BATCH * BATCHES)
    log(f"[6 search] {BATCHES} x B={BATCH}, p={P}, pre_k={PRE_K}, k={K}: "
        f"recall@10 {recall:.4f} (floor {RECALL_FLOOR}), kernel launches "
        f"{launches}, returned vs recomputed distances max rel err "
        f"{dist_err:.3g}, host wall {search_s:.3f}s")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall@10 {recall} < {RECALL_FLOOR}")
    if launches <= 0:
        raise AssertionError("the search never launched the CUDA kernel")

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
    # bound on this batch's inputs: LUT rows, the probed partitions' code
    # columns, offsets and sizes read once, the whole output written once;
    # one float32 add per table entry per valid column and query
    probed = torch.unique(parts)
    tree_bytes = (luts_g.numel() * 2 + int(part_sizes[probed].sum())
                  * codes_csr.shape[0] + n_groups * 8 + got.numel() * 2)
    tree_ops = int(grp_size.sum()) * q_cap * s_pad
    tree_bound, tree_by = bound(tree_ops, PEAK_F32, tree_bytes)
    log(f"[7 kernel time] grouped leaf scorer, L2 flushed: kernel "
        f"{kernel_ms:.4f} ms, plain twin {plain_ms:.4f} ms, bound "
        f"{tree_bound:.4f} ms, bound by {tree_by} ({tree_bytes} bytes, "
        f"{tree_ops} float32 adds) ({smi})")

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

    records += block_sweep_phases(ds, queries, db_dev, gt_np, cold_ms, turns,
                                  smi)
    records += hasher_phases(ds, queries, db_dev, gt_np, cold_ms, turns, smi)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
        log(f"[9 kernel check] {name}{label}: B={q.shape[0]}, r={r}, "
            f"{aug.dtype} rows {list(aug.shape)}: max abs err "
            f"{rep['max_abs_err']:.6g} (tolerance 1e-5 * sum|terms| + 1e-5; "
            f"compact 1 bf16 ulp, max {rep['max_ulp']}, {rep['ulp_over_1']} "
            f"values past 1 ulp near 0 within tolerance), offsets "
            f"bit-identical {rep['loc_equal']:.6f} of {rep['checked']}, the "
            f"rest reach the twin's minimum within tolerance")

    aug128 = r128_s.device_state()[0]
    aug512 = r512_s.device_state()[0]
    q_top2 = q_aug[:BATCH // 2]
    q_512 = q_aug[:128]
    check("block_min_qmajor_compact", "compact",
          sw.block_min_sweep_qmajor(q_aug, aug64, r=SWEEP_R, compact=True),
          q_aug, aug64, SWEEP_R)
    check("block_min", "rowmajor", sw.block_min_sweep(q_aug, aug128, r=128),
          q_aug, aug128, 128)
    check("block_min_qmajor", "qmajor",
          sw.block_min_sweep_qmajor(q_512, aug512, r=512), q_512, aug512, 512)
    check("block_min2", "top2", sw.block_min2_sweep(q_top2, aug64, r=SWEEP_R),
          q_top2, aug64, SWEEP_R)
    # the allowlist penalty (half the ids allowed) and the int8 layout
    allow = np.random.default_rng(SEED + 1).random(ds.size) < 0.5
    pen64 = main_s._allow_penalty(allow, n_pad).to(dev)
    pen128 = r128_s._allow_penalty(allow, aug128.shape[0]).to(dev)
    check("block_min", "rowmajor",
          sw.block_min_sweep(q_aug, aug128, r=128, penalty=pen128), q_aug,
          aug128, 128, pen128, " + penalty")
    check("block_min2", "top2",
          sw.block_min2_sweep(q_top2, aug64, r=SWEEP_R, penalty=pen64),
          q_top2, aug64, SWEEP_R, pen64, " + penalty")
    codes, scales, sn = sw.build_int8_augmented_db(
        ds.numpy(), ds.size, measure, tile_n=n_pad,
        shuffle_stride=sw.shuffle_stride_for(ds.size))
    aug8 = codes.to(dev)
    q_aug8, _ = sw.augment_for_sweep(q0, aug8, measure, scales.to(dev), sn)
    pen8 = sw.build_allow_penalty(
        allow, n_pad, SWEEP_R, inv_perm=main_s._inv_host,
        mask_value=4.0 * sw.INT8_NORM_DIGIT_MAX * sn).to(dev)
    check("block_min_qmajor_compact", "compact",
          sw.block_min_sweep_qmajor(q_aug8, aug8, r=SWEEP_R, compact=True,
                                    penalty=pen8),
          q_aug8, aug8, SWEEP_R, pen8, " + int8 rows + penalty")

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
    run(top2_s, queries[:BATCH], BATCH, "block_min2", "top2 r=64")
    run(r128_s, queries[:BATCH], BATCH, "block_min", "r=128")
    run(r512_s, queries[:128], 128, "block_min_qmajor", "r=512 B=128")

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
        log(f"[11 kernel time] {name}: B={b}, r={r}, rows {n_rows}, L2 "
            f"flushed: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms, bound by {b_by} ({ops} bf16 FLOP, {nbytes} "
            f"bytes) -> "
            f"{ops / k_ms / 1e9:.1f} TFLOP/s, {b_ms / k_ms:.3f} of the bound "
            f"({smi})")
        records.append({
            "name": name, "route": "cuda",
            "source": "scann_tpu_torch/csrc/block_min_sweep.cu",
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
        f"{int((want >= sk.INVALID_COMBINED / 2).sum())}")
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

    score_err = 0.0
    for b, dtype in ((BATCH, torch.bfloat16), (AH_APPROX_B, torch.float32)):
        got = sk.lut16_score(luts[:b], codes_t, dtype)
        torch.cuda.synchronize()
        want = sk.lut16_score_reference(luts[:b], codes_t, dtype)
        same = torch.equal(got, want)
        ulp = 0 if same else int((order(got) - order(want)).abs().max())
        err = float((got.float() - want.float()).abs().max())
        score_err = max(score_err, err)
        log(f"[13 kernel check] lut16_score: B={b}, {dtype}, codes "
            f"{list(codes_t.shape)} -> {list(got.shape)}: bit-identical "
            f"{same}, max {ulp} ulp, max abs err {err} (tolerance: bit for "
            f"bit, both add bf16 entries in ascending s in float32)")
        if not same:
            raise AssertionError(f"lut16_score ({dtype}) differs from its "
                                 f"twin by up to {ulp} ulp")
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
    for b, dtype in ((BATCH, torch.bfloat16), (AH_APPROX_B, torch.float32)):
        lb = luts[:b]
        k_ms, p_ms = turns(lambda: sk.lut16_score(lb, codes_t, dtype),
                           lambda: sk.lut16_score_reference(lb, codes_t,
                                                            dtype), 10, 2)
        # the kernel looks entries up and sums them: one float32 add per
        # table entry per column and query, as for the grouped scorer
        cols = codes_t.shape[1]
        ops = b * AH_S * cols
        nbytes = (codes_t.numel() + lb.numel() * 4
                  + b * cols * (2 if dtype == torch.bfloat16 else 4))
        b_ms, b_by = bound(ops, PEAK_F32, nbytes)
        score[b] = (k_ms, p_ms, b_ms, b_by)
        log(f"[15 kernel time] lut16_score: B={b}, {dtype}, columns {cols}, "
            f"L2 flushed: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms, bound by {b_by} ({ops} float32 adds, "
            f"{nbytes} bytes) -> {b_ms / k_ms:.3f} of the bound ({smi})")
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
    k_ms, p_ms, b_ms, b_by = score[BATCH]
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


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scann_tpu_torch``) on one GPU.

Drives the port's main path once at GloVe-100 shape: builds a tree-x-AH
index on the card over 1,183,514 x 100 seeded synthetic clustered vectors,
checks the CUDA grouped leaf-scoring kernel against its plain PyTorch twin
on the first batch's real inputs, serves 10 batches of 1024 queries through
``TreeXHybridSearcher.search_batched_tensors`` and holds recall@10 against
exact ground truth, then times the kernel, its twin and the search stages
with CUDA events.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (the kernel is built from
``scann_tpu_torch/csrc`` at first use). Exits non-zero, printing no result,
when there is no CUDA device or any phase fails. The line before the last
is the kernels' JSON record; the last line is the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N, D, CLUSTERS, SPREAD = 1_183_514, 100, 2000, 2.5
BATCH, BATCHES, K = 1024, 10, 10
P, PRE_K = 10, 100
RECALL_FLOOR = 0.9
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


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

    # -- 2. kernel build ---------------------------------------------------------
    t0 = time.perf_counter()
    native.load("tree_ah_grouped")
    build_kernel_s = time.perf_counter() - t0
    if "tree_ah_grouped" in native.build_logs:
        ptxas = [ln.split("ptxas info    :")[-1].strip() for ln in
                 native.build_logs["tree_ah_grouped"].splitlines()
                 if "registers" in ln]
        log(f"[2 kernel build] nvcc built tree_ah_grouped.cu for sm_90a in "
            f"{build_kernel_s:.2f}s; ptxas per instance: "
            f"{' | '.join(ptxas)}")
    else:
        log(f"[2 kernel build] loaded the library already built from this "
            f"source in {build_kernel_s:.2f}s")

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
    recall = recall_at_k(idx.cpu().numpy(), gt.cpu().numpy(), K)
    if tuple(idx.shape) != (BATCH * BATCHES, K) or bool((idx < 0).any()):
        raise AssertionError(f"bad result ids: shape {tuple(idx.shape)}")
    if not bool(torch.isfinite(dists).all()):
        raise AssertionError("non-finite result distances")
    if bool((dists[:, 1:] < dists[:, :-1]).any()):
        raise AssertionError("result distances not ascending")
    exact = ((queries[:, None, :] - db_dev[idx]) ** 2).sum(-1)
    dist_err = float(((dists - exact).abs() / exact.clamp_min(1e-6)).max())
    log(f"[6 search] {BATCHES} x B={BATCH}, p={P}, pre_k={PRE_K}, k={K}: "
        f"recall@10 {recall:.4f} (floor {RECALL_FLOOR}), kernel launches "
        f"{launches}, returned vs recomputed distances max rel err "
        f"{dist_err:.3g}, host wall {search_s:.3f}s")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall@10 {recall} < {RECALL_FLOOR}")
    if launches <= 0:
        raise AssertionError("the search never launched the CUDA kernel")
    if dist_err > 1e-3:
        raise AssertionError(f"returned distances off by {dist_err}")

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

    # plain, kernel, kernel, plain
    plain_ms = cold_ms(lambda: tag.tree_ah_grouped_scores_reference(
        *kargs, **kkw), 5)
    kernel_ms = cold_ms(lambda: tag.tree_ah_grouped_scores(*kargs, **kkw), 20)
    kernel_ms = (kernel_ms + cold_ms(
        lambda: tag.tree_ah_grouped_scores(*kargs, **kkw), 20)) / 2
    plain_ms = (plain_ms + cold_ms(lambda: tag.tree_ah_grouped_scores_reference(
        *kargs, **kkw), 5)) / 2
    log(f"[7 kernel time] grouped leaf scorer, L2 flushed: kernel "
        f"{kernel_ms:.4f} ms, plain twin {plain_ms:.4f} ms ({smi})")

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
    split = {}
    for label, fn in (("kernel", tag.tree_ah_grouped_scores),
                      ("plain", tag.tree_ah_grouped_scores_reference)):
        staged(q0, fn)
        rows = np.array([staged(queries[i * BATCH:(i + 1) * BATCH], fn)
                         for i in range(BATCHES)])
        split[label] = dict(zip(names, rows.mean(0).tolist()))
        log(f"[7 stages/{label}] per batch ms: " + ", ".join(
            f"{n} {v:.4f}" for n, v in split[label].items())
            + f", sum {rows.sum(1).mean():.4f}")
    e2e = []
    for rep in range(3):
        for i in range(BATCHES):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            qb = queries[i * BATCH:(i + 1) * BATCH]
            a.record()
            searcher.search_batched_tensors(qb, K, params)
            b.record()
            torch.cuda.synchronize()
            e2e.append(a.elapsed_time(b))
    med = float(np.median(e2e))
    log(f"[7 search time] search_batched_tensors, B={BATCH}, n={len(e2e)} "
        f"batches: median {med:.4f} ms, max {float(np.max(e2e)):.4f} ms -> "
        f"{BATCH / med * 1e3:.0f} queries/s at recall@10 {recall:.4f} "
        f"({smi})")

    print(json.dumps({"kernels": [{
        "name": "tree_ah_grouped",
        "route": "cuda",
        "source": "scann_tpu_torch/csrc/tree_ah_grouped.cu",
        "replaces": "scann_tpu/ops/tree_ah_grouped.py:86",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The fused small-database kernel's cluster form (#2,
``csrc/fused_bf.cu::fused_bf_cluster_kernel``) modelled on the CPU: its
launch plan (``ops/fused_bf.cluster_plan``), and its filtered selection and
cluster merge emulated lane by lane in numpy.

The emulation follows the kernel step for step: a query tile's rows split
into one contiguous range per CTA of the cluster, each range walked in
sub-chunks of ``8192 / q_tile`` rows; per sub-chunk a warp holds a query's
candidates as 64-bit (value bits, column) keys, lane ``l`` the rows
``l + 32 m``; a candidate survives below the running k-th key (while the
list is not full, at or below the k-th smallest of the 32 lanes' minima);
the list's keys and the survivors are compacted by ballots and each ranked
against all (ties by position), the key of rank j the new list's j-th; past
64 survivors the selection falls back to rounds (over 8 candidates a lane
at a time), each taking the smallest survivor (per-lane tree of minima, the
two 32-bit warp reductions) and inserting it with a shuffle up. Then each
CTA's lists are ranked against its peers' and the key of rank j goes to
slot j.

Tolerances: on integer-valued inputs every product and sum is exact in
float32, so the emulation equals the twin (``fused_bf_search_reference``)
bit for bit, values and ids, ties lowest column first. On random inputs it
is held to the Pallas kernel in interpret mode with the brute-force tests'
RTOL 1e-5 / ATOL 1e-4 (float32 sums in another order), ids equal away from
ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops.fused_bf_pallas import fused_bf_search_pallas
from scann_tpu_torch.ops import fused_bf as fb

NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
MASKED_HALF = np.float32(3.4e38) / np.float32(4.0)
RTOL, ATOL = 1e-5, 1e-4


def h100_like(q_tile, cluster, dk):
    """A capacity model of the H100 (two CTAs an SM where the stages are
    narrow, clusters of 16 scarce); the plan takes whatever the card
    reports."""
    per_sm = 2 if dk <= 64 else 1
    if cluster <= 8:
        return (per_sm * 132) // cluster
    return {16: 7 * per_sm}.get(cluster, (per_sm * 132) // (2 * cluster))


def portable_only(q_tile, cluster, dk):
    """A card that schedules no cluster past the portable 8."""
    return 132 // cluster if cluster <= 8 else 0


def one_cta_an_sm(q_tile, cluster, dk):
    return 132 // cluster


CAPACITIES = {"h100_like": h100_like, "portable_only": portable_only,
              "one_cta_an_sm": one_cta_an_sm}


@pytest.mark.parametrize("capacity", list(CAPACITIES))
@pytest.mark.parametrize("b", [1, 7, 8, 9, 100, 1024, 6400])
@pytest.mark.parametrize("n_valid", [0, 1, 5, 511, 10_000, 1_183_514])
def test_cluster_plan_covers_every_row_once(capacity, b, n_valid):
    cap = CAPACITIES[capacity]
    for d in (4, 13, 64, 100):
        plan = fb.cluster_plan(b, n_valid, d, 10, 132, cap)
        assert plan.q_tile in fb.Q_TILES
        assert 1 <= plan.cluster <= fb.MAX_CLUSTER
        dk = fb.slab_width(plan.q_tile, d)
        assert dk % 8 == 0 and dk >= min(d, fb.MAX_SLAB[plan.q_tile])
        assert cap(plan.q_tile, plan.cluster, dk) >= 1  # the cluster fits
        assert -(-b // plan.q_tile) <= 65535
        # CTA r takes [r * rows, min(n_valid, (r + 1) * rows)): the ranges
        # tile [0, n_valid) with no gap and no overlap
        ranges = [(min(n_valid, r * plan.rows_per_cta),
                   min(n_valid, (r + 1) * plan.rows_per_cta))
                  for r in range(plan.cluster)]
        covered = np.zeros(n_valid, np.int64)
        for lo, hi in ranges:
            covered[lo:hi] += 1
        assert (covered == 1).all()
        assert plan.rows_per_cta * plan.cluster >= n_valid
        # no CTA of the cluster is left without rows it could have had
        assert plan.rows_per_cta * (plan.cluster - 1) < max(n_valid, 1)


def test_cluster_plan_prefers_what_its_cost_model_says():
    """The chosen plan costs no more than any other that fits; the
    headline shape spreads over the card and the B=6400 shape takes the
    widest query tile (each row read fewest times)."""
    cap = h100_like
    for b, n, d in [(100, 10_000, 64), (6400, 10_000, 64),
                    (1024, 1_183_514, 100), (3, 20, 4)]:
        plan = fb.cluster_plan(b, n, d, 10, 132, cap)
        cost = fb.plan_cost(plan, b, n, d, 10, 132, cap)
        for q_tile in fb.Q_TILES:
            for cs in range(1, fb.MAX_CLUSTER + 1):
                other = fb.ClusterPlan(q_tile, cs, -(-n // cs))
                if (cap(q_tile, cs, fb.slab_width(q_tile, d)) < 1
                        or other.rows_per_cta * (cs - 1) >= n):
                    continue
                assert cost <= fb.plan_cost(other, b, n, d, 10, 132, cap)
    head = fb.cluster_plan(100, 10_000, 64, 10, 132, cap)
    assert -(-100 // head.q_tile) * head.cluster >= 66
    assert fb.cluster_plan(6400, 10_000, 64, 10, 132, cap).q_tile == 32
    with pytest.raises(ValueError, match="no plan"):
        fb.cluster_plan(0, 10, 4, 10, 132, cap)


# -- the kernel, lane by lane ----------------------------------------------


def _keys(vals, cols):
    """64-bit keys of float32 values >= 0 (or +inf: missing, the kNone
    key) and their columns."""
    bits = vals.astype(np.float32).view(np.uint32).astype(np.uint64)
    keys = (bits << np.uint64(32)) | cols.astype(np.uint64)
    return np.where(np.isinf(vals), NONE, keys)


CAP = 64


def select_rounds(cand, run, k, stats):
    """The fallback: rounds over the survivors (below the list's k-th key),
    each inserting the smallest survivor. ``cand`` [M, 32] keys (lane l's
    m-th candidate at [m, l]), ``run`` [32] the sorted list (lane j < k the
    j-th key, NONE past its end and on lanes >= k)."""
    lane = np.arange(32)
    run = run.copy()
    thr = run[k - 1]
    bits = cand < thr
    while bits.any():                                # __any_sync
        v = np.where(bits, cand, NONE)
        h = v.shape[0] // 2
        while h > 0:                                 # the tree of minima
            v = np.minimum(v[:h], v[h:2 * h])
            h //= 2
        best = v[0]
        hi = (best >> np.uint64(32)).min()           # __reduce_min_sync
        lo = np.where(best >> np.uint64(32) == hi,
                      best & np.uint64(0xFFFFFFFF), np.uint64(0xFFFFFFFF)
                      ).min()
        pick = (hi << np.uint64(32)) | lo
        assert pick < thr                            # every round inserts
        up = np.concatenate([run[:1], run[:-1]])     # __shfl_up_sync
        move = (lane < k) & (run > pick)
        run = np.where(move, np.where((lane > 0) & (up > pick), up, pick),
                       run)
        thr = run[k - 1]
        bits &= (cand > pick) & (cand < thr)
        stats["rounds"] += 1
    return run


def _ranks(keys):
    """Rank of each key among all (ties by position): 0 .. n - 1, once
    each."""
    pos = np.arange(len(keys))
    return ((keys[None, :] < keys[:, None])
            | ((keys[None, :] == keys[:, None])
               & (pos[None, :] < pos[:, None]))).sum(1)


SCRATCH = CAP + 16 + 16       # keys a query's selection: kScratch


def select_ranked(cand, run, k, stats, scr):
    """One query's selection on one sub-chunk (the kernel's
    select_ranked): ``cand`` [M, 32] keys, ``run`` [32] its list, ``scr``
    its kScratch words of the warp's rows of the distances (holding what
    the distances left there). Returns the new list."""
    lim = run[k - 1]
    if lim == NONE:
        lmin = cand.min(axis=0)                      # each lane's minimum
        scr[:32] = lmin
        r = _ranks(scr[:32])
        t = lmin[np.argmax(r == k - 1)]              # ballot, shuffle
        lim = NONE if t == NONE else t + np.uint64(1)
    bits = cand < lim
    s = int(bits.sum())                              # __reduce_add_sync
    if s == 0:
        stats["skipped"] += 1
        return run
    if s > CAP:
        stats["fallback"] += 1
        for h in range(0, len(cand), 8):             # 8 a lane a pass
            run = select_rounds(cand[h:h + 8], run, k, stats)
        return run
    stats["ranked"] += 1
    # the list's k keys, then the survivors in ballot order: slot m, lane
    total = k + s
    scr[:k] = run[:k]
    scr[k:total] = cand[bits]
    rank = _ranks(scr[:total])
    for i in range(total):
        if rank[i] < k:
            scr[CAP + 16 + rank[i]] = scr[i]
    new = np.full(32, NONE, np.uint64)
    new[:k] = scr[CAP + 16:CAP + 16 + k]
    return new


def select_warp(cands, runs, k, stats, scr):
    """A warp's selection of its queries on one sub-chunk, one query after
    the other, query u in scratch words u * kScratch .. of ``scr`` (the
    warp's rows of the distances seen as 64-bit words)."""
    runs = runs.copy()
    for u in range(len(cands)):
        runs[u] = select_ranked(cands[u], runs[u], k, stats,
                                scr[u * SCRATCH:(u + 1) * SCRATCH])
    return runs


def emulate_cluster_kernel(q, db, norms, n_valid, k, plan, stats=None):
    """(values [B, k] float32, ids [B, k] int32) as the cluster kernel
    computes them under ``plan``: every query of a tile, those past B as
    the zero rows the kernel stages for them, eight warps of QT / 8 queries
    each selecting in its own rows of the distances."""
    stats = stats if stats is not None else {}
    for key in ("rounds", "skipped", "fallback", "ranked"):
        stats.setdefault(key, 0)
    b = q.shape[0]
    qt = plan.q_tile
    qpw = qt // 8
    r_rows = fb.sub_chunk_rows(qt)
    m = r_rows // 32
    out_v = np.full((b, k), np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    for q0 in range(0, b, qt):
        tile = np.zeros((qt, q.shape[1]), np.float32)
        tile[:min(b, q0 + qt) - q0] = q[q0:q0 + qt]
        qsq = (tile ** 2).sum(1, dtype=np.float32)
        lists = np.full((plan.cluster, qt, k), NONE, np.uint64)
        for split in range(plan.cluster):
            begin = min(n_valid, split * plan.rows_per_cta)
            end = min(n_valid, begin + plan.rows_per_cta)
            runs = np.full((qt, 32), NONE, np.uint64)
            for r0 in range(begin, end, r_rows):
                rows = np.arange(r0, r0 + r_rows)
                inside = rows < end
                x = np.zeros((r_rows, db.shape[1]), np.float32)
                x[inside] = db[rows[inside]]
                xsq = np.where(inside, norms[np.minimum(rows, len(norms) - 1)],
                               np.float32(0))
                v = (qsq[:, None] + xsq[None, :]
                     - np.float32(2) * (tile @ x.T)).astype(np.float32)
                bad = ~inside[None, :] | ~(v < MASKED_HALF)
                ds = np.where(bad, np.float32(np.inf),
                              np.maximum(v, np.float32(0)))
                cand = _keys(ds, np.broadcast_to(rows, ds.shape))
                cand = cand.reshape(qt, m, 32)
                for w in range(8):
                    sl = slice(w * qpw, (w + 1) * qpw)
                    scr = ds[sl].copy().view(np.uint64).reshape(-1)
                    runs[sl] = select_warp(cand[sl], runs[sl], k, stats, scr)
            lists[split] = runs[:, :k]
        for t in range(min(b, q0 + qt) - q0):
            qi = q0 + t
            # the merge: cs lists of k keys, ranked with ties by position
            keys = lists[:, t].reshape(-1)
            rank = _ranks(keys)
            assert sorted(rank) == list(range(len(keys)))
            for key, r in zip(keys, rank):
                if r < k:
                    v = np.uint32(int(key) >> 32).view(np.float32)
                    ok = v < MASKED_HALF                 # NaN for NONE
                    out_v[qi, r] = v if ok else np.inf
                    out_i[qi, r] = int(key) & 0xFFFFFFFF if ok else -1
    return out_v, out_i


def _integer_case(rng, n, d, b):
    """Small integers: every distance exact in float32, many equal; rows
    duplicated and queries sitting on them."""
    db = rng.integers(0, 3, size=(n, d)).astype(np.float32)
    q = rng.integers(0, 3, size=(b, d)).astype(np.float32)
    db[n // 2:n // 2 + 5] = db[1]
    q[0] = db[1]
    norms = (db ** 2).sum(1).astype(np.float32)
    return q, db, norms


PLANS = [
    fb.ClusterPlan(16, 1, 700),    # one CTA a tile: no merge
    fb.ClusterPlan(16, 3, 234),    # a partial last range
    fb.ClusterPlan(16, 4, 175),
    fb.ClusterPlan(32, 16, 44),    # the widest cluster, ranges of 44 rows
    fb.ClusterPlan(16, 16, 44),    # as many CTAs as the tile has queries
    fb.ClusterPlan(32, 5, 140),
]


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "q{}c{}r{}".format(*p))
def test_emulated_kernel_equals_twin_bit_for_bit_on_ties(k, plan):
    """Integer-valued, tie-heavy rows with n_valid < N: the emulated kernel
    equals the twin in values and ids."""
    rng = np.random.default_rng(k * 100 + plan.cluster)
    n, n_valid = 700, 690
    q, db, norms = _integer_case(rng, n, 6, 11)
    plan = fb.ClusterPlan(plan.q_tile, plan.cluster,
                          max(plan.rows_per_cta, -(-n_valid // plan.cluster)))
    got_v, got_i = emulate_cluster_kernel(q, db, norms, n_valid, k, plan)
    want_v, want_i = fb.fused_bf_search_reference(
        torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(norms),
        n_valid, k)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())
    # equal values come out lowest column first (query 0 sits on row 1
    # and its five copies)
    same = got_v[:, 1:] == got_v[:, :-1]
    assert (got_i[:, 1:][same] > got_i[:, :-1][same]).all()
    assert got_v[0, 0] == 0 and got_i[0, 0] <= 1


@pytest.mark.parametrize("k", [1, 10, 16])
def test_emulated_kernel_fills_missing_slots(k):
    """k > n_valid: (inf, -1) past the valid rows, and rows >= n_valid never
    surface, with a cluster wider than the valid rows."""
    rng = np.random.default_rng(k)
    q, db, norms = _integer_case(rng, 40, 4, 5)
    for plan in (fb.ClusterPlan(16, 1, 3), fb.ClusterPlan(16, 3, 1),
                 fb.ClusterPlan(32, 16, 1)):
        got_v, got_i = emulate_cluster_kernel(q, db, norms, 3, k, plan)
        want_v, want_i = fb.fused_bf_search_reference(
            torch.from_numpy(q), torch.from_numpy(db),
            torch.from_numpy(norms), 3, k)
        np.testing.assert_array_equal(got_v, want_v.numpy())
        np.testing.assert_array_equal(got_i, want_i.numpy())
        assert (got_i[:, 3:] == -1).all() and np.isinf(got_v[:, 3:]).all()
    got_v, got_i = emulate_cluster_kernel(q, db, norms, 0, k,
                                          fb.ClusterPlan(16, 2, 1))
    assert (got_i == -1).all() and np.isinf(got_v).all()


@pytest.mark.parametrize("k", [1, 10, 16])
def test_emulated_kernel_matches_pallas(k):
    """Random float32 rows (several sub-chunks a CTA, a partial query
    tile, n_valid < N): the emulated kernel against the Pallas kernel in
    interpret mode, within RTOL / ATOL, ids equal away from ties; and the
    rounds stay near the keys that enter the lists."""
    rng = np.random.default_rng(7 + k)
    n, n_valid, d, b = 1500, 1490, 16, 13
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    norms = (db ** 2).sum(1).astype(np.float32)
    want_v, want_i = fused_bf_search_pallas(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(norms[None, :]),
        jnp.asarray([n_valid], jnp.int32), k=k, interpret=True)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    for plan in (fb.ClusterPlan(16, 2, 745), fb.ClusterPlan(32, 1, 1490)):
        stats = {"rounds": 0}
        got_v, got_i = emulate_cluster_kernel(q, db, norms, n_valid, k, plan,
                                              stats)
        np.testing.assert_allclose(got_v, want_v, rtol=RTOL, atol=ATOL)
        tol = ATOL + RTOL * np.abs(want_v)
        ext = np.concatenate([np.full((b, 1), -np.inf), want_v,
                              np.full((b, 1), np.inf)], 1)
        gap = np.minimum(ext[:, 1:-1] - ext[:, :-2], ext[:, 2:] - ext[:, 1:-1])
        strict = gap > tol
        np.testing.assert_array_equal(got_i[strict], want_i[strict])
        # random values: the lane minima bound the first sub-chunk's
        # survivors well, so no selection falls back to rounds
        assert stats["fallback"] == 0 and stats["rounds"] == 0
        assert stats["ranked"] >= b * plan.cluster


@pytest.mark.parametrize("k", [1, 10, 16])
def test_emulated_kernel_falls_back_to_rounds_on_sorted_rows(k):
    """Rows ordered by falling distance: every sub-chunk beats the list
    the one before left, more than 64 candidates survive, and the selection
    takes its rounds; still the twin's result bit for bit."""
    n, b = 1000, 3
    db = np.zeros((n, 4), np.float32)
    db[:, 0] = np.arange(n, 0, -1)          # distance (n - i)^2 from 0
    db[:, 1] = np.arange(n) % 2             # and ties between neighbours
    q = np.zeros((b, 4), np.float32)
    q[1, 1] = 1.0
    q[2, 0] = 500.0
    norms = (db ** 2).sum(1).astype(np.float32)
    for plan in (fb.ClusterPlan(16, 1, n), fb.ClusterPlan(32, 2, 500)):
        stats = {}
        got_v, got_i = emulate_cluster_kernel(q, db, norms, n - 3, k, plan,
                                              stats)
        want_v, want_i = fb.fused_bf_search_reference(
            torch.from_numpy(q), torch.from_numpy(db),
            torch.from_numpy(norms), n - 3, k)
        np.testing.assert_array_equal(got_v, want_v.numpy())
        np.testing.assert_array_equal(got_i, want_i.numpy())
        assert stats["fallback"] > 0 and stats["rounds"] > 0

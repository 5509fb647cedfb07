"""The float32 q-major block-min sweep (#4) as the fourth form of
``csrc/block_min_compact.cu``, on the CPU: its launch plan at r = 8, 128,
256 and 512 with runs that balance the persistent grid, the kernel's
top-1 reduction and its carry of a block over up to four 128-row tiles
emulated lane by lane against the port's twin and the Pallas kernel in
interpret mode, its q-major store map, and the routing between the two
kernels.

Tolerances:
  - plans, unit counts and store maps are counts: equal;
  - the emulated reduction on the twin's own float32 scores: equal to
    ``block_min_sweep_qmajor_reference``, values and offsets, on random and
    on integer-valued tie-heavy inputs (the lowest row among equal minima,
    as ``jnp.argmin``);
  - against the Pallas kernel in interpret mode: equal on integer-valued
    inputs (every sum exact); on random ones within the twin's 1e-5 * sum
    |terms| + 1e-5, Pallas's offsets reaching the emulation's minimum.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops import sweep_pallas as jsw
from scann_tpu_torch.ops import sweep as sw
from scann_tpu_torch.ops.distances import DistanceMeasure
from scann_tpu_torch.types import MAX_SHARED_MEMORY

# the block-sweep searcher's r = 512 call: 1,245,184 augmented rows of 104
MAIN = dict(n=1_245_184, b=128, d1=104, r=512)
TR, TQ = sw.COMPACT_TILE_ROWS, sw.COMPACT_TILE_Q
WGS = TQ // 64


def _inputs(seed, *, n, d, b, r, penalty, integer=False):
    """Augmented bf16 rows and queries as the searcher builds them (squared
    L2, the last rows masked) and an optional allowlist penalty; with
    ``integer`` small integer rows and queries, whose scores are exact and
    tie often."""
    rng = np.random.default_rng(seed)
    if integer:
        db = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        q = rng.integers(-1, 2, size=(b, d)).astype(np.float32)
    else:
        db = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    n_valid = n - 3 * min(r, 64) // 2
    measure = DistanceMeasure.SQUARED_L2
    aug = sw.build_augmented_db(db, n_valid, measure, tile_n=n)
    q_aug = sw._augment_queries(torch.from_numpy(q), measure, aug.shape[1])
    pen = None
    if penalty:
        pen = sw.build_allow_penalty(rng.random(n_valid) < 0.3, n, r)
    return q_aug, aug, pen


# -- the plan -----------------------------------------------------------------


def test_plan_at_the_main_shape():
    """B = 128, r = 512: one query tile, no cluster, seven stages, no
    staging; runs of 76 tiles (19 blocks) make 128 units for 132 SMs, so
    the busiest CTA walks 76 tiles where 73.7 is the even share (the
    halving rule of the other forms gives 64-tile runs, 152 units and 128
    tiles for the busiest: a 1.7x tail)."""
    plan = sw.sweep_plan("qmajor", **MAIN, int8_rows=False)
    assert plan == sw.CompactPlan(nks=8, stages=7, cluster=1, run_tiles=76,
                                  runs=128, q_tiles=1, units=128,
                                  smem_bytes=230_512)
    assert plan.smem_bytes == sw.sweep_smem_bytes("qmajor", 104, 512, 7, 76)
    n_tiles = MAIN["n"] // TR
    assert sw.busiest_cluster_tiles(n_tiles, 76, 1, 132) == 76
    assert sw.busiest_cluster_tiles(n_tiles, 64, 1, 132) == 128
    # no run of whole blocks does better: 2432 blocks over 132 CTAs
    assert 76 == 4 * -(-(n_tiles // 4) // 132)


@pytest.mark.parametrize("r", [8, 128, 256, 512])
@pytest.mark.parametrize("n,b", [(1_245_184, 128), (1_245_184, 24),
                                 (1_245_184, 300), (8192, 1), (65_536, 1000)])
@pytest.mark.parametrize("sms", [132, 8])
def test_plan_balances_the_grid(r, n, b, sms):
    plan = sw.sweep_plan("qmajor", n, b, 104, r, False, sms)
    assert plan is not None
    assert plan.smem_bytes <= MAX_SHARED_MEMORY
    assert plan.smem_bytes == sw.sweep_smem_bytes("qmajor", 104, r,
                                                  plan.stages, plan.run_tiles)
    assert plan.stages == 7                      # nothing staged
    per = max(1, r // TR)                        # tiles a block
    assert plan.run_tiles % per == 0
    assert plan.run_tiles <= 64 * r // TR
    n_tiles = -(-n // TR)
    q_groups = -(-plan.q_tiles // plan.cluster)
    assert plan.units == -(-n_tiles // plan.run_tiles) * q_groups
    clusters = sms // plan.cluster
    busiest = sw.busiest_cluster_tiles(n_tiles, plan.run_tiles, q_groups,
                                       clusters)
    # the fewest tiles any run of whole blocks leaves the busiest cluster,
    # and the longest run that does
    spans = {rt: sw.busiest_cluster_tiles(n_tiles, rt, q_groups, clusters)
             for rt in range(per, 64 * r // TR + 1, per)}
    assert busiest == min(spans.values())
    assert plan.run_tiles == max(rt for rt, v in spans.items()
                                 if v == busiest)
    # within one run (or one tile's blocks) of the even share
    assert busiest <= -(-n_tiles * q_groups // clusters) + plan.run_tiles


@pytest.mark.parametrize("n,b,d1,r,int8_rows", [
    (4096, 64, 104, 64, True),      # int8 rows
    (4096, 64, 104, 4, False),      # r < 8
    (8192, 64, 104, 1024, False),   # r > 512
    (4096, 64, 264, 64, False),     # wider than 16 k-steps
    (4096, 64, 100, 64, False),     # D1 not a multiple of 8
    (4096, 64, 104, 48, False),     # r not a power of two
])
def test_plan_rejects(n, b, d1, r, int8_rows):
    assert sw.sweep_plan("qmajor", n, b, d1, r, int8_rows) is None


def test_other_forms_keep_r_at_most_256():
    for form in ("compact", "rowmajor", "top2"):
        assert sw.sweep_plan(form, 8192, 64, 104, 512, False) is None
        assert sw.sweep_plan(form, 8192, 64, 104, 256, False) is not None


# -- the reduction, lane by lane ----------------------------------------------


def _lexmin(v, i, ov, oi):
    take = (ov < v) | ((ov == v) & (oi < i))
    return np.where(take, ov, v), np.where(take, oi, i)


def _exchange(v, ix, level):
    """The kernel's exchange() over the quad axis (-2, lanes t): of items
    (2p, 2p + 1) lane t keeps 2p + bit and receives the other lane's copy
    of it."""
    mask = 1 << level
    t = np.arange(4)
    bit = (t >> level) & 1
    outs_v, outs_i = [], []
    for p in range(v.shape[-1] // 2):
        keep = np.broadcast_to((2 * p + bit)[:, None], v.shape[:-1] + (1,))
        send = np.broadcast_to((2 * p + 1 - bit)[:, None],
                               v.shape[:-1] + (1,))
        kv, ki = (np.take_along_axis(x, keep, -1) for x in (v, ix))
        sv, si = (np.take_along_axis(x, send, -1) for x in (v, ix))
        nv, ni = _lexmin(kv, ki, sv[..., t ^ mask, :], si[..., t ^ mask, :])
        outs_v.append(nv)
        outs_i.append(ni)
    return np.concatenate(outs_v, -1), np.concatenate(outs_i, -1)


def _emulate_qmajor(scores: np.ndarray, b: int, r: int, plan):
    """The kernel's q-major epilogue on float32 scores [N, B], thread by
    thread: units in the persistent grid's order, each tile's accumulator
    as the m64n128 layout holds it (acc[4j + 2h + e] = query slot g + 8h,
    row 8j + 2t + e), the in-thread tree, the quad exchange, the carry of a
    block over r / 128 tiles (the earlier tile winning ties) and the stores
    from registers to [B, N/r]. Returns (minima, offsets, writes), writes
    counting the stores of each output."""
    n = scores.shape[0]
    n_tiles = -(-n // TR)
    s = np.zeros((n_tiles * TR, plan.q_tiles * TQ), np.float32)
    s[:n, :b] = scores
    nb = n // r
    out_v = np.full((b, nb), np.nan, np.float32)
    out_l = np.full((b, nb), -1, np.int64)
    writes = np.zeros((b, nb), np.int64)
    rt = min(r, TR)
    nbt, jb = TR // rt, rt // 8
    gb_size = 2 if nbt >= 2 else 1
    wg, w, g, t = np.meshgrid(np.arange(WGS), np.arange(4), np.arange(8),
                              np.arange(4), indexing="ij")
    qrow = 64 * wg + 16 * w + g                            # [WGS, 4, 8, 4]
    for u, rank in np.ndindex(plan.units, plan.cluster):
        run, qt = sw.compact_unit(plan, u)
        qt += rank
        if qt >= plan.q_tiles:      # multiplies zeros, stores nothing
            continue
        t0 = run * plan.run_tiles
        t1 = min(t0 + plan.run_tiles, n_tiles)
        carry_v = np.zeros(qrow.shape, np.float32)
        carry_i = np.zeros(qrow.shape, np.int64)
        for tile in range(t0, t1):
            tl = s[tile * TR:(tile + 1) * TR, qt * TQ:(qt + 1) * TQ]
            for gb in range(nbt // gb_size):
                vs, ixs = [], []
                for k in range(2 * gb_size):
                    bl, h = gb * gb_size + (k >> 1), k & 1
                    tv = [tl[8 * (bl * jb + m // 2) + 2 * t + m % 2,
                             qrow + 8 * h] for m in range(2 * jb)]
                    tm = [np.full_like(t, m) for m in range(2 * jb)]
                    step = 1
                    while step < 2 * jb:
                        for m in range(0, 2 * jb, 2 * step):
                            take = tv[m + step] < tv[m]
                            tv[m] = np.where(take, tv[m + step], tv[m])
                            tm[m] = np.where(take, tm[m + step], tm[m])
                        step *= 2
                    vs.append(tv[0])
                    ixs.append(8 * (tm[0] // 2) + tm[0] % 2 + 2 * t)
                v, ix = np.stack(vs, -1), np.stack(ixs, -1)
                if gb_size == 2:
                    v, ix = _exchange(v, ix, 0)
                    v, ix = _exchange(v, ix, 1)
                    item, writer = t, np.ones_like(t, bool)
                else:
                    v, ix = _exchange(v, ix, 0)
                    lanes = np.arange(4) ^ 2
                    v, ix = _lexmin(v, ix, v[..., lanes, :],
                                    ix[..., lanes, :])
                    item, writer = t & 1, t < 2
                val, off = v[..., 0], ix[..., 0]
                bl = gb * gb_size + (item >> 1)
                q = qrow + 8 * (item & 1)
                blk = (tile - t0) * nbt + bl
                if r > TR:          # a block over r / 128 tiles
                    per, part = r // TR, (tile - t0) % (r // TR)
                    blk = np.full_like(blk, (tile - t0) // per)
                    take = (val < carry_v) | (part == 0)
                    carry_v = np.where(take, val, carry_v)
                    carry_i = np.where(take, off + part * TR, carry_i)
                    if part != per - 1:
                        continue
                    val, off = carry_v, carry_i
                gblk = t0 * TR // r + blk
                gq = qt * TQ + q
                ok = writer & (gq < b) & (gblk < nb)
                out_v[gq[ok], gblk[ok]] = val[ok]
                out_l[gq[ok], gblk[ok]] = off[ok]
                np.add.at(writes, (gq[ok], gblk[ok]), 1)
    return out_v, out_l, writes


def _twin_scores(q_aug, aug, r, pen):
    """The twin's own float32 scores [N, B] (sw._block_scores)."""
    parts = [s3.reshape(-1, s3.shape[-1])
             for _, s3 in sw._block_scores(q_aug, aug, r, pen)]
    return torch.cat(parts).numpy()


@pytest.mark.parametrize("r", [8, 64, 128, 256, 512])
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("n_blocks,b,sms", [(9, 70, 132), (6, 300, 4),
                                            (5, 24, 8)])
def test_emulated_reduction_equals_twin(r, penalty, integer, n_blocks, b,
                                        sms):
    """B = 24, 70 or 300 (a CTA past B, clusters of 1 and 2), a last tile
    of 32 rows where r allows, runs of one block and of several: the
    lane-level emulation equals the twin's minima and offsets exactly, and
    writes each (query, block) once."""
    n = n_blocks * max(r, TR) - (32 if r <= 32 else 0)
    n -= n % r
    q_aug, aug, pen = _inputs(r + b + n_blocks, n=n, d=40, b=b, r=r,
                              penalty=penalty, integer=integer)
    plan = sw.sweep_plan("qmajor", n, b, aug.shape[1], r, False, sms=sms)
    got_v, got_l, writes = _emulate_qmajor(_twin_scores(q_aug, aug, r, pen),
                                           b, r, plan)
    want_v, want_l = sw.block_min_sweep_qmajor_reference(q_aug, aug, r=r,
                                                         penalty=pen)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_l, want_l.numpy())
    assert (writes == 1).all()
    rep = sw.check_against_twin(
        "qmajor", (torch.from_numpy(got_v), torch.from_numpy(got_l)), q_aug,
        aug, r=r, penalty=pen)
    assert rep["loc_equal"] == 1.0 and rep["max_abs_err"] == 0.0


def test_four_tile_carry_takes_the_earliest_tile_on_ties():
    """A block of 512 rows whose minimum appears in tiles 1, 2 and 3 (and a
    larger value in tile 0): the carry keeps tile 1's row; where every
    tile holds the same value, tile 0's."""
    r, b = 512, 8
    scores = np.full((2 * r, b), 5.0, np.float32)
    scores[0:128, 0] = 9.0
    for tile, row in ((1, 7), (2, 3), (3, 0)):
        scores[tile * TR + row, 0] = 1.0
    scores[r + 300, 1] = -2.0                 # block 1, tile 2, row 44
    plan = sw.sweep_plan("qmajor", 2 * r, b, 40, r, False, sms=132)
    v, l, writes = _emulate_qmajor(scores, b, r, plan)
    assert v[0, 0] == 1.0 and l[0, 0] == TR + 7
    assert v[1, 1] == -2.0 and l[1, 1] == 300
    assert (l[2:, 0] == 0).all() and (v[2:, 0] == 5.0).all()
    assert (writes == 1).all()


@pytest.mark.parametrize("r", [8, 128, 512])
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("integer", [False, True])
def test_emulated_reduction_matches_pallas(r, penalty, integer):
    """Against the Pallas kernel in interpret mode, at the batch its
    interpret mode runs (B = 8, N a multiple of 128 r): equal on
    integer-valued inputs; on random ones within the summation tolerance,
    Pallas's offsets reaching the emulation's minimum, the emulation's the
    lowest reaching its own."""
    n = 128 * r
    q_aug, aug, pen = _inputs(5 * r, n=n, d=24, b=8, r=r, penalty=penalty,
                              integer=integer)
    plan = sw.sweep_plan("qmajor", n, 8, aug.shape[1], r, False, sms=8)
    scores = _twin_scores(q_aug, aug, r, pen)
    got_v, got_l, _ = _emulate_qmajor(scores, 8, r, plan)

    def jax_of(x):
        return None if x is None else jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16)

    jv, jl = jsw.block_min_sweep_qmajor_pallas(
        jax_of(q_aug), jax_of(aug), r=r, interpret=True, compact=False,
        penalty=jax_of(pen))
    jv, jl = np.asarray(jv), np.asarray(jl).astype(np.int64)
    s3 = scores.T.reshape(8, -1, r)
    np.testing.assert_array_equal(got_l, s3.argmin(-1))
    if integer:
        np.testing.assert_array_equal(got_v, jv)
        np.testing.assert_array_equal(got_l, jl)
    else:
        tol = 1e-5 * np.abs(s3).max(-1) + 1e-5
        assert (np.abs(got_v - jv) <= tol).all()
        reached = np.take_along_axis(s3, jl[..., None], -1)[..., 0]
        assert (np.abs(reached - got_v) <= tol).all()


# -- routing ------------------------------------------------------------------


@pytest.fixture
def stub_card(monkeypatch):
    """The card's pieces stubbed (meta tensors, recording kernel entries)."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return lambda: fn

    monkeypatch.setattr(sw, "on_card", lambda t, fn_name: True)
    monkeypatch.setattr(sw, "_compact_kernel_fn", entry("block_min_compact"))
    monkeypatch.setattr(sw, "_kernel_fn", entry("block_min_sweep"))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    sw.reset_launches()
    yield calls
    sw.reset_launches()


@pytest.mark.parametrize("r,penalty", [(512, False), (512, True),
                                       (256, False), (8, True)])
def test_qmajor_calls_take_the_wgmma_kernel(stub_card, r, penalty):
    n, b, d1 = 8192, 130, 104
    q_aug = torch.empty(b, d1, dtype=torch.bfloat16, device="meta")
    aug = torch.empty(n, d1, dtype=torch.bfloat16, device="meta")
    pen = (torch.empty(n // r, r, dtype=torch.bfloat16, device="meta")
           if penalty else None)
    vals, locs = sw.block_min_sweep_qmajor(q_aug, aug, r=r, penalty=pen)
    assert (vals.dtype, locs.dtype) == (torch.float32, torch.int32)
    assert tuple(vals.shape) == tuple(locs.shape) == (b, n // r)
    (kernel, args), = stub_card
    plan = sw.sweep_plan("qmajor", n, b, d1, r, False)
    assert kernel == "block_min_compact"
    assert args[5:13] == (n, b, d1, r, plan.stages, plan.run_tiles,
                          plan.cluster, sw.SWEEP_FORMS.index("qmajor"))
    assert (args[2] is not None) == penalty
    assert args[13] is None and args[14] is None
    assert sw.LAUNCHES["block_min_qmajor"] == 1
    assert sw.LAUNCHES_BY_KERNEL["block_min_qmajor"] == {
        "block_min_compact": 1, "block_min_sweep": 0}


@pytest.mark.parametrize("dtype,r", [(torch.int8, 512), (torch.bfloat16, 4),
                                     (torch.bfloat16, 1024)])
def test_qmajor_calls_outside_the_plan_stay_on_the_old_kernel(stub_card,
                                                              dtype, r):
    n, b, d1 = 8192, 130, 104
    q_aug = torch.empty(b, d1, dtype=torch.bfloat16, device="meta")
    aug = torch.empty(n, d1, dtype=dtype, device="meta")
    sw.block_min_sweep_qmajor(q_aug, aug, r=r)
    assert [c[0] for c in stub_card] == ["block_min_sweep"]
    assert sw.LAUNCHES_BY_KERNEL["block_min_qmajor"] == {
        "block_min_compact": 0, "block_min_sweep": 1}

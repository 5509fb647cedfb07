"""The Python side of the compact q-major block-min kernel
(``csrc/block_min_compact.cu``, #5), on the CPU: its launch plan, the query
image it reads as wgmma's A operand, the rows' 128-byte swizzled TMA boxes
read through the B descriptor, the per-thread block reduction emulated
lane by lane against the port's twin and the Pallas kernel in interpret
mode, and the routing between the two compact kernels.

Tolerances:
  - images, boxes and fragments are copies: equal;
  - the product of the emulated operands against ``q_aug @ rows.T`` in
    float32: the twin's 1e-5 * sum |terms| + 1e-5 (summation order);
  - the emulated reduction on given float32 scores: equal to the lowest-row
    argmin of those scores, values rounded once to bf16; against the twin
    through ``check_against_twin("compact")``; against the Pallas kernel
    within 1 bf16 ulp, its offsets reaching the minimum (as
    tests/test_torch_sweep.py holds the twin to it).
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

MAIN = dict(n=1_187_840, b=1024, d1=104, r=64)
# the kernel's tiles: rows (the wgmma N), queries (64 a warpgroup)
TR, TQ = sw.COMPACT_TILE_ROWS, sw.COMPACT_TILE_Q
WGS = TQ // 64


def _inputs(seed, *, n, d, b, r, penalty, n_valid=None):
    """Augmented bf16 rows, queries and an optional allowlist penalty, as
    the searcher builds them (squared L2, padded rows masked)."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    n_valid = n - 3 * r // 2 if n_valid is None else n_valid
    measure = DistanceMeasure.SQUARED_L2
    aug = sw.build_augmented_db(db, n_valid, measure, tile_n=n)
    q_aug = sw._augment_queries(torch.from_numpy(q), measure, aug.shape[1])
    pen = None
    if penalty:
        pen = sw.build_allow_penalty(rng.random(n_valid) < 0.3, n, r)
    return q_aug, aug, pen


# -- the plan -----------------------------------------------------------------


def test_plan_at_the_main_shape():
    """bf16 rows, r = 64, D1 = 104, B = 1024: 8 k-steps (two 64-column
    boxes), six stages, clusters of 2 CTAs, runs of 32 tiles of 128 rows
    (64 blocks a query), 290 runs x 4 groups of 2 query tiles of 128."""
    plan = sw.compact_plan(**MAIN, int8_rows=False)
    assert plan == sw.CompactPlan(nks=8, stages=6, cluster=2, run_tiles=32,
                                  runs=290, q_tiles=8, units=1160,
                                  smem_bytes=226_400)
    assert plan.smem_bytes == sw.compact_smem_bytes(104, 64, 6, 32)
    # by run, the query-tile group fastest: the 66 clusters' first units
    # cover runs 0..16, each run's four groups side by side
    assert [sw.compact_unit(plan, u) for u in range(6)] == [
        (0, 0), (0, 2), (0, 4), (0, 6), (1, 0), (1, 2)]
    first = {sw.compact_unit(plan, c)[0] for c in range(sw.H100_SMS // 2)}
    assert first == set(range(17))


@pytest.mark.parametrize("r", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("d1", [8, 104, 136, 256])
@pytest.mark.parametrize("n,b", [(1_187_840, 1024), (4096 + 256, 1),
                                 (4096, 1000)])
def test_plan_accepts_bf16_rows(r, d1, n, b):
    plan = sw.compact_plan(n, b, d1, r, int8_rows=False)
    assert plan is not None
    assert plan.smem_bytes <= MAX_SHARED_MEMORY
    assert plan.smem_bytes == sw.compact_smem_bytes(d1, r, plan.stages,
                                                    plan.run_tiles)
    assert 2 <= plan.stages <= 8 and plan.nks == 4 * -(-d1 // 64)
    n_tiles = -(-n // TR)
    assert plan.runs == -(-n_tiles // plan.run_tiles)
    assert plan.q_tiles == -(-b // TQ)
    assert plan.cluster == (2 if plan.q_tiles >= 2 else 1)
    assert plan.units == plan.runs * -(-plan.q_tiles // plan.cluster)
    # at most 64 blocks a query staged; whole blocks in a run
    assert plan.run_tiles * TR // r <= 64
    assert plan.run_tiles * TR % r == 0


@pytest.mark.parametrize("n,b,d1,r,int8_rows", [
    (4096, 64, 104, 64, True),      # int8 rows
    (4096, 64, 104, 4, False),      # r < 8
    (4096, 64, 104, 1, False),
    (4096, 64, 104, 512, False),    # not a compact block
    (4096, 64, 264, 64, False),     # wider than 16 k-steps
    (4096, 64, 100, 64, False),     # D1 not a multiple of 8
    (4096 + 32, 64, 104, 64, False),  # N not a multiple of r
    (4096, 64, 104, 48, False),     # r not a power of two
])
def test_plan_rejects(n, b, d1, r, int8_rows):
    assert sw.compact_plan(n, b, d1, r, int8_rows) is None


def test_plan_spreads_small_calls():
    """A call with few units shortens the runs until it fills the grid,
    down to one block (two tiles at r = 256)."""
    plan = sw.compact_plan(4096, 64, 104, 64, False)
    assert plan.run_tiles == 1 and plan.units == 32
    plan = sw.compact_plan(4096, 64, 104, 256, False)
    assert plan.run_tiles == 2 and plan.units == 16


# -- the operands -------------------------------------------------------------


def _a_from_image(img: np.ndarray, b_pad: int, nks: int) -> np.ndarray:
    """[b_pad, 16 nks] int16 read from the query image through the A
    fragment map: thread (wg, w, lane = 4g + t) of query tile qt, k-step
    ks, register i, half e holds query 64 wg + 16 w + g + 8 (i & 1) at
    dimension 16 ks + 2t + 8 (i >> 1) + e."""
    qt, wg, ks, w, g, t, i, e = np.meshgrid(
        np.arange(b_pad // TQ), np.arange(WGS), np.arange(nks),
        np.arange(4), np.arange(8), np.arange(4), np.arange(4), np.arange(2),
        indexing="ij")
    lane = 4 * g + t
    off = (((qt * WGS + wg) * nks + ks) * 2048 + (w * 32 + lane) * 16
           + i * 4 + e * 2)
    q = qt * TQ + 64 * wg + 16 * w + g + 8 * (i & 1)
    k = 16 * ks + 2 * t + 8 * (i >> 1) + e
    a = np.full((b_pad, 16 * nks), -1, np.int32)
    a[q, k] = img[off // 2]
    return a


@pytest.mark.parametrize("b,d1", [(5, 104), (130, 8), (128, 136), (70, 256)])
def test_query_image_is_the_a_fragment_map(b, d1):
    rng = np.random.default_rng(b + d1)
    q_aug = torch.from_numpy(rng.normal(size=(b, d1)).astype(
        np.float32)).to(torch.bfloat16)
    img = sw.block_min_compact_query_image(q_aug).view(torch.int16).numpy()
    nks, b_pad = 4 * -(-d1 // 64), -(-b // TQ) * TQ
    assert img.size * 2 == (b_pad // TQ) * WGS * nks * 2048
    want = np.zeros((b_pad, 16 * nks), np.int16)
    want[:b, :d1] = q_aug.view(torch.int16).numpy()
    np.testing.assert_array_equal(_a_from_image(img, b_pad, nks), want)


def _tma_box(rows: np.ndarray, tile: int, d1: int) -> np.ndarray:
    """One ring stage as TMA fills it: ceil(D1 / 64) boxes of the 2-D map
    {D1, N} (row pitch 2 D1 bytes), box b at (64 b, TR tile), each TR rows
    x 128 bytes in the 128-byte swizzle: the 16-byte chunk c of row n
    lands at chunk c ^ (n % 8); zero past D1 and past N. int16."""
    n = rows.shape[0]
    boxes = -(-d1 // 64)
    stage = np.zeros(boxes * TR * 64, np.int16)
    bx, rr, k = np.meshgrid(np.arange(boxes), np.arange(TR), np.arange(64),
                            indexing="ij")
    row, col = TR * tile + rr, 64 * bx + k
    ok = (row < n) & (col < d1)
    byte = (bx * TR * 128 + rr * 128 + ((k // 8) ^ (rr % 8)) * 16
            + (k % 8) * 2)
    stage[byte[ok] // 2] = rows[row[ok], col[ok]]
    return stage


def _b_from_stage(stage: np.ndarray, nks: int) -> np.ndarray:
    """[TR rows, 16 nks] read through the kernel's sw128_desc(stage +
    128 TR (s // 4) + 32 (s % 4)) for k-step s: the linear address start +
    1024 (n // 8) (sbo) + 128 (n % 8) + 2 k, then the 128-byte swizzle on
    the address (bits 4-6 ^= bits 7-9)."""
    n, k = np.meshgrid(np.arange(TR), np.arange(16 * nks), indexing="ij")
    s = k // 16
    lin = ((s // 4) * TR * 128 + (s % 4) * 32 + (n // 8) * 1024
           + (n % 8) * 128 + (k % 16) * 2)
    return stage[(lin ^ (((lin >> 7) & 7) << 4)) // 2]


@pytest.mark.parametrize("n,b,d1", [(300, 5, 104), (256, 130, 8),
                                    (200, 64, 136), (128, 3, 256)])
def test_tma_box_through_the_descriptors_gives_the_product(n, b, d1):
    """The emulated operands are copies of the rows and queries (zero past
    N, B and D1), and their product is q_aug @ rows.T."""
    rng = np.random.default_rng(n + b + d1)
    rows = torch.from_numpy(rng.normal(size=(n, d1)).astype(
        np.float32)).to(torch.bfloat16)
    q_aug = torch.from_numpy(rng.normal(size=(b, d1)).astype(
        np.float32)).to(torch.bfloat16)
    nks, b_pad = 4 * -(-d1 // 64), -(-b // TQ) * TQ
    a = _a_from_image(
        sw.block_min_compact_query_image(q_aug).view(torch.int16).numpy(),
        b_pad, nks).astype(np.int16)
    a_bf = torch.from_numpy(a).view(torch.bfloat16).float()
    rows_i16 = rows.view(torch.int16).numpy()
    want = (q_aug.float() @ rows.float().T).numpy()
    tol = (q_aug.float().abs() @ rows.float().abs().T).numpy() * 1e-5 + 1e-5
    for tile in range(-(-n // TR)):
        b_img = _b_from_stage(_tma_box(rows_i16, tile, d1), nks)
        lo, hi = TR * tile, min(TR * tile + TR, n)
        want_b = np.zeros((TR, 16 * nks), np.int16)
        want_b[:hi - lo, :d1] = rows_i16[lo:hi]
        np.testing.assert_array_equal(b_img, want_b)
        b_bf = torch.from_numpy(b_img.copy()).view(torch.bfloat16).float()
        got = (a_bf @ b_bf.T).numpy()
        assert (np.abs(got[:b, :hi - lo] - want[:, lo:hi])
                <= tol[:, lo:hi]).all()
        assert not got[b:].any() and not got[:, hi - lo:].any()


# -- the reduction, lane by lane ----------------------------------------------


def _lexmin(v, i, ov, oi):
    take = (ov < v) | ((ov == v) & (oi < i))
    return np.where(take, ov, v), np.where(take, oi, i)


def _exchange(v, ix, level):
    """The kernel's exchange() over the quad axis (-2, lanes t): of items
    (2p, 2p + 1) lane t keeps 2p + bit and receives the other lane's copy
    of it (lane t ^ mask sends 2p + 1 - its bit)."""
    mask = 1 << level
    t = np.arange(4)
    bit = (t >> level) & 1
    outs_v, outs_i = [], []
    for p in range(v.shape[-1] // 2):
        keep = 2 * p + bit                          # [4]
        send = 2 * p + 1 - bit
        kv = np.take_along_axis(v, np.broadcast_to(keep[:, None],
                                                   v.shape[:-1] + (1,)), -1)
        ki = np.take_along_axis(ix, np.broadcast_to(keep[:, None],
                                                    v.shape[:-1] + (1,)), -1)
        sv = np.take_along_axis(v, np.broadcast_to(send[:, None],
                                                   v.shape[:-1] + (1,)), -1)
        si = np.take_along_axis(ix, np.broadcast_to(send[:, None],
                                                    v.shape[:-1] + (1,)), -1)
        rv, ri = sv[..., t ^ mask, :], si[..., t ^ mask, :]
        nv, ni = _lexmin(kv, ki, rv, ri)
        outs_v.append(nv)
        outs_i.append(ni)
    return np.concatenate(outs_v, -1), np.concatenate(outs_i, -1)


def _emulate_kernel(scores: np.ndarray, b: int, r: int, plan):
    """The kernel's epilogue and stores on float32 scores [N, B], thread by
    thread: units in order, each tile's accumulator as the m64n64 layout
    holds it (acc[4j + 2h + e] = query slot g + 8h, row 8j + 2t + e), the
    in-thread tree, the quad exchange, the carry of a block over r / 64
    tiles, the staging and the clipped stores. Returns (float32 minima,
    offsets) [B, N/r]."""
    n = scores.shape[0]
    n_tiles = -(-n // TR)
    s = np.zeros((n_tiles * TR, plan.q_tiles * TQ), np.float32)
    s[:n, :b] = scores
    nb = n // r
    out_v = np.full((b, nb), np.nan, np.float32)
    out_l = np.full((b, nb), -1, np.int64)
    rt = min(r, TR)
    nbt, jb = TR // rt, rt // 8
    gb_size = 2 if nbt >= 2 else 1
    blocks = plan.run_tiles * TR // r
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
        st_v = np.zeros((TQ, blocks), np.float32)
        st_l = np.zeros((TQ, blocks), np.int64)
        carry_v = np.zeros(qrow.shape, np.float32)
        carry_i = np.zeros(qrow.shape, np.int64)
        for tile in range(t0, t1):
            tl = s[tile * TR:(tile + 1) * TR, qt * TQ:(qt + 1) * TQ]
            for gb in range(nbt // gb_size):
                vs, ixs = [], []
                for k in range(2 * gb_size):
                    bl, h = gb * gb_size + (k >> 1), k & 1
                    # values m = 2 jj + e as a tree, the lower half of a
                    # pair winning ties
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
                v = np.stack(vs, -1)
                ix = np.stack(ixs, -1)
                if gb_size == 2:
                    v, ix = _exchange(v, ix, 0)
                    v, ix = _exchange(v, ix, 1)
                    item, writer = t, np.ones_like(t, bool)
                else:
                    v, ix = _exchange(v, ix, 0)
                    lanes = np.arange(4) ^ 2
                    v, ix = _lexmin(v, ix, v[..., lanes, :], ix[..., lanes, :])
                    item, writer = t & 1, t < 2
                val, off = v[..., 0], ix[..., 0]
                bl = gb * gb_size + (item >> 1)
                q = qrow + 8 * (item & 1)
                blk = (tile - t0) * nbt + bl
                if r > TR:          # a block over r / 64 tiles
                    per, part = r // TR, (tile - t0) % (r // TR)
                    blk = np.full_like(blk, (tile - t0) // per)
                    take = (val < carry_v) | (part == 0)
                    carry_v = np.where(take, val, carry_v)
                    carry_i = np.where(take, off + part * TR, carry_i)
                    if part != per - 1:
                        continue
                    val, off = carry_v, carry_i
                st_v[q[writer], blk[writer]] = val[writer]
                st_l[q[writer], blk[writer]] = off[writer]
        blk0 = t0 * TR // r
        here = min(blocks, nb - blk0)
        qs = qt * TQ + np.arange(TQ)
        ok = qs < b
        out_v[qs[ok], blk0:blk0 + here] = st_v[ok, :here]
        out_l[qs[ok], blk0:blk0 + here] = st_l[ok, :here]
    return out_v, out_l


def _float_scores(q_aug, aug, pen):
    s = (aug.float() @ q_aug.float().T).numpy()
    if pen is not None:
        s = s + pen.float().reshape(-1)[:, None].numpy()
    return s


def _lowest_argmin(scores, r):
    s3 = scores.T.reshape(scores.shape[1], -1, r)            # [B, N/r, r]
    return s3.min(-1), s3.argmin(-1)


@pytest.mark.parametrize("r", [8, 16, 64, 128, 256])
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("n,b,sms", [(1024 + 256, 70, 132), (2560, 300, 4),
                                     (1280, 600, 8)])
def test_emulated_reduction_matches_twin(r, penalty, n, b, sms):
    """B not a multiple of 64, a last tile of 32 rows where r allows, runs
    of one tile (132 SMs) and of several (4, 8), clusters of 1 and 2 CTAs
    (B = 600: a CTA past B): the lane-level emulation gives the lowest-row
    argmin of the same float32 scores exactly, and passes the twin's
    compact check."""
    if r <= 32:
        n = n - 32          # not a multiple of the 64-row tile
    q_aug, aug, pen = _inputs(r + b, n=n, d=40, b=b, r=r, penalty=penalty)
    plan = sw.compact_plan(n, b, aug.shape[1], r, False, sms=sms)
    scores = _float_scores(q_aug, aug, pen)
    got_v, got_l = _emulate_kernel(scores, b, r, plan)
    want_v, want_l = _lowest_argmin(scores, r)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_l, want_l)
    vals = torch.from_numpy(got_v).to(torch.bfloat16)
    locs = torch.from_numpy(got_l.astype(np.uint8))
    sw.check_against_twin("compact", (vals, locs), q_aug, aug, r=r,
                          penalty=pen)
    tv, tl = sw.block_min_sweep_qmajor_reference(q_aug, aug, r=r,
                                                 compact=True, penalty=pen)
    assert (sw._bf16_order(vals) - sw._bf16_order(tv)).abs().max() <= 1


@pytest.mark.parametrize("r", [8, 64, 256])
@pytest.mark.parametrize("penalty", [False, True])
def test_emulated_reduction_matches_pallas(r, penalty):
    """Against the Pallas kernel in interpret mode, at the batch the
    q-major kernel's interpret mode runs (B = 8, N a multiple of 128 r):
    values within 1 bf16 ulp, Pallas's offsets reaching the emulation's
    minimum, the emulation's offsets the lowest reaching it."""
    n = 128 * r * (2 if r < 256 else 1)
    q_aug, aug, pen = _inputs(3 * r, n=n, d=24, b=8, r=r, penalty=penalty)
    plan = sw.compact_plan(n, 8, aug.shape[1], r, False, sms=8)
    scores = _float_scores(q_aug, aug, pen)
    got_v, got_l = _emulate_kernel(scores, 8, r, plan)

    def jax_of(x):
        return None if x is None else jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16)

    jv, jl = jsw.block_min_sweep_qmajor_pallas(
        jax_of(q_aug), jax_of(aug), r=r, interpret=True, compact=True,
        penalty=jax_of(pen))
    jax_v = torch.from_numpy(np.array(jv).view(np.int16)).view(torch.bfloat16)
    vals = torch.from_numpy(got_v).to(torch.bfloat16)
    assert (sw._bf16_order(vals) - sw._bf16_order(jax_v)).abs().max() <= 1
    s3 = scores.T.reshape(8, -1, r)
    jax_l = np.asarray(jl).astype(np.int64)
    reached = np.take_along_axis(s3, jax_l[..., None], -1)[..., 0]
    tol = 1e-5 * np.abs(s3).max(-1) + 1e-5
    assert (np.abs(reached - got_v) <= tol).all()
    np.testing.assert_array_equal(got_l, s3.argmin(-1))


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("d1,r,int8_rows,want", [
    (104, 64, False, "block_min_compact"),
    (8, 8, False, "block_min_compact"),
    (256, 256, False, "block_min_compact"),
    (136, 32, False, "block_min_compact"),
    (104, 64, True, "block_min_sweep"),    # int8 rows
    (104, 4, False, "block_min_sweep"),    # r < 8
    (104, 1, False, "block_min_sweep"),
    (264, 64, False, "block_min_sweep"),   # wider than the registers hold
])
def test_compact_calls_route_by_the_plan(monkeypatch, d1, r, int8_rows,
                                         want):
    """Through the public wrapper, with the card's pieces stubbed (meta
    tensors, a recording kernel entry): the plan's calls launch the wgmma
    kernel with its stages and run length, the rest the mma.sync kernel;
    either counts one block_min_qmajor_compact launch."""
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
    n, b = 4096, 200
    dtype = torch.int8 if int8_rows else torch.bfloat16
    aug = torch.empty(n, d1, dtype=dtype, device="meta")
    q_aug = torch.empty(b, d1, dtype=torch.bfloat16, device="meta")
    sw.reset_launches()
    vals, locs = sw.block_min_sweep_qmajor(q_aug, aug, r=r, compact=True)
    assert vals.dtype == torch.bfloat16 and locs.dtype == torch.uint8
    assert tuple(vals.shape) == (b, n // r)
    assert [c[0] for c in calls] == [want]
    assert sw.LAUNCHES["block_min_qmajor_compact"] == 1
    assert sw.COMPACT_LAUNCHES == {
        "block_min_compact": int(want == "block_min_compact"),
        "block_min_sweep": int(want == "block_min_sweep")}
    if want == "block_min_compact":
        plan = sw.compact_plan(n, b, d1, r, False)
        assert calls[0][1][5:12] == (n, b, d1, r, plan.stages,
                                     plan.run_tiles, plan.cluster)
    # the float32 q-major form routes by its own plan, which takes these
    # calls where the compact plan does
    calls.clear()
    sw.block_min_sweep_qmajor(q_aug, aug, r=r, compact=False)
    assert [c[0] for c in calls] == [want]
    assert (sw.sweep_plan("qmajor", n, b, d1, r, int8_rows) is None) == (
        want == "block_min_sweep")

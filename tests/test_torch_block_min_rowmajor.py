"""The row-major epilogues of ``csrc/block_min_compact.cu`` on the CPU: the
row-major top-1 (#3) and the top-2 tournament (#6). Their plans and
shared-memory counts, the routing of each call to one of the two block-min
kernels, the top-2 form's permuted view of the rows (a 5-D TMA box that
gives each thread 32 consecutive rows), the epilogues emulated lane by lane
in the kernel's own order (top-2: row bits 0 to 4 in the thread, bit 5 by a
shuffle exchange, bit 6 by a last shuffle, the carry of a block over two
tiles at r = 256) against the port's twins and the Pallas kernels in
interpret mode, and the row-major store map.

Tolerances:
  - on given float32 scores the emulated top-2 equals ``_tournament2`` and
    the emulated top-1 the lowest-row argmin exactly (values and offsets),
    on tie-heavy integer scores and on random ones;
  - against the Pallas kernels in interpret mode: exactly, on integer-valued
    bf16 rows and queries, whose float32 sums are exact in any order; on
    random inputs within ``check_against_twin``'s 1e-5 * sum |terms| + 1e-5
    (the summation order differs), offsets reaching the minimum;
  - the store map: every (block, query) of the output written exactly once,
    nothing past N / r or B.
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

TR, TQ = sw.COMPACT_TILE_ROWS, sw.COMPACT_TILE_Q
WGS = TQ // 64
RS = [8, 16, 32, 64, 128, 256]


def _inputs(seed, *, n, d, b, r, penalty):
    """Augmented bf16 rows, queries and an optional allowlist penalty, as
    the searcher builds them (squared L2, padded rows masked)."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    n_valid = n - 3 * r // 2
    measure = DistanceMeasure.SQUARED_L2
    aug = sw.build_augmented_db(db, n_valid, measure, tile_n=n)
    q_aug = sw._augment_queries(torch.from_numpy(q), measure, aug.shape[1])
    pen = None
    if penalty:
        pen = sw.build_allow_penalty(rng.random(n_valid) < 0.3, n, r)
    return q_aug, aug, pen


def _float_scores(q_aug, aug, pen):
    s = (aug.float() @ q_aug.float().T).numpy()
    if pen is not None:
        s = s + pen.float().reshape(-1)[:, None].numpy()
    return s


# -- the plans ----------------------------------------------------------------


def test_plans_at_the_main_shapes():
    """The top-2 path's calls (B = 512, r = 64) and the r = 128 path's (B =
    1024) over 1,187,840 x 104 rows: seven stages (no staging beside the
    ring), clusters of 2, runs of r / 2 tiles; the compact form's plan is
    unchanged."""
    top2 = sw.sweep_plan("top2", 1_187_840, 512, 104, 64, False)
    assert top2 == sw.CompactPlan(nks=8, stages=7, cluster=2, run_tiles=32,
                                  runs=290, q_tiles=4, units=580,
                                  smem_bytes=1024 + 7 * 32768 + 7 * 16)
    r128 = sw.sweep_plan("rowmajor", 1_187_840, 1024, 104, 128, False)
    assert r128 == sw.CompactPlan(nks=8, stages=7, cluster=2, run_tiles=64,
                                  runs=145, q_tiles=8, units=580,
                                  smem_bytes=230_512)
    assert sw.sweep_plan("compact", 1_187_840, 1024, 104, 64, False) == \
        sw.compact_plan(1_187_840, 1024, 104, 64, False)
    assert sw.compact_plan(1_187_840, 1024, 104, 64, False).smem_bytes == \
        226_400


@pytest.mark.parametrize("form", ["rowmajor", "top2"])
@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("d1", [8, 104, 136, 256])
@pytest.mark.parametrize("n,b", [(1_187_840, 512), (4096 + 256, 1),
                                 (4096, 1000)])
def test_plan_of_each_row_major_form(form, r, d1, n, b):
    """Accepted wherever the compact form is, with the same grid and runs;
    the shared memory is the ring and its barriers only, as the device
    layout counts it, and the ring takes the stages the staging freed."""
    plan = sw.sweep_plan(form, n, b, d1, r, False)
    compact = sw.compact_plan(n, b, d1, r, False)
    assert plan is not None and compact is not None
    assert plan._replace(stages=0, smem_bytes=0) == \
        compact._replace(stages=0, smem_bytes=0)
    stage = -(-d1 // 64) * TR * 128
    assert plan.smem_bytes == 1024 + plan.stages * (stage + 16)
    assert plan.smem_bytes == sw.sweep_smem_bytes(form, d1, r, plan.stages,
                                                  plan.run_tiles)
    assert plan.smem_bytes <= MAX_SHARED_MEMORY
    assert plan.stages >= compact.stages
    assert plan.stages == 8 or \
        1024 + (plan.stages + 1) * (stage + 16) > MAX_SHARED_MEMORY


@pytest.mark.parametrize("form", ["compact", "rowmajor", "top2"])
@pytest.mark.parametrize("n,b,d1,r,int8_rows", [
    (4096, 64, 104, 64, True),      # int8 rows
    (4096, 64, 104, 4, False),      # r < 8
    (4096, 64, 104, 2, False),
    (4096, 64, 104, 512, False),    # r > 256 (the q-major form's limit: 512)
    (4096, 64, 264, 64, False),     # wider than 16 k-steps
    (4096, 64, 100, 64, False),     # D1 not a multiple of 8
    (4096 + 32, 64, 104, 64, False),  # N not a multiple of r
    (4096, 64, 104, 48, False),     # r not a power of two
])
def test_plan_rejects(form, n, b, d1, r, int8_rows):
    assert sw.sweep_plan(form, n, b, d1, r, int8_rows) is None


def test_plan_rejects_an_unknown_form():
    with pytest.raises(ValueError, match="form"):
        sw.sweep_plan("float32", 4096, 64, 104, 64, False)


# -- routing ------------------------------------------------------------------


@pytest.fixture
def stub_card(monkeypatch):
    """The card's pieces stubbed (meta tensors, recording kernel entries):
    returns the list of (kernel, args) calls."""
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
    return calls


@pytest.mark.parametrize("form", ["rowmajor", "top2"])
@pytest.mark.parametrize("d1,r,int8_rows,want", [
    (104, 64, False, "block_min_compact"),
    (104, 128, False, "block_min_compact"),
    (8, 8, False, "block_min_compact"),
    (256, 256, False, "block_min_compact"),
    (104, 64, True, "block_min_sweep"),    # int8 rows
    (104, 4, False, "block_min_sweep"),    # r < 8
    (104, 512, False, "block_min_sweep"),  # r > 256
    (264, 64, False, "block_min_sweep"),   # wider than the registers hold
])
def test_row_major_calls_route_by_the_plan(stub_card, form, d1, r,
                                           int8_rows, want):
    """Through the public wrappers: the plan's calls launch the wgmma
    kernel with their form, stages, run length and the seconds' outputs
    (top-2 only), the rest the mma.sync kernel; each counts one launch of
    its form, by the kernel that served it; ``mma_sync`` keeps the old
    kernel as the yardstick."""
    n, b = 4096, 200
    dtype = torch.int8 if int8_rows else torch.bfloat16
    aug = torch.empty(n, d1, dtype=dtype, device="meta")
    q_aug = torch.empty(b, d1, dtype=torch.bfloat16, device="meta")
    name = "block_min2" if form == "top2" else "block_min"
    sw.reset_launches()
    if form == "top2":
        got = sw.block_min2_sweep(q_aug, aug, r=r)
        assert len(got) == 4
    else:
        got = sw.block_min_sweep(q_aug, aug, r=r)
        assert len(got) == 2
    assert [tuple(t.shape) for t in got] == [(n // r, b)] * len(got)
    assert [t.dtype for t in got] == [torch.float32, torch.int32] * (
        len(got) // 2)
    assert [c[0] for c in stub_card] == [want]
    assert sw.LAUNCHES[name] == 1 and sum(sw.LAUNCHES.values()) == 1
    assert sw.LAUNCHES_BY_KERNEL[name] == {
        "block_min_compact": int(want == "block_min_compact"),
        "block_min_sweep": int(want == "block_min_sweep")}
    if want == "block_min_compact":
        plan = sw.sweep_plan(form, n, b, d1, r, False)
        args = stub_card[0][1]
        assert args[5:13] == (n, b, d1, r, plan.stages, plan.run_tiles,
                              plan.cluster, sw.SWEEP_FORMS.index(form))
        assert (args[13] is not None, args[14] is not None) == (
            (form == "top2",) * 2)
        stub_card.clear()
        sw._launch(name, q_aug, aug, r, None, qmajor=False, compact=False,
                   top2=form == "top2", mma_sync=True)
        assert [c[0] for c in stub_card] == ["block_min_sweep"]
        assert sw.LAUNCHES_BY_KERNEL[name]["block_min_sweep"] == 1
    sw.reset_launches()
    assert all(v == 0 for c in sw.LAUNCHES_BY_KERNEL.values()
               for v in c.values())


@pytest.mark.parametrize("n,r", [(4096 + 64, 64), (4096 + 8, 8),
                                 (4096 + 96, 32)])
def test_top2_calls_on_part_of_a_tile_take_a_padded_copy(stub_card, n, r):
    """The top-2 form reads whole 128-row tiles: a call whose rows end
    inside a tile launches on a copy padded with zero rows (and a penalty
    padded with zeros) and returns only the N / r real blocks."""
    q_aug = torch.empty(100, 104, dtype=torch.bfloat16, device="meta")
    aug = torch.empty(n, 104, dtype=torch.bfloat16, device="meta")
    pen = torch.empty(n // r, r, dtype=torch.bfloat16, device="meta")
    got = sw.block_min2_sweep(q_aug, aug, r=r, penalty=pen)
    assert [tuple(x.shape) for x in got] == [(n // r, 100)] * 4
    (kernel, args), = stub_card
    n_pad = -(-n // TR) * TR
    assert kernel == "block_min_compact" and args[5] == n_pad
    # the row-major top-1 reads the rows as they are
    stub_card.clear()
    sw.block_min_sweep(q_aug, aug, r=r, penalty=pen)
    assert stub_card[0][1][5] == n


def test_float32_qmajor_calls_stay_on_the_old_kernel(stub_card):
    """The float32 q-major calls its plan refuses (int8 rows, r < 8) stay
    on block_min_sweep.cu; bf16 rows at 8 <= r <= 512 take the q-major
    form of block_min_compact.cu (tests/test_torch_block_min_qmajor.py),
    and the yardstick's mma_sync=True the old kernel."""
    q_aug = torch.empty(200, 104, dtype=torch.bfloat16, device="meta")
    aug = torch.empty(4096, 104, dtype=torch.bfloat16, device="meta")
    aug8 = torch.empty(4096, 104, dtype=torch.int8, device="meta")
    sw.reset_launches()
    sw.block_min_sweep_qmajor(q_aug, aug8, r=64)
    sw.block_min_sweep_qmajor(q_aug, aug, r=4)
    sw._launch("block_min_qmajor", q_aug, aug, 64, None, qmajor=True,
               compact=False, top2=False, mma_sync=True)
    assert [c[0] for c in stub_card] == ["block_min_sweep"] * 3
    assert sw.LAUNCHES_BY_KERNEL["block_min_qmajor"]["block_min_sweep"] == 3
    assert sw.LAUNCHES_BY_KERNEL["block_min_qmajor"]["block_min_compact"] == 0


# -- the top-2 form's rows: a permuted 5-D TMA box -----------------------------


def _tma_box_5d(rows: np.ndarray, tile: int, d1: int, j0: int, nj: int,
                stage: np.ndarray) -> None:
    """One 5-D box of the top-2 view written into ``stage`` (int16, one
    ring stage of ceil(D1 / 64) boxes of TR rows x 128 bytes), as TMA
    writes it: box dims {64 cols, 2 e, 4 t, nj j, 1 tile} innermost first
    at coordinates {64 bx, 0, 0, j0, tile}, global row strides {1, 32, 2,
    128}; box element (c, e, t, j) lands at smem row 8 (j - j0) + 2t + e
    after the part's first row 8 j0, in the 128-byte swizzle (16-byte chunk
    c // 8 ^ smem row % 8); zero past D1."""
    boxes = -(-d1 // 64)
    bx, c, e, t, j = np.meshgrid(np.arange(boxes), np.arange(64),
                                 np.arange(2), np.arange(4),
                                 np.arange(j0, j0 + nj), indexing="ij")
    row = TR * tile + 32 * t + 2 * j + e
    col = 64 * bx + c
    srow = 8 * j0 + 8 * (j - j0) + 2 * t + e
    ok = col < d1
    byte = (bx * TR * 128 + srow * 128 + ((c // 8) ^ (srow % 8)) * 16
            + (c % 8) * 2)
    stage[byte[ok] // 2] = rows[row[ok], col[ok]]


def _b_from_stage(stage: np.ndarray, nks: int) -> np.ndarray:
    """[TR rows, 16 nks] read through the kernel's sw128_desc (as
    tests/test_torch_block_min_compact.py models it): the linear address
    + 1024 (n // 8) + 128 (n % 8) + 2 k, then the 128-byte swizzle."""
    n, k = np.meshgrid(np.arange(TR), np.arange(16 * nks), indexing="ij")
    s = k // 16
    lin = ((s // 4) * TR * 128 + (s % 4) * 32 + (n // 8) * 1024
           + (n % 8) * 128 + (k % 16) * 2)
    return stage[(lin ^ (((lin >> 7) & 7) << 4)) // 2]


@pytest.mark.parametrize("d1", [8, 104, 136, 256])
@pytest.mark.parametrize("cluster", [1, 2])
def test_permuted_box_gives_each_thread_32_consecutive_rows(d1, cluster):
    """Through the B descriptor, accumulator column n = 8j + 2t + e of the
    top-2 form reads tile row 32t + 2j + e, so thread t's 32 columns are
    rows 32t .. 32t + 31; the two halves a cluster's CTAs load (j in
    [0, 8) and [8, 16)) make the same stage as one whole box."""
    rng = np.random.default_rng(d1 + cluster)
    n = 3 * TR
    rows = rng.integers(-30000, 30000, size=(n, d1)).astype(np.int16)
    nks = 4 * -(-d1 // 64)
    for tile in range(n // TR):
        stage = np.zeros(nks // 4 * TR * 64, np.int16)
        for rank in range(cluster):
            _tma_box_5d(rows, tile, d1, rank * 16 // cluster, 16 // cluster,
                        stage)
        b_img = _b_from_stage(stage, nks)
        col = np.arange(TR)
        j, t, e = col // 8, (col % 8) // 2, col % 2
        want = np.zeros((TR, 16 * nks), np.int16)
        want[:, :d1] = rows[TR * tile + 32 * t + 2 * j + e]
        np.testing.assert_array_equal(b_img, want)


# -- the epilogues, lane by lane ----------------------------------------------


def _lanes():
    """[WGS, 4 warps, 8 g, 4 t] index arrays of a CTA's consumer lanes and
    each lane's query slot g of its warp's 16."""
    wg, w, g, t = np.meshgrid(np.arange(WGS), np.arange(4), np.arange(8),
                              np.arange(4), indexing="ij")
    return t, 64 * wg + 16 * w + g


def _shfl(x, mask):
    """__shfl_xor_sync over the quad axis (t, the last)."""
    return x[..., np.arange(4) ^ mask]


def _merge(a, b):
    """merge_runs: the JAX package's merge, ``a`` the lower run."""
    m1a, m2a, l1a, l2a = a
    m1b, m2b, l1b, l2b = b
    ta = m1a <= m1b
    mo, lo = np.where(ta, m1b, m1a), np.where(ta, l1b, l1a)
    t2 = m2a <= m2b
    c2, lc2 = np.where(t2, m2a, m2b), np.where(t2, l2a, l2b)
    to = mo <= c2
    return (np.where(ta, m1a, m1b), np.where(to, mo, c2),
            np.where(ta, l1a, l1b), np.where(to, lo, lc2))


def _pair(va, vb, row):
    ta = va <= vb
    return (np.where(ta, va, vb), np.where(ta, vb, va),
            row + np.where(ta, 0, 1), row + np.where(ta, 1, 0))


def _shfl_run(x, mask):
    m1, m2, l1, l2 = x
    packed = _shfl(l1 | (l2 << 16), mask)
    return _shfl(m1, mask), _shfl(m2, mask), packed & 0xFFFF, packed >> 16


def _select(bit, x, y):
    return tuple(np.where(bit, u, v) for u, v in zip(x, y))


def _exchange_runs(i0, i1, bit, mask):
    """exchange_runs: keep i<bit>, send the other, merge with the partner's
    copy of the kept item, the lane of bit 0 first."""
    keep = _select(bit, i1, i0)
    recv = _shfl_run(_select(bit, i0, i1), mask)
    return _merge(_select(bit, recv, keep), _select(bit, keep, recv))


def _top2_tile(tl, t, qrow, r):
    """The top-2 epilogue of one tile [TR rows, TQ queries] of float32
    scores for every lane: the 5-D box put tile row 32t + 2j + e at
    accumulator column 8j + 2t + e, so a thread holds rows 32t .. 32t + 31
    of its two query slots; bits 0 to 4 merge in the thread (a binary
    counter over j), bit 5 by an exchange keeping slot t & 1, bit 6 by a
    last shuffle. Yields (finished run, block in the tile, lanes that
    write, query slot) in the kernel's order."""
    lb = {8: 2, 16: 3}.get(r, 4)
    ones = np.ones_like(t, bool)
    run32 = []
    for h in range(2):
        stk = [None] * 4
        for j in range(16):
            row = 32 * t + 2 * j
            cur = _pair(tl[row, qrow + 8 * h], tl[row + 1, qrow + 8 * h], row)
            pending = False
            for level in range(lb):
                if (j >> level) & 1:
                    cur = _merge(stk[level], cur)
                else:
                    stk[level] = cur
                    pending = True
                    break
            if pending:
                continue
            if r <= 32:
                m1, m2, l1, l2 = cur
                yield ((m1, m2, l1 & (r - 1), l2 & (r - 1)), row // r, ones,
                       qrow + 8 * h)
            else:
                run32.append(cur)
    if r >= 64:
        hq, half = t & 1, t >> 1
        cur = _exchange_runs(run32[0], run32[1], hq, 1)
        if r == 64:
            m1, m2, l1, l2 = cur
            yield (m1, m2, l1 & 63, l2 & 63), half, ones, qrow + 8 * hq
        else:
            other = _shfl_run(cur, 2)
            cur = _merge(_select(half, other, cur), _select(half, cur, other))
            yield cur, np.zeros_like(t), half == 0, qrow + 8 * hq


def _top1_tile(tl, t, qrow, r):
    """The top-1 epilogue of one tile, as the compact form reduces it (a
    tree of minima in the thread, the lower row first on ties, then the
    exchanges across the quad): yields ((value, offset), block in the
    tile, lanes that write, query slot)."""
    rt = min(r, TR)
    nbt, jb = TR // rt, rt // 8
    gb_size = 2 if nbt >= 2 else 1

    def lexmin(v, i, ov, oi):
        take = (ov < v) | ((ov == v) & (oi < i))
        return np.where(take, ov, v), np.where(take, oi, i)

    def exchange(v, ix, level):
        mask, bit = 1 << level, (t >> level) & 1
        outs_v, outs_i = [], []
        for p in range(len(v) // 2):
            kv = np.where(bit, v[2 * p + 1], v[2 * p])
            ki = np.where(bit, ix[2 * p + 1], ix[2 * p])
            sv = np.where(bit, v[2 * p], v[2 * p + 1])
            si = np.where(bit, ix[2 * p], ix[2 * p + 1])
            nv, ni = lexmin(kv, ki, _shfl(sv, mask), _shfl(si, mask))
            outs_v.append(nv)
            outs_i.append(ni)
        return outs_v, outs_i

    for gb in range(nbt // gb_size):
        v, ix = [], []
        for k in range(2 * gb_size):
            bl, h = gb * gb_size + (k >> 1), k & 1
            tv = [tl[8 * (bl * jb + m // 2) + 2 * t + m % 2, qrow + 8 * h]
                  for m in range(2 * jb)]
            tm = [np.full_like(t, m) for m in range(2 * jb)]
            step = 1
            while step < 2 * jb:
                for m in range(0, 2 * jb, 2 * step):
                    take = tv[m + step] < tv[m]
                    tv[m] = np.where(take, tv[m + step], tv[m])
                    tm[m] = np.where(take, tm[m + step], tm[m])
                step *= 2
            v.append(tv[0])
            ix.append(8 * (tm[0] // 2) + tm[0] % 2 + 2 * t)
        if gb_size == 2:
            v, ix = exchange(v, ix, 0)
            v, ix = exchange(v, ix, 1)
            item, writer = t, np.ones_like(t, bool)
        else:
            v, ix = exchange(v, ix, 0)
            v, ix = lexmin(v[0], ix[0], _shfl(v[0], 2), _shfl(ix[0], 2))
            v, ix = [v], [ix]
            item, writer = t & 1, t < 2
        yield ((v[0], ix[0]), gb * gb_size + (item >> 1), writer,
               qrow + 8 * (item & 1))


def _emulate(scores: np.ndarray, b: int, r: int, plan, form: str):
    """The row-major kernel on float32 scores [N, B], thread by thread:
    units in order, each CTA of the cluster, each tile's epilogue, the
    carry of a block over two tiles at r = 256, the clipped row-major
    stores. Returns the outputs [N/r, B] (float32 values, int64 offsets;
    two of each for top-2) and the number of writes of each element."""
    n = scores.shape[0]
    n_tiles = -(-n // TR)
    s = np.zeros((n_tiles * TR, plan.q_tiles * TQ), np.float32)
    s[:n, :b] = scores
    nb = n // r
    parts = 4 if form == "top2" else 2
    outs = [np.full((nb, b), np.nan if i % 2 == 0 else -1,
                    np.float32 if i % 2 == 0 else np.int64)
            for i in range(parts)]
    writes = np.zeros((nb, b), np.int64)
    t, qrow = _lanes()
    tile_fn = _top2_tile if form == "top2" else _top1_tile
    for u, rank in np.ndindex(plan.units, plan.cluster):
        run, qt = sw.compact_unit(plan, u)
        qt += rank
        if qt >= plan.q_tiles:      # multiplies zeros, stores nothing
            continue
        t0 = run * plan.run_tiles
        carry = None
        for tile in range(t0, min(t0 + plan.run_tiles, n_tiles)):
            tl = s[tile * TR:(tile + 1) * TR, qt * TQ:(qt + 1) * TQ]
            for res, bl, writer, q in tile_fn(tl, t, qrow, r):
                if form == "top2":
                    m1, m2, l1, l2 = res
                    vals = [m1, l1, m2, l2]
                else:
                    vals = list(res)
                gblk = np.broadcast_to(tile * TR // r + bl, t.shape)
                if r > TR:          # a block over two tiles
                    gblk = np.full_like(t, tile // 2)
                    if (tile - t0) % 2 == 0:
                        carry = vals
                        continue
                    if form == "top2":
                        m1, m2, l1, l2 = carry[0], carry[2], carry[1], \
                            carry[3]
                        nm1, nm2, nl1, nl2 = _merge(
                            (m1, m2, l1, l2),
                            (vals[0], vals[2], vals[1] + TR, vals[3] + TR))
                        vals = [nm1, nl1, nm2, nl2]
                    else:
                        lower = vals[0] < carry[0]
                        vals = [np.where(lower, vals[0], carry[0]),
                                np.where(lower, vals[1] + TR, carry[1])]
                gq = qt * TQ + q
                ok = writer & (gq < b) & (gblk < nb)
                for out, v in zip(outs, vals):
                    out[gblk[ok], gq[ok]] = v[ok]
                np.add.at(writes, (gblk[ok], gq[ok]), 1)
    return outs, writes


def _tie_scores(rng, n, b, lo=-2, hi=3):
    return rng.integers(lo, hi, size=(n, b)).astype(np.float32)


def _twin_top2(scores, r):
    s3 = torch.from_numpy(scores).view(-1, r, scores.shape[1])
    return [x.numpy() for x in sw._tournament2(s3)]


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("n,b,sms", [(1024 + 256, 70, 132), (2560, 300, 4),
                                     (1280 + 256, 600, 8)])
def test_emulated_top2_equals_the_tournament(r, ties, n, b, sms):
    """Tie-heavy integer scores (five values) and random ones; B not a
    multiple of 128 (B = 600: a CTA past B), runs of one tile and of
    several, clusters of 1 and 2, a last partial tile where r <= 128: the
    emulated epilogue gives ``_tournament2``'s four outputs exactly, and
    writes every (block, query) once."""
    if r <= 64:
        n -= r              # a last tile of 128 - r rows
    rng = np.random.default_rng(r * 31 + b + ties)
    scores = (_tie_scores(rng, n, b) if ties
              else rng.normal(size=(n, b)).astype(np.float32))
    plan = sw.sweep_plan("top2", n, b, 8, r, False, sms=sms)
    (m1, l1, m2, l2), writes = _emulate(scores, b, r, plan, "top2")
    want = _twin_top2(scores, r)
    np.testing.assert_array_equal(m1, want[0])
    np.testing.assert_array_equal(l1, want[1])
    np.testing.assert_array_equal(m2, want[2])
    np.testing.assert_array_equal(l2, want[3])
    assert (writes == 1).all()
    if ties:
        # the tie rule is exercised: where the minimum repeats, the second
        # is not always its second-lowest row
        eq = scores.reshape(-1, r, b) == m1[:, None, :]
        twice = eq.sum(1) >= 2
        second = np.argmax(eq.cumsum(1) == 2, axis=1)
        assert (l2 != second)[twice].any()


def test_emulated_top2_breaks_ties_as_the_tournament():
    """[1, 1, 5, 1] a block of 8 rows (rows 4..7 high): the second is the
    offset the JAX package's tournament names (3), not the lowest (1)."""
    col = np.array([1, 1, 5, 1, 9, 9, 9, 9], np.float32)
    scores = np.tile(col, 16)[:, None].repeat(3, 1)
    plan = sw.sweep_plan("top2", 128, 3, 8, 8, False)
    (m1, l1, m2, l2), _ = _emulate(scores, 3, 8, plan, "top2")
    assert (m1 == 1).all() and (l1 == 0).all()
    assert (m2 == 1).all() and (l2 == 3).all()


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("n,b,sms", [(1024 + 256, 70, 132), (2560, 300, 4),
                                     (1280 + 256, 600, 8)])
def test_emulated_rowmajor_top1_is_the_lowest_argmin(r, ties, n, b, sms):
    """The row-major top-1 on the same calls: the float32 minimum,
    unrounded, and the lowest row reaching it, exactly; every (block,
    query) written once."""
    if r <= 64:
        n -= r
    rng = np.random.default_rng(r * 17 + b + ties)
    scores = (_tie_scores(rng, n, b) if ties
              else rng.normal(size=(n, b)).astype(np.float32))
    plan = sw.sweep_plan("rowmajor", n, b, 8, r, False, sms=sms)
    (vals, locs), writes = _emulate(scores, b, r, plan, "rowmajor")
    s3 = scores.reshape(-1, r, b)
    np.testing.assert_array_equal(vals, s3.min(1))
    np.testing.assert_array_equal(locs, s3.argmin(1))
    assert (writes == 1).all()


@pytest.mark.parametrize("form", ["rowmajor", "top2"])
@pytest.mark.parametrize("r", [8, 64, 128, 256])
@pytest.mark.parametrize("penalty", [False, True])
def test_emulation_passes_the_twin_check(form, r, penalty):
    """On the searcher's own augmented inputs (a masked tail, an allowlist
    penalty), the emulated outputs pass ``check_against_twin`` with every
    offset the twin's own."""
    n, b = 2048 + 512, 200
    q_aug, aug, pen = _inputs(r + penalty, n=n, d=40, b=b, r=r,
                              penalty=penalty)
    plan = sw.sweep_plan(form, n, b, aug.shape[1], r, False, sms=8)
    outs, _ = _emulate(_float_scores(q_aug, aug, pen), b, r, plan, form)
    got = [torch.from_numpy(x.astype(np.int32) if i % 2 else x)
           for i, x in enumerate(outs)]
    rep = sw.check_against_twin(form, got, q_aug, aug, r=r, penalty=pen)
    assert rep["checked"] == (n // r) * b * (2 if form == "top2" else 1)
    assert rep["loc_equal"] == 1.0


def _jax_of(x):
    return None if x is None else jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16)


def _integer_inputs(rng, n, b, d1, r, penalty):
    """Integer-valued bf16 rows and queries, |v| <= 2, and an optional
    penalty of 0 or 64: every float32 sum is exact in any order."""
    rows = torch.from_numpy(rng.integers(-2, 3, size=(n, d1)).astype(
        np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.integers(-2, 3, size=(b, d1)).astype(
        np.float32)).to(torch.bfloat16)
    pen = None
    if penalty:
        pen = torch.from_numpy(np.where(rng.random((n // r, r)) < 0.3, 64.0,
                                        0.0).astype(np.float32)).to(
            torch.bfloat16)
    return q, rows, pen


@pytest.mark.parametrize("form", ["rowmajor", "top2"])
@pytest.mark.parametrize("r", [8, 32, 128, 256])
@pytest.mark.parametrize("penalty", [False, True])
def test_emulation_equals_pallas_on_exact_sums(form, r, penalty):
    """Against ``block_min_sweep_pallas`` / ``block_min2_sweep_pallas`` in
    interpret mode: bit for bit, ties included."""
    n, b, d1 = 2048, 24, 16
    rng = np.random.default_rng(r + 7 * penalty)
    q, rows, pen = _integer_inputs(rng, n, b, d1, r, penalty)
    plan = sw.sweep_plan(form, n, b, d1, r, False, sms=8)
    outs, _ = _emulate(_float_scores(q, rows, pen), b, r, plan, form)
    fn = (jsw.block_min2_sweep_pallas if form == "top2"
          else jsw.block_min_sweep_pallas)
    want = fn(_jax_of(q), _jax_of(rows), tile_n=1024, r=r, interpret=True,
              penalty=_jax_of(pen))
    assert len(want) == len(outs)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("form", ["rowmajor", "top2"])
@pytest.mark.parametrize("r", [16, 64, 256])
def test_emulation_agrees_with_pallas_on_random_inputs(form, r):
    """Random augmented inputs with a penalty: values within the twin's
    tolerance of the Pallas kernel's, each side's offsets reaching the
    other's value."""
    n, b = 2048, 40
    q_aug, aug, pen = _inputs(r, n=n, d=24, b=b, r=r, penalty=True)
    plan = sw.sweep_plan(form, n, b, aug.shape[1], r, False, sms=8)
    scores = _float_scores(q_aug, aug, pen)
    outs, _ = _emulate(scores, b, r, plan, form)
    fn = (jsw.block_min2_sweep_pallas if form == "top2"
          else jsw.block_min_sweep_pallas)
    want = [np.asarray(x) for x in fn(_jax_of(q_aug), _jax_of(aug),
                                      tile_n=1024, r=r, interpret=True,
                                      penalty=_jax_of(pen))]
    s3 = scores.reshape(-1, r, b)
    a3 = np.abs(aug.float().numpy()) @ np.abs(q_aug.float().numpy()).T
    a3 = a3 + np.abs(pen.float().reshape(-1, 1).numpy())
    tol = 1e-5 * a3.reshape(-1, r, b).max(1) + 1e-5
    for i in range(0, len(outs), 2):
        np.testing.assert_array_less(np.abs(outs[i] - want[i]), tol)
        for v, locs in ((outs[i], want[i + 1]), (want[i], outs[i + 1])):
            reached = np.take_along_axis(s3, locs[:, None, :], 1)[:, 0]
            np.testing.assert_array_less(np.abs(reached - v), 2 * tol)

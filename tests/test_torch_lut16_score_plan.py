"""The Python side of the query-tiled LUT16 score kernel
(``csrc/lut16_scoring.cu`` ``lut16_score_tiled``, #8), on the CPU: its
launch plan and the route of every shape the card test takes, the table
image it copies into shared memory, the bank map of its lookups, the
kernel emulated thread by thread (code ring, lookups, adds, stores) against
the port's twin and the Pallas kernel in interpret mode, its store map, and
the wrapper's routing between the two score kernels.

Tolerances:
  - plans, images, bank maps and store maps are counts and copies: equal;
  - the emulated kernel adds the same bf16 entries as float32 in ascending
    s, so it equals ``lut16_score_reference`` bit for bit, in float32 and
    after the one rounding to bf16;
  - against the Pallas kernel (XLA's summation order), as
    tests/test_torch_lut16.py holds the twin: |emulation - pallas| <= 1e-6
    * sum |terms| in float32, 1 bf16 ulp in bf16.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scann_tpu.ops.pallas_kernels import lut16_score_pallas
from scann_tpu_torch.ops import scoring_kernels as sk
from scann_tpu_torch.types import MAX_SHARED_MEMORY

LANES = 8                        # lanes splitting a tile's queries
GROUPS = sk.SCORE_GROUPS         # column groups of a CTA (256 threads)
THREADS = GROUPS * LANES
# the card test's shapes (tests/test_torch_cuda.py) and their tiles
CARD_SHAPES = {(1024, 50, 16, 20000): 128, (100, 7, 16, 5000): 128,
               (33, 8, 256, 777): 32, (1, 3, 4, 10): 8,
               (128, 50, 16, 1_183_514): 128, (1024, 50, 16, 16_384): 128}


def _next_pow2(x):
    return 1 << (x - 1).bit_length()


# -- the plan -----------------------------------------------------------------


def test_plan_at_the_main_shapes():
    """The approximate-only hasher (B=128, float32 scores) and the
    16,384-row hasher's re-rank (B=1024): 128 queries a tile, 4 columns and
    16 queries a thread (64 accumulators), all 50 code rows a ring slot of
    each column half, 228,800 bytes of shared memory (one CTA an SM)."""
    plan = sk.lut16_score_plan(128, 50, 16, 1_183_514)
    assert plan == sk.ScorePlan(q_tile=128, cols=4, tile_cols=128,
                                stage_rows=50, smem_bytes=228_800, q_tiles=1,
                                col_tiles=9247, units=9247)
    plan = sk.lut16_score_plan(1024, 50, 16, 16_384)
    assert (plan.q_tiles, plan.col_tiles, plan.units) == (8, 128, 1024)
    # the persistent grid's shares differ by at most one tile
    shares = [np.subtract(*sk.lut16_score_units(plan, 132, c)[::-1])
              for c in range(132)]
    assert sum(shares) == 1024 and max(shares) - min(shares) <= 1


@pytest.mark.parametrize("b", [1, 33, 128, 1024])
@pytest.mark.parametrize("c", [4, 16, 256])
@pytest.mark.parametrize("n", [10, 777, 16_384, 1_183_514])
@pytest.mark.parametrize("s", [3, 8, 50])
def test_plan_fits_and_is_widest(b, c, n, s):
    plan = sk.lut16_score_plan(b, s, c, n)
    assert plan is not None
    assert plan.smem_bytes <= MAX_SHARED_MEMORY
    assert plan.smem_bytes == sk.lut16_score_smem_bytes(plan.q_tile, s, c,
                                                        plan.stage_rows)
    assert plan.q_tile <= max(8, _next_pow2(b))
    assert plan.cols == (4 if plan.q_tile == 128 else 8)
    assert plan.tile_cols == GROUPS * plan.cols
    assert plan.cols * plan.q_tile // LANES <= 64     # accumulators
    assert plan.q_tiles == -(-b // plan.q_tile)
    assert plan.col_tiles == -(-n // plan.tile_cols)
    assert plan.units == plan.q_tiles * plan.col_tiles
    # as many code rows a slot as fit, and no wider tile would fit
    assert 1 <= plan.stage_rows <= s
    if plan.stage_rows < s:
        assert sk.lut16_score_smem_bytes(plan.q_tile, s, c,
                                         plan.stage_rows + 1) \
            > MAX_SHARED_MEMORY
    wider = 2 * plan.q_tile
    if wider <= min(128, max(8, _next_pow2(b))):
        assert sk.lut16_score_smem_bytes(wider, s, c, 1) > MAX_SHARED_MEMORY


@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_card_shapes_route_to_a_tile(shape):
    """Every shape the card test launches has a plan, with the tile named
    here (the old kernel's shapes all fit: 8 queries' tables take at most
    a sixth of its 32 queries' padded rows)."""
    plan = sk.lut16_score_plan(*shape)
    assert plan is not None and plan.q_tile == CARD_SHAPES[shape]


def test_plan_refuses_tables_past_shared_memory():
    """S x C past what 8 queries' tables and one ring row can hold."""
    assert sk.lut16_score_plan(4, 200, 256, 10) is None
    assert sk.lut16_score_smem_bytes(8, 200, 256, 1) > MAX_SHARED_MEMORY
    assert sk.lut16_score_plan(4, 50, 256, 10) is not None


# -- the table image and the bank map ---------------------------------------------


@pytest.mark.parametrize("b,q_tile", [(5, 8), (33, 32), (130, 128), (64, 64)])
def test_table_image_is_entry_major_by_query(b, q_tile):
    rng = np.random.default_rng(b)
    s, c = 3, 5
    luts = torch.from_numpy(rng.normal(size=(b, s, c)).astype(np.float32))
    img = sk.lut16_score_table_image(luts, q_tile)
    qt = -(-b // q_tile)
    assert img.dtype == torch.bfloat16 and img.numel() == qt * s * c * q_tile
    want = torch.zeros(qt * q_tile, s, c, dtype=torch.bfloat16)
    want[:b] = luts.to(torch.bfloat16)
    # tile t, entry (s, code), query q at t * S*C*Q + (s*C + code) * Q + q
    got = img.view(qt, s, c, q_tile).permute(0, 3, 1, 2).reshape(-1, s, c)
    assert torch.equal(got, want)


def _thread_map():
    """(lane, lane of its group lq, column group cg) of the CTA's threads."""
    tid = np.arange(THREADS)
    lane = tid & 31
    return lane, lane & (LANES - 1), (tid >> 5) * (32 // LANES) + (lane >> 3)


def _load_bytes(q_tile):
    qs = q_tile // LANES
    return 16 if qs >= 8 else 2 * qs


def _wavefronts(addr, lb):
    """Shared-memory wavefronts of one warp's load of lb bytes a lane at
    byte addresses addr [32]: 16-byte loads are served a quarter warp at a
    time, 8-byte loads a half warp, narrower ones the whole warp; a phase
    takes as many wavefronts as the most distinct 4-byte words any one of
    the 32 banks holds among its lanes."""
    lanes = 8 if lb == 16 else 16 if lb == 8 else 32
    worst = 0
    for p in range(0, 32, lanes):
        words = {w for a in addr[p:p + lanes]
                 for w in range(a // 4, (a + lb - 1) // 4 + 1)}
        per_bank = np.bincount([w % 32 for w in words], minlength=32)
        worst += int(per_bank.max())
    return worst, 32 // lanes


@pytest.mark.parametrize("q_tile,c", [(128, 16), (64, 16), (64, 256),
                                      (32, 256), (16, 16), (8, 256)])
def test_bank_map_of_the_lookups(q_tile, c):
    """Every lookup load of one warp, for random codes and for codes that
    put every group on the same banks: with 16-byte loads (tiles of 64 and
    128 queries) the 8 lanes of a quarter warp read 128 contiguous bytes of
    their group's row, one wavefront a phase whatever the codes; narrower
    loads (tiles of 8-32 queries, tables too large for 64) mix the groups'
    rows in a phase: at most 2 (8-byte) or 4 (4- and 2-byte) wavefronts."""
    lb = _load_bytes(q_tile)
    lane, lq, cg = _thread_map()
    rng = np.random.default_rng(q_tile + c)
    row = 2 * q_tile
    for codes in (rng.integers(0, c, size=GROUPS),
                  (np.arange(GROUPS) * max(1, 128 // row)) % c):
        for warp in range(THREADS // 32):
            sel = slice(32 * warp, 32 * warp + 32)
            for k in range(max(1, q_tile // 64)):
                addr = (3 * c * row + codes[cg[sel]] * row + lq[sel] * lb
                        + 128 * k)
                waves, phases = _wavefronts(addr, lb)
                if lb == 16:
                    assert waves == phases
                else:
                    assert waves <= phases * (2 if lb == 8 else 4)


# -- the kernel, thread by thread ---------------------------------------------


def _emulate_kernel(luts, codes_t, out_dtype, plan, grid, shift0=0):
    """csrc/lut16_scoring.cu lut16_score_tiled_kernel on the CPU: each CTA
    of a persistent grid walks its tiles, copies the tile's tables from the
    image, streams each column half's code rows through its own ring slots
    read from the 16-byte aligned address at or below the half's first
    column (the codes lie ``shift0`` bytes past an aligned address; a half
    wholly past N reads the last column's), and each thread reads its code
    word, clamps
    it below C, looks its columns' entries up (16 queries' entries in two
    16-byte loads at q_tile 128) and adds them as float32 in ascending s,
    then stores its columns of each of its queries' rows. Returns (out,
    writes), writes counting the stores of each output element."""
    b, s, c = luts.shape
    n = codes_t.shape[1]
    q, cols, tc = plan.q_tile, plan.cols, plan.tile_cols
    qs = q // LANES
    lb = _load_bytes(q)
    nl = max(1, qs // 8)
    half = tc // 2                   # a column half: 4 warps, 16 groups
    row_b = half + 16
    img = sk.lut16_score_table_image(torch.from_numpy(luts), q)
    img = img.view(torch.int16).numpy().view(np.uint8)
    tab_bytes = 2 * q * s * c
    # the codes in a flat buffer: address a of the buffer is byte a
    buf = np.zeros(shift0 + s * n + 64, np.uint8)
    buf[shift0:shift0 + s * n] = codes_t.reshape(-1)
    out = np.zeros((b, n), np.float32)
    writes = np.zeros((b, n), np.int64)
    lane, lq, cg = _thread_map()
    tid_c = cg * cols
    h = np.arange(THREADS) // (THREADS // 2)
    hc = tid_c - h * half            # the thread's column in its half
    cmax = min(c, 256) - 1
    for cta in range(grid):
        t0, t1 = sk.lut16_score_units(plan, grid, cta)
        for t in range(t0, t1):
            qt, col0 = t // plan.col_tiles, (t % plan.col_tiles) * tc
            tabs = img[qt * tab_bytes:(qt + 1) * tab_bytes]
            acc = np.zeros((THREADS, cols, qs), np.float32)
            for s0 in range(0, s, plan.stage_rows):
                for si in range(s0, min(s0 + plan.stage_rows, s)):
                    # each half's ring row, from the aligned address at or
                    # below its first column (clamped to the last column)
                    rings, pos = [], np.zeros(THREADS, np.int64)
                    for hh in (0, 1):
                        hcol = min(col0 + hh * half, n - 1)
                        src = shift0 + si * n + hcol
                        base = src & ~15
                        ring = np.zeros(row_b, np.uint8)
                        for k in range(row_b // 16):
                            if 16 * k < src - base + min(half, n - hcol):
                                ring[16 * k:16 * k + 16] = buf[
                                    base + 16 * k:base + 16 * k + 16]
                        rings.append(ring)
                        pos[h == hh] = (src & 15) + hc[h == hh]
                    ring = np.concatenate(rings)
                    pos += h * row_b
                    # the code word of a thread's 4 columns: two aligned
                    # words, funnel-shifted, each byte clamped below C
                    code = []
                    for w in range(cols // 4):
                        x0, x1 = (_le32(ring, (pos & ~3) + 4 * w + 4 * e)
                                  for e in (0, 1))
                        x = (x1 << 32 | x0) >> (8 * (pos & 3)).astype(
                            np.uint64)
                        code += [np.minimum((x >> 8 * i) & 0xFF, cmax)
                                 for i in range(4)]
                    code = np.stack(code, 1).astype(np.int64)    # [thr, cols]
                    addr = (si * c * 2 * q + code * 2 * q
                            + (lq * lb)[:, None])
                    ent = []
                    for k in range(nl):
                        for i in range(lb // 2):
                            # 32-bit words of the load; the high entry
                            # masked, the low one shifted
                            a = addr + 128 * k + 4 * (i // 2)
                            x = (_le32(tabs, a) if lb >= 4 else
                                 tabs[a].astype(np.uint64)
                                 | tabs[a + 1].astype(np.uint64) << 8)
                            ent.append(x & 0xFFFF0000 if i & 1
                                       else (x << 16) & 0xFFFFFFFF)
                    e = np.stack(ent, -1).astype(np.uint32)      # [thr, cols, qs]
                    acc += e.view(np.float32)
            j = np.arange(qs)
            if qs >= 8:
                ql = 8 * (lq[:, None] + 8 * (j // 8)) + j % 8
            else:
                ql = lq[:, None] * qs + j
            qq = qt * q + ql                                     # [thr, qs]
            for cc in range(cols):
                col = col0 + tid_c + cc                          # [thr]
                ok = (qq < b) & (col < n)[:, None]
                rows, cs = qq[ok], np.broadcast_to(col[:, None], qq.shape)[ok]
                out[rows, cs] = acc[:, cc, :][ok]
                np.add.at(writes, (rows, cs), 1)
    got = torch.from_numpy(out)
    return got.to(out_dtype), writes


def _le32(mem, a):
    """Little-endian 32-bit words of byte array ``mem`` at addresses a
    (uint64)."""
    return sum(mem[a + i].astype(np.uint64) << (8 * i) for i in range(4))


def _score_inputs(seed, b, s, c, n):
    rng = np.random.default_rng(seed)
    luts = (rng.normal(size=(b, s, c)) * 3 + 4).astype(np.float32)
    codes_t = rng.integers(0, c, size=(s, n)).astype(np.uint8)
    return luts, codes_t


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c,n,grid,shift0", [
    (130, 7, 16, 300, 3, 0),     # B past a tile of 128, a last partial tile
    (130, 7, 16, 300, 5, 7),     # codes at an odd address, more CTAs
    (33, 8, 256, 777, 4, 3),     # C=256: 32 queries a tile
    (5, 3, 4, 10, 1, 0),         # 8 queries a tile, one short tile
    (40, 4, 16, 1000, 2, 13),    # 64 queries a tile, 8 columns a thread
    (17, 6, 16, 520, 3, 1),      # 32 queries a tile
])
def test_emulated_kernel_equals_twin_bit_for_bit(out_dtype, b, s, c, n, grid,
                                                 shift0):
    luts, codes_t = _score_inputs(b + s + n, b, s, c, n)
    plan = sk.lut16_score_plan(b, s, c, n)
    got, writes = _emulate_kernel(luts, codes_t, out_dtype, plan, grid,
                                  shift0)
    want = sk.lut16_score_reference(torch.from_numpy(luts),
                                    torch.from_numpy(codes_t), out_dtype)
    assert torch.equal(got, want)
    # the store map: every (query, column) written exactly once
    assert (writes == 1).all()


@pytest.mark.parametrize("b,s,n,grid", [(130, 7, 300, 5), (20, 4, 1030, 4)])
def test_store_map_with_a_short_last_range(b, s, n, grid):
    """B not a multiple of the tile and a last partial column tile, over
    grids that split the tiles unevenly: each output once, none past B or
    N (the emulation indexes [B, N] and would raise)."""
    luts, codes_t = _score_inputs(n, b, s, 16, n)
    plan = sk.lut16_score_plan(b, s, 16, n)
    assert b % plan.q_tile and n % plan.tile_cols
    covered = np.zeros(plan.units, np.int64)
    for cta in range(grid):
        t0, t1 = sk.lut16_score_units(plan, grid, cta)
        covered[t0:t1] += 1
    assert (covered == 1).all()
    _, writes = _emulate_kernel(luts, codes_t, torch.float32, plan, grid)
    assert (writes == 1).all()


def test_emulated_kernel_clamps_codes_past_c():
    """A code byte at or past C reads entry C - 1 of its own subspace, as
    the twin does on the clamped codes (it never reads another row)."""
    luts, codes_t = _score_inputs(3, 20, 4, 5, 300)
    codes_t[1, ::7] = 200
    plan = sk.lut16_score_plan(20, 4, 5, 300)
    got, _ = _emulate_kernel(luts, codes_t, torch.float32, plan, 2)
    want = sk.lut16_score_reference(
        torch.from_numpy(luts), torch.from_numpy(np.minimum(codes_t, 4)))
    assert torch.equal(got, want)


def _abs_sums(luts, codes_t):
    t = torch.from_numpy(luts).to(torch.bfloat16).float().abs().numpy()
    s = luts.shape[1]
    return t[:, np.arange(s)[:, None], codes_t.astype(np.int64)].sum(1)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s", [(5, 8), (70, 5)])
def test_emulated_kernel_matches_pallas(out_dtype, b, s):
    luts, codes_t = _score_inputs(7 * b + s, b, s, 16, 512)
    jdt = jnp.float32 if out_dtype == "float32" else jnp.bfloat16
    want = lut16_score_pallas(jnp.asarray(luts), jnp.asarray(codes_t),
                              tile_n=128, interpret=True, out_dtype=jdt)
    plan = sk.lut16_score_plan(b, s, 16, 512)
    got, _ = _emulate_kernel(luts, codes_t, getattr(torch, out_dtype), plan,
                             3)
    if out_dtype == "float32":
        tol = 1e-6 * _abs_sums(luts, codes_t)
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= tol).all(), float((err - tol).max())
    else:
        want_t = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
            torch.bfloat16)
        bits = [x.view(torch.int16).int() for x in (got, want_t)]
        assert int((bits[0] - bits[1]).abs().max()) <= 1


# -- routing ------------------------------------------------------------------


@pytest.fixture
def stub_card(monkeypatch):
    """The card's pieces stubbed: meta tensors and recording kernel
    entries (score, fused, tiled) in place of the built library."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(sk, "on_card", lambda t, fn_name: True)
    monkeypatch.setattr(sk, "_kernel_fns", lambda: (
        entry("column_per_thread"), entry("fused"), entry("query_tiled")))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    sk.reset_launches()
    yield calls
    sk.reset_launches()


@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_search_calls_take_the_query_tiled_kernel(stub_card, shape,
                                                  out_dtype):
    b, s, c, n = shape
    luts = torch.empty(b, s, c, device="meta")
    codes_t = torch.empty(s, n, dtype=torch.uint8, device="meta")
    out = sk.lut16_score(luts, codes_t, out_dtype)
    assert tuple(out.shape) == (b, n) and out.dtype == out_dtype
    (name, args), = stub_card
    plan = sk.lut16_score_plan(b, s, c, n)
    assert name == "query_tiled"
    assert args[3:] == (b, s, c, n, int(out_dtype == torch.bfloat16),
                        plan.q_tile, plan.stage_rows, 0)
    assert sk.LAUNCHES["lut16_score"] == 1
    assert sk.SCORE_LAUNCHES == {"query_tiled": 1, "column_per_thread": 0}


def test_the_old_kernel_only_by_request(stub_card):
    """``_score_launch(per_column=True)`` (the same-run yardstick) launches
    the one-column-a-thread kernel and counts it apart."""
    luts = torch.empty(128, 50, 16, device="meta")
    codes_t = torch.empty(50, 4096, dtype=torch.uint8, device="meta")
    sk._score_launch(luts, codes_t, torch.float32, per_column=True)
    assert [c[0] for c in stub_card] == ["column_per_thread"]
    assert stub_card[0][1][3:] == (128, 50, 16, 4096, 0, 0)
    assert sk.SCORE_LAUNCHES == {"query_tiled": 0, "column_per_thread": 1}
    assert sk.LAUNCHES["lut16_score"] == 1


def test_tables_past_shared_memory_raise_on_the_card(stub_card):
    luts = torch.empty(4, 200, 256, device="meta")
    codes_t = torch.empty(200, 10, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        sk.lut16_score(luts, codes_t)
    assert stub_card == [] and sk.LAUNCHES["lut16_score"] == 0


def test_cpu_tensors_take_the_twin():
    luts, codes_t = _score_inputs(1, 4, 3, 16, 50)
    sk.reset_launches()
    got = sk.lut16_score(torch.from_numpy(luts), torch.from_numpy(codes_t))
    assert sk.LAUNCHES["lut16_score"] == 0
    assert sum(sk.SCORE_LAUNCHES.values()) == 0
    assert torch.equal(got, sk.lut16_score_reference(
        torch.from_numpy(luts), torch.from_numpy(codes_t)))

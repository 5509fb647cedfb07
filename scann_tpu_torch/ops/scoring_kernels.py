"""Scoring kernels (counterpart of ``scann_tpu/ops/pallas_kernels.py``; the
name drops "pallas" because the kernels here are CUDA).

Three kernels, each with a plain PyTorch twin beside it. Two share one CUDA
source (``csrc/lut16_scoring.cu``):

  - :func:`lut16_score` — ``out[b, n] = Σ_s bf16(luts[b, s, codes_t[s, n]])``
    summed in float32, as float32 or bf16 (TPU kernel ``_lut16_kernel``),
    on the query-tiled kernel (:func:`lut16_score_plan`; the
    one-column-a-thread kernel it replaced stays as a yardstick behind
    ``_score_launch(per_column=True)``, counted apart in
    :data:`SCORE_LAUNCHES`);
  - :func:`lut16_fused_sweep` — the int8 LUT16 sweep over packed nibbles
    with the r:1 block minimum fused in: the [N, B] score matrix never
    reaches device memory (TPU kernel ``_lut16_fused_kernel``). Each output
    is one exact float32 integer ``(acc + 128*S_pad)*r + row % r``, so one
    minimum picks the best (sum, row) pair; blocks with no row below
    ``n_valid`` hold ``INVALID_COMBINED``.

The third has its own (``csrc/int8_dots.cu``):

  - :func:`int8_dots` — ``out[b, n] = Σ_d q[b, d] · float(codes_t[d, n])``,
    float32 queries against uint8 codes without a float copy of the codes
    in device memory (TPU kernel ``_int8_dots_kernel``); the scalar-quantized
    searcher folds its affine codec around it (``ops/asymmetric.py``).

CPU tensors take the twins; CUDA tensors launch the kernel or raise. Each
kernel launch adds one to its entry in :data:`LAUNCHES`. The LUT16 twins add
in the kernels' order (ascending subspace, float32 or int32) and stream N in
chunks, so they agree with the kernels bit for bit and never hold a
[B, S, N] gather; the int8-dots twin is a float32 matrix product, within
1e-5 of Σ_d |q_d · c_d| of the kernel's three bf16 tensor-core products.

The kernels take their shared-memory operands laid out here, in plain
PyTorch that the CPU tests reach: :func:`lut16_score_table_image` (a query
tile's bf16 tables, interleaved by query), :func:`lut16_fused_table_image`
(the int8 tables as wgmma's B operand) and :func:`int8_dots_query_image`
(the queries' bf16 x 3 split, :func:`split_bf16x3`, likewise).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from scann_tpu_torch.ops.lut16_scoring import sum_lut_entries
from scann_tpu_torch.types import MAX_SHARED_MEMORY, align_up, on_card

# Sentinel for blocks with no valid row in the fused output. Every real
# combined value is <= 255*S_pad*r + r - 1 < 2**24, far below it.
INVALID_COMBINED = 1e9

# Kernel launches since the last reset, one entry per kernel. Only a launch
# of a CUDA kernel counts, never a call of a plain twin; a run reads these to
# show that its main path went through the kernels.
LAUNCHES: Dict[str, int] = {"lut16_score": 0, "lut16_fused_sweep": 0,
                             "int8_dots": 0}
# lut16_score's launches by the kernel that served them: the query-tiled
# kernel every search path takes, or the one-column-a-thread kernel it
# replaced (a yardstick reached only through _score_launch(per_column=True))
SCORE_LAUNCHES: Dict[str, int] = {"query_tiled": 0, "column_per_thread": 0}

# the CUDA kernels' tiles (csrc/lut16_scoring.cu): the query-tiled score
# kernel's column groups of 8 lanes a CTA (kTiledThreads / kTiledLanes),
# code ring slots of each column half (kTiledRing) and query tiles, widest
# first; the
# one-column-a-thread score kernel's words per (subspace, code) row of 32
# queries; fused kernel code bytes per packed byte and stage (kFusedUnits x
# kFusedWin) and the largest block
SCORE_GROUPS, SCORE_RING = 32, 3
_SCORE_Q_TILES = (128, 64, 32, 16, 8)
_SCORE_ROW_WORDS = 17
_FUSED_STAGE_ROWS, _FUSED_MAX_R = 512, 1024
# the fused kernel's (queries per tile, code stages per warpgroup), widest
# first: the first whose shared memory fits serves a call
_FUSED_PLANS = ((128, 2), (64, 2), (64, 1))
# elements of the [B, T] accumulator one step of a twin holds
_TWIN_ELEMS = 1 << 24
# the int8-dots kernel's row tile (csrc/int8_dots.cu kRows); the transposed
# codes of the scalar-quantized dataset pad their columns to it
INT8_DOTS_TILE_N = 128
# the int8-dots kernel's query tile (kQ) and the dimensions one launch takes
# (kMaxKs k16 steps)
_INT8_Q, INT8_DOTS_MAX_D = 128, 128

_fns = None
_int8_fn = None


def reset_launches() -> None:
    for counts in (LAUNCHES, SCORE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _kernel_fns():
    global _fns
    if _fns is None:
        from scann_tpu_torch import native

        lib = native.load("lut16_scoring")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        score = lib.lut16_score
        score.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, vp]
        score.restype = ctypes.c_int
        fused = lib.lut16_fused_sweep
        fused.argtypes = [vp, vp, vp, i32, i32, i64, i64, i64, i32, i32, i32,
                          vp]
        fused.restype = ctypes.c_int
        tiled = lib.lut16_score_tiled
        tiled.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, i32, i32, vp]
        tiled.restype = ctypes.c_int
        _fns = (score, fused, tiled)
    return _fns


def _launch(fn, name: str, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# LUT16 scoring (#8)
# ---------------------------------------------------------------------------


def _check_score_args(luts: torch.Tensor, codes_t: torch.Tensor, out_dtype):
    if luts.dim() != 3 or codes_t.dim() != 2:
        raise ValueError("luts must be [B, S, C] and codes_t [S, N]")
    if not luts.is_floating_point():
        raise ValueError(f"luts must be floating point, got {luts.dtype}")
    if codes_t.dtype != torch.uint8:
        raise ValueError(f"codes_t must be uint8, got {codes_t.dtype}")
    if luts.shape[1] != codes_t.shape[0]:
        raise ValueError(f"luts have {luts.shape[1]} subspaces, codes_t "
                         f"{codes_t.shape[0]}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")


def lut16_score_reference(luts: torch.Tensor, codes_t: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Twin of the score kernel: [B, N] in ``out_dtype``. Table entries are
    rounded to bf16 (nearest even), summed in float32 in ascending s, and the
    sum rounded once to ``out_dtype``. Works on any device."""
    _check_score_args(luts, codes_t, out_dtype)
    b, n = luts.shape[0], codes_t.shape[1]
    table = luts.to(torch.bfloat16).float()
    out = torch.empty(b, n, dtype=out_dtype, device=luts.device)
    step = max(1, _TWIN_ELEMS // max(b, 1))
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        acc = torch.zeros(b, hi - lo, dtype=torch.float32, device=luts.device)
        out[:, lo:hi] = sum_lut_entries(table, codes_t[:, lo:hi], acc)
    return out


class ScorePlan(NamedTuple):
    """Launch plan of the query-tiled score kernel: ``q_tile`` queries a
    tile (``q_tile / 8`` a thread), ``cols`` neighbouring columns a thread,
    ``tile_cols`` columns a tile (32 column groups of 8 lanes),
    ``stage_rows`` code rows (subspaces) a ring slot, ``smem_bytes`` a CTA
    (the tile's tables, then the ring), and the ``q_tiles`` x
    ``col_tiles`` = ``units`` tiles the persistent grid shares out."""
    q_tile: int
    cols: int
    tile_cols: int
    stage_rows: int
    smem_bytes: int
    q_tiles: int
    col_tiles: int
    units: int


def lut16_score_smem_bytes(q_tile: int, s: int, c: int,
                           stage_rows: int) -> int:
    """Shared memory of one CTA of the query-tiled kernel: the tile's bf16
    tables (2 * q_tile * S * C bytes) and, for each of the CTA's two column
    halves, SCORE_RING slots of ``stage_rows`` code rows of tile_cols / 2 +
    16 bytes."""
    tile_cols = SCORE_GROUPS * _score_cols(q_tile)
    return (2 * q_tile * s * c
            + 2 * SCORE_RING * stage_rows * (tile_cols // 2 + 16))


def _score_cols(q_tile: int) -> int:
    """Columns a thread: 4 with 16 queries a thread, else 8."""
    return 4 if q_tile == 128 else 8


def lut16_score_plan(b: int, s: int, c: int, n: int) -> Optional[ScorePlan]:
    """The query-tiled kernel's plan for a [B, S, C] x [S, N] call: the
    widest query tile (128, 64, 32, 16 or 8, no wider than B needs) whose
    tables leave room for the code ring, with as many code rows a slot as
    fit, up to S; None where even 8 queries' tables do not fit a block's
    shared memory."""
    if b <= 0 or s <= 0 or c <= 0 or n <= 0:
        return None
    cap = max(_SCORE_Q_TILES[-1], 1 << (b - 1).bit_length())
    for q_tile in _SCORE_Q_TILES:
        if q_tile > cap:
            continue
        cols = _score_cols(q_tile)
        tile_cols = SCORE_GROUPS * cols
        room = MAX_SHARED_MEMORY - lut16_score_smem_bytes(q_tile, s, c, 0)
        rows = min(s, room // (2 * SCORE_RING * (tile_cols // 2 + 16)))
        if rows >= 1:
            q_tiles, col_tiles = -(-b // q_tile), -(-n // tile_cols)
            return ScorePlan(q_tile, cols, tile_cols, rows,
                             lut16_score_smem_bytes(q_tile, s, c, rows),
                             q_tiles, col_tiles, q_tiles * col_tiles)
    return None


def lut16_score_units(plan: ScorePlan, grid: int, cta: int
                      ) -> Tuple[int, int]:
    """Tiles [t0, t1) of CTA ``cta`` of a persistent grid of ``grid``: an
    even share of the q_tiles x col_tiles tiles, query tile major (tile t
    is query tile t // col_tiles, column tile t % col_tiles)."""
    return plan.units * cta // grid, plan.units * (cta + 1) // grid


def lut16_score_table_image(luts: torch.Tensor, q_tile: int) -> torch.Tensor:
    """The query-tiled kernel's tables, flat bf16: per tile of ``q_tile``
    queries (zero past B), [S*C][q_tile], so the q_tile entries of one
    (subspace, code) are contiguous (16 bytes = 8 queries) and the kernel
    copies a tile's tables into shared memory as they are."""
    b, s, c = luts.shape
    qt = -(-b // q_tile)
    t = luts.reshape(b, s * c)
    if qt * q_tile != b:
        t = torch.nn.functional.pad(t, (0, 0, 0, qt * q_tile - b))
    # one copy rounds to bf16 (nearest even) and transposes each tile
    img = torch.empty(qt, s * c, q_tile, dtype=torch.bfloat16,
                      device=luts.device)
    img.copy_(t.view(qt, q_tile, s * c).transpose(1, 2))
    return img.view(-1)


def _score_launch(luts: torch.Tensor, codes_t: torch.Tensor,
                  out_dtype: torch.dtype, *, per_column: bool = False
                  ) -> torch.Tensor:
    """Checks a card call, allocates the output and launches the
    query-tiled kernel, or with ``per_column`` the kernel it replaced (one
    column a thread, 32 queries a CTA; kept as a same-run yardstick, never
    reached by a search path)."""
    _check_score_args(luts, codes_t, out_dtype)
    if codes_t.device != luts.device:
        raise ValueError(f"codes_t is on {codes_t.device}, luts on "
                         f"{luts.device}")
    b, s, c = luts.shape
    n = codes_t.shape[1]
    # the least shared memory either kernel takes for these tables
    smem = (4 * _SCORE_ROW_WORDS * s * c if per_column
            else lut16_score_smem_bytes(_SCORE_Q_TILES[-1], s, c, 1))
    if smem > MAX_SHARED_MEMORY:
        raise ValueError(f"tables of S={s} x C={c} need {smem} bytes of "
                         f"shared memory, more than the {MAX_SHARED_MEMORY} "
                         f"a block has")
    out = torch.empty(b, n, dtype=out_dtype, device=luts.device)
    if b == 0 or n == 0:
        return out
    codes = codes_t.contiguous()
    bf16_out = int(out_dtype == torch.bfloat16)
    score, _, tiled = _kernel_fns()
    with torch.cuda.device(luts.device):
        stream = torch.cuda.current_stream(luts.device).cuda_stream
        if per_column:
            table = luts.to(torch.bfloat16).contiguous()
            _launch(score, "lut16_score", table.data_ptr(), codes.data_ptr(),
                    out.data_ptr(), b, s, c, n, bf16_out, stream)
        else:
            plan = lut16_score_plan(b, s, c, n)
            img = lut16_score_table_image(luts, plan.q_tile)
            _launch(tiled, "lut16_score", img.data_ptr(), codes.data_ptr(),
                    out.data_ptr(), b, s, c, n, bf16_out, plan.q_tile,
                    plan.stage_rows, stream)
    SCORE_LAUNCHES["column_per_thread" if per_column else "query_tiled"] += 1
    return out


def lut16_score(luts: torch.Tensor, codes_t: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Approximate distances [B, N] from per-query tables.

    Args:
        luts: [B, S, C] float32 per-query tables.
        codes_t: [S, N] uint8 transposed database codes (values below C).
        out_dtype: float32, or bf16, which halves the score matrix's bytes
            (candidates are re-ranked exactly anyway).

    CPU tensors go to :func:`lut16_score_reference`; CUDA tensors to the
    query-tiled CUDA kernel (:func:`lut16_score_plan`), built from
    ``csrc/lut16_scoring.cu`` at first use. A failed build or launch, or
    tables too large for the plan, raise: there is no fallback on the
    GPU."""
    if not on_card(luts, "lut16_score"):
        return lut16_score_reference(luts, codes_t, out_dtype)
    return _score_launch(luts, codes_t, out_dtype)


# ---------------------------------------------------------------------------
# fused int8 LUT16 sweep with the block minimum (#7)
# ---------------------------------------------------------------------------


def _check_fused_args(luts_i8: torch.Tensor, codes_packed_t: torch.Tensor,
                      r: int):
    """(B, sh, N, C) of a fused-sweep call."""
    if luts_i8.dim() != 2 or codes_packed_t.dim() != 2:
        raise ValueError("luts_i8 must be [B, S_pad*C] and codes_packed_t "
                         "[S_pad/2, N]")
    if luts_i8.dtype != torch.int8:
        raise ValueError(f"luts_i8 must be int8, got {luts_i8.dtype}")
    if codes_packed_t.dtype != torch.uint8:
        raise ValueError(f"codes_packed_t must be uint8, got "
                         f"{codes_packed_t.dtype}")
    b, width = luts_i8.shape
    sh, n = codes_packed_t.shape
    s_pad = 2 * sh
    c = width // s_pad if s_pad else 0
    if s_pad == 0 or c * s_pad != width or not 1 <= c <= 16:
        raise ValueError(f"LUT width {width} is not S_pad={s_pad} times a "
                         f"code count in [1, 16]")
    if r < 1 or n % r:
        raise ValueError(f"{n} rows are not a multiple of r={r}")
    if 255 * s_pad * r + r >= 1 << 24:
        raise ValueError(f"combined values 255*S_pad*r + r with S_pad={s_pad},"
                         f" r={r} reach 2**24: not exact in float32")
    return b, sh, n, c


def lut16_fused_sweep_reference(luts_i8: torch.Tensor,
                                codes_packed_t: torch.Tensor, n_valid: int,
                                r: int = 32) -> torch.Tensor:
    """Twin of the fused kernel: [N/r, B] float32 combined block minima.
    int32 sums over the packed bytes (low nibble through table row j, high
    nibble through row sh + j), then the combined value and the minimum.
    Works on any device."""
    b, sh, n, c = _check_fused_args(luts_i8, codes_packed_t, r)
    s_pad = 2 * sh
    device = luts_i8.device
    table = luts_i8.reshape(b, s_pad, c).to(torch.int32)
    out = torch.empty(n // r, b, dtype=torch.float32, device=device)
    step = max(r, _TWIN_ELEMS // max(b, 1) // r * r)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        acc = torch.zeros(b, hi - lo, dtype=torch.int32, device=device)
        for j in range(sh):
            v = codes_packed_t[j, lo:hi].long()
            acc.add_(table[:, j, :].index_select(1, v & 0xF))
            acc.add_(table[:, sh + j, :].index_select(1, v >> 4))
        rows = torch.arange(lo, hi, device=device)
        comb = ((acc + 128 * s_pad) * r + (rows % r).int()).float()
        comb = torch.where(rows < n_valid, comb, INVALID_COMBINED)
        out[lo // r:hi // r] = comb.view(b, -1, r).amin(dim=2).T
    return out


def lut16_fused_smem_bytes(sh: int, q_tile: int = 128,
                           stages: int = 2) -> int:
    """Shared memory of one CTA of the fused kernel at S_pad = 2*sh: its
    query tile's tables (q_tile * 32 bytes per packed byte), the code stages
    of its two warpgroups and their barriers, with 128 bytes of
    alignment."""
    return (128 + sh * q_tile * 32 + 2 * stages * sh * _FUSED_STAGE_ROWS
            + 8 * (2 * stages + 1))


def lut16_fused_plan(sh: int) -> Optional[Tuple[int, int]]:
    """(queries per tile, code stages per warpgroup) of the fused kernel
    at S_pad = 2*sh: 128 queries up to S_pad 74, 64 up to 150 (one stage
    per warpgroup past 112); None past that."""
    for q_tile, stages in _FUSED_PLANS:
        if lut16_fused_smem_bytes(sh, q_tile, stages) <= MAX_SHARED_MEMORY:
            return q_tile, stages
    return None


def lut16_fused_k32_tables(luts_i8: torch.Tensor, sh: int) -> torch.Tensor:
    """[B, S_pad*C] even-first int8 tables -> [B, sh, 32]: for packed byte
    j, the entries of table row j (the low nibble's subspace) then those of
    row sh + j (the high nibble's), each padded to 16 with zeros: the 32 k
    of the fused kernel's one-hot product step j."""
    b, width = luts_i8.shape
    c = width // (2 * sh)
    t = luts_i8.reshape(b, 2, sh, c)
    if c < 16:
        t = torch.nn.functional.pad(t, (0, 16 - c))
    return t.permute(0, 2, 1, 3).reshape(b, sh, 32)


def lut16_fused_table_image(luts_i8: torch.Tensor, sh: int,
                            q_tile: int = 128) -> torch.Tensor:
    """The fused kernel's shared-memory image of the tables, flat uint8: per
    tile of ``q_tile`` queries (zero past B), per packed byte j, wgmma's
    K-major B operand in the canonical no-swizzle layout: q_tile / 8 groups
    of 8 queries x 2 core matrices (k 0..15, k 16..31), each 8 queries x 16
    bytes."""
    k32 = lut16_fused_k32_tables(luts_i8, sh)
    b = k32.shape[0]
    full = k32.new_zeros(-(-b // q_tile) * q_tile, sh, 32)
    full[:b] = k32
    img = full.view(-1, q_tile // 8, 8, sh, 2, 16).permute(0, 3, 1, 4, 2, 5)
    return img.contiguous().view(torch.uint8).reshape(-1)


def lut16_fused_sweep(luts_i8: torch.Tensor, codes_packed_t: torch.Tensor,
                      n_valid: int, r: int = 32) -> torch.Tensor:
    """Fused LUT16 sweep + block minimum: [N/r, B] float32 combined values.

    Args:
        luts_i8: [B, S_pad*C] int8 quantized tables, even-first subspace
            order, biased by -128 (``hashes/lut.luts_i8_evenfirst``).
        codes_packed_t: [S_pad/2, N] uint8 packed nibbles, N % r == 0.
        n_valid: rows >= n_valid never win a block; a block with none
            below it holds INVALID_COMBINED.
        r: rows per block (the kernel takes a power of two in [8, 1024]).

    Decode: sumq = int(out) // r; row = block*r + int(out) % r;
    distance = sumq * multiplier + bias * S_real.

    CPU tensors go to :func:`lut16_fused_sweep_reference`; CUDA tensors to
    the CUDA kernel, or raise."""
    if not on_card(luts_i8, "lut16_fused_sweep"):
        return lut16_fused_sweep_reference(luts_i8, codes_packed_t, n_valid,
                                           r)
    b, sh, n, c = _check_fused_args(luts_i8, codes_packed_t, r)
    if codes_packed_t.device != luts_i8.device:
        raise ValueError(f"codes_packed_t is on {codes_packed_t.device}, "
                         f"luts_i8 on {luts_i8.device}")
    if r < 8 or r > _FUSED_MAX_R or r & (r - 1):
        raise ValueError(f"the CUDA kernel takes r a power of two in [8, "
                         f"{_FUSED_MAX_R}], got {r}")
    plan = lut16_fused_plan(sh)
    if plan is None:
        raise ValueError(
            f"S_pad={2 * sh} needs {lut16_fused_smem_bytes(sh, 64, 1)} bytes "
            f"of shared memory, more than the {MAX_SHARED_MEMORY} a block has")
    q_tile, stages = plan
    out = torch.empty(n // r, b, dtype=torch.float32, device=luts_i8.device)
    if b == 0 or n == 0:
        return out
    tables = lut16_fused_table_image(luts_i8, sh, q_tile)
    codes = codes_packed_t
    pitch = align_up(n, 16)
    if (codes.stride() != (pitch, 1) or pitch != n
            or codes.data_ptr() % 16):
        # TMA reads the rows at a 16-byte pitch from a 16-byte aligned start
        codes = codes_packed_t.new_zeros(sh, pitch)
        codes[:, :n] = codes_packed_t
    _, fused, _ = _kernel_fns()
    with torch.cuda.device(luts_i8.device):
        stream = torch.cuda.current_stream(luts_i8.device).cuda_stream
        _launch(fused, "lut16_fused_sweep", tables.data_ptr(),
                codes.data_ptr(), out.data_ptr(), b, sh, n, pitch,
                int(n_valid), r, q_tile, stages, stream)
    return out


# ---------------------------------------------------------------------------
# int8 dots (#9)
# ---------------------------------------------------------------------------


def _check_int8_args(queries: torch.Tensor, codes_t: torch.Tensor):
    if queries.dim() != 2 or codes_t.dim() != 2:
        raise ValueError("queries must be [B, D] and codes_t [D, N]")
    if queries.dtype != torch.float32:
        raise ValueError(f"queries must be float32, got {queries.dtype}")
    if codes_t.dtype != torch.uint8:
        raise ValueError(f"codes_t must be uint8, got {codes_t.dtype}")
    if queries.shape[1] != codes_t.shape[0]:
        raise ValueError(f"queries have D={queries.shape[1]}, codes_t "
                         f"{codes_t.shape[0]} rows")


def int8_dots_reference(queries: torch.Tensor,
                        codes_t: torch.Tensor) -> torch.Tensor:
    """Twin of the int8-dots kernel: the float32 product of ``queries``
    with the codes cast to float32. Works on any device."""
    _check_int8_args(queries, codes_t)
    return queries @ codes_t.float()


def split_bf16x3(queries: torch.Tensor) -> torch.Tensor:
    """[B, D] float32 -> [3, B, D] bf16 parts, each the rounding to nearest
    of what the previous parts leave: ``q0 = bf16(q)``, ``q1 = bf16(q -
    q0)``, ``q2 = bf16(q - q0 - q1)``. Each difference is exact in float32
    and the three parts sum to q exactly (24 significant bits in three
    8-bit parts), so the three products of the parts with codes 0..255
    (exact in bf16, each product exact in float32) give the float32 dots
    with float32 accumulation: the int8-dots kernel's tensor-core form."""
    q0 = queries.to(torch.bfloat16)
    r1 = queries - q0.float()
    q1 = r1.to(torch.bfloat16)
    q2 = (r1 - q1.float()).to(torch.bfloat16)
    return torch.stack([q0, q1, q2])


def int8_dots_query_image(queries: torch.Tensor) -> torch.Tensor:
    """The kernel's shared-memory image of the queries, flat uint8: per tile
    of 128 queries, per bf16 part, per k16 step, the K-major core matrices
    of wgmma's B operand (16 groups of 8 queries x 2 halves of 8 d, each
    8 x 16 bytes), zero past B and D."""
    b, d = queries.shape
    nks = -(-d // 16)
    qt = -(-b // _INT8_Q)
    parts = torch.zeros(3, qt * _INT8_Q, nks * 16, dtype=torch.bfloat16,
                        device=queries.device)
    parts[:, :b, :d] = split_bf16x3(queries)
    img = parts.view(3, qt, _INT8_Q // 8, 8, nks, 2, 8).permute(
        1, 0, 4, 2, 5, 3, 6)
    return img.contiguous().view(torch.uint8).reshape(-1)


def int8_dots_smem_bytes(d: int) -> int:
    """Shared memory of one CTA of the int8-dots kernel for one launch's
    min(d, INT8_DOTS_MAX_D) dimensions (csrc/int8_dots.cu smem_bytes): three
    code stages of 128 rows, two [128 queries x 64 rows] float32 output
    tiles, the query tile's three bf16 parts, the barriers, 1 KB of
    alignment."""
    rows = 16 * -(-min(d, INT8_DOTS_MAX_D) // 16)
    return (1024 + 3 * rows * INT8_DOTS_TILE_N + 2 * _INT8_Q * 64 * 4
            + 3 * rows * _INT8_Q * 2 + 8 * 4)


def _int8_dots_fn():
    global _int8_fn
    if _int8_fn is None:
        from scann_tpu_torch import native

        fn = native.load("int8_dots").int8_dots
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, i32, i32, i64, i64, i64, vp]
        fn.restype = ctypes.c_int
        _int8_fn = fn
    return _int8_fn


def _int8_dots_launch(queries: torch.Tensor,
                      codes_t: torch.Tensor) -> torch.Tensor:
    """One kernel launch over d <= INT8_DOTS_MAX_D: [B, N] float32."""
    b, d = queries.shape
    n = codes_t.shape[1]
    codes = codes_t
    if (codes.stride(1) != 1 or codes.stride(0) % 16
            or codes.data_ptr() % 16):
        # TMA reads rows at a 16-byte pitch from a 16-byte aligned start
        codes = torch.zeros(d, align_up(n, 16), dtype=torch.uint8,
                            device=codes_t.device)
        codes[:, :n] = codes_t
    pitch = align_up(n, 4)  # the TMA stores' 16-byte row pitch
    out = torch.empty(b, pitch, dtype=torch.float32, device=queries.device)
    img = int8_dots_query_image(queries)
    fn = _int8_dots_fn()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        _launch(fn, "int8_dots", img.data_ptr(), codes.data_ptr(),
                out.data_ptr(), b, d, n, codes.stride(0), pitch, stream)
    return out if pitch == n else out[:, :n].contiguous()


def int8_dots(queries: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """Raw dots [B, N] float32 of float32 queries [B, D] with uint8 codes
    ``codes_t`` [D, N]: ``out[b, n] = Σ_d q[b, d] · codes_t[d, n]``. The
    caller folds in the codec's scale and offset (``ops/asymmetric.py``).

    CPU tensors go to :func:`int8_dots_reference`; CUDA tensors to the CUDA
    kernel, built from ``csrc/int8_dots.cu`` at first use, or raise. The
    kernel takes D <= INT8_DOTS_MAX_D per launch; a wider D is summed over
    slices of that many dimensions, one launch each."""
    if not on_card(queries, "int8_dots"):
        return int8_dots_reference(queries, codes_t)
    _check_int8_args(queries, codes_t)
    if codes_t.device != queries.device:
        raise ValueError(f"codes_t is on {codes_t.device}, queries on "
                         f"{queries.device}")
    b, d = queries.shape
    n = codes_t.shape[1]
    if b == 0 or n == 0 or d == 0:
        return torch.zeros(b, n, dtype=torch.float32, device=queries.device)
    q = queries.contiguous()
    out = None
    for lo in range(0, d, INT8_DOTS_MAX_D):
        part = _int8_dots_launch(q[:, lo:lo + INT8_DOTS_MAX_D].contiguous(),
                                 codes_t[lo:lo + INT8_DOTS_MAX_D])
        out = part if out is None else out.add_(part)
    return out

// LUT16 scoring kernels for the asymmetric hasher on Hopper (sm_90a).
//
// Replaces two TPU kernels of scann_tpu/ops/pallas_kernels.py:
//   _lut16_kernel        :40   lut16_score_pallas (pallas_call :75)
//   _lut16_fused_kernel  :109  lut16_fused_sweep_pallas (pallas_call :171)
// with one source and three plain C entry points, loaded through ctypes:
// lut16_score_tiled (#8), lut16_score (#8's earlier form, a yardstick) and
// lut16_fused_sweep (#7).
//
// --- lut16_score (#8) ------------------------------------------------------
//
//   out[b, n] = sum_s bf16(lut[b, s, codes_t[s, n]])
//
// float32 sums in ascending s, written as float32 or bf16 (round to nearest
// even). The TPU kernel feeds a bf16 one-hot to its matrix unit; here the
// lookup is a lookup. The plain twin (ops/scoring_kernels.py::
// lut16_score_reference) adds the same bf16 entries in the same order in
// float32, so the two agree bit for bit (a tensor-core one-hot would not:
// its accumulation does not round each add as float32 does).
//
// What bounds it on the H100, at the approximate-only hasher's call (B =
// 128, S = 50, C = 16, 1,183,514 columns, float32 out): one float32 add
// per table entry, B*N*S = 7.57e9 adds, 0.226 ms at 33.5 T/s (one add a
// lane a clock on 128 lanes of 132 SMs); the bytes (codes once, the [B, N]
// scores once: 665 MB) 0.199 ms. Beside each add the CUDA cores issue the
// bf16 half's conversion (a shift or a mask) and a share of a shared load,
// so about 2.1 issue slots an entry: an issue floor near 0.48 ms; shared
// memory delivers 64 bf16 entries a clock an SM, a floor of 0.45 ms.
//
// The design (lut16_score_tiled_kernel, the form every search path takes;
// plan from ops/scoring_kernels.lut16_score_plan):
//  - Tables. A CTA stages a tile of Q queries' bf16 tables (Q = 128 where
//    they fit beside the code ring, else 64 .. 8) in shared memory
//    entry-major and interleaved by query, [S*C][Q], copied as they are
//    from an image the wrapper lays out (lut16_score_table_image). A
//    column group of 8 lanes shares a code: lane lq holds queries
//    8 (lq + 8k) + 0..7, so one 16-byte load returns 8 queries' entries
//    and a quarter warp's loads read 128 contiguous bytes of one row,
//    free of bank conflicts whatever the codes (checked on the CPU in
//    tests/test_torch_lut16_score_plan.py).
//  - Codes. The [S, N] u8 rows stream through a 3-slot cp.async ring, all S
//    rows of a column tile a slot where they fit, each row copied from the
//    16-byte aligned address at or below its first column (any N, any
//    alignment). A thread owns 4 neighbouring columns (8 below Q = 128)
//    and reads their codes as one word a row (two aligned words and a
//    funnel shift), clamped below C; a byte permute gives each lookup's
//    row.
//  - Adds. 4 columns x 16 queries = 64 float32 accumulators a thread, each
//    adding its entries in ascending s from 0.0f: w << 16 for the low
//    half, w & 0xFFFF0000 for the high one. No FMA contraction, denormals
//    kept (no --use_fast_math), as PyTorch adds.
//  - Grid. Persistent: as many CTAs as the card holds (one an SM at Q =
//    128, 226,400 bytes), each taking an even share of the (query tile,
//    column tile) tiles, query tile major, so a CTA restages its tables
//    only where its share crosses a query tile.
//  - Stores. Each query row of a thread's columns in one 16-byte (float32)
//    or 8-byte (bf16) store where the row's alignment allows, narrower
//    ones where it does not; rows at or past B and columns past N are never
//    written.
// The kernel it replaced (lut16_score_kernel: one column a thread, 32
// queries' tables a CTA as bf16 pairs, one code byte a subspace from global
// memory, a grid of 2.19 waves at B = 128) stays as a same-run yardstick,
// reached only through ops/scoring_kernels._score_launch(per_column=True).
//
// --- lut16_fused_sweep (#7) ------------------------------------------------
//
//   acc[n, b]  = sum_j lut_i8[b, j, lo(code[j, n])] + lut_i8[b, sh + j, hi(code[j, n])]
//   comb[n, b] = (acc + 128 * S_pad) * r + n % r,  INVALID_COMBINED where n >= n_valid
//   out[blk, b] = min over the r rows of block blk
//
// LUTs are int8 (u8 tables biased by -128), even-first: rows 0..sh-1 hold
// subspaces 0, 2, 4, ..., rows sh..2sh-1 subspaces 1, 3, 5, ... Byte j of a
// packed code column holds subspace 2j in its low nibble and 2j+1 in its
// high nibble. The sums are exact integers and the combined value is below
// 2^24, so kernel, twin and the TPU kernel agree bit for bit; the minimum
// picks the lowest row among equal sums.
//
// What bounds it on the H100, at B = 1024 over 1,183,744 rows, S_pad = 50:
// counted as the one-hot product the TPU runs, 1.94e12 int8 operations,
// 0.98 ms at the 1,979 TOPS int8 tensor-core peak; the bytes (29.6 MB of
// packed codes, 51 KB of tables, 151.5 MB of block minima) need 0.054 ms.
//
// The design: the one-hot int8 product on the tensor cores through wgmma
// (m64n128k32 s8, int32 sums), rows on M and queries on N. One k32 step is
// one packed byte: k 0..15 are the 16 codes of its low nibble (table row
// j), k 16..31 those of its high nibble (row sh + j).
//  - A, the one-hot, is built in registers from the nibbles: a thread's
//    four bytes for k = 4t..4t+3 are 1 << 8*(code - 4t) when the code falls
//    there, else 0 (a clamped shift). Two register sets alternate, so a set
//    is rebuilt only after the product reading it has completed.
//  - B, the tables of 128 queries, K-major in shared memory in the
//    canonical no-swizzle core-matrix layout, laid out by the wrapper
//    (sh x 4 KB); a CTA loads its query tile's tables once with a bulk copy
//    and keeps them for its whole life. The grid is one CTA per SM, the
//    SMs shared out among the query tiles, each CTA walking a range of rows.
//    Past S_pad 74 a tile of 128 queries' tables and the code stages no
//    longer fit a block's shared memory; S_pad up to 150 then takes tiles
//    of 64 queries (m64n64k32), with one code stage per warpgroup past
//    S_pad 112 (ops/scoring_kernels.lut16_fused_plan).
//  - The codes stream by TMA into a ring of two stages per warpgroup. The
//    rows are cut into units of max(r, 16) rows; an item is 32 units, one
//    per (warp, lane group g) of a warpgroup, and a stage holds 16 rows of
//    each of them (a 3-D box {16 rows, 32 units, sh bytes}). The kernel
//    builds A itself, so it chooses the row in each M slot: slots g and
//    g + 8 of warp w carry two rows of unit 8w + g, and successive 64-row
//    products walk through the units. Every row of a block thus meets in
//    one thread, whose running minimum of (sum + 128 S_pad) * r + row % r
//    over its 32 (or 16) queries needs no shuffle and no exchange; r = 8
//    keeps two blocks per 16-row unit, one per slot. The offset stays the
//    true row within the block, so the lowest row wins among equal sums.
//  - Two warpgroups take a CTA's items in turn, so one's one-hot and
//    minimum instructions overlap the other's products.

#include <cuda_bf16.h>
#include <limits.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// ---------------------------------------------------------------------------
// lut16_score, one column a thread (the yardstick)
// ---------------------------------------------------------------------------

constexpr int kScoreThreads = 256;     // one column per thread
constexpr int kScoreQ = 32;            // queries per CTA
constexpr int kScorePairs = kScoreQ / 2;
constexpr int kScoreRow = kScorePairs + 1;  // words per (s, code) row, padded
constexpr int kScoreTiles = 16;        // column tiles one CTA walks

template <bool BF16_OUT>
__global__ void __launch_bounds__(kScoreThreads)
lut16_score_kernel(const uint16_t* __restrict__ luts,  // [B, S, C] bf16 bits
                   const uint8_t* __restrict__ codes,  // [S, N]
                   void* __restrict__ out,             // [B, N]
                   int b, int s, int c, long long n, int q_tiles) {
  extern __shared__ uint32_t lut_w[];  // [S*C][kScoreRow]
  const int qt = blockIdx.x % q_tiles;
  const long long chunk = blockIdx.x / q_tiles;
  const int q0 = qt * kScoreQ;
  const int sc = s * c;

  // the tables of this CTA's queries, two queries per word: thread i reads
  // entry e of query pair p, neighbouring threads neighbouring entries
  for (int i = threadIdx.x; i < kScorePairs * sc; i += blockDim.x) {
    const int p = i / sc;
    const int e = i - p * sc;
    const int qa = q0 + 2 * p;
    const uint32_t lo = qa < b ? luts[(long long)qa * sc + e] : 0u;
    const uint32_t hi = qa + 1 < b ? luts[(long long)(qa + 1) * sc + e] : 0u;
    lut_w[e * kScoreRow + p] = lo | (hi << 16);
  }
  __syncthreads();

  const long long col_end = min(n, (chunk + 1) * kScoreTiles * kScoreThreads);
  for (long long col = chunk * kScoreTiles * kScoreThreads + threadIdx.x;
       col < col_end; col += kScoreThreads) {
    float acc[kScoreQ];
#pragma unroll
    for (int q = 0; q < kScoreQ; ++q) acc[q] = 0.0f;
    uint32_t code = codes[col];
    for (int si = 0; si < s; ++si) {
      const uint32_t next = si + 1 < s ? codes[(long long)(si + 1) * n + col] : 0u;
      // codes are below C; a larger byte reads entry C-1 rather than
      // another subspace's row
      const uint32_t* row = lut_w + (si * c + min(code, (uint32_t)(c - 1))) * kScoreRow;
#pragma unroll
      for (int p = 0; p < kScorePairs; ++p) {
        const uint32_t w = row[p];
        acc[2 * p] += __uint_as_float(w << 16);
        acc[2 * p + 1] += __uint_as_float(w & 0xFFFF0000u);
      }
      code = next;
    }
#pragma unroll
    for (int q = 0; q < kScoreQ; ++q) {
      if (q0 + q >= b) break;
      const long long o = (long long)(q0 + q) * n + col;
      if (BF16_OUT) {
        // round to nearest even, as torch.Tensor.to(torch.bfloat16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(acc[q]);
      } else {
        static_cast<float*>(out)[o] = acc[q];
      }
    }
  }
}

template <bool BF16_OUT>
int launch_score(const void* luts, const void* codes, void* out, int b, int s,
                 int c, long long n, cudaStream_t stream) {
  auto kernel = lut16_score_kernel<BF16_OUT>;
  const size_t smem = sizeof(uint32_t) * (size_t)s * c * kScoreRow;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int q_tiles = (b + kScoreQ - 1) / kScoreQ;
  const long long per_cta = (long long)kScoreTiles * kScoreThreads;
  const long long chunks = (n + per_cta - 1) / per_cta;
  const long long grid = chunks * q_tiles;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kScoreThreads, smem, stream>>>(
      static_cast<const uint16_t*>(luts), static_cast<const uint8_t*>(codes),
      out, b, s, c, n, q_tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// lut16_score, query-tiled (the form every search path launches)
// ---------------------------------------------------------------------------

constexpr int kTiledThreads = 256;  // 32 column groups of 8 lanes
constexpr int kTiledHalf = 128;     // threads of a half: 4 warps
constexpr int kTiledLanes = 8;      // lanes splitting a tile's queries
constexpr int kTiledRing = 3;       // code ring slots of each half

// The shape of one instance: QS queries a thread, a tile of Q = 8 QS
// queries; COLS neighbouring columns a thread, TC a tile, TC / 2 a half;
// ROW bytes a ring row of a half (its TC / 2 codes and the 16 the aligned
// copy may start before them); a lookup reads NL loads of LB bytes (16
// bytes = 8 queries' entries).
template <int QS>
struct Tiled {
  static constexpr int kQ = kTiledLanes * QS;
  static constexpr int kCols = QS == 16 ? 4 : 8;
  static constexpr int kTC = kTiledThreads / kTiledLanes * kCols;
  static constexpr int kHalfCols = kTC / 2;
  static constexpr int kRow = kHalfCols + 16;
  static constexpr int kLB = QS >= 8 ? 16 : 2 * QS;
  static constexpr int kNL = QS >= 8 ? QS / 8 : 1;
  static constexpr int kEntries = kLB / 2;  // a load's queries
};

struct TiledArgs {
  const uint8_t* img;    // [q_tiles][S*C][Q] bf16 (lut16_score_table_image)
  const uint8_t* codes;  // [S, N] u8, rows N bytes apart
  void* out;             // [B, N] float32 or bf16
  long long n;
  long long col_tiles;
  int b, s, c;
  int stage_rows;        // code rows a ring slot
  int tab_bytes;         // 2 * Q * S * C
};

__device__ __forceinline__ void tiled_cp_async16(void* smem, const void* gmem,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void tiled_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void tiled_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first column of half h of tile t, clamped to the last column: a
// half wholly past N reads (and never stores) the last column's codes.
template <int QS>
__device__ __forceinline__ long long tiled_half_col(const TiledArgs& a,
                                                   long long t, int h) {
  return min((t % a.col_tiles) * Tiled<QS>::kTC + h * Tiled<QS>::kHalfCols,
             a.n - 1);
}

// Copies ring item `item` of this CTA (tile t0 + item / nsc, code rows
// stage item % nsc) for half h into the half's slot, if the CTA has that
// item, and commits one cp.async group either way. Row j of a slot holds
// the kRow bytes from the 16-byte aligned address at or below the half's
// first column; pieces past the row's last column are zero-filled.
template <int QS>
__device__ __forceinline__ void tiled_copy(const TiledArgs& a, long long t0,
                                           long long items, int nsc,
                                           long long item, uint8_t* ring,
                                           int h) {
  using T = Tiled<QS>;
  if (item < items) {
    const long long t = t0 + item / nsc;
    const int st = (int)(item % nsc);
    const long long col0 = tiled_half_col<QS>(a, t, h);
    const int ncols = (int)min((long long)T::kHalfCols, a.n - col0);
    const int s0 = st * a.stage_rows;
    const int rows = min(a.stage_rows, a.s - s0);
    uint8_t* slot = ring + (item % kTiledRing) * a.stage_rows * T::kRow;
    constexpr int kPieces = T::kRow / 16;
    for (int i = threadIdx.x % kTiledHalf; i < rows * kPieces;
         i += kTiledHalf) {
      const int j = i / kPieces, k = i - j * kPieces;
      const uintptr_t src = reinterpret_cast<uintptr_t>(
          a.codes + (long long)(s0 + j) * a.n + col0);
      const uintptr_t base = src & ~uintptr_t(15);
      // a piece that holds a byte of the row is read whole (an aligned 16
      // bytes cannot cross a page)
      const bool live = 16 * k < (int)(src - base) + ncols;
      tiled_cp_async16(slot + j * T::kRow + 16 * k,
                       reinterpret_cast<const void*>(live ? base + 16 * k
                                                          : base),
                       live ? 16 : 0);
    }
  }
  tiled_commit();
}

// The kCols outputs of one query row, at dst (column col of N): whole
// 16-, 8- or 4-byte stores where the row and its alignment allow.
template <int COLS, bool BF16_OUT>
__device__ __forceinline__ void tiled_store(void* dst, const float (&v)[COLS],
                                            int valid) {
  constexpr int kBytes = COLS * (BF16_OUT ? 2 : 4);
  uint32_t w[kBytes / 4];
#pragma unroll
  for (int i = 0; i < kBytes / 4; ++i) {
    if (BF16_OUT) {
      // round to nearest even, as torch.Tensor.to(torch.bfloat16)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
              << 16);
    } else {
      w[i] = __float_as_uint(v[i]);
    }
  }
  const uint32_t mis = (uint32_t)reinterpret_cast<uintptr_t>(dst);
  if (valid >= COLS && (mis & 15) == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    if constexpr (kBytes == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else if (valid >= COLS && (mis & 7) == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i)
      reinterpret_cast<uint2*>(dst)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  } else if (valid >= COLS && (mis & 3) == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i)
      reinterpret_cast<uint32_t*>(dst)[i] = w[i];
  } else {
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc) {
      if (cc < valid) {
        if (BF16_OUT)
          static_cast<uint16_t*>(dst)[cc] =
              (uint16_t)(w[cc / 2] >> (16 * (cc & 1)));
        else
          static_cast<uint32_t*>(dst)[cc] = w[cc];
      }
    }
  }
}

// The tile's tables are [S*C][Q] bf16 (entry-major, query-interleaved):
// entry (s, code) of query q at byte 2 (((s C + code) Q) + q). Lane lq of
// a column group reads queries 8 (lq + 8 k) .. + 7 (load k, QS >= 8) or
// lq QS .. + QS - 1: the 8 lanes of a quarter warp share the group's code,
// so each 16-byte load instruction reads 128 contiguous bytes of one row,
// whatever the codes (no bank conflict). Accumulator j of a column holds
// query 8 (lq + 8 (j / 8)) + j % 8, or lq QS + j.
//
// The two halves of the CTA (4 warps each) score the two column halves of
// every tile, each with its own code ring and named barrier (1 + h); half
// 1 starts each run of tiles one ring item after half 0 (named barrier 3),
// so the halves' stores at the ends of their tiles alternate with the
// other half's lookups instead of all 8 warps storing at once. A table
// staging syncs the whole CTA.
template <int QS, bool BF16_OUT>
__global__ void __launch_bounds__(kTiledThreads, 1)
lut16_score_tiled_kernel(const TiledArgs a) {
  using T = Tiled<QS>;
  constexpr int kCols = T::kCols;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int h = tid / kTiledHalf;  // the column half
  uint8_t* tabs = smem;
  uint8_t* ring = smem + a.tab_bytes + h * kTiledRing * a.stage_rows * T::kRow;

  const int lane = tid & 31;
  const int lq = lane & (kTiledLanes - 1);
  // column group within the half; its first column in the half and tile
  const int cg = (tid % kTiledHalf >> 5) * (32 / kTiledLanes) + (lane >> 3);
  const int hc = cg * kCols;
  const int tid_c = h * T::kHalfCols + hc;
  // this CTA's tiles: an even share of the q_tiles x col_tiles tiles,
  // query tile major, so a CTA restages its tables at most a few times
  const long long units =
      (long long)((a.b + T::kQ - 1) / T::kQ) * a.col_tiles;
  const long long t0 = units * blockIdx.x / gridDim.x;
  const long long t1 = units * (blockIdx.x + 1) / gridDim.x;
  const int nsc = (a.s + a.stage_rows - 1) / a.stage_rows;
  const long long items = (t1 - t0) * nsc;
  // codes are below C; a larger byte reads entry C - 1, never another
  // subspace's row
  const uint32_t cmax4 = (uint32_t)(min(a.c, 256) - 1) * 0x01010101u;
  const uint32_t n16 = (uint32_t)(a.n & 15);
  const int row_bytes = a.c * 2 * T::kQ;  // one subspace's tables

  for (int i = 0; i < kTiledRing - 1; ++i)
    tiled_copy<QS>(a, t0, items, nsc, i, ring, h);

  long long cur_qt = -1;
  bool lead = false;  // half 0's first item after a table staging
  float acc[kCols][QS];
  for (long long it = 0; it < items; ++it) {
    const long long t = t0 + it / nsc;
    const int st = (int)(it % nsc);
    const long long qt = t / a.col_tiles;
    if (qt != cur_qt) {  // uniform over the block
      __syncthreads();   // every thread is done with the last tables
      const uint8_t* src = a.img + qt * (long long)a.tab_bytes;
      for (int i = tid; i < a.tab_bytes / 16; i += kTiledThreads)
        tiled_cp_async16(tabs + 16 * i, src + 16 * i, 16);
      tiled_commit();
      tiled_wait<0>();
      __syncthreads();
      cur_qt = qt;
      lead = h == 0;
      // half 1 starts once half 0 has scored its first item
      if (h == 1) asm volatile("bar.sync 3, %0;\n" ::"n"(kTiledThreads)
                               : "memory");
    }
    tiled_wait<kTiledRing - 2>();
    // the half's item is ready; its threads are done with item - 1's slot
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "n"(kTiledHalf)
                 : "memory");
    tiled_copy<QS>(a, t0, items, nsc, it + kTiledRing - 1, ring, h);
    if (st == 0) {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
        for (int j = 0; j < QS; ++j) acc[cc][j] = 0.0f;
    }
    const uint8_t* slot = ring + (it % kTiledRing) * a.stage_rows * T::kRow;
    const int s0 = st * a.stage_rows;
    const int rows = min(a.stage_rows, a.s - s0);
    // row j of the slot starts `shift` bytes before the half's first code
    uint32_t shift = ((uint32_t)reinterpret_cast<uintptr_t>(a.codes) +
                      (uint32_t)s0 * n16 +
                      (uint32_t)tiled_half_col<QS>(a, t, h)) & 15u;
    const uint8_t* tab_s = tabs + s0 * row_bytes + lq * T::kLB;
#pragma unroll 2
    for (int j = 0; j < rows; ++j) {
      const uint32_t pos = shift + hc;
      const uint8_t* rp = slot + j * T::kRow + (pos & ~3u);
      const uint32_t sh = (pos & 3u) * 8u;
      uint32_t w[kCols / 4];
      {
        const uint32_t x0 = *reinterpret_cast<const uint32_t*>(rp);
        const uint32_t x1 = *reinterpret_cast<const uint32_t*>(rp + 4);
        w[0] = __vminu4(__funnelshift_r(x0, x1, sh), cmax4);
        if constexpr (kCols == 8) {
          const uint32_t x2 = *reinterpret_cast<const uint32_t*>(rp + 8);
          w[1] = __vminu4(__funnelshift_r(x1, x2, sh), cmax4);
        }
      }
      shift = (shift + n16) & 15u;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const uint32_t code = __byte_perm(w[cc / 4], 0, 0x4440 + (cc & 3));
        const uint8_t* p = tab_s + code * (2 * T::kQ);
#pragma unroll
        for (int k = 0; k < T::kNL; ++k) {
          uint32_t e[4];
          if constexpr (T::kLB == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(p + 128 * k);
            e[0] = v.x, e[1] = v.y, e[2] = v.z, e[3] = v.w;
          } else if constexpr (T::kLB == 8) {
            const uint2 v = *reinterpret_cast<const uint2*>(p);
            e[0] = v.x, e[1] = v.y;
          } else if constexpr (T::kLB == 4) {
            e[0] = *reinterpret_cast<const uint32_t*>(p);
          } else {
            e[0] = *reinterpret_cast<const uint16_t*>(p);
          }
          // entries as float32: the high half masked, the low one shifted
#pragma unroll
          for (int i = 0; i < T::kEntries; ++i) {
            const uint32_t x = e[i / 2];
            acc[cc][8 * k + i] +=
                __uint_as_float((i & 1) ? (x & 0xFFFF0000u) : (x << 16));
          }
        }
      }
      tab_s += row_bytes;
    }
    if (lead) asm volatile("bar.arrive 3, %0;\n" ::"n"(kTiledThreads)
                           : "memory");
    lead = false;
    if (st != nsc - 1) continue;
    const long long col = (t % a.col_tiles) * T::kTC + tid_c;
    const int valid = (int)min((long long)kCols, a.n - col);
    if (valid <= 0) continue;
#pragma unroll
    for (int j = 0; j < QS; ++j) {
      const int ql = QS >= 8 ? 8 * (lq + 8 * (j / 8)) + j % 8 : lq * QS + j;
      const long long q = qt * T::kQ + ql;
      if (q >= a.b) continue;
      float v[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) v[cc] = acc[cc][j];
      uint8_t* dst = static_cast<uint8_t*>(a.out) +
                     (q * a.n + col) * (BF16_OUT ? 2 : 4);
      tiled_store<kCols, BF16_OUT>(dst, v, valid);
    }
  }
  tiled_wait<0>();
}

template <int QS, bool BF16_OUT>
int launch_tiled(const TiledArgs& a, cudaStream_t stream) {
  using T = Tiled<QS>;
  auto kernel = lut16_score_tiled_kernel<QS, BF16_OUT>;
  const int smem = a.tab_bytes + 2 * kTiledRing * a.stage_rows * T::kRow;
  // host queries that cost microseconds a launch, made once an instance
  // and device: the shared-memory limit (raised to what any call may
  // take) and the occupancy (once a shared-memory size too)
  static HostMemo limit, memo;
  int dev = 0, sms = 0, per_sm = 0, done = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = limit.get((uint32_t)(dev & 127), &done, [&](int*) {
         return cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
       })) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = memo.get((uint32_t)((dev & 127) << 24 | smem), &per_sm,
                      [&](int* v) {
                        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            v, kernel, kTiledThreads, smem);
                      })) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // a persistent grid: as many CTAs as the card holds at once, each
  // taking an even share of the tiles
  const long long units =
      (long long)((a.b + T::kQ - 1) / T::kQ) * a.col_tiles;
  const long long grid = min(units, (long long)sms * per_sm);
  kernel<<<(unsigned)grid, kTiledThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool BF16_OUT>
int dispatch_tiled(int q_tile, const TiledArgs& a, cudaStream_t stream) {
  switch (q_tile) {
    case 128: return launch_tiled<16, BF16_OUT>(a, stream);
    case 64: return launch_tiled<8, BF16_OUT>(a, stream);
    case 32: return launch_tiled<4, BF16_OUT>(a, stream);
    case 16: return launch_tiled<2, BF16_OUT>(a, stream);
    case 8: return launch_tiled<1, BF16_OUT>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// lut16_fused_sweep
// ---------------------------------------------------------------------------

constexpr int kFusedThreads = 256;  // two consumer warpgroups
constexpr int kFusedUnits = 32;     // units of an item: 4 warps x 8 lanes g
constexpr int kFusedWin = 16;       // rows of each unit one code stage holds
constexpr int kMaxStages = 2;       // code stages in flight per warpgroup
constexpr float kInvalidCombined = 1e9f;  // ops/scoring_kernels.INVALID_COMBINED

// The four one-hot int8 entries k = 4t..4t+3 of a 16-entry code, from
// code8 = 8 * code and t32 = 32 * t: byte (code - 4t) is 1 when the code
// falls in this thread's range, all 0 else. PTX's shl clamps shift amounts
// above 32 to 32 (the result is then 0), and code8 - t32 wraps to a large
// amount when code < 4t, so two instructions build the register.
__device__ __forceinline__ uint32_t onehot4(uint32_t code8, uint32_t t32) {
  uint32_t d;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(d) : "r"(1u), "r"(code8 - t32));
  return d;
}

// The A registers of one k32 step (the mma A layout: [0] slot g at k 4t..,
// [1] slot g + 8, [2] and [3] the same at k 16 + 4t..) from w, whose low
// byte is slot g's packed code and whose second byte is slot g + 8's: k
// 0..15 are the low nibble's one-hot, k 16..31 the high nibble's.
__device__ __forceinline__ void onehot_a(uint32_t (&a)[4], uint32_t w,
                                         uint32_t t32) {
  a[0] = onehot4((w << 3) & 0x78u, t32);
  a[1] = onehot4((w >> 5) & 0x78u, t32);
  a[2] = onehot4((w >> 1) & 0x78u, t32);
  a[3] = onehot4((w >> 9) & 0x78u, t32);
}

// D[64 x 128] (+)= A[64 x 32] (registers) * B[32 x 128] (shared memory),
// int8 in, int32 sums (the 128-query tile)
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 32] * B[32 x 64]: the 64-query tile of wide codes
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// The sums of one 64-row tile of a warpgroup over all sh packed bytes. The
// stage holds [sh][32 units][16 rows] codes; `codes` points at this
// thread's unit, and slots g and g + 8 take rows off and off + 1 of its
// window (off and off + 8 when two blocks share a unit). The one-hot
// registers are double-buffered: a set is rebuilt only after the product
// that reads it has completed.
template <bool kSplit, int kQ>
__device__ __forceinline__ void fused_tile(int (&acc)[kQ / 2], uint32_t tab,
                                           const uint8_t* codes, int sh,
                                           int off, uint32_t t32) {
  constexpr int kTableStep = kQ * 32;  // table bytes of one k32 step
  auto word = [&](int j) -> uint32_t {
    const uint8_t* c = codes + j * (kFusedUnits * kFusedWin);
    if (kSplit) return c[off] | ((uint32_t)c[off + 8] << 8);
    return *reinterpret_cast<const uint16_t*>(c + off);
  };
  uint32_t a0[4], a1[4];
#pragma unroll
  for (int i = 0; i < kQ / 2; ++i) fence_operand(acc[i]);
  onehot_a(a0, word(0), t32);
  wgmma_fence();
  for (int j = 0; j < sh; j += 2) {
    wgmma_s8_rs(acc, a0, kmajor_desc(tab + j * kTableStep, 128, 256), j != 0);
    wgmma_commit();
    if (j + 1 < sh) {
      const uint32_t w = word(j + 1);
      wgmma_wait<1>();  // the product that read a1 has completed
      onehot_a(a1, w, t32);
      wgmma_fence();
      wgmma_s8_rs(acc, a1, kmajor_desc(tab + (j + 1) * kTableStep, 128, 256),
                  1);
      wgmma_commit();
    }
    if (j + 2 < sh) {
      const uint32_t w = word(j + 2);
      wgmma_wait<1>();  // the product that read a0 has completed
      onehot_a(a0, w, t32);
      wgmma_fence();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kQ / 2; ++i) fence_operand(acc[i]);
}

// kQ queries per tile (the wgmma N: 128, or 64 where 128 queries' tables
// do not fit beside the code stages); nst code stages per warpgroup (2, or
// 1 for the widest codes)
template <bool kSplit, int kQ>
__global__ void __launch_bounds__(kFusedThreads, 1)
lut16_fused_kernel(const __grid_constant__ CUtensorMap codes_map,  // see launch
                   const uint8_t* __restrict__ tables,  // [q_tiles][sh][kQ*32]
                   float* __restrict__ out,             // [n_blocks, B]
                   int b, int sh, long long n_blocks, long long n_valid,
                   int r, int unit, long long n_items, int cpq, int nst) {
  constexpr int kBest = kQ / 4;  // queries of one thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int table_bytes = sh * kQ * 32;
  const int stage_bytes = sh * kFusedUnits * kFusedWin;
  uint8_t* tab_s = smem;
  uint8_t* stages = smem + table_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + 2 * nst * stage_bytes);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a CTA keeps one query tile's tables and walks a range of items (32
  // units each); its two warpgroups take the range's items in turn
  const int qt = blockIdx.x / cpq;
  const int part = blockIdx.x % cpq;
  const long long lo = n_items * part / cpq;
  const long long hi = n_items * (part + 1) / cpq;
  const int spi = unit / kFusedWin;  // code stages per item
  const long long my_items = hi - lo > wg ? (hi - lo - wg + 1) / 2 : 0;
  const long long seq = my_items * spi;
  const uint32_t full0 = smem_u32(bars + wg * nst);
  const uint32_t tbar = smem_u32(bars + 2 * nst);
  uint8_t* my_stages = stages + wg * nst * stage_bytes;
  const bool leader = (tid & 127) == 0;

  // stage i of this warpgroup: window i % spi of item i / spi
  auto issue = [&](long long i) {
    const long long item = lo + wg + 2 * (i / spi);
    const int slot = (int)(i % nst);
    const uint32_t bar = full0 + 8 * slot;
    mbar_expect_tx(bar, stage_bytes);
    tma_load_3d(smem_u32(my_stages + slot * stage_bytes), &codes_map, bar,
                (int)(i % spi) * kFusedWin, (int)(item * kFusedUnits), 0);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 * nst + 1; ++i)
      mbar_init(smem_u32(bars + i), 1);
    mbar_init_fence();
    mbar_expect_tx(tbar, table_bytes);
    bulk_load(smem_u32(tab_s), tables + (long long)qt * table_bytes,
              table_bytes, tbar);
  }
  __syncthreads();
  if (leader)
    for (long long i = 0; i < nst && i < seq; ++i) issue(i);
  mbar_wait(tbar, 0);

  const int p = 8 * warp + g;  // this thread's unit within an item
  const uint32_t t32 = 32u * t;
  const uint32_t tab = smem_u32(tab_s);
  const int bias = 256 * sh;  // 128 * S_pad
  int acc[kQ / 2];
  int best0[kBest], best1[kBest];
  long long i = 0;
  for (long long it = 0; it < my_items; ++it) {
    const long long u = (lo + wg + 2 * it) * kFusedUnits + p;
    const long long row0 = u * unit;
#pragma unroll
    for (int c = 0; c < kBest; ++c) best0[c] = best1[c] = INT_MAX;
    for (int st = 0; st < spi; ++st, ++i) {
      const int slot = (int)(i % nst);
      mbar_wait(full0 + 8 * slot, (uint32_t)((i / nst) & 1));
      const uint8_t* codes = my_stages + slot * stage_bytes + p * kFusedWin;
      for (int kk = 0; kk < kFusedWin / 2; ++kk) {
        // the unit's rows in slots g and g + 8, and their offsets in their
        // blocks
        const int r0 = kSplit ? kk : st * kFusedWin + 2 * kk;
        const int r1 = kSplit ? 8 + kk : r0 + 1;
        const int l0 = kSplit ? kk : r0;
        const int l1 = kSplit ? kk : r1;
        fused_tile<kSplit, kQ>(acc, tab, codes, sh, kSplit ? kk : 2 * kk,
                               t32);
        const bool v0 = row0 + r0 < n_valid;
        const bool v1 = row0 + r1 < n_valid;
        // acc[4 jj + e]: slot g, query 8 jj + 2t + e; acc[4 jj + 2 + e]:
        // slot g + 8, the same query
#pragma unroll
        for (int c = 0; c < kBest; ++c) {
          const int x0 = (acc[4 * (c >> 1) + (c & 1)] + bias) * r + l0;
          const int x1 = (acc[4 * (c >> 1) + 2 + (c & 1)] + bias) * r + l1;
          if (v0) best0[c] = min(best0[c], x0);
          if (kSplit) {
            if (v1) best1[c] = min(best1[c], x1);
          } else if (v1) {
            best0[c] = min(best0[c], x1);
          }
        }
      }
      warpgroup_sync(1 + wg);  // every thread has read the stage
      if (leader && i + nst < seq) issue(i + nst);
    }
    // the minima of this unit's block (two blocks when they share it) for
    // the thread's kBest queries
    const long long blk = kSplit ? 2 * u : u;
#pragma unroll
    for (int c = 0; c < kBest; ++c) {
      const int q = qt * kQ + 8 * (c >> 1) + 2 * t + (c & 1);
      if (q >= b) continue;
      if (blk < n_blocks)
        out[blk * b + q] =
            best0[c] == INT_MAX ? kInvalidCombined : (float)best0[c];
      if (kSplit && blk + 1 < n_blocks)
        out[(blk + 1) * b + q] =
            best1[c] == INT_MAX ? kInvalidCombined : (float)best1[c];
    }
  }
}

int launch_fused(const void* tables, const void* codes, void* out, int b,
                 int sh, long long n, long long n_pitch, long long n_valid,
                 int r, int q_tile, int nst, cudaStream_t stream) {
  if (b <= 0 || n <= 0) return 0;
  const bool split = r < kFusedWin;  // r = 8: two blocks share a unit
  const int unit = split ? kFusedWin : r;
  if (r < 8 || r > 1024 || (r & (r - 1)) || n % r || n_pitch % unit ||
      n > n_pitch || sh < 1 || sh > 256 || (q_tile != 128 && q_tile != 64) ||
      nst < 1 || nst > kMaxStages)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  // the packed codes [sh, n_pitch] seen as {row in unit, unit, byte j}; a
  // box is 16 rows of each of 32 units for every j, zero past the end
  const long long units = n_pitch / unit;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)unit, (cuuint64_t)units,
                              (cuuint64_t)sh};
  const cuuint64_t strides[2] = {(cuuint64_t)unit, (cuuint64_t)n_pitch};
  const cuuint32_t box[3] = {kFusedWin, kFusedUnits, (cuuint32_t)sh};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(codes),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const int smem = 128 + sh * q_tile * 32 +
                   2 * nst * sh * kFusedUnits * kFusedWin + 8 * (2 * nst + 1);
  auto kernel = q_tile == 128
                    ? (split ? lut16_fused_kernel<true, 128>
                             : lut16_fused_kernel<false, 128>)
                    : (split ? lut16_fused_kernel<true, 64>
                             : lut16_fused_kernel<false, 64>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const long long n_items = (units + kFusedUnits - 1) / kFusedUnits;
  const int q_tiles = (b + q_tile - 1) / q_tile;
  // one CTA per SM, the SMs shared out among the query tiles
  long long cpq = sms / q_tiles;
  if (cpq < 1) cpq = 1;
  if (cpq > n_items) cpq = n_items;
  const long long grid = q_tiles * cpq;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kFusedThreads, smem, stream>>>(
      map, static_cast<const uint8_t*>(tables), static_cast<float*>(out), b,
      sh, n / r, n_valid, r, unit, n_items, (int)cpq, nst);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launch (0 on success). The Python wrappers check shapes, types and limits.

// luts: [B, S, C] bf16; codes: [S, N] u8; out: [B, N] float32 or bf16.
extern "C" int lut16_score(const void* luts, const void* codes, void* out,
                           int b, int s, int c, long long n, int bf16_out,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_out) return launch_score<true>(luts, codes, out, b, s, c, n, st);
  return launch_score<false>(luts, codes, out, b, s, c, n, st);
}

// The query-tiled form. img: ceil(B / q_tile) tiles of [S*C][q_tile] bf16
// (ops/scoring_kernels.lut16_score_table_image); codes: [S, N] u8, rows N
// bytes apart, any alignment; out: [B, N] float32 or bf16. q_tile (8, 16,
// 32, 64 or 128) and stage_rows (code rows a ring slot, 1..S) from
// ops/scoring_kernels.lut16_score_plan.
extern "C" int lut16_score_tiled(const void* img, const void* codes,
                                 void* out, int b, int s, int c, long long n,
                                 int bf16_out, int q_tile, int stage_rows,
                                 void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const long long tab = 2LL * q_tile * s * c;
  const int tc = q_tile == 128 ? 128 : 256;  // Tiled<QS>::kTC
  if (s < 1 || c < 1 || stage_rows < 1 || stage_rows > s ||
      tab + 2LL * kTiledRing * stage_rows * (tc / 2 + 16) > 232448 ||
      reinterpret_cast<uintptr_t>(img) % 16)
    return (int)cudaErrorInvalidValue;
  const TiledArgs a = {static_cast<const uint8_t*>(img),
                       static_cast<const uint8_t*>(codes), out, n,
                       (n + tc - 1) / tc, b, s, c, stage_rows, (int)tab};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_out) return dispatch_tiled<true>(q_tile, a, st);
  return dispatch_tiled<false>(q_tile, a, st);
}

// tables: ceil(B/q_tile) query tiles of sh * q_tile * 32 bytes, the int8
// even-first tables in the wgmma B layout
// (ops/scoring_kernels.lut16_fused_table_image); codes: [sh, n_pitch] u8
// packed, 16-byte aligned, n_pitch a multiple of 16 and of r; out: [N/r, B]
// float32. r is a power of two in [8, 1024] dividing N; q_tile is 128 or 64
// and nst (code stages per warpgroup) 2 or 1, as
// ops/scoring_kernels.lut16_fused_plan chooses them.
extern "C" int lut16_fused_sweep(const void* tables, const void* codes,
                                 void* out, int b, int sh, long long n,
                                 long long n_pitch, long long n_valid, int r,
                                 int q_tile, int nst, void* stream) {
  return launch_fused(tables, codes, out, b, sh, n, n_pitch, n_valid, r,
                      q_tile, nst, static_cast<cudaStream_t>(stream));
}

// LUT16 scoring kernels for the asymmetric hasher on Hopper (sm_90a).
//
// Replaces two TPU kernels of scann_tpu/ops/pallas_kernels.py:
//   _lut16_kernel        :40   lut16_score_pallas (pallas_call :75)
//   _lut16_fused_kernel  :109  lut16_fused_sweep_pallas (pallas_call :171)
// with one source and two plain C entry points, lut16_score and
// lut16_fused_sweep, loaded through ctypes.
//
// --- lut16_score (#8) ------------------------------------------------------
//
//   out[b, n] = sum_s bf16(lut[b, s, codes_t[s, n]])
//
// float32 sums in ascending s, written as float32 or bf16 (round to nearest
// even). The TPU kernel feeds a bf16 one-hot to its matrix unit; here the
// lookup is a lookup. The plain twin (ops/scoring_kernels.py::
// lut16_score_reference) adds the same bf16 entries in the same order in
// float32, so the two agree bit for bit.
//
// What bounds it on the H100, at B = 1024 over 1,183,514 columns, S = 50,
// C = 16: the function's own work is one float32 add per table entry,
// B*N*S = 6.06e10 adds, 0.90 ms at the 67 TFLOP/s float32 peak; the bytes
// (the codes once, the bf16 [B, N] output once: 2.49 GB) need 0.74 ms at
// 3.35 TB/s. Each add needs a shared-memory table read, and shared memory
// serves one 32-lane wavefront per clock per SM, so ~4 ms is where this
// design ends. The design: a CTA holds the bf16 tables of 32 queries in shared
// memory as bf16 pairs (two queries per 32-bit word, so one load feeds two
// sums), laid out [s][code][query pair] with a row of 17 words, so the 16
// codes of a subspace fall in 16 different banks and a warp's loads never
// conflict. Each thread owns one column and keeps its 32 float32 sums in
// registers; the CTA walks 16 column tiles of 256 so the table slab is
// loaded once per 4096 columns. Codes are read coalesced, one byte per
// thread per subspace, the next one loaded before the current one is used.
// Outputs are written coalesced along N. A one-hot bf16 product on the
// tensor cores (as the TPU does it) escapes the shared-memory limit with 32x
// the operations (1.96 ms at the 989 TFLOP/s bf16 peak), at the price of
// the tensor cores' own addition order; later work.
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
// lut16_score
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

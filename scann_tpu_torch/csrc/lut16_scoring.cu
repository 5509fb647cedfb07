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
// The design is the TPU's own: the one-hot int8 product on the tensor cores
// (mma.sync m16n8k32 s8, int32 accumulate). Queries are the M side, rows
// the N side. One k32 step is one packed byte: k 0..15 are the 16 codes of
// its low nibble (LUT row j), k 16..31 those of its high nibble (LUT row
// sh + j). A fragments (tables) come from shared memory by ldmatrix, with
// rows padded to an odd multiple of 16 bytes so the eight rows of a matrix
// hit eight different bank groups. B fragments (one-hot) are built in
// registers from the nibbles: a thread's four bytes for k = 4t..4t+3 are
// 1 << 8*(code - 4t) when the code falls there, else 0 (a clamped shift:
// three integer instructions per register with the nibble's extraction).
// Column n of n-tile nt carries row 4n + nt of a 32-row chunk, so one
// 32-bit word of codes feeds all four n-tiles of a thread. A CTA owns 64
// queries (four m-tiles) and a tile of 1024 rows whose codes it stages in
// shared memory; each warp reduces one 32-row chunk at a time: the
// accumulators of a chunk never leave registers, a thread holds rows
// 8t..8t+7 of each of its queries, and two shuffles finish r = 32. Blocks
// of r > 32 rows carry a running minimum across chunks; blocks of 8 or 16
// rows end inside a thread or a lane pair.
// The one-hot registers still cost about as many integer instructions per
// k-step as there are mma instructions; wgmma, a deeper pipeline and more
// queries per warp are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

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

constexpr int kFusedThreads = 256;  // 8 warps
constexpr int kFusedQ = 64;         // queries per CTA: four m16 tiles
constexpr int kFusedM = kFusedQ / 16;
constexpr int kFusedRows = 1024;    // rows per CTA tile
constexpr float kInvalidCombined = 1e9f;  // ops/scoring_kernels.INVALID_COMBINED

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__global__ void __launch_bounds__(kFusedThreads)
lut16_fused_kernel(const int8_t* __restrict__ luts,   // [B, S_pad*16]
                   const uint8_t* __restrict__ codes,  // [sh, N]
                   float* __restrict__ out,            // [N/r, B]
                   int b, int sh, long long n, long long n_valid, int r,
                   int q_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int s_pad = 2 * sh;
  const int row_bytes = s_pad * 16;
  const int lut_stride = row_bytes + 16;  // an odd multiple of 16 bytes
  uint8_t* lut_s = smem;                                 // [kFusedQ][lut_stride]
  uint8_t* code_s = smem + kFusedQ * lut_stride;         // [sh][kFusedRows]

  const int qt = blockIdx.x % q_tiles;
  const long long tile = blockIdx.x / q_tiles;
  const int q0 = qt * kFusedQ;
  const long long row0 = tile * kFusedRows;
  const int tid = threadIdx.x;

  // stage the tables (16-byte chunks, zero rows past B) ...
  for (int i = tid; i < kFusedQ * s_pad; i += kFusedThreads) {
    const int q = i / s_pad;
    const int ch = i - q * s_pad;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + q < b)
      v = reinterpret_cast<const uint4*>(luts + (long long)(q0 + q) * row_bytes)[ch];
    *reinterpret_cast<uint4*>(lut_s + q * lut_stride + ch * 16) = v;
  }
  // ... and the tile's packed codes (zero columns past N)
  if (n % 16 == 0) {
    constexpr int kChunks = kFusedRows / 16;
    for (int i = tid; i < sh * kChunks; i += kFusedThreads) {
      const int j = i / kChunks;
      const int ch = i - j * kChunks;
      const long long col = row0 + ch * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col < n) v = *reinterpret_cast<const uint4*>(codes + j * n + col);
      *reinterpret_cast<uint4*>(code_s + j * kFusedRows + ch * 16) = v;
    }
  } else {
    for (int i = tid; i < sh * kFusedRows; i += kFusedThreads) {
      const int j = i / kFusedRows;
      const int x = i - j * kFusedRows;
      code_s[i] = row0 + x < n ? codes[j * n + row0 + x] : 0;
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t t32 = 32u * t;
  const int rr = r < 32 ? r : 32;                 // rows of a block inside a chunk
  const int levels = rr == 32 ? 2 : rr == 16 ? 1 : 0;  // shuffles to finish it
  const int group = (1 << levels) - 1;
  const int unit = r < 32 ? 32 : r;               // rows a warp walks at once
  const int bias = 128 * s_pad;
  const long long n_blocks = n / r;
  // ldmatrix: lane i addresses row (i % 8) of matrix i / 8; matrices 1 and
  // 3 are query rows 8..15, matrices 2 and 3 the high-nibble table row
  const int lm_q = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_hi = lane >> 4;

  for (int u = warp; u * unit < kFusedRows; u += kFusedThreads / 32) {
    if (row0 + (long long)u * unit >= n) break;
    int best[kFusedM][2];
#pragma unroll
    for (int m = 0; m < kFusedM; ++m) best[m][0] = best[m][1] = INT_MAX;

    for (int ch = 0; ch * 32 < unit; ++ch) {
      const int crow = u * unit + ch * 32;  // chunk's first row in the tile
      int acc[kFusedM][4][4];
#pragma unroll
      for (int m = 0; m < kFusedM; ++m)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0;

      for (int j = 0; j < sh; ++j) {
        // codes of rows crow + 4g .. crow + 4g + 3, byte nt for n-tile nt
        const uint32_t cw =
            *reinterpret_cast<const uint32_t*>(code_s + j * kFusedRows + crow + 4 * g);
        uint32_t a[kFusedM][4];
#pragma unroll
        for (int m = 0; m < kFusedM; ++m)
          ldsm_x4(a[m], lut_s + (m * 16 + lm_q) * lut_stride +
                            (lm_hi ? sh + j : j) * 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // 8 * the low and the high nibble of byte nt
          const uint32_t lo8 = ((cw >> (8 * nt)) << 3) & 0x78u;
          const uint32_t hi8 = (cw >> (8 * nt + 1)) & 0x78u;
          const uint32_t b0 = onehot4(lo8, t32);
          const uint32_t b1 = onehot4(hi8, t32);
#pragma unroll
          for (int m = 0; m < kFusedM; ++m) mma_s8(acc[m][nt], a[m], b0, b1);
        }
      }

      // acc[m][nt][2h + e]: query 16m + g + 8h, chunk row 8t + 4e + nt
      const long long chunk_row0 = row0 + crow;
#pragma unroll
      for (int m = 0; m < kFusedM; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v = INT_MAX;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = 8 * t + 4 * e + nt;
              const int local = r >= 32 ? ch * 32 + row : (row & (r - 1));
              int val = (acc[m][nt][2 * h + e] + bias) * r + local;
              if (chunk_row0 + row >= n_valid) val = INT_MAX;
              v = min(v, val);
            }
          }
          for (int l = 0; l < levels; ++l)
            v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1 << l));
          if (r >= 32) {
            best[m][h] = min(best[m][h], v);
          } else if ((m & group) == (t & group)) {
            const long long blk = chunk_row0 / r + (t >> levels);
            const int q = q0 + 16 * m + g + 8 * h;
            if (blk < n_blocks && q < b)
              out[blk * b + q] = v == INT_MAX ? kInvalidCombined : (float)v;
          }
        }
      }
    }

    if (r >= 32) {
      // all four lanes of a group hold the block's minimum; lane t writes
      // m-tile t
      const long long blk = (row0 + (long long)u * unit) / r;
#pragma unroll
      for (int m = 0; m < kFusedM; ++m) {
        if (m != t) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + 16 * m + g + 8 * h;
          const int v = best[m][h];
          if (blk < n_blocks && q < b)
            out[blk * b + q] = v == INT_MAX ? kInvalidCombined : (float)v;
        }
      }
    }
  }
}

int launch_fused(const void* luts, const void* codes, void* out, int b, int sh,
                 long long n, long long n_valid, int r, cudaStream_t stream) {
  const size_t smem = (size_t)kFusedQ * (2 * sh * 16 + 16) + (size_t)sh * kFusedRows;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lut16_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int q_tiles = (b + kFusedQ - 1) / kFusedQ;
  const long long tiles = (n + kFusedRows - 1) / kFusedRows;
  const long long grid = tiles * q_tiles;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  lut16_fused_kernel<<<(unsigned)grid, kFusedThreads, smem, stream>>>(
      static_cast<const int8_t*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), b, sh, n, n_valid, r, q_tiles);
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

// luts: [B, 2*sh*16] int8 even-first; codes: [sh, N] u8 packed; out: [N/r, B]
// float32. r is a power of two in [8, 1024] dividing N.
extern "C" int lut16_fused_sweep(const void* luts, const void* codes, void* out,
                                 int b, int sh, long long n, long long n_valid,
                                 int r, void* stream) {
  return launch_fused(luts, codes, out, b, sh, n, n_valid, r,
                      static_cast<cudaStream_t>(stream));
}

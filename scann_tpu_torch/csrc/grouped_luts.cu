// Tree-x-AH's grouped bf16 tables on Hopper (sm_90a), written straight
// from the un-expanded float32 tables.
//
// Replaces no TPU kernel: the JAX package builds the grouped scorer's
// tables (_residual_luts, _group_luts) from XLA operations, and the port
// built them from PyTorch operations: a [B, p, S, C] float32 expansion of
// the per-query tables, the partition bias added in place, the pad
// subspaces, a bf16 cast, the even-first `cat` and a gather into slot
// order. This kernel writes the result of that composition and nothing
// else (ops/grouped_luts.grouped_luts_reference is its plain twin):
//
//     out[slot[i], :] = the table of pair i = (b, t), i = b*p + t:
//         tables[b]  (per-query source: the inner-product tables, the same
//                     for every partition a query probes)
//         tables[i]  (per-pair source: the squared-L2 tables of the
//                     residual queries, or any flat [B*p, S_pad, C] tables)
//         + bias[i] on subspace 0's C entries, a float32 add (the
//           partition term -<q, c_t> of the inner-product path; the
//           per-query source only)
//         + zeros for the pad subspaces S_src..S_pad-1
//         rounded once to bf16, to nearest even (torch's `.to(bfloat16)`)
//         in even-first subspace order when the codes are packed
//         (subspace 2j at position j < S_pad/2, 2j+1 at S_pad/2 + j)
//     out[r, :] = 0 for every row r that no pair's slot names: the unused
//         slots of partly filled groups and the rows of unused groups.
//         The grouped scorer scores them and nothing reads their scores;
//         zeros keep them finite and the same from call to call.
//
// Rows a pair names are bit for bit the composition's: the same float32
// add of the same operands, then one rounding.
//
// Layouts: tables [N, S_src, C] float32 (N = B per query, B*p per pair),
// bias [B*p] float32 or none (none on the per-pair source), slot [B*p]
// int64 (each row of out at most once, as group_pairs_by_partition gives
// them), out [rows, S_pad*C] bf16, used [rows] u8 scratch.
//
// What bounds it on the H100. The work is a copy: the kernel must write
// rows * S_pad * C * 2 bytes and read the source once. At the 1536-d
// deployment's shape (B 1,024, p 100, S 768, C 16, q_cap 8, NG 15,360) it
// writes 122,880 rows of 24,576 bytes, 3.02 GB, 0.90 ms at 3.35 TB/s, and
// reads 50 MB of per-query tables; the composition it replaces moved about
// 23 GB, most of it through a strided clone. On the per-pair source (sift,
// S 64) it reads 420 MB and writes about 280 MB. The design:
//   - one block per query. On the per-query source the block stages its
//     query's row once in shared memory, already rounded to bf16, padded
//     and in output order (S_pad * C * 2 bytes: 24,576 at S 768), and its
//     warps copy it to the p slot rows with 16-byte stores, recomputing
//     only subspace 0's C entries per pair (source + bias, read through L1)
//     when there is a bias. The source is read once per query, the rows
//     are written once: the bytes the bound counts. On the per-pair source
//     each warp converts its pair's row on the way, from 16-byte loads;
//   - rows no pair names are found in one pass before the kernel: the
//     entry point clears `used` and a small kernel marks used[slot[i]];
//     blocks after the B query blocks (kZeroRows rows each) write zeros to
//     the unmarked rows. Three device operations, one call from the host;
//   - 256 threads a block, shared memory only for the staged row, so about
//     eight blocks an SM: at B 1,024 the query blocks run in one wave.
// PERF.md gives the measured time against this bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kZeroRows = 64;     // rows a zero-writing block checks
constexpr int kMarkThreads = 256;

struct Args {
  const float* tables;       // [N, s_src, c]
  const float* bias;         // [b*p] or nullptr; nullptr per pair
  const long long* slot;     // [b*p]
  const uint8_t* used;       // [rows]
  uint16_t* out;             // [rows, s_pad*c] bf16 bits
  long long rows;
  int b, p, s_src, s_pad, c;
  int packed;
  int vec_store;             // s_pad*c a multiple of 8: 16-byte stores
  int vec_load;              // c a multiple of 8, tables 16-byte aligned
};

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// the source subspace at output position j
__device__ __forceinline__ int subspace_at(int j, int s_pad, int packed) {
  if (!packed) return j;
  const int half = s_pad >> 1;
  return j < half ? 2 * j : 2 * (j - half) + 1;
}

// bf16 of the 8 output entries of chunk k of a pair's row, read from the
// source row `src` (per-pair source)
__device__ __forceinline__ void load_chunk(const Args& a, const float* src,
                                           int k, uint16_t h[8]) {
  const int e0 = 8 * k;
  if (a.vec_load) {
    // c % 8 == 0: the chunk lies in one subspace, 32-byte aligned
    const int j = e0 / a.c;
    const int s = subspace_at(j, a.s_pad, a.packed);
    if (s < a.s_src) {
      const float4* p4 =
          reinterpret_cast<const float4*>(src + s * a.c + (e0 - j * a.c));
      const float4 x0 = p4[0], x1 = p4[1];
      h[0] = bf16_bits(x0.x); h[1] = bf16_bits(x0.y);
      h[2] = bf16_bits(x0.z); h[3] = bf16_bits(x0.w);
      h[4] = bf16_bits(x1.x); h[5] = bf16_bits(x1.y);
      h[6] = bf16_bits(x1.z); h[7] = bf16_bits(x1.w);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) h[q] = 0;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int e = e0 + q, j = e / a.c;
    const int s = subspace_at(j, a.s_pad, a.packed);
    h[q] = s < a.s_src ? bf16_bits(src[s * a.c + (e - j * a.c)]) : 0;
  }
}

__device__ void zero_rows(const Args& a, long long z, int warp, int lane) {
  const int w = a.s_pad * a.c;
  for (int q = warp; q < kZeroRows; q += kWarps) {
    const long long r = z * kZeroRows + q;
    if (r >= a.rows || a.used[r]) continue;
    uint16_t* dst = a.out + r * w;
    if (a.vec_store) {
      for (int k = lane; k < w / 8; k += 32)
        reinterpret_cast<uint4*>(dst)[k] = make_uint4(0, 0, 0, 0);
    } else {
      for (int e = lane; e < w; e += 32) dst[e] = 0;
    }
  }
}

template <bool kPerPair>
__global__ void __launch_bounds__(kThreads)
    grouped_luts_kernel(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((int)blockIdx.x >= a.b) {
    zero_rows(a, (long long)blockIdx.x - a.b, warp, lane);
    return;
  }
  const int b = blockIdx.x;
  const int w = a.s_pad * a.c;
  const float* src_q = a.tables + (long long)b * a.s_src * a.c;
  extern __shared__ __align__(16) uint16_t row[];
  if constexpr (!kPerPair) {
    // the query's row once: bf16, padded, in output order
    for (int e = threadIdx.x; e < w; e += kThreads) {
      const int j = e / a.c;
      const int s = subspace_at(j, a.s_pad, a.packed);
      row[e] = s < a.s_src ? bf16_bits(src_q[s * a.c + (e - j * a.c)]) : 0;
    }
    __syncthreads();
  }
  for (int t = warp; t < a.p; t += kWarps) {
    const long long i = (long long)b * a.p + t;
    const long long r = a.slot[i];
    if (r < 0 || r >= a.rows) continue;
    uint16_t* dst = a.out + r * w;
    const float* src = kPerPair ? a.tables + i * a.s_src * a.c : src_q;
    // subspace 0 sits at positions 0..c-1 in either order
    const bool biased = !kPerPair && a.bias != nullptr;
    const float bias = biased ? a.bias[i] : 0.0f;
    if (a.vec_store) {
      for (int k = lane; k < w / 8; k += 32) {
        uint16_t h[8];
        if constexpr (kPerPair) {
          load_chunk(a, src, k, h);
        } else {
          const uint4 v = reinterpret_cast<const uint4*>(row)[k];
          memcpy(h, &v, 16);
          if (biased && 8 * k < a.c) {
            // a select, not a conditional store: the store put h on the
            // stack (24 bytes spilled)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              h[q] = 8 * k + q < a.c
                         ? bf16_bits(__fadd_rn(src[8 * k + q], bias)) : h[q];
          }
        }
        uint4 v;
        memcpy(&v, h, 16);
        reinterpret_cast<uint4*>(dst)[k] = v;
      }
    } else {
      for (int e = lane; e < w; e += 32) {
        uint16_t h;
        if constexpr (kPerPair) {
          const int j = e / a.c;
          const int s = subspace_at(j, a.s_pad, a.packed);
          h = s < a.s_src ? bf16_bits(src[s * a.c + (e - j * a.c)]) : 0;
        } else {
          h = biased && e < a.c ? bf16_bits(__fadd_rn(src[e], bias)) : row[e];
        }
        dst[e] = h;
      }
    }
  }
}

__global__ void mark_used_kernel(const long long* slot, long long bp,
                                 long long rows, uint8_t* used) {
  const long long i = (long long)blockIdx.x * kMarkThreads + threadIdx.x;
  if (i >= bp) return;
  const long long r = slot[i];
  if (r >= 0 && r < rows) used[r] = 1;
}

}  // namespace

// Plain C entry point for ctypes. Clears `used` (rows bytes of scratch the
// caller allocates), marks the rows the slots name and launches the
// kernel, all on `stream`; does not synchronise. Returns
// cudaGetLastError() after the launches (0 on success). `per_pair` selects
// the per-pair source ([b*p, s_src, c]), which takes no bias; `bias` may be
// null; `vec_load`
// says c % 8 == 0 and `tables` is 16-byte aligned.
extern "C" int grouped_luts_bf16(const void* tables, const void* bias,
                                 const void* slot, void* used, void* out,
                                 int b, int p, int per_pair, int s_src,
                                 int s_pad, int c, long long rows, int packed,
                                 int vec_load, void* stream) {
  if (b <= 0 || p <= 0 || s_src <= 0 || s_src > s_pad || c <= 0 ||
      rows <= 0 || (packed && (s_pad & 1)) || (per_pair && bias != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long w = (long long)s_pad * c;
  const long long bp = (long long)b * p;
  const long long blocks = b + (rows + kZeroRows - 1) / kZeroRows;
  if (blocks > 0x7fffffffLL || w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(used, 0, (size_t)rows, s);
  if (err != cudaSuccess) return (int)err;
  mark_used_kernel<<<(unsigned)((bp + kMarkThreads - 1) / kMarkThreads),
                     kMarkThreads, 0, s>>>(
      static_cast<const long long*>(slot), bp, rows,
      static_cast<uint8_t*>(used));
  const Args a = {static_cast<const float*>(tables),
                  static_cast<const float*>(bias),
                  static_cast<const long long*>(slot),
                  static_cast<const uint8_t*>(used),
                  static_cast<uint16_t*>(out),
                  rows, b, p, s_src, s_pad, c, packed,
                  (int)(w % 8 == 0), vec_load && c % 8 == 0};
  auto kernel = per_pair ? grouped_luts_kernel<true>
                         : grouped_luts_kernel<false>;
  const size_t smem = per_pair ? 0 : (size_t)w * 2;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Grouped leaf scorer for tree-x-AH search on Hopper (sm_90a).
//
// Replaces the TPU kernel scann_tpu/ops/tree_ah_grouped.py::_kernel
// (tree_ah_grouped_scores_pallas), both of its branches. The (query,
// partition) pairs of a batch are grouped by partition, at most q_cap pairs
// per group; for group g the kernel scores every candidate column l of the
// group's CSR code slice:
//
//     out[g*q_cap + q, l] = sum_s lut[g, q, s, code_s(off_g + l)]
//
//   - bf16 tables (#1): float32 sums of the bf16 entries, rounded to bf16
//     (round to nearest even); masked slots bf16(MASKED_DISTANCE);
//   - int8 tables (#1b, the TPU kernel's int8 branch): exact int32 sums of
//     the int8 entries, stored as int16 (|sum| <= 128 * S_pad < 32767, which
//     the wrapper checks); masked slots I16_MASK = 32767.
//
// Slots l >= size_g are masked; a tile that starts at or past size_g (every
// tile of an unused group, whose size is 0) is written masked without
// reading codes.
//
// Layouts (the JAX package's, unchanged):
//   luts    [NG*q_cap, S_pad*C] bf16 or int8; with packed codes the
//           subspace order is even-first (subspaces 0,2,4,..., then 1,3,5,...);
//   codes   packed: [S_pad/2, N_csr] u8, byte j = subspace 2j in the low
//           nibble and 2j+1 in the high nibble; unpacked: [S_pad, N_csr] u8;
//   offsets [NG] i32 first CSR column of each group's partition;
//   sizes   [NG] i32 partition size (0 for unused groups);
//   out     [NG*q_cap, l_cap] bf16 or int16.
//
// What bounds it on the H100: per candidate column the kernel reads S_pad/2
// bytes of codes (32 B at S=50) and writes q_cap scores (2 B each); the LUT
// rows are read once per block (q_cap*S_pad*C entries: 16 KB bf16 or 8 KB
// int8 at q_cap=8) and then come from shared memory, where every lookup of a
// warp falls in the banks of one 16-entry row, so lookups never conflict.
// The design: grid (NG, L-tiles); each block stages its group's LUT rows in
// shared memory, then each thread walks one candidate column at a time,
// neighbour threads on neighbour code bytes (coalesced), with q_cap
// accumulators in registers (float32, or int32 for int8 tables). The sum
// runs over subspaces in the same order as the PyTorch twin
// (tree_ah_grouped_scores_reference), additions only, so kernel and twin
// agree bit for bit (exactly, for integer sums). The TPU kernel contracts a
// one-hot matrix on the MXU; here a lookup and an add per entry do the same
// work without the one-hot. Staging code tiles with cp.async/TMA and
// keeping 16-entry tables in registers are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskedDistance = 1.7e38f;  // types.MASKED_DISTANCE
constexpr short kI16Mask = 32767;           // ops/tree_ah_grouped.I16_MASK
constexpr int kThreads = 256;

// Table entry, accumulator and output types of the two branches.
template <bool INT8>
struct Types;

template <>
struct Types<false> {
  using Lut = __nv_bfloat16;
  using Acc = float;
  using Out = __nv_bfloat16;
  static __device__ __forceinline__ Acc load(Lut v) { return __bfloat162float(v); }
  static __device__ __forceinline__ Out store(Acc a) { return __float2bfloat16(a); }
  static __device__ __forceinline__ Out masked() { return __float2bfloat16(kMaskedDistance); }
};

template <>
struct Types<true> {
  using Lut = int8_t;
  using Acc = int;
  using Out = short;
  static __device__ __forceinline__ Acc load(Lut v) { return (int)v; }
  static __device__ __forceinline__ Out store(Acc a) { return (short)a; }
  static __device__ __forceinline__ Out masked() { return kI16Mask; }
};

template <int QCAP, bool PACKED, bool INT8>
__global__ void __launch_bounds__(kThreads)
tree_ah_grouped_kernel(const typename Types<INT8>::Lut* __restrict__ luts,
                       const uint8_t* __restrict__ codes,
                       const int* __restrict__ offsets,
                       const int* __restrict__ sizes,
                       typename Types<INT8>::Out* __restrict__ out,
                       int s_rows, int num_codes, long long n_csr,
                       int l_cap, int l_tile) {
  using T = Types<INT8>;
  using Lut = typename T::Lut;
  using Acc = typename T::Acc;
  using Out = typename T::Out;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Lut* lut_s = reinterpret_cast<Lut*>(smem_raw);  // [QCAP][S_pad*C]
  const int g = blockIdx.x;
  const int tile0 = blockIdx.y * l_tile;
  const int size = sizes[g];
  const int s_pad = PACKED ? 2 * s_rows : s_rows;
  const int sc = s_pad * num_codes;
  const Out masked = T::masked();
  Out* out_g = out + (long long)g * QCAP * l_cap + tile0;

  if (tile0 >= size) {  // uniform over the block
    for (int l = threadIdx.x; l < l_tile; l += blockDim.x) {
#pragma unroll
      for (int q = 0; q < QCAP; ++q) out_g[(long long)q * l_cap + l] = masked;
    }
    return;
  }

  const Lut* lut_g = luts + (long long)g * QCAP * sc;
  for (int i = threadIdx.x; i < QCAP * sc; i += blockDim.x) lut_s[i] = lut_g[i];
  __syncthreads();

  const uint8_t* codes_g = codes + offsets[g] + tile0;
  for (int l = threadIdx.x; l < l_tile; l += blockDim.x) {
    if (tile0 + l >= size) {
#pragma unroll
      for (int q = 0; q < QCAP; ++q) out_g[(long long)q * l_cap + l] = masked;
      continue;
    }
    Acc acc[QCAP];
#pragma unroll
    for (int q = 0; q < QCAP; ++q) acc[q] = Acc(0);
    for (int j = 0; j < s_rows; ++j) {
      const int byte = codes_g[(long long)j * n_csr + l];
      if (PACKED) {
        const int lo = j * num_codes + (byte & 0xF);
        const int hi = (s_rows + j) * num_codes + (byte >> 4);
#pragma unroll
        for (int q = 0; q < QCAP; ++q) {
          acc[q] += T::load(lut_s[q * sc + lo]);
          acc[q] += T::load(lut_s[q * sc + hi]);
        }
      } else {
        const int e = j * num_codes + byte;
#pragma unroll
        for (int q = 0; q < QCAP; ++q) acc[q] += T::load(lut_s[q * sc + e]);
      }
    }
#pragma unroll
    for (int q = 0; q < QCAP; ++q)
      out_g[(long long)q * l_cap + l] = T::store(acc[q]);
  }
}

template <int QCAP, bool PACKED, bool INT8>
int launch(const void* luts, const void* codes, const void* offsets,
           const void* sizes, void* out, int ng, int s_rows, int num_codes,
           long long n_csr, int l_cap, int l_tile, cudaStream_t stream) {
  using T = Types<INT8>;
  auto kernel = tree_ah_grouped_kernel<QCAP, PACKED, INT8>;
  const int s_pad = PACKED ? 2 * s_rows : s_rows;
  const size_t smem = sizeof(typename T::Lut) * (size_t)QCAP * s_pad * num_codes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(ng, l_cap / l_tile);
  const int threads = l_tile < kThreads ? l_tile : kThreads;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const typename T::Lut*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<const int*>(offsets), static_cast<const int*>(sizes),
      static_cast<typename T::Out*>(out), s_rows, num_codes, n_csr, l_cap, l_tile);
  return (int)cudaGetLastError();
}

template <bool PACKED, bool INT8>
int dispatch(int q_cap, const void* luts, const void* codes, const void* offsets,
             const void* sizes, void* out, int ng, int s_rows, int num_codes,
             long long n_csr, int l_cap, int l_tile, cudaStream_t stream) {
#define TREE_AH_CASE(Q)                                                      \
  case Q:                                                                    \
    return launch<Q, PACKED, INT8>(luts, codes, offsets, sizes, out, ng, s_rows,   \
                             num_codes, n_csr, l_cap, l_tile, stream);
  switch (q_cap) {
    TREE_AH_CASE(1)
    TREE_AH_CASE(2)
    TREE_AH_CASE(4)
    TREE_AH_CASE(8)
    TREE_AH_CASE(16)
    TREE_AH_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TREE_AH_CASE
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the
// launch (0 on success).
// `int8_luts` selects the int8-table branch (int8 LUTs, int16 out).
extern "C" int tree_ah_grouped_scores(const void* luts, const void* codes,
                                      const void* offsets, const void* sizes,
                                      void* out, int ng, int q_cap, int s_rows,
                                      int num_codes, long long n_csr, int l_cap,
                                      int l_tile, int packed, int int8_luts,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TREE_AH_DISPATCH(P, I)                                                \
  return dispatch<P, I>(q_cap, luts, codes, offsets, sizes, out, ng, s_rows,  \
                        num_codes, n_csr, l_cap, l_tile, s);
  if (packed) {
    if (int8_luts) TREE_AH_DISPATCH(true, true)
    TREE_AH_DISPATCH(true, false)
  }
  if (int8_luts) TREE_AH_DISPATCH(false, true)
  TREE_AH_DISPATCH(false, false)
#undef TREE_AH_DISPATCH
}

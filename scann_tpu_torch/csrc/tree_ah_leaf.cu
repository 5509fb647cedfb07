// Per-(query, partition) float32 leaf scorer for tree-x-AH search on Hopper
// (sm_90a).
//
// Replaces the TPU kernel scann_tpu/ops/tree_ah_pallas.py::_kernel
// (tree_ah_leaf_scores_pallas). For every (query, selected partition) pair
// i the kernel scores the pair's contiguous CSR code columns against the
// pair's own float32 table:
//
//     out[i, l] = sum_s lut[i, s, codes[s, off_i + l]]     (l < size_i)
//     out[i, l] = MASKED_DISTANCE                          (l >= size_i)
//
// in float32 end to end: tables, sums and output (the grouped scorer #1
// rounds tables and output to bf16; this one is the JAX package's
// non-grouped path, exact in float32).
//
// Layouts (the JAX package's):
//   luts    [B*p, S_pad*C] float32, zero rows for pad subspaces;
//   codes   [S_pad, N_csr] u8, partition-contiguous columns;
//   offsets [B*p] i32 first CSR column of each pair's partition (any
//           alignment: the kernel reads bytes);
//   sizes   [B*p] i32 partition size of each pair (off + size <= N_csr);
//   out     [B*p, l_cap] float32.
//
// What bounds it on the H100: per pair the kernel reads size * S_pad code
// bytes and writes l_cap float32 scores, and does one float32 add per code
// byte; at S_pad=64 that is 4 bytes written and 64 bytes read per 64 adds,
// so the code and output streams bound it. The design: grid (pairs,
// L-tiles); a block stages its pair's table (S_pad*C floats, 4 KB at
// S_pad=64, C=16) in shared memory once, then each thread walks one
// candidate column, neighbour threads on neighbour code bytes of a subspace
// row (coalesced), and sums in float32 over ascending s — the order of the
// PyTorch twin (tree_ah_leaf_scores_reference), additions only, so kernel
// and twin agree bit for bit. Every lookup of a warp falls in the 16 banks
// of one 16-entry row, so lookups never conflict. A tile at or past the
// pair's size is written masked without reading codes or the table.
// Reading each pair's codes once per pair (queries that share a partition
// read it again) is what the grouped scorer #1 removes; this kernel keeps
// the TPU kernel's one-pair-per-step contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskedDistance = 1.7e38f;  // types.MASKED_DISTANCE

__global__ void __launch_bounds__(256)
tree_ah_leaf_kernel(const float* __restrict__ luts,
                    const uint8_t* __restrict__ codes,
                    const int* __restrict__ offsets,
                    const int* __restrict__ sizes,
                    float* __restrict__ out, int s_pad, int num_codes,
                    long long n_csr, int l_cap, int l_tile) {
  extern __shared__ float lut_s[];  // [S_pad*C]
  const int pair = blockIdx.x;
  const int tile0 = blockIdx.y * l_tile;
  const int size = sizes[pair];
  float* out_p = out + (long long)pair * l_cap + tile0;
  const int tile_len = min(l_tile, l_cap - tile0);

  if (tile0 >= size) {  // uniform over the block
    for (int l = threadIdx.x; l < tile_len; l += blockDim.x)
      out_p[l] = kMaskedDistance;
    return;
  }

  const int sc = s_pad * num_codes;
  const float* lut_p = luts + (long long)pair * sc;
  for (int i = threadIdx.x; i < sc; i += blockDim.x) lut_s[i] = lut_p[i];
  __syncthreads();

  const uint8_t* codes_p = codes + (long long)offsets[pair] + tile0;
  for (int l = threadIdx.x; l < tile_len; l += blockDim.x) {
    if (tile0 + l >= size) {
      out_p[l] = kMaskedDistance;
      continue;
    }
    float acc = 0.0f;
    for (int s = 0; s < s_pad; ++s)
      acc += lut_s[s * num_codes + codes_p[(long long)s * n_csr + l]];
    out_p[l] = acc;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int tree_ah_leaf_scores(const void* luts, const void* codes,
                                   const void* offsets, const void* sizes,
                                   void* out, int pairs, int s_pad,
                                   int num_codes, long long n_csr, int l_cap,
                                   int l_tile, void* stream) {
  const size_t smem = sizeof(float) * (size_t)s_pad * num_codes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tree_ah_leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(pairs, (l_cap + l_tile - 1) / l_tile);
  const int threads = l_tile < 256 ? l_tile : 256;
  tree_ah_leaf_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<const int*>(offsets), static_cast<const int*>(sizes),
      static_cast<float*>(out), s_pad, num_codes, n_csr, l_cap, l_tile);
  return (int)cudaGetLastError();
}

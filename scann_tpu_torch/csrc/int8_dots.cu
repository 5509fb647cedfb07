// Raw dots of float32 queries with uint8 codes on Hopper (sm_90a).
//
// Replaces the TPU kernel scann_tpu/ops/pallas_kernels.py::_int8_dots_kernel
// (:204; int8_dots_pallas, pallas_call :229), the product the scalar-quantized
// searcher folds its affine codec into (ops/asymmetric.py):
//
//   out[b, n] = sum_d q[b, d] * float(codes_t[d, n])
//
// q is [B, D] float32, codes_t [D, N] uint8 (the transposed codes), out
// [B, N] float32, all row-major. Each output is one float32 FMA chain in
// ascending d. The plain twin (ops/scoring_kernels.py::int8_dots_reference)
// is a float32 matrix product, which adds in its own order: the two agree
// to 1e-5 of sum_d |q_d * c_d| per entry. The contract is float32 queries
// times exact codes, as the Pallas kernel computes on the CPU; the TPU's
// default-precision matrix unit would round q to bf16.
//
// What bounds it on the H100, at B = 1024 queries over N_pad = 1,183,616
// columns, D = 100: the codes once (118 MB), the queries once and the
// float32 output once (4.85 GB) need 1.48 ms at 3.35 TB/s; the 2.42e11
// float32 operations (one FMA = 2) on the CUDA cores need 3.6 ms at
// 67 TFLOP/s. The kernel's reason to exist is that no float copy of the
// codes reaches device memory: u8 tiles stream in and convert in registers
// on their way to shared memory.
//
// The design is the plain register-tiled product of a first version: a CTA
// computes a 128 x 128 output tile with 256 threads, each an 8 x 8 block of
// accumulators, over steps of 16 in d. Per step, the 128 x 16 query tile
// (float32) and the 16 x 128 code tile (bytes, converted to float) are
// staged in shared memory; the next step's tile is loaded into registers
// while the current one is used. Code loads are one byte per thread, 128
// consecutive bytes per row of the tile; outputs are stored as float4 where
// the row length allows it. Ragged edges (B, N, D not multiples of the
// tile) are masked: missing queries and columns are not written, missing d
// contribute 0.
//
// The tensor-core route, for a later PR: the codes are exact in bf16, and q
// split into three bf16 parts (q = q0 + q1 + q2, each the rounding of what
// is left) gives float32-exact products on bf16 mma/wgmma with float32
// accumulation: three products at 989 TFLOP/s in place of one at 67, which
// leaves the kernel bound by its output bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // queries per CTA
constexpr int kBN = 128;       // columns per CTA (INT8_DOTS_TILE_N)
constexpr int kBK = 16;        // d per shared-memory step
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kAPad = 4;       // keeps the float4 reads of a row aligned

// The next step's tiles into registers: queries rows row0 + 16 j at d
// k0 + a_k, codes rows k0 + b_k + 2 j at column col; 0 past the edges.
__device__ __forceinline__ void load_tiles(
    const float* __restrict__ q, const uint8_t* __restrict__ codes, int b,
    int d, long long n, int row0, int a_k, long long col, bool col_ok,
    int b_k, int k0, float (&ra)[8], float (&rb)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = row0 + 16 * j;
    const int k = k0 + a_k;
    ra[j] = (row < b && k < d) ? q[(long long)row * d + k] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + b_k + 2 * j;
    rb[j] = (col_ok && k < d) ? (float)codes[(long long)k * n + col] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
int8_dots_kernel(const float* __restrict__ q,
                 const uint8_t* __restrict__ codes, float* __restrict__ out,
                 int b, int d, long long n) {
  __shared__ __align__(16) float as[kBK][kBM + kAPad];
  __shared__ __align__(16) float bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4.. and 64 + tx*4..
  const int ty = tid / 16;  // output rows ty*4.. and 64 + ty*4..
  const long long n0 = (long long)blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  // loader roles: queries k = tid % 16, rows tid / 16 + 16 j;
  //               codes column tid % 128, k = tid / 128 + 2 j
  const int a_k = tid % kBK;
  const int a_row = tid / kBK;
  const int b_col = tid % kBN;
  const int b_k = tid / kBN;
  const bool b_col_ok = n0 + b_col < n;

  float ra[8], rb[8];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_tiles(q, codes, b, d, n, m0 + a_row, a_k, n0 + b_col, b_col_ok, b_k,
             0, ra, rb);
  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      as[a_k][a_row + 16 * j] = ra[j];
      bs[b_k + 2 * j][b_col] = rb[j];
    }
    __syncthreads();
    if (k0 + kBK < d)  // in flight during the products
      load_tiles(q, codes, b, d, n, m0 + a_row, a_k, n0 + b_col, b_col_ok,
                 b_k, k0 + kBK, ra, rb);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool vec = (n % 4) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= b) continue;
    float* dst = out + (long long)row * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long col = n0 + h * 64 + tx * 4;
      // constant indices only: acc stays in registers
      if (vec && col + 3 < n) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < n) dst[col + c] = acc[i][h * 4 + c];
      }
    }
  }
}

}  // namespace

// Plain C entry point, loaded through ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int int8_dots(const void* q, const void* codes, void* out, int b,
                         int d, long long n, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  const long long grid_x = (n + kBN - 1) / kBN;
  const int grid_y = (b + kBM - 1) / kBM;
  if (grid_x > INT_MAX || grid_y > 65535) return (int)cudaErrorInvalidValue;
  int8_dots_kernel<<<dim3((unsigned)grid_x, grid_y), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)q, (const uint8_t*)codes, (float*)out, b, d, n);
  return (int)cudaGetLastError();
}

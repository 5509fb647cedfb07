// Raw dots of float32 queries with uint8 codes on Hopper (sm_90a).
//
// Replaces the TPU kernel scann_tpu/ops/pallas_kernels.py::_int8_dots_kernel
// (:204; int8_dots_pallas, pallas_call :229), the product the scalar-quantized
// searcher folds its affine codec into (ops/asymmetric.py):
//
//   out[b, n] = sum_d q[b, d] * float(codes_t[d, n])
//
// q is [B, D] float32, codes_t [D, N] uint8 (the transposed codes), out
// [B, N] float32. The plain twin (ops/scoring_kernels.py::int8_dots_reference)
// is a float32 matrix product; the two agree to 1e-5 of sum_d |q_d * c_d|
// per entry. The contract is float32 queries times exact codes, as the
// Pallas kernel computes on the CPU.
//
// Tensor cores through a bf16 x 3 split. The codes 0..255 are exact in bf16.
// The wrapper splits each query into three bf16 parts, each the rounding to
// nearest of what is left (q0 = bf16(q), q1 = bf16(q - q0), q2 = bf16(q - q0
// - q1)); their sum is q exactly, and every product q_k * c is exact in
// float32 (8 x 8 significant bits). Three bf16 products with float32
// accumulation therefore give the float32 function within the contract; two
// parts would leave an error of ~2^-18 |q c| per term and change it.
//
// What bounds it on the H100, at B = 1024 over N_pad = 1,183,616 columns,
// D = 100: writing out (4.85 GB) takes 1.45 ms at 3.35 TB/s; the three bf16
// products (7.27e11 operations at D = 100) take 0.73 ms at 989 TFLOP/s. The
// float32 FMA form of the first version needed 3.6 ms on the CUDA cores and
// lost to torch.matmul of float codes.
//
// The design:
//  - Rows on the M side, the codes as the A operand from registers
//    (wgmma.m64n128k16.f32.bf16.bf16, A in registers). A CTA of two
//    warpgroups owns a tile of 128 rows, 64 per warpgroup. Code tiles
//    [D_pad, 128] u8 arrive by TMA (128-byte swizzle, zero fill past D and
//    N) into a ring of three stages; each thread reads its A fragments with
//    16-bit loads and converts the bytes to bf16 in registers (byte_perm
//    into the float 2^23 + c, one subtraction, one packing cvt). M slots g
//    and g + 8 of a warp carry the adjacent rows 2g and 2g + 1, so one
//    16-bit load feeds both, and the swizzle keeps a warp's loads in
//    different banks.
//  - The queries as the B operand, K-major in shared memory: the wrapper
//    lays the three parts of 128 queries out in the canonical no-swizzle
//    core-matrix layout (8 queries x 16 bytes per core matrix), and one bulk
//    copy brings a query tile in; it stays resident while the CTA walks its
//    row tiles. Queries on N rather than M: the codes, which stream, then
//    convert once per row for all 128 queries.
//  - A persistent grid walks the (query tile, row tile) pairs query tile
//    first, so all CTAs stream the same query tile's codes at once.
//  - The epilogue stages each warpgroup's [128 queries x 64 rows] float32
//    tile in shared memory (two 128-byte-swizzled boxes) and writes it with
//    TMA stores, which clip past B and N; the next tile's products run while
//    the stores drain.

#include <cuda_bf16.h>
#include <limits.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;     // two consumer warpgroups
constexpr int kRows = 128;        // rows per CTA tile (INT8_DOTS_TILE_N)
constexpr int kQ = 128;           // queries per query tile (wgmma N)
constexpr int kMaxKs = 8;         // k16 steps: D <= 128 per launch
constexpr int kStages = 3;        // code tiles in flight
constexpr int kBoxRows = 32;      // rows per output box (128 bytes)
constexpr int kStagingPerWg = 2 * kQ * kBoxRows * 4;  // two boxes, 32 KB

// bf16 pair (lo, hi) of two code bytes of x: the float 2^23 + c minus 2^23
// is c exactly, and c < 256 is exact in bf16
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t x, int lo_byte,
                                                    int hi_byte) {
  const float lo =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | lo_byte)) -
      8388608.0f;
  const float hi =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | hi_byte)) -
      8388608.0f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] (registers) * B[16 x 128] (shared memory)
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1)
int8_dots_kernel(const __grid_constant__ CUtensorMap codes_map,  // [D, N] u8
                 const __grid_constant__ CUtensorMap out_map,    // [B, N] f32
                 const uint8_t* __restrict__ q_img,  // query tiles, see wrapper
                 int nks, int row_tiles, int q_tiles) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle of TMA boxes
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = nks * 16 * kRows;
  const int q_bytes = 3 * nks * 16 * kQ * 2;
  uint8_t* stages = smem;
  uint8_t* staging = stages + kStages * stage_bytes;
  uint8_t* q_s = staging + 2 * kStagingPerWg;
  uint64_t* bars = reinterpret_cast<uint64_t*>(q_s + q_bytes);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t qbar = smem_u32(bars + kStages);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;  // warp within the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long total = (long long)row_tiles * q_tiles;
  const long long grid = gridDim.x;
  const int my_items =
      blockIdx.x < total ? (int)((total - 1 - blockIdx.x) / grid + 1) : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init(qbar, 1);
    mbar_init_fence();
    for (int s = 0; s < kStages && s < my_items; ++s) {
      const long long item = blockIdx.x + s * grid;
      mbar_expect_tx(full0 + 8 * s, stage_bytes);
      tma_load_2d(smem_u32(stages + s * stage_bytes), &codes_map, full0 + 8 * s,
                  (int)(item % row_tiles) * kRows, 0);
    }
  }
  __syncthreads();

  // this thread's two rows (M slots g and g + 8) in the CTA tile
  const int row = 64 * wg + 16 * warp + 2 * g;
  const int chunk = row >> 4;  // 16-byte chunk of a 128-byte code row
  uint8_t* stage_wg = staging + wg * kStagingPerWg;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int cur_qt = -1;
  uint32_t q_phase = 0;

  for (int li = 0; li < my_items; ++li) {
    const long long item = blockIdx.x + li * grid;
    const int qt = (int)(item / row_tiles);
    const int rt = (int)(item % row_tiles);
    if (qt != cur_qt) {
      __syncthreads();  // every product on the previous query tile is done
      if (tid == 0) {
        mbar_expect_tx(qbar, q_bytes);
        bulk_load(smem_u32(q_s), q_img + (long long)qt * q_bytes, q_bytes,
                  qbar);
      }
      mbar_wait(qbar, q_phase);
      q_phase ^= 1;
      cur_qt = qt;
    }
    const int s = li % kStages;
    mbar_wait(full0 + 8 * s, (li / kStages) & 1);

    // A fragments: a[ks][0] row 2g at k 2t..2t+1, [1] row 2g+1, [2] and [3]
    // the same at k 2t+8..2t+9 (the mma A layout with slot g -> row 2g,
    // slot g+8 -> row 2g+1)
    const uint8_t* tile = stages + s * stage_bytes;
    uint32_t a[kMaxKs][4];
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      if (ks < nks) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = 16 * ks + 2 * t + (i & 1) + 8 * (i >> 1);
          w[i] = *reinterpret_cast<const uint16_t*>(
              tile + d * kRows + ((chunk ^ (d & 7)) << 4) + 2 * g);
        }
        const uint32_t lo = w[0] | (w[1] << 16);
        const uint32_t hi = w[2] | (w[3] << 16);
        a[ks][0] = bytes_to_bf16x2(lo, 0, 2);
        a[ks][1] = bytes_to_bf16x2(lo, 1, 3);
        a[ks][2] = bytes_to_bf16x2(hi, 0, 2);
        a[ks][3] = bytes_to_bf16x2(hi, 1, 3);
      }
    }
    __syncthreads();  // stage s is read: refill it
    if (tid == 0 && li + kStages < my_items) {
      const long long next = blockIdx.x + (li + kStages) * grid;
      mbar_expect_tx(full0 + 8 * s, stage_bytes);
      tma_load_2d(smem_u32(stages + s * stage_bytes), &codes_map, full0 + 8 * s,
                  (int)(next % row_tiles) * kRows, 0);
    }

#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
    wgmma_fence();
    const uint32_t qaddr = smem_u32(q_s);
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      if (ks < nks) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const uint64_t desc =
              kmajor_desc(qaddr + (p * nks + ks) * (kQ * 32), 128, 256);
          wgmma_bf16_rs(acc, a[ks], desc, (ks | p) != 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);

    // epilogue: acc[4j + e] = (row 2g, query 8j + 2t + e), acc[4j + 2 + e]
    // = (row 2g + 1, same query) -> two boxes of [128 queries][32 rows]
    if ((tid & 127) == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    warpgroup_sync(1 + wg);
    {
      const int r = 16 * warp + 2 * g;  // row within the warpgroup's 64
      uint8_t* box = stage_wg + (r >> 5) * (kQ * kBoxRows * 4);
      const int jj = r & 31;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * j + 2 * t + e;
          const uint32_t addr = smem_u32(box + q * 128 +
                                         (((jj >> 2) ^ (q & 7)) << 4) +
                                         (jj & 3) * 4);
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
                       "f"(acc[4 * j + e]), "f"(acc[4 * j + 2 + e])
                       : "memory");
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(1 + wg);
    if ((tid & 127) == 0) {
      const int n0 = rt * kRows + 64 * wg;
      tma_store_2d(&out_map, smem_u32(stage_wg), n0, qt * kQ);
      tma_store_2d(&out_map, smem_u32(stage_wg + kQ * kBoxRows * 4),
                   n0 + kBoxRows, qt * kQ);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if ((tid & 127) == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Dynamic shared memory of one CTA for nks k16 steps: at most 214,048
// bytes (nks = 8), below the 232,448 a block may have.
int smem_bytes(int nks) {
  return 1024 + kStages * nks * 16 * kRows + 2 * kStagingPerWg +
         3 * nks * 16 * kQ * 2 + 8 * (kStages + 1);
}

}  // namespace

// Plain C entry point, loaded through ctypes. q_img holds ceil(b/128) query
// tiles of 3 * nks * 4096 bytes (the bf16 parts in the wgmma core-matrix
// layout, zero past b and d); codes is [d, n_pitch] u8 with n_pitch % 16 == 0
// and n <= n_pitch; out is [b, out_pitch] float32 with out_pitch % 4 == 0.
// Launches on `stream`, does not synchronise, allocates nothing; returns a
// CUDA error code (0 on success).
extern "C" int int8_dots(const void* q_img, const void* codes, void* out, int b,
                         int d, long long n, long long n_pitch,
                         long long out_pitch, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const int nks = (d + 15) / 16;
  if (d <= 0 || nks > kMaxKs || n_pitch % 16 || out_pitch % 4 || n > n_pitch ||
      n > out_pitch)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;

  CUtensorMap codes_map, out_map;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)d};
    const cuuint64_t strides[1] = {(cuuint64_t)n_pitch};
    const cuuint32_t box[2] = {kRows, (cuuint32_t)(nks * 16)};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&codes_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
               const_cast<void*>(codes), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)b};
    const cuuint64_t strides[1] = {(cuuint64_t)out_pitch * 4};
    const cuuint32_t box[2] = {kBoxRows, kQ};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }

  const int smem = smem_bytes(nks);
  cudaError_t err = cudaFuncSetAttribute(
      int8_dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const long long row_tiles = (n + kRows - 1) / kRows;
  const int q_tiles = (b + kQ - 1) / kQ;
  if (row_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  // one CTA per SM: the shared memory takes most of an SM
  long long grid = sms;
  if (grid > row_tiles * q_tiles) grid = row_tiles * q_tiles;
  int8_dots_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      codes_map, out_map, static_cast<const uint8_t*>(q_img), nks,
      (int)row_tiles, q_tiles);
  return (int)cudaGetLastError();
}

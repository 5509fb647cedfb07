// Exact small-database search on Hopper (sm_90a): squared L2 and the k
// smallest per query (k <= 16) in one launch.
//
// Replaces the TPU kernel scann_tpu/ops/fused_bf_pallas.py::_kernel (:28;
// fused_bf_search_pallas, pallas_call :68):
//
//   dist[b, n] = max(|q_b|^2 + |x_n|^2 - 2 q_b . x_n, 0), +inf for n >= n_valid
//   out[b, :]  = the k smallest (value, column) pairs, ascending; equal
//                values lowest column first; slots with no valid row
//                (inf, -1)
//
// q is [B, D] float32, db [N, D] float32, norms [N] float32 (|x_n|^2), all
// row-major; the outputs are [B, k] float32 and int32. Each dot product is
// one float32 FMA chain in ascending d; the plain twin
// (ops/fused_bf.py::fused_bf_search_reference, the composed float32 product,
// mask and top-k) adds in its own order, so values agree to 1e-5 of the
// terms |q|^2 + |x|^2 the formula cancels, and ids agree wherever no other
// value lies that close.
//
// What bounds it on the H100, at the JAX package's headline shape (N =
// 10,000 rows of D = 64, B = 100, k = 10): 1.28e8 float32 operations on the
// CUDA cores (1.9 us at 67 TFLOP/s) and 2.6 MB of inputs (0.8 us at
// 3.35 TB/s). A few microseconds of work: the launch and the composed
// path's many small launches are the story, so one launch does it all.
// Launched back to back on an H100 (700 W), it takes about 0.02 ms at k = 1,
// 0.05 ms at k = 10 and 0.09 ms at k = 16: the k rounds of the selection,
// not the products, set its time.
//
// The design. One CTA per batch of 32 queries would occupy 4 of the 132 SMs,
// so the rows are split across CTAs: CTA (s, t) takes queries 32t..32t+31
// and a contiguous range of 256-row sub-chunks. Per sub-chunk, 256 threads
// compute the 32 x 256 distance tile (each thread 4 rows x 8 queries, the
// staged row and query tiles in shared memory, 8 d per step, the next
// step's tiles loaded into registers meanwhile; |q|^2 comes from the same
// staged query tiles in the first sub-chunk), write it to
// shared memory, and each warp keeps the running k best of 4 queries: lane j
// of the warp holds the j-th best so far, and k rounds of a warp-wide
// minimum over the tile's 8 values per lane and the running entries, each
// round taking the smallest after the last one taken, give the new k best.
// A candidate is one 64-bit key, the value's bits above the column: keys
// are unique and order by (value, column), so nothing needs marking as
// taken, equal values come out lowest column first, and a round's minimum
// is two warp reductions (__reduce_min_sync) in place of five shuffle
// levels. Each CTA writes its k best keys per query to a scratch array;
// the last CTA of a query batch to finish (an atomic counter per batch,
// after a memory fence) merges the splits' lists the same way, 512
// candidates at a time, and writes the outputs. A single split skips the
// scratch and writes directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 32;            // queries per CTA
constexpr int kRows = 256;        // rows per sub-chunk
constexpr int kDk = 8;            // d per shared-memory step
constexpr int kThreads = 256;     // 64 row lanes x 4 query groups
constexpr int kWarps = kThreads / 32;
constexpr int kQPerWarp = kQ / kWarps;
constexpr int kMaxK = 16;
constexpr int kMergeM = 16;       // candidates per lane per merge pass
// strides of the staged tiles: + 4 floats puts the 32 lanes of a staging
// store (8 d x 4 rows or queries) in 32 different banks
constexpr int kXs = kRows + 4;
constexpr int kQs = kQ + 4;
constexpr unsigned kFull = 0xffffffffu;
// MASKED_DISTANCE / 2 (scann_tpu_torch/types.py): float32(3.4e38) / 4;
// a value at or past it counts as missing, as in the TPU kernel
constexpr float kMaskedHalf = 3.4e38f / 4.0f;

// A candidate as one 64-bit key: the value's bits above the column. Values
// are >= 0 or +inf here, whose bits order like the values, so the keys
// order by (value, column) and are unique.
__device__ __forceinline__ unsigned long long pack(float v, int col) {
  return ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)col;
}

// Past every real key: an empty slot (unpacks to NaN, written as (inf, -1)).
constexpr unsigned long long kNone = ~0ull;

// k rounds of a warp-wide minimum over M candidate keys per lane plus one
// running key per lane (lane j < k holds the j-th smallest so far). Round r
// takes the smallest key after the one round r - 1 took (two warp
// reductions: the high word, then the low word among the lanes holding that
// high word); on return lane j < k holds the j-th smallest of the union and
// the other lanes hold kNone, which also fills slots when fewer than k
// exist.
template <int M>
__device__ __forceinline__ void select_into(
    const unsigned long long (&cand)[M], unsigned long long& run, int k,
    int lane) {
  unsigned long long lo = 0, mine = kNone;
  for (int r = 0; r < k; ++r) {
    unsigned long long best = kNone;
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (cand[m] >= lo && cand[m] < best) best = cand[m];
    if (run >= lo && run < best) best = run;
    const unsigned hi = __reduce_min_sync(kFull, (unsigned)(best >> 32));
    const unsigned low = __reduce_min_sync(
        kFull, (unsigned)(best >> 32) == hi ? (unsigned)best : 0xffffffffu);
    const unsigned long long pick = ((unsigned long long)hi << 32) | low;
    if (lane == r) mine = pick;
    if (pick == kNone) break;  // the same on every lane
    lo = pick + 1;
  }
  run = mine;
}

__device__ __forceinline__ void write_out(float* out_v, int* out_i, int qi,
                                          int k, int j,
                                          unsigned long long key) {
  const float v = __uint_as_float((unsigned)(key >> 32));
  const bool ok = v < kMaskedHalf;
  out_v[(long long)qi * k + j] = ok ? v : INFINITY;
  out_i[(long long)qi * k + j] = ok ? (int)(unsigned)key : -1;
}

// The next d step's tiles into registers: rows r0 + st_r + 32 j and query
// q0 + st_r at d k0 + st_d; 0 past the edges.
__device__ __forceinline__ void load_step(
    const float* __restrict__ q, const float* __restrict__ db, int d, int n,
    int r0, int q0, int st_d, int st_r, bool q_ok, int k0,
    float (&rx)[kRows / 32], float& rq) {
  const bool d_ok = k0 + st_d < d;
#pragma unroll
  for (int j = 0; j < kRows / 32; ++j) {
    const int row = r0 + st_r + 32 * j;
    rx[j] = (d_ok && row < n) ? db[(long long)row * d + k0 + st_d] : 0.0f;
  }
  rq = (d_ok && q_ok) ? q[(long long)(q0 + st_r) * d + k0 + st_d] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
fused_bf_kernel(const float* __restrict__ q, const float* __restrict__ db,
                const float* __restrict__ norms, int n_valid, int b, int d,
                int n, int k, int chunks_per_split, int n_splits,
                unsigned long long* __restrict__ part,
                int* __restrict__ counters, float* __restrict__ out_v,
                int* __restrict__ out_i) {
  __shared__ __align__(16) float xs[kDk][kXs];
  __shared__ __align__(16) float qs[kDk][kQs];
  __shared__ __align__(16) float ds[kQ][kRows];
  __shared__ float qsq[kQ];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tx = tid % 64;  // rows tx + 64 i of the sub-chunk
  const int ty = tid / 64;  // queries ty * 8 + j of the batch
  const int split = blockIdx.x;
  const int qtile = blockIdx.y;
  const int q0 = qtile * kQ;

  unsigned long long run[kQPerWarp];
#pragma unroll
  for (int u = 0; u < kQPerWarp; ++u) run[u] = kNone;

  const int n_chunks = (n + kRows - 1) / kRows;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  const int st_d = tid % kDk;   // staging: d within the step
  const int st_r = tid / kDk;   // staging: row (+ 32 j) or query
  const bool q_ok = q0 + st_r < b;
  float qacc = 0.0f;            // tid < kQ: |q|^2 of query q0 + tid
  for (int c = c_begin; c < c_end; ++c) {
    const int r0 = c * kRows;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float rx[kRows / 32], rq;
    load_step(q, db, d, n, r0, q0, st_d, st_r, q_ok, 0, rx, rq);
    for (int k0 = 0; k0 < d; k0 += kDk) {
#pragma unroll
      for (int j = 0; j < kRows / 32; ++j) xs[st_d][st_r + 32 * j] = rx[j];
      qs[st_d][st_r] = rq;
      __syncthreads();
      if (k0 + kDk < d)  // in flight during the products
        load_step(q, db, d, n, r0, q0, st_d, st_r, q_ok, k0 + kDk, rx, rq);
      if (c == c_begin && tid < kQ) {
        // |q|^2 from the staged tiles, one FMA chain in ascending d
#pragma unroll
        for (int dd = 0; dd < kDk; ++dd)
          qacc = fmaf(qs[dd][tid], qs[dd][tid], qacc);
      }
#pragma unroll
      for (int dd = 0; dd < kDk; ++dd) {
        float xv[4], qv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[dd][tx + 64 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) qv[j] = qs[dd][ty * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(qv[j], xv[i], acc[i][j]);
      }
      __syncthreads();
    }
    if (c == c_begin) {
      if (tid < kQ) qsq[tid] = qacc;
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = r0 + tx + 64 * i;
      const float xsq = col < n ? norms[col] : 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = qsq[ty * 8 + j] + xsq - 2.0f * acc[i][j];
        // masked, past MASKED_DISTANCE / 2 or NaN: +inf; else clamped at
        // +0 (not -0: the keys order by the bits)
        v = (col >= n_valid || !(v < kMaskedHalf)) ? INFINITY
                                                  : (v > 0.0f ? v : 0.0f);
        ds[ty * 8 + j][tx + 64 * i] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kQPerWarp; ++u) {
      const int qi = warp * kQPerWarp + u;
      unsigned long long cand[kRows / 32];
#pragma unroll
      for (int m = 0; m < kRows / 32; ++m)
        cand[m] = pack(ds[qi][lane + 32 * m], r0 + lane + 32 * m);
      select_into(cand, run[u], k, lane);
    }
    __syncthreads();  // ds is rewritten by the next sub-chunk
  }

  if (n_splits == 1) {
#pragma unroll
    for (int u = 0; u < kQPerWarp; ++u) {
      const int qi = q0 + warp * kQPerWarp + u;
      if (qi < b && lane < k) write_out(out_v, out_i, qi, k, lane, run[u]);
    }
    return;
  }

  const int total = n_splits * k;  // candidates per query after the splits
#pragma unroll
  for (int u = 0; u < kQPerWarp; ++u) {
    const int qi = q0 + warp * kQPerWarp + u;
    if (qi < b && lane < k)
      part[(long long)qi * total + (long long)split * k + lane] = run[u];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[qtile], 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

#pragma unroll
  for (int u = 0; u < kQPerWarp; ++u) {
    const int qi = q0 + warp * kQPerWarp + u;  // the same on every lane
    if (qi >= b) continue;
    const unsigned long long* pp = part + (long long)qi * total;
    unsigned long long mine = kNone;
    for (int p0 = 0; p0 < total; p0 += 32 * kMergeM) {
      unsigned long long cand[kMergeM];
#pragma unroll
      for (int m = 0; m < kMergeM; ++m) {
        const int at = p0 + lane + 32 * m;
        // L2 reads: the other CTAs' lists were written from other SMs
        cand[m] = at < total ? __ldcg(pp + at) : kNone;
      }
      select_into(cand, mine, k, lane);
    }
    if (lane < k) write_out(out_v, out_i, qi, k, lane, mine);
  }
}

}  // namespace

// Plain C entry point, loaded through ctypes. `part` holds B * n_splits * k
// 64-bit keys and `counters` ceil(B / 32) zeros when n_splits > 1 (both
// unused otherwise). Launches on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fused_bf_search(const void* q, const void* db,
                               const void* norms, int n_valid, int b, int d,
                               int n, int k, int chunks_per_split,
                               int n_splits, void* part, void* counters,
                               void* out_v, void* out_i, void* stream) {
  if (b <= 0) return 0;
  if (d <= 0 || n <= 0 || k < 1 || k > kMaxK || n_valid < 0 || n_valid > n ||
      chunks_per_split < 1 || n_splits < 1)
    return (int)cudaErrorInvalidValue;
  const int q_tiles = (b + kQ - 1) / kQ;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  fused_bf_kernel<<<dim3(n_splits, q_tiles), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const float*)q, (const float*)db, (const float*)norms, n_valid, b, d,
      n, k, chunks_per_split, n_splits, (unsigned long long*)part,
      (int*)counters, (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}

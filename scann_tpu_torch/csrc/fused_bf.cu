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
// row-major; the outputs are [B, k] float32 and int32. The plain twin
// (ops/fused_bf.py::fused_bf_search_reference, the composed float32 product,
// mask and top-k) adds in its own order, so values agree to 1e-5 of the
// terms |q|^2 + |x|^2 the formula cancels, and ids agree wherever no other
// value lies that close; on integer-valued inputs every sum is exact and
// the two agree bit for bit.
//
// What bounds it on the H100, at the JAX package's headline shape (N =
// 10,000 rows of D = 64, B = 100, k = 10): 1.28e8 float32 operations on the
// CUDA cores (1.9 us at 67 TFLOP/s) and 2.6 MB of inputs (0.8 us at
// 3.35 TB/s). A few microseconds of work: a launch costs as much, so one
// launch does it all, and what is left to design is that the selection and
// the merge of the row splits cost no more than the pass over the rows.
//
// Two kernels. fused_bf_cluster_kernel serves every call of
// ops/fused_bf.fused_bf_search; fused_bf_kernel, the first port, stays as a
// same-run yardstick (ops/fused_bf._launch(scratch_merge=True)).
//
// fused_bf_cluster_kernel. A thread-block cluster takes a tile of QT = 16
// or 32 queries (ops/fused_bf.cluster_plan picks QT, the cluster width, up
// to 16, and the rows each CTA takes); the CTAs of the cluster split the
// rows [0, n_valid) into contiguous ranges. A CTA walks its range in
// sub-chunks of R = 8192 / QT rows: 256 threads, each 4 rows x 8 queries of
// float32 FMAs in ascending d, read from a two-stage cp.async ring of
// d-slabs of the rows and the queries, as wide as shared memory allows (40
// d at QT 16, 80 at QT 32; staged rows dk + 4 floats apart, so the LDS.128
// of eight neighbouring rows hit eight bank groups; the queries are a
// broadcast). A short last sub-chunk skips its row groups past the range.
// The sub-chunk's distances go to shared memory, and each warp keeps the
// running k best of QT / 8 queries in registers, lane j the j-th as one
// 64-bit key (the value's bits above the column: keys are unique and order
// by (value, column)). The selection is filtered: a candidate survives
// only below the running k-th key, or, while the list is not full, at or
// below the k-th smallest of the 32 lanes' minima; one vote ends a query
// with no survivor. The list and the survivors are compacted into the
// warp's own rows of the distances (one ballot a candidate slot) and
// ranked (the key of rank j the new j-th), so the work follows the
// candidates that enter the list, not k rounds; past 64 survivors (many
// equal values) it takes rounds, each inserting the smallest survivor with
// one shuffle. The CTAs then merge in the cluster's distributed shared
// memory: each CTA writes its lists to its own shared memory, and after a
// cluster barrier CTA r reads the cs lists of queries r, r + cs, ... from
// its peers (mapa / ld.shared::cluster) and ranks each of the cs x k keys
// against the others (rank = keys below it; the ranks are distinct),
// writing the key of rank j < k to slot j. No global scratch, no fence, no
// atomic counter and no reset launch; the merge is spread over the
// cluster's CTAs. On an H100 (700 W) at the headline it takes 0.028 ms at
// k = 10 back to back (0.025 at k = 1, 0.031 at k = 16; the first port
// 0.046, 0.021, 0.092): the product loop runs at a third to a half of the
// FMA rate, and the selection and the merge about 5 us each (PERF.md).
//
// fused_bf_kernel (the first port). One CTA per batch of 32 queries would
// occupy 4 of the 132 SMs, so the rows are split across CTAs: CTA (s, t)
// takes queries 32t..32t+31 and a contiguous range of 256-row sub-chunks.
// Per sub-chunk, 256 threads compute the 32 x 256 distance tile (each
// thread 4 rows x 8 queries, the staged row and query tiles in shared
// memory, 8 d per step, the next step's tiles loaded into registers
// meanwhile; |q|^2 comes from the same staged query tiles in the first
// sub-chunk), write it to shared memory, and each warp keeps the running k
// best of 4 queries: k rounds of a warp-wide minimum over the tile's 8
// values per lane and the running entries, each round taking the smallest
// after the last one taken, give the new k best. Each CTA writes its k
// best keys per query to a scratch array; the last CTA of a query batch to
// finish (an atomic counter per batch, after a memory fence) merges the
// splits' lists the same way, 512 candidates at a time, and writes the
// outputs. A single split skips the scratch and writes directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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


// ---- fused_bf_cluster_kernel ------------------------------------------------

constexpr int kClThreads = 256;
constexpr int kClWarps = kClThreads / 32;
constexpr int kTileOut = 8192;   // distances a sub-chunk: 32 a thread
constexpr int kStages = 2;
constexpr int kMaxCluster = 16;  // non-portable above 8
constexpr int kCap = 64;         // survivors the ranked selection takes
constexpr int kScratch = kCap + kMaxK + kMaxK;  // keys a query's selection
constexpr int kSmemLimit = 232448;  // shared memory a block may use

// The tile of QT queries (16 or 32): each thread 4 rows x 8 queries (per 4
// d, 4 LDS.128 of rows, 8 broadcast ones of queries, 128 FMAs: the FMAs,
// not the shared loads, set the pace). Shared memory, in order: the ring
// (each stage kR rows then QT queries, `dk` d each, rows dk + 4 floats
// apart), the sub-chunk's distances [QT][kR] (a warp's rows of it its
// selection scratch once read, and the merge's candidates), the lists
// [QT][16].
template <int QT>
struct Tile {
  static constexpr int kGroups = QT / 8;               // 8 queries a thread
  static constexpr int kLanes = kClThreads / kGroups;  // row lanes
  static constexpr int kR = kTileOut / QT;             // rows a sub-chunk
  static constexpr int kQPW = QT / kClWarps;           // queries a warp
  static constexpr int kM = kR / 32;                   // candidates a lane
  static constexpr int kDsBytes = QT * kR * 4;
  static constexpr int kFixed = kDsBytes + QT * kMaxK * 8;
  static __host__ __device__ constexpr int ring_bytes(int dk) {
    return kStages * (kR + QT) * (dk + 4) * 4;
  }
  // the widest slab (a multiple of 8, so rows dk + 4 floats apart put
  // eight neighbouring rows' 16-byte loads in eight bank groups) that fits
  static constexpr int kMaxDk =
      ((kSmemLimit - kFixed) / (kStages * (kR + QT) * 4) - 4) / 8 * 8;
  static_assert(kM == 8 || kM == 16, "candidates a lane");
  static_assert(kLanes >= 32, "a warp reads one query group");
  static_assert((QT + kMaxCluster) * kMaxK * 8 <= kDsBytes, "merge space");
  static_assert(kQPW * kScratch * 8 <= kQPW * kR * 4, "warp scratch");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// every thread of every CTA of the cluster; orders shared-memory accesses
// across it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the two halves of cluster_sync, for work between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 64-bit word at `p`'s offset in the shared memory of CTA `rank`
__device__ __forceinline__ unsigned long long ld_peer(const void* p,
                                                      int rank) {
  unsigned remote;
  unsigned long long v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(sm90::smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.u64 %0, [%1];\n"
               : "=l"(v) : "r"(remote) : "memory");
  return v;
}

// The products of one staged slab: rows xr + i kLanes pitch for i < NA
// (the row groups that hold rows of the range; the others are skipped
// whole) against the 8 queries at qr, w4 steps of 4 d, one FMA chain per
// (row, query) in ascending d.
template <int NA, int kLanes>
__device__ __forceinline__ void slab_fma(float (&acc)[4][8],
                                         const float* xr, const float* qr,
                                         int pitch, int w4) {
#pragma unroll 2
  for (int d4 = 0; d4 < w4; ++d4) {
    float4 xv[NA], qv[8];
#pragma unroll
    for (int i = 0; i < NA; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xr + i * kLanes * pitch +
                                               4 * d4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      qv[j] = *reinterpret_cast<const float4*>(qr + j * pitch + 4 * d4);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(qv[j].x, xv[i].x, acc[i][j]);
        acc[i][j] = fmaf(qv[j].y, xv[i].y, acc[i][j]);
        acc[i][j] = fmaf(qv[j].z, xv[i].z, acc[i][j]);
        acc[i][j] = fmaf(qv[j].w, xv[i].w, acc[i][j]);
      }
  }
}

// Rounds over the survivors (the candidates below the list's k-th key):
// each takes the smallest survivor, which always enters the list (a tree
// of minima over the lane's survivors, two warp reductions), inserts it
// with one shuffle and drops the survivors not below the new k-th key.
// The fallback of select_ranked where more than kCap candidates survive.
template <int M>
__device__ __forceinline__ unsigned long long select_rounds(
    const unsigned long long (&cand)[M], unsigned long long run, int k,
    int lane) {
  unsigned long long thr = __shfl_sync(kFull, run, k - 1);
  unsigned bits = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) bits |= (cand[m] < thr ? 1u : 0u) << m;
  while (__any_sync(kFull, bits != 0)) {
    unsigned long long v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = (bits >> m) & 1u ? cand[m] : kNone;
#pragma unroll
    for (int h = M / 2; h > 0; h /= 2)
#pragma unroll
      for (int m = 0; m < h; ++m) v[m] = v[m + h] < v[m] ? v[m + h] : v[m];
    const unsigned hi = __reduce_min_sync(kFull, (unsigned)(v[0] >> 32));
    const unsigned lo = __reduce_min_sync(
        kFull, (unsigned)(v[0] >> 32) == hi ? (unsigned)v[0] : 0xffffffffu);
    const unsigned long long pick = ((unsigned long long)hi << 32) | lo;
    // lanes at or past pick's place shift up by one
    const unsigned long long up = __shfl_up_sync(kFull, run, 1);
    if (lane < k && run > pick) run = (lane > 0 && up > pick) ? up : pick;
    thr = __shfl_sync(kFull, run, k - 1);
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (!(cand[m] > pick && cand[m] < thr)) bits &= ~(1u << m);
  }
  return run;
}

// Rounds over 8 candidates a lane at a time (select_rounds keeps no more
// in registers).
template <int M>
__device__ __forceinline__ unsigned long long select_rounds_by_8(
    const unsigned long long (&cand)[M], unsigned long long run, int k,
    int lane) {
  if constexpr (M > 8) {
    unsigned long long part[8];
#pragma unroll
    for (int h = 0; h < M / 8; ++h) {
#pragma unroll
      for (int m = 0; m < 8; ++m) part[m] = cand[h * 8 + m];
      run = select_rounds(part, run, k, lane);
    }
    return run;
  } else {
    return select_rounds(cand, run, k, lane);
  }
}

// The filtered selection of one query on one sub-chunk. `run` is the
// lane's entry of the sorted list (lane j < k the j-th smallest key so far;
// kNone past the list's end and on lanes >= k), `cand` the lane's M
// candidate keys (kNone for masked rows), `scr` kScratch keys of scratch.
// A candidate survives below the list's k-th key; while the list is not
// full, at or below the k-th smallest of the 32 lanes' minima (an upper
// bound on the sub-chunk's k-th smallest). One vote ends a sub-chunk with
// no survivor. Otherwise the list's k keys and the survivors go to `scr`
// (positions from one ballot a candidate slot) and each is ranked against
// all of them (ties by position, so the ranks are distinct): the key of
// rank j < k is the new list's j-th. The cost follows the survivors, not
// the k rounds of a selection by successive minima; more than kCap
// survivors (many equal values) take select_rounds. Returns the lane's
// entry of the new list.
template <int M>
__device__ __forceinline__ unsigned long long select_ranked(
    const unsigned long long (&cand)[M], unsigned long long run, int k,
    int lane, unsigned long long* scr) {
  const unsigned long long thr = __shfl_sync(kFull, run, k - 1);
  unsigned long long lim = thr;  // survivors: cand < lim
  if (thr == kNone) {
    unsigned long long lmin = cand[0];
#pragma unroll
    for (int m = 1; m < M; ++m) lmin = cand[m] < lmin ? cand[m] : lmin;
    scr[lane] = lmin;
    __syncwarp();
    int r = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned long long y = scr[j];
      r += (y < lmin || (y == lmin && j < lane)) ? 1 : 0;
    }
    const unsigned at = __ballot_sync(kFull, r == k - 1);
    const unsigned long long t = __shfl_sync(kFull, lmin, __ffs(at) - 1);
    lim = t == kNone ? kNone : t + 1;
    __syncwarp();  // scr is rewritten below
  }
  unsigned bits = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) bits |= (cand[m] < lim ? 1u : 0u) << m;
  const int s = (int)__reduce_add_sync(kFull, __popc(bits));
  if (s == 0) return run;
  if (s > kCap) return select_rounds_by_8(cand, run, k, lane);
  if (lane < k) scr[lane] = run;
  const unsigned below = (1u << lane) - 1u;
  int base = k;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const bool mine = (bits >> m) & 1u;
    const unsigned set = __ballot_sync(kFull, mine);
    if (mine) scr[base + __popc(set & below)] = cand[m];
    base += __popc(set);
  }
  __syncwarp();
  const int total = k + s;
  unsigned long long* slot = scr + kCap + kMaxK;
  for (int i = lane; i < total; i += 32) {
    const unsigned long long x = scr[i];
    int r = 0;
#pragma unroll 8
    for (int j = 0; j < total; ++j) {
      const unsigned long long y = scr[j];
      r += (y < x || (y == x && j < i)) ? 1 : 0;
    }
    if (r < k) slot[r] = x;
  }
  __syncwarp();
  return lane < k ? slot[lane] : kNone;
}

template <int QT, bool V16>
__global__ void __launch_bounds__(kClThreads, 1)
fused_bf_cluster_kernel(const float* __restrict__ q,
                        const float* __restrict__ db,
                        const float* __restrict__ norms, int nv, int b, int d,
                        int k, int dk, int rows_cta, float* __restrict__ out_v,
                        int* __restrict__ out_i) {
  using T = Tile<QT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ring_bytes = T::ring_bytes(dk);
  float* ring = reinterpret_cast<float*>(smem);
  float* ds = reinterpret_cast<float*>(smem + ring_bytes);
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(
      smem + ring_bytes + T::kDsBytes);
  __shared__ float qsq[QT];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int split = blockIdx.x;  // rank in the cluster: grid.x is its width
  const int cs = gridDim.x;
  const int q0 = blockIdx.y * QT;
  const int row_begin = (int)min((long long)nv, (long long)split * rows_cta);
  const int row_end = (int)min((long long)nv, (long long)row_begin + rows_cta);
  const int n_sub = (row_end - row_begin + T::kR - 1) / T::kR;
  const int n_slab = (d + dk - 1) / dk;
  const int units = n_sub * n_slab;
  const int pitch = dk + 4;
  const int stage_floats = (T::kR + QT) * pitch;
  const int per = V16 ? 4 : 1;     // floats a copy
  const int copies = dk / per;     // copies a staged row
  // this thread's first copy of a unit and the step to its next one, as
  // (staged row, copy in the row): no division in the loop
  const int row_first = tid / copies, c_first = tid % copies;
  const int row_step = kClThreads / copies, c_step = kClThreads % copies;

  // unit u = (sub-chunk u / n_slab, slab u % n_slab) into stage u % 2: kR
  // rows then QT queries, dk d each, zeros past the edges of d and of the
  // query tile; rows past the range are not copied (their products are
  // skipped by row group or masked)
  auto issue = [&](int u) {
    if (u < units) {
      const int r0 = row_begin + u / n_slab * T::kR;
      const int k0 = u % n_slab * dk;
      float* st = ring + u % kStages * stage_floats;
      int row = row_first, c = c_first;
      while (row < T::kR + QT) {
        const int col = k0 + c * per;
        const bool is_row = row < T::kR;
        const int at = is_row ? r0 + row : q0 + row - T::kR;
        if (is_row && at >= row_end) {
          // the rest of the rows are past the range too: on to this
          // thread's first copy of the queries
          const int id0 = T::kR * copies;
          const int first = id0 + ((tid - id0) % kClThreads + kClThreads) %
                                      kClThreads;
          row = first / copies;
          c = first % copies;
          continue;
        }
        const bool ok = col < d && (is_row ? at < row_end : at < b);
        const float* src = ok ? (is_row ? db : q) + (long long)at * d + col
                              : db;
        float* dst = st + row * pitch + c * per;
        if (V16)
          cp_async16(dst, src, ok ? 16 : 0);
        else
          cp_async4(dst, src, ok ? 4 : 0);
        row += row_step;
        c += c_step;
        if (c >= copies) {
          c -= copies;
          ++row;
        }
      }
    }
    cp_async_commit();  // empty past the last unit: the waits stay uniform
  };
  issue(0);
  issue(1);
  if (tid < QT) {
    // |q|^2, one FMA chain in ascending d, while the first slabs land
    float a = 0.0f;
    if (q0 + tid < b) {
      const float* qr = q + (long long)(q0 + tid) * d;
#pragma unroll 8
      for (int dd = 0; dd < d; ++dd) a = fmaf(qr[dd], qr[dd], a);
    }
    qsq[tid] = a;
  }

  const int g = tid / T::kLanes;   // queries 8g .. 8g + 7: one per warp
  const int rl = tid % T::kLanes;  // rows rl + kLanes i of the sub-chunk
  unsigned long long run[T::kQPW];
#pragma unroll
  for (int u = 0; u < T::kQPW; ++u) run[u] = kNone;

  for (int c = 0; c < n_sub; ++c) {
    const int r0 = row_begin + c * T::kR;
    // the rows' norms, in flight during the products
    float xsq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + rl + i * T::kLanes;
      xsq[i] = row < row_end ? norms[row] : 0.0f;
    }
    // row groups holding rows of the range (fewer in a last, short
    // sub-chunk); the same for the whole CTA
    const int na = min(4, (row_end - r0 + T::kLanes - 1) / T::kLanes);
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < n_slab; ++s) {
      const int u = c * n_slab + s;
      cp_async_wait1();  // unit u has landed; u + 1 may be in flight
      __syncthreads();
      const float* st = ring + u % kStages * stage_floats;
      const float* xr = st + rl * pitch;
      const float* qr = st + (T::kR + 8 * g) * pitch;
      // the slab's d, rounded up to 4 (the copies zero-filled the rest)
      const int w4 = (min(dk, d - s * dk) + 3) / 4;
      if (na == 4)
        slab_fma<4, T::kLanes>(acc, xr, qr, pitch, w4);
      else if (na == 3)
        slab_fma<3, T::kLanes>(acc, xr, qr, pitch, w4);
      else if (na == 2)
        slab_fma<2, T::kLanes>(acc, xr, qr, pitch, w4);
      else
        slab_fma<1, T::kLanes>(acc, xr, qr, pitch, w4);
      __syncthreads();  // the stage is free
      issue(u + 2);
    }

    // the sub-chunk's distances; rows past the range (or n_valid) +inf
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + rl + i * T::kLanes;
      const bool in = row < row_end;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = qsq[8 * g + j] + xsq[i] - 2.0f * acc[i][j];
        // past MASKED_DISTANCE / 2 or NaN: missing; else clamped at +0
        v = (!in || !(v < kMaskedHalf)) ? INFINITY : (v > 0.0f ? v : 0.0f);
        ds[(8 * g + j) * T::kR + rl + i * T::kLanes] = v;
      }
    }
    __syncthreads();
    // the warp's queries' candidates into registers; their rows of ds are
    // then the warp's selection scratch
    float* dw = ds + warp * T::kQPW * T::kR;
    unsigned long long cand[T::kQPW][T::kM];
#pragma unroll
    for (int u = 0; u < T::kQPW; ++u)
#pragma unroll
      for (int m = 0; m < T::kM; ++m) {
        const float v = dw[u * T::kR + lane + 32 * m];
        cand[u][m] = v < INFINITY ? pack(v, r0 + lane + 32 * m) : kNone;
      }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < T::kQPW; ++u)
      run[u] = select_ranked(
          cand[u], run[u], k, lane,
          reinterpret_cast<unsigned long long*>(dw) + u * kScratch);
    // the next sub-chunk rewrites ds only after the slab loop's barrier
  }

  if (cs == 1) {
#pragma unroll
    for (int u = 0; u < T::kQPW; ++u) {
      const int qi = q0 + warp * T::kQPW + u;
      if (qi < b && lane < k) write_out(out_v, out_i, qi, k, lane, run[u]);
    }
    return;
  }

#pragma unroll
  for (int u = 0; u < T::kQPW; ++u)
    if (lane < k) lists[(warp * T::kQPW + u) * kMaxK + lane] = run[u];
  cluster_sync();  // every CTA's lists written (and ds read)
  // this CTA merges queries split, split + cs, ... of the tile: their cs
  // lists of k keys from the peers' shared memory into ds
  const int nq = split < QT ? (QT - split + cs - 1) / cs : 0;
  const int n = cs * k;
  unsigned long long* cands = reinterpret_cast<unsigned long long*>(ds);
  for (int it = tid; it < nq * n; it += kClThreads) {
    const int j = it / n, c = it % n;
    cands[it] = ld_peer(&lists[(split + j * cs) * kMaxK + c % k], c / k);
  }
  // this CTA is done reading its peers; it waits for them to be done
  // reading it only before it exits
  cluster_arrive();
  __syncthreads();
  for (int it = tid; it < nq * n; it += kClThreads) {
    const int j = it / n, c = it % n;
    const int qi = q0 + split + j * cs;
    const unsigned long long* row = cands + j * n;
    const unsigned long long x = row[c];
    // the keys are unique but for kNone: ties go by position, so the
    // ranks are 0 .. n - 1, each once, and slots 0 .. k - 1 each get one
    int rank = 0;
#pragma unroll 8
    for (int c2 = 0; c2 < n; ++c2) {
      const unsigned long long y = row[c2];
      rank += (y < x || (y == x && c2 < c)) ? 1 : 0;
    }
    if (qi < b && rank < k) write_out(out_v, out_i, qi, k, rank, x);
  }
  cluster_wait();
}

// Raises the kernel's shared-memory limit and allows clusters past 8, once
// an instance and device.
template <int QT, bool V16>
cudaError_t cluster_attrs() {
  static sm90::HostMemo memo;
  int dev = 0, done = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return memo.get((uint32_t)(dev & 127), &done, [](int*) {
    auto kernel = fused_bf_cluster_kernel<QT, V16>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<QT>::kFixed + Tile<QT>::ring_bytes(Tile<QT>::kMaxDk));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
}

template <int QT>
cudaLaunchConfig_t cluster_config(int cluster, int tiles, int dk,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, tiles);
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = Tile<QT>::kFixed + Tile<QT>::ring_bytes(dk);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int QT, bool V16>
int cluster_launch(const float* q, const float* db, const float* norms,
                   int nv, int b, int d, int k, int dk, int cluster,
                   int rows_cta, float* out_v, int* out_i,
                   cudaStream_t stream) {
  cudaError_t err = cluster_attrs<QT, V16>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<QT>(cluster, (b + QT - 1) / QT, dk,
                                               attr, stream);
  err = cudaLaunchKernelEx(&cfg, fused_bf_cluster_kernel<QT, V16>, q, db,
                           norms, nv, b, d, k, dk, rows_cta, out_v, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The widest ring stage (d) of the q_tile instance (ops/fused_bf.MAX_SLAB
// holds the same); 0 for a tile it is not built for.
int max_slab(int q_tile) {
  return q_tile == 16 ? Tile<16>::kMaxDk : q_tile == 32 ? Tile<32>::kMaxDk : 0;
}

template <int QT>
int cluster_capacity(int cluster, int dk, int* clusters) {
  cudaError_t err = cluster_attrs<QT, true>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config<QT>(cluster, 1, dk, attr, 0);
  if (cudaOccupancyMaxActiveClusters(
          clusters, fused_bf_cluster_kernel<QT, true>, &cfg) != cudaSuccess) {
    // a width the card cannot schedule: none fit, and the error is not
    // left for the next launch's cudaGetLastError()
    cudaGetLastError();
    *clusters = 0;
  }
  return 0;
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

// Plain C entry point of the cluster kernel, loaded through ctypes: the
// plan (clusters of `cluster` CTAs, one a tile of q_tile = 16 or 32
// queries, each CTA `rows_per_cta` rows; ops/fused_bf.cluster_plan) covers
// rows [0, n_valid) once; `dk` d a ring stage (a multiple of 8, at most
// max_slab(q_tile)). Launches on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fused_bf_cluster_search(const void* q, const void* db,
                                       const void* norms, int n_valid, int b,
                                       int d, int k, int q_tile, int cluster,
                                       int rows_per_cta, int dk, void* out_v,
                                       void* out_i, void* stream) {
  if (b <= 0) return 0;
  const int max_dk = max_slab(q_tile);
  if (d <= 0 || k < 1 || k > kMaxK || n_valid < 0 || cluster < 1 ||
      cluster > kMaxCluster || rows_per_cta < 1 ||
      (long long)rows_per_cta * cluster < n_valid || max_dk == 0 ||
      dk < 8 || dk % 8 != 0 || dk > max_dk ||
      (b + q_tile - 1) / q_tile > 65535)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where every row starts 16-byte aligned
  const bool v16 = d % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)db % 16 == 0;
  const float *qf = (const float*)q, *dbf = (const float*)db,
              *nf = (const float*)norms;
  float* ov = (float*)out_v;
  int* oi = (int*)out_i;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_tile == 16)
    return v16 ? cluster_launch<16, true>(qf, dbf, nf, n_valid, b, d, k, dk,
                                          cluster, rows_per_cta, ov, oi, st)
               : cluster_launch<16, false>(qf, dbf, nf, n_valid, b, d, k, dk,
                                           cluster, rows_per_cta, ov, oi, st);
  return v16 ? cluster_launch<32, true>(qf, dbf, nf, n_valid, b, d, k, dk,
                                        cluster, rows_per_cta, ov, oi, st)
             : cluster_launch<32, false>(qf, dbf, nf, n_valid, b, d, k, dk,
                                         cluster, rows_per_cta, ov, oi, st);
}

// Clusters of `cluster` CTAs of the q_tile instance with `dk`-wide stages
// the card holds at once (cudaOccupancyMaxActiveClusters; 0 where one does
// not fit). Returns a CUDA error code (0 on success).
extern "C" int fused_bf_cluster_capacity(int q_tile, int cluster, int dk,
                                         int* clusters) {
  *clusters = 0;
  if (cluster < 1 || cluster > kMaxCluster || dk < 8 || dk % 8 != 0 ||
      dk > max_slab(q_tile))
    return (int)cudaErrorInvalidValue;
  return q_tile == 16 ? cluster_capacity<16>(cluster, dk, clusters)
                      : cluster_capacity<32>(cluster, dk, clusters);
}

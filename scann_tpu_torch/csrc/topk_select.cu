// Exact smallest-k selection over rows of bf16 scores on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package selects tree-x-AH's candidates
// with lax.approx_min_k, an XLA operation, and the port selected them with
// torch.topk over an int64 key (ops/topk.py::_top_k_by_key). This kernel
// gives that selection's results bit for bit, with no key in memory:
//
//     out_vals[r, :], out_idx[r, :] = the k smallest of row r, ascending by
//         (ordered value, column)
//
// where the ordered value of a bf16 pattern b is u = b ^ 0x8000 for a clear
// sign bit and u = ~b for a set one: the int64 key's order (negative
// patterns XOR 0x7FFF, shifted by 2^15). -0.0 comes before +0.0, ties come
// lower column first, NaNs with a set sign bit before -inf and the others
// after +inf. Values come back as their input bits, NaN payloads included.
//
// Layouts: in [rows, row_stride] bf16 with unit column stride (any row
// stride, any alignment of a row's start); out_vals [rows, k] bf16;
// out_idx [rows, k] int64; `cap` keys a row for the candidates (a power of
// two, at least 4,096 and at least k), in shared memory while they fit
// (k <= 16,384), else in the caller's global scratch [rows, cap] int64.
//
// What bounds it on the H100. The selection has to read each score once:
// at [1024, 102,400] that is 209.7 MB, 0.063 ms at 3.35 TB/s. The old path
// wrote and read an 8-byte key per score several times (about 5 ms). The
// design:
//   - one block of 512 threads a row, three blocks an SM; a warp owns a
//     contiguous range of the row, read as 16-byte chunks (8 values), two
//     chunks a lane in flight. The chunk grid starts at the 16-byte
//     boundary at or below the row's start; values outside the row are
//     ignored. The ordered values of a chunk come from four 32-bit
//     operations, two values each;
//   - an exact radix select over the 16-bit ordered value: a 256-bin
//     histogram of its high byte finds the bin where the count reaches k,
//     a histogram of the low byte inside that bin the k-th value v*, the
//     count below it and the count equal to it. Each histogram is kept per
//     lane ([bin][lane] words in shared memory): a lane's atomic add lands
//     in its own bank, so scores that crowd into one bin (bf16 leaf
//     scores do, and so do masked slots) cost no bank conflicts. A chunk
//     whose 8 values share a high byte is one add; the second pass skips
//     chunks with no value in the bin;
//   - the selection pass skips, by one warp vote, the chunks whose
//     smallest value is above v*, and appends (u << 32 | column) for every
//     value below v* and every value equal to it to a shared buffer, one
//     shared atomic a warp and step. Where those are more than the buffer
//     holds (a tie at v* across many columns: all-equal rows, masked
//     tails), a counting pass first gives each warp the number of v*
//     values before its range, and only the first k - below of them, in
//     column order, are appended;
//   - a bitonic sort of the buffer, padded to a power of two, orders the
//     candidates by (u, column); the first k are written as bf16 bits and
//     int64 columns. (Stages in registers and shuffles were 0.3-6% faster,
//     too little to show end to end.)
// At [1024, 102,400] each of the three passes takes about 0.09 ms and the
// sort of 1,024 keys about 0.07 (PERF.md). Shared memory: 32 KB of
// histograms, whose bytes then hold the key buffer (8 * cap bytes when the
// keys stay in shared memory; with global keys, 128 KB that stage the
// sort's chunks of 16,384 keys), and 1 KB of bin counts. Larger k (the
// sort's global-memory form) serves callers such as SOAR's pre_k *
// multiplicity; no benchmark cell selects that many.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;        // 16-byte chunks a lane has in flight
constexpr int kBins = 256;
constexpr int kMinCap = 4096;     // keys the histograms' bytes hold
constexpr int kMaxSharedCap = 16384;   // keys kept in shared memory (128 KB)
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kBins * 32 * 4 == kMinCap * 8, "histogram and keys share");

struct Args {
  const uint16_t* in;
  long long row_stride;   // elements
  int n;                  // columns
  int k;
  int cap;                // keys a row's buffer holds, a power of two
  uint16_t* out_vals;
  long long* out_idx;
  uint64_t* scratch;      // [rows, cap] when the keys are global
};

// the ordered values of the two bf16 patterns in a word: the sign bit of
// each half picks XOR 0xFFFF (set) or 0x8000 (clear)
__device__ __forceinline__ uint32_t ordered2(uint32_t w) {
  return w ^ ((((w >> 15) & 0x00010001u) * 0x7FFFu) | 0x80008000u);
}

__device__ __forceinline__ uint4 ordered8(const uint4& v) {
  return make_uint4(ordered2(v.x), ordered2(v.y), ordered2(v.z),
                    ordered2(v.w));
}

__device__ __forceinline__ uint16_t unordered(uint32_t u) {
  return (uint16_t)(u ^ ((u & 0x8000u) ? 0x8000u : 0xFFFFu));
}

// element e (0..7, a constant after unrolling) of a chunk
__device__ __forceinline__ uint32_t element(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return (e & 1) ? (w >> 16) : (w & 0xFFFFu);
}

// the smallest of a chunk's 8 ordered values
__device__ __forceinline__ uint32_t chunk_min(const uint4& o) {
  const uint32_t m = __vminu2(__vminu2(o.x, o.y), __vminu2(o.z, o.w));
  return min(m & 0xFFFFu, m >> 16);
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// A warp's walk over its chunks [wbeg, wend) in column order: steps of 32
// chunks (one a lane), kUnroll steps loaded before any is used. Every lane
// of the warp makes the same calls, so `f` may vote and shuffle.
// f(first, lo, hi, o): the chunk's 8 ordered values, the first at column
// `first`, of which those at element positions [lo, hi) lie in the row
// (lo = 0 and hi = 8 but at the row's two ends).
template <class F>
__device__ __forceinline__ void walk(const uint4* chunks, int head, int n,
                                     int wbeg, int wend, int lane, F&& f) {
  for (int base = wbeg; base < wend; base += 32 * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const int c = base + s * 32 + lane;
      v[s] = c < wend ? __ldg(chunks + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const int c = base + s * 32 + lane;
      const int first = c * 8 - head;           // column of element 0
      const int lo = c < wend ? max(0, -first) : 8;
      const int hi = c < wend ? min(8, n - first) : 0;
      f(first, lo, hi, ordered8(v[s]));
    }
  }
}

// One step (size, stride) of a bitonic sort over buf[0, n), whose first
// key sits at index `base` of the whole sequence (the direction of a
// pair follows its index there).
__device__ __forceinline__ void bitonic_step(uint64_t* buf, int n, int size,
                                             int stride, int base) {
  for (int i = threadIdx.x; i < n / 2; i += kThreads) {
    const int lo_i = 2 * i - (i & (stride - 1));
    const int hi_i = lo_i + stride;
    const uint64_t x = buf[lo_i], y = buf[hi_i];
    if ((x > y) == (((base + lo_i) & size) == 0)) {
      buf[lo_i] = y;
      buf[hi_i] = x;
    }
  }
}

// Sum of the [bin][lane] histogram into counts[bin]. Thread t reads bank
// (l + t) % 32 at step l, so a warp's reads never share a bank.
__device__ __forceinline__ void reduce_bins(const uint32_t* hist,
                                            uint32_t* counts) {
  const int t = threadIdx.x;
  if (t < kBins) {
    uint32_t s = 0;
#pragma unroll 8
    for (int l = 0; l < 32; ++l) s += hist[t * 32 + ((l + t) & 31)];
    counts[t] = s;
  }
}

// One warp: the bin where the running count reaches `target` (1 <= target
// <= the total), into *bin_out, and the count before it, into *before_out.
__device__ __forceinline__ void find_bin(const uint32_t* counts,
                                         uint32_t target, int lane,
                                         int* bin_out, uint32_t* before_out) {
  uint32_t c[8];
  uint32_t local = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[i] = counts[lane * 8 + i];
    local += c[i];
  }
  const uint32_t incl = (uint32_t)warp_inclusive_sum((int)local, lane);
  uint32_t run = incl - local;
  if (run < target && target <= incl) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (run + c[i] >= target) {
        *bin_out = lane * 8 + i;
        *before_out = run;
        break;
      }
      run += c[i];
    }
  }
}

// kGlobalKeys: the candidate keys live in a.scratch (k > kMaxSharedCap),
// else in the dynamic shared buffer after the histograms are done with it
template <bool kGlobalKeys>
__global__ void __launch_bounds__(kThreads, 3)
topk_select_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) uint64_t s_dyn[];
  __shared__ uint32_t s_counts[kBins];
  __shared__ uint32_t s_warp_eq[kWarps];
  __shared__ int s_bin, s_low, s_fill;
  __shared__ uint32_t s_before, s_in_bin;

  uint32_t* hist = reinterpret_cast<uint32_t*>(s_dyn);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  uint64_t* keys = kGlobalKeys ? a.scratch + row * a.cap : s_dyn;
  const uint16_t* src = a.in + row * a.row_stride;
  const int head = (int)((reinterpret_cast<uintptr_t>(src) & 15) >> 1);
  const uint4* chunks = reinterpret_cast<const uint4*>(src - head);
  const int n = a.n, k = a.k;
  const int n_chunks = (head + n + 7) >> 3;
  const int per_warp = (((n_chunks + kWarps - 1) / kWarps) + 31) & ~31;
  const int wbeg = min(warp * per_warp, n_chunks);
  const int wend = min(wbeg + per_warp, n_chunks);

  for (int i = tid; i < kMinCap / 2; i += kThreads)
    reinterpret_cast<uint4*>(s_dyn)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) s_fill = 0;
  __syncthreads();

  // pass 1: histogram of the high byte; a whole chunk in one bin (a
  // masked tail, crowded scores) is one add
  walk(chunks, head, n, wbeg, wend, lane,
       [&](int, int lo, int hi, const uint4& o) {
         const uint32_t hb = (o.x >> 8) & 0x00FF00FFu;
         if (lo == 0 && hi == 8 && hb == ((o.y >> 8) & 0x00FF00FFu) &&
             hb == ((o.z >> 8) & 0x00FF00FFu) &&
             hb == ((o.w >> 8) & 0x00FF00FFu) && (hb >> 16) == (hb & 0xFFu)) {
           atomicAdd(&hist[(hb & 0xFFu) * 32 + lane], 8u);
           return;
         }
#pragma unroll
         for (int e = 0; e < 8; ++e)
           if (e >= lo && e < hi)
             atomicAdd(&hist[(element(o, e) >> 8) * 32 + lane], 1u);
       });
  __syncthreads();
  reduce_bins(hist, s_counts);
  __syncthreads();
  if (warp == 0) {
    find_bin(s_counts, (uint32_t)k, lane, &s_bin, &s_before);
  } else {
    for (int i = tid - 32; i < kMinCap / 2; i += kThreads - 32)
      reinterpret_cast<uint4*>(s_dyn)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // pass 2: histogram of the low byte inside the high byte's bin
  const uint32_t bin = (uint32_t)s_bin;
  const uint32_t bin2 = bin * 0x00010001u;
  walk(chunks, head, n, wbeg, wend, lane,
       [&](int, int lo, int hi, const uint4& o) {
         if ((__vcmpeq2((o.x >> 8) & 0x00FF00FFu, bin2) |
              __vcmpeq2((o.y >> 8) & 0x00FF00FFu, bin2) |
              __vcmpeq2((o.z >> 8) & 0x00FF00FFu, bin2) |
              __vcmpeq2((o.w >> 8) & 0x00FF00FFu, bin2)) == 0)
           return;
#pragma unroll
         for (int e = 0; e < 8; ++e) {
           const uint32_t u = element(o, e);
           if (e >= lo && e < hi && (u >> 8) == bin)
             atomicAdd(&hist[(u & 0xFFu) * 32 + lane], 1u);
         }
       });
  __syncthreads();
  reduce_bins(hist, s_counts);
  __syncthreads();
  if (warp == 0) find_bin(s_counts, (uint32_t)k - s_before, lane, &s_low,
                          &s_in_bin);
  __syncthreads();

  const uint32_t vstar = (bin << 8) | (uint32_t)s_low;
  const uint32_t below = s_before + s_in_bin, eq = s_counts[s_low];
  // all the candidates fit the buffer, or only the first `need` of the
  // values equal to v* (in column order) go in
  const bool ordered_ties = below + eq > (uint32_t)a.cap;
  const uint32_t need = (uint32_t)k - below;
  const int total = ordered_ties ? k : (int)(below + eq);

  uint32_t eq_seen = 0;   // ties before this warp's current step
  if (ordered_ties) {
    uint32_t mine = 0;
    walk(chunks, head, n, wbeg, wend, lane,
         [&](int, int lo, int hi, const uint4& o) {
#pragma unroll
           for (int e = 0; e < 8; ++e)
             mine += (e >= lo && e < hi && element(o, e) == vstar);
         });
    mine = __reduce_add_sync(kFull, mine);
    if (lane == 0) s_warp_eq[warp] = mine;
    __syncthreads();
    for (int w = 0; w < warp; ++w) eq_seen += s_warp_eq[w];
  }

  // the selection pass; most chunks hold nothing at or below v*
  walk(chunks, head, n, wbeg, wend, lane,
       [&](int first, int lo, int hi, const uint4& o) {
         if (!__any_sync(kFull, chunk_min(o) <= vstar && lo < hi)) return;
         uint32_t lt = 0, tie = 0;
#pragma unroll
         for (int e = 0; e < 8; ++e) {
           const uint32_t u = element(o, e);
           const bool in = e >= lo && e < hi;
           lt |= (uint32_t)(in && u < vstar) << e;
           tie |= (uint32_t)(in && u == vstar) << e;
         }
         uint32_t sel = lt | tie;
         if (ordered_ties) {
           sel = lt;
           if (eq_seen < need && __any_sync(kFull, tie)) {
             // this lane's ties have ranks rank0, rank0 + 1, ...: keep
             // those below `need`, the lowest set bits of `tie` (a loop
             // over the bits that counted the rank up came out of nvcc
             // 12.9 with its bits shifted by two)
             const int cnt = __popc(tie);
             const int incl = warp_inclusive_sum(cnt, lane);
             const uint32_t rank0 = eq_seen + (uint32_t)(incl - cnt);
             uint32_t keep = rank0 < need ? tie : 0u;
             if (rank0 < need && need - rank0 < (uint32_t)cnt)
               keep &= (1u << __fns(tie, 0, (int)(need - rank0) + 1)) - 1u;
             sel = lt | keep;
             eq_seen += (uint32_t)__shfl_sync(kFull, incl, 31);
           }
         }
         if (__any_sync(kFull, sel)) {
           const int cnt = __popc(sel);
           const int incl = warp_inclusive_sum(cnt, lane);
           int base = 0;
           if (lane == 31) base = atomicAdd(&s_fill, incl);
           int pos = __shfl_sync(kFull, base, 31) + incl - cnt;
#pragma unroll
           for (int e = 0; e < 8; ++e)
             if ((sel >> e) & 1)
               keys[pos++] = ((uint64_t)element(o, e) << 32) |
                             (uint32_t)(first + e);
         }
       });
  __syncthreads();

  int sort_n = 1;
  while (sort_n < total) sort_n <<= 1;
  for (int i = total + tid; i < sort_n; i += kThreads) keys[i] = ~0ull;
  __syncthreads();

  // bitonic sort of keys[0, sort_n) by (u, column)
  if constexpr (!kGlobalKeys) {
    for (int size = 2; size <= sort_n; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        bitonic_step(keys, sort_n, size, stride, 0);
        __syncthreads();
      }
  } else {
    // global keys (sort_n > kMaxSharedCap): every stride below a chunk of
    // kMaxSharedCap keys runs on the chunk staged in shared memory, so
    // only the strides of a chunk or more pass over global memory
    auto in_chunks = [&](int size_from, int size_to) {
      for (int c = 0; c < sort_n; c += kMaxSharedCap) {
        for (int i = tid; i < kMaxSharedCap; i += kThreads)
          s_dyn[i] = keys[c + i];
        __syncthreads();
        for (int size = size_from; size <= size_to; size <<= 1)
          for (int stride = min(size, kMaxSharedCap) >> 1; stride > 0;
               stride >>= 1) {
            bitonic_step(s_dyn, kMaxSharedCap, size, stride, c);
            __syncthreads();
          }
        for (int i = tid; i < kMaxSharedCap; i += kThreads)
          keys[c + i] = s_dyn[i];
        __syncthreads();
      }
    };
    in_chunks(2, kMaxSharedCap);
    for (int size = 2 * kMaxSharedCap; size <= sort_n; size <<= 1) {
      for (int stride = size >> 1; stride >= kMaxSharedCap; stride >>= 1) {
        bitonic_step(keys, sort_n, size, stride, 0);
        __syncthreads();
      }
      in_chunks(size, size);
    }
  }

  uint16_t* ov = a.out_vals + row * k;
  long long* oi = a.out_idx + row * k;
  for (int i = tid; i < k; i += kThreads) {
    const uint64_t key = keys[i];
    ov[i] = unordered((uint32_t)(key >> 32));
    oi[i] = (long long)(uint32_t)key;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches one block a row on `stream`,
// does not synchronise, allocates nothing; returns cudaGetLastError() after
// the launch (0 on success). `cap` is a power of two, at least 4,096 and at
// least k; `scratch` holds [rows, cap] int64 when cap > 16,384, else it is
// unused (ops/topk.py sizes both).
extern "C" int topk_select_bf16(const void* in, long long row_stride,
                                int rows, int n, int k, int cap,
                                void* out_vals, void* out_idx,
                                void* scratch, void* stream) {
  if (rows < 1 || n < 1 || k < 1 || k > n || cap < kMinCap || cap < k ||
      (cap & (cap - 1)) != 0 || (cap > kMaxSharedCap && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a = {static_cast<const uint16_t*>(in), row_stride, n, k, cap,
                  static_cast<uint16_t*>(out_vals),
                  static_cast<long long*>(out_idx),
                  static_cast<uint64_t*>(scratch)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool global = cap > kMaxSharedCap;
  const int smem = (global ? kMaxSharedCap : cap) * 8;
  auto kernel = global ? topk_select_bf16_kernel<true>
                       : topk_select_bf16_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<rows, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

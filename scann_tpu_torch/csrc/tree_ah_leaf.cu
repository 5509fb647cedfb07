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
//           alignment, any N_csr);
//   sizes   [B*p] i32 partition size of each pair (off + size <= N_csr);
//   order   [B*p] i32 the pairs sorted by offset, stably (the wrapper's one
//           device sort);
//   out     [B*p, l_cap] float32.
//
// What bounds it on the H100. The bytes it must move are each pair's table
// (S_pad*C floats), each probed partition's codes once, and each pair's
// l_cap scores: on the per-pair SOAR batch (1024 x 30 pairs, S_pad 64,
// C=16, l_cap 2048) about 0.46 GB, 0.14 ms at 3.35 TB/s. The work is one
// table lookup and one float32 add per (pair, valid column, subspace),
// about 2.3e9 of each. The adds alone take 0.03 ms at the float32 rate, but
// every lookup is one shared-memory read, and a Hopper SM serves 32 of them
// a clock: 2.3e9 / (32 * 132 SMs * ~1.8 GHz) = ~0.3 ms, the floor of any
// design that looks entries up on the CUDA cores.
//
// The design, to sit on that floor:
//   - pairs in partition order: block b scores the Q consecutive pairs
//     order[b*Q, b*Q+Q) (Q from the wrapper's shared-memory budget, at most
//     8). Runs of equal offsets inside the chunk are its distinct
//     partitions; at ~10 pairs a partition a chunk spans one or two;
//   - the chunk's Q tables are staged once into shared memory, laid out
//     [S_pad][Q][C] so that, for C=16 or 256, the pairs of a run sit at
//     constant offsets from one address and every 16-entry row lies in 16
//     banks (a warp's lookups never conflict at C=16);
//   - each run's codes stream through a 2-stage ring of [16 subspaces x 512
//     columns] tiles by 16-byte cp.async copies taken from the 16-byte
//     aligned address below each row's start (any offset, any N_csr); the
//     next tile's copies are in flight while one is scored, and a
//     partition's codes are read once per chunk, not once per pair. Four
//     blocks share an SM;
//   - a thread owns 4 neighbouring columns of a tile: per subspace it reads
//     their 4 code bytes once (one aligned word, or two and a funnel shift
//     where offsets or N_csr are not multiples of 4) and adds each run
//     pair's entry to one float32 register per (pair, column), over
//     ascending s from 0.0f -- the order of the PyTorch twin
//     (tree_ah_leaf_scores_reference), additions only, so kernel and twin
//     agree bit for bit;
//   - each pair's [len, l_cap) tail (len, the longest size of its run) is
//     written MASKED_DISTANCE with float4 stores while the first tiles
//     arrive, reading neither codes nor tables.
// Tensor cores would need a one-hot contraction of S_pad*C terms per score
// in bf16 or TF32 products, which is neither exact in float32 nor summed in
// the twin's order, so the kernel stays on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskedDistance = 1.7e38f;  // types.MASKED_DISTANCE
constexpr int kThreads = 128;
constexpr int kTileCols = 4 * kThreads;      // code columns per tile
constexpr int kRowBytes = kTileCols + 16;    // a tile row and its shift
constexpr int kCopies = kRowBytes / 16;      // 16-byte copies per tile row
constexpr int kStageRows = 16;               // subspaces per ring stage
constexpr int kStages = 2;
constexpr int kStageBytes = kStageRows * kRowBytes;
constexpr int kRingBytes = kStages * kStageBytes;  // ops/tree_ah_leaf.py
constexpr int kMaxQ = 8;                     // ops/tree_ah_leaf.py

// The chunk's pairs in partition order and its runs of equal offsets.
struct Chunk {
  int pair[kMaxQ];
  int size[kMaxQ];
  int off[kMaxQ];
  int tail[kMaxQ];     // first column the pair's run does not score
  int run_off[kMaxQ];
  int run_len[kMaxQ];  // longest size of the run, at most l_cap
  int run_q0[kMaxQ];   // first chunk slot of the run
  int run_nq[kMaxQ];
  int runs;
};

struct Args {
  const float* luts;
  const uint8_t* codes;
  const int* offsets;
  const int* sizes;
  const int* order;
  float* out;
  long long n_csr;
  int pairs;
  int s_pad;
  int c;
  int q;
  int l_cap;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The next ring item to copy: run, column tile, subspace stage.
struct Producer {
  int run;
  int tile;
  int stage;
  int item;
};

__device__ __forceinline__ int next_run(const Chunk& ch, int r) {
  while (r < ch.runs && ch.run_len[r] == 0) ++r;
  return r;
}

// Copies the producer's item (if any is left) into its ring slot, commits
// one cp.async group either way, and advances the producer.
__device__ __forceinline__ void copy_next(const Args& a, const Chunk& ch,
                                          uint8_t* ring, Producer& p) {
  if (p.run < ch.runs) {
    uint8_t* slot = ring + (p.item % kStages) * kStageBytes;
    const int col0 = ch.run_off[p.run] + p.tile * kTileCols;
    const int ncols = min(kTileCols, ch.run_len[p.run] - p.tile * kTileCols);
    const int s0 = p.stage * kStageRows;
    const int rows = min(kStageRows, a.s_pad - s0);
    for (int i = threadIdx.x; i < rows * kCopies; i += kThreads) {
      const int j = i / kCopies, k = i - j * kCopies;
      const uintptr_t src = reinterpret_cast<uintptr_t>(
          a.codes + (long long)(s0 + j) * a.n_csr + col0);
      const uintptr_t base = src & ~uintptr_t(15);
      // a 16-byte piece that holds a byte of the row is read whole (it
      // cannot cross a page); pieces past the row are zero-filled
      const bool live = 16 * k < (int)(src - base) + ncols;
      cp_async16(slot + j * kRowBytes + 16 * k,
                 reinterpret_cast<const void*>(live ? base + 16 * k : base),
                 live ? 16 : 0);
    }
    if (++p.stage * kStageRows >= a.s_pad) {
      p.stage = 0;
      if (++p.tile * kTileCols >= ch.run_len[p.run]) {
        p.tile = 0;
        p.run = next_run(ch, p.run + 1);
      }
    }
    ++p.item;
  }
  cp_async_commit();
}

// Scores run r (NQ pairs) tile by tile from the ring, keeping the producer
// kStages-1 items ahead, and writes the run's scored columns.
template <int NQ, int CC>
__device__ __forceinline__ void score_run(const Args& a, const Chunk& ch,
                                          const float* tabs, uint8_t* ring,
                                          Producer& p, int& item, int r,
                                          int nsc) {
  const int c = CC ? CC : a.c;
  const int q0 = ch.run_q0[r], len = ch.run_len[r];
  const int tid4 = 4 * threadIdx.x;
  const uint32_t ncsr16 = (uint32_t)a.n_csr & 15u;
  const bool vec_out = (a.l_cap & 3) == 0;
  // every row's 4 code bytes are one aligned word (the searcher's slab)
  const bool aligned4 = ((reinterpret_cast<uintptr_t>(a.codes) |
                          (uintptr_t)a.n_csr | (uintptr_t)ch.run_off[r]) &
                         3) == 0;
  for (int tile = 0; tile * kTileCols < len; ++tile) {
    const int ncols = min(kTileCols, len - tile * kTileCols);
    const int v = ncols - tid4;  // columns of this thread inside the run
    const bool live = v > 0;
    const uint32_t keep = v >= 4 ? 0xffffffffu : (1u << (8 * max(v, 0))) - 1u;
    // row s of the tile starts `shift` bytes past its ring row
    uint32_t shift = ((uint32_t)reinterpret_cast<uintptr_t>(a.codes) +
                      (uint32_t)(ch.run_off[r] + tile * kTileCols)) & 15u;
    float acc[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[q][cc] = 0.0f;
    for (int sc = 0; sc < nsc; ++sc, ++item) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // item ready; every thread done with item-1's slot
      copy_next(a, ch, ring, p);
      if (!live) continue;
      const int s0 = sc * kStageRows;
      const int rows = min(kStageRows, a.s_pad - s0);
      const uint8_t* slot = ring + (item % kStages) * kStageBytes;
      const float* tab = tabs + ((long long)s0 * a.q + q0) * c;
#pragma unroll 2
      for (int j = 0; j < rows; ++j) {
        const uint32_t pos = shift + tid4;
        const uint8_t* rp = slot + j * kRowBytes + (pos & ~3u);
        uint32_t w = *reinterpret_cast<const uint32_t*>(rp);
        if (!aligned4) {
          const uint32_t hi = *reinterpret_cast<const uint32_t*>(rp + 4);
          w = __funnelshift_r(w, hi, (pos & 3u) * 8u);
        }
        w &= keep;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* e = tab + ((w >> (8 * cc)) & 0xffu);
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[q][cc] += e[q * c];
        }
        tab += a.q * c;
        shift = (shift + ncsr16) & 15u;
      }
    }
    if (!live) continue;
    const int l0 = tile * kTileCols + tid4;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int size = ch.size[q0 + q];
      float o[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        o[cc] = l0 + cc < size ? acc[q][cc] : kMaskedDistance;
      float* dst = a.out + (long long)ch.pair[q0 + q] * a.l_cap + l0;
      if (vec_out && v >= 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          if (cc < v) dst[cc] = o[cc];
      }
    }
  }
}

template <int CC>
__global__ void __launch_bounds__(kThreads, 4)
tree_ah_leaf_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Chunk ch;
  const int c = CC ? CC : a.c;
  const int nsc = (a.s_pad + kStageRows - 1) / kStageRows;
  float* tabs = reinterpret_cast<float*>(smem);  // [S_pad][Q][C]
  uint8_t* ring =
      smem + ((sizeof(float) * (size_t)a.s_pad * a.q * c + 15) & ~size_t(15));
  const int first = blockIdx.x * a.q;
  const int n = min(a.q, a.pairs - first);

  if (threadIdx.x < n) {
    const int pair = a.order[first + threadIdx.x];
    ch.pair[threadIdx.x] = pair;
    ch.off[threadIdx.x] = a.offsets[pair];
    ch.size[threadIdx.x] = a.sizes[pair];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int runs = 0;
    for (int j = 0; j < n; ++j) {
      const int len = min(max(ch.size[j], 0), a.l_cap);
      if (runs == 0 || ch.off[j] != ch.run_off[runs - 1]) {
        ch.run_off[runs] = ch.off[j];
        ch.run_len[runs] = len;
        ch.run_q0[runs] = j;
        ch.run_nq[runs] = 1;
        ++runs;
      } else {
        ch.run_len[runs - 1] = max(ch.run_len[runs - 1], len);
        ++ch.run_nq[runs - 1];
      }
    }
    for (int r = 0; r < runs; ++r)
      for (int j = 0; j < ch.run_nq[r]; ++j)
        ch.tail[ch.run_q0[r] + j] = ch.run_len[r];
    ch.runs = runs;
  }
  __syncthreads();

  // the chunk's tables, [S_pad][Q][C]: in the first cp.async group
  const int sc_all = a.s_pad * c;
  const bool vec_tabs =
      (c & 3) == 0 && (reinterpret_cast<uintptr_t>(a.luts) & 15) == 0;
  if (vec_tabs) {
    const int per_pair = sc_all / 4;
    for (int i = threadIdx.x; i < n * per_pair; i += kThreads) {
      const int j = i / per_pair, e = 4 * (i - j * per_pair);
      const int s = e / c, k = e - s * c;
      cp_async16(tabs + ((long long)s * a.q + j) * c + k,
                 a.luts + (long long)ch.pair[j] * sc_all + e, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n * sc_all; i += kThreads) {
      const int j = i / sc_all, e = i - j * sc_all;
      const int s = e / c, k = e - s * c;
      cp_async4(tabs + ((long long)s * a.q + j) * c + k,
                a.luts + (long long)ch.pair[j] * sc_all + e);
    }
  }
  Producer p = {next_run(ch, 0), 0, 0, 0};
  for (int i = 0; i < kStages - 1; ++i) copy_next(a, ch, ring, p);

  // masked tails [tail, l_cap), while the first tiles arrive
  for (int j = 0; j < n; ++j) {
    float* dst = a.out + (long long)ch.pair[j] * a.l_cap;
    int l = ch.tail[j];
    if ((a.l_cap & 3) == 0) {
      const int l4 = min((l + 3) & ~3, a.l_cap);
      if (l + (int)threadIdx.x < l4) dst[l + threadIdx.x] = kMaskedDistance;
      const float4 m = make_float4(kMaskedDistance, kMaskedDistance,
                                   kMaskedDistance, kMaskedDistance);
      for (int i = l4 / 4 + threadIdx.x; i < a.l_cap / 4; i += kThreads)
        reinterpret_cast<float4*>(dst)[i] = m;
    } else {
      for (l += threadIdx.x; l < a.l_cap; l += kThreads)
        dst[l] = kMaskedDistance;
    }
  }

  int item = 0;
  for (int r = next_run(ch, 0); r < ch.runs; r = next_run(ch, r + 1)) {
    switch (ch.run_nq[r]) {
      case 1: score_run<1, CC>(a, ch, tabs, ring, p, item, r, nsc); break;
      case 2: score_run<2, CC>(a, ch, tabs, ring, p, item, r, nsc); break;
      case 3: score_run<3, CC>(a, ch, tabs, ring, p, item, r, nsc); break;
      case 4: score_run<4, CC>(a, ch, tabs, ring, p, item, r, nsc); break;
      case 5: score_run<5, CC>(a, ch, tabs, ring, p, item, r, nsc); break;
      case 6: score_run<6, CC>(a, ch, tabs, ring, p, item, r, nsc); break;
      case 7: score_run<7, CC>(a, ch, tabs, ring, p, item, r, nsc); break;
      default: score_run<8, CC>(a, ch, tabs, ring, p, item, r, nsc); break;
    }
  }
  cp_async_wait<0>();
}

template <int CC>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      ((sizeof(float) * (size_t)a.s_pad * a.q * a.c + 15) & ~size_t(15)) +
      kRingBytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tree_ah_leaf_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.pairs + a.q - 1) / a.q;
  tree_ah_leaf_kernel<CC><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the
// launch (0 on success). `q` pairs a block, 1..8 (ops/tree_ah_leaf.py picks
// it from the shared-memory budget).
extern "C" int tree_ah_leaf_scores(const void* luts, const void* codes,
                                   const void* offsets, const void* sizes,
                                   const void* order, void* out, int pairs,
                                   int s_pad, int num_codes, long long n_csr,
                                   int l_cap, int q, void* stream) {
  if (q < 1 || q > kMaxQ || pairs < 1) return (int)cudaErrorInvalidValue;
  const Args a = {static_cast<const float*>(luts),
                  static_cast<const uint8_t*>(codes),
                  static_cast<const int*>(offsets),
                  static_cast<const int*>(sizes),
                  static_cast<const int*>(order),
                  static_cast<float*>(out),
                  n_csr, pairs, s_pad, num_codes, q, l_cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_codes == 16) return launch<16>(a, st);
  if (num_codes == 256) return launch<256>(a, st);
  return launch<0>(a, st);
}

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
//   - int8 tables (#1b, the TPU kernel's int8 branch): exact sums of the
//     int8 entries, stored as int16 (|sum| <= 128 * S_pad < 32767, which
//     the wrapper checks); masked slots I16_MASK = 32767.
//
// Slots l >= size_g are masked; every row of the output is written, those
// of unused groups (size 0) and unused group slots included.
//
// Layouts (the JAX package's, unchanged):
//   luts    [NG*q_cap, S_pad*C] bf16 or int8; with packed codes the
//           subspace order is even-first (subspaces 0,2,4,..., then 1,3,5,...);
//   codes   packed: [S_pad/2, N_csr] u8, byte j = subspace 2j in the low
//           nibble and 2j+1 in the high nibble; unpacked: [S_pad, N_csr] u8;
//   offsets [NG] i32 first CSR column of each group's partition (any
//           alignment, any N_csr);
//   sizes   [NG] i32 partition size (0 for unused groups);
//   out     [NG*q_cap, l_cap] bf16 or int16.
//
// What bounds it on the H100. PERF.md's bound counts only what the batch
// needs (real pairs' tables at S, probed codes once, real pairs' rows):
// 0.048 ms for #1 on the main cell, 0.061 ms for #1b on the SOAR cell. The
// output contract itself moves more: all NG*q_cap*l_cap slots (84% of them
// masked on the main cell), each group's code columns once and its tables
// once per live column range, about 0.48 and 0.46 GB: a traffic floor of
// 0.14 ms at 3.35 TB/s (chip_smoke.py [7], [23] print it). The work is one
// table lookup and one add per (group slot, valid column, subspace): 1.6e9
// (#1) and 2.8e9 (#1b) entries. At one entry a shared load (32 a clock per
// SM) the lookups alone take 0.19 and 0.34 ms, the floor of a kernel that
// looks each entry up alone; at q_cap entries a load (128 shared bytes a
// clock) 0.10 and 0.08 ms. Beside the lookups the CUDA cores issue the
// adds and the integer work around them: each lookup's address, and for
// bf16 tables the shift and mask that turn two entries into floats, which
// keep #1 issue-bound near twice its traffic floor.
//
// The design:
//   - every pair of a group reads the same code, so the group's tables are
//     staged once per block interleaved by query (Layout below): the q_cap
//     entries of one (subspace, code) are contiguous and one 16-byte shared
//     load returns 8 bf16 or 16 int8 entries (q_cap 32: two or four loads).
//     The tables are read from global memory 16 bytes of 8 queries' rows
//     at once (one round trip a thread) and transposed in registers;
//   - bf16: each query's accumulator adds over ascending byte j, the low
//     nibble then the high one (ascending s unpacked), in float32 from 0.0f
//     -- the order of the PyTorch twin (tree_ah_grouped_scores_reference),
//     additions only, so kernel and twin agree bit for bit. A 32-bit word of
//     two bf16 entries becomes two floats with one shift and one mask;
//   - int8: the entries are staged biased by +128 as u8, four queries to a
//     32-bit word (bytes b0..b3). Per word, one accumulator adds the words
//     whole (mod 2^32) and one adds b1 and b3 as u16 lanes (one byte
//     permute); a code byte's two nibbles' words go in with one
//     three-operand add each. At the end b0's and b2's u16 sums are the
//     whole sum less the odd sums shifted by 8. A lane holds at most 255 *
//     S_pad < 65536, so every u16 sum is exact, and 128 * S_pad comes off:
//     the integer sums are exact in any order. (Masking the even and the
//     odd lanes of every word costs two more integer operations a word
//     and measured about a quarter slower on the SOAR cell, PERF.md; plain
//     int32 sums were not tried: twice the adds and a sign extension per
//     entry);
//   - a block scores one column range of one group: ranges of at least two
//     column tiles, at most four a group (ops/tree_ah_grouped.kernel_plan),
//     so that the largest partition (ten times the mean on the main cell)
//     does not leave a tail; each live range stages the tables once. A
//     range past the group's size writes its masked slots and returns. A
//     group's ranges are neighbours in launch order, so blocks that only
//     write run beside blocks that score;
//   - the range's codes stream through a 2-stage ring of [stage_rows x tile]
//     tiles by 16-byte cp.async copies taken from the 16-byte aligned
//     address below each row's start (any offset, any N_csr). The first
//     copies are in flight while the tables are staged and the masked slots
//     written, the next stage's while one is scored. Where the tables leave
//     no room for two one-row stages (within 1 KB of the block's shared
//     memory) codes are read from global memory directly;
//   - a thread owns `cols` neighbouring columns (4 at q_cap <= 8, 2 at 16, 1
//     at 32: at most 32 accumulators) and reads their codes as one word per
//     byte row (one aligned word, or two and a funnel shift). With packed
//     codes two shift-and-masks of that word give every column's low and
//     high nibble as a byte offset into its subspace's row, and one byte
//     permute per lookup picks a column's; packed codes at C=16 take an
//     instance with C fixed;
//   - masked slots [max(size, range start), range end) are written with
//     16-byte stores, reading neither codes nor tables; scores with 8- or
//     4-byte stores where the row allows.
// The kernel stays on the CUDA cores: a one-hot contraction on the tensor
// cores is not bit-identical in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskedDistance = 1.7e38f;  // types.MASKED_DISTANCE
constexpr short kI16Mask = 32767;           // ops/tree_ah_grouped.I16_MASK
constexpr int kThreads = 128;               // ops/tree_ah_grouped.THREADS
constexpr int kStages = 2;  // code ring stages (ops/tree_ah_grouped.py)

struct Args {
  const void* luts;
  const uint8_t* codes;
  const int* offsets;
  const int* sizes;
  void* out;
  long long n_csr;
  int s_rows;      // code rows: S_pad/2 packed, S_pad unpacked
  int c;           // codes a subspace
  int l_cap;
  int range_cols;  // columns a block, a multiple of the tile
  int ranges;      // blocks a group: ceil(l_cap / range_cols)
  int stage_rows;  // code rows a ring stage
  int ring;        // 1: codes through the ring; 0: read from global
  int tab_bytes;   // the tables' shared bytes, 16-aligned
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// QB bytes of shared memory (QB-aligned) as 32-bit words, low byte first.
template <int QB>
struct Words {
  static constexpr int N = QB < 4 ? 1 : QB / 4;
  uint32_t w[N];
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (QB == 1) {
      w[0] = *p;
    } else if constexpr (QB == 2) {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    } else if constexpr (QB == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (QB == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else {
#pragma unroll
      for (int k = 0; k < QB / 16; ++k) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[k];
        w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z,
        w[4 * k + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* p) const {
    if constexpr (QB == 1) {
      *p = (uint8_t)w[0];
    } else if constexpr (QB == 2) {
      *reinterpret_cast<uint16_t*>(p) = (uint16_t)w[0];
    } else if constexpr (QB == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else if constexpr (QB == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int k = 0; k < QB / 16; ++k)
        reinterpret_cast<uint4*>(p)[k] =
            make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    }
  }
};

// The two branches: table entry and output types, the staged form of an
// entry, the accumulators of one column and how a lookup adds to them.
template <int QCAP, bool INT8>
struct Branch;

template <int QCAP>
struct Branch<QCAP, false> {
  using Lut = __nv_bfloat16;
  using Out = __nv_bfloat16;
  static constexpr int kEntry = 2;
  static constexpr int kAcc = QCAP;  // one float32 per query
  using Acc = float;
  static __device__ __forceinline__ uint32_t stage(Lut v) {
    return __bfloat16_as_ushort(v);
  }
  static __device__ __forceinline__ void add(Acc (&acc)[kAcc],
                                             const Words<QCAP * 2>& e) {
#pragma unroll
    for (int q = 0; q < QCAP; ++q) {
      const uint32_t w = e.w[q / 2];
      acc[q] += __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
  static __device__ __forceinline__ Out result(const Acc (&acc)[kAcc], int q,
                                               int) {
    return __float2bfloat16(acc[q]);
  }
  static __device__ __forceinline__ Out masked() {
    return __float2bfloat16(kMaskedDistance);
  }
};

template <int QCAP>
struct Branch<QCAP, true> {
  using Lut = int8_t;
  using Out = short;
  static constexpr int kEntry = 1;
  // Word k of a lookup holds queries 4k..4k+3 as bytes b0..b3.
  // Accumulator 2k+1 sums b1 and b3 as u16 lanes (a byte permute);
  // accumulator 2k sums the whole words mod 2^32, b0 + b1<<8 + b2<<16 +
  // b3<<24, from which the end takes b1's and b3's sums back out (q_cap
  // 1 has only b0).
  static constexpr int kAcc = QCAP == 1 ? 1 : (QCAP < 4 ? 2 : QCAP / 2);
  using Acc = uint32_t;
  static __device__ __forceinline__ uint32_t stage(Lut v) {
    return (uint8_t)v ^ 0x80u;  // v + 128
  }
  static __device__ __forceinline__ uint32_t odd(uint32_t w) {
    return __byte_perm(w, 0, 0x4341);  // b1 | b3 << 16
  }
  static __device__ __forceinline__ void add(Acc (&acc)[kAcc],
                                             const Words<QCAP>& e) {
#pragma unroll
    for (int k = 0; k < Words<QCAP>::N; ++k) {
      acc[2 * k] += e.w[k];
      if (2 * k + 1 < kAcc) acc[2 * k + 1] += odd(e.w[k]);
    }
  }
  // both nibbles' lookups of one code byte: one three-operand add each
  static __device__ __forceinline__ void add2(Acc (&acc)[kAcc],
                                              const Words<QCAP>& lo,
                                              const Words<QCAP>& hi) {
#pragma unroll
    for (int k = 0; k < Words<QCAP>::N; ++k) {
      acc[2 * k] += lo.w[k] + hi.w[k];
      if (2 * k + 1 < kAcc) acc[2 * k + 1] += odd(lo.w[k]) + odd(hi.w[k]);
    }
  }
  static __device__ __forceinline__ Out result(const Acc (&acc)[kAcc], int q,
                                               int bias) {
    const int k = q / 4;
    uint32_t a;
    if constexpr (kAcc == 1) {
      a = acc[0];
    } else {
      a = (q & 1) ? acc[2 * k + 1] : acc[2 * k] - (acc[2 * k + 1] << 8);
    }
    return (short)((int)(((q & 2) ? a >> 16 : a) & 0xffffu) - bias);
  }
  static __device__ __forceinline__ Out masked() { return kI16Mask; }
};

// Columns a thread: at most 32 accumulators (ops/tree_ah_grouped.py).
template <int QCAP>
__host__ __device__ constexpr int cols_per_thread() {
  return QCAP <= 8 ? 4 : 32 / QCAP;
}

// Writes m to rows [0, QCAP) x columns [from, to) of a group's output:
// 16-byte stores between a 2-byte head and tail in each row.
template <int QCAP, typename Out>
__device__ __forceinline__ void fill_masked(Out* out_g, int l_cap, int from,
                                            int to, Out m) {
  if (from >= to) return;
  uint16_t bits;
  memcpy(&bits, &m, 2);
  const uint32_t m2 = bits | ((uint32_t)bits << 16);
  const uint4 m8 = make_uint4(m2, m2, m2, m2);
  for (int q = 0; q < QCAP; ++q) {
    Out* row = out_g + (long long)q * l_cap;
    const uint32_t mis =
        (uint32_t)reinterpret_cast<uintptr_t>(row + from) & 15u;
    const int head = min((int)((16u - mis) & 15u) / 2, to - from);
    const int v0 = from + head;
    const int nvec = (to - v0) / 8;
    const int t0 = v0 + 8 * nvec;
    if ((int)threadIdx.x < head) row[from + threadIdx.x] = m;
    for (int i = threadIdx.x; i < nvec; i += kThreads)
      reinterpret_cast<uint4*>(row + v0)[i] = m8;
    if (t0 + (int)threadIdx.x < to) row[t0 + threadIdx.x] = m;
  }
}

// The next ring item to copy: column tile and stage of code rows.
struct Producer {
  int tile;
  int stage;
  int item;
};

// Copies the producer's item (if any is left) into its ring slot, commits
// one cp.async group either way, and advances the producer.
template <int TILE>
__device__ __forceinline__ void copy_next(const Args& a, long long col_base,
                                          int live, int nsc, uint8_t* ring,
                                          Producer& p) {
  constexpr int kRowBytes = TILE + 16;
  constexpr int kCopies = kRowBytes / 16;
  if (p.tile * TILE < live) {
    uint8_t* slot = ring + (p.item % kStages) * a.stage_rows * kRowBytes;
    const long long col0 = col_base + (long long)p.tile * TILE;
    const int ncols = min(TILE, live - p.tile * TILE);
    const int s0 = p.stage * a.stage_rows;
    const int rows = min(a.stage_rows, a.s_rows - s0);
    for (int i = threadIdx.x; i < rows * kCopies; i += kThreads) {
      const int j = i / kCopies, k = i - j * kCopies;
      const uintptr_t src = reinterpret_cast<uintptr_t>(
          a.codes + (long long)(s0 + j) * a.n_csr + col0);
      const uintptr_t base = src & ~uintptr_t(15);
      // a 16-byte piece that holds a byte of the row is read whole (it
      // cannot cross a page); pieces past the row are zero-filled
      const bool live16 = 16 * k < (int)(src - base) + ncols;
      cp_async16(slot + j * kRowBytes + 16 * k,
                 reinterpret_cast<const void*>(live16 ? base + 16 * k : base),
                 live16 ? 16 : 0);
    }
    if (++p.stage == nsc) {
      p.stage = 0;
      ++p.tile;
    }
    ++p.item;
  }
  cp_async_commit();
}

// Staged tables: [S_pad][QB/kChunk][C][kChunk] bytes, kChunk = min(QB, 16):
// the QB bytes of one (subspace, code) are QB/kChunk chunks of kChunk
// bytes, C*kChunk apart, each one shared load. (8-byte chunks, on which no
// half warp's loads conflict at C=16, ran slower with bf16 tables in a
// probe: twice the load instructions.)
template <int QB>
struct Layout {
  static constexpr int kChunk = QB < 16 ? QB : 16;
  static constexpr int kQK = QB / kChunk;
  // byte offset of byte `byte` of entry (s, code)
  static __device__ __forceinline__ int at(int s, int code, int byte, int c) {
    return ((s * kQK + byte / kChunk) * c + code) * kChunk + byte % kChunk;
  }
  // log2(kChunk): a code's offset in its subspace's chunk row is code <<
  static constexpr int kShift =
      kChunk == 16 ? 4 : kChunk == 8 ? 3 : kChunk == 4 ? 2 : kChunk == 2;
  // the QB bytes of entry (s, code)
  static __device__ __forceinline__ void load(const uint8_t* tabs, int s,
                                              int code, int c, Words<QB>& e) {
    load(tabs + at(s, code, 0, c), c, e);
  }
  // the QB bytes of the entry whose first chunk is at p
  static __device__ __forceinline__ void load(const uint8_t* p, int c,
                                              Words<QB>& e) {
    if constexpr (kQK == 1) {
      e.load(p);
    } else {
#pragma unroll
      for (int k = 0; k < kQK; ++k) {
        Words<kChunk> v;
        v.load(p + k * c * kChunk);
#pragma unroll
        for (int i = 0; i < Words<kChunk>::N; ++i)
          e.w[k * Words<kChunk>::N + i] = v.w[i];
      }
    }
  }
  // stores the P bytes of w (P a power of two <= 16, P | QB) as byte
  // `byte` on of entry (s, code)
  template <int P>
  static __device__ __forceinline__ void store(uint8_t* tabs, int s, int code,
                                               int byte, int c,
                                               const Words<P>& w) {
    if constexpr (P <= kChunk) {
      w.store(tabs + at(s, code, byte, c));
    } else {
#pragma unroll
      for (int k = 0; k < P / kChunk; ++k) {
        Words<kChunk> v;
#pragma unroll
        for (int i = 0; i < Words<kChunk>::N; ++i)
          v.w[i] = w.w[k * Words<kChunk>::N + i];
        v.store(tabs + at(s, code, byte + k * kChunk, c));
      }
    }
  }
};

// Stages group g's QCAP tables (rows of s_pad*c entries in global memory)
// into shared memory. Where rows are 16-byte aligned, a thread reads 16
// bytes of up to 8 queries' rows at once (one round trip) and writes
// their entries query-interleaved; otherwise one entry at a time.
template <int QCAP, bool INT8>
__device__ __forceinline__ void stage_tables(
    const typename Branch<QCAP, INT8>::Lut* lut_g, int sc, int c,
    uint8_t* tabs) {
  using B = Branch<QCAP, INT8>;
  using L = Layout<QCAP * B::kEntry>;
  constexpr int E = B::kEntry;
  constexpr int G = QCAP < 8 ? QCAP : 8;  // queries a pass
  constexpr int V = 16 / E;               // entries a 16-byte read
  constexpr int kPB = G * E;              // bytes a pass adds to an entry
  const bool vec = (sc % V) == 0 &&
                   (reinterpret_cast<uintptr_t>(lut_g) & 15) == 0;
  if (vec) {
    const int nchunk = sc / V;
    for (int t = threadIdx.x; t < nchunk * (QCAP / G); t += kThreads) {
      const int pass = t / nchunk, e0 = (t - pass * nchunk) * V;
      uint32_t in[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            lut_g + (long long)(pass * G + g) * sc + e0));
        in[g][0] = v.x, in[g][1] = v.y, in[g][2] = v.z, in[g][3] = v.w;
      }
      int s = e0 / c, code = e0 - s * c;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        Words<kPB> w;
#pragma unroll
        for (int k = 0; k < Words<kPB>::N; ++k) w.w[k] = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint32_t raw =
              E == 2 ? (in[g][i / 2] >> (16 * (i & 1))) & 0xffffu
                     : (in[g][i / 4] >> (8 * (i & 3))) & 0xffu;
          const uint32_t bits = INT8 ? raw ^ 0x80u : raw;  // int8: v + 128
          w.w[(g * E) / 4] |= bits << (8 * ((g * E) & 3));
        }
        L::template store<kPB>(tabs, s, code, pass * kPB, c, w);
        if (++code == c) code = 0, ++s;
      }
    }
  } else {
    for (int e = threadIdx.x; e < sc; e += kThreads) {
      Words<QCAP * E> w;
#pragma unroll
      for (int k = 0; k < Words<QCAP * E>::N; ++k) w.w[k] = 0;
#pragma unroll
      for (int q = 0; q < QCAP; ++q)
        w.w[(q * E) / 4] |= B::stage(lut_g[(long long)q * sc + e])
                            << (8 * ((q * E) & 3));
      const int s = e / c;
      L::template store<QCAP * E>(tabs, s, e - s * c, 0, c, w);
    }
  }
}

template <int QCAP, bool PACKED, bool INT8, int CC>
__global__ void __launch_bounds__(kThreads)
tree_ah_grouped_kernel(const Args a) {
  using B = Branch<QCAP, INT8>;
  using Out = typename B::Out;
  using Lut = typename B::Lut;
  constexpr int kQB = QCAP * B::kEntry;  // staged bytes of one (s, code)
  constexpr int kCols = cols_per_thread<QCAP>();
  constexpr int kTile = kCols * kThreads;
  constexpr int kRowBytes = kTile + 16;
  using L = Layout<kQB>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tabs = smem;  // staged entries, see Layout
  uint8_t* ring = smem + a.tab_bytes;

  // a group's ranges are neighbours in launch order, so the blocks that
  // only write masked slots run beside those that score
  const int g = blockIdx.x / a.ranges;
  const int r0 = (blockIdx.x - g * a.ranges) * a.range_cols;
  const int r1 = min(r0 + a.range_cols, a.l_cap);
  const int size = min(max(a.sizes[g], 0), a.l_cap);
  const int live = min(size, r1) - r0;  // columns this block scores
  const int s_pad = PACKED ? 2 * a.s_rows : a.s_rows;
  Out* out_g = static_cast<Out*>(a.out) + (long long)g * QCAP * a.l_cap;

  if (live <= 0) {  // uniform over the block
    fill_masked<QCAP>(out_g, a.l_cap, r0, r1, B::masked());
    return;
  }
  const long long col_base = (long long)a.offsets[g] + r0;
  const int nsc = (a.s_rows + a.stage_rows - 1) / a.stage_rows;
  Producer p = {0, 0, 0};
  if (a.ring) copy_next<kTile>(a, col_base, live, nsc, ring, p);

  // the group's tables, interleaved by query, while the first tiles arrive
  const int c = CC ? CC : a.c;  // codes a subspace, fixed at 16 if CC
  const int sc = s_pad * c;
  stage_tables<QCAP, INT8>(
      static_cast<const Lut*>(a.luts) + (long long)g * QCAP * sc, sc, c,
      tabs);
  fill_masked<QCAP>(out_g, a.l_cap, max(r0, size), r1, B::masked());

  const int tid_c = kCols * threadIdx.x;
  const uint32_t ncsr16 = (uint32_t)a.n_csr & 15u;
  // every row's code word of a thread is one aligned word (4 columns a
  // thread over the searcher's slab)
  const bool aligned4 =
      kCols == 4 && ((reinterpret_cast<uintptr_t>(a.codes) |
                      (uintptr_t)a.n_csr | (uintptr_t)col_base) & 3) == 0;
  const int bias = 128 * s_pad;
  const bool vec_out = (a.l_cap % kCols) == 0;
  for (int tile = 0; tile * kTile < live; ++tile) {
    const int ncols = min(kTile, live - tile * kTile);
    const int v = ncols - tid_c;  // columns of this thread in the range
    const uint32_t keep =
        v >= 4 ? 0xffffffffu : (1u << (8 * max(v, 0))) - 1u;
    const long long col0 = col_base + (long long)tile * kTile;
    // row j of the tile starts `shift` bytes past its ring row
    uint32_t shift =
        ((uint32_t)reinterpret_cast<uintptr_t>(a.codes) + (uint32_t)col0) & 15u;
    typename B::Acc acc[kCols][B::kAcc];
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
#pragma unroll
      for (int k = 0; k < B::kAcc; ++k) acc[cc][k] = 0;
    for (int st = 0; st < nsc; ++st) {
      const uint8_t* slot = ring;
      if (a.ring) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // item ready; every thread done with item-1's slot
        copy_next<kTile>(a, col_base, live, nsc, ring, p);
        slot += (tile * nsc + st) % kStages * a.stage_rows * kRowBytes;
      } else if (tile == 0 && st == 0) {
        __syncthreads();  // the tables
      }
      if (v <= 0) continue;
      const int s0 = st * a.stage_rows;
      const int rows = min(a.stage_rows, a.s_rows - s0);
      for (int j = 0; j < rows; ++j) {
        uint32_t w;
        if (a.ring) {
          const uint32_t pos = shift + tid_c;
          const uint8_t* rp = slot + j * kRowBytes + (pos & ~3u);
          w = *reinterpret_cast<const uint32_t*>(rp);
          if (!aligned4) {
            const uint32_t hi = *reinterpret_cast<const uint32_t*>(rp + 4);
            w = __funnelshift_r(w, hi, (pos & 3u) * 8u);
          }
          shift = (shift + ncsr16) & 15u;
        } else {
          const uint8_t* gp =
              a.codes + (long long)(s0 + j) * a.n_csr + col0 + tid_c;
          w = 0;
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            if (cc < v) w |= (uint32_t)gp[cc] << (8 * cc);
        }
        w &= keep;
        const int s = s0 + j;
        // packed: every column's low and high nibble shifted to its offset
        // in the chunk rows of subspaces s and s_rows + s (one byte each)
        constexpr uint32_t kNib = 0x0f0f0f0fu << L::kShift;
        const uint32_t lo = (w << L::kShift) & kNib;
        const uint32_t hi = (w >> (4 - L::kShift)) & kNib;
        const uint8_t* row_lo = tabs + L::at(s, 0, 0, c);
        const uint8_t* row_hi = tabs + L::at(a.s_rows + s, 0, 0, c);
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const uint32_t byte = (w >> (8 * cc)) & 0xffu;
          Words<kQB> e;
          if constexpr (PACKED) {
            // the nibble's offset in its chunk row: byte cc of lo / hi
            const uint8_t* pl = row_lo + __byte_perm(lo, 0, 0x4440 + cc);
            const uint8_t* ph = row_hi + __byte_perm(hi, 0, 0x4440 + cc);
            if constexpr (INT8) {  // both nibbles at once
              Words<kQB> h;
              L::load(pl, c, e);
              L::load(ph, c, h);
              B::add2(acc[cc], e, h);
            } else {  // the low nibble, then the high one
              L::load(pl, c, e);
              B::add(acc[cc], e);
              L::load(ph, c, e);
              B::add(acc[cc], e);
            }
          } else {
            L::load(tabs, s, byte, c, e);
            B::add(acc[cc], e);
          }
        }
      }
    }
    if (v <= 0) continue;
    const int l0 = r0 + tile * kTile + tid_c;
#pragma unroll
    for (int q = 0; q < QCAP; ++q) {
      Out o[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) o[cc] = B::result(acc[cc], q, bias);
      Out* dst = out_g + (long long)q * a.l_cap + l0;
      if (vec_out && v >= kCols && kCols > 1) {
        if constexpr (kCols == 4) {
          uint2 u;
          memcpy(&u, o, 8);
          *reinterpret_cast<uint2*>(dst) = u;
        } else if constexpr (kCols == 2) {
          uint32_t u;
          memcpy(&u, o, 4);
          *reinterpret_cast<uint32_t*>(dst) = u;
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          if (cc < v) dst[cc] = o[cc];
      }
    }
  }
  cp_async_wait<0>();
}

template <int QCAP, bool PACKED, bool INT8>
int launch(const Args& a, int ng, cudaStream_t stream) {
  // packed codes at C=16 (the searchers' tables) fix C at compile time
  constexpr int kC16 = PACKED ? 16 : 0;
  auto kernel = PACKED && a.c == 16
                    ? tree_ah_grouped_kernel<QCAP, PACKED, INT8, kC16>
                    : tree_ah_grouped_kernel<QCAP, PACKED, INT8, 0>;
  constexpr int kTile = cols_per_thread<QCAP>() * kThreads;
  if (a.range_cols <= 0 || a.range_cols % kTile != 0 || a.stage_rows < 1)
    return (int)cudaErrorInvalidValue;
  // the ring and 16 bytes its last row's word reads may pass
  const size_t smem = (size_t)a.tab_bytes +
      (a.ring ? (size_t)kStages * a.stage_rows * (kTile + 16) + 16 : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)ng * a.ranges;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool PACKED, bool INT8>
int dispatch(int q_cap, const Args& a, int ng, cudaStream_t stream) {
  switch (q_cap) {
    case 1: return launch<1, PACKED, INT8>(a, ng, stream);
    case 2: return launch<2, PACKED, INT8>(a, ng, stream);
    case 4: return launch<4, PACKED, INT8>(a, ng, stream);
    case 8: return launch<8, PACKED, INT8>(a, ng, stream);
    case 16: return launch<16, PACKED, INT8>(a, ng, stream);
    case 32: return launch<32, PACKED, INT8>(a, ng, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the
// launch (0 on success). `int8_luts` selects the int8-table branch (int8
// LUTs, int16 out). range_cols, stage_rows, ring (0: no room for the code
// ring, codes read from global memory) and the tables' shared bytes come
// from ops/tree_ah_grouped.kernel_plan.
extern "C" int tree_ah_grouped_scores(const void* luts, const void* codes,
                                      const void* offsets, const void* sizes,
                                      void* out, int ng, int q_cap, int s_rows,
                                      int num_codes, long long n_csr, int l_cap,
                                      int range_cols, int stage_rows,
                                      int ring, int tab_bytes, int packed,
                                      int int8_luts, void* stream) {
  const Args a = {luts, static_cast<const uint8_t*>(codes),
                  static_cast<const int*>(offsets),
                  static_cast<const int*>(sizes), out, n_csr, s_rows,
                  num_codes, l_cap, range_cols,
                  range_cols > 0 ? (l_cap + range_cols - 1) / range_cols : 0,
                  stage_rows, ring, tab_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    if (int8_luts) return dispatch<true, true>(q_cap, a, ng, s);
    return dispatch<true, false>(q_cap, a, ng, s);
  }
  if (int8_luts) return dispatch<false, true>(q_cap, a, ng, s);
  return dispatch<false, false>(q_cap, a, ng, s);
}

// Block-min sweep for the block-sweep searcher on Hopper (sm_90a).
//
// Replaces four TPU kernels of scann_tpu/ops/sweep_pallas.py with one source:
//   _block_min_kernel                :247  row-major [N/r, B] f32 + i32
//   _block_min_qmajor_kernel         :270  query-major [B, N/r] f32 + i32
//   _block_min_qmajor_compact_kernel :300  query-major bf16 + u8 (r <= 256)
//   _block_min2_kernel               :395  two smallest per block, row-major
// Template instances cover bf16 or int8 rows, top-1 or top-2, and r >= 64
// (the reduction inside a warp fully unrolled) or smaller r; the output
// layout, the compact minima and the penalty are runtime arguments.
//
// What it computes, for rows x_n (bf16, or int8 converted to bf16, exact for
// |v| <= 127) and augmented queries q_b (bf16):
//   s[n, b] = sum_k x_n[k] * q_b[k]   (bf16 products, float32 sums)
//           + pen[n]                   (optional [N/r, r] bf16 penalty)
// then over each contiguous block of r rows, per query:
//   top-1: min and argmin, the lowest offset on ties (jnp.argmin's rule);
//   top-2: (first, second) by the JAX package's tournament: contiguous
//          pairs, then merges of (first, second) runs, level by level. It
//          orders ties its own way: for [1, 1, 5, 1] the second is offset 3.
// Offsets are written relative to the block; compact values are the float32
// minimum rounded to nearest even.
//
// What bounds it on the H100, at the main shapes (N = 1,187,840 rows,
// D1 = 104, B = 1024, r = 64): 2 * 1024 * 104 * 1,187,840 = 2.53e11 FLOP,
// 0.256 ms at the 989 TFLOP/s bf16 tensor-core peak, while the bytes
// (247 MB of rows + 57 MB of compact minima) need 0.091 ms at 3.35 TB/s.
// So the tensor cores bound it; a CUDA-core kernel could not beat ~3.8 ms
// at 67 TFLOP/s float32.
//
// The design: warp-level mma.sync m16n8k16 (bf16 in, float32 accumulate),
// the simple route to the tensor cores, fed by ldmatrix. A CTA owns 128
// queries and walks a run of 128-row tiles; its 8 warps split a tile
// 2 (rows) x 4 (queries), 64 x 32 each. The query tile stays in shared
// memory for the run; row tiles are double-buffered with cp.async, so the
// next tile loads while the current one is multiplied. The grid's fastest
// dimension is the query tile, so the CTAs that read one row run are
// resident together and share it through L2. The depth D1 runs in steps of
// 16, the upper half of a step zeroed in the fragments where D1 ends
// (D1 = 104 is not a multiple of 16). The reduction works on the
// accumulator registers: a thread holds rows 8e + g (e = 0..7, g = lane / 4)
// of two query columns, so rows are reduced in registers and across the 8
// lanes of a column with shuffles. Top-1 finds the block minimum, then the
// lowest row reaching it (the argmin with the lowest offset on ties);
// across warps and tiles it combines (value, row) pairs lexicographically,
// which is the same rule. Top-2 applies the tournament's levels in its
// order, row bit 0 first. Blocks of 8..64 rows end inside a warp: their
// results are staged in shared memory and stored by all threads with
// coalesced writes. Blocks of r > 64 rows span both warp rows (exchanged
// through shared memory) and, past 128, tiles (carried by one thread per
// query). Scores never leave registers. wgmma, TMA and a persistent grid
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 8 warps: 2 along rows x 4 along queries
constexpr int kTileRows = 128;     // rows per tile
constexpr int kTileQ = 128;        // queries per CTA
constexpr int kTilesPerCta = 16;   // tiles one CTA walks (more when r > 2048)
constexpr int kMaxTileLevels = 6;  // tournament levels across tiles: r <= 8192
constexpr int kStageBlocks = kTileRows / 8;  // staged blocks per tile, r >= 8

// A run of rows reduced so far: its first (m1 at row l1) and, for top-2,
// its second (m2 at row l2). Rows are global row indices.
struct Run {
  float m1;
  int l1;
  float m2;
  int l2;
};

struct Out {
  void* v1;        // f32 or bf16 (compact)
  void* l1;        // i32 or u8 (compact)
  float* v2;       // top-2 only
  int* l2;         // top-2 only
  long long nb;    // N / r
  int b;
  int qmajor;
  int compact;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring int8 row elements (k, k+1) as a bf16x2 register, low half k.
__device__ __forceinline__ uint32_t int8_pair(const int8_t* tile, int row,
                                              int k, int d1) {
  const char2 c = *reinterpret_cast<const char2*>(tile + row * d1 + k);
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(c.x),
                                           static_cast<float>(c.y));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void lex_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The tournament's merge of two neighbouring runs, a on the left (lower
// rows): scann_tpu/ops/sweep_pallas.py:430-445, level 1 included (a single
// row is the run {v, row, +inf, -1}).
__device__ __forceinline__ Run merge(const Run& a, const Run& b) {
  const bool ta = a.m1 <= b.m1;
  Run o;
  o.m1 = ta ? a.m1 : b.m1;
  o.l1 = ta ? a.l1 : b.l1;
  const float mo = ta ? b.m1 : a.m1;
  const int lo = ta ? b.l1 : a.l1;
  const bool t2 = a.m2 <= b.m2;
  const float c2 = t2 ? a.m2 : b.m2;
  const int lc2 = t2 ? a.l2 : b.l2;
  const bool to = mo <= c2;
  o.m2 = to ? mo : c2;
  o.l2 = to ? lo : lc2;
  return o;
}

__device__ __forceinline__ Run shfl_run(const Run& s, int mask) {
  Run o;
  o.m1 = __shfl_xor_sync(0xffffffffu, s.m1, mask);
  o.l1 = __shfl_xor_sync(0xffffffffu, s.l1, mask);
  o.m2 = __shfl_xor_sync(0xffffffffu, s.m2, mask);
  o.l2 = __shfl_xor_sync(0xffffffffu, s.l2, mask);
  return o;
}

// One block's result for query q; offsets are relative to the block.
__device__ __forceinline__ void write_result(const Out& o, long long blk, int q,
                                             float m1, int loc1, float m2,
                                             int loc2, bool top2) {
  const long long idx = o.qmajor ? static_cast<long long>(q) * o.nb + blk
                                 : blk * o.b + q;
  if (o.compact) {
    static_cast<__nv_bfloat16*>(o.v1)[idx] = __float2bfloat16_rn(m1);
    static_cast<uint8_t*>(o.l1)[idx] = static_cast<uint8_t>(loc1);
    return;
  }
  static_cast<float*>(o.v1)[idx] = m1;
  static_cast<int*>(o.l1)[idx] = loc1;
  if (top2) {
    o.v2[idx] = m2;
    o.l2[idx] = loc2;
  }
}

template <bool INT8, bool TOP2, bool BIG>
__global__ void __launch_bounds__(kThreads, 2)
block_min_kernel(const unsigned char* __restrict__ db,
                 const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ pen, Out out, int n,
                 int b, int d1, int r, int tiles_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kElem = INT8 ? 1 : 2;
  const int q_bytes = (kTileQ * d1 * 2 + 15) & ~15;
  const int tile_bytes = kTileRows * d1 * kElem;  // a multiple of 16
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* db_s = smem + q_bytes;
  Run* xw = reinterpret_cast<Run*>(db_s + 2 * tile_bytes);  // [2][kTileQ]
  float* st_v1 = reinterpret_cast<float*>(xw + 2 * kTileQ);  // [16][kTileQ]
  int* st_l1 = reinterpret_cast<int*>(st_v1 + kStageBlocks * kTileQ);
  float* st_v2 = reinterpret_cast<float*>(st_l1 + kStageBlocks * kTileQ);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warps split a tile 4 (queries, wq) x 2 (rows, wr); queries are the mma's
  // M side and rows its N side, so each thread holds rows of whole queries
  const int wq = warp & 3, wr = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kTileQ;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  const long long t_first = static_cast<long long>(blockIdx.y) * tiles_per_cta;
  const int my_tiles = static_cast<int>(
      min(static_cast<long long>(tiles_per_cta), n_tiles - t_first));
  const int r_log2 = __ffs(r) - 1;
  const int tiles_in_block = r > kTileRows ? r / kTileRows : 1;
  const float kInf = __int_as_float(0x7f800000);

  // The query tile; rows past b are zero and their columns never written.
  {
    const int words = d1 / 2;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
    uint32_t* qs = reinterpret_cast<uint32_t*>(q_s);
    for (int i = tid; i < kTileQ * words; i += kThreads) {
      const int rq = i / words;
      qs[i] = q0 + rq < b
                  ? qw[static_cast<long long>(q0 + rq) * words + (i - rq * words)]
                  : 0u;
    }
  }
  const long long db_bytes = static_cast<long long>(n) * d1 * kElem;
  auto load_tile = [&](int t, int buf) {
    const long long start = (t_first + t) * tile_bytes;
    unsigned char* dst = db_s + buf * tile_bytes;
    for (int i = tid * 16; i < tile_bytes; i += kThreads * 16) {
      const long long left = db_bytes - (start + i);
      const int nbytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
      cp_async16(dst + i, nbytes > 0 ? db + start + i : db, nbytes);
    }
    cp_async_commit();
  };

  Run carry = {kInf, 0, kInf, -1};  // top-1, r > 128: the block so far
  Run slots[kMaxTileLevels];        // top-2, r > 128: pending subtrees

  // ldmatrix lane addressing. A (queries): rows (lane & 15) at
  // k + 8 * (lane >> 4). B (rows), two n-tiles per x4: rows
  // (lane & 7) + 8 * (lane >> 4) at k + 8 * ((lane >> 3) & 1).
  const int qa_row = wq * 32 + (lane & 15), qa_k = (lane >> 4) * 8;
  const int xb_row = wr * 64 + (lane & 7) + ((lane >> 4) << 3);
  const int xb_k = ((lane >> 3) & 1) * 8;

  load_tile(0, 0);
  for (int t = 0; t < my_tiles; ++t) {
    if (t + 1 < my_tiles) {
      load_tile(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* tile = db_s + (t & 1) * tile_bytes;
    const int row0 = static_cast<int>((t_first + t) * kTileRows);

    float acc[2][8][4];  // [query m-tile][row n-tile][fragment]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;

    for (int k0 = 0; k0 < d1; k0 += 16) {
      const bool hi = k0 + 8 < d1;  // D1 % 8 == 0: a step is full or half
      // past D1 the upper matrices read the next row (inside the
      // allocation) and are zeroed
      uint32_t aq[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_x4(aq[mt], q_s + (qa_row + mt * 16) * d1 + k0 + qa_k);
        if (!hi) aq[mt][2] = aq[mt][3] = 0u;
      }
      uint32_t bx[8][2];
      if (INT8) {
        const int8_t* t8 = reinterpret_cast<const int8_t*>(tile);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int row = wr * 64 + nt * 8 + g;
          bx[nt][0] = int8_pair(t8, row, k0 + 2 * tig, d1);
          bx[nt][1] = hi ? int8_pair(t8, row, k0 + 8 + 2 * tig, d1) : 0u;
        }
      } else {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t t4[4];
          ldsm_x4(t4, tile + 2 * ((xb_row + np * 16) * d1 + k0 + xb_k));
          bx[2 * np][0] = t4[0];
          bx[2 * np][1] = hi ? t4[1] : 0u;
          bx[2 * np + 1][0] = t4[2];
          bx[2 * np + 1][1] = hi ? t4[3] : 0u;
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_bf16(acc[mt][nt], aq[mt], bx[nt][0], bx[nt][1]);
    }

    // acc[mt][nt][2h + j]: query wq*32 + 16mt + 8h + g, row rho = 8nt + 2tig
    // + j of the warp's 64 rows. Row bit 0 is j, bits 1-2 are lane bits 0-1
    // (tig), bits 3-5 are the bits of nt. p = 2nt + j indexes a thread's 16.
    const int wrow0 = row0 + wr * 64;
    // the block size inside the warp's 64 rows: a constant for r >= 64, so
    // the unrolled levels and the representative tests fold away
    const int rw = BIG ? 64 : r;
    float pe[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int row = wrow0 + 8 * (p >> 1) + 2 * tig + (p & 1);
      pe[p] = (pen != nullptr && row < n) ? __bfloat162float(pen[row]) : 0.0f;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = wq * 32 + mt * 16 + 8 * h + g;
        // res[p]: the result of the block whose first row is the thread's
        // p-th, where that p represents its block (see rep below)
        Run res[16];
        if (TOP2) {
          // tournament levels in row-bit order: j, then the lanes, then nt
          Run s[8];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int row = wrow0 + 8 * nt + 2 * tig;
            s[nt] = merge(Run{acc[mt][nt][2 * h] + pe[2 * nt], row, kInf, -1},
                          Run{acc[mt][nt][2 * h + 1] + pe[2 * nt + 1], row + 1,
                              kInf, -1});
          }
#pragma unroll
          for (int lv = 0; lv < 2; ++lv) {
            if (rw >= (4 << lv)) {
              const int mask = 1 << lv;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                const Run o = shfl_run(s[nt], mask);
                s[nt] = (lane & mask) ? merge(o, s[nt]) : merge(s[nt], o);
              }
            }
          }
#pragma unroll
          for (int sh = 1; sh < 8; sh <<= 1)
            if (rw >= 16 * sh)
#pragma unroll
              for (int nt = 0; nt < 8; nt += 2 * sh) s[nt] = merge(s[nt], s[nt + sh]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) res[2 * nt] = s[nt];
        } else {
          // order-free: the block minimum (in registers, then across the
          // lanes where a block's partial sits), spread back to every p of
          // the block, then the lowest row that reaches it
          float v[16], m[16];
          int ix[16];
#pragma unroll
          for (int p = 0; p < 16; ++p)
            m[p] = v[p] = acc[mt][p >> 1][2 * h + (p & 1)] + pe[p];
          if (rw >= 2)
#pragma unroll
            for (int p = 0; p < 16; p += 2) m[p] = fminf(m[p], m[p + 1]);
#pragma unroll
          for (int sh = 2; sh < 16; sh <<= 1)
            if (rw >= 8 * sh)
#pragma unroll
              for (int p = 0; p < 16; p += 2 * sh) m[p] = fminf(m[p], m[p + sh]);
#pragma unroll
          for (int lv = 0; lv < 2; ++lv)
            if (rw >= (4 << lv))
#pragma unroll
              for (int p = 0; p < 16; ++p)
                if (((8 * (p >> 1) + (p & 1)) & (rw - 1)) == 0)
                  m[p] = fminf(m[p], __shfl_xor_sync(0xffffffffu, m[p], 1 << lv));
#pragma unroll
          for (int sh = 8; sh >= 2; sh >>= 1)
            if (rw >= 8 * sh)
#pragma unroll
              for (int p = 0; p < 16; p += 2 * sh) m[p + sh] = m[p];
          if (rw >= 2)
#pragma unroll
            for (int p = 0; p < 16; p += 2) m[p + 1] = m[p];
#pragma unroll
          for (int p = 0; p < 16; ++p)
            ix[p] = v[p] == m[p] ? wrow0 + 8 * (p >> 1) + 2 * tig + (p & 1)
                                 : INT_MAX;
          if (rw >= 2)
#pragma unroll
            for (int p = 0; p < 16; p += 2) ix[p] = min(ix[p], ix[p + 1]);
#pragma unroll
          for (int sh = 2; sh < 16; sh <<= 1)
            if (rw >= 8 * sh)
#pragma unroll
              for (int p = 0; p < 16; p += 2 * sh) ix[p] = min(ix[p], ix[p + sh]);
#pragma unroll
          for (int lv = 0; lv < 2; ++lv)
            if (rw >= (4 << lv))
#pragma unroll
              for (int p = 0; p < 16; ++p)
                if (((8 * (p >> 1) + (p & 1)) & (rw - 1)) == 0)
                  ix[p] = min(ix[p], __shfl_xor_sync(0xffffffffu, ix[p], 1 << lv));
#pragma unroll
          for (int p = 0; p < 16; ++p) res[p] = Run{m[p], ix[p], kInf, -1};
        }
        // p represents its block when its row bits below the block size
        // are 0;
        // the lane whose own row starts the block holds the result
        if (r > 64) {
          if (tig == 0) xw[wr * kTileQ + col] = res[0];
        } else {
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            const int rho = 8 * (p >> 1) + 2 * tig + (p & 1);
            if ((TOP2 && (p & 1)) || (rho & (rw - 1)) != 0) continue;
            if (rw >= 8) {
              // stage: stored below by all threads, coalesced
              const int bl = (wr * 64 + rho) >> r_log2;
              st_v1[bl * kTileQ + col] = res[p].m1;
              // offsets are < 64 here: top-2 packs both in one word
              st_l1[bl * kTileQ + col] =
                  (res[p].l1 - wrow0 - rho) |
                  (TOP2 ? (res[p].l2 - wrow0 - rho) << 16 : 0);
              if (TOP2) st_v2[bl * kTileQ + col] = res[p].m2;
            } else if (wrow0 + rho < n && q0 + col < b) {
              write_result(out, (wrow0 + rho) >> r_log2, q0 + col, res[p].m1,
                           res[p].l1 - wrow0 - rho, res[p].m2,
                           res[p].l2 - wrow0 - rho, TOP2);
            }
          }
        }
      }
    }
    if (r >= 8 && r <= 64) {
      // coalesced stores of the tile's staged results: along the queries
      // (row-major) or along the blocks (q-major)
      __syncthreads();
      const int nbt = kTileRows >> r_log2;
      const long long blk0 = row0 >> r_log2;
      const long long nb_left = out.nb - blk0;
      for (int i = tid; i < nbt * kTileQ; i += kThreads) {
        const int bl = out.qmajor ? i % nbt : i / kTileQ;
        const int c = out.qmajor ? i / nbt : i % kTileQ;
        if (bl < nb_left && q0 + c < b) {
          const int s_i = bl * kTileQ + c;
          const int locs = st_l1[s_i];
          write_result(out, blk0 + bl, q0 + c, st_v1[s_i],
                       TOP2 ? locs & 0xFFFF : locs, TOP2 ? st_v2[s_i] : 0.0f,
                       locs >> 16, TOP2);
        }
      }
    } else if (r > 64) {
      __syncthreads();
      if (tid < kTileQ) {
        // one thread per query column: the two warp rows, then the tiles
        Run R = xw[tid];
        const Run lower = xw[kTileQ + tid];
        if (TOP2) {
          R = merge(R, lower);
        } else {
          lex_min(R.m1, R.l1, lower.m1, lower.l1);
        }
        const int tib = (row0 >> 7) & (tiles_in_block - 1);
        if (TOP2) {
          int lvl = 0;
          for (; (tib >> lvl) & 1; ++lvl) R = merge(slots[lvl], R);
          if (tib != tiles_in_block - 1) slots[lvl] = R;
        } else {
          if (tib == 0) {
            carry = R;
          } else {
            lex_min(carry.m1, carry.l1, R.m1, R.l1);
          }
          R = carry;
        }
        const int qg = q0 + tid;
        if (tib == tiles_in_block - 1 && qg < b) {
          const int base = (row0 >> r_log2) << r_log2;
          write_result(out, row0 >> r_log2, qg, R.m1, R.l1 - base, R.m2,
                       R.l2 - base, TOP2);
        }
      }
    }
    __syncthreads();  // the tile buffer, xw and the stage are reused
  }
}

size_t smem_bytes(int d1, bool int8_rows, bool top2) {
  return ((kTileQ * d1 * 2 + 15) & ~15) +
         2 * static_cast<size_t>(kTileRows) * d1 * (int8_rows ? 1 : 2) +
         2 * kTileQ * sizeof(Run) + kStageBlocks * kTileQ * (top2 ? 12 : 8);
}

template <bool INT8, bool TOP2, bool BIG>
int launch(const void* db, const void* q, const void* pen, const Out& out,
           int n, int b, int d1, int r, cudaStream_t stream) {
  auto kernel = block_min_kernel<INT8, TOP2, BIG>;
  const size_t smem = smem_bytes(d1, INT8, TOP2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  long long tiles_per_cta = r / kTileRows > kTilesPerCta ? r / kTileRows
                                                         : kTilesPerCta;
  while ((n_tiles + tiles_per_cta - 1) / tiles_per_cta > 65535) tiles_per_cta *= 2;
  const dim3 grid(static_cast<unsigned>((b + kTileQ - 1) / kTileQ),
                  static_cast<unsigned>((n_tiles + tiles_per_cta - 1) / tiles_per_cta));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(db), static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pen), out, n, b, d1, r,
      static_cast<int>(tiles_per_cta));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. db [n, d1] bf16 (or int8 with int8_rows),
// q [b, d1] bf16, pen [n] bf16 or null; outputs as allocated by the caller:
// v1/l1 [N/r, B] (or [B, N/r] with qmajor) f32/i32 (bf16/u8 with compact),
// v2/l2 the seconds for top2 (row-major, f32/i32). r is a power of two,
// n % r == 0, d1 % 8 == 0. Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int block_min_sweep(const void* db, const void* q, const void* pen,
                               void* v1, void* l1, void* v2, void* l2,
                               long long n, int b, int d1, int r, int int8_rows,
                               int top2, int qmajor, int compact, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (n >= (1LL << 31) || d1 <= 0 || d1 % 8 != 0 ||
      r <= 0 || (r & (r - 1)) || r > kTileRows << kMaxTileLevels ||
      n % r != 0 || (top2 && (qmajor || compact || r < 2)) ||
      (compact && r > 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const Out out{v1, l1, static_cast<float*>(v2), static_cast<int*>(l2), n / r,
                b, qmajor, compact};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n);
  const bool big = r >= 64;
#define BLOCK_MIN_CASE(I8, T2, BG)                                   \
  if (!!int8_rows == I8 && !!top2 == T2 && big == BG)                \
    return launch<I8, T2, BG>(db, q, pen, out, ni, b, d1, r, s);
  BLOCK_MIN_CASE(false, false, true)
  BLOCK_MIN_CASE(false, false, false)
  BLOCK_MIN_CASE(false, true, true)
  BLOCK_MIN_CASE(false, true, false)
  BLOCK_MIN_CASE(true, false, true)
  BLOCK_MIN_CASE(true, false, false)
  BLOCK_MIN_CASE(true, true, true)
  BLOCK_MIN_CASE(true, true, false)
#undef BLOCK_MIN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

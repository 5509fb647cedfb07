// Block-min sweeps on Hopper (sm_90a) for bf16 rows: the block-sweep
// searcher's compact q-major kernel (#5), its row-major top-1 (#3), its
// top-2 tournament (#6) and its float32 q-major top-1 (#4), one kernel with
// the epilogue as a template parameter.
//
// Replaces the TPU kernels of scann_tpu/ops/sweep_pallas.py
//   _block_min_qmajor_compact_kernel (:300; pallas_call :378),
//   _block_min_kernel (:247; :475), _block_min2_kernel (:395; :516) and
//   _block_min_qmajor_kernel (:270; :378)
// for bf16 rows, blocks of 8 <= r <= 256 rows (512 for #4) and row widths
// D1 <= 256. The calls it does not take (int8 rows, r < 8, r past those,
// wider rows) stay with the mma.sync kernel of csrc/block_min_sweep.cu;
// ops/sweep.sweep_plan decides from the arguments alone, before any
// launch.
//
// What it computes, for rows x_n (bf16 [N, D1]) and augmented queries q_b
// (bf16 [B, D1]):
//   s[n, b] = sum_k x_n[k] * q_b[k]   (bf16 products, float32 sums)
//           + pen[n]                   (optional [N/r, r] bf16 penalty)
// then, per query and per block of r consecutive rows:
//  - kCompact (#5): the minimum rounded once to bf16 (nearest even) and the
//    u8 offset of the lowest row reaching the float32 minimum (jnp.argmin's
//    rule), q-major: [B, N/r];
//  - kRowMajor (#3): the same minimum in float32, unrounded, and its int32
//    offset, row-major: [N/r, B];
//  - kTop2 (#6): the first and second of the JAX package's tournament
//    (float32 values, int32 offsets), row-major: four [N/r, B] arrays;
//  - kQMajor (#4): kRowMajor's minimum and offset, q-major: [B, N/r].
//
// #4 on the block-sweep searcher (B = 128, r = 512 over 1,245,184 rows)
// is bound by its bytes: 259 MB of rows, 0.078 ms at 3.35 TB/s, against
// 1.36e10 bf16 FLOP (0.014 ms); the grid shares 2432 blocks of four tiles
// among 132 SMs, so the plan takes runs of 19 blocks (76 tiles, 128 units:
// the busiest CTA walks 76 tiles where 73.7 is an even share).
//
// What bounds it on the H100, at the main shapes (N = 1,187,840 rows,
// D1 = 104, B = 1024, r = 64): 2 * 1024 * 104 * 1,187,840 = 2.53e11 bf16
// FLOP, 0.2558 ms at 989 TFLOP/s, against 247 MB of rows + 57 MB of minima,
// 0.091 ms at 3.35 TB/s: the operations bound it. The kernel multiplies
// D1 rounded up to 128 (whole boxes), 0.315 ms of tensor time.
//
// What held the mma.sync form back (block_min_sweep.cu, 1.63 ms at these
// shapes on an H100 at 700 W): warp-level m16n8k16 products fed by ldmatrix,
// the resident query tile re-read at every k-step; the block minimum in
// series with the products on the same warps; a 2-stage cp.async ring that
// every thread issues, with a __syncthreads a tile; a grid of 4,640 CTAs,
// each reloading its query tile and filling and draining its pipeline.
//
// The design (each choice measured on an H100 80GB HBM3 at 700 W with
// throwaway variants of this file; chip_smoke.py [11] times the result):
//  - Queries on M as the A operand, in registers. A CTA holds a tile of 128
//    queries: two consumer warpgroups of 64 each, which load their A
//    fragments once a work unit straight from the [B, D1] queries (the
//    layout ops/sweep.block_min_compact_query_image models; 4 registers a
//    k16 step),
//    and issue wgmma.m64n128k16.f32.bf16.bf16 with A from registers.
//  - Rows on N as the B operand, by TMA: 2-D boxes of 128 rows x 64
//    columns (128 bytes) in the 128-byte swizzle, read through a swizzled
//    K-major descriptor (1024 bytes between 8-row atoms, a k16 step 32
//    bytes into the row). TMA fills zeros past D1 and past N, so a tile
//    takes 4 k-steps a box with no branch between its wgmmas (a branch made
//    ptxas fence each one). A first form with 16-byte-wide boxes of a 3-D
//    view and no swizzle was bound by the boxes' loads.
//  - Clusters of two CTAs, on two query tiles, share each row tile: each
//    CTA loads half the rows of every box and multicasts them into both,
//    so a row tile leaves L2 once for 256 queries. A stage is free once
//    every consumer warp of both CTAs has arrived on both CTAs' empty
//    barrier (with a cluster-scope release on that arrive the kernel ran
//    far slower; clusters of four fit 120 SMs and ran slower). One
//    producer warp keeps a ring of up to eight stages full.
//  - The top-1 block minimum in registers. In the m64n128 accumulator a
//    thread holds queries g and g + 8 of its warp's 16 and rows
//    8j + 2t + {0, 1}, j = 0..15: a block of r >= 8 rows is r / 4 values a
//    query in the thread's own registers, reduced as a tree of minima,
//    whose lowest index is then found from the root down (lowest_argmin),
//    then two shuffle levels across t that exchange halves, so each
//    shuffle carries a (value, row) pair of two blocks or queries and each
//    lane ends with one finished result. A lexicographic minimum may be
//    taken in any order, so the thread reduces its own rows first.
//  - The top-2 tournament cannot: it merges contiguous runs level by level
//    in row-bit order, the lower run first, and its second breaks ties by
//    the level at which the candidates met (for [1, 1, 5, 1] the second is
//    offset 3, not 1), so the merges must follow the row bits. In natural
//    order row bit 0 lies inside a thread, bits 1 and 2 across the lanes
//    t, bits 3 and up inside the thread again: a first form merged them in
//    that order, 72 dependent shuffles a tile, and took about half the
//    old kernel's time, held by the shuffles' latency. This form reads
//    each tile of rows through a 5-D TMA view {col, e, t, j, tile} with
//    row strides {1, 32, 2, 128}, which puts tile row 32t + 2j + e at
//    accumulator column 8j + 2t + e: each thread then holds 32
//    consecutive rows of its two queries, merges row bits 0 to 4 in its
//    own registers (a binary counter over j keeps at most four pending
//    runs), bit 5 by one shuffle exchange that keeps one query a lane and
//    bit 6 (r >= 128) by a last shuffle: about a third of the old
//    kernel's time (chip_smoke.py [11]). The view needs whole 128-row
//    tiles (the wrapper pads a copy otherwise). A run is (first, second)
//    values and their rows; a shuffle carries both rows in one register.
//  - A block of 256 rows spans two tiles, one of 512 (the q-major form)
//    four: the top-1 forms carry the block's running (value, row) in
//    registers from tile to tile, the earlier tile's on a tie, and write
//    it at the block's last tile; the tournament merges the first tile's
//    run with the second's as the lower run. A run holds whole blocks.
//  - A persistent grid of clusters walks work units of two query tiles x
//    one run of consecutive row tiles, ordered by run, so the clusters
//    that read a run read it at about the same time. The compact form
//    stages its run's bf16 minima and u8 offsets in shared memory (64
//    blocks a query where the run allows) and writes them in 16-byte
//    pieces along each query's output row. The row-major forms store from
//    registers: at each store the lanes of a warp hold 16 consecutive
//    queries of one or two blocks, so each store instruction writes 64
//    contiguous bytes a block, whole 32-byte sectors, and needs no staging.
//    The float32 q-major form stores from registers too, 4 bytes a query a
//    block: its output is small beside the rows (2.5 MB against 259 MB at
//    r = 512) and a query's neighbouring blocks meet in L2; with nothing
//    staged its run length is free, and the plan picks the one that
//    balances the grid.
//  - Not kept: a second accumulator a warpgroup (its next tile's product
//    in flight while it reduces the last), with 384 threads and
//    setmaxnreg or with 64-row tiles; ptxas serialized the wgmmas (C7514,
//    C7518) and both ran slower. Four consumer warpgroups of 64-row tiles
//    (256 queries a CTA) and ping-pong turns between the two warpgroups
//    ran no faster. The product and the block minimum still run mostly in
//    series: each alone takes about half the kernel's time.
//
// Launch plan (stages, run length, cluster) from ops/sweep.sweep_plan;
// shared memory layout as sweep_layout below computes it, on host and
// device.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRows = 128;                 // rows per tile (the wgmma N)
constexpr int kQ = 128;                    // queries per tile, 64 a warpgroup
constexpr int kBoxCols = 64;               // bf16 columns of a TMA box
constexpr int kBox = kRows * 128;          // one box: 128 rows x 128 bytes
constexpr int kMaxStages = 8;
constexpr int kMaxBoxes = 4;               // D1 <= 256
constexpr int kMaxCluster = 2;             // CTAs sharing each row tile
constexpr int kMaxSmem = 232448;           // shared memory a block may use
constexpr int kConsumerBar = 1;            // named barrier of the consumers
// the epilogues (ops/sweep.SWEEP_FORMS numbers them the same way)
constexpr int kCompact = 0, kRowMajor = 1, kTop2 = 2, kQMajor = 3;
constexpr int kMaxTilesABlock = 4;  // r <= 512 (the q-major form; else 256)

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive on the barrier at the same offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank) : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a TMA box written into the same offset of every CTA in `mask`, each
// CTA's barrier at `bar`'s offset counting its bytes
__device__ __forceinline__ void tma_load_2d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask) : "memory");
}

// a 5-D box (the top-2 form's permuted view of the rows), into this CTA
// or into every CTA in `mask`
__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c3,
                                            int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, 0, 0, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c3),
      "r"(c4) : "memory");
}

__device__ __forceinline__ void tma_load_5d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c3,
    int c4, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%3, 0, 0, %4, %5}], [%2], %6;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c3), "r"(c4), "h"(mask) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBar), "n"(kConsumers)
               : "memory");
}

// Shared-memory descriptor of a K-major operand in the 128-byte swizzle
// that TMA writes (SWIZZLE_128B): atoms of 8 rows x 128 bytes, the 16-byte
// chunk index of row n XORed with n % 8, 1024 bytes between atoms (sbo);
// the leading offset is unused. A k16 step inside a 128-byte row starts 32
// bytes further; the atoms sit on 1024-byte boundaries.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

// Shared memory of one CTA, from its 1024-byte aligned base: the ring's
// stages of ceil(d1 / 64) boxes, then (compact form only) the run's staged
// minima ([kQ][stride_v] bf16) and offsets ([kQ][stride_l] u8), then the
// full and empty barriers. `total` adds the alignment slack.
// ops/sweep.sweep_smem_bytes computes the same.
struct Layout {
  int boxes, stage_bytes, blocks, stride_v, stride_l, staging_v, staging_l,
      bars, total;
};

__host__ __device__ inline Layout sweep_layout(int d1, int r, int stages,
                                               int run_tiles, bool staged) {
  Layout l;
  l.boxes = (d1 + kBoxCols - 1) / kBoxCols;
  l.stage_bytes = l.boxes * kBox;
  l.blocks = run_tiles * kRows / r;
  l.stride_v = staged ? ((2 * l.blocks + 15) & ~15) + 16 : 0;
  l.stride_l = staged ? ((l.blocks + 15) & ~15) + 16 : 0;
  l.staging_v = stages * l.stage_bytes;
  l.staging_l = l.staging_v + kQ * l.stride_v;
  l.bars = l.staging_l + kQ * l.stride_l;
  l.total = 1024 + l.bars + 16 * stages;
  return l;
}

// (value, row) of `o` replaces `m` if it is lower, or equal at a lower row
__device__ __forceinline__ void lex_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The minimum of M values t[M..2M-1] (M a power of two) and the lowest
// index that reaches it. The values are reduced as a heap-ordered tree of
// minima (t[i] = min(t[2i], t[2i + 1]), one instruction a node); the index
// is then found from the root down, taking the left child wherever it
// reaches the minimum: 2 log2 M compares and a few selects in place of the
// two selects a node that carrying the index through the tree costs.
template <int M>
__device__ __forceinline__ int lowest_argmin(float (&t)[2 * M], float& m) {
  constexpr int kLog = M >= 32 ? 5 : M >= 16 ? 4 : M >= 8 ? 3 : M >= 4 ? 2 : 1;
#pragma unroll
  for (int i = M - 1; i >= 1; --i) t[i] = fminf(t[2 * i], t[2 * i + 1]);
  m = t[1];
  int idx = 0;  // the path from the root, one bit a level, top first
#pragma unroll
  for (int d = 0; d < kLog; ++d) {
    // the left children of the 2^d nodes at depth d, narrowed to the
    // path's node by the path's bits, deepest first
    float c[M / 2];
#pragma unroll
    for (int k = 0; k < M / 2; ++k)
      if (k < (1 << d)) c[k] = t[2 * ((1 << d) + k)];
#pragma unroll
    for (int e = kLog - 1; e >= 0; --e)
      if (e < d) {
        const bool bit = (idx >> (d - 1 - e)) & 1;
#pragma unroll
        for (int k = 0; k < M / 4 + 1; ++k)
          if (k < (1 << e)) c[k] = bit ? c[2 * k + 1] : c[2 * k];
      }
    idx = 2 * idx + (c[0] != m);
  }
  return idx;
}

// One level of the exchange across the 4 lanes of a quad (lane bit `bit`,
// xor mask `mask`): of the items (2p, 2p + 1) a lane keeps 2p + bit and
// sends the other, so n items become n / 2, each reduced over both lanes.
template <int N>
__device__ __forceinline__ void exchange(float (&v)[4], int (&ix)[4], int bit,
                                         int mask) {
#pragma unroll
  for (int p = 0; p < N / 2; ++p) {
    const float sv = bit ? v[2 * p] : v[2 * p + 1];
    const int si = bit ? ix[2 * p] : ix[2 * p + 1];
    float kv = bit ? v[2 * p + 1] : v[2 * p];
    int ki = bit ? ix[2 * p + 1] : ix[2 * p];
    lex_min(kv, ki, __shfl_xor_sync(0xffffffffu, sv, mask),
            __shfl_xor_sync(0xffffffffu, si, mask));
    v[p] = kv;
    ix[p] = ki;
  }
}

// A run of the tournament: its first and second values and their rows in
// the tile (the block's offsets where r <= 128)
struct Run {
  float m1, m2;
  int l1, l2;
};

// the JAX package's merge of two adjacent runs, `a` the lower: the first
// is the smaller first (a's on a tie); the second the smaller of the
// losing first and the smaller second, the losing first on a tie
__device__ __forceinline__ Run merge_runs(const Run& a, const Run& b) {
  const bool ta = a.m1 <= b.m1;
  const float mo = ta ? b.m1 : a.m1;
  const int lo = ta ? b.l1 : a.l1;
  const bool t2 = a.m2 <= b.m2;
  const float c2 = t2 ? a.m2 : b.m2;
  const int lc2 = t2 ? a.l2 : b.l2;
  const bool to = mo <= c2;
  Run o;
  o.m1 = ta ? a.m1 : b.m1;
  o.l1 = ta ? a.l1 : b.l1;
  o.m2 = to ? mo : c2;
  o.l2 = to ? lo : lc2;
  return o;
}

// rows `row` (value a) and `row + 1` (value b): the tournament's first level
__device__ __forceinline__ Run pair_run(float a, float b, int row) {
  const bool ta = a <= b;
  Run o;
  o.m1 = ta ? a : b;
  o.m2 = ta ? b : a;
  o.l1 = row + (ta ? 0 : 1);
  o.l2 = row + (ta ? 1 : 0);
  return o;
}

// `c` ? x : y field by field (a select of whole runs would make ptxas
// keep both in local memory and pick one by address)
__device__ __forceinline__ Run select_run(bool c, const Run& x,
                                          const Run& y) {
  Run o;
  o.m1 = c ? x.m1 : y.m1;
  o.m2 = c ? x.m2 : y.m2;
  o.l1 = c ? x.l1 : y.l1;
  o.l2 = c ? x.l2 : y.l2;
  return o;
}

__device__ __forceinline__ Run shfl_run(const Run& x, int mask) {
  Run o;
  o.m1 = __shfl_xor_sync(0xffffffffu, x.m1, mask);
  o.m2 = __shfl_xor_sync(0xffffffffu, x.m2, mask);
  const int p = __shfl_xor_sync(0xffffffffu, x.l1 | (x.l2 << 16), mask);
  o.l1 = p & 0xFFFF;
  o.l2 = p >> 16;
  return o;
}

// One tournament level across lanes t and t ^ mask (`bit` = this lane's
// bit of `mask`, the row bit the level merges): of the items (i0, i1) a
// lane keeps i<bit> and sends the other, then merges its own kept run
// with the partner's copy of it, the run of the lane whose bit is 0 first
__device__ __forceinline__ Run exchange_runs(const Run& i0, const Run& i1,
                                             int bit, int mask) {
  const Run keep = select_run(bit, i1, i0);
  const Run recv = shfl_run(select_run(bit, i0, i1), mask);
  return merge_runs(select_run(bit, recv, keep), select_run(bit, keep, recv));
}

// KS: k16 steps of a tile, 4 a box (the A fragments are zero past d1, the
// boxes zero past d1, so the product needs no branch between its steps);
// RT: rows of a block within one tile (min(r, 128); r = 256 and 512 carry
// across two and four tiles); PEN: the penalty; FORM: the epilogue
// (kCompact, kRowMajor, kTop2, kQMajor). `cluster` CTAs (1 or 2) share each
// row tile: each loads 128 / cluster of its rows into all of them. out_v /
// out_l: bf16 / u8 (compact) or float / int32 (row-major, q-major) minima
// and offsets; out_v2 / out_l2 the tournament's seconds.
template <int KS, int RT, bool PEN, int FORM>
__global__ void __launch_bounds__(kThreads, 1)
block_min_compact_kernel(const __grid_constant__ CUtensorMap rows_map,
                         const __nv_bfloat16* __restrict__ q_aug,
                         const __nv_bfloat16* __restrict__ pen,
                         void* __restrict__ out_v, void* __restrict__ out_l,
                         float* __restrict__ out_v2,
                         int* __restrict__ out_l2, int n, int b, int d1,
                         int r, int stages, int run_tiles, int cluster) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay =
      sweep_layout(d1, r, stages, run_tiles, FORM == kCompact);
  const uint32_t full0 = smem_u32(smem + lay.bars);
  const uint32_t empty0 = full0 + 8 * stages;

  const int tid = threadIdx.x;
  const int rank = cluster > 1 ? cluster_rank() : 0;
  const int n_tiles = (n + kRows - 1) / kRows;
  const int q_tiles = (b + kQ - 1) / kQ;
  const int q_groups = (q_tiles + cluster - 1) / cluster;
  const int runs = (n_tiles + run_tiles - 1) / run_tiles;
  // work units of the cluster: a run x a group of `cluster` query tiles
  const long long units = (long long)runs * q_groups;
  const int first = blockIdx.x / cluster, step = gridDim.x / cluster;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      // every consumer warp of the cluster frees a stage of every CTA
      mbar_init(empty0 + 8 * s, cluster * kConsumers / 32);
    }
    mbar_init_fence();
  }
  if (cluster > 1) {
    cluster_sync();  // the peers' barriers exist before anyone signals them
  } else {
    __syncthreads();
  }

  if (tid >= kConsumers) {
    // the producer warp: one thread keeps the ring full, loading its part
    // of each box (128 / cluster rows) into every CTA of the cluster
    if (tid == kConsumers) {
      const int part = kRows / cluster;
      const uint16_t mask = (uint16_t)((1 << cluster) - 1);
      int s = 0, ph = 0, filled = 0;  // ring slot, its phase, slots used
      for (long long u = first; u < units; u += step) {
        const int t0 = (int)(u / q_groups) * run_tiles;
        const int t1 = min(t0 + run_tiles, n_tiles);
        for (int t = t0; t < t1; ++t) {
          if (filled < stages)
            ++filled;
          else
            mbar_wait(empty0 + 8 * s, ph ^ 1);  // its last use is done
          mbar_expect_tx(full0 + 8 * s, lay.stage_bytes);
          for (int bx = 0; bx < lay.boxes; ++bx) {
            const uint32_t dst = smem_u32(smem + s * lay.stage_bytes +
                                          bx * kBox + rank * part * 128);
            if constexpr (FORM == kTop2) {
              // {col, e, t, j, tile}: this CTA's part is j in
              // [rank * 16 / cluster, ...), smem rows 8j + 2t + e
              if (cluster > 1)
                tma_load_5d_multicast(dst, &rows_map, full0 + 8 * s,
                                      bx * kBoxCols, rank * part / 8, t,
                                      mask);
              else
                tma_load_5d(dst, &rows_map, full0 + 8 * s, bx * kBoxCols, 0,
                            t);
            } else if (cluster > 1) {
              tma_load_2d_multicast(dst, &rows_map, full0 + 8 * s,
                                    bx * kBoxCols, t * kRows + rank * part,
                                    mask);
            } else {
              tma_load_2d(dst, &rows_map, full0 + 8 * s, bx * kBoxCols,
                          t * kRows);
            }
          }
          if (++s == stages) s = 0, ph ^= 1;
        }
      }
    }
  } else {
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // query rows of this thread in the CTA tile: slot g (h = 0) and g + 8
    const int qrow = 64 * wg + 16 * ((tid >> 5) & 3) + g;
    __nv_bfloat16* st_v =
        reinterpret_cast<__nv_bfloat16*>(smem + lay.staging_v);
    uint8_t* st_l = smem + lay.staging_l;
    const int sv_q = lay.stride_v / 2;  // bf16 elements a staged query row
    const long long nb = n / r;
    constexpr int NBT = kRows / RT;     // blocks of a tile (1 where r >= 128)
    constexpr int JB = RT / 8;          // accumulator columns j of a block

    uint32_t a[KS][4];
    float acc[64];
    int s = 0, ph = 0;  // ring slot and its phase
    for (long long u = first; u < units; u += step) {
      const int qt = (int)(u % q_groups) * cluster + rank;
      const int t0 = (int)(u / q_groups) * run_tiles;
      const int t1 = min(t0 + run_tiles, n_tiles);
      {
        // the unit's A fragments straight from q_aug [b, d1]: register i
        // of k-step ks holds the bf16 pair of query qrow + 8 (i & 1) of
        // the tile at dimensions 16 ks + 2 t + 8 (i >> 1) + {0, 1}, zero
        // past B and D1 (a CTA past the last query tile multiplies zeros
        // and stores nothing)
        const long long q0 = (long long)qt * kQ + qrow;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long qq = q0 + 8 * (i & 1);
            const int d = 16 * ks + 2 * t + 8 * (i >> 1);
            a[ks][i] = qq < b && d < d1
                           ? *reinterpret_cast<const uint32_t*>(
                                 q_aug + qq * d1 + d)
                           : 0u;
          }
      }
      float carry_v = 0.0f;  // r > 128: the block's minimum so far
      int carry_i = 0;
      Run carry2 = {0.0f, 0.0f, 0, 0};

      for (int tile = t0; tile < t1; ++tile) {
        mbar_wait(full0 + 8 * s, ph);
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
        wgmma_fence();
        const uint32_t base = smem_u32(smem + s * lay.stage_bytes);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_bf16_rs(acc, a[ks],
                        sw128_desc(base + (ks >> 2) * kBox + (ks & 3) * 32),
                        ks != 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
        // this warp has read stage s: lane c tells CTA c of the cluster
        if (cluster > 1) {
          if (lane < cluster) mbar_arrive_cluster(empty0 + 8 * s, lane);
        } else if (lane == 0) {
          mbar_arrive(empty0 + 8 * s);
        }
        if (++s == stages) s = 0, ph ^= 1;

        // epilogue: acc[4j + 2h + e] is query slot g + 8h, row 8j + 2t + e
        // (the top-2 form permutes the rows, below)
        const int row0 = tile * kRows;
        const long long tblk = (long long)tile * kRows / r;  // tile's block
        if constexpr (FORM == kTop2) {
          // the 5-D box put tile row 32t + 2j + e at accumulator column
          // 8j + 2t + e: this thread holds rows 32t .. 32t + 31 of query
          // slots g and g + 8. Row bits 0 (e) and 1 to 4 (j) merge in the
          // thread, a binary counter over j keeping the pending runs
          constexpr int LB = RT >= 32 ? 4 : RT == 16 ? 3 : 2;  // j levels
          Run run32[2];  // r >= 64: the thread's 32-row run of each slot
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gq = qt * kQ + qrow + 8 * h;
            Run stk[4];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int row = 32 * t + 2 * j;
              float va = acc[4 * j + 2 * h], vb = acc[4 * j + 2 * h + 1];
              if (PEN) {
                const uint32_t pw =
                    row0 + row < n
                        ? *reinterpret_cast<const uint32_t*>(pen + row0 + row)
                        : 0u;
                va += __uint_as_float(pw << 16);
                vb += __uint_as_float(pw & 0xFFFF0000u);
              }
              Run cur = pair_run(va, vb, row);  // row bit 0
              bool pending = false;
#pragma unroll
              for (int L = 0; L < 4; ++L) {
                if (L < LB && !pending) {
                  if ((j >> L) & 1) {
                    cur = merge_runs(stk[L], cur);
                  } else {
                    stk[L] = cur;
                    pending = true;
                  }
                }
              }
              if (pending) continue;
              if (RT <= 32) {  // a whole block of this thread's rows
                const long long gblk = tblk + row / RT;
                if (gq < b && gblk < nb) {
                  const long long o = gblk * b + gq;
                  static_cast<float*>(out_v)[o] = cur.m1;
                  static_cast<int*>(out_l)[o] = cur.l1 & (RT - 1);
                  out_v2[o] = cur.m2;
                  out_l2[o] = cur.l2 & (RT - 1);
                }
              } else {
                run32[h] = cur;
              }
            }
          }
          if (RT >= 64) {
            // row bit 5 across lanes t ^ 1, keeping query slot t & 1
            const int hq = t & 1, half = t >> 1;
            Run cur = exchange_runs(run32[0], run32[1], hq, 1);
            long long gblk = tblk + half;  // r = 64: rows 64 half ..
            bool write = true;
            if (RT == 64) {
              cur.l1 &= 63;
              cur.l2 &= 63;
            } else {
              // row bit 6 across lanes t ^ 2: both compute the block
              const Run other = shfl_run(cur, 2);
              cur = merge_runs(select_run(half, other, cur),
                               select_run(half, cur, other));
              gblk = tblk;
              write = half == 0;
              if (r > kRows) {  // r = 256: two tiles a block
                gblk = tile / 2;
                if (((tile - t0) & 1) == 0) {
                  carry2 = cur;
                  write = false;
                } else {
                  cur.l1 += kRows;
                  cur.l2 += kRows;
                  cur = merge_runs(carry2, cur);
                }
              }
            }
            const int gq = qt * kQ + qrow + 8 * hq;
            if (write && gq < b && gblk < nb) {
              const long long o = gblk * b + gq;
              static_cast<float*>(out_v)[o] = cur.m1;
              static_cast<int*>(out_l)[o] = cur.l1;
              out_v2[o] = cur.m2;
              out_l2[o] = cur.l2;
            }
          }
        } else {
          uint32_t pw[16];  // the penalty of rows 8j + 2t and 8j + 2t + 1
#pragma unroll
          for (int j = 0; j < 16; ++j)
            pw[j] = PEN && row0 + 8 * j < n
                        ? *reinterpret_cast<const uint32_t*>(pen + row0 +
                                                             8 * j + 2 * t)
                        : 0u;
          // groups of two blocks (one where a block fills the tile): items
          // k = 2 * (block in group) + h, reduced within the thread, then
          // across the quad
          constexpr int GB = NBT >= 2 ? 2 : 1;  // blocks a group
          constexpr int NI = 2 * GB;            // items a group
#pragma unroll
          for (int gb = 0; gb < NBT / GB; ++gb) {
            float v[4];
            int ix[4];
#pragma unroll
            for (int k = 0; k < NI; ++k) {
              // the item's 2 JB values m = 2 jj + e, rows 8 jj + 2t + e of
              // the block, in row order
              const int bl = gb * GB + (k >> 1), h = k & 1;
              float tv[4 * JB];
#pragma unroll
              for (int m = 0; m < 2 * JB; ++m) {
                const int j = bl * JB + (m >> 1), e = m & 1;
                tv[2 * JB + m] = acc[4 * j + 2 * h + e];
                if (PEN)
                  tv[2 * JB + m] +=
                      __uint_as_float(e ? pw[j] & 0xFFFF0000u : pw[j] << 16);
              }
              const int mi = lowest_argmin<2 * JB>(tv, v[k]);
              ix[k] = 8 * (mi >> 1) + (mi & 1) + 2 * t;
            }
            int item;  // the item this lane holds at the end
            if (NI == 4) {
              exchange<4>(v, ix, t & 1, 1);
              exchange<2>(v, ix, (t >> 1) & 1, 2);
              item = t;
            } else {
              exchange<2>(v, ix, t & 1, 1);
              lex_min(v[0], ix[0], __shfl_xor_sync(0xffffffffu, v[0], 2),
                      __shfl_xor_sync(0xffffffffu, ix[0], 2));
              item = t & 1;
            }
            if (NI == 4 || t < 2) {
              const int bl = gb * GB + (item >> 1);
              const int q = qrow + 8 * (item & 1);
              int blk = (tile - t0) * NBT + bl;  // block within the run
              float val = v[0];
              int off = ix[0];
              bool write = true;
              if (RT == kRows && r > kRows) {
                // a block over r / 128 tiles (a run holds whole blocks):
                // the running minimum, the earlier tile's on a tie, written
                // at the block's last tile
                const int per = r / kRows, part = (tile - t0) & (per - 1);
                blk = (tile - t0) / per;
                if (part == 0 || val < carry_v) {
                  carry_v = val;
                  carry_i = off + part * kRows;
                }
                write = part == per - 1;
                val = carry_v;
                off = carry_i;
              }
              if (write) {
                if constexpr (FORM == kCompact) {
                  st_v[q * sv_q + blk] = __float2bfloat16_rn(val);
                  st_l[q * lay.stride_l + blk] = (uint8_t)off;
                } else {
                  // row-major [N/r, B] or q-major [B, N/r], from registers:
                  // a row-major store covers 16 queries of a block (64
                  // bytes); the q-major output (2.5 MB at B = 128, r = 512)
                  // is written 4 bytes a query and meets in L2
                  const long long gblk = (long long)t0 * kRows / r + blk;
                  const int gq = qt * kQ + q;
                  if (gq < b && gblk < nb) {
                    const long long o = FORM == kQMajor
                                            ? (long long)gq * nb + gblk
                                            : gblk * b + gq;
                    static_cast<float*>(out_v)[o] = val;
                    static_cast<int*>(out_l)[o] = off;
                  }
                }
              }
            }
          }
        }
      }
      if constexpr (FORM != kCompact) continue;

      // the run's minima, consecutive along each query's output row: in
      // 16-byte pieces where the run is whole and the rows 16-byte
      // aligned, else element by element
      consumer_sync();
      __nv_bfloat16* cv = static_cast<__nv_bfloat16*>(out_v);
      uint8_t* cl = static_cast<uint8_t*>(out_l);
      const long long blk0 = (long long)t0 * kRows / r;
      const int blocks = lay.blocks;  // a power of two
      const int lb = __ffs(blocks) - 1;
      const long long left = nb - blk0;
      const int here = left < blocks ? (int)left : blocks;
      if (here == blocks && blocks % 16 == 0 && nb % 16 == 0) {
        // minima: blocks / 8 pieces a query, offsets: blocks / 16
        for (int i = tid; i < kQ * blocks / 8; i += kConsumers) {
          const int ql = i >> (lb - 3), c = i & (blocks / 8 - 1);
          const int q = qt * kQ + ql;
          if (q < b)
            *reinterpret_cast<uint4*>(cv + (long long)q * nb + blk0 +
                                      8 * c) =
                *reinterpret_cast<const uint4*>(st_v + ql * sv_q + 8 * c);
        }
        for (int i = tid; i < kQ * blocks / 16; i += kConsumers) {
          const int ql = i >> (lb - 4), c = i & (blocks / 16 - 1);
          const int q = qt * kQ + ql;
          if (q < b)
            *reinterpret_cast<uint4*>(cl + (long long)q * nb + blk0 +
                                      16 * c) =
                *reinterpret_cast<const uint4*>(st_l + ql * lay.stride_l +
                                                16 * c);
        }
      } else {
        for (int i = tid; i < kQ * blocks; i += kConsumers) {
          const int ql = i >> lb, bl = i & (blocks - 1);
          const int q = qt * kQ + ql;
          if (q < b && bl < here) {
            const long long o = (long long)q * nb + blk0 + bl;
            cv[o] = st_v[ql * sv_q + bl];
            cl[o] = st_l[ql * lay.stride_l + bl];
          }
        }
      }
      consumer_sync();  // the staging is reused by the next unit
    }
  }
  // no CTA leaves while a peer may still signal its barriers
  if (cluster > 1) cluster_sync();
}

struct Args {
  const void *q_aug, *pen;
  void *out_v, *out_l, *out_v2, *out_l2;
  int n, b, d1, r, stages, run_tiles, cluster, smem;
  cudaStream_t stream;
};

template <int KS, int RT, bool PEN, int FORM>
int launch(const CUtensorMap& map, const Args& x) {
  auto kernel = block_min_compact_kernel<KS, RT, PEN, FORM>;
  // host queries that cost microseconds a launch, made once an instance
  // and device: the shared-memory limit (raised to what any call may
  // take) and, below, the occupancy
  static HostMemo limit, memo;
  int dev = 0, done = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = limit.get((uint32_t)(dev & 127), &done, [&](int*) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = x.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = x.smem;
  cfg.stream = x.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // one CTA per SM, as many clusters as the card holds at once (once an
  // instance, device, cluster width and shared-memory size)
  int clusters = 0;
  cfg.gridDim = dim3(x.cluster * 256);
  err = memo.get((uint32_t)((dev & 127) << 24 | x.cluster << 20 | x.smem),
                 &clusters, [&](int* v) {
                   return cudaOccupancyMaxActiveClusters(v, kernel, &cfg);
                 });
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (x.n + kRows - 1) / kRows;
  const long long units =
      (n_tiles + x.run_tiles - 1) / x.run_tiles *
      ((x.b + kQ * x.cluster - 1) / (kQ * x.cluster));
  cfg.gridDim =
      dim3((unsigned)(x.cluster * (units < clusters ? units : clusters)));
  err = cudaLaunchKernelEx(
      &cfg, kernel, map, static_cast<const __nv_bfloat16*>(x.q_aug),
      static_cast<const __nv_bfloat16*>(x.pen), x.out_v, x.out_l,
      static_cast<float*>(x.out_v2), static_cast<int*>(x.out_l2), x.n, x.b,
      x.d1, x.r, x.stages, x.run_tiles, x.cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KS, int RT, bool PEN>
int launch_form(int form, const CUtensorMap& map, const Args& x) {
  if (form == kCompact) return launch<KS, RT, PEN, kCompact>(map, x);
  if (form == kRowMajor) return launch<KS, RT, PEN, kRowMajor>(map, x);
  if (form == kQMajor) return launch<KS, RT, PEN, kQMajor>(map, x);
  return launch<KS, RT, PEN, kTop2>(map, x);
}

template <int KS>
int launch_r(int form, const CUtensorMap& map, const Args& x) {
#define SWEEP_CASE(RT)                                                   \
  if (x.r == RT || (RT == kRows && x.r > kRows))                         \
    return x.pen != nullptr ? launch_form<KS, RT, true>(form, map, x)    \
                            : launch_form<KS, RT, false>(form, map, x);
  SWEEP_CASE(8)
  SWEEP_CASE(16)
  SWEEP_CASE(32)
  SWEEP_CASE(64)
  SWEEP_CASE(128)
#undef SWEEP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded through ctypes. rows [n, d1] bf16, 16-byte
// aligned; q_aug [b, d1] bf16, contiguous (the kernel reads each work
// unit's A fragments from it, as ops/sweep.block_min_compact_query_image
// lays them out); pen [n] bf16 or null; `form` 0 (compact: out_v [b, n / r] bf16, out_l [b, n / r]
// u8), 1 (row-major: out_v [n / r, b] float32, out_l [n / r, b] int32) or
// 2 (top-2: out_v, out_l, out_v2, out_l2 row-major as form 1) or 3
// (q-major: out_v [b, n / r] float32, out_l [b, n / r] int32), allocated
// by the caller; out_v2 / out_l2 null unless form 2. r a power of two in
// [8, 256] ([8, 512] for form 3), n % r == 0, d1 % 8 == 0 and d1 <= 256;
// stages, run_tiles (a multiple of r / 128 where r > 128) and cluster (1
// or 2) from ops/sweep.sweep_plan. Launches on `stream`, does not
// synchronise, allocates nothing; returns a CUDA error code (0 on
// success).
extern "C" int block_min_compact(const void* rows, const void* q_aug,
                                 const void* pen, void* out_v, void* out_l,
                                 long long n, int b, int d1, int r, int stages,
                                 int run_tiles, int cluster, int form,
                                 void* out_v2, void* out_l2, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (n >= (1LL << 31) || d1 <= 0 || d1 % 8 || d1 > kMaxBoxes * kBoxCols ||
      r < 8 || r > (form == kQMajor ? kMaxTilesABlock : 2) * kRows ||
      (r & (r - 1)) || n % r || stages < 1 || stages > kMaxStages ||
      run_tiles < 1 || (r > kRows && run_tiles % (r / kRows)) ||
      (cluster != 1 && cluster != kMaxCluster) || form < kCompact ||
      form > kQMajor || ((out_v2 == nullptr || out_l2 == nullptr ||
                        n % kRows) && form == kTop2) ||
      reinterpret_cast<uintptr_t>(rows) % 16)
    return (int)cudaErrorInvalidValue;
  const Layout lay = sweep_layout(d1, r, stages, run_tiles, form == kCompact);
  if (lay.blocks < 1 || lay.total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;

  // boxes of 128 / cluster rows x 64 columns, 128-byte swizzled, zero past
  // d1 and n. The top-2 form reads each tile through a 5-D view {col, e,
  // t, j, tile} with row strides {1, 32, 2, 128}: smem row 8j + 2t + e
  // (accumulator column 8j + 2t + e) holds tile row 32t + 2j + e, and the
  // view needs whole tiles.
  CUtensorMap map;
  const cuuint64_t rb = (cuuint64_t)d1 * 2;
  const cuuint64_t dims2[2] = {(cuuint64_t)d1, (cuuint64_t)n};
  const cuuint64_t strides2[1] = {rb};
  const cuuint32_t box2[2] = {kBoxCols, (cuuint32_t)(kRows / cluster)};
  const cuuint64_t dims5[5] = {(cuuint64_t)d1, 2, 4, 16,
                               (cuuint64_t)n / kRows};
  const cuuint64_t strides5[4] = {rb, 32 * rb, 2 * rb, kRows * rb};
  const cuuint32_t box5[5] = {kBoxCols, 2, 4, (cuuint32_t)(16 / cluster), 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const bool top2 = form == kTop2;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, top2 ? 5 : 2,
             const_cast<void*>(rows), top2 ? dims5 : dims2,
             top2 ? strides5 : strides2, top2 ? box5 : box2, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const Args x = {q_aug, pen, out_v, out_l, out_v2, out_l2, (int)n, b, d1, r,
                  stages, run_tiles, cluster, lay.total,
                  static_cast<cudaStream_t>(stream)};
#define SWEEP_KS(BOXES) \
  if (lay.boxes == BOXES) return launch_r<4 * BOXES>(form, map, x);
  SWEEP_KS(1)
  SWEEP_KS(2)
  SWEEP_KS(3)
  SWEEP_KS(4)
#undef SWEEP_KS
  return (int)cudaErrorInvalidValue;
}

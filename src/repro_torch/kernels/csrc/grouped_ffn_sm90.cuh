// Grouped expert FFN on Hopper's tensor cores (sm_90a), shared by moe_ffn.cu
// and ragged_ffn.cu: the route for bf16 with both widths multiples of 8.
// f32 inputs and widths whose rows are not 16-byte aligned stay on the
// CUDA-core device code in grouped_ffn.cuh.
//
// Replaces (with grouped_ffn.cuh): src/repro/kernels/moe_ffn/kernel.py
// moe_ffn_kernel and src/repro/kernels/moe_dropless/kernel.py
// ragged_ffn_kernel.  For every row r of a group g of R token rows, all of
// expert e(g),
//   y[r] = act(x[r] @ W_up[e] [, x[r] @ W_gate[e]]) @ W_down[e]
// with the products accumulated in f32 and y rounded to bf16 once.
// ExpertRows is (E, X, M) with e(g) = g; RaggedRows is (N, M) in blocks of
// bx rows, block b of expert block_expert[b], where the liveness tags (one
// a row) make a block none of whose rows is routed dead: its y is 0.
//
// What bounds it: at the m6-base shapes (E = 32, M = 1024, I = 4096) the
// weights are 537 MB and a group has 8 to 192 rows, 8 to 192 flops per
// weight byte read: below the 295 flop/byte bf16 ridge, so the weight bytes
// over 3.35 TB/s.  The design reads each expert's weight tile once per group
// of rows, from device memory, with TMA, and keeps the tensor cores fed.
//
// Design (swap A and B): the TPU kernel's (bx, M) f32 accumulator does not
// fit a CTA at M = 1024, so the FFN stays two passes with h in device
// memory, and each pass computes a transposed product so that the weights
// are wgmma's 64-row operand A and the group's token rows its N columns:
//   pass 1: h^T = W_up[e]^T x_g^T   (and W_gate[e]^T x_g^T when gated)
//   pass 2: y^T = W_down[e]^T h_g^T
// A CTA owns (group tile of N rows, 128 output columns) and streams the
// reduction dimension through a ring of shared-memory stages of 64: one
// producer warp issues the TMA loads (two 64-column weight boxes, the gate's
// two when gated, the N-row token box; 128-byte swizzle; the stage's
// mbarrier counts the bytes), two consumer warpgroups each run wgmma on one
// 64-column half for all N rows and release the stage.  The weight is
// MN-major in shared memory (output columns contiguous), the rows K-major.
// TMA fills rows past R, columns past C and reduction elements past K with
// zeros, so no row is padded in memory and the epilogue masks the stores.
//
// Numerics of h: pass 1's epilogue applies the activation to the f32
// accumulators and writes h as two bf16 planes, hi = bf16(h) and
// lo = bf16(h - hi); pass 2 runs two wgmmas on each A tile (hi and lo
// columns) into one f32 accumulator, so h keeps about 16 mantissa bits
// (relative error about 2^-17) where a plain bf16 h would keep 8.  The
// tensor cores' own f32 accumulation rounds its partial sums differently
// from an FMA chain, so a few in a thousand bf16 outputs land one ulp from
// the f32 plain version's (chip_smoke.py logs the share on both routes).
//
// Grids.  moe_ffn (ExpertRows: every group of X rows live, one expert
// each): pass 1 (ceil(I / 128), G * tiles), pass 2 (ceil(M / 128),
// G * tiles), one CTA per output tile; blockIdx.x (the column tile) varies
// fastest, so the CTAs that read one group's rows run together and share
// them through L2.  At E = 32, X = 180 that is 1024 and 256 CTAs, one
// resident per SM (160 and 193 KB of stages).
//
// ragged_ffn (RaggedRows) is scheduled over the work, not the layout's
// blocks: most of a serving or mesh layout is padding (1025 of 1044 blocks
// at a mesh rank's mixed step), and one expert's rows span several blocks
// (a static prefill, expert choice) or several groups (the mesh's and the
// model drafter's multi-group buffers), so a CTA a block re-read an
// expert's weights once a block.  A prologue kernel (one CTA) builds a work
// list on the device: the live blocks (a block is live when a row of it is
// routed, read from the liveness tags; every block without them) sorted by
// expert, cut into items of up to n rows of one expert, and the list of
// dead blocks.  Each pass is then a persistent grid of the SM count (one
// CTA an SM fits) walking the items crossed with the column tiles, the
// column tile fastest, its stage ring running on across the tiles a CTA
// takes (the producer loads the next tile while the consumers store the
// last).  An item's token rows are gathered into a stage by one TMA box a
// block, so its weight tile is read once for up to n rows wherever they
// lie; where few items leave SMs idle the reduction is split across CTAs.
// The down pass's CTAs also write the dead blocks' rows of y as 0, so a
// dead block costs its zero stores and its x is never read.  The count of
// items is read from device memory: nothing returns to the host.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped_ffn.cuh"
#include "sm90.cuh"
#include "wgmma_bf16.cuh"

namespace grouped_ffn_sm90 {

using namespace sm90;   // mbarriers, TMA, descriptors, tensor maps; Wgmma<N>

constexpr int kBK = 64;                        // reduction depth of a stage: one 128-byte row
constexpr int kBC = 128;                       // output columns per CTA
constexpr int kConsumers = 2;                  // consumer warpgroups, 64 columns each
constexpr int kThreads = kConsumers * 128 + 32;  // + the producer warp
constexpr int kHalf = 64 * kBK * 2;            // one 64-column weight box: 8 KB
constexpr int kSmemBudget = 220 * 1024;

enum Kind { kUp = 0, kUpGated = 1, kDown = 2 };

// A stage: the weight boxes (two 64-column halves, the gate's two when
// gated) and N token rows (pass 2: of h's hi and lo planes).  At most
// MAXST stages in the 220 KB budget: 4 for moe_ffn's grid, more for the
// ragged passes' persistent CTAs, whose narrow tiles leave room for more
// weight bytes in flight.
template <int N, int KIND, int MAXST = 4>
struct Tile {
  static constexpr int kA = (KIND == kUpGated ? 2 : 1) * kConsumers * kHalf;
  static constexpr int kBRow = N * kBK * 2;    // N token rows of 128 bytes
  static constexpr int kB = (KIND == kDown ? 2 : 1) * kBRow;   // pass 2: hi and lo
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = kSmemBudget / kStage < MAXST ? kSmemBudget / kStage : MAXST;
  static constexpr int kSmem = kStages * kStage + 1024;   // + the 1024-byte alignment
  static_assert(kStages >= 2, "a stage ring needs two stages");
};

constexpr int kRaggedStages = 8;

__device__ __forceinline__ float activate(int act, float u, float g) {
  using namespace grouped_ffn;
  switch (act) {
    case kGelu: return gelu_tanh(u);
    case kRelu: return fmaxf(u, 0.0f);
    case kSwiglu: return silu(g) * u;
    default: return gelu_tanh(g) * u;    // kGeglu
  }
}

// A consumer warpgroup's products for one output tile over reduction steps
// [kt0, kt1), into zeroed accumulators: its 64-column half of every stage,
// released after use.
template <int N, int KIND, int MAXST>
__device__ __forceinline__ void mma_tile(float (&acc)[N / 2],
                                         float (&accg)[KIND == kUpGated ? N / 2 : 1],
                                         const uint8_t* smem, uint64_t* full, uint64_t* empty,
                                         int kt0, int kt1, int wg, int lane, int& t) {
  using T = Tile<N, KIND, MAXST>;
  constexpr bool kGated = KIND == kUpGated;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kGated ? N / 2 : 1); ++i) accg[i] = 0.0f;
  for (int kt = kt0; kt < kt1; ++kt, ++t) {
    const int s = t % T::kStages;
    mbar_wait(&full[s], (t / T::kStages) & 1);
    const uint8_t* st = smem + s * T::kStage;
    const uint8_t* a = st + wg * kHalf;
    const uint8_t* b = st + T::kA;
    fence_regs(acc);
    if constexpr (kGated) fence_regs(accg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sw128_desc(a + kk * 16 * 128);   // 16 reduction rows of 128 bytes
      const uint64_t db = sw128_desc(b + kk * 32);         // 16 bf16 along each token row
      Wgmma<N>::mma(acc, da, db);
      if constexpr (kGated)
        Wgmma<N>::mma(accg, sw128_desc(st + (kConsumers + wg) * kHalf + kk * 16 * 128), db);
      if constexpr (KIND == kDown) Wgmma<N>::mma(acc, da, sw128_desc(b + T::kBRow + kk * 32));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if constexpr (kGated) fence_regs(accg);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// One pass of moe_ffn.  wmap: the (E, K, C) weights; gmap: W_gate
// (kUpGated); bmap: the (G, R, K) rows (x, or h's hi plane), group g of
// expert g; blomap: h's lo plane (kDown).  out (G*R, C): h's hi plane
// (kUp*) or y (kDown); out_lo: h's lo plane.  grid (ceil(C / 128), G * tiles).
template <int N, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
tc_pass_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap gmap,
               const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap blomap,
               int tiles, int R, int K, int C, int act, __nv_bfloat16* __restrict__ out,
               __nv_bfloat16* __restrict__ out_lo) {
  using T = Tile<N, KIND>;
  constexpr int kR = N / 2;                    // accumulator registers per product
  constexpr bool kGated = KIND == kUpGated;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[T::kStages], empty[T::kStages];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int g = blockIdx.y / tiles;
  const int n0 = (blockIdx.y - g * tiles) * N;
  const int c0 = blockIdx.x * kBC;
  const int nk = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers * 128) {               // the producer warp: one lane loads
    if (tid == kConsumers * 128) {
      const int e = g;
      uint64_t evict_first;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(evict_first));
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % T::kStages;
        if (kt >= T::kStages) mbar_wait(&empty[s], ((kt / T::kStages) + 1) & 1);
        uint8_t* st = smem + s * T::kStage;
        const int k = kt * kBK;
        mbar_expect_tx(&full[s], T::kStage);
#pragma unroll
        for (int h = 0; h < kConsumers; ++h) {
          tma_load_hint(st + h * kHalf, &wmap, &full[s], c0 + 64 * h, k, e, evict_first);
          if (kGated)
            tma_load_hint(st + (kConsumers + h) * kHalf, &gmap, &full[s], c0 + 64 * h, k, e,
                          evict_first);
        }
        tma_load(st + T::kA, &bmap, &full[s], k, n0, g);
        if (KIND == kDown) tma_load(st + T::kA + T::kBRow, &blomap, &full[s], k, n0, g);
      }
    }
    return;
  }

  // consumer warpgroup wg: output columns [c0 + 64 wg, c0 + 64 wg + 64)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[kR], accg[kGated ? kR : 1];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kGated ? kR : 1); ++i) accg[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::kStages;
    mbar_wait(&full[s], (kt / T::kStages) & 1);
    const uint8_t* st = smem + s * T::kStage;
    const uint8_t* a = st + wg * kHalf;
    const uint8_t* b = st + T::kA;
    fence_regs(acc);
    if constexpr (kGated) fence_regs(accg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sw128_desc(a + kk * 16 * 128);   // 16 reduction rows of 128 bytes
      const uint64_t db = sw128_desc(b + kk * 32);         // 16 bf16 along each token row
      Wgmma<N>::mma(acc, da, db);
      if constexpr (kGated)
        Wgmma<N>::mma(accg, sw128_desc(st + (kConsumers + wg) * kHalf + kk * 16 * 128), db);
      if constexpr (KIND == kDown) Wgmma<N>::mma(acc, da, sw128_desc(b + T::kBRow + kk * 32));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if constexpr (kGated) fence_regs(accg);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: register i holds output column c and token row r of the tile
  const int cbase = c0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = cbase + 8 * ((i >> 1) & 1);
    const int r = n0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    if (r < R && c < C) {
      const size_t o = ((size_t)g * R + r) * C + c;
      if constexpr (KIND == kDown) {
        out[o] = __float2bfloat16(acc[i]);
      } else {
        const float v = activate(act, acc[i], kGated ? accg[kGated ? i : 0] : 0.0f);
        const __nv_bfloat16 hi = __float2bfloat16(v);
        out[o] = hi;
        out_lo[o] = __float2bfloat16(v - __bfloat162float(hi));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The ragged FFN's work list and persistent passes
// ---------------------------------------------------------------------------

// The work list.  A tile's token rows are up to n / seg segments of seg =
// min(bx, n) rows, each a block (or, where bx > n, a part of one), all of
// one expert and gathered from anywhere in x: one TMA box a segment.  The
// int32 workspace of ragged_work_ints words holds: [0] the item count, [1]
// the dead-block count; from word 4 an int4 an item (its first segment in
// the sorted list, its segments, its expert, 0), in expert order; the live
// blocks sorted by expert (segment s is part s % spb of block
// sorted[s / spb], spb = bx / seg); the dead blocks; each block's expert,
// or -1 where the block is dead; and a counter for each (item, column
// tile) of a split reduction.
struct Segs {
  int bx, seg, spb;
  __host__ __device__ Segs(int bx_, int n) : bx(bx_), seg(bx_ < n ? bx_ : n), spb(bx_ / seg) {}
  __device__ __forceinline__ long long row(const int* sorted, int s) const {
    return (long long)sorted[s / spb] * bx + (long long)(s % spb) * seg;
  }
};
__host__ __device__ __forceinline__ int ragged_items(int nb, int bx, int n) {
  return nb * (bx / (bx < n ? bx : n));      // at most a segment an item
}
__host__ __device__ __forceinline__ int* work_sorted(int* work, int nb, int bx, int n) {
  return work + 4 + 4 * ragged_items(nb, bx, n);
}
__host__ __device__ __forceinline__ int* work_dead(int* work, int nb, int bx, int n) {
  return work_sorted(work, nb, bx, n) + nb;
}
__host__ __device__ __forceinline__ int* work_counters(int* work, int nb, int bx, int n) {
  return work_dead(work, nb, bx, n) + 2 * nb;
}
// words of the workspace; ctiles: the most column tiles a pass has
__host__ __device__ __forceinline__ long long ragged_work_ints(int nb, int bx, int n, int ctiles) {
  return 4 + 4LL * ragged_items(nb, bx, n) + 3LL * nb +
         (long long)ragged_items(nb, bx, n) * ctiles;
}

constexpr int kListThreads = 256;
constexpr int kListWarps = kListThreads / 32;

// The exclusive prefix sum of v over the CTA's kListThreads threads, the
// total in *total; sh: kListWarps ints of shared memory.
__device__ __forceinline__ int block_sum(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sh[w] = incl;
  __syncthreads();
  if (w == 0) {
    int s = lane < kListWarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < kListWarps; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += u;
    }
    if (lane < kListWarps) sh[lane] = s;
  }
  __syncthreads();
  const int before = (w > 0 ? sh[w - 1] : 0) + incl - v;
  *total = sh[kListWarps - 1];
  __syncthreads();                             // sh is reused by the next scan
  return before;
}

constexpr int kSortExperts = 1024;            // the most experts the prologue sorts by
constexpr int kSmemBlocks = 8192;             // blocks whose experts the prologue keeps in smem

// The prologue, one CTA of kListThreads: each block's expert or -1 (dead:
// none of its bx rows routed, the tags read 8 rows a thread; no tags: every
// block live); the dead blocks listed and the live ones counted an expert
// (shared-memory atomics); each expert's first place and first item (two
// sum-scans over the experts: an expert of k live blocks has ceil(k spb /
// spi) items of spi = n / seg segments) and its items; and the blocks
// sorted by expert (a counting sort).  The orders within the dead list and
// within an expert are free: a row's result does not depend on the rows
// beside it in a tile.  So one expert's rows from several groups, or runs
// split by another expert's, share a tile and its weight reads.  The split
// reduction's counters in use are zeroed too.  The blocks' experts stay in
// shared memory up to kSmemBlocks blocks (the workspace's copy beyond).
static __global__ void __launch_bounds__(kListThreads)
work_list_kernel(const int32_t* __restrict__ block_expert, grouped_ffn::Tags tags, int nb, int bx,
                 int n, int E, int counters_used, int* __restrict__ work) {
  __shared__ int sh[kListWarps];
  __shared__ int first_block[kSortExperts];  // live blocks an expert, then its first place
  __shared__ int eff_smem[kSmemBlocks];
  __shared__ int n_dead;
  const int tid = threadIdx.x;
  const Segs sg(bx, n);
  const int spi = n / sg.seg;
  int4* items = reinterpret_cast<int4*>(work + 4);
  int* sorted = work_sorted(work, nb, bx, n);
  int* dead = sorted + nb;
  int* eff = nb <= kSmemBlocks ? eff_smem : dead + nb;
  int* counters = work_counters(work, nb, bx, n);
  if (tid == 0) n_dead = 0;
  for (int e = tid; e < E; e += kListThreads) first_block[e] = 0;
  for (int i = tid; i < counters_used; i += kListThreads) counters[i] = 0;
  if (tags.p == nullptr) {
    for (int b = tid; b < nb; b += kListThreads) eff[b] = block_expert[b];
  } else {
    for (int b = tid; b < nb; b += kListThreads) eff[b] = -1;
    __syncthreads();
    // 8 rows a thread (bx is a multiple of 8, so they share a block), their
    // tags loaded before any is tested; a block's every marker stores the same
    const long long rows = (long long)nb * bx;
    for (long long r0 = 8LL * tid; r0 < rows; r0 += 8LL * kListThreads) {
      bool hit[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) hit[q] = tags.routed(r0 + q);
      bool any = false;
#pragma unroll
      for (int q = 0; q < 8; ++q) any |= hit[q];
      if (any) eff[r0 / bx] = block_expert[r0 / bx];
    }
  }
  __syncthreads();
  for (int b = tid; b < nb; b += kListThreads) {   // the dead list's order is free
    const int e = eff[b];
    if (e < 0) dead[atomicAdd(&n_dead, 1)] = b;
    else atomicAdd(&first_block[e], 1);
  }
  __syncthreads();
  int block_carry = 0, item_carry = 0, total;
  for (int c = 0; c < E; c += kListThreads) {
    const int e = c + tid;
    const int k = e < E ? first_block[e] : 0;
    const int m = (k * sg.spb + spi - 1) / spi;
    const int kb = block_sum(k, sh, &total) + block_carry;
    block_carry += total;
    const int mi = block_sum(m, sh, &total) + item_carry;
    item_carry += total;
    if (e < E) {
      first_block[e] = kb;
      for (int j = 0; j < m; ++j)              // segments [kb spb + j spi, ...) of the k spb
        items[mi + j] = make_int4(kb * sg.spb + j * spi, min(spi, k * sg.spb - j * spi), e, 0);
    }
  }
  __syncthreads();
  for (int b = tid; b < nb; b += kListThreads)
    if (eff[b] >= 0) sorted[atomicAdd(&first_block[eff[b]], 1)] = b;
  if (tid == 0) {
    work[0] = item_carry;
    work[1] = n_dead;
  }
}

constexpr int kMaxSplit = 8;

// One ragged pass, a persistent CTA an SM: work unit u is k-slice u % S of
// item u / (ctiles S) at column tile (u / S) % ctiles.  An item's token rows
// are its segments, gathered by one TMA box each into the stage's N rows
// (a stage expects the bytes of the boxes it loads; rows past them hold a
// previous stage's data, whose columns are never stored).  Where the items
// times the column tiles leave SMs idle (a decode step's few experts, a
// mesh rank's one-token groups), the reduction is split S ways (at most
// kMaxSplit, a slice at least 4 steps): each slice's f32 accumulators go to
// `partial`, and the CTA that finishes an (item, tile) last adds the slices
// in order (the sum does not depend on which CTA finishes last) and stores
// the tile.  bmap / blomap: the (N, K) rows (x, or h's hi and lo planes) as
// a (1, N, K) map in boxes of seg rows; out (N, C).  The down pass (kDown)
// first writes the dead blocks' bx rows of out as 0.
template <int N, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
tc_ragged_pass_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap blomap, int* __restrict__ work,
                      float* __restrict__ partial, int partial_floats, int nb, int bx, int K,
                      int C, int act, __nv_bfloat16* __restrict__ out,
                      __nv_bfloat16* __restrict__ out_lo) {
  using T = Tile<N, KIND, kRaggedStages>;
  constexpr bool kGated = KIND == kUpGated;
  constexpr int kR = N / 2;                    // accumulator registers per product
  constexpr int kP = kGated ? 2 * kR : kR;     // partial floats a consumer thread
  constexpr int kMaxSegs = N / 8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[T::kStages], empty[T::kStages];
  __shared__ int last;
  __shared__ int sched[3];                      // the split, its slices' steps, the units
  __shared__ int out_rows[2][kMaxSegs];         // an epilogue's out row of each 8 tile rows
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  // the consumers keep few registers live beside the accumulators: what the
  // mainloop does not need is read again after it (shared memory, params)
  const int ctiles = (C + kBC - 1) / kBC;
  const int nk = (K + kBK - 1) / kBK;
  const int4* items = reinterpret_cast<const int4*>(work + 4);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // a split only where the tiles leave SMs idle (each slice costs its
    // partial stores, a fence and the last CTA's sum), as far as `partial`
    // holds every unit's slice
    const int tiles = work[0] * ctiles;
    const long long room = partial_floats / (kP * kConsumers * 128);
    int split = tiles > 0 ? (int)gridDim.x / tiles : 1;
    split = max(1, min(split, min(kMaxSplit, nk / 4)));
    while (split > 1 && (long long)tiles * split > room) --split;
    sched[0] = split;
    sched[1] = (nk + split - 1) / split;       // reduction steps a slice
    sched[2] = tiles * split;
  }
  __syncthreads();

  int t = 0;
  if (tid >= kConsumers * 128) {               // the producer warp: one lane loads
    if (tid == kConsumers * 128) {
      const int split = sched[0], ks = sched[1], units = sched[2];
      uint64_t evict_first;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(evict_first));
      const Segs sg(bx, N);
      const uint32_t box = sg.seg * kBK * 2;   // one segment's bytes in a stage
      const int* sorted = work_sorted(work, nb, bx, N);
      int rows[kMaxSegs];
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int4 it = items[u / (ctiles * split)];
        for (int j = 0; j < it.y; ++j) rows[j] = (int)sg.row(sorted, it.x + j);
        const int c0 = (u / split) % ctiles * kBC;
        const int kt0 = (u % split) * ks, kt1 = min(nk, kt0 + ks);
        for (int kt = kt0; kt < kt1; ++kt, ++t) {
          const int s = t % T::kStages;
          if (t >= T::kStages) mbar_wait(&empty[s], ((t / T::kStages) + 1) & 1);
          uint8_t* st = smem + s * T::kStage;
          const int k = kt * kBK;
          mbar_expect_tx(&full[s], T::kA + it.y * box * (KIND == kDown ? 2 : 1));
#pragma unroll
          for (int h = 0; h < kConsumers; ++h) {
            tma_load_hint(st + h * kHalf, &wmap, &full[s], c0 + 64 * h, k, it.z, evict_first);
            if (kGated)
              tma_load_hint(st + (kConsumers + h) * kHalf, &gmap, &full[s], c0 + 64 * h, k, it.z,
                            evict_first);
          }
          for (int j = 0; j < it.y; ++j) {
            tma_load(st + T::kA + j * box, &bmap, &full[s], k, rows[j], 0);
            if (KIND == kDown)
              tma_load(st + T::kA + T::kBRow + j * box, &blomap, &full[s], k, rows[j], 0);
          }
        }
      }
    }
    return;
  }

  if (KIND == kDown) {                         // the dead blocks' rows of y: 0
    const int ndead = work[1];
    const int* dead = work_dead(work, nb, bx, N);
    const int chunks = bx * C / 8;             // 16-byte stores of 8 bf16
    for (int d = blockIdx.x; d < ndead; d += gridDim.x) {
      uint4* p = reinterpret_cast<uint4*>(out + (size_t)dead[d] * bx * C);
      for (int i = tid; i < chunks; i += kConsumers * 128) p[i] = make_uint4(0, 0, 0, 0);
    }
  }

  // consumer warpgroup wg: output columns [c0 + 64 wg, c0 + 64 wg + 64)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  constexpr int kCT = kConsumers * 128;       // consumer threads
  float acc[kR], accg[kGated ? kR : 1];
  for (int u = blockIdx.x; u < sched[2]; u += gridDim.x) {
    {
      const int kt0 = u % sched[0] * sched[1];
      mma_tile<N, KIND, kRaggedStages>(acc, accg, smem, full, empty, kt0,
                                       min((K + kBK - 1) / kBK, kt0 + sched[1]), wg, lane, t);
    }
    const int split = sched[0], tile = u / split;
    if (split > 1) {
      int* counters = work_counters(work, nb, bx, N);
      float* mine = partial + (size_t)u * kP * kCT + tid;     // [unit][register][thread]
#pragma unroll
      for (int i = 0; i < kR; ++i) mine[(size_t)i * kCT] = acc[i];
      if constexpr (kGated) {
#pragma unroll
        for (int i = 0; i < kR; ++i) mine[(size_t)(kR + i) * kCT] = accg[i];
      }
      __threadfence();
      asm volatile("bar.sync 1, %0;" ::"n"(kCT) : "memory");   // the consumers only
      if (tid == 0) last = atomicAdd(&counters[tile], 1) == split - 1;
      asm volatile("bar.sync 1, %0;" ::"n"(kCT) : "memory");
      if (!last) continue;
      __threadfence();
      const float* slices = partial + (size_t)tile * split * kP * kCT + tid;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        float v = 0.0f;
        for (int sl = 0; sl < split; ++sl) v += __ldcg(slices + ((size_t)sl * kP + i) * kCT);
        acc[i] = v;
      }
      if constexpr (kGated) {
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          float v = 0.0f;
          for (int sl = 0; sl < split; ++sl)
            v += __ldcg(slices + ((size_t)sl * kP + kR + i) * kCT);
          accg[i] = v;
        }
      }
      if (tid == 0) counters[tile] = 0;      // ready for the next pass
    }
    // the epilogue: register i holds output column c and tile row
    // 8 (i / 4) + 2 (lane % 4) + i % 2, whose 8-row group i / 4 lies in
    // segment 8 (i / 4) / seg (seg a multiple of 8); the groups' out rows
    // are found once, in the buffer of this iteration's parity (between two
    // epilogues of one parity lies a barrier: the next iteration's, or its
    // split reduction's)
    int* rows = out_rows[(u - blockIdx.x) / gridDim.x & 1];
    if (tid < kMaxSegs) {
      const Segs sg(bx, N);
      const int4 it = items[tile / ctiles];
      const int j = 8 * tid / sg.seg;
      rows[tid] = j < it.y ? (int)sg.row(work_sorted(work, nb, bx, N), it.x + j) +
                                 8 * tid % sg.seg : -1;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kCT) : "memory");
    const int cbase = (tile % ctiles) * kBC + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int c = cbase + 8 * ((i >> 1) & 1);
      const int row = rows[i >> 2];
      if (row >= 0 && c < C) {
        const size_t o = (size_t)(row + 2 * (lane & 3) + (i & 1)) * C + c;
        if constexpr (KIND == kDown) {
          out[o] = __float2bfloat16(acc[i]);
        } else {
          const float v = activate(act, acc[i], kGated ? accg[kGated ? i : 0] : 0.0f);
          const __nv_bfloat16 hi = __float2bfloat16(v);
          out[o] = hi;
          out_lo[o] = __float2bfloat16(v - __bfloat162float(hi));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: launches
// ---------------------------------------------------------------------------

template <int N, int KIND>
cudaError_t launch_pass(const CUtensorMap& w, const CUtensorMap& wg, const CUtensorMap& b,
                        const CUtensorMap& blo, int groups, int tiles, int R, int K, int C,
                        int act, __nv_bfloat16* out, __nv_bfloat16* out_lo, cudaStream_t s) {
  using T = Tile<N, KIND>;
  const cudaError_t err = cudaFuncSetAttribute(
      tc_pass_kernel<N, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kBC - 1) / kBC, groups * tiles);
  tc_pass_kernel<N, KIND><<<grid, kThreads, T::kSmem, s>>>(w, wg, b, blo, tiles, R, K, C, act,
                                                          out, out_lo);
  return cudaGetLastError();
}

template <int N>
cudaError_t run_tiles(const void* x, const void* w_up, const void* w_gate, const void* w_down,
                      int groups, int R, int E, int tiles, void* h, void* y, int M, int I,
                      int act, cudaStream_t s) {
  const bool gated = act == grouped_ffn::kSwiglu || act == grouped_ffn::kGeglu;
  if (gated && N > 128) return cudaErrorInvalidValue;   // two accumulators must fit registers
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  __nv_bfloat16* hi = (__nv_bfloat16*)h;
  __nv_bfloat16* lo = hi + (size_t)groups * R * I;
  CUtensorMap mx, mup, mgate, mdown, mhi, mlo;
  if (!map3d(encode, &mx, kBF16, x, M, R, groups, N) ||
      !map3d(encode, &mup, kBF16, w_up, I, M, E, kBK) ||
      !map3d(encode, &mgate, kBF16, gated ? w_gate : w_up, I, M, E, kBK) ||
      !map3d(encode, &mdown, kBF16, w_down, M, I, E, kBK) ||
      !map3d(encode, &mhi, kBF16, hi, I, R, groups, N) ||
      !map3d(encode, &mlo, kBF16, lo, I, R, groups, N))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (N <= 128) {
    err = gated ? launch_pass<N, kUpGated>(mup, mgate, mx, mx, groups, tiles, R, M, I, act, hi,
                                           lo, s)
                : launch_pass<N, kUp>(mup, mup, mx, mx, groups, tiles, R, M, I, act, hi, lo, s);
  } else {
    err = launch_pass<N, kUp>(mup, mup, mx, mx, groups, tiles, R, M, I, act, hi, lo, s);
  }
  if (err != cudaSuccess) return err;
  return launch_pass<N, kDown>(mdown, mdown, mhi, mlo, groups, tiles, R, I, M, 0,
                               (__nv_bfloat16*)y, nullptr, s);
}

// Both passes over `groups` groups of R rows (group g: expert g), each cut
// into `tiles` tiles of n rows (n in 8, 16, 32, 48, 64, 96, 128, 192;
// n <= 128 when gated; tiles * n >= R).  x (groups, R, M) -> h (2, groups, R, I) bf16,
// the hi and lo planes -> y (groups, R, M) bf16.  act: 1 gelu, 2 relu,
// 3 swiglu, 4 geglu.
inline cudaError_t run_ffn(const void* x, const void* w_up, const void* w_gate,
                           const void* w_down, int groups, int R, int E, int n, int tiles,
                           void* h, void* y, int M, int I, int act, cudaStream_t s) {
  if (groups == 0 || R == 0) return cudaSuccess;
  if (M % 8 || I % 8 || act < 1 || act > 4 || (long long)tiles * n < R ||
      (long long)groups * tiles > 65535)
    return cudaErrorInvalidValue;
#define GROUPED_FFN_SM90_N(NN)                                                                \
  case NN:                                                                                    \
    return run_tiles<NN>(x, w_up, w_gate, w_down, groups, R, E, tiles, h, y, M, I, act, s);
  switch (n) {
    GROUPED_FFN_SM90_N(8)
    GROUPED_FFN_SM90_N(16)
    GROUPED_FFN_SM90_N(32)
    GROUPED_FFN_SM90_N(48)
    GROUPED_FFN_SM90_N(64)
    GROUPED_FFN_SM90_N(96)
    GROUPED_FFN_SM90_N(128)
    GROUPED_FFN_SM90_N(192)
    default: return cudaErrorInvalidValue;
  }
#undef GROUPED_FFN_SM90_N
}

template <int N, int KIND>
cudaError_t launch_ragged_pass(const CUtensorMap& w, const CUtensorMap& wg, const CUtensorMap& b,
                               const CUtensorMap& blo, int* work, float* partial,
                               int partial_floats, int ctas, int nb, int bx, int K, int C,
                               int act, __nv_bfloat16* out, __nv_bfloat16* out_lo,
                               cudaStream_t s) {
  using T = Tile<N, KIND, kRaggedStages>;
  const cudaError_t err = cudaFuncSetAttribute(
      tc_ragged_pass_kernel<N, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  tc_ragged_pass_kernel<N, KIND><<<ctas, kThreads, T::kSmem, s>>>(
      w, wg, b, blo, work, partial, partial_floats, nb, bx, K, C, act, out, out_lo);
  return cudaGetLastError();
}

template <int N>
cudaError_t run_ragged_tiles(const void* x, const void* w_up, const void* w_gate,
                             const void* w_down, const int32_t* block_expert,
                             grouped_ffn::Tags tags, int* work, float* partial,
                             int partial_floats, int ctas, int rows, int bx, int E, void* h,
                             void* y, int M, int I, int act, cudaStream_t s) {
  const bool gated = act == grouped_ffn::kSwiglu || act == grouped_ffn::kGeglu;
  if (gated && N > 128) return cudaErrorInvalidValue;   // two accumulators must fit registers
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const int nb = rows / bx;
  const Segs sg(bx, N);
  if (sg.seg % 8 || bx % sg.seg || E > kSortExperts) return cudaErrorInvalidValue;
  __nv_bfloat16* hi = (__nv_bfloat16*)h;
  __nv_bfloat16* lo = hi + (size_t)rows * I;
  CUtensorMap mx, mup, mgate, mdown, mhi, mlo;
  if (!map3d(encode, &mx, kBF16, x, M, rows, 1, sg.seg) ||
      !map3d(encode, &mup, kBF16, w_up, I, M, E, kBK) ||
      !map3d(encode, &mgate, kBF16, gated ? w_gate : w_up, I, M, E, kBK) ||
      !map3d(encode, &mdown, kBF16, w_down, M, I, E, kBK) ||
      !map3d(encode, &mhi, kBF16, hi, I, rows, 1, sg.seg) ||
      !map3d(encode, &mlo, kBF16, lo, I, rows, 1, sg.seg))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)ragged_items(nb, bx, N) * (((I > M ? I : M) + kBC - 1) / kBC);
  work_list_kernel<<<1, kListThreads, 0, s>>>(block_expert, tags, nb, bx, N, E,
                                              (int)(tiles < ctas ? tiles : ctas), work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (N <= 128) {
    err = gated ? launch_ragged_pass<N, kUpGated>(mup, mgate, mx, mx, work, partial,
                                                  partial_floats, ctas, nb, bx, M, I, act, hi,
                                                  lo, s)
                : launch_ragged_pass<N, kUp>(mup, mup, mx, mx, work, partial, partial_floats,
                                             ctas, nb, bx, M, I, act, hi, lo, s);
  } else {
    err = launch_ragged_pass<N, kUp>(mup, mup, mx, mx, work, partial, partial_floats, ctas, nb,
                                     bx, M, I, act, hi, lo, s);
  }
  if (err != cudaSuccess) return err;
  return launch_ragged_pass<N, kDown>(mdown, mdown, mhi, mlo, work, partial, partial_floats,
                                      ctas, nb, bx, I, M, 0, (__nv_bfloat16*)y, nullptr, s);
}

// run_ragged_tiles<NN>'s signature, for the ragged library's explicit
// instantiations: its widest tiles compile in units of their own
// (ragged_ffn_n128.cu, ragged_ffn_n192.cu), declared extern in ragged_ffn.cu
#define GROUPED_FFN_SM90_RAGGED_TILES(NN)                                                     \
  cudaError_t run_ragged_tiles<NN>(const void*, const void*, const void*, const void*,       \
                                   const int32_t*, grouped_ffn::Tags, int*, float*, int, int, \
                                   int, int, int, void*, void*, int, int, int, cudaStream_t)

}  // namespace grouped_ffn_sm90

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
// with the products accumulated in f32 and y rounded to bf16 once.  The
// rows are a (G, R, K) array: ExpertRows is (E, X, M) with e(g) = g,
// RaggedRows is (N / bx, bx, M) with e(g) = block_expert[g].
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
// Grids: pass 1 (ceil(I / 128), G * tiles), pass 2 (ceil(M / 128),
// G * tiles), one CTA per output tile; blockIdx.x (the column tile) varies
// fastest, so the CTAs that read one group's rows run together and share
// them through L2.  At E = 32, X = 180 that is 1024 and 256 CTAs, one
// resident per SM (160 and 193 KB of stages).
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

template <int N, int KIND>
struct Tile {
  static constexpr int kA = (KIND == kUpGated ? 2 : 1) * kConsumers * kHalf;
  static constexpr int kBRow = N * kBK * 2;    // N token rows of 128 bytes
  static constexpr int kB = (KIND == kDown ? 2 : 1) * kBRow;   // pass 2: hi and lo
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = kSmemBudget / kStage < 4 ? kSmemBudget / kStage : 4;
  static constexpr int kSmem = kStages * kStage + 1024;   // + the 1024-byte alignment
  static_assert(kStages >= 2, "a stage ring needs two stages");
};

__device__ __forceinline__ float activate(int act, float u, float g) {
  using namespace grouped_ffn;
  switch (act) {
    case kGelu: return gelu_tanh(u);
    case kRelu: return fmaxf(u, 0.0f);
    case kSwiglu: return silu(g) * u;
    default: return gelu_tanh(g) * u;    // kGeglu
  }
}

// One pass.  wmap: the (E, K, C) weights; gmap: W_gate (kUpGated);
// bmap: the (G, R, K) rows (x, or h's hi plane); blomap: h's lo plane
// (kDown).  out (G*R, C): h's hi plane (kUp*) or y (kDown); out_lo: h's lo
// plane.  grid (ceil(C / 128), G * tiles).
template <int N, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
tc_pass_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap gmap,
               const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap blomap,
               const int32_t* __restrict__ group_expert, int tiles, int R, int K, int C, int act,
               __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ out_lo) {
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
      const int e = group_expert ? group_expert[g] : g;
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
// Host side: launches
// ---------------------------------------------------------------------------

template <int N, int KIND>
cudaError_t launch_pass(const CUtensorMap& w, const CUtensorMap& wg, const CUtensorMap& b,
                        const CUtensorMap& blo, const int32_t* group_expert, int groups,
                        int tiles, int R, int K, int C, int act, __nv_bfloat16* out,
                        __nv_bfloat16* out_lo, cudaStream_t s) {
  using T = Tile<N, KIND>;
  const cudaError_t err = cudaFuncSetAttribute(
      tc_pass_kernel<N, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kBC - 1) / kBC, groups * tiles);
  tc_pass_kernel<N, KIND><<<grid, kThreads, T::kSmem, s>>>(w, wg, b, blo, group_expert, tiles, R,
                                                          K, C, act, out, out_lo);
  return cudaGetLastError();
}

template <int N>
cudaError_t run_tiles(const void* x, const void* w_up, const void* w_gate, const void* w_down,
                      const int32_t* group_expert, int groups, int R, int E, int tiles, void* h,
                      void* y, int M, int I, int act, cudaStream_t s) {
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
    err = gated ? launch_pass<N, kUpGated>(mup, mgate, mx, mx, group_expert, groups, tiles, R, M,
                                           I, act, hi, lo, s)
                : launch_pass<N, kUp>(mup, mup, mx, mx, group_expert, groups, tiles, R, M, I,
                                      act, hi, lo, s);
  } else {
    err = launch_pass<N, kUp>(mup, mup, mx, mx, group_expert, groups, tiles, R, M, I, act, hi, lo,
                              s);
  }
  if (err != cudaSuccess) return err;
  return launch_pass<N, kDown>(mdown, mdown, mhi, mlo, group_expert, groups, tiles, R, I, M, 0,
                               (__nv_bfloat16*)y, nullptr, s);
}

// Both passes over `groups` groups of R rows (group g: expert
// group_expert[g], or g when group_expert is null), each cut into `tiles`
// tiles of n rows (n in 8, 16, 32, 48, 64, 96, 128, 192; n <= 128 when
// gated; tiles * n >= R).  x (groups, R, M) -> h (2, groups, R, I) bf16,
// the hi and lo planes -> y (groups, R, M) bf16.  act: 1 gelu, 2 relu,
// 3 swiglu, 4 geglu.
inline cudaError_t run_ffn(const void* x, const void* w_up, const void* w_gate,
                           const void* w_down, const int32_t* group_expert, int groups, int R,
                           int E, int n, int tiles, void* h, void* y, int M, int I, int act,
                           cudaStream_t s) {
  if (groups == 0 || R == 0) return cudaSuccess;
  if (M % 8 || I % 8 || act < 1 || act > 4 || (long long)tiles * n < R ||
      (long long)groups * tiles > 65535)
    return cudaErrorInvalidValue;
#define GROUPED_FFN_SM90_N(NN)                                                                \
  case NN:                                                                                    \
    return run_tiles<NN>(x, w_up, w_gate, w_down, group_expert, groups, R, E, tiles, h, y, M, \
                         I, act, s);
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

}  // namespace grouped_ffn_sm90

// Flash attention forward on Hopper's tensor cores (sm_90a), for
// flash_attention.cu's entry point flash_attention_tc: the route for bf16
// with D in (64, 128).  f32, and D in (16, 32), stay on the CUDA-core
// kernel in flash_attention.cu.
//
// Replaces (with flash_attention.cu): src/repro/kernels/flash_attention/
// kernel.py flash_attention_kernel.  In the public (B, S, H, D) layout,
// query head h reading kv head h / G (G = Hq / Hkv):
//   o[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h/G] * D^-0.5) @ v[b, t, h/G]
// with an f32 online softmax, the reference's finite -1e30 mask (causal:
// t <= s), the output acc / max(l, 1e-30) rounded to bf16 once.  Any S.
//
// What bounds it: at the m6-base training shape (B = 8, S = 144, H = 16,
// D = 64, causal) q, k, v and o are 2.36 MB each against 0.34 GFLOP: bytes,
// 2.8 us at 3.35 TB/s.  The design reads each input once per CTA with TMA,
// keeps scores and probabilities in registers, and runs both products on the
// tensor cores, so that the time goes to the loads.
//
// Design.  One CTA of one warpgroup per (64 query rows, head, batch): 64
// rows are wgmma's M, and a small CTA (128 threads, 41 KB of shared memory
// at D = 64) lets 4 share an SM.
// - Thread 0 issues TMA loads over 4-D maps of the (B, S, H, D) tensors
//   themselves, boxes of 64 positions x 64 columns (two boxes for D = 128)
//   with the 128-byte swizzle: the Q tile once, then the K and V tiles of
//   64 keys through a ring of two stages, each stage refilled as soon as
//   every warp has finished with it.  K and V land on barriers of their own
//   (mbarriers count the bytes), so the scores start before V is in.
//   Positions past S read as zeros.  (On an H100, a producer warp measured
//   no faster at S = 144 and 13 % slower at S = 256: its registers cost the
//   SM its fourth CTA.  A ring of four stages, all of S = 256 in flight,
//   was 13 % slower too: three CTAs an SM.)
// - The grid is (Hq, B, query tiles) with the last query tile first: under
//   a causal mask it has the most KV tiles, and launched first the long
//   CTAs do not form the tail.
// - S = Q K^T: one m64n64k16 wgmma per 16 columns of D, both operands
//   K-major in shared memory.  The softmax runs on the f32 accumulator in
//   registers, in base 2 (log2 e folded into the scale, exp2f): each thread
//   holds 16 scores of two rows; a row's max and sum take two shuffles
//   across the 4 threads that share it (the sum only once, at the end).
// - O += P V: the 16-key slices of the score accumulator are, register for
//   register, the A fragments of a k16 wgmma, so P goes from registers
//   (RS form) against V, MN-major in shared memory; D = 128 runs two
//   64-column products.  P is split into bf16 hi = bf16(p) and
//   lo = bf16(p - hi), two wgmmas per slice into one f32 accumulator, so P
//   keeps about 16 bits and only the f32 summation order differs from an
//   f32 P V (flash_attention/ref.py attention_split_ref is this numerics).
// - Causal: KV tiles wholly above the diagonal are skipped, only the
//   diagonal tile and the ragged last tile are masked.
// - Epilogue: O / max(l, 1e-30) in bf16 into the Q tile (in the same
//   swizzled layout), then a TMA store, which drops rows past S.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "wgmma_bf16.cuh"

namespace flash_sm90 {

using namespace sm90;

constexpr int kRows = 64;               // query rows of a CTA: one consumer warpgroup (wgmma M)
constexpr int kKeys = 64;               // keys per KV tile (N of the score product)
constexpr int kBox = 64 * 128;          // one box: 64 positions of 64 bf16 columns, 8 KB
constexpr int kStages = 2;
constexpr int kThreads = 128;           // one warpgroup
constexpr float kNegInf = -1e30f;       // the TPU kernel's finite mask value

template <int D>
struct Layout {
  static constexpr int kParts = D / 64;                 // 64-column boxes per position
  static constexpr int kTile = kParts * kBox;           // 64 positions of Q, K or V
  static constexpr int kStage = 2 * kTile;              // K, then V
  static constexpr int kSmem = (1 + kStages * 2) * kTile + 1024;   // Q, the ring; alignment
  // CTAs an SM should hold (the register budget ptxas works to): D = 64,
  // 4 (at most 128 registers a thread; 41 KB of shared memory each), so the
  // m6 grid at S = 256 (512 CTAs) runs in one wave on 132 SMs
  static constexpr int kMinBlocks = D == 64 ? 4 : 2;
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// K and V of KV tile kt into stage kt % kStages, K first, each on its own
// barrier (the scores need only K)
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* kv, uint64_t* kfull, uint64_t* vfull,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap, int kt,
                                        int hk, int b) {
  using L = Layout<D>;
  const int s = kt % kStages;
  uint8_t* st = kv + s * L::kStage;
  mbar_expect_tx(&kfull[s], L::kTile);
#pragma unroll
  for (int p = 0; p < L::kParts; ++p)
    tma_load_4d(st + p * kBox, kmap, &kfull[s], 64 * p, hk, kt * kKeys, b);
  mbar_expect_tx(&vfull[s], L::kTile);
#pragma unroll
  for (int p = 0; p < L::kParts; ++p)
    tma_load_4d(st + L::kTile + p * kBox, vmap, &vfull[s], 64 * p, hk, kt * kKeys, b);
}

// grid (Hq, B, query tiles): the query tiles with the most KV tiles (causal:
// the last) are launched first, so that the short ones fill the tail
template <int D>
__global__ void __launch_bounds__(kThreads, Layout<D>::kMinBlocks)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                int S, int G, int causal, float scale_log2) {
  using L = Layout<D>;
  constexpr int P = L::kParts;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qfull, kfull[kStages], vfull[kStages];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                   // the Q tile, P boxes
  uint8_t* kv = smem + L::kTile;        // stage s: K boxes [0, P), V boxes [P, 2P)

  const int h = blockIdx.x, b = blockIdx.y, hk = h / G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  // KV tiles: causal, up to the one holding the diagonal of the last row
  const int n_tiles = causal ? (min(S, q0 + kRows) - 1) / kKeys + 1 : (S + kKeys - 1) / kKeys;
  const int tid = threadIdx.x;
  if (tid == 0) {                       // thread 0 loads: Q, and the first KV tiles
    mbar_init(&qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&qfull, L::kTile);
#pragma unroll
    for (int p = 0; p < P; ++p) tma_load_4d(qs + p * kBox, &qmap, &qfull, 64 * p, h, q0, b);
    for (int kt = 0; kt < min(n_tiles, kStages); ++kt)
      load_kv<D>(kv, kfull, vfull, &kmap, &vmap, kt, hk, b);
  }
  __syncthreads();

  // this thread holds rows q0 + rl and q0 + rl + 8 (rl = 16 warp + lane / 4)
  // of every accumulator
  const int warp = tid / 32, lane = tid % 32;
  const int rl = 16 * warp + lane / 4;

  float o[P][32];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  mbar_wait(&qfull, 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&kfull[s], (kt / kStages) & 1);
    const uint8_t* ks = kv + s * L::kStage;
    const uint8_t* vs = ks + L::kTile;
    // S = Q K^T: one m64n64k16 wgmma per 16 columns of D, 32 bytes of a
    // 128-byte row, both operands K-major
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<64>::mma_kk(sc, sw128_desc(qs + (kk / 4) * kBox + (kk % 4) * 32),
                        sw128_desc(ks + (kk / 4) * kBox + (kk % 4) * 32));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // score i: row q0 + rl + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2;
    // only the diagonal tile (causal) and the ragged last tile are masked
    const int k0 = kt * kKeys;
    const bool edge = k0 + kKeys > S || (causal && k0 + kKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int row = q0 + rl + 8 * ((i / 2) % 2);
        if (key >= S || (causal && key > row)) x = kNegInf;
      }
      sc[i] = x;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i / 2) % 2];

    // p = exp2(x - m) as bf16 hi + lo pairs: pair j (scores 2j, 2j + 1, row
    // j % 2) is register j % 4 of the A fragment of keys 16 (j / 4) .. + 15
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = exp2f(sc[2 * j] - m[j % 2]);
      const float p1 = exp2f(sc[2 * j + 1] - m[j % 2]);
      l[j % 2] += p0 + p1;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
      hi[j / 4][j % 4] = bf16x2_bits(h2);
      lo[j / 4][j % 4] =
          bf16x2_bits(__floats2bfloat162_rn(p0 - __low2float(h2), p1 - __high2float(h2)));
    }
#pragma unroll
    for (int p = 0; p < P; ++p) fence_regs(o[p]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
    mbar_wait(&vfull[s], (kt / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)         // keys 16 j .. 16 j + 15: 16 rows of 128 bytes of V
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint64_t dv = sw128_desc(vs + p * kBox + j * 16 * 128);
        Wgmma<64>::mma_rs(o[p], hi[j], dv);
        Wgmma<64>::mma_rs(o[p], lo[j], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < P; ++p) fence_regs(o[p]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {       // the A registers stay untouched until here
      fence_regs(hi[j]);
      fence_regs(lo[j]);
    }
    if (kt + kStages < n_tiles) {       // every warp is done with stage s: refill it
      __syncthreads();
      if (tid == 0) load_kv<D>(kv, kfull, vfull, &kmap, &vmap, kt + kStages, hk, b);
    }
  }

  // epilogue: the row sums across the 4 threads of a row, then O / l in bf16
  // into the Q tile (its last read completed above), in the 128-byte swizzle
  // (16-byte chunk c of row r at chunk c ^ (r % 8)), and a TMA store of the
  // tile, which drops rows past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = rl + 8 * (j % 2), chunk = j / 2;
      const float d = l[j % 2];
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[p][2 * j] / d, o[p][2 * j + 1] / d);
      *reinterpret_cast<__nv_bfloat162*>(qs + p * kBox + r * 128 + ((chunk ^ (r % 8)) << 4) +
                                         4 * (lane % 4)) = v;
    }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) tma_store_4d(&omap, qs + p * kBox, 64 * p, h, q0, b);
    tma_store_wait();
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                   const CUtensorMap& o, int B, int S, int Hq, int G, int causal, float scale_log2,
                   cudaStream_t st) {
  using L = Layout<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + kRows - 1) / kRows);
  flash_tc_kernel<D><<<grid, kThreads, L::kSmem, st>>>(q, k, v, o, S, G, causal, scale_log2);
  return cudaGetLastError();
}

// q/o (B, S, Hq, D), k/v (B, S, Hkv, D) bf16, contiguous and 16-byte
// aligned; D in (64, 128); Hq % Hkv == 0.
inline cudaError_t run(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int Hq, int Hkv, int D, int causal, cudaStream_t st) {
  if (B == 0 || S == 0) return cudaSuccess;
  if ((D != 64 && D != 128) || Hkv <= 0 || Hq % Hkv || B > 65535 ||
      (S + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorMisalignedAddress;                       // TMA needs 16-byte addresses
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv, mo;
  if (!map4d(encode, &mq, kBF16, q, D, Hq, S, B, kRows) ||
      !map4d(encode, &mk, kBF16, k, D, Hkv, S, B, kKeys) ||
      !map4d(encode, &mv, kBF16, v, D, Hkv, S, B, kKeys) ||
      !map4d(encode, &mo, kBF16, o, D, Hq, S, B, kRows))
    return cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const int G = Hq / Hkv;
  return D == 64 ? launch<64>(mq, mk, mv, mo, B, S, Hq, G, causal, scale_log2, st)
                 : launch<128>(mq, mk, mv, mo, B, S, Hq, G, causal, scale_log2, st);
}

}  // namespace flash_sm90

// Device code shared by the decode attention kernels (through
// decode_sm90.cuh, which reads the K/V rows from shared memory and holds the
// int8 / e4m3 code formats): the bf16 / f32 element formats, vector loads,
// q loads and the online-softmax state of the row-parallel warp layout.
//
// Layout.  One CTA per (query row, kv head), kWarps warps, each keeping its
// own online-softmax state (m, l, acc) for the G grouped query heads, merged
// once through shared memory at the end.  Inside a warp, TPR = D / VEC
// lanes share one K/V token row, each holding VEC contiguous dims, so one
// pass of the warp reads RPW = 32 / LANES token rows (LANES = TPR rounded up
// to a power of two) with one vector load per lane (16 bytes where the
// registers allow it: VEC * G <= 32 keeps q and acc at 2 * G * VEC floats
// per lane).  A token's score is summed over its LANES lanes with
// shuffles; the running max is warp-wide, so every lane rescales by the
// same alpha, and the rows' partial l and acc are summed at the end.  A
// width that is no power of two (D = 224: 28 lanes of 8) leaves the row's
// last LANES - TPR lanes idle: they hold zeros, so the shuffles' sums and
// the merges are unchanged.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace decode {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;

// The largest power of two <= n (n >= 1).
__host__ __device__ constexpr int floor_pow2(int n) { return n < 2 ? 1 : 2 * floor_pow2(n / 2); }
// The smallest power of two >= n (n >= 1).
__host__ __device__ constexpr int ceil_pow2(int n) { return n < 2 ? 1 : 2 * ceil_pow2((n + 1) / 2); }

// VEC elements per lane: 16 bytes of the element, at most 32 / G (registers)
// rounded down to a power of two (G = 3 and 5 give 10 and 6, which are no
// vector width and do not divide D), but at least D / 32 rounded up to a
// power of two, so that a row fits one warp (D = 224 in f32: 8 elements, two
// 16-byte loads), and at most D.
template <int ELEM_BYTES, int G, int D>
__host__ __device__ constexpr int vec_elems() {
  constexpr int by_bytes = 16 / ELEM_BYTES;
  constexpr int by_regs = floor_pow2(32 / G);
  constexpr int by_warp = ceil_pow2((D + 31) / 32);
  constexpr int v0 = by_bytes < by_regs ? by_bytes : by_regs;
  constexpr int v = v0 > by_warp ? v0 : by_warp;
  return v < D ? v : D;
}

// Element formats: how one 32-bit word of a vector load decodes to f32.
struct FmtF32 {
  using T = float;
  static constexpr int kPerWord = 1;
  __device__ static void dec(uint32_t w, float* o) { o[0] = __uint_as_float(w); }
};
struct FmtBF16 {
  using T = __nv_bfloat16;
  static constexpr int kPerWord = 2;
  __device__ static void dec(uint32_t w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };

// VEC consecutive elements at p (aligned to one load's byte count) -> f32:
// one vector load of 4, 8 or 16 bytes, or several of 16.
template <typename Fmt, int VEC>
__device__ __forceinline__ void load_vec(const typename Fmt::T* p, float* out) {
  constexpr int kBytes = VEC * (int)sizeof(typename Fmt::T);
  constexpr int kLoad = kBytes < 16 ? kBytes : 16;
  static_assert(kLoad == 4 || kLoad == 8 || (kLoad == 16 && kBytes % 16 == 0),
                "vector loads of 4, 8 or 16 bytes");
  using R = typename Raw<kLoad>::type;
#pragma unroll
  for (int c = 0; c < kBytes / kLoad; ++c) {
    const R r = reinterpret_cast<const R*>(p)[c];
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int j = 0; j < kLoad / 4; ++j) Fmt::dec(w[j], out + (c * (kLoad / 4) + j) * Fmt::kPerWord);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// Per-lane online-softmax state over the lane's VEC dims.
template <int G, int VEC>
struct State {
  float m[G], l[G], acc[G][VEC];

  __device__ void init() {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNegInf;
      l[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] = 0.0f;
    }
  }
};

// q (G, D) of this CTA, pre-scaled, into the lane's VEC dims.
template <typename TQ, int G, int VEC, int D>
__device__ __forceinline__ void load_q(const TQ* qp, int d0, float scale, float (&qr)[G][VEC]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) qr[g][i] = to_f32(qp[g * D + d0 + i]) * scale;
}

template <typename TO>
__device__ __forceinline__ void store_zero(TO* o, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) from_f32(0.0f, o + e);
}

}  // namespace decode

// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//           paged_decode_attention_kernel (the Pallas TPU kernel, _paged_kernel).
//
// What it computes: one query per row i and kv head h, G grouped query
// heads, attending to positions [0, lengths[i]) of the row's context read
// through its block table:
//   out[i, h, g] = softmax(q[i, h, g] . K^T * D^-0.5) V
// with K/V rows at pool[(tables[i, p / bs], h, p % bs)].  A row of length 0
// writes exactly 0 (acc / max(l, 1e-30) with acc = l = 0), like the
// reference's finite NEG_INF mask.
//
// What bounds it on this card: bytes.  Each (row, head) streams
// 2 * length * D * sizeof(T) bytes of K/V and does ~4 * G * D flops per
// position — far below the H100's 295 flop/byte ridge, so the only limit
// is how many K/V bytes are in flight.
//
// Design: one CTA per (row, kv head), 4 warps.  The TPU kernel carried the
// online-softmax state across the sequential block axis of its grid; here
// that axis is a loop inside the CTA, split over the 4 warps (warp w takes
// KV blocks w, w+4, ...), each keeping its own (m, l, acc) state in
// registers, merged once through shared memory at the end (flash-decoding
// within one CTA).  A lane owns VPT = D/32 contiguous dims of q, K, V and
// acc, so a warp reads one K or V row as one contiguous 32*VPT*sizeof(T)
// transaction; CH tokens are loaded before their scores are reduced, so CH
// independent row loads are in flight per warp.  Positions past the length
// get score NEG_INF and are neither loaded nor accumulated.  All math is
// f32 from bf16 (or f32) inputs; no tensor cores: the work is bytes-bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kChunk = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int G, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int32_t* __restrict__ tables,
                              const int32_t* __restrict__ lengths, T* __restrict__ out,
                              int Hkv, int bs, int MB, float scale) {
  constexpr int D = 32 * VPT;
  const int i = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * VPT;
  const int length = lengths[i];
  T* o = out + ((size_t)i * Hkv + h) * G * D;

  if (length <= 0) {
    for (int e = threadIdx.x; e < G * D; e += blockDim.x) from_f32(0.0f, o + e);
    return;
  }

  float qr[G][VPT], acc[G][VPT], m[G], l[G];
  const T* qp = q + ((size_t)i * Hkv + h) * G * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      qr[g][v] = to_f32(qp[g * D + d0 + v]) * scale;
      acc[g][v] = 0.0f;
    }
  }

  int nb = (length + bs - 1) / bs;
  if (nb > MB) nb = MB;
  const int32_t* table = tables + (size_t)i * MB;
  for (int b = warp; b < nb; b += kWarps) {
    const size_t blk = ((size_t)table[b] * Hkv + h) * bs;
    for (int t0 = 0; t0 < bs; t0 += kChunk) {
      float kr[kChunk][VPT];
      bool live[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int t = t0 + c;
        live[c] = t < bs && b * bs + t < length;
        const T* kp = k_pool + (blk + t) * D + d0;
#pragma unroll
        for (int v = 0; v < VPT; ++v) kr[c][v] = live[c] ? to_f32(kp[v]) : 0.0f;
      }
      float p[G][kChunk];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          float s = 0.0f;
#pragma unroll
          for (int v = 0; v < VPT; ++v) s += qr[g][v] * kr[c][v];
          s = warp_sum(s);
          p[g][c] = live[c] ? s : kNegInf;
          mx = fmaxf(mx, p[g][c]);
        }
        const float alpha = expf(m[g] - mx);
        float lsum = 0.0f;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          p[g][c] = live[c] ? expf(p[g][c] - mx) : 0.0f;
          lsum += p[g][c];
        }
        l[g] = l[g] * alpha + lsum;
        m[g] = mx;
#pragma unroll
        for (int v = 0; v < VPT; ++v) acc[g][v] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (!live[c]) continue;
        const T* vp = v_pool + (blk + t0 + c) * D + d0;
        float vr[VPT];
#pragma unroll
        for (int v = 0; v < VPT; ++v) vr[v] = to_f32(vp[v]);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int v = 0; v < VPT; ++v) acc[g][v] += p[g][c] * vr[v];
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) sm_acc[warp][g][d0 + v] = acc[g][v];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w][g]);
    float lt = 0.0f, at = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mt);
      lt += sm_l[w][g] * f;
      at += sm_acc[w][g][d] * f;
    }
    from_f32(at / fmaxf(lt, 1e-30f), o + e);
  }
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* kp, const void* vp, const int32_t* tbl,
                     const int32_t* len, void* out, int N, int Hkv, int D, int bs, int MB,
                     cudaStream_t stream) {
  dim3 grid(N, Hkv), block(kWarps * 32);
  const float scale = 1.0f / sqrtf((float)D);
#define REPRO_PDA_LAUNCH(VPT)                                                        \
  paged_decode_attention_kernel<T, G, VPT><<<grid, block, 0, stream>>>(              \
      (const T*)q, (const T*)kp, (const T*)vp, tbl, len, (T*)out, Hkv, bs, MB, scale)
  switch (D) {
    case 32: REPRO_PDA_LAUNCH(1); break;
    case 64: REPRO_PDA_LAUNCH(2); break;
    case 128: REPRO_PDA_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PDA_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int32_t* tbl,
                   const int32_t* len, void* out, int N, int Hkv, int G, int D, int bs,
                   int MB, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  switch (G) {
    case 1: return launch_g<T, 1>(q, kp, vp, tbl, len, out, N, Hkv, D, bs, MB, stream);
    case 2: return launch_g<T, 2>(q, kp, vp, tbl, len, out, N, Hkv, D, bs, MB, stream);
    case 4: return launch_g<T, 4>(q, kp, vp, tbl, len, out, N, Hkv, D, bs, MB, stream);
    case 8: return launch_g<T, 8>(q, kp, vp, tbl, len, out, N, Hkv, D, bs, MB, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  Returns a cudaError_t (0 = success).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out, int N, int Hkv,
                                      int G, int D, int bs, int MB, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* tbl = (const int32_t*)tables;
  const int32_t* len = (const int32_t*)lengths;
  if (dtype == 0)
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, tbl, len, out, N, Hkv, G, D, bs,
                                      MB, s);
  if (dtype == 1)
    return (int)launch<float>(q, k_pool, v_pool, tbl, len, out, N, Hkv, G, D, bs, MB, s);
  return (int)cudaErrorInvalidValue;
}

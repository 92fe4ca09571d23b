// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py flash_attention_kernel
//           (the Pallas TPU kernel, grid (B, Hq, S/bq, S/bkv) with the KV axis
//           sequential and the running max, denominator and accumulator in
//           VMEM scratch).
//
// What it computes: causal or full GQA attention in the public (B, S, H, D)
// layout, query head h reading kv head h / (Hq / Hkv):
//   o[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h/G] * D^-0.5) @ v[b, t, h/G]
// with an f32 online softmax, the output divided by max(l, 1e-30) and
// rounded to the input type once.  Causal rows attend to t <= s.
//
// What bounds it on this card: at the m6-base training shape (B = 8,
// S = 144, H = 16, D = 64, causal) a call moves 4 x 2.4 MB (q, k, v, o in
// bf16) and does ~0.2 GFLOP: bytes, about 3 us at 3.35 TB/s.  At that size
// the launch and the serial key loop dominate.
//
// Design: one CTA of 128 threads per (query tile, head, batch) with a loop
// over KV tiles of 32 keys in place of the TPU grid's sequential axis.
// TPR = max(1, D/32) threads share a query row, each holding D/TPR of its
// dims of q (pre-scaled, as the TPU kernel scales q) and of the f32
// accumulator in registers; the row's dot product is summed across them with
// warp shuffles.  K and V tiles are staged in shared memory as f32, each
// row's TPR parts padded by one float so the parts fall in distinct banks.
// For causal attention, KV tiles wholly above the tile's last query row are
// skipped, as the TPU kernel skips blocks above the diagonal; inside a tile
// every thread walks the same keys (so the shuffles stay converged) and a
// key past the row's diagonal or past S is left out of the softmax, which
// is what the TPU kernel's finite -1e30 mask amounts to.  Any S: the last
// query tile and KV tile are masked instead of requiring S to divide.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBkv = 32;           // keys per KV tile
constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int Hq, int Hkv, int causal, float scale) {
  constexpr int kTpr = D <= 32 ? 1 : D / 32;     // threads per query row
  constexpr int kDpt = D / kTpr;                 // dims per thread
  constexpr int kBq = kThreads / kTpr;           // query rows per CTA
  constexpr int kStride = kTpr * (kDpt + 1);     // padded shared row
  __shared__ float Ks[kBkv][kStride];
  __shared__ float Vs[kBkv][kStride];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int part = tid % kTpr;
  const int s = q0 + tid / kTpr;
  const bool live = s < S;

  float qr[kDpt], acc[kDpt];
  const T* qrow = q + ((size_t)(b * S + (live ? s : 0)) * Hq + h) * D + part * kDpt;
#pragma unroll
  for (int d = 0; d < kDpt; ++d) {
    qr[d] = live ? to_f32(qrow[d]) * scale : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  const int kv_end = causal ? min(S, q0 + kBq) : S;   // tiles above the diagonal skipped
  for (int k0 = 0; k0 < kv_end; k0 += kBkv) {
    __syncthreads();                                   // tile reuse
    for (int idx = tid; idx < kBkv * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, key = k0 + j;
      const int col = (d / kDpt) * (kDpt + 1) + d % kDpt;
      const size_t off = ((size_t)(b * S + key) * Hkv + hk) * D + d;
      Ks[j][col] = key < S ? to_f32(k[off]) : 0.0f;
      Vs[j][col] = key < S ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();
    const int nk = min(kBkv, S - k0);
    for (int j = 0; j < nk; ++j) {
      const float* kr = &Ks[j][part * (kDpt + 1)];
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < kDpt; ++d) dot = fmaf(qr[d], kr[d], dot);
#pragma unroll
      for (int off = 1; off < kTpr; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (causal && k0 + j > s) continue;              // masked: weight exactly 0
      if (dot > m) {                                   // new running max: rescale
        const float alpha = expf(m - dot);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < kDpt; ++d) acc[d] *= alpha;
        m = dot;
      }
      const float p = expf(dot - m);
      l += p;
      const float* vr = &Vs[j][part * (kDpt + 1)];
#pragma unroll
      for (int d = 0; d < kDpt; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
  }
  if (!live) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* orow = o + ((size_t)(b * S + s) * Hq + h) * D + part * kDpt;
#pragma unroll
  for (int d = 0; d < kDpt; ++d) from_f32(acc[d] * inv, orow + d);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
                int Hkv, int D, int causal, cudaStream_t st) {
  if (B == 0 || S == 0) return cudaSuccess;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int tpr = D <= 32 ? 1 : D / 32;
  const int bq = kThreads / tpr;
  const dim3 grid((S + bq - 1) / bq, Hq, B);
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  T* ot = (T*)o;
  switch (D) {
    case 16: flash_fwd_kernel<T, 16><<<grid, kThreads, 0, st>>>(qt, kt, vt, ot, S, Hq, Hkv, causal, scale); break;
    case 32: flash_fwd_kernel<T, 32><<<grid, kThreads, 0, st>>>(qt, kt, vt, ot, S, Hq, Hkv, causal, scale); break;
    case 64: flash_fwd_kernel<T, 64><<<grid, kThreads, 0, st>>>(qt, kt, vt, ot, S, Hq, Hkv, causal, scale); break;
    case 128: flash_fwd_kernel<T, 128><<<grid, kThreads, 0, st>>>(qt, kt, vt, ot, S, Hq, Hkv, causal, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  q/o (B, S, Hq, D), k/v (B, S, Hkv, D),
// contiguous; D in (16, 32, 64, 128); Hq % Hkv == 0.  Returns a cudaError_t.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                               int B, int S, int Hq, int Hkv, int D, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)run<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, D, causal, st);
  if (dtype == 1) return (int)run<float>(q, k, v, o, B, S, Hq, Hkv, D, causal, st);
  return (int)cudaErrorInvalidValue;
}

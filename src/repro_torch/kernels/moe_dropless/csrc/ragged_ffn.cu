// Ragged grouped expert FFN for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/moe_dropless/kernel.py ragged_ffn_kernel
//           (the Pallas TPU kernel with the scalar-prefetched block_expert).
//
// What it computes: x (N, M) holds expert-sorted token rows, block-padded
// so that every block of bx rows belongs to one expert, block_expert[N/bx];
//   y[r] = act(x[r] @ W_up[e] [, x[r] @ W_gate[e]]) @ W_down[e],  e = block_expert[r/bx]
// for every row, including the trailing padding blocks the routing layout
// clips to expert E-1, exactly as the reference does (every row stays finite).
//
// What bounds it on this card: bytes at the serving shapes.  A decode step
// routes 8 or 40 choices into blocks of 8 rows, so each weight element read
// from memory is used for at most 8 rows: ~8 flops per 2-byte bf16 weight,
// far below the 295 flop/byte ridge.  The least time is the bytes of the
// distinct experts' W_up and W_down over 3.35 TB/s.
//
// Design: the TPU kernel kept a (bx, M) f32 accumulator in VMEM across the I
// tiles; at M = 1024, bx = 128 that is 512 KB, more than a CTA's 227 KB of
// shared memory.  So the FFN runs as two grouped passes keyed by
// block_expert, with the intermediate h kept in f32 (as the reference keeps
// it) in an (N, I) scratch the wrapper allocates:
//   pass 1: h = act(x @ W_up[e] [, x @ W_gate[e]])   (f32 out)
//   pass 2: y = h @ W_down[e]                         (rounded to T once)
// Both passes are one kernel template: a CTA takes 8 rows (a chunk inside one
// expert block, since bx is a multiple of 8) and 128 output columns.  Its 256
// threads split the 128 columns 16 ways (8 contiguous columns each, one
// 16-byte bf16 load per weight row) and the reduction dimension 16 ways; each
// weight element loaded is used for all 8 rows from registers, the 8 input
// rows sit in shared memory as f32, and the 16 partial sums per output are
// added through shared memory.  The math is f32 FMA on the CUDA cores: no
// bf16 rounding of h, which tensor cores would need, so the numbers are the
// reference's up to summation order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;      // rows per CTA
constexpr int kCols = 128;    // output columns per CTA
constexpr int kColT = 16;     // threads across the columns (8 columns each)
constexpr int kRedT = 16;     // threads across the reduction dimension
constexpr int kKc = 512;      // reduction chunk staged in shared memory
constexpr int kThreads = kColT * kRedT;

enum Act { kNone = 0, kGelu = 1, kRelu = 2, kSwiglu = 3, kGeglu = 4 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// jax.nn.gelu's default (tanh) form
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// 8 consecutive weights starting at p (16-byte aligned for bf16, 32 for f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float w[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    w[2 * j] = f.x;
    w[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float w[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// out[r, c] = act(sum_k A[r, k] W[e][k, c] [, gate sum]) for the CTA's 8 rows.
template <typename TA, typename TW, typename TO, int ACT>
__global__ void __launch_bounds__(kThreads)
grouped_rows_kernel(const TA* __restrict__ A, const TW* __restrict__ W,
                    const TW* __restrict__ Wg, const int32_t* __restrict__ block_expert,
                    TO* __restrict__ out, int K, int C, int bx) {
  constexpr bool kGated = ACT == kSwiglu || ACT == kGeglu;
  __shared__ float As[kRows][kKc];
  __shared__ float red[kRedT][kCols];
  __shared__ float redg[kRedT][kCols];

  const int tid = threadIdx.x;
  const int tx = tid % kColT;           // column group
  const int ty = tid / kColT;           // reduction group
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kCols + tx * 8;
  const bool col_ok = c0 < C;           // C % 8 == 0: a group is all in or all out
  const int e = block_expert[r0 / bx];
  const TW* Wb = W + (size_t)e * K * C + c0;
  const TW* Wgb = kGated ? Wg + (size_t)e * K * C + c0 : nullptr;

  float acc[kRows][8], accg[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = accg[r][j] = 0.0f;

  for (int kc = 0; kc < K; kc += kKc) {
    const int klen = min(kKc, K - kc);
    __syncthreads();                    // As reuse across chunks
    for (int idx = tid; idx < kRows * klen; idx += kThreads) {
      const int r = idx / klen, k = idx % klen;
      As[r][k] = to_f32(A[(size_t)(r0 + r) * K + kc + k]);
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 4
      for (int k = ty; k < klen; k += kRedT) {
        float w[8];
        load8(Wb + (size_t)(kc + k) * C, w);
        float wg[8];
        if (kGated) load8(Wgb + (size_t)(kc + k) * C, wg);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float a = As[r][k];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a, w[j], acc[r][j]);
          if (kGated) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              accg[r][j] = fmaf(a, wg[j], accg[r][j]);
          }
        }
      }
    }
  }

  // add the kRedT partial sums of each output, one row at a time
  for (int r = 0; r < kRows; ++r) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[ty][tx * 8 + j] = acc[r][j];
      if (kGated) redg[ty][tx * 8 + j] = accg[r][j];
    }
    __syncthreads();
    if (tid < kCols) {
      const int c = blockIdx.x * kCols + tid;
      if (c < C) {
        float s = 0.0f, sg = 0.0f;
#pragma unroll
        for (int t = 0; t < kRedT; ++t) {
          s += red[t][tid];
          if (kGated) sg += redg[t][tid];
        }
        float v = s;
        if (ACT == kGelu) v = gelu_tanh(s);
        if (ACT == kRelu) v = fmaxf(s, 0.0f);
        if (ACT == kSwiglu) v = silu(sg) * s;
        if (ACT == kGeglu) v = gelu_tanh(sg) * s;
        from_f32(v, out + (size_t)(r0 + r) * C + c);
      }
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const void* w_up, const void* w_gate, const void* w_down,
                const int32_t* be, float* h, void* y, int N, int M, int I, int bx, int act,
                cudaStream_t s) {
  if (N == 0) return cudaSuccess;
  const dim3 block(kThreads);
  const dim3 g1((I + kCols - 1) / kCols, N / kRows), g2((M + kCols - 1) / kCols, N / kRows);
  const T* xt = (const T*)x;
  const T* up = (const T*)w_up;
  const T* gt = (const T*)w_gate;
  switch (act) {
    case kGelu: grouped_rows_kernel<T, T, float, kGelu><<<g1, block, 0, s>>>(xt, up, nullptr, be, h, M, I, bx); break;
    case kRelu: grouped_rows_kernel<T, T, float, kRelu><<<g1, block, 0, s>>>(xt, up, nullptr, be, h, M, I, bx); break;
    case kSwiglu: grouped_rows_kernel<T, T, float, kSwiglu><<<g1, block, 0, s>>>(xt, up, gt, be, h, M, I, bx); break;
    case kGeglu: grouped_rows_kernel<T, T, float, kGeglu><<<g1, block, 0, s>>>(xt, up, gt, be, h, M, I, bx); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grouped_rows_kernel<float, T, T, kNone><<<g2, block, 0, s>>>(
      h, (const T*)w_down, nullptr, be, (T*)y, I, M, bx);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  act: 1 gelu, 2 relu, 3 swiglu, 4 geglu
// (3 and 4 read w_gate).  h is an (N, I) float32 scratch.  Returns a
// cudaError_t (0 = success).
extern "C" int ragged_ffn(int dtype, const void* x, const void* w_up, const void* w_gate,
                          const void* w_down, const void* block_expert, void* h, void* y,
                          int N, int M, int I, int bx, int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* be = (const int32_t*)block_expert;
  if (dtype == 0)
    return (int)run<__nv_bfloat16>(x, w_up, w_gate, w_down, be, (float*)h, y, N, M, I, bx,
                                   act, s);
  if (dtype == 1)
    return (int)run<float>(x, w_up, w_gate, w_down, be, (float*)h, y, N, M, I, bx, act, s);
  return (int)cudaErrorInvalidValue;
}

// Grouped expert FFN device code shared by ragged_ffn.cu and moe_ffn.cu.
//
// Both kernels compute, for every row r of a token buffer A with its own
// expert e(r),
//   y[r] = act(A[r] @ W_up[e] [, A[r] @ W_gate[e]]) @ W_down[e]
// as two grouped passes with the intermediate h kept in f32 (as the TPU
// kernels keep it) in an (N, I) scratch the wrapper allocates:
//   pass 1: h = act(A @ W_up[e] [, A @ W_gate[e]])   (f32 out)
//   pass 2: y = h @ W_down[e]                         (rounded to T once)
// The two callers differ only in how rows map to experts, a RowMap:
//   RaggedRows — expert-sorted rows, expert per block of bx rows, and with
//                the liveness tags a dead block's chunks written as 0;
//   ExpertRows — (E, X, M) capacity buffers, expert e owns rows [e*X, e*X+X).
//
// Both passes are one kernel template: a CTA takes a chunk of 8 rows of one
// expert and 128 output columns.  Its 256 threads split the 128 columns 16
// ways (8 contiguous columns each, one 16-byte bf16 load per weight row when
// the width is a multiple of 8, masked scalar loads otherwise) and the
// reduction dimension 16 ways; each weight element loaded is used for all 8
// rows from registers, the 8 input rows sit in shared memory as f32 (rows past
// the chunk's end read as 0 and are not written), and the 16 partial sums
// per output are added through shared memory.  The math is f32 FMA on the
// CUDA cores: no bf16 rounding of h, which tensor cores would need, so the
// numbers are the reference's up to summation order.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace grouped_ffn {

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

// the first n (< 8) of them, one at a time, the rest 0 (a width not a
// multiple of 8: rows are not 16-byte aligned and the last group is short)
template <typename T>
__device__ __forceinline__ void load8_masked(const T* p, int n, float w[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = j < n ? to_f32(p[j]) : 0.0f;
}

// The ragged FFN's liveness: one tag a row, int32 or int64 (bytes 4 or 8),
// in segments of seg_rows rows that lie `stride` tags apart; a row is
// routed iff its tag is >= 0.  p null: no liveness (every row counts).
struct Tags {
  const void* p;
  int bytes, seg_rows, stride;
  __device__ bool routed(long long r) const {
    const long long s = r / seg_rows;
    const long long i = s * stride + (r - s * seg_rows);
    return bytes == 8 ? static_cast<const long long*>(p)[i] >= 0
                      : static_cast<const int32_t*>(p)[i] >= 0;
  }
};

// Expert-sorted rows: chunk c is rows [8c, 8c+8); bx % 8 == 0.  With tags,
// a chunk of a block none of whose bx rows is routed is dead.
struct RaggedRows {
  const int32_t* block_expert;
  int bx;
  Tags tags;
  __device__ int expert(int c) const { return block_expert[c * kRows / bx]; }
  __device__ int first_row(int c) const { return c * kRows; }
  __device__ int rows(int) const { return kRows; }
  // called by every thread of the CTA (a CTA-wide vote; bx <= blockDim.x)
  __device__ bool live(int c) const {
    if (tags.p == nullptr) return true;
    const int b = c * kRows / bx;
    return __syncthreads_or(threadIdx.x < bx && tags.routed((long long)b * bx + threadIdx.x));
  }
};

// Capacity buffers (E, X, M): nc = ceil(X/8) chunks per expert, chunk c
// of expert c / nc; the last chunk of each expert is short when X % 8.
struct ExpertRows {
  int X, nc;
  __device__ int expert(int c) const { return c / nc; }
  __device__ int first_row(int c) const { return (c / nc) * X + (c % nc) * kRows; }
  __device__ int rows(int c) const { return min(kRows, X - (c % nc) * kRows); }
  __device__ bool live(int) const { return true; }
};

// out[r, c] = act(sum_k A[r, k] W[e][k, c] [, gate sum]) for the CTA's rows,
// grid = (ceil(C / 128), chunks).  VEC: C % 8 == 0 (16-byte weight loads);
// a template parameter, so the hot loop carries no per-load branch.
template <typename TA, typename TW, typename TO, int ACT, bool VEC, typename RowMap>
__global__ void __launch_bounds__(kThreads)
grouped_rows_kernel(const TA* __restrict__ A, const TW* __restrict__ W,
                    const TW* __restrict__ Wg, RowMap map, TO* __restrict__ out,
                    int K, int C) {
  constexpr bool kGated = ACT == kSwiglu || ACT == kGeglu;
  __shared__ float As[kRows][kKc];
  __shared__ float red[kRedT][kCols];
  __shared__ float redg[kRedT][kCols];

  const int tid = threadIdx.x;
  const int tx = tid % kColT;           // column group
  const int ty = tid / kColT;           // reduction group
  const int chunk = blockIdx.y;
  const int r0 = map.first_row(chunk);
  const int nrows = map.rows(chunk);
  if (!map.live(chunk)) {               // a dead block's chunk: its A unread, its rows 0
    const int c = blockIdx.x * kCols + tid;
    if (tid < kCols && c < C)
      for (int r = 0; r < nrows; ++r) from_f32(0.0f, out + (size_t)(r0 + r) * C + c);
    return;
  }
  const int e = map.expert(chunk);
  const int c0 = blockIdx.x * kCols + tx * 8;
  const int ncols = min(8, C - c0);     // <= 0: the group is past the edge
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
      As[r][k] = r < nrows ? to_f32(A[(size_t)(r0 + r) * K + kc + k]) : 0.0f;
    }
    __syncthreads();
    if (ncols > 0) {
#pragma unroll 4
      for (int k = ty; k < klen; k += kRedT) {
        float w[8], wg[8];
        const size_t off = (size_t)(kc + k) * C;
        if (VEC) {
          load8(Wb + off, w);
          if (kGated) load8(Wgb + off, wg);
        } else {
          load8_masked(Wb + off, ncols, w);
          if (kGated) load8_masked(Wgb + off, ncols, wg);
        }
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
    if (tid < kCols && r < nrows) {
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

// Pass 1 of run_ffn at one width class (VEC: I % 8 == 0).
template <typename T, bool VEC, typename RowMap>
cudaError_t up_pass(const T* x, const T* up, const T* gt, RowMap map, dim3 grid, float* h,
                    int M, int I, int act, cudaStream_t s) {
  const dim3 block(kThreads);
  switch (act) {
    case kGelu: grouped_rows_kernel<T, T, float, kGelu, VEC><<<grid, block, 0, s>>>(x, up, nullptr, map, h, M, I); break;
    case kRelu: grouped_rows_kernel<T, T, float, kRelu, VEC><<<grid, block, 0, s>>>(x, up, nullptr, map, h, M, I); break;
    case kSwiglu: grouped_rows_kernel<T, T, float, kSwiglu, VEC><<<grid, block, 0, s>>>(x, up, gt, map, h, M, I); break;
    case kGeglu: grouped_rows_kernel<T, T, float, kGeglu, VEC><<<grid, block, 0, s>>>(x, up, gt, map, h, M, I); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Both passes over `chunks` row chunks: A (rows, M) -> h (rows, I) f32 ->
// y (rows, M).  act: 1 gelu, 2 relu, 3 swiglu, 4 geglu (3, 4 read w_gate).
template <typename T, typename RowMap>
cudaError_t run_ffn(const void* x, const void* w_up, const void* w_gate, const void* w_down,
                    RowMap map, int chunks, float* h, void* y, int M, int I, int act,
                    cudaStream_t s) {
  if (chunks == 0) return cudaSuccess;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 g1((I + kCols - 1) / kCols, chunks), g2((M + kCols - 1) / kCols, chunks);
  const T* xt = (const T*)x;
  const T* up = (const T*)w_up;
  const T* gt = (const T*)w_gate;
  cudaError_t err = I % 8 == 0 ? up_pass<T, true>(xt, up, gt, map, g1, h, M, I, act, s)
                               : up_pass<T, false>(xt, up, gt, map, g1, h, M, I, act, s);
  if (err != cudaSuccess) return err;
  const T* down = (const T*)w_down;
  if (M % 8 == 0)
    grouped_rows_kernel<float, T, T, kNone, true><<<g2, kThreads, 0, s>>>(h, down, nullptr, map, (T*)y, I, M);
  else
    grouped_rows_kernel<float, T, T, kNone, false><<<g2, kThreads, 0, s>>>(h, down, nullptr, map, (T*)y, I, M);
  return cudaGetLastError();
}

}  // namespace grouped_ffn

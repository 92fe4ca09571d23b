// The dropless combine for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no Pallas kernel.  The reference combines the ragged FFN's rows
// back into token order with XLA's scatter-add, `.at[gi, tok].add(vals)`
// (src/repro/core/dispatch/dropless.py:176 on one device; :138-141 on a mesh
// rank).  The port ran it as index_put_(accumulate=True), which on the card
// sorts the linearised indices first: every padding row reads token 0, so at
// a decode step (8 tokens top-1 of 32, blocks of 8: 232 rows) 224 rows pile
// onto one index and are summed one after another.  On an H100 it took 16.82
// ms in 120 calls of an m6-base serving run (~0.14 ms a call, three times the
// ragged FFN's device time in the same calls) to move 16 KiB in and 16 KiB out.
//
// What it computes: rows (G, T, K) int32 holds, for token t's choice k, the
// ragged row it was routed to, or -1 (the inverse of the ragged view's
// sort_order, built on the device by the wrapper's caller); then
//   y[g, t, :] = sum_{k : r = rows[g, t, k] >= 0} round(out[g, r, :] * round(gate[g, r]))
// with each term rounded to the activation dtype (the dispatcher's bf16
// product), the terms summed in f32 in the order k = 0..K-1 and rounded
// once.  Rows the map does not name (padding, dead blocks) are never read,
// so a NaN there cannot reach y; a token with no routed choice gets 0.
//
// What bounds it on this card: its launch.  A decode step reads its 8 routed
// rows of 1024 bf16 (16 KiB) and writes 16 KiB, ~0.01 us at 3.35 TB/s; the
// floor is the launch's few microseconds.  At a training step's thousands of
// tokens the bytes bound it: each routed row read once, y written once.
//
// Design: no TMA or clusters for kilobytes.  A CTA of 128 threads takes
// 128 / tpt tokens, tpt (32, 64 or 128) threads running along M with 16-byte
// vector loads and stores (the wrapper requires 16-byte aligned rows).
// A token's K row ids and gates are the same for its threads (broadcast
// loads).  The order of the terms is fixed, so the sum is deterministic; the
// products and sums use __fmul_rn / __fadd_rn so that no multiply-add is
// contracted and the plain version's roundings are the kernel's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// elements of T in 16 bytes
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// the kVec elements of T at p as f32: one 16-byte load, its words taken
// apart with bit operations (a bf16 is the high half of its f32), so
// nothing is addressed on the stack
template <typename T>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[kVec<T>]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// kVec f32 values rounded once to T and stored at p in one 16-byte store
template <typename T>
__device__ __forceinline__ void store_rounded(T* p, const float (&f)[kVec<T>]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4)
      w[i] = bits(from_f32<T>(f[i]));
    else
      w[i] = bits(from_f32<T>(f[2 * i])) | (bits(from_f32<T>(f[2 * i + 1])) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

struct Args {
  const void* out;      // (G, R, M), rows of M contiguous elements
  const float* gate;    // (G, R), unit row stride
  const int32_t* rows;  // (G, T, K), unit choice stride
  void* y;              // (G, T, M) contiguous
  int G, T, K, M;
  long long out_gs, out_rs;    // out's group and row strides (elements)
  long long gate_gs;           // gate's group stride
  long long rows_gs, rows_ts;  // the row map's group and token strides
};

template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(Args a, int tpt) {
  constexpr int VEC = kVec<T>;
  const long long token = (long long)blockIdx.x * (kThreads / tpt) + threadIdx.x / tpt;
  if (token >= (long long)a.G * a.T) return;
  const int g = (int)(token / a.T), t = (int)(token % a.T);
  const int lane = threadIdx.x % tpt;
  const T* out = static_cast<const T*>(a.out) + g * a.out_gs;
  const float* gate = a.gate + g * a.gate_gs;
  const int32_t* rows = a.rows + g * a.rows_gs + t * a.rows_ts;
  T* y = static_cast<T*>(a.y) + token * a.M;
  for (int c = lane * VEC; c < a.M; c += tpt * VEC) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    for (int k = 0; k < a.K; ++k) {
      const int r = __ldg(rows + k);
      if (r < 0) continue;
      const float gk = to_f32(from_f32<T>(__ldg(gate + r)));
      float o[VEC];
      load_f32<T>(out + r * a.out_rs + c, o);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = __fadd_rn(acc[j], to_f32(from_f32<T>(__fmul_rn(o[j], gk))));
    }
    store_rounded<T>(y + c, acc);
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int vecs = a.M / kVec<T>;
  const int tpt = vecs <= 32 ? 32 : vecs <= 64 ? 64 : kThreads;
  const long long tokens = (long long)a.G * a.T;
  const long long ctas = (tokens + kThreads / tpt - 1) / (kThreads / tpt);
  if (ctas == 0) return cudaSuccess;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  combine_kernel<T><<<(unsigned)ctas, kThreads, 0, s>>>(a, tpt);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (out and y; gate is float32, rows int32).
// out's base, group and row strides and M keep every row 16-byte aligned
// (the wrapper checks).  Returns a cudaError_t (0 = success).
extern "C" int ragged_combine(int dtype, const void* out, const void* gate, const void* rows,
                              void* y, int G, int T, int K, int M, long long out_gs,
                              long long out_rs, long long gate_gs, long long rows_gs,
                              long long rows_ts, void* stream) {
  const Args a{out, (const float*)gate, (const int32_t*)rows, y, G, T, K, M,
               out_gs, out_rs, gate_gs, rows_gs, rows_ts};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<__nv_bfloat16>(a, s);
  if (dtype == 1) return (int)launch<float>(a, s);
  return (int)cudaErrorInvalidValue;
}

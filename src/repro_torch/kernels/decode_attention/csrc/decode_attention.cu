// Dense-cache decode attention for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//           decode_attention_kernel (the Pallas TPU kernel, _kernel).
//
// What it computes: single-token GQA decode over a dense cache, one query
// per sequence b, G grouped query heads per kv head h:
//   out[b, h * G + g] = softmax(q[b, h * G + g] . K[b, :len, h]^T * D^-0.5) V[b, :len, h]
// with q and out (B, Hq, D) and K/V (B, T, Hkv, D) read through their
// strides (element strides of b, t and h; the last dim contiguous).  Keys
// past lengths[b] are neither read nor weighted; a row of length 0 writes
// exactly 0, as the TPU kernel's acc / max(l, 1e-30) with l = 0 does.
//
// What bounds it on this card: bytes.  A (sequence, head) streams
// 2 * length * D * sizeof(T) bytes of K/V at ~4 * G * D flops a position.
//
// Design: the TPU kernel's (B, Hkv, T, D) blocking was its wrapper's
// transpose for VMEM tiles; here the (B, T, Hkv, D) layout is read in place.
// One CTA per (sequence, kv head), 4 warps interleaved over the valid
// positions RPW tokens at a time, each warp with its own online softmax,
// merged in shared memory; the lanes' vector loads and the merge are the
// row-parallel layout of kernels/csrc/decode_common.cuh.  Any T: the loop
// ends at min(length, T), so nothing is padded.
#include "decode_common.cuh"

namespace {

using namespace decode;

template <typename Fmt, int G, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const typename Fmt::T* __restrict__ q,
                        const typename Fmt::T* __restrict__ k,
                        const typename Fmt::T* __restrict__ v,
                        const int32_t* __restrict__ lengths, typename Fmt::T* __restrict__ out,
                        int T, int Hkv, long long kb, long long kt, long long kh, long long vb,
                        long long vt, long long vh, float scale) {
  using E = typename Fmt::T;
  constexpr int VEC = vec_elems<(int)sizeof(E), G, D>();
  constexpr int TPR = D / VEC;        // lanes per token row
  constexpr int RPW = 32 / TPR;       // token rows per warp pass
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = lane / TPR;
  const int d0 = (lane % TPR) * VEC;
  int length = lengths[b];
  if (length > T) length = T;
  const size_t qo = ((size_t)b * Hkv + h) * G * D;     // (B, Hq, D), Hq = Hkv * G
  E* o = out + qo;
  if (length <= 0) {
    store_zero(o, G * D);
    return;
  }

  float qr[G][VEC];
  load_q<E, G, VEC, D>(q + qo, d0, scale, qr);
  State<G, VEC> st;
  st.init();

  const E* kp = k + b * kb + h * kh + d0;
  const E* vp = v + b * vb + h * vh + d0;
  for (int t0 = warp * RPW; t0 < length; t0 += kWarps * RPW) {
    const int t = t0 + row;
    const bool live = t < length;
    float kf[VEC], vf[VEC];
    if (live) {
      load_vec<Fmt, VEC>(kp + t * kt, kf);
      load_vec<Fmt, VEC>(vp + t * vt, vf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.0f;
    }
    st.template update<TPR>(qr, kf, 1.0f, vf, 1.0f, live);
  }
  merge_store<E, G, VEC, TPR, D>(st, o);
}

template <typename Fmt, int G>
cudaError_t launch_g(const void* q, const void* k, const void* v, const int32_t* len, void* out,
                     int B, int T, int Hkv, int D, const long long* ks, const long long* vs,
                     cudaStream_t stream) {
  using E = typename Fmt::T;
  dim3 grid(B, Hkv), block(kWarps * 32);
  const float scale = 1.0f / sqrtf((float)D);
#define REPRO_DA_LAUNCH(DD)                                                             \
  decode_attention_kernel<Fmt, G, DD><<<grid, block, 0, stream>>>(                      \
      (const E*)q, (const E*)k, (const E*)v, len, (E*)out, T, Hkv, ks[0], ks[1], ks[2], \
      vs[0], vs[1], vs[2], scale)
  switch (D) {
    case 16: REPRO_DA_LAUNCH(16); break;
    case 32: REPRO_DA_LAUNCH(32); break;
    case 64: REPRO_DA_LAUNCH(64); break;
    case 128: REPRO_DA_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DA_LAUNCH
  return cudaGetLastError();
}

template <typename Fmt>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* len, void* out,
                   int B, int T, int Hkv, int G, int D, const long long* ks,
                   const long long* vs, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  switch (G) {
    case 1: return launch_g<Fmt, 1>(q, k, v, len, out, B, T, Hkv, D, ks, vs, stream);
    case 2: return launch_g<Fmt, 2>(q, k, v, len, out, B, T, Hkv, D, ks, vs, stream);
    case 4: return launch_g<Fmt, 4>(q, k, v, len, out, B, T, Hkv, D, ks, vs, stream);
    case 8: return launch_g<Fmt, 8>(q, k, v, len, out, B, T, Hkv, D, ks, vs, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of q, k, v and out): 0 = bfloat16, 1 = float32.  k_strides and
// v_strides: the (b, t, h) element strides.  Returns a cudaError_t.
extern "C" int decode_attention(int dtype, const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int T, int Hkv, int G,
                                int D, long long kb, long long kt, long long kh, long long vb,
                                long long vt, long long vh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* len = (const int32_t*)lengths;
  const long long ks[3] = {kb, kt, kh}, vs[3] = {vb, vt, vh};
  if (dtype == 0)
    return (int)launch<FmtBF16>(q, k, v, len, out, B, T, Hkv, G, D, ks, vs, s);
  if (dtype == 1)
    return (int)launch<FmtF32>(q, k, v, len, out, B, T, Hkv, G, D, ks, vs, s);
  return (int)cudaErrorInvalidValue;
}

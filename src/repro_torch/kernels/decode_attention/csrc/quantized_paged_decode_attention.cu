// Quantized paged decode attention for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py
//           quantized_paged_decode_attention_kernel (the Pallas TPU kernel,
//           _quant_paged_kernel).
//
// What it computes: paged decode attention (one query per row i, G grouped
// query heads per kv head h, positions [0, lengths[i]) read through the
// row's block table) over int8 code pools, each value decoded in registers
// as decode(code) * scale with one f32 scale per (block, kv head):
//   out[i, h, g] = softmax(q . K^T * D^-0.5) V,
//   K[p] = decode(k_codes[tbl[i, p / bs], h, p % bs]) * k_scales[tbl[i, p / bs], h]
// decode is the int8 value (kv_quant="int8") or the float8_e4m3fn bit
// pattern (kv_quant="fp8"), a template parameter, not a branch in the loop.
// A row of length 0 writes exactly 0.
//
// What bounds it on this card: bytes.  A (row, head) streams
// 2 * length * D code bytes plus two scales a block, half the bf16 kernel's
// bytes, at ~4 * G * D flops a position: far below the 295 flop/byte ridge.
//
// Design: the bf16 paged kernel's (paged_decode_attention.cu) one CTA per
// (row, kv head) and 4 warps taking KV blocks w, w+4, ..., each with its own
// online softmax merged in shared memory.  The code tiles are read with
// 16-byte vector loads (D / 16 lanes per token row at G <= 2, see
// kernels/csrc/decode_common.cuh); a block's two scales are read once, with
// its table entry, and folded into the score (s * k_scale) and into the
// softmax weight of V (p * v_scale), so the codes are dequantized to f32 in
// registers and never written anywhere.
#include "decode_common.cuh"

namespace {

using namespace decode;

template <typename TQ, typename Fmt, int G, int D>
__global__ void __launch_bounds__(kWarps * 32)
quantized_paged_decode_attention_kernel(const TQ* __restrict__ q,
                                        const int8_t* __restrict__ k_codes,
                                        const int8_t* __restrict__ v_codes,
                                        const float* __restrict__ k_scales,
                                        const float* __restrict__ v_scales,
                                        const int32_t* __restrict__ tables,
                                        const int32_t* __restrict__ lengths,
                                        TQ* __restrict__ out, int Hkv, int bs, int MB,
                                        float scale) {
  constexpr int VEC = vec_elems<1, G, D>();
  constexpr int TPR = D / VEC;        // lanes per token row
  constexpr int RPW = 32 / TPR;       // token rows per warp pass
  const int i = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = lane / TPR;
  const int d0 = (lane % TPR) * VEC;
  const int length = lengths[i];
  TQ* o = out + ((size_t)i * Hkv + h) * G * D;
  if (length <= 0) {
    store_zero(o, G * D);
    return;
  }

  float qr[G][VEC];
  load_q<TQ, G, VEC, D>(q + ((size_t)i * Hkv + h) * G * D, d0, scale, qr);
  State<G, VEC> st;
  st.init();

  int nb = (length + bs - 1) / bs;
  if (nb > MB) nb = MB;
  const int32_t* table = tables + (size_t)i * MB;
  for (int b = warp; b < nb; b += kWarps) {
    const size_t bh = (size_t)table[b] * Hkv + h;
    const float ks = k_scales[bh], vs = v_scales[bh];
    const size_t blk = bh * bs;
    for (int t0 = 0; t0 < bs; t0 += RPW) {
      const int t = t0 + row;
      const bool live = t < bs && b * bs + t < length;
      float kf[VEC], vf[VEC];
      if (live) {
        load_vec<Fmt, VEC>(k_codes + (blk + t) * D + d0, kf);
        load_vec<Fmt, VEC>(v_codes + (blk + t) * D + d0, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.0f;
      }
      st.template update<TPR>(qr, kf, ks, vf, vs, live);
    }
  }
  merge_store<TQ, G, VEC, TPR, D>(st, o);
}

template <typename TQ, typename Fmt, int G>
cudaError_t launch_g(const void* q, const void* kc, const void* vc, const float* ks,
                     const float* vs, const int32_t* tbl, const int32_t* len, void* out,
                     int N, int Hkv, int D, int bs, int MB, cudaStream_t stream) {
  dim3 grid(N, Hkv), block(kWarps * 32);
  const float scale = 1.0f / sqrtf((float)D);
#define REPRO_QPDA_LAUNCH(DD)                                                         \
  quantized_paged_decode_attention_kernel<TQ, Fmt, G, DD><<<grid, block, 0, stream>>>( \
      (const TQ*)q, (const int8_t*)kc, (const int8_t*)vc, ks, vs, tbl, len, (TQ*)out,   \
      Hkv, bs, MB, scale)
  switch (D) {
    case 32: REPRO_QPDA_LAUNCH(32); break;
    case 64: REPRO_QPDA_LAUNCH(64); break;
    case 128: REPRO_QPDA_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_QPDA_LAUNCH
  return cudaGetLastError();
}

template <typename TQ, typename Fmt>
cudaError_t launch(const void* q, const void* kc, const void* vc, const float* ks,
                   const float* vs, const int32_t* tbl, const int32_t* len, void* out, int N,
                   int Hkv, int G, int D, int bs, int MB, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  switch (G) {
    case 1: return launch_g<TQ, Fmt, 1>(q, kc, vc, ks, vs, tbl, len, out, N, Hkv, D, bs, MB, stream);
    case 2: return launch_g<TQ, Fmt, 2>(q, kc, vc, ks, vs, tbl, len, out, N, Hkv, D, bs, MB, stream);
    case 4: return launch_g<TQ, Fmt, 4>(q, kc, vc, ks, vs, tbl, len, out, N, Hkv, D, bs, MB, stream);
    case 8: return launch_g<TQ, Fmt, 8>(q, kc, vc, ks, vs, tbl, len, out, N, Hkv, D, bs, MB, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t launch_fmt(int fmt, const void* q, const void* kc, const void* vc,
                       const float* ks, const float* vs, const int32_t* tbl,
                       const int32_t* len, void* out, int N, int Hkv, int G, int D, int bs,
                       int MB, cudaStream_t stream) {
  if (fmt == 0)
    return launch<TQ, FmtInt8>(q, kc, vc, ks, vs, tbl, len, out, N, Hkv, G, D, bs, MB, stream);
  if (fmt == 1)
    return launch<TQ, FmtFp8>(q, kc, vc, ks, vs, tbl, len, out, N, Hkv, G, D, bs, MB, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and out): 0 = bfloat16, 1 = float32.  fmt (of the codes):
// 0 = int8, 1 = float8_e4m3fn.  Returns a cudaError_t (0 = success).
extern "C" int quantized_paged_decode_attention(int dtype, int fmt, const void* q,
                                                const void* k_codes, const void* v_codes,
                                                const void* k_scales, const void* v_scales,
                                                const void* tables, const void* lengths,
                                                void* out, int N, int Hkv, int G, int D,
                                                int bs, int MB, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* ks = (const float*)k_scales;
  const float* vs = (const float*)v_scales;
  const int32_t* tbl = (const int32_t*)tables;
  const int32_t* len = (const int32_t*)lengths;
  if (dtype == 0)
    return (int)launch_fmt<__nv_bfloat16>(fmt, q, k_codes, v_codes, ks, vs, tbl, len, out, N,
                                          Hkv, G, D, bs, MB, s);
  if (dtype == 1)
    return (int)launch_fmt<float>(fmt, q, k_codes, v_codes, ks, vs, tbl, len, out, N, Hkv, G,
                                  D, bs, MB, s);
  return (int)cudaErrorInvalidValue;
}

// Quantized paged decode attention for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:226
//           quantized_paged_decode_attention_kernel (the Pallas TPU kernel,
//           _quant_paged_kernel).
//
// What it computes: paged decode attention (one query per row i, G grouped
// query heads per kv head h, positions [0, lengths[i]) read through the
// row's block table) over int8 code pools, each value decoded as
// decode(code) * scale with one f32 scale per (block, kv head):
//   out[i, h, g] = softmax(q . K^T * D^-0.5) V,
//   K[p] = decode(k_codes[tbl[i, p / bs], h, p % bs]) * k_scales[tbl[i, p / bs], h]
// decode is the int8 value (kv_quant="int8") or the float8_e4m3fn bit
// pattern (kv_quant="fp8"), a template parameter, not a branch in the loop.
// A row of length 0 writes exactly 0.
//
// What bounds it on this card: latency, not bytes.  The codes are half the
// bf16 kernel's bytes (0.29 us at the m6 decode step), far less than one
// dependent DRAM round trip per block.
//
// Design: the bf16 kernel's (kernels/csrc/decode_sm90.cuh): one 1-D
// bulk copy a code tile, every block of the split in flight at once; the
// lane that issues a block's copies also stores its two scales next to the
// codes in shared memory before the block's barriers complete, and the
// scales are folded into the score (s * k_scale) and the softmax weight of
// V (p * v_scale), so the codes are dequantized to f32 in registers and
// never written anywhere; `splits` > 1 merges over a thread-block cluster.
#include "decode_sm90.cuh"

// dtype (of q and out): 0 = bfloat16, 1 = float32.  fmt (of the codes):
// 0 = int8, 1 = float8_e4m3fn.  splits in (1, 2, 4, 8), 1 <= stages <= 32.
// Returns a cudaError_t (0 = success).
extern "C" int quantized_paged_decode_attention(int dtype, int fmt, const void* q,
                                                const void* k_codes, const void* v_codes,
                                                const void* k_scales, const void* v_scales,
                                                const void* tables, const void* lengths,
                                                void* out, int N, int Hkv, int G, int D,
                                                int bs, int MB, int splits, int stages,
                                                void* stream) {
  const decode_sm90::Launch a{q, (const int32_t*)lengths, out, N, Hkv, G, D, splits, stages,
                              0.0f};  // no logit softcap
  const float* ks = (const float*)k_scales;
  const float* vs = (const float*)v_scales;
  const int32_t* tbl = (const int32_t*)tables;
  const cudaStream_t s = (cudaStream_t)stream;
  using decode_sm90::FmtFp8;
  using decode_sm90::FmtInt8;
  using decode_sm90::launch_paged;
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && fmt == 0)
    return (int)launch_paged<bf16, FmtInt8, true>(a, k_codes, v_codes, ks, vs, tbl, bs, MB, s);
  if (dtype == 0 && fmt == 1)
    return (int)launch_paged<bf16, FmtFp8, true>(a, k_codes, v_codes, ks, vs, tbl, bs, MB, s);
  if (dtype == 1 && fmt == 0)
    return (int)launch_paged<float, FmtInt8, true>(a, k_codes, v_codes, ks, vs, tbl, bs, MB, s);
  if (dtype == 1 && fmt == 1)
    return (int)launch_paged<float, FmtFp8, true>(a, k_codes, v_codes, ks, vs, tbl, bs, MB, s);
  return (int)cudaErrorInvalidValue;
}

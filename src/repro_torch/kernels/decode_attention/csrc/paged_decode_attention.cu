// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:143
//           paged_decode_attention_kernel (the Pallas TPU kernel, _paged_kernel).
//
// What it computes: one query per row i and kv head h, G grouped query
// heads, attending to positions [0, lengths[i]) of the row's context read
// through its block table:
//   out[i, h, g] = softmax(q[i, h, g] . K^T * D^-0.5) V
// with K/V rows at pool[(tables[i, p / bs], h, p % bs)], bf16 or f32 pools.
// A row of length 0 writes exactly 0, like the reference's finite NEG_INF
// mask.
//
// What bounds it on this card: latency, not bytes.  At the m6 decode step
// (8 rows, at most 7 blocks of 16 positions a row) the K/V bytes take
// 0.56 us at 3.35 TB/s, less than one dependent DRAM round trip per block.
//
// Design (kernels/csrc/decode_sm90.cuh, shared with the quantized
// and dense kernels): one CTA per (row, kv head, split); one 1-D bulk copy a K or V
// tile, every block of the split in flight at once on mbarriers, so a CTA
// pays one round trip, not one a block; the 4 warps read each arrived tile
// from shared memory in the row-parallel layout of decode_common.cuh; with
// `splits` > 1 the row's blocks are split over a thread-block cluster and
// rank 0 merges the CTAs' softmax states through distributed shared memory.
// The wrapper (ops.py::split_plan) picks `splits` and the ring's `stages`.
#include "decode_sm90.cuh"

// dtype (of q, the pools and out): 0 = bfloat16, 1 = float32.  splits in
// (1, 2, 4, 8), 1 <= stages <= 32.  Returns a cudaError_t (0 = success).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out, int N, int Hkv,
                                      int G, int D, int bs, int MB, int splits, int stages,
                                      void* stream) {
  const decode_sm90::Launch a{q, (const int32_t*)lengths, out, N, Hkv, G, D, splits, stages,
                              0.0f};  // no logit softcap
  const int32_t* tbl = (const int32_t*)tables;
  const cudaStream_t s = (cudaStream_t)stream;
  using decode_sm90::launch_paged;
  if (dtype == 0)
    return (int)launch_paged<__nv_bfloat16, decode::FmtBF16, false>(
        a, k_pool, v_pool, nullptr, nullptr, tbl, bs, MB, s);
  if (dtype == 1)
    return (int)launch_paged<float, decode::FmtF32, false>(a, k_pool, v_pool, nullptr, nullptr,
                                                           tbl, bs, MB, s);
  return (int)cudaErrorInvalidValue;
}

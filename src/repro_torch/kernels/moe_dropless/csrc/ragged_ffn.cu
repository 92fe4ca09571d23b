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
// block_expert, with h in device memory.  Two routes, chosen by the wrapper:
// - ragged_ffn_tc (bf16, M and I multiples of 8: every serving shape):
//   kernels/csrc/grouped_ffn_sm90.cuh, wgmma on the tensor cores with the
//   weights as operand A and one bx-row block as its N = bx columns, so a
//   decode step's 8-row blocks use all of wgmma's 64 weight rows and read
//   each weight tile once per block; h in two bf16 planes (hi + lo);
// - ragged_ffn (f32): the CUDA-core device code in
//   kernels/csrc/grouped_ffn.cuh, with the RaggedRows map (8-row chunks, bx
//   any multiple of 8) and an f32 scratch.
#include "grouped_ffn.cuh"
#include "grouped_ffn_sm90.cuh"

// dtype: 0 = bfloat16, 1 = float32.  act: 1 gelu, 2 relu, 3 swiglu, 4 geglu
// (3 and 4 read w_gate).  h is an (N, I) float32 scratch.  Returns a
// cudaError_t (0 = success).
extern "C" int ragged_ffn(int dtype, const void* x, const void* w_up, const void* w_gate,
                          const void* w_down, const void* block_expert, void* h, void* y,
                          int N, int M, int I, int bx, int act, void* stream) {
  using namespace grouped_ffn;
  cudaStream_t s = (cudaStream_t)stream;
  const RaggedRows map{(const int32_t*)block_expert, bx};
  if (dtype == 0)
    return (int)run_ffn<__nv_bfloat16>(x, w_up, w_gate, w_down, map, N / kRows, (float*)h, y,
                                       M, I, act, s);
  if (dtype == 1)
    return (int)run_ffn<float>(x, w_up, w_gate, w_down, map, N / kRows, (float*)h, y, M, I,
                               act, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bf16 only, M % 8 == 0, I % 8 == 0.  E experts in
// the weights; h is a (2, N, I) bf16 scratch, h's hi and lo planes; each
// bx-row block is `tiles` tiles of n rows (tiles * n >= bx).  Returns a
// cudaError_t.
extern "C" int ragged_ffn_tc(const void* x, const void* w_up, const void* w_gate,
                             const void* w_down, const void* block_expert, void* h, void* y,
                             int N, int M, int I, int E, int bx, int act, int n, int tiles,
                             void* stream) {
  if (bx <= 0 || N % bx) return (int)cudaErrorInvalidValue;
  return (int)grouped_ffn_sm90::run_ffn(x, w_up, w_gate, w_down, (const int32_t*)block_expert,
                                        N / bx, bx, E, n, tiles, h, y, M, I, act,
                                        (cudaStream_t)stream);
}

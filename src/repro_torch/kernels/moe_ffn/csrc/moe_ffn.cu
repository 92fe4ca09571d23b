// Grouped expert FFN over capacity buffers for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/moe_ffn/kernel.py moe_ffn_kernel (the Pallas
//           TPU kernel, grid (E, X/bx, I/bi) with a (bx, M) f32 VMEM
//           accumulator across the I tiles).
//
// What it computes: x (E, X, M) holds each expert's capacity buffer (X =
// G*C slots, empty slots are zero rows);
//   y[e, r] = act(x[e, r] @ W_up[e] [, x[e, r] @ W_gate[e]]) @ W_down[e]
// with the products in f32 and y rounded to the input type once.
//
// What bounds it on this card: at the m6-base training shapes (E = 32,
// X = 45 or 180, M = 1024, I = 4096, bf16) the two matmuls are
// 2*2*E*X*M*I = 24 or 97 GFLOP against 537 MB of weights, 45 or 180
// flops per weight byte: below the bf16 tensor-core ridge (295), so the
// least time is the weight bytes over 3.35 TB/s.  This kernel does its math
// as f32 FMA on the CUDA cores (67 TFLOP/s), which is what bounds it in
// practice; tensor cores would round h to bf16, which the reference does not.
//
// Design: a (bx, M) f32 accumulator at bx = 128, M = 1024 is 512 KB, more
// than a CTA's 227 KB of shared memory, so the FFN runs as two grouped
// passes with h in an f32 (E*X, I) scratch: the device code in
// kernels/csrc/grouped_ffn.cuh, with the ExpertRows map.  Each expert's X
// rows are cut into 8-row chunks and the last chunk is masked, so X need
// not be a multiple of 8 (45 and 180 on the training path) and no row is
// padded; a width not a multiple of 8 (any I) takes masked scalar loads.
#include "grouped_ffn.cuh"

// dtype: 0 = bfloat16, 1 = float32.  act: 1 gelu, 2 relu, 3 swiglu, 4 geglu
// (3 and 4 read w_gate).  h is an (E*X, I) float32 scratch.  Returns a
// cudaError_t (0 = success).
extern "C" int moe_ffn(int dtype, const void* x, const void* w_up, const void* w_gate,
                       const void* w_down, void* h, void* y, int E, int X, int M, int I,
                       int act, void* stream) {
  using namespace grouped_ffn;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = (X + kRows - 1) / kRows;
  const ExpertRows map{X, nc};
  if (dtype == 0)
    return (int)run_ffn<__nv_bfloat16>(x, w_up, w_gate, w_down, map, E * nc, (float*)h, y,
                                       M, I, act, s);
  if (dtype == 1)
    return (int)run_ffn<float>(x, w_up, w_gate, w_down, map, E * nc, (float*)h, y, M, I,
                               act, s);
  return (int)cudaErrorInvalidValue;
}

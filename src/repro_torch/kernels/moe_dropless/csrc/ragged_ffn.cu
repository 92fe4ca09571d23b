// Ragged grouped expert FFN for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/moe_dropless/kernel.py ragged_ffn_kernel
//           (the Pallas TPU kernel with the scalar-prefetched block_expert).
//
// What it computes: x (N, M) holds expert-sorted token rows, block-padded
// so that every block of bx rows belongs to one expert, block_expert[N/bx];
//   y[r] = act(x[r] @ W_up[e] [, x[r] @ W_gate[e]]) @ W_down[e],  e = block_expert[r/bx]
// for every row of a live block.  The liveness is optional: one tag a row
// (the ragged view's token, or a mesh rank's received expert ids), >= 0 on
// a routed row; a block with none is dead, its x and expert id never read
// and its rows written as exactly 0 (the combine adds every row into a
// token, padding with gate 0, so a stale or NaN row would poison it).
// Without the tags every block is live, including the trailing padding
// blocks the routing layout clips to expert E-1, exactly as the reference
// computes them (every row stays finite).
//
// What bounds it on this card: bytes at the serving shapes.  A decode step
// routes 8 or 40 choices into blocks of 8 rows, so each weight element read
// from memory is used for at most 8 rows: ~8 flops per 2-byte bf16 weight,
// far below the 295 flop/byte ridge.  The least time is the bytes of the
// distinct experts' W_up and W_down over 3.35 TB/s.
//
// Design: the TPU kernel kept a (bx, M) f32 accumulator in VMEM across the I
// tiles; at M = 1024, bx = 128 that is 512 KB, more than a CTA's 227 KB of
// shared memory.  So the FFN runs as two grouped passes with h in device
// memory.  Two routes, chosen by the wrapper:
// - ragged_ffn_tc (bf16, M and I multiples of 8: every serving shape):
//   kernels/csrc/grouped_ffn_sm90.cuh, wgmma on the tensor cores with the
//   weights as operand A and a run of token rows as its N columns.  A
//   prologue kernel builds the work on the device: runs of one expert's
//   consecutive live blocks, each cut to n rows (n from static sizes), and
//   the dead blocks; each pass is a persistent grid of the SM count over
//   the runs crossed with the column tiles, so an expert's weight tile is
//   read once a run, not once a block, and dead blocks cost their zero
//   stores.  h in two bf16 planes (hi + lo);
// - ragged_ffn (f32): the CUDA-core device code in
//   kernels/csrc/grouped_ffn.cuh, with the RaggedRows map (8-row chunks, bx
//   any multiple of 8; a dead block's chunks write 0) and an f32 scratch.
#include "grouped_ffn.cuh"
#include "grouped_ffn_sm90.cuh"

// the widest tiles' passes compile beside this unit (build.py's EXTRA_SOURCES)
namespace grouped_ffn_sm90 {
extern template GROUPED_FFN_SM90_RAGGED_TILES(96);
extern template GROUPED_FFN_SM90_RAGGED_TILES(128);
extern template GROUPED_FFN_SM90_RAGGED_TILES(192);
}  // namespace grouped_ffn_sm90

// The liveness as both entries take it: tags (null: none), bytes a tag (4
// or 8), rows a segment of tags, a segment's stride in tags.
//
// dtype: 0 = bfloat16, 1 = float32.  act: 1 gelu, 2 relu, 3 swiglu, 4 geglu
// (3 and 4 read w_gate).  h is an (N, I) float32 scratch.  Returns a
// cudaError_t (0 = success).
extern "C" int ragged_ffn(int dtype, const void* x, const void* w_up, const void* w_gate,
                          const void* w_down, const void* block_expert, const void* tags,
                          int tag_bytes, int seg_rows, int seg_stride, void* h, void* y, int N,
                          int M, int I, int bx, int act, void* stream) {
  using namespace grouped_ffn;
  cudaStream_t s = (cudaStream_t)stream;
  const RaggedRows map{(const int32_t*)block_expert, bx, Tags{tags, tag_bytes, seg_rows,
                                                              seg_stride}};
  if (dtype == 0)
    return (int)run_ffn<__nv_bfloat16>(x, w_up, w_gate, w_down, map, N / kRows, (float*)h, y,
                                       M, I, act, s);
  if (dtype == 1)
    return (int)run_ffn<float>(x, w_up, w_gate, w_down, map, N / kRows, (float*)h, y, M, I,
                               act, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: bf16 only, M % 8 == 0, I % 8 == 0.  E experts in
// the weights (at most kSortExperts); `work` is an int32 workspace of
// work_ints words for the work list (at least ragged_work_ints), `partial`
// an f32 scratch of partial_floats for split reductions (a pass splits as
// far as it holds every slice), ctas the persistent grid (the SM count); h
// is a (2, N, I) bf16 scratch, h's hi and lo planes; a work item holds up
// to n rows (n in 8, 16, 32, 48, 64, 96, 128, 192; n <= 128 when gated;
// min(bx, n) cuts bx evenly).  Returns a cudaError_t.
extern "C" int ragged_ffn_tc(const void* x, const void* w_up, const void* w_gate,
                             const void* w_down, const void* block_expert, const void* tags,
                             int tag_bytes, int seg_rows, int seg_stride, void* work,
                             int work_ints, void* partial, int partial_floats, void* h,
                             void* y, int N, int M, int I, int E, int bx, int act, int n,
                             int ctas, void* stream) {
  using namespace grouped_ffn_sm90;
  if (N == 0) return 0;
  if (bx <= 0 || n <= 0 || N % bx || M % 8 || I % 8 || act < 1 || act > 4 || ctas <= 0 ||
      partial_floats < 0 ||
      (tags != nullptr && seg_rows <= 0) ||
      work_ints < ragged_work_ints(N / bx, bx, n, ((I > M ? I : M) + kBC - 1) / kBC))
    return (int)cudaErrorInvalidValue;
  const grouped_ffn::Tags live{tags, tag_bytes, seg_rows, seg_stride};
  cudaStream_t s = (cudaStream_t)stream;
#define RAGGED_TILE(NN)                                                                        \
  case NN:                                                                                     \
    return (int)run_ragged_tiles<NN>(x, w_up, w_gate, w_down, (const int32_t*)block_expert,   \
                                     live, (int*)work, (float*)partial, partial_floats, ctas, \
                                     N, bx, E, h, y, M, I, act, s);
  switch (n) {
    RAGGED_TILE(8)
    RAGGED_TILE(16)
    RAGGED_TILE(32)
    RAGGED_TILE(48)
    RAGGED_TILE(64)
    RAGGED_TILE(96)
    RAGGED_TILE(128)
    RAGGED_TILE(192)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RAGGED_TILE
}

// Dense-cache decode attention for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:63
//           decode_attention_kernel (the Pallas TPU kernel, _kernel).
//
// What it computes: single-token GQA decode over a dense cache, one query
// per sequence b, G grouped query heads per kv head h:
//   out[b, h * G + g] = softmax(cap(q[b, h * G + g] . K[b, :len, h]^T * D^-0.5)) V[b, :len, h]
// where cap(s) = c tanh(s / c) with a logit softcap c > 0 (the reference's
// _sdpa, which this kernel stands in for on the static path), else s.
// with q and out (B, Hq, D) contiguous and K/V (B, T, Hkv, D) read through
// their strides (element strides of b, t and h; the last dim contiguous).
// Keys past lengths[b] (and past T) are neither read into the result nor
// weighted; a row of length 0 writes exactly 0, as the TPU kernel's
// acc / max(l, 1e-30) with l = 0 does.
//
// What bounds it on this card: bytes in principle, 2 * length * D *
// sizeof(T) of K/V a (sequence, head) at ~4 * G * D flops a position; at the
// m6 decode step (8 sequences of 21-112 positions, 16 kv heads of 64, bf16)
// that is 1.84 MB, 0.56 us at 3.35 TB/s, so in practice latency: the launch
// and the dependent DRAM round trips.  At zamba2-7b's shared attention (32
// kv heads of D = 224, G = 1, instantiated for that group alone) a step of 8
// sequences at 112 positions moves 25.7 MB, 7.7 us: bytes bound it there.
//
// Design (kernels/csrc/decode_sm90.cuh, shared with the two paged kernels):
// the TPU kernel's (B, Hkv, T, D) blocking was its wrapper's transpose for
// VMEM tiles; here the (B, T, Hkv, D) layout is read in place, a tile of bs
// positions of one (sequence, kv head) being one box (D, 1, bs, 1) of a 4-D
// tensor map over (D, Hkv, T, B) that the host encodes per call from the
// tensors' strides.  A tile's place needs only its index, so every CTA puts
// the K and V tiles of its first pass in flight at entry, one thread a
// stage, beside the load of its length, and the rest of its ring once the
// length is known: one DRAM round trip before the first score, where the
// paged kernels pay two (table, then tiles) and loads straight from global
// memory pay one per pass.  Tiles past the length are waited for and never
// read; boxes past T are clipped by the copy engine.
// The 4 warps read the ring in shared memory in the row-parallel layout of
// decode_common.cuh,
// and with `splits` > 1 a thread-block cluster splits the tiles and rank 0
// merges the softmax states.  The wrapper (ops.py::dense_plan) picks
// `splits` and `stages`.
#include "decode_sm90.cuh"

namespace {

template <typename TQ, typename Fmt>
cudaError_t run(CUtensorMapDataType type, const void* q, const void* k, const void* v,
                const int32_t* lengths, void* out, int B, int T, int Hkv, int G, int D,
                const long long* ks, const long long* vs, int bs, int splits, int stages,
                float softcap, cudaStream_t stream) {
  using E = typename Fmt::T;
  if (B == 0) return cudaSuccess;
  if (T < 1 || bs < 1 || bs > 256 || D > 256 || bs * D * sizeof(E) % 128)
    return cudaErrorInvalidValue;                        // TMA boxes, 128-byte aligned tiles
  const sm90::EncodeTiledFn encode = sm90::encode_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t eb = sizeof(E);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t k_strides[3] = {ks[2] * eb, ks[1] * eb, ks[0] * eb};   // h, t, b
  const cuuint64_t v_strides[3] = {vs[2] * eb, vs[1] * eb, vs[0] * eb};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)bs, 1};
  decode_sm90::DenseTiles<E> src;
  if (!sm90::map_tiled<4>(encode, &src.k_map, type, k, dims, k_strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !sm90::map_tiled<4>(encode, &src.v_map, type, v, dims, v_strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;                        // a layout the copy engine refuses
  src.bs = bs;
  src.tiles = (T + bs - 1) / bs;
  src.capacity = T;
  const decode_sm90::Launch a{q, lengths, out, B, Hkv, G, D, splits, stages, softcap};
  return decode_sm90::launch<TQ, Fmt>(src, a, stream);
}

}  // namespace

// dtype (of q, k, v and out): 0 = bfloat16, 1 = float32.  k_strides and
// v_strides: the (b, t, h) element strides (multiples of 16 bytes, the
// base 16-byte aligned).  bs: positions a tile (bs * D * sizeof a multiple
// of 128 bytes); splits in (1, 2, 4, 8), 1 <= stages <= 32; softcap: the
// logit cap c (0: none).  Returns a cudaError_t (cudaErrorInvalidValue where
// the tensor maps cannot be encoded).
extern "C" int decode_attention(int dtype, const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int T, int Hkv, int G,
                                int D, long long kb, long long kt, long long kh, long long vb,
                                long long vt, long long vh, int bs, int splits, int stages,
                                float softcap, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* len = (const int32_t*)lengths;
  const long long ks[3] = {kb, kt, kh}, vs[3] = {vb, vt, vh};
  if (dtype == 0)
    return (int)run<__nv_bfloat16, decode::FmtBF16>(sm90::kBF16, q, k, v, len, out, B, T, Hkv,
                                                    G, D, ks, vs, bs, splits, stages, softcap,
                                                    s);
  if (dtype == 1)
    return (int)run<float, decode::FmtF32>(sm90::kF32, q, k, v, len, out, B, T, Hkv, G, D, ks,
                                           vs, bs, splits, stages, softcap, s);
  return (int)cudaErrorInvalidValue;
}

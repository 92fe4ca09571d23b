// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (grouped_ffn_sm90.cuh, flash_attention_sm90.cuh) and the decode kernels
// (decode_sm90.cuh): mbarriers, TMA loads and stores, 1-D bulk
// copies, the 128-byte-swizzle wgmma descriptor, wgmma fences, and the
// host's tensor maps.  The wgmma instructions themselves are in
// wgmma_bf16.cuh.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed; trap (a launch
// failure the wrapper reports) rather than hang if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// `bytes` contiguous bytes of global memory into shared memory by the copy
// engine, without a tensor map (both addresses 16-byte aligned, `bytes` a
// multiple of 16); completes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// box (c0, c1, c2) of a 3-D tensor map into shared memory; completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the same with an L2 eviction policy (the weights: read once, evict first,
// so that the token rows other CTAs read again stay in L2)
__device__ __forceinline__ void tma_load_hint(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4, %5}], [%2], %6;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "l"(policy)
      : "memory");
}

// box (c0, c1, c2, c3) of a 4-D tensor map into shared memory; completes on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// shared memory into box (c0, c1, c2, c3) of a 4-D tensor map; elements out
// of the tensor's bounds are not written.  The writing threads first make
// their shared-memory stores visible to the copy (fence_proxy_async) and
// synchronise; the issuing thread then waits for the read (tma_store_wait)
// before the shared memory may be reused or the CTA exits.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle layout
// (1024-byte atoms of 8 rows of 128 bytes): both byte offsets 1024, the
// stride from one 8-row atom to the next along the rows (K for an MN-major
// operand, M or N for a K-major one; the other offset is unused, as every
// operand here is one 128-byte atom across).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads, or reuse of the A
// fragment registers of a register-sourced wgmma, across the async wgmmas
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver API: reached through the runtime's
// entry-point query, so the libraries need no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

constexpr CUtensorMapDataType kBF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// 2 for bf16 and f16, 4 for f32: the element types the maps below take
inline uint32_t elem_bytes(CUtensorMapDataType type) {
  return type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4u : 2u;
}

// A rank-R array of `type` elements: dims innermost first, dims[0]
// contiguous, byte strides of dims 1..R-1 (each a multiple of 16, the base
// 16-byte aligned), read in boxes `box` (each at most 256; box[0] times the
// element a multiple of 16 bytes).  Out of bounds reads as 0 and is not
// written.  False where the driver refuses the layout.
template <int R>
inline bool map_tiled(EncodeTiledFn encode, CUtensorMap* m, CUtensorMapDataType type,
                      const void* base, const cuuint64_t (&dims)[R],
                      const cuuint64_t (&strides)[R - 1], const cuuint32_t (&box)[R],
                      CUtensorMapSwizzle swizzle) {
  cuuint32_t elem[R];
  for (int i = 0; i < R; ++i) elem[i] = 1;
  return encode(m, type, R, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a contiguous (d2, d1, d0) array of `type`, d0 a multiple of 16 bytes,
// read in boxes of (1, box1, 128 bytes) with the 128-byte swizzle
inline bool map3d(EncodeTiledFn encode, CUtensorMap* m, CUtensorMapDataType type,
                  const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t box1) {
  const uint32_t eb = elem_bytes(type);
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * eb, d0 * d1 * eb};
  const cuuint32_t box[3] = {128 / eb, box1, 1};
  return map_tiled<3>(encode, m, type, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// a contiguous (d3, d2, d1, d0) array of `type`, d0 a multiple of 16 bytes,
// read and written in boxes of (1, box2, 1, 128 bytes) with the 128-byte
// swizzle: box2 rows of 128 bytes in shared memory.  For the attention
// tensors (B, S, H, D): d0 = D, d1 = H, d2 = S, d3 = B, so a box is box2
// positions of one head, and positions past S never reach the next batch's
// rows.
inline bool map4d(EncodeTiledFn encode, CUtensorMap* m, CUtensorMapDataType type,
                  const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint64_t d3,
                  uint32_t box2) {
  const uint32_t eb = elem_bytes(type);
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * eb, d0 * d1 * eb, d0 * d1 * d2 * eb};
  const cuuint32_t box[4] = {128 / eb, 1, box2, 1};
  return map_tiled<4>(encode, m, type, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90

// Paged decode attention on Hopper (sm_90a): the device code of both paged
// decode kernels, paged_decode_attention.cu (bf16 / f32 pools) and
// quantized_paged_decode_attention.cu (int8 / e4m3 codes with one f32 scale
// per (block, kv head)).
//
// What it computes: one query per row i and kv head h, G grouped query
// heads, over positions [0, lengths[i]) of the row's context read through
// its block table:
//   out[i, h, g] = softmax(q[i, h, g] . K^T * D^-0.5) V,
//   K[p] = dec(k_pool[tables[i, p / bs], h, p % bs]) * k_scale (1 unscaled)
// A row of length 0 writes exactly 0; positions past the length are neither
// read nor weighted (the finite NEG_INF mask of the TPU kernels).
//
// What bounds it at decode sizes: latency, not bytes.  The m6 decode step
// (8 rows of 21-112 positions, 16 kv heads of 64) moves 1.84 MB of K/V,
// 0.56 us at 3.35 TB/s; a kernel that waits on its loads block by block
// pays one dependent DRAM round trip (about a microsecond) per block.
//
// Design: pay one round trip a CTA, not one a block.
// - Copies.  A (block, kv head) tile of the (P, Hkv, bs, D) pool is one
//   contiguous run of bs * D elements, so one 1-D bulk copy
//   (cp.async.bulk, sm90::bulk_load) moves it into shared memory, completing
//   on an mbarrier.  Stage s has a thread of its own (lane s / 4 of warp
//   s % 4: the copy instructions of one warp issue one after another),
//   which reads the split's s-th table entry beside the row's length, then
//   initialises the stage's barriers and puts that block's K and V tiles in
//   flight, on barriers of their own, so the scores start before V lands;
//   in the quantized kernel the same thread stores the block's two scales
//   next to the codes and arrives on the barriers once they are there.
//   `stages` tiles of each fit the shared memory the wrapper gives
//   (ops.py::split_plan); a longer context wraps the ring, refilling a
//   stage once the CTA has read its block (a pass then reads no block
//   past those in flight).
// - Compute from shared memory, in decode_common.cuh's row-parallel layout:
//   TPR lanes a token row, 16-byte vector reads, a warp-wide online
//   softmax, the f32 decode of bf16 / f32 / int8 / e4m3 (int8 by byte
//   permutes, not the quarter-rate int-to-float conversion).  The 4 warps
//   share each arrived block (different token rows), each lane taking two
//   rows a pass so that their shuffles and exponentials overlap (with one
//   CTA of 4 warps an SM at the m6 decode step nothing else hides their
//   latency), then merge as the dense kernel merges them.
// - Split over the KV blocks on a thread-block cluster (flash-decoding in
//   one launch).  With `splits` S > 1 the grid is (S, Hkv, N) in clusters
//   of (S, 1, 1); CTA r takes the row's blocks r, r + S, r + 2S, ... (their
//   table entries are known before the length) and reduces them to (m, l,
//   acc); it writes that state into its slot in rank 0's shared memory
//   (distributed shared memory), arrives once on rank 0's merge barrier and
//   leaves; rank 0 merges the S slots in rank order and writes.  No
//   workspace, no atomics, no second kernel, and only rank 0 waits.
// All math is f32, the softmax in base 2 (q pre-scaled by D^-0.5 log2 e);
// one query per (row, head) is a GEMV, so the CUDA cores, not wgmma's
// 64-row tiles, do it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "decode_common.cuh"
#include "sm90.cuh"

namespace paged {

using namespace decode;
namespace cg = cooperative_groups;

constexpr int kMaxStages = 32;   // one thread (lane s / 4 of warp s % 4) a stage
constexpr int kRowsPerLane = 2;  // token rows a lane takes in one pass

// The launch's arguments (pointers, sizes, the split and the ring depth).
struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;   // (P, Hkv), quantized kernel only
  const float* v_scales;
  const int32_t* tables;   // (N, MB)
  const int32_t* lengths;  // (N,)
  void* out;
  int N, Hkv, G, D, bs, MB, splits, stages;
};

// int8 codes (kv_quant="int8"): the integer value, exactly, without the
// quarter-rate int-to-float conversion: the code's byte plus 128 becomes the
// low byte of the f32 2^23 + (code + 128), from which one subtraction
// leaves the code (byte permute and add run at the full rate).
struct FmtInt8 {
  using T = int8_t;
  static constexpr int kPerWord = 4;
  __device__ static void dec(uint32_t w, float* o) {
    const uint32_t u = w ^ 0x80808080u;            // each byte: code + 128
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = __uint_as_float(__byte_perm(u, 0x4Bu, 0x4550u + j)) - 8388736.0f;
  }
};
// float8_e4m3fn bit patterns in int8 (kv_quant="fp8"): Hopper's native
// e4m3x2 -> f16x2 conversion, exact, then f16 -> f32, exact.
struct FmtFp8 {
  using T = int8_t;
  static constexpr int kPerWord = 4;
  __device__ static void dec(uint32_t w, float* o) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)((w >> (16 * j)) & 0xffffu), __NV_E4M3);
      const float2 f = __half22float2(__half2(hr));
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
  }
};

// Dynamic shared memory of a launch: `stages` stages (a K and a V tile,
// their two barriers and two scales), the cluster merge's barrier, and,
// with splits > 1, one (m, l, acc) slot per rank in rank 0 (ops.py's
// split_plan counts the same bytes).
template <typename E>
__host__ __device__ constexpr size_t smem_bytes(int bs, int D, int G, int stages, int splits) {
  return (size_t)stages * (2 * (size_t)bs * D * sizeof(E) + 2 * sizeof(uint64_t) + 2 * sizeof(float)) +
         sizeof(uint64_t) + (splits > 1 ? (size_t)splits * (2 * G + G * D) * sizeof(float) : 0);
}

// rank's copy of a barrier in this CTA's shared memory gets one arrival,
// releasing this thread's (and, through the CTA barrier before it, the
// CTA's) writes at cluster scope
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(sm90::smem_u32(bar)),
               "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

// sm90::mbar_wait with acquire at cluster scope (arrivals from other CTAs)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sm90::smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// The scores of one pass: this lane's ROWS token rows have key dims kf
// (score multipliers k_mul; `live` false past the length); the online
// softmax's max and l over them, and their weights p and the rescale alpha
// (State::update's arithmetic over ROWS rows at once, so that their
// shuffles and exponentials overlap, and split so that it runs before V
// has arrived).
template <int G, int VEC, int TPR, int ROWS>
__device__ __forceinline__ void scores(State<G, VEC>& st, const float (&qr)[G][VEC],
                                       const float (&kf)[ROWS][VEC], const float (&k_mul)[ROWS],
                                       const bool (&live)[ROWS], float (&p)[ROWS][G],
                                       float (&alpha)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float s[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      // four independent partial sums: the dot is a chain of VEC / 4 FMAs
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[e % 4] += qr[g][e] * kf[u][e];
      s[u] = (part[0] + part[1]) + (part[2] + part[3]);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
#pragma unroll
      for (int u = 0; u < ROWS; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      s[u] = live[u] ? s[u] * k_mul[u] : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int o = TPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mn = fmaxf(st.m[g], mx);
    alpha[g] = exp2f(st.m[g] - mn);
    float p_sum = 0.0f;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      p[u][g] = live[u] ? exp2f(s[u] - mn) : 0.0f;
      p_sum += p[u][g];
    }
    st.l[g] = st.l[g] * alpha[g] + p_sum;
    st.m[g] = mn;
  }
}

template <int G, int VEC, int ROWS>
__device__ __forceinline__ void accumulate(State<G, VEC>& st, const float (&p)[ROWS][G],
                                           const float (&alpha)[G], const float (&vf)[ROWS][VEC],
                                           const float (&v_mul)[ROWS]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float pv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) pv[u] = p[u][g] * v_mul[u];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float a = st.acc[g][e] * alpha[g];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) a += pv[u] * vf[u][e];
      st.acc[g][e] = a;
    }
  }
}

// The ring of stages in shared memory: K and V tiles, their barriers, the
// quantized kernel's scales.
template <typename E, bool kScaled>
struct Ring {
  E* k_tiles;
  E* v_tiles;
  uint64_t* full_k;
  uint64_t* full_v;
  float* k_mul;
  float* v_mul;
  int tile, stages;
  uint32_t tile_bytes;

  // block j of the split, (block, kv head) tile bh of the pools, into stage
  // j % stages; the quantized kernel's two scales are loaded here and
  // stored, with the barriers' second arrivals, by publish once needed
  __device__ __forceinline__ void issue(int j, size_t bh, const E* k_pool, const E* v_pool,
                                        const float* k_scales, const float* v_scales,
                                        float& ks, float& vs) const {
    const int s = j % stages;
    sm90::mbar_expect_tx(&full_k[s], tile_bytes);
    sm90::bulk_load(k_tiles + (size_t)s * tile, k_pool + bh * tile, tile_bytes, &full_k[s]);
    sm90::mbar_expect_tx(&full_v[s], tile_bytes);
    sm90::bulk_load(v_tiles + (size_t)s * tile, v_pool + bh * tile, tile_bytes, &full_v[s]);
    if constexpr (kScaled) {
      ks = k_scales[bh];
      vs = v_scales[bh];
    }
  }

  __device__ __forceinline__ void publish(int j, float ks, float vs) const {
    if constexpr (kScaled) {
      const int s = j % stages;
      k_mul[s] = ks;
      sm90::mbar_arrive(&full_k[s]);
      v_mul[s] = vs;
      sm90::mbar_arrive(&full_v[s]);
    }
  }
};

// (launch bounds of one CTA an SM: without the minimum, ptxas held some
// instantiations to 64 or 96 registers and spilled)
template <typename TQ, typename Fmt, bool kScaled, int G, int D>
__global__ void __launch_bounds__(kWarps * 32, 1)
paged_decode_kernel(const TQ* __restrict__ q, const typename Fmt::T* __restrict__ k_pool,
                    const typename Fmt::T* __restrict__ v_pool,
                    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                    const int32_t* __restrict__ tables, const int32_t* __restrict__ lengths,
                    TQ* __restrict__ out, int Hkv, int bs, int MB, int stages, float scale) {
  using E = typename Fmt::T;
  constexpr int VEC = vec_elems<(int)sizeof(E), G, D>();
  constexpr int TPR = D / VEC;          // lanes per token row
  constexpr int RPW = 32 / TPR;         // token rows per warp pass
  constexpr int R = kWarps * RPW;       // token rows per CTA pass and lane row
  constexpr int ROWS = kRowsPerLane;    // token rows a lane takes per pass
  constexpr int SLOT = 2 * G + G * D;   // one rank's (m, l, acc) in the cluster merge
  const int split = blockIdx.x, S = gridDim.x, h = blockIdx.y, i = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = lane / TPR, d0 = (lane % TPR) * VEC;
  const int32_t* table = tables + (size_t)i * MB;
  // stage s belongs to lane s / kWarps of warp s % kWarps, which reads the
  // split's s-th table entry beside the length
  const int my_stage = lane < kMaxStages / kWarps ? lane * kWarps + warp : kMaxStages;
  const int first = split + my_stage * S;
  const int first_blk = (my_stage < stages && first < MB) ? table[first] : 0;
  const int length = lengths[i];
  float qr[G][VEC];                     // in flight with the length and the table
  load_q<TQ, G, VEC, D>(q + ((size_t)i * Hkv + h) * G * D, d0, scale, qr);
  TQ* o = out + ((size_t)i * Hkv + h) * G * D;
  if (length <= 0) {                    // the whole cluster leaves here
    if (split == 0) store_zero(o, G * D);
    return;
  }
  const int ctx = min(length, MB * bs);
  const int nb = (ctx + bs - 1) / bs;
  const int nj = nb > split ? (nb - split + S - 1) / S : 0;   // this split's blocks
  const int tile = bs * D;
  const uint32_t tile_bytes = (uint32_t)(tile * sizeof(E));

  extern __shared__ __align__(128) unsigned char smem[];
  E* k_tiles = reinterpret_cast<E*>(smem);
  E* v_tiles = k_tiles + (size_t)stages * tile;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(v_tiles + (size_t)stages * tile);
  uint64_t* full_v = full_k + stages;
  uint64_t* merged = full_v + stages;  // rank 0: one arrival from every other rank
  float* k_mul = reinterpret_cast<float*>(merged + 1);
  float* v_mul = k_mul + stages;
  float* slots = v_mul + stages;       // rank 0: S slots of SLOT floats
  const Ring<E, kScaled> ring{k_tiles, v_tiles, full_k, full_v, k_mul, v_mul, tile, stages,
                              tile_bytes};
  float ks = 1.0f, vs = 1.0f;          // this thread's stage's scales (quantized kernel)
  // a stage's thread initialises its barriers and, without waiting for the
  // rest of the CTA, issues the split's block into it; the CTA barrier
  // after it orders every thread's waits after the inits
  int issued = min(nj, stages);             // every stage when the ring wraps
  if (my_stage < issued) {
    sm90::mbar_init(&full_k[my_stage], kScaled ? 2 : 1);
    sm90::mbar_init(&full_v[my_stage], kScaled ? 2 : 1);
    if (my_stage == 0 && split == 0 && S > 1) sm90::mbar_init(merged, S - 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    ring.issue(my_stage, (size_t)first_blk * Hkv + h, k_pool, v_pool, k_scales, v_scales, ks,
               vs);
  }
  __syncthreads();
  // rank 0's merge barrier is initialised (and fenced at cluster scope)
  // before any rank arrives on it: the cluster barrier's relaxed arrive
  // here, its wait before the merge
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  State<G, VEC> st;
  st.init();
  if (my_stage < issued) ring.publish(my_stage, ks, vs);   // before this thread waits on a barrier

  // rows [0, rows_end) of the split's blocks are live: all bs of every
  // block but the row's last, which ends at the length
  const int last = split + (nj - 1) * S;
  const int rows_end = nj > 0 ? (nj - 1) * bs + min(bs, ctx - last * bs) : 0;
  const bool wrap = nj > stages;
  const float inv_bs = 1.0f / (float)bs;
  int consumed = 0;
  for (int r0 = 0; r0 < rows_end;) {
    // a pass reads no block past those in flight (a wrapping ring with
    // fewer stages than a pass spans takes more, shorter passes)
    const int pass_end = min(min(r0 + ROWS * R, rows_end),
                             wrap ? (consumed + stages) * bs : rows_end);
    float kf[ROWS][VEC], vf[ROWS][VEC], km[ROWS], vm[ROWS];
    bool live[ROWS];
    int stage[ROWS], at[ROWS];
    uint32_t parity[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = r0 + u * R + warp * RPW + row;
      int j = __float2int_rz((float)r * inv_bs);   // r / bs, then exact
      j += ((j + 1) * bs <= r) - (j * bs > r);
      live[u] = r < pass_end;
      stage[u] = wrap ? j % stages : j;
      parity[u] = wrap ? (uint32_t)(j / stages) & 1u : 0u;
      at[u] = stage[u] * tile + (r - j * bs) * D + d0;
      km[u] = vm[u] = 1.0f;
      if (live[u]) {
        sm90::mbar_wait(&full_k[stage[u]], parity[u]);
        load_vec<Fmt, VEC>(k_tiles + at[u], kf[u]);
        if constexpr (kScaled) km[u] = k_mul[stage[u]];
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[u][e] = 0.0f;
      }
    }
    float p[ROWS][G], alpha[G];
    scores<G, VEC, TPR, ROWS>(st, qr, kf, km, live, p, alpha);
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (live[u]) {
        sm90::mbar_wait(&full_v[stage[u]], parity[u]);
        load_vec<Fmt, VEC>(v_tiles + at[u], vf[u]);
        if constexpr (kScaled) vm[u] = v_mul[stage[u]];
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vf[u][e] = 0.0f;
      }
    }
    accumulate<G, VEC, ROWS>(st, p, alpha, vf, vm);
    if (wrap) {                          // uniform over the CTA
      const int done = min(nj, pass_end / bs);
      if (done > consumed) {             // every thread has read blocks < done
        __syncthreads();
        consumed = done;
        const int target = min(nj, consumed + stages);
        for (int jj = issued; jj < target; ++jj) {
          if (jj % stages == my_stage) {
            ring.issue(jj, (size_t)table[split + jj * S] * Hkv + h, k_pool, v_pool, k_scales,
                       v_scales, ks, vs);
            ring.publish(jj, ks, vs);
          }
        }
        issued = target;
      }
    }
    r0 = pass_end;
  }

  // the warp's rows into one state (m is warp-wide already), then the
  // warps into this CTA's state
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = TPR; off < 32; off <<= 1) {
      st.l[g] += __shfl_xor_sync(0xffffffffu, st.l[g], off);
#pragma unroll
      for (int e = 0; e < VEC; ++e) st.acc[g][e] += __shfl_xor_sync(0xffffffffu, st.acc[g][e], off);
    }
  }
  __shared__ float w_m[kWarps][G], w_l[kWarps][G], w_acc[kWarps][G][D];
  if (lane < TPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        w_m[warp][g] = st.m[g];
        w_l[warp][g] = st.l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) w_acc[warp][g][lane * VEC + e] = st.acc[g][e];
    }
  }
  __syncthreads();
  // with a split, this CTA's state goes into its slot in rank 0 (distributed
  // shared memory), once rank 0's merge barrier is known to be initialised
  float* slot = nullptr;
  if (S > 1) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    slot = cg::this_cluster().map_shared_rank(slots, 0) + split * SLOT;
  }
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, w_m[w][g]);
    float lt = 0.0f, at = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(w_m[w][g] - mt);
      lt += w_l[w][g] * f;
      at += w_acc[w][g][d] * f;
    }
    if (S == 1) {
      from_f32(at / fmaxf(lt, 1e-30f), o + e);
    } else {
      slot[2 * G + e] = at;
      if (d == 0) {
        slot[g] = mt;
        slot[G + g] = lt;
      }
    }
  }
  if (S == 1) return;

  // the cluster's merge: the other ranks arrive once on rank 0's barrier
  // and leave; rank 0 merges the S slots in rank order
  __syncthreads();
  if (split != 0) {
    if (threadIdx.x == 0) mbar_arrive_rank(merged, 0);
    return;
  }
  mbar_wait_cluster(merged, 0);
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D;
    float mt = kNegInf;
    for (int r = 0; r < S; ++r) mt = fmaxf(mt, slots[r * SLOT + g]);
    float lt = 0.0f, at = 0.0f;
    for (int r = 0; r < S; ++r) {
      const float f = exp2f(slots[r * SLOT + g] - mt);
      lt += slots[r * SLOT + G + g] * f;
      at += slots[r * SLOT + 2 * G + e] * f;
    }
    from_f32(at / fmaxf(lt, 1e-30f), o + e);
  }
}

// One launch of grid (splits, Hkv, N) in clusters of (splits, 1, 1).
template <typename TQ, typename Fmt, bool kScaled, int G, int D>
cudaError_t launch_gd(const Args& a, cudaStream_t stream) {
  using E = typename Fmt::T;
  auto kernel = paged_decode_kernel<TQ, Fmt, kScaled, G, D>;
  const size_t smem = smem_bytes<E>(a.bs, D, G, a.stages, a.splits);
  // past 48 KB of static and dynamic shared memory together a kernel must
  // opt in: once per instantiation, to all the block may have
  static bool opted_in = false;
  if (!opted_in) {
    int device = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.Hkv, a.N);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const float scale = 1.4426950408889634f / sqrtf((float)D);   // D^-0.5 log2(e)
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const TQ*)a.q, (const E*)a.k_pool, (const E*)a.v_pool, a.k_scales,
      a.v_scales, a.tables, a.lengths, (TQ*)a.out, a.Hkv, a.bs, a.MB, a.stages, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TQ, typename Fmt, bool kScaled, int G>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch_gd<TQ, Fmt, kScaled, G, 32>(a, stream);
    case 64: return launch_gd<TQ, Fmt, kScaled, G, 64>(a, stream);
    case 128: return launch_gd<TQ, Fmt, kScaled, G, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Checks what the kernel takes (the wrapper checks the same first) and
// launches on `stream`; N = 0 launches nothing.
template <typename TQ, typename Fmt, bool kScaled>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.N == 0) return cudaSuccess;
  const bool splits_ok = a.splits == 1 || a.splits == 2 || a.splits == 4 || a.splits == 8;
  if (!splits_ok || a.stages < 1 || a.stages > kMaxStages || a.bs < 1 || a.MB < 1 ||
      (a.bs * a.D * sizeof(typename Fmt::T)) % 16)
    return cudaErrorInvalidValue;
  switch (a.G) {
    case 1: return launch_g<TQ, Fmt, kScaled, 1>(a, stream);
    case 2: return launch_g<TQ, Fmt, kScaled, 2>(a, stream);
    case 4: return launch_g<TQ, Fmt, kScaled, 4>(a, stream);
    case 8: return launch_g<TQ, Fmt, kScaled, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace paged

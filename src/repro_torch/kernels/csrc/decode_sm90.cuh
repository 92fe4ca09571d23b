// Decode attention on Hopper (sm_90a): the device code of the three decode
// kernels, paged_decode_attention.cu (bf16 / f32 pools),
// quantized_paged_decode_attention.cu (int8 / e4m3 codes with one f32 scale
// per (block, kv head)) and decode_attention.cu (a dense (B, T, Hkv, D)
// cache).
//
// What it computes: one query per row i and kv head h, G grouped query
// heads, over positions [0, lengths[i]) of the row's context:
//   out[i, h, g] = softmax(q[i, h, g] . K^T * D^-0.5) V,
// paged: K[p] = dec(k_pool[tables[i, p / bs], h, p % bs]) * k_scale (1 unscaled);
// dense: K[p] = k[i, p, h].
// A row of length 0 writes exactly 0; positions past the length are neither
// read nor weighted (the finite NEG_INF mask of the TPU kernels).
//
// What bounds it at decode sizes: latency, not bytes.  The m6 decode step
// (8 rows of 21-112 positions, 16 kv heads of 64) moves 1.84 MB of K/V,
// 0.56 us at 3.35 TB/s; a kernel that waits on its loads tile by tile pays
// one dependent DRAM round trip (about a microsecond) per tile.
//
// Design: pay one round trip a CTA, not one a tile.  The context is read
// in tiles of `bs` positions of one kv head; the two layouts differ only in
// where tile j is and how it is copied (the Tiles policies below):
// - Paged (PagedTiles): a (block, kv head) tile of the (P, Hkv, bs, D) pool
//   is one contiguous run of bs * D elements, moved by one 1-D bulk copy
//   (cp.async.bulk, sm90::bulk_load); its address comes from the block
//   table, read beside the row's length, so the copies wait for both.  In
//   the quantized kernel the issuing thread stores the block's two scales
//   next to the codes and arrives on the barriers once they are there.
// - Dense (DenseTiles): the positions of one (row, kv head) sit at a fixed
//   stride in the (B, T, Hkv, D) cache, so a tile is a box (D, 1, bs, 1) of
//   a 4-D tensor map over (D, Hkv, T, B) built from the tensors' strides,
//   moved by one TMA load (sm90::tma_load_4d).  Its address needs nothing
//   but the tile's index, so the tiles of the first pass are issued at
//   kernel entry, beside the length's load, and the rest of the ring once
//   the length is known: the first pass waits one round trip where the
//   paged kernel's waits two.  (Issuing the whole ring at entry measured
//   slower: every row shorter than the plan's longest then fetches tiles
//   it never reads.)  Boxes past T are clipped by the copy engine; tiles
//   issued past the length are waited for (a CTA must not exit with a copy
//   in flight) and never read.
// - The ring.  Stage s has a thread of its own (lane s / 4 of warp s % 4:
//   the copy instructions of one warp issue one after another), which
//   initialises the stage's barriers and puts the split's s-th K and V
//   tiles in flight, on barriers of their own, so the scores start before
//   V lands.  `stages` tiles of each fit the shared memory the wrapper
//   gives (ops.py::split_plan); a longer context wraps the ring, refilling
//   a stage once the CTA has read its tile (a pass then reads no tile past
//   those in flight).
// - Compute from shared memory, in decode_common.cuh's row-parallel layout:
//   TPR lanes a token row (D = 224, zamba2-7b's shared attention and the
//   dense kernel's only width that is no power of two: 28 lanes of 8
//   elements and 4 idle lanes holding zeros), 16-byte vector reads, a warp-wide online
//   softmax, the f32 decode of bf16 / f32 / int8 / e4m3 (int8 by byte
//   permutes, not the quarter-rate int-to-float conversion).  The 4 warps
//   share each arrived tile (different token rows), each lane taking two
//   rows a pass so that their shuffles and exponentials overlap (with one
//   CTA of 4 warps an SM at the m6 decode step nothing else hides their
//   latency), then merge through shared memory.
// - Split over the tiles on a thread-block cluster (flash-decoding in one
//   launch).  With `splits` S > 1 the grid is (S, Hkv, N) in clusters of
//   (S, 1, 1); CTA r takes the row's tiles r, r + S, r + 2S, ... and
//   reduces them to (m, l, acc); it writes that state into its slot in
//   rank 0's shared memory (distributed shared memory), arrives once on
//   rank 0's merge barrier and leaves; rank 0 merges the S slots in rank
//   order and writes.  No workspace, no atomics, no second kernel, and only
//   rank 0 waits.
// - The logit softcap (the reference's _sdpa: s <- c tanh(s / c) on the
//   natural-scale score s = q . k D^-0.5, before the softmax).  With a cap
//   c > 0 each live score becomes (c log2 e) tanhf(s2 / (c log2 e)) on the
//   base-2 score s2 = s log2 e, before the running max, so every split sees
//   capped scores and the merge is unchanged.  The cap is a template flag
//   (kCap), instantiated for the dense tiles alone (the continuous engine,
//   which runs the paged kernels, refuses a cap): a runtime branch in the
//   score loop cost the uncapped dense kernel 4 % on an H100 at the static
//   engine's shape, and the kCap = false kernels are the arithmetic of
//   before.
// All math is f32, the softmax in base 2 (q pre-scaled by D^-0.5 log2 e);
// one query per (row, head) is a GEMV, so the CUDA cores, not wgmma's
// 64-row tiles, do it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "decode_common.cuh"
#include "sm90.cuh"

namespace decode_sm90 {

using namespace decode;
namespace cg = cooperative_groups;

constexpr int kMaxStages = 32;   // one thread (lane s / 4 of warp s % 4) a stage
constexpr int kRowsPerLane = 2;  // token rows a lane takes in one pass

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
// has arrived).  kCap caps each score at cap2 in base 2 (cap2 = c log2 e,
// inv_cap2 its reciprocal).
template <int G, int VEC, int LANES, int ROWS, bool kCap>
__device__ __forceinline__ void scores(State<G, VEC>& st, const float (&qr)[G][VEC],
                                       const float (&kf)[ROWS][VEC], const float (&k_mul)[ROWS],
                                       const bool (&live)[ROWS], float (&p)[ROWS][G],
                                       float (&alpha)[G], float cap2, float inv_cap2) {
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
    for (int o = 1; o < LANES; o <<= 1)
#pragma unroll
      for (int u = 0; u < ROWS; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      float x = s[u] * k_mul[u];
      if constexpr (kCap) x = cap2 * tanhf(x * inv_cap2);
      s[u] = live[u] ? x : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int o = LANES; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
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

  // the barriers of tile j's stage, each armed for one tile's bytes
  __device__ __forceinline__ int arm(int j) const {
    const int s = j % stages;
    sm90::mbar_expect_tx(&full_k[s], tile_bytes);
    sm90::mbar_expect_tx(&full_v[s], tile_bytes);
    return s;
  }

  // the quantized kernel's scales of tile j, stored with the barriers'
  // second arrivals once needed
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

// Where tile j of a row is and how it is copied, for the paged layout: the
// (block, kv head) tile tables[i, j] of the (P, Hkv, bs, D) pools.
template <typename E, bool kScaled_>
struct PagedTiles {
  static constexpr bool kScaled = kScaled_;
  static constexpr bool kEarly = false;   // the copies need the table, read beside the length
  static constexpr bool kD16 = false;     // D in (32, 64, 128)
  static constexpr bool kD224 = false;
  static constexpr bool kCapped = false;  // no softcap instantiation
  static constexpr int kAlign = 16;       // shared-memory alignment of a tile (bulk copies)
  const E* k_pool;
  const E* v_pool;
  const float* k_scales;   // (P, Hkv), quantized kernel only
  const float* v_scales;
  const int32_t* tables;   // (N, MB)
  int bs, MB;
  int tiles;               // MB: a row's tiles
  int capacity;            // MB * bs: positions a row can hold

  // the pool block of row i's tile j (any j < MB)
  __device__ __forceinline__ int block(int i, int j) const { return tables[(size_t)i * MB + j]; }

  __device__ __forceinline__ void issue(const Ring<E, kScaled>& ring, int j, int blk, int i, int h,
                                        int Hkv, float& ks, float& vs) const {
    const size_t bh = (size_t)blk * Hkv + h;
    const int s = ring.arm(j);
    sm90::bulk_load(ring.k_tiles + (size_t)s * ring.tile, k_pool + bh * ring.tile,
                    ring.tile_bytes, &ring.full_k[s]);
    sm90::bulk_load(ring.v_tiles + (size_t)s * ring.tile, v_pool + bh * ring.tile,
                    ring.tile_bytes, &ring.full_v[s]);
    if constexpr (kScaled) {
      ks = k_scales[bh];
      vs = v_scales[bh];
    }
  }
};

// The dense layout: tile j of row i and kv head h is the box (D, 1, bs, 1)
// at (0, h, j * bs, i) of the tensor maps over (D, Hkv, T, B); rows past T
// are clipped (read as 0, never weighted).
template <typename E>
struct DenseTiles {
  static constexpr bool kScaled = false;
  static constexpr bool kEarly = true;    // every copy is known before the length
  static constexpr bool kD16 = true;      // D in (16, 32, 64, 128), and 224 at G = 1
  static constexpr bool kD224 = true;     // (zamba2-7b's shared attention)
  static constexpr bool kCapped = true;   // a softcap instantiation beside each kernel
  static constexpr int kAlign = 128;      // shared-memory alignment of a tile (TMA boxes)
  CUtensorMap k_map;
  CUtensorMap v_map;
  int bs;
  int tiles;               // ceil(T / bs)
  int capacity;            // T

  __device__ __forceinline__ int block(int, int j) const { return j; }

  __device__ __forceinline__ void issue(const Ring<E, false>& ring, int j, int blk, int i, int h,
                                        int, float&, float&) const {
    const int s = ring.arm(j);
    sm90::tma_load_4d(ring.k_tiles + (size_t)s * ring.tile, &k_map, &ring.full_k[s], 0, h,
                      blk * bs, i);
    sm90::tma_load_4d(ring.v_tiles + (size_t)s * ring.tile, &v_map, &ring.full_v[s], 0, h,
                      blk * bs, i);
  }
};

// (launch bounds of one CTA an SM: without the minimum, ptxas held some
// instantiations to 64 or 96 registers and spilled)
template <typename TQ, typename Fmt, typename Tiles, int G, int D, bool kCap>
__global__ void __launch_bounds__(kWarps * 32, 1)
decode_kernel(const __grid_constant__ Tiles src, const TQ* __restrict__ q,
              const int32_t* __restrict__ lengths, TQ* __restrict__ out, int Hkv, int stages,
              float scale, float cap2, float inv_cap2) {
  using E = typename Fmt::T;
  constexpr bool kScaled = Tiles::kScaled;
  constexpr int VEC = vec_elems<(int)sizeof(E), G, D>();
  constexpr int TPR = D / VEC;          // lanes holding a token row's dims
  constexpr int LANES = ceil_pow2(TPR); // lanes a token row spans (the rest idle)
  constexpr int RPW = 32 / LANES;       // token rows per warp pass
  static_assert(TPR * VEC == D && LANES <= 32, "a token row within one warp");
  constexpr int R = kWarps * RPW;       // token rows per CTA pass and lane row
  constexpr int ROWS = kRowsPerLane;    // token rows a lane takes per pass
  constexpr int SLOT = 2 * G + G * D;   // one rank's (m, l, acc) in the cluster merge
  const int split = blockIdx.x, S = gridDim.x, h = blockIdx.y, i = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // an idle lane (D = 224: the last 4 of each 32) holds zero q, K and V, so
  // it adds nothing to the shuffles' sums and writes nothing
  const bool dims = lane % LANES < TPR;
  const int row = lane / LANES, d0 = dims ? (lane % LANES) * VEC : 0;
  const int bs = src.bs;
  const int tile = bs * D;
  const uint32_t tile_bytes = (uint32_t)(tile * sizeof(E));

  // the dynamic shared memory, aligned for the copies (the launch adds the
  // slack); a TMA ring's tiles are multiples of 128 bytes (its entry checks)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if constexpr (Tiles::kAlign > 16) {
    const uint32_t mis = sm90::smem_u32(smem_raw) & (Tiles::kAlign - 1);
    smem += mis ? Tiles::kAlign - mis : 0;
  }
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

  // stage s belongs to lane s / kWarps of warp s % kWarps, which puts the
  // split's s-th tile in flight: at once where its place is known without
  // the length (dense), else once the length and its table entry are read
  const int my_stage = lane < kMaxStages / kWarps ? lane * kWarps + warp : kMaxStages;
  const int first = split + my_stage * S;
  const int first_blk =
      (!Tiles::kEarly && my_stage < stages && first < src.tiles) ? src.block(i, first) : first;
  const int length = lengths[i];
  float ks = 1.0f, vs = 1.0f;          // this thread's stage's scales (quantized kernel)
  // a stage's thread initialises its barriers and, without waiting for the
  // rest of the CTA, issues the split's tile into it; the CTA barrier
  // after it orders every thread's waits after the inits
  auto start = [&](int lo, int hi) {
    if (my_stage >= lo && my_stage < hi) {
      sm90::mbar_init(&full_k[my_stage], kScaled ? 2 : 1);
      sm90::mbar_init(&full_v[my_stage], kScaled ? 2 : 1);
      if (my_stage == 0 && split == 0 && S > 1) sm90::mbar_init(merged, S - 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      src.issue(ring, my_stage, first_blk, i, h, Hkv, ks, vs);
    }
  };
  // tiles put in flight before the length is known (dense): those of the
  // first pass, within the cache and the ring.  More would be fetched for
  // nothing by every row shorter than the plan's longest; fewer leave the
  // first pass waiting on a second round trip.
  int early = 0;
  if constexpr (Tiles::kEarly) {
    const int first_pass = (ROWS * R + bs - 1) / bs;
    early = min(min(stages, first_pass), src.tiles > split ? (src.tiles - split + S - 1) / S : 0);
    start(0, early);
  }
  float qr[G][VEC] = {};                // in flight with the length (and the table)
  if (dims) load_q<TQ, G, VEC, D>(q + ((size_t)i * Hkv + h) * G * D, d0, scale, qr);
  TQ* o = out + ((size_t)i * Hkv + h) * G * D;
  const int ctx = min(length, src.capacity);
  const int nb = ctx > 0 ? (ctx + bs - 1) / bs : 0;
  const int nj = nb > split ? (nb - split + S - 1) / S : 0;   // this split's tiles
  // a tile issued past the length is never read: its thread waits for it
  // (no copy may be in flight when the CTA exits)
  auto drain = [&]() {
    if constexpr (Tiles::kEarly) {
      if (my_stage < early && my_stage >= nj) {
        sm90::mbar_wait(&full_k[my_stage], 0);
        sm90::mbar_wait(&full_v[my_stage], 0);
      }
    }
  };
  if (length <= 0) {                    // the whole cluster leaves here
    drain();
    if (split == 0) store_zero(o, G * D);
    return;
  }
  // the rest of the ring (every stage when it wraps), now that the length is known
  int issued = max(early, min(nj, stages));
  start(early, issued);
  __syncthreads();
  // rank 0's merge barrier is initialised (and fenced at cluster scope)
  // before any rank arrives on it: the cluster barrier's relaxed arrive
  // here, its wait before the merge
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  State<G, VEC> st;
  st.init();
  if (my_stage < issued) ring.publish(my_stage, ks, vs);   // before this thread waits on a barrier

  // rows [0, rows_end) of the split's tiles are live: all bs of every
  // tile but the row's last, which ends at the length
  const int last = split + (nj - 1) * S;
  const int rows_end = nj > 0 ? (nj - 1) * bs + min(bs, ctx - last * bs) : 0;
  const bool wrap = nj > stages;
  const float inv_bs = 1.0f / (float)bs;
  int consumed = 0;
  for (int r0 = 0; r0 < rows_end;) {
    // a pass reads no tile past those in flight (a wrapping ring with
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
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[u][e] = 0.0f;
      if (live[u]) {
        sm90::mbar_wait(&full_k[stage[u]], parity[u]);
        if (dims) load_vec<Fmt, VEC>(k_tiles + at[u], kf[u]);
        if constexpr (kScaled) km[u] = k_mul[stage[u]];
      }
    }
    float p[ROWS][G], alpha[G];
    scores<G, VEC, LANES, ROWS, kCap>(st, qr, kf, km, live, p, alpha, cap2, inv_cap2);
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vf[u][e] = 0.0f;
      if (live[u]) {
        sm90::mbar_wait(&full_v[stage[u]], parity[u]);
        if (dims) load_vec<Fmt, VEC>(v_tiles + at[u], vf[u]);
        if constexpr (kScaled) vm[u] = v_mul[stage[u]];
      }
    }
    accumulate<G, VEC, ROWS>(st, p, alpha, vf, vm);
    if (wrap) {                          // uniform over the CTA
      const int done = min(nj, pass_end / bs);
      if (done > consumed) {             // every thread has read tiles < done
        __syncthreads();
        consumed = done;
        const int target = min(nj, consumed + stages);
        for (int jj = issued; jj < target; ++jj) {
          if (jj % stages == my_stage) {
            src.issue(ring, jj, src.block(i, split + jj * S), i, h, Hkv, ks, vs);
            ring.publish(jj, ks, vs);
          }
        }
        issued = target;
      }
    }
    r0 = pass_end;
  }
  drain();

  // the warp's rows into one state (m is warp-wide already), then the
  // warps into this CTA's state
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = LANES; off < 32; off <<= 1) {
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

// The launch's arguments beside the layout: q, lengths, out, sizes, the
// split, the ring's depth and the logit softcap (0: none).
struct Launch {
  const void* q;
  const int32_t* lengths;  // (N,)
  void* out;
  int N, Hkv, G, D, splits, stages;
  float softcap;
};

// One launch of grid (splits, Hkv, N) in clusters of (splits, 1, 1).
template <typename TQ, typename Fmt, typename Tiles, int G, int D, bool kCap>
cudaError_t launch_k(const Tiles& src, const Launch& a, cudaStream_t stream) {
  using E = typename Fmt::T;
  auto kernel = decode_kernel<TQ, Fmt, Tiles, G, D, kCap>;
  const size_t smem = smem_bytes<E>(src.bs, D, G, a.stages, a.splits) +
                      (Tiles::kAlign > 16 ? Tiles::kAlign : 0);
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
  const float cap2 = a.softcap > 0.0f ? a.softcap * 1.4426950408889634f : 0.0f;
  const float inv_cap2 = cap2 > 0.0f ? 1.0f / cap2 : 0.0f;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, src, (const TQ*)a.q, a.lengths,
                                             (TQ*)a.out, a.Hkv, a.stages, scale, cap2, inv_cap2);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The capped kernel where a softcap is asked for (dense tiles only), else
// the uncapped one.
template <typename TQ, typename Fmt, typename Tiles, int G, int D>
cudaError_t launch_gd(const Tiles& src, const Launch& a, cudaStream_t stream) {
  if (a.softcap > 0.0f) {
    if constexpr (Tiles::kCapped) return launch_k<TQ, Fmt, Tiles, G, D, true>(src, a, stream);
    return cudaErrorInvalidValue;
  }
  return launch_k<TQ, Fmt, Tiles, G, D, false>(src, a, stream);
}

template <typename TQ, typename Fmt, typename Tiles, int G>
cudaError_t launch_g(const Tiles& src, const Launch& a, cudaStream_t stream) {
  switch (a.D) {
    case 16:
      if constexpr (Tiles::kD16) return launch_gd<TQ, Fmt, Tiles, G, 16>(src, a, stream);
      return cudaErrorInvalidValue;
    case 32: return launch_gd<TQ, Fmt, Tiles, G, 32>(src, a, stream);
    case 64: return launch_gd<TQ, Fmt, Tiles, G, 64>(src, a, stream);
    case 128: return launch_gd<TQ, Fmt, Tiles, G, 128>(src, a, stream);
    case 224:
      if constexpr (Tiles::kD224 && G == 1) return launch_gd<TQ, Fmt, Tiles, G, 224>(src, a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// Checks what the kernel takes (the wrappers check the same first) and
// launches on `stream`; N = 0 launches nothing.
template <typename TQ, typename Fmt, typename Tiles>
cudaError_t launch(const Tiles& src, const Launch& a, cudaStream_t stream) {
  if (a.N == 0) return cudaSuccess;
  const bool splits_ok = a.splits == 1 || a.splits == 2 || a.splits == 4 || a.splits == 8;
  if (!splits_ok || a.stages < 1 || a.stages > kMaxStages || src.bs < 1 || src.tiles < 1 ||
      (src.bs * a.D * sizeof(typename Fmt::T)) % 16 || !(a.softcap >= 0.0f))
    return cudaErrorInvalidValue;
  switch (a.G) {
    case 1: return launch_g<TQ, Fmt, Tiles, 1>(src, a, stream);
    case 2: return launch_g<TQ, Fmt, Tiles, 2>(src, a, stream);
    case 3: return launch_g<TQ, Fmt, Tiles, 3>(src, a, stream);
    case 4: return launch_g<TQ, Fmt, Tiles, 4>(src, a, stream);
    case 5: return launch_g<TQ, Fmt, Tiles, 5>(src, a, stream);
    case 8: return launch_g<TQ, Fmt, Tiles, 8>(src, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The paged kernels' launch: pools, their scales (quantized kernel) and the
// block tables (N, MB).
template <typename TQ, typename Fmt, bool kScaled>
cudaError_t launch_paged(const Launch& a, const void* k_pool, const void* v_pool,
                         const float* k_scales, const float* v_scales, const int32_t* tables,
                         int bs, int MB, cudaStream_t stream) {
  using E = typename Fmt::T;
  const PagedTiles<E, kScaled> src{(const E*)k_pool, (const E*)v_pool, k_scales, v_scales,
                                   tables, bs, MB, MB, MB * bs};
  return launch<TQ, Fmt>(src, a, stream);
}

}  // namespace decode_sm90

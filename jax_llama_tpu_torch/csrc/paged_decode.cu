// Paged-attention decode over a block-table KV pool for Hopper (sm_90a),
// plain C entry point: split-KV flash-decoding, tensor cores for bf16 q.
//
// Replaces the TPU kernel `paged_pool_attention` of
// jax_llama_tpu/ops/paged_attention.py (pallas_call at :371, body
// `_paged_kernel` at :79), for T >= 1 query tokens per row and a bf16,
// float32 or int8 pool (the int8 branch at :110-113, :163-204, scale
// planes at :355-368).  The T queries of a row sit at
// CONSECUTIVE positions (token t at q_pos[b] + t: one decode token at T=1,
// the speculative verify block at T = n_draft + 1) and are packed with the
// G query heads of their KV head as rows r = t*G + g:
//
//   out[b, h, r] = sum_s softmax_s(q[b,h,r] . k[layer,h,blk(s),off(s)] / sqrt(d))
//                  v[layer,h,blk(s),off(s)]
//   lse[b, h, r] = log sum_s exp(q[b,h,r] . k[...] / sqrt(d))
//
// over the slots s of the blocks that row b's table names, restricted to
// 0 <= pool_pos[blk, off] <= q_pos[b] + r / G.  A row with q_pos = -1 is
// inactive; a packed row that sees no live slot (token 0 of a row whose
// pool is still empty, say) writes out = 0 and lse = MASK_VALUE (the JAX
// kernel's finalize), so the caller's merge weight exp(lse - m) underflows
// to exactly 0.
//
// Layout: q [B, KVH, T*G, d] in the pool's dtype (query head h_q = kvh*G +
// g); k_pool, v_pool [L, KVH, NB, BLK, d] contiguous; pool_pos [NB, BLK]
// int32 (-1 = invalid slot); table [B, MB] int32 physical block ids, NB
// (or any id outside [0, NB)) marks an unused entry; q_pos [B] int32, the
// FIRST token's position.  out [B, KVH, T*G, d] and lse [B, KVH, T*G] are
// float32, as in the JAX kernel.  Any block size works: each slot's row
// address comes from the table, and a K/V row is d * sizeof(T) bytes, a
// multiple of 16.  Scratch (the caller's, float32): o_part [B, KVH, NS,
// T*G, d], m_part and l_part [B, KVH, NS, T*G], NS = ceil(MB*BLK / SPLIT).
//
// int8 pool: k_pool, v_pool int8 [L, KVH, NB, BLK, d] with float32
// per-slot-per-head scales k_scale, v_scale [L, KVH, NB, BLK]; q, out and
// lse as above (q bf16 or float32).  Both scales fold per slot, as the JAX
// kernel folds them: each score q.k is multiplied by its slot's k_scale
// BEFORE the mask (an unwritten slot carries scale 0 and payload 0, and a
// score of 0 is not -inf: the mask must still exclude it), and each
// probability by its slot's v_scale before it is rounded to q's dtype
// for the P.V product (l sums the unscaled P).  The layer's planes are
// reached by pointer offset, never sliced or copied.
//
// What bounds it on an H100: memory.  A step does ~4·T·G·d FLOPs per live
// slot and moves 2·d·bytes(dtype) of K/V per slot and KV head: at the
// verify shape (T*G = 16) about 16 FLOP per byte, far below the ~295
// FLOP/byte at which the tensor cores would become the limit.  The least
// time is the live slots' K/V over HBM bandwidth, and what keeps a kernel
// from it is how much of that K/V is in flight at once.  The design:
//   * Split pass: one block per (split, KV head, row).  A split is a fixed
//     run of SPLIT = 256 slots in table order (slot j = offset j % BLK of
//     table entry j / BLK: two entries at BLK = 128), so its bounds depend
//     only on the table layout.  At llama3-8b's serving shape that is up
//     to 8 x 8 x 8 = 512 blocks on 132 SMs, where one block per (row, KV
//     head) gave 64.  The block first reads its split's positions: an
//     inactive row (q_pos = -1) returns at once, a split with no slot the
//     row's LAST token may attend (every split past the row's live-block
//     bound, JAX :313-333) writes an empty partial (m = -inf, l = 0)
//     without touching K or V, and within a live split each 64-slot tile
//     with no such slot is skipped without a load: processing a wholly
//     masked tile would add exp(MASK - MASK) = 1 of garbage (JAX
//     :128-141), so skipping is required, not an optimisation.
//   * Double buffer: the tile's K and V rows (and an int8 tile's scales)
//     are copied into dynamic shared memory with cp.async, 16 bytes a
//     copy; the next live tile's copies are in flight during this tile's
//     math.  A sentinel entry or a slot past the table is zero-filled by
//     the copy itself (src-size 0) and masked by its position.
//   * Tensor cores for bf16 q: Q.K^T and P.V by mma.sync m16n8k16 (bf16
//     in, float32 accumulate); the packed rows are padded to m-tiles of
//     16 (T=1, G=4 is 4 live rows of 16: free in a memory-bound kernel).
//     With one m-tile (up to 16 packed rows) the four warps split each
//     tile's 64 slots, 16 each; with two, two warps per m-tile take 32
//     slots each; with three or four (up to MAX_ROWS = 64 packed rows),
//     one warp per m-tile takes all 64.  Each warp keeps its own (m, l,
//     acc) in registers and the warps of one m-tile join them in shared
//     memory at the end.  An int8 tile is widened into a bf16 shared tile
//     once per tile (int8 values are exact in bf16) and its float32 scales
//     sit beside it, so the products are the bf16 instance's.
//   * Float32 q (float32 pools, or int8 pools with float32 q) keeps a
//     CUDA-core inner loop (one thread per (packed row, slot) score, one
//     warp per row's softmax, one feature column per thread in P.V) over
//     the same split grid and double buffer.
//   * Masking: at T > 1 a tile can be live for a late token and wholly
//     masked for an early one (the skip is per tile, the mask per packed
//     row).  Each (row, slot) pair the row may not attend gets p = 0, and
//     a row whose running max is still -inf takes p = 0 and alpha = 1, so
//     no exp(-inf - -inf) reaches l or acc.
//   * The online softmax runs in float32, in base 2 (log2(e)/sqrt(d)
//     folded into one scale); P is rounded to the pool dtype (bf16) or to
//     q's dtype (int8) before P.V, l sums the unrounded P.
//   * Combine pass: one block per (KV head, row) reads the m and l of the
//     row's splits, and the partial outputs of only the splits that saw a
//     slot, rescales them to the common max, and writes out and lse.  A
//     packed row that no split saw writes out = 0, lse = MASK_VALUE.
//   * No atomics and a fixed order of every sum: identical inputs give
//     bit-identical outputs, which self-draft acceptance of exactly 1.0
//     needs (each draft-chain step replays the verify's T through the
//     same kernel).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <math.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;       // query heads per KV head
constexpr int MAX_ROWS = 64;  // packed rows (T*G) a launch holds
constexpr int SPLIT = 256;    // slots per split, in table order
constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;
constexpr float LN2 = 0.69314718055994530942f;

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four float32 values, or eight bf16 values (a 16-bit shift each), from
// 16 aligned bytes of shared memory.
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
// Sixteen int8 values, as float32 (exact).  Each byte is biased to an
// unsigned value u = b + 128 (b ^ 0x80) and placed in the mantissa of
// 2^23, so float(b) = as_float(0x4B000000 | u) - (2^23 + 128): integer
// logic and one float add, several times the rate of the int -> float
// conversion instruction.
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[16]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[4 * i + j] =
          __uint_as_float(0x4B000000u | ((u >> (8 * j)) & 0xffu)) -
          8388736.f;
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// 16 bytes global -> shared without holding a register; src_bytes 0 fills
// the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// The same for one 4-byte value (a slot's scale).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one group (the next tile's copies) is in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// The shared-memory layout of a split block: the split's positions and
// source slots, the list of its live tiles, the tiles' scales (int8), two
// stages of raw K/V tiles and (int8 with bf16 q) the widened bf16 tiles.
// T: pool element type; D: head_dim; TS: slots per tile; WIDEN: the int8
// tile is widened into a bf16 tile for the tensor cores.
template <typename T, int D, int TS, bool WIDEN>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int CH = D / VEC;          // copies per K/V row
  static constexpr int LDE = D + VEC;         // padded raw row (elements)
  static constexpr int RAW_TILE = TS * LDE * sizeof(T);
  static constexpr int LDB = D + 8;           // widened bf16 row (elements)
  static constexpr int BF_TILE = WIDEN ? TS * LDB * 2 : 0;
  static constexpr int NT = SPLIT / TS;       // tiles per split
  static constexpr int HDR = (2 * SPLIT + NT + 4) * 4;
  static constexpr int SCALES = sizeof(T) == 1 ? 2 * 2 * TS * 4 : 0;
  static constexpr int RAW0 = ((HDR + SCALES) + 127) / 128 * 128;
  static constexpr int BF0 = RAW0 + 4 * RAW_TILE;  // K, V x 2 stages
  static constexpr int BYTES = BF0 + 2 * BF_TILE;
};

// The split's positions (-1, a sentinel entry and a slot past the table
// remapped to INT_MAX, so one compare masks them) and source slots (-1:
// nothing to read) into pos_s / src_s, and the list of its tiles that hold
// a slot the last token may attend into tiles_s.  Returns their count.
template <int TS>
__device__ int split_setup(const int* __restrict__ pool_pos,
                           const int* __restrict__ trow, int NB, int BLK,
                           int start, int end, int qp_last, int* pos_s,
                           int* src_s, int* tiles_s, int* count_s) {
  constexpr int NT = SPLIT / TS;
  const int tid = threadIdx.x;
  for (int i = tid; i < SPLIT; i += NTHREADS) {
    const int slot = start + i;
    int flat = -1, p = INT_MAX;
    if (slot < end) {
      const int blk = trow[slot / BLK];
      if (blk >= 0 && blk < NB) {
        flat = blk * BLK + slot % BLK;
        const int raw = pool_pos[flat];
        p = raw < 0 ? INT_MAX : raw;
      }
    }
    pos_s[i] = p;
    src_s[i] = flat;
  }
  __syncthreads();
  if (tid < 32) {
    int n = 0;
    for (int t = 0; t < NT; ++t) {
      bool live = false;
      for (int j = tid; j < TS; j += 32) live |= pos_s[t * TS + j] <= qp_last;
      if (__any_sync(0xffffffffu, live)) {
        if (tid == 0) tiles_s[n] = t;
        ++n;
      }
    }
    if (tid == 0) *count_s = n;
  }
  __syncthreads();
  return *count_s;
}

// Start the copies of tile `tile` of the split into stage buffers kdst,
// vdst (row stride LDE elements), and its scales (int8) into ksc, vsc.
template <typename T, int D, int TS, bool WIDEN>
__device__ __forceinline__ void copy_tile(
    unsigned char* kdst, unsigned char* vdst, float* ksc, float* vsc,
    const T* __restrict__ kplane, const T* __restrict__ vplane,
    const float* __restrict__ ksplane, const float* __restrict__ vsplane,
    const int* src_s, int tile) {
  using L = Layout<T, D, TS, WIDEN>;
  const int* src = src_s + tile * TS;
  for (int c = threadIdx.x; c < TS * L::CH; c += NTHREADS) {
    const int j = c / L::CH, col = c % L::CH;
    const int flat = src[j];
    const size_t off = (size_t)(flat < 0 ? 0 : flat) * D + col * L::VEC;
    const int bytes = flat < 0 ? 0 : 16;
    const int dst = (j * L::LDE + col * L::VEC) * (int)sizeof(T);
    cp_async16(kdst + dst, kplane + off, bytes);
    cp_async16(vdst + dst, vplane + off, bytes);
  }
  if constexpr (sizeof(T) == 1) {
    if (threadIdx.x < TS) {
      const int flat = src[threadIdx.x];
      const int bytes = flat < 0 ? 0 : 4;
      const size_t off = flat < 0 ? 0 : flat;
      cp_async4(ksc + threadIdx.x, ksplane + off, bytes);
      cp_async4(vsc + threadIdx.x, vsplane + off, bytes);
    }
  }
}

// A raw int8 tile widened into a bf16 tile (row stride LDB): 16 values a
// thread-step, exact.
template <int D, int TS>
__device__ __forceinline__ void widen_tile(uint16_t* dst,
                                           const int8_t* src) {
  using L = Layout<int8_t, D, TS, true>;
  for (int c = threadIdx.x; c < TS * (D / 16); c += NTHREADS) {
    const int j = c / (D / 16), col = (c % (D / 16)) * 16;
    float x[16];
    load_vec(src + j * L::LDE + col, x);
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = pack_bf16x2(x[2 * i], x[2 * i + 1]);
    uint4* d4 = reinterpret_cast<uint4*>(dst + j * L::LDB + col);
    d4[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d4[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// The split pass for bf16 q on the tensor cores.  T: pool element type
// (__nv_bfloat16, or int8_t with scales); D: head_dim; MT: m-tiles of 16
// packed rows (1, 2 or 4).
template <typename T, int D, int MT>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_split_tc(const uint16_t* __restrict__ q,
                      const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ pool_pos,
                      const int* __restrict__ table,
                      const int* __restrict__ q_pos,
                      float* __restrict__ o_part, float* __restrict__ m_part,
                      float* __restrict__ l_part, int KVH, int G, int TT,
                      int NB, int BLK, int MB, int layer, float scale_log2) {
  constexpr bool Q8 = sizeof(T) == 1;
  constexpr int TS = 64;
  constexpr int WPM = NWARPS / MT;   // warps per m-tile
  constexpr int NSW = TS / WPM;      // slots of a tile per warp
  constexpr int KSTEPS = D / 16, DBLK = D / 8, NBLK = NSW / 8;
  using L = Layout<T, D, TS, Q8>;
  constexpr int LDB = L::LDB;
  static_assert(MT == 1 || MT == 2 || MT == 4, "m-tiles");
  static_assert(Q8 || L::LDE == LDB, "a bf16 raw tile is the mma tile");
  // The join area (NWARPS x 16 rows of acc, m, l) reuses the stages.
  static_assert(NWARPS * 16 * (D + 2) * 4 <= 4 * L::RAW_TILE, "join area");
  extern __shared__ __align__(128) unsigned char smem[];
  int* pos_s = reinterpret_cast<int*>(smem);
  int* src_s = pos_s + SPLIT;
  int* tiles_s = src_s + SPLIT;
  int* count_s = tiles_s + L::NT;
  float* sc_s = reinterpret_cast<float*>(smem + L::HDR);  // [stage][k,v][TS]
  unsigned char* raw = smem + L::RAW0;  // [stage][k,v][RAW_TILE]

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int R = TT * G;
  const int qp = q_pos[b];
  if (qp < 0) return;  // inactive: the combine pass writes the dead row
  const int start = sp * SPLIT;
  const int end = min(start + SPLIT, MB * BLK);
  const size_t part = ((size_t)b * KVH + h) * gridDim.x + sp;
  const int n = split_setup<TS>(pool_pos, table + (size_t)b * MB, NB, BLK,
                                start, end, qp + TT - 1, pos_s, src_s,
                                tiles_s, count_s);
  if (n == 0) {  // nothing here for any token: an empty partial
    if (tid < R) {
      m_part[part * R + tid] = -INFINITY;
      l_part[part * R + tid] = 0.f;
    }
    return;
  }

  const size_t plane = ((size_t)layer * KVH + h) * NB * BLK;  // in slots
  const T* kplane = k_pool + plane * D;
  const T* vplane = v_pool + plane * D;
  const float* ksplane = Q8 ? k_scale + plane : nullptr;
  const float* vsplane = Q8 ? v_scale + plane : nullptr;
  auto stage_k = [&](int s) { return raw + (2 * s) * L::RAW_TILE; };
  auto stage_v = [&](int s) { return raw + (2 * s + 1) * L::RAW_TILE; };
  copy_tile<T, D, TS, Q8>(stage_k(0), stage_v(0), sc_s, sc_s + TS, kplane,
                           vplane, ksplane, vsplane, src_s, tiles_s[0]);
  cp_async_commit();

  // This warp's m-tile and slot range; this thread's two packed rows.
  const int mt = warp / WPM, w0 = (warp % WPM) * NSW;
  int lim[2];
  uint32_t qf[KSTEPS][4];
  {
    const uint16_t* qrow = q + ((size_t)b * KVH + h) * R * D;
    int r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[i] = mt * 16 + grp + 8 * i;
      lim[i] = qp + r[i] / G;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = kk * 16 + tig * 2;
      qf[kk][0] = r[0] < R ? ld32(qrow + r[0] * D + c) : 0u;
      qf[kk][1] = r[1] < R ? ld32(qrow + r[1] * D + c) : 0u;
      qf[kk][2] = r[0] < R ? ld32(qrow + r[0] * D + c + 8) : 0u;
      qf[kk][3] = r[1] < R ? ld32(qrow + r[1] * D + c + 8) : 0u;
    }
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial row sums over this thread's columns
  float o[DBLK][4];
#pragma unroll
  for (int nb = 0; nb < DBLK; ++nb) {
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    if (it + 1 < n) {
      copy_tile<T, D, TS, Q8>(stage_k(st ^ 1), stage_v(st ^ 1),
                               sc_s + (st ^ 1) * 2 * TS,
                               sc_s + (st ^ 1) * 2 * TS + TS, kplane, vplane,
                               ksplane, vsplane, src_s, tiles_s[it + 1]);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const uint16_t* kt;
    const uint16_t* vt;
    if constexpr (Q8) {
      uint16_t* kb = reinterpret_cast<uint16_t*>(smem + L::BF0);
      uint16_t* vb = reinterpret_cast<uint16_t*>(smem + L::BF0 + L::BF_TILE);
      widen_tile<D, TS>(kb, reinterpret_cast<const int8_t*>(stage_k(st)));
      widen_tile<D, TS>(vb, reinterpret_cast<const int8_t*>(stage_v(st)));
      __syncthreads();
      kt = kb;
      vt = vb;
    } else {
      kt = reinterpret_cast<const uint16_t*>(stage_k(st));
      vt = reinterpret_cast<const uint16_t*>(stage_v(st));
    }
    const int* tp = pos_s + tiles_s[it] * TS;
    const float* ksc = sc_s + st * 2 * TS;
    const float* vsc = ksc + TS;

    // S = Q K^T for this warp's 16 rows x NSW slots.
    float sc[NBLK][4];
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NBLK; ++nb) {
        const uint16_t* kr = kt + (w0 + nb * 8 + grp) * LDB + kk * 16 + tig * 2;
        mma_bf16(sc[nb], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }
    // Base-2 scores (int8: times the slot's k_scale, before the mask),
    // masked per packed row; row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = w0 + nb * 8 + tig * 2 + (e & 1);
        float s = sc[nb][e] * scale_log2;
        if constexpr (Q8) s *= ksc[col];
        s = tp[col] <= lim[i] ? s : -INFINITY;
        sc[nb][e] = s;
        mx[i] = fmaxf(mx[i], s);
      }
    }
    float m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // A row with no attendable slot yet: p = 0, alpha = 1.
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int nb = 0; nb < DBLK; ++nb) {
        o[nb][2 * i] *= alpha;
        o[nb][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nb][e] - m_use[e >> 1]);
        l[e >> 1] += p;
        // int8: the slot's v_scale on P before it is rounded for P.V.
        sc[nb][e] = Q8 ? p * vsc[w0 + nb * 8 + tig * 2 + (e & 1)] : p;
      }
    }
    // O += P V: the score accumulators of n-blocks 2j, 2j+1 are the A
    // fragment of k-step j; P is rounded to bf16 here.
#pragma unroll
    for (int j = 0; j < NSW / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16x2(sc[2 * j][0], sc[2 * j][1]);
      a[1] = pack_bf16x2(sc[2 * j][2], sc[2 * j][3]);
      a[2] = pack_bf16x2(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      a[3] = pack_bf16x2(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      const int r0 = w0 + j * 16 + tig * 2;
#pragma unroll
      for (int nb = 0; nb < DBLK; ++nb) {
        const int col = nb * 8 + grp;
        const uint32_t b0 =
            pack_raw(vt[r0 * LDB + col], vt[(r0 + 1) * LDB + col]);
        const uint32_t b1 =
            pack_raw(vt[(r0 + 8) * LDB + col], vt[(r0 + 9) * LDB + col]);
        mma_bf16(o[nb], a, b0, b1);
      }
    }
    __syncthreads();  // this stage is read; the next copy may land in it
  }

  // Join the warps of each m-tile: acc, m and l per warp into shared
  // memory (over the stages), then each packed row's partial.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* jo = reinterpret_cast<float*>(raw);     // [NWARPS][16][D]
  float* jm = jo + NWARPS * 16 * D;              // [NWARPS][16]
  float* jl = jm + NWARPS * 16;                  // [NWARPS][16]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = grp + 8 * i;
    float* orow = jo + (warp * 16 + rr) * D;
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      *reinterpret_cast<float2*>(orow + nb * 8 + tig * 2) =
          make_float2(o[nb][2 * i], o[nb][2 * i + 1]);
    }
    if (tig == 0) {
      jm[warp * 16 + rr] = m[i];
      jl[warp * 16 + rr] = l[i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const int w_first = (r / 16) * WPM, rr = r % 16;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WPM; ++w) M = fmaxf(M, jm[(w_first + w) * 16 + rr]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WPM; ++w) {
      const float mw = jm[(w_first + w) * 16 + rr];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - M);
      acc += wt * jo[((w_first + w) * 16 + rr) * D + c];
      lsum += wt * jl[(w_first + w) * 16 + rr];
    }
    o_part[(part * R + r) * D + c] = acc;
    if (c == 0) {
      m_part[part * R + r] = M;
      l_part[part * R + r] = lsum;
    }
  }
}

// The split pass for float32 q on the CUDA cores.  T: pool element type
// (float, or int8_t with scales); MAXR: packed rows the instance holds.
template <typename T, int D, int MAXR>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_split_f32(const float* __restrict__ q,
                       const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ pool_pos,
                       const int* __restrict__ table,
                       const int* __restrict__ q_pos,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int KVH, int G, int TT,
                       int NB, int BLK, int MB, int layer, float scale_log2) {
  constexpr bool Q8 = sizeof(T) == 1;
  constexpr int TS = Q8 ? 64 : 32;
  using L = Layout<T, D, TS, false>;
  constexpr int VEC = L::VEC, LDE = L::LDE;
  constexpr int GSTEP = NTHREADS / D;  // threads sharing a column
  constexpr int NG = (MAXR + GSTEP - 1) / GSTEP;
  extern __shared__ __align__(128) unsigned char smem[];
  int* pos_s = reinterpret_cast<int*>(smem);
  int* src_s = pos_s + SPLIT;
  int* tiles_s = src_s + SPLIT;
  int* count_s = tiles_s + L::NT;
  float* sc_s = reinterpret_cast<float*>(smem + L::HDR);
  unsigned char* raw = smem + L::RAW0;
  float* q_s = reinterpret_cast<float*>(smem + L::BYTES);  // [MAXR][D]
  float* p_s = q_s + MAXR * D;                             // [MAXR][TS]
  float* m_s = p_s + MAXR * TS;
  float* l_s = m_s + MAXR;
  float* alpha_s = l_s + MAXR;

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = TT * G;
  const int qp = q_pos[b];
  if (qp < 0) return;
  const int start = sp * SPLIT;
  const int end = min(start + SPLIT, MB * BLK);
  const size_t part = ((size_t)b * KVH + h) * gridDim.x + sp;
  const int n = split_setup<TS>(pool_pos, table + (size_t)b * MB, NB, BLK,
                                start, end, qp + TT - 1, pos_s, src_s,
                                tiles_s, count_s);
  if (n == 0) {
    if (tid < R) {
      m_part[part * R + tid] = -INFINITY;
      l_part[part * R + tid] = 0.f;
    }
    return;
  }
  const size_t plane = ((size_t)layer * KVH + h) * NB * BLK;
  const T* kplane = k_pool + plane * D;
  const T* vplane = v_pool + plane * D;
  const float* ksplane = Q8 ? k_scale + plane : nullptr;
  const float* vsplane = Q8 ? v_scale + plane : nullptr;
  auto stage_k = [&](int s) { return raw + (2 * s) * L::RAW_TILE; };
  auto stage_v = [&](int s) { return raw + (2 * s + 1) * L::RAW_TILE; };
  copy_tile<T, D, TS, false>(stage_k(0), stage_v(0), sc_s, sc_s + TS,
                              kplane, vplane, ksplane, vsplane, src_s,
                              tiles_s[0]);
  cp_async_commit();

  const float* qrow = q + ((size_t)b * KVH + h) * R * D;
  for (int i = tid; i < R * D; i += NTHREADS) q_s[i] = qrow[i] * scale_log2;
  if (tid < MAXR) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int dd = tid % D, g0 = tid / D;  // this thread's output column
  float acc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) acc[i] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    if (it + 1 < n) {
      copy_tile<T, D, TS, false>(stage_k(st ^ 1), stage_v(st ^ 1),
                                  sc_s + (st ^ 1) * 2 * TS,
                                  sc_s + (st ^ 1) * 2 * TS + TS, kplane,
                                  vplane, ksplane, vsplane, src_s,
                                  tiles_s[it + 1]);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const T* kt = reinterpret_cast<const T*>(stage_k(st));
    const T* vt = reinterpret_cast<const T*>(stage_v(st));
    const int* tp = pos_s + tiles_s[it] * TS;
    const float* ksc = sc_s + st * 2 * TS;
    const float* vsc = ksc + TS;

    // Scores (base 2) for every (packed row, slot) pair of the tile.
    for (int i = tid; i < R * TS; i += NTHREADS) {
      const int r = i / TS, j = i % TS;
      float s = -INFINITY;
      if (tp[j] <= qp + r / G) {
        const float* qr = q_s + r * D;
        const T* kr = kt + j * LDE;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += VEC) {
          float kx[VEC];
          load_vec(kr + c, kx);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot += qr[c + e] * kx[e];
        }
        s = Q8 ? dot * ksc[j] : dot;
      }
      p_s[r * TS + j] = s;
    }
    __syncthreads();
    // Online softmax update, one warp per packed row.
    for (int r = warp; r < R; r += NWARPS) {
      float mx = -INFINITY;
      for (int j = lane; j < TS; j += 32) mx = fmaxf(mx, p_s[r * TS + j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const bool none = m_new == -INFINITY;
      float sum = 0.f;
      for (int j = lane; j < TS; j += 32) {
        const float p = none ? 0.f : exp2f(p_s[r * TS + j] - m_new);
        sum += p;
        p_s[r * TS + j] = Q8 ? p * vsc[j] : p;  // float32 q: no rounding
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = none ? 1.f : exp2f(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int r = g0 + i * GSTEP;
      if (r < R) acc[i] *= alpha_s[r];
    }
    for (int j = 0; j < TS; ++j) {
      const float v = to_f32(vt[j * LDE + dd]);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int r = g0 + i * GSTEP;
        if (r < R) acc[i] += p_s[r * TS + j] * v;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int r = g0 + i * GSTEP;
    if (r < R) o_part[(part * R + r) * D + dd] = acc[i];
  }
  if (tid < R) {
    m_part[part * R + tid] = m_s[tid];
    l_part[part * R + tid] = l_s[tid];
  }
}

// The combine pass: one block per (KV head, row).  The row's splits are
// rescaled to their common max; only splits that saw a slot (l > 0) are
// read.  out = sum_s 2^(m_s - M) o_s / L, lse = M ln 2 + log L with
// L = sum_s 2^(m_s - M) l_s; a packed row no split saw: out 0, lse
// MASK_VALUE.
__global__ void __launch_bounds__(NTHREADS)
paged_decode_combine(const float* __restrict__ o_part,
                     const float* __restrict__ m_part,
                     const float* __restrict__ l_part,
                     const int* __restrict__ q_pos, float* __restrict__ out,
                     float* __restrict__ lse, int KVH, int R, int D,
                     int n_split) {
  __shared__ float M_s[MAX_ROWS], L_s[MAX_ROWS];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t row = (size_t)b * KVH + h;
  float* orow = out + row * R * D;
  float* lrow = lse + row * R;
  if (q_pos[b] < 0) {  // inactive: the split pass wrote nothing
    for (int i = tid; i < R * D; i += NTHREADS) orow[i] = 0.f;
    if (tid < R) lrow[tid] = MASK_VALUE;
    return;
  }
  const size_t p0 = row * n_split;
  if (tid < R) {
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) {
      const size_t i = (p0 + s) * R + tid;
      if (l_part[i] > 0.f) M = fmaxf(M, m_part[i]);
    }
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t i = (p0 + s) * R + tid;
      const float l = l_part[i];
      if (l > 0.f) L += l * exp2f(m_part[i] - M);
    }
    M_s[tid] = M;
    L_s[tid] = L;
    lrow[tid] = L > 0.f ? M * LN2 + logf(L) : MASK_VALUE;
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const float L = L_s[r];
    float o = 0.f;
    if (L > 0.f) {
      const float M = M_s[r];
      for (int s = 0; s < n_split; ++s) {
        const size_t i = (p0 + s) * R + r;
        if (l_part[i] > 0.f) o += exp2f(m_part[i] - M) * o_part[i * D + c];
      }
      o /= L;
    }
    orow[idx] = o;
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *pool_pos, *table, *q_pos;
  float *o_part, *m_part, *l_part;
  int B, KVH, G, TT, NB, BLK, MB, layer, n_split;
  float scale_log2;
  cudaStream_t st;
  int* instance;
};

// Dynamic shared memory above 48 KB needs the kernel's attribute raised
// first (per device, so at every launch).
template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D, int MT>
int launch_tc(const Args& a) {
  constexpr int smem = Layout<T, D, 64, sizeof(T) == 1>::BYTES;
  auto kernel = paged_decode_split_tc<T, D, MT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.n_split, a.KVH, a.B), NTHREADS, smem, a.st>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.ks, a.vs, a.pool_pos, a.table, a.q_pos,
      a.o_part, a.m_part, a.l_part, a.KVH, a.G, a.TT, a.NB, a.BLK, a.MB,
      a.layer, a.scale_log2);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) *a.instance = 16 * MT;
  return (int)launched;
}

template <typename T, int D, int MAXR>
int launch_f32(const Args& a) {
  constexpr int TS = sizeof(T) == 1 ? 64 : 32;
  constexpr int smem = Layout<T, D, TS, false>::BYTES +
                       (MAXR * D + MAXR * TS + 3 * MAXR) * 4;
  auto kernel = paged_decode_split_f32<T, D, MAXR>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.n_split, a.KVH, a.B), NTHREADS, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.ks, a.vs, a.pool_pos, a.table, a.q_pos,
      a.o_part, a.m_part, a.l_part, a.KVH, a.G, a.TT, a.NB, a.BLK, a.MB,
      a.layer, a.scale_log2);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) *a.instance = -MAXR;
  return (int)launched;
}

// The split pass's instance: bf16 q on the tensor cores with 1, 2 or 4
// m-tiles; float32 q on the CUDA cores, up to 16 or 64 packed rows.
template <typename TQ, typename T, int D>
int launch_split(const Args& a) {
  const int R = a.TT * a.G;
  if constexpr (sizeof(TQ) == 2) {
    if (R <= 16) return launch_tc<T, D, 1>(a);
    if (R <= 32) return launch_tc<T, D, 2>(a);
    return launch_tc<T, D, 4>(a);
  } else {
    return R <= 16 ? launch_f32<T, D, 16>(a) : launch_f32<T, D, 64>(a);
  }
}

template <typename TQ, typename T>
int launch_split_d(int D, const Args& a) {
  if (D == 128) return launch_split<TQ, T, 128>(a);
  if (D == 64) return launch_split<TQ, T, 64>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// T query tokens per row (t_tokens), G query heads per KV head; T*G <=
// MAX_ROWS packed rows.  dtype (of q): 0 = float32, 1 = bfloat16.  k_scale
// and v_scale: NULL for a pool of q's dtype, else the float32 scale planes
// of an int8 pool.  partials: float32 scratch of B*KVH*n_split*T*G*(D+2)
// values (o_part, then m_part, then l_part); n_split = ceil(MB * BLK /
// SPLIT), checked here.  Launches the split pass and
// the combine pass on `stream` and does not synchronise.  Host outputs:
// *kernels is the number of kernels this call launched (2 when it
// succeeds), *instance the split pass's instance (+16, +32 or +64: the
// tensor-core kernel and the packed rows it holds; -16 or -64: the
// CUDA-core kernel's).  Returns the first failing launch's cudaError_t
// (0 on success).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const float* k_scale,
                            const float* v_scale, const int* pool_pos,
                            const int* table, const int* q_pos, float* out,
                            float* lse, float* partials, int B, int KVH,
                            int G, int t_tokens, int D, int NB, int BLK,
                            int MB, int layer, int dtype, int n_split,
                            float scale_log2, void* stream, int* kernels,
                            int* instance) {
  *kernels = 0;
  *instance = 0;
  if (B <= 0 || KVH <= 0 || G <= 0 || G > MAXG || t_tokens <= 0 ||
      G * t_tokens > MAX_ROWS || NB <= 0 || BLK <= 0 || MB <= 0 ||
      layer < 0 || B > 65535 || KVH > 65535 ||
      n_split != (int)(((long)MB * BLK + SPLIT - 1) / SPLIT)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((k_scale == nullptr) != (v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int R = G * t_tokens;
  const size_t rows = (size_t)B * KVH * n_split * R;
  Args a{q,        k_pool,  v_pool,   k_scale, v_scale,
         pool_pos, table,   q_pos,    partials, partials + rows * D,
         partials + rows * D + rows,  B,        KVH,     G,
         t_tokens, NB,      BLK,      MB,      layer,   n_split,
         scale_log2, static_cast<cudaStream_t>(stream), instance};
  const bool int8 = k_scale != nullptr;
  int rc;
  if (dtype == 1) {
    rc = int8 ? launch_split_d<__nv_bfloat16, int8_t>(D, a)
              : launch_split_d<__nv_bfloat16, __nv_bfloat16>(D, a);
  } else if (dtype == 0) {
    rc = int8 ? launch_split_d<float, int8_t>(D, a)
              : launch_split_d<float, float>(D, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  *kernels = 1;
  paged_decode_combine<<<dim3(KVH, B), NTHREADS, 0, a.st>>>(
      a.o_part, a.m_part, a.l_part, q_pos, out, lse, KVH, R, D, n_split);
  rc = (int)cudaGetLastError();
  if (rc == 0) *kernels = 2;
  return rc;
}

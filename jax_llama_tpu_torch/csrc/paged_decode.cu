// Paged-attention decode over a block-table KV pool for Hopper (sm_90a),
// plain C entry point.
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
// float32, as in the JAX kernel.  Any block size works: a K/V row is d *
// sizeof(T) bytes, a multiple of 16, so every row stays 16-byte aligned
// (the TPU kernel's multiple-of-8 rule is its sublane tiling and does not
// carry over).
//
// int8 pool: k_pool, v_pool int8 [L, KVH, NB, BLK, d] with float32
// per-slot-per-head scales k_scale, v_scale [L, KVH, NB, BLK]; q, out and
// lse as above (q bf16 or float32).  Both scales fold per slot, as the JAX
// kernel folds them: each score q.k is multiplied by its slot's k_scale
// BEFORE the mask (an unwritten slot carries scale 0 and payload 0, and a
// score of 0 is not -inf: the mask must still exclude it), and each
// probability by its slot's v_scale before it is rounded to q's dtype
// for the P.V product (l sums the unscaled P).  The layer's planes are
// reached by pointer offset, never sliced or copied.  The tiles hold the
// int8 bytes (half a bf16 tile) and convert to float32 in the dot and
// P.V loops, so the pool is read at one byte per element plus 8 bytes of
// scales per slot and KV head.
//
// What bounds it on an H100: memory.  A step does ~4·T·G·d FLOPs per live
// slot and moves 2·d·bytes(dtype) of K/V per slot and KV head: at the
// verify shape (T*G = 16) still ~10x below the ~295 FLOP/byte at which the
// tensor cores would become the limit.  The least time is the live slots'
// K/V over HBM bandwidth.  What the design does about it:
//   * One block per (row, KV head).  It walks the row's table inside the
//     kernel and reads each live [BLK, d] K and V tile straight from the
//     layer's plane of the pool: no gathered view, no per-layer copy.
//   * All T*G packed rows of a KV head share each K/V tile (GQA and
//     multi-token packing), so the pool is read once per KV head for all
//     T tokens, never once per query head or per token.
//   * A prologue finds the row's live-block bound (1 + the last table
//     entry holding a slot the LAST token may attend; JAX :313-333).  Table
//     entries past it, sentinel entries, and sub-tiles with no slot the
//     last token may attend are skipped without loading K or V.
//     Processing a wholly masked tile would add exp(MASK - MASK) = 1 of
//     garbage (JAX :128-141), so skipping is required, not an
//     optimisation.
//   * At T > 1 a tile can be live for a late token and wholly masked for
//     an early one (the skip is per tile, the mask per packed row).  Each
//     (row, slot) pair the row may not attend gets p = 0 explicitly, and a
//     row whose running max is still -inf takes p = 0 and alpha = 1, so no
//     exp(-inf - -inf) reaches l or acc.
//   * A tile's K and V rows are copied to shared memory with cp.async, so
//     all of a tile's loads are in flight at once.
//   * The online softmax (m, l) per packed row runs in float32, in base 2
//     with log2(e) folded into the pre-scaled q; the output accumulator
//     sits in registers (one feature column per thread).  P is rounded to
//     the pool dtype before the P.V product, as the JAX kernel does; l sums
//     the unrounded P.
//   * Two instances per (q dtype, pool dtype) and head_dim: the T = 1 one
//     (up to 8 query
//     heads, the first version's code and shared-memory tile: the per-row
//     limits and the -inf guard compile away) and the multi-token one (up
//     to MAX_ROWS = 32 packed rows: n_draft up to 7 at G = 4), whose larger
//     query and score tiles take half the slots per K/V tile to stay inside
//     the 48 KB of static shared memory.  The caller splits a longer
//     block into launches of at most MAX_ROWS / G tokens
//     (ops/paged_attention.py split_tokens).  The int8 instances take 64
//     slots a tile at T = 1 and 32 in the multi-token one (a row of d int8
//     values is d bytes, a multiple of 16 at d = 64 and 128, so cp.async
//     keeps its 16-byte alignment at any block size).
// Not done yet (later work): the grid is B*KVH blocks (64 for llama3-8b at
// 8 slots, on 132 SMs) and each block waits on its own tile loads, so a
// long row is latency-bound.  A split-KV second pass (flash-decoding) and
// a double buffer (the next tile's copies in flight during this tile's
// math) are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <math.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;       // query heads per KV head (the T = 1 rows)
constexpr int MAX_ROWS = 32;  // packed rows (T*G) of the multi-token one
constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;
constexpr float LN2 = 0.69314718055994530942f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
// P as it enters the P.V product: rounded to the pool dtype.
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Eight bf16 (or four float32) values from 16 aligned bytes of shared
// memory, as float32 (bf16 -> float32 is a 16-bit shift).
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// Sixteen int8 values, as float32 (exact).  Each byte is biased to an
// unsigned value u = b + 128 (b ^ 0x80) and placed in the mantissa of
// 2^23, so float(b) = as_float(0x4B000000 | u) - (2^23 + 128): integer
// logic and one float add, which issue several times as fast as the
// int -> float conversion instruction (16 a clock per SM on sm_90).
// The score loop converts each K value once per packed query row, so
// this rate weighs on the int8 instances' time.
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

// 16-byte global -> shared copy that does not hold a register or wait:
// a tile's copies are all in flight together (cp.async, sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// The same for one 4-byte value (a slot's scale).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
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

// TQ: q element type; T: pool element type (TQ, or int8_t with scales);
// D: head_dim; TS: slots per shared-memory tile; MAXR: packed query rows
// (T*G) the instance holds; more than MAXG makes the multi-token instance.
template <typename TQ, typename T, int D, int TS, int MAXR>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const TQ* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ pool_pos,
                    const int* __restrict__ table,
                    const int* __restrict__ q_pos, float* __restrict__ out,
                    float* __restrict__ lse, int KVH, int G, int TT, int NB,
                    int BLK, int MB, int layer, float scale_log2) {
  static_assert(TS <= NTHREADS, "one position per thread");
  static_assert(MAXR <= NTHREADS, "one lse per thread");
  constexpr bool MULTI = MAXR > MAXG;      // T > 1 rows: per-row limits
  constexpr bool Q8 = sizeof(T) == 1;      // int8 pool: fold the scales
  constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int LD = D + VEC;              // padded shared row
  constexpr int GSTEP = NTHREADS / D;      // threads sharing a column
  constexpr int NG = (MAXR + GSTEP - 1) / GSTEP;
  __shared__ __align__(16) float q_s[MAXR * D];
  // Raw bytes: a __shared__ array of a class type (__nv_bfloat16) would
  // need a constructor.
  __shared__ __align__(16) unsigned char k_raw[TS * LD * sizeof(T)];
  __shared__ __align__(16) unsigned char v_raw[TS * LD * sizeof(T)];
  T* k_s = reinterpret_cast<T*>(k_raw);
  T* v_s = reinterpret_cast<T*>(v_raw);
  __shared__ float p_s[MAXR * TS];
  __shared__ int pos_s[TS];
  __shared__ float ksc_s[Q8 ? TS : 1], vsc_s[Q8 ? TS : 1];
  __shared__ float m_s[MAXR], l_s[MAXR], alpha_s[MAXR];
  __shared__ int bound_s;

  const int h = blockIdx.x, b = blockIdx.y;
  const int R = TT * G;                  // packed rows, r = t*G + g
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dd = tid % D, g0 = tid / D;  // this thread's output column(s)
  const int qp = q_pos[b];
  const int qp_last = qp + TT - 1;       // the last token's position
  const size_t row = (size_t)b * KVH + h;
  float* out_row = out + row * R * D;
  float* lse_row = lse + row * R;

  // Live-block bound over the row's table: 0 for an inactive row.
  if (tid == 0) bound_s = 0;
  if (tid < MAXR) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  for (int i = tid; i < R * D; i += NTHREADS) {
    q_s[i] = to_f32(q[row * R * D + i]) * scale_log2;
  }
  __syncthreads();
  const int* trow = table + (size_t)b * MB;
  if (qp >= 0) {
    int last = -1;
    for (int i = tid; i < MB * BLK; i += NTHREADS) {
      const int mb = i / BLK;
      const int blk = trow[mb];
      if (blk >= 0 && blk < NB) {
        const int p = pool_pos[(size_t)blk * BLK + i % BLK];
        if (p >= 0 && p <= qp_last) last = mb;
      }
    }
    if (last >= 0) atomicMax(&bound_s, last + 1);
  }
  __syncthreads();
  const int bound = bound_s;

  float acc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) acc[i] = 0.f;

  for (int mb = 0; mb < bound; ++mb) {
    const int blk = trow[mb];
    if (blk < 0 || blk >= NB) continue;  // sentinel entry
    const size_t block0 = (((size_t)layer * KVH + h) * NB + blk) * BLK;
    for (int s0 = 0; s0 < BLK; s0 += TS) {
      const int n = min(TS, BLK - s0);
      __syncthreads();  // the previous tile's shared reads are done
      bool live = false;
      if (tid < n) {
        int p = pool_pos[(size_t)blk * BLK + s0 + tid];
        p = p < 0 ? INT_MAX : p;
        pos_s[tid] = p;
        live = p <= qp_last;
      }
      // Wholly masked for every token: no K/V read.
      if (!__syncthreads_or(live)) continue;

      if constexpr (Q8) {
        // The tile's scales travel with its K/V copies (a plain load here
        // would hold each thread for one memory round trip before it
        // could issue them).
        if (tid < n) {
          cp_async4(&ksc_s[tid], k_scale + block0 + s0 + tid);
          cp_async4(&vsc_s[tid], v_scale + block0 + s0 + tid);
        }
      }
      const T* ksrc = k_pool + (block0 + s0) * D;
      const T* vsrc = v_pool + (block0 + s0) * D;
      for (int c = tid; c < n * (D / VEC); c += NTHREADS) {
        const int r = c / (D / VEC);
        const int col = (c % (D / VEC)) * VEC;
        cp_async16(&k_s[r * LD + col], ksrc + (size_t)r * D + col);
        cp_async16(&v_s[r * LD + col], vsrc + (size_t)r * D + col);
      }
      cp_async_wait_all();
      __syncthreads();

      // Scores (base 2) for every (packed row, slot) pair of the tile;
      // packed row r belongs to token r / G and attends up to its position.
      for (int i = tid; i < R * n; i += NTHREADS) {
        const int r = i / n, j = i % n;
        float s = -INFINITY;
        if (pos_s[j] <= (MULTI ? qp + r / G : qp)) {
          const float* qr = q_s + r * D;
          const T* kr = k_s + j * LD;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < D; c += VEC) {
            float kx[VEC];
            load_vec(kr + c, kx);
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot += qr[c + e] * kx[e];
          }
          // int8: the slot's K scale, before the mask (this branch).
          s = Q8 ? dot * ksc_s[j] : dot;
        }
        p_s[r * TS + j] = s;
      }
      __syncthreads();

      // Online softmax update, one warp per packed row.  A row with no
      // attendable slot so far (max still -inf) keeps p = 0 and alpha = 1:
      // the tile may be live only for later tokens.
      for (int r = warp; r < R; r += NWARPS) {
        float mx = -INFINITY;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[r * TS + j]);
        mx = warp_max(mx);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const bool none = MULTI && m_new == -INFINITY;
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          // exp2(-inf - m_new) = 0 for a masked pair once m_new is finite.
          const float p = none ? 0.f : exp2f(p_s[r * TS + j] - m_new);
          sum += p;
          // int8: the slot's V scale, then the round to q's dtype.
          p_s[r * TS + j] = round_p(Q8 ? p * vsc_s[j] : p, TQ());
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

      // acc = alpha * acc + P V, for this thread's column and rows.
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int r = g0 + i * GSTEP;
        if (r < R) acc[i] *= alpha_s[r];
      }
      for (int j = 0; j < n; ++j) {
        const float v = to_f32(v_s[j * LD + dd]);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int r = g0 + i * GSTEP;
          if (r < R) acc[i] += p_s[r * TS + j] * v;
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int r = g0 + i * GSTEP;
    if (r < R) {
      const float l = l_s[r];
      out_row[r * D + dd] = acc[i] / (l == 0.f ? 1.f : l);
    }
  }
  if (tid < R) {
    const float l = l_s[tid];
    lse_row[tid] = l == 0.f ? MASK_VALUE : m_s[tid] * LN2 + logf(l);
  }
}

template <typename TQ, typename T, int TS, int MAXR>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* pool_pos, const int* table,
           const int* q_pos, float* out, float* lse, int B, int KVH, int G,
           int TT, int D, int NB, int BLK, int MB, int layer,
           float scale_log2, cudaStream_t st) {
  const dim3 grid(KVH, B);
  const TQ* qq = static_cast<const TQ*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  if (D == 128) {
    paged_decode_kernel<TQ, T, 128, TS, MAXR><<<grid, NTHREADS, 0, st>>>(
        qq, kk, vv, ks, vs, pool_pos, table, q_pos, out, lse, KVH, G, TT,
        NB, BLK, MB, layer, scale_log2);
  } else if (D == 64) {
    paged_decode_kernel<TQ, T, 64, TS, MAXR><<<grid, NTHREADS, 0, st>>>(
        qq, kk, vv, ks, vs, pool_pos, table, q_pos, out, lse, KVH, G, TT,
        NB, BLK, MB, layer, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The T = 1 and multi-token instances of one (q dtype, pool dtype) pair,
// with their tile widths.
template <typename TQ, typename T, int TS1, int TSM>
int dispatch(bool small, const void* q, const void* k, const void* v,
             const float* ks, const float* vs, const int* pool_pos,
             const int* table, const int* q_pos, float* out, float* lse,
             int B, int KVH, int G, int TT, int D, int NB, int BLK, int MB,
             int layer, float scale_log2, cudaStream_t st) {
  return small
      ? launch<TQ, T, TS1, MAXG>(q, k, v, ks, vs, pool_pos, table, q_pos,
                                 out, lse, B, KVH, G, TT, D, NB, BLK, MB,
                                 layer, scale_log2, st)
      : launch<TQ, T, TSM, MAX_ROWS>(q, k, v, ks, vs, pool_pos, table, q_pos,
                                     out, lse, B, KVH, G, TT, D, NB, BLK, MB,
                                     layer, scale_log2, st);
}

}  // namespace

// T query tokens per row (t_tokens), G query heads per KV head; T*G packed
// rows.  dtype (of q): 0 = float32, 1 = bfloat16.  k_scale and v_scale:
// NULL for a pool of q's dtype, else the float32 scale planes of an int8
// pool.  Returns the cudaError_t of the launch (0 on success).  Launches
// on `stream` and does not synchronise.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const float* k_scale,
                            const float* v_scale, const int* pool_pos,
                            const int* table, const int* q_pos, float* out,
                            float* lse, int B, int KVH, int G, int t_tokens,
                            int D, int NB, int BLK, int MB, int layer,
                            int dtype, float scale_log2, void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0 || G > MAXG || t_tokens <= 0 ||
      G * t_tokens > MAX_ROWS || NB <= 0 || BLK <= 0 || MB <= 0 ||
      layer < 0 || B > 65535 || KVH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if ((k_scale == nullptr) != (v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = t_tokens == 1;
  const bool int8 = k_scale != nullptr;
  if (dtype == 1) {
    return int8
        ? dispatch<__nv_bfloat16, int8_t, 64, 32>(
              small, q, k_pool, v_pool, k_scale, v_scale, pool_pos, table,
              q_pos, out, lse, B, KVH, G, t_tokens, D, NB, BLK, MB, layer,
              scale_log2, st)
        : dispatch<__nv_bfloat16, __nv_bfloat16, 64, 32>(
              small, q, k_pool, v_pool, k_scale, v_scale, pool_pos, table,
              q_pos, out, lse, B, KVH, G, t_tokens, D, NB, BLK, MB, layer,
              scale_log2, st);
  }
  if (dtype == 0) {
    return int8
        ? dispatch<float, int8_t, 64, 32>(
              small, q, k_pool, v_pool, k_scale, v_scale, pool_pos, table,
              q_pos, out, lse, B, KVH, G, t_tokens, D, NB, BLK, MB, layer,
              scale_log2, st)
        : dispatch<float, float, 32, 16>(
              small, q, k_pool, v_pool, k_scale, v_scale, pool_pos, table,
              q_pos, out, lse, B, KVH, G, t_tokens, D, NB, BLK, MB, layer,
              scale_log2, st);
  }
  return (int)cudaErrorInvalidValue;
}

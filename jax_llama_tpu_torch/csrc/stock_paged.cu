// Stock-paged decode for Hopper (sm_90a), plain C entry point: the
// "stock-paged" slot of the kernel-selection layer.
//
// Replaces the TPU kernel `_stock_launch` of jax_llama_tpu/ops/kernels.py
// (pallas_call at :428; the upstream body
// `paged_flash_attention_kernel_inline_seq_dim`), reached from
// `stock_paged_decode` (:473), and the merge of the step's own slot that
// follows it there (:560-579).  The function, for one T = 1 decode step:
//
//   q3[b, h]     = round_to_q_dtype(q[b, 0, h] / sqrt(d))
//   pool pass:   over the slots j < len[b] = max(q_pos[b], 0) of row b's
//                table in table order (slot j = offset j % BLK of block
//                table[b, j / BLK]), with K and V rounded to bf16 whatever
//                the pool dtype:
//                  s_j = q3 . k_j (float32), m = max_j s_j,
//                  l = sum_j exp(s_j - m), out = sum_j exp(s_j - m) v_j / l
//                (out rounded once to q's dtype when G % 8 == 0, as JAX
//                stores it; float32 otherwise); a row with len 0 keeps
//                m = -inf, l = 0, out = 0;
//   merge:       lse = m + log l (-inf when l = 0),
//                s_new = (q[b,0,h] . k_new[b,0,kvh]) / sqrt(d),
//                M = max(lse, s_new), w = exp(lse - M), p = exp(s_new - M),
//                result = (out * w + p * v_new) / (w + p), in q's dtype.
//
// A table entry outside [0, NB) (the sentinel NB) is never read: its
// slots score MASK_VALUE (the finite mask value) with zero values.  The
// layer and KV-head plane is reached by pointer offset into the contiguous
// [L, KVH, NB, BLK, d] pool (the flat page ((layer*KVH + h)*NB + block)
// of JAX's view): nothing is sliced or copied.
//
// Layout: q, out [B, 1, H, d] and k_new, v_new [B, 1, KVH, d] in q's dtype
// (bf16 or float32; query head h = kvh*G + g); pools bf16 or float32;
// table [B, MB] and q_pos [B] int32.  Scratch: o_part [B, KVH, NS, G, d],
// m_part and l_part [B, KVH, NS, G] float32, NS = ceil(MB*BLK / split).
//
// What bounds it on an H100: memory.  A step does 4*d FLOPs per (query
// head, live slot) and reads 2*d*bytes(pool) per (KV head, live slot): at
// G = 4 about 4 FLOP per byte, far below the ~295 at which the tensor
// cores would be the limit.  The least time is the live slots' K/V over
// HBM bandwidth.  The design is split-KV flash-decoding, as the paged
// kernel's (paged_decode.cu, which keeps the positional mask, T > 1 and
// int8 pools that this slot does not take):
//   * Split pass: one block per (split of `split` slots, KV head, row).
//     At llama3-8b's serving shape (8 rows, 8 KV heads, 2048-slot rows)
//     that is up to 8 x 64 = 512 blocks on 132 SMs, against 64 for one
//     block per (row, KV head): more of the row's K/V is in flight at
//     once.  A block
//     whose split starts at or past the row's length returns at once.
//     Each block walks its slots in tiles (64 bf16 or 32 float32 slots of
//     d values), copied into shared memory with cp.async, 16 bytes a copy;
//     each slot's row address comes from the table, so any block size
//     works.  Scores: each slot's dot products for all G query heads are
//     taken by 2 (bf16) or 4 (float32) threads over interleaved 16-byte
//     chunks of the row, the K tile padded so that no two threads of a
//     quarter-warp hit one bank, then joined by shuffles.  The online
//     softmax (m, l) runs per query head in float32, one warp each; the
//     output accumulator holds one feature column per thread.  The block
//     writes its unnormalised partial (o, m, l).
//   * Combine pass: one block per (KV head, row) reads the row's live
//     splits only, rescales them to the common max (out, m, l), and folds
//     in the step's own slot (the merge above), so the model receives the
//     layer's attention output from two launches and no torch arithmetic.
// Not done yet (later work): double-buffered tiles within a split, the
// tensor cores for the q.k products at G = 8, and a grid sized from the
// rows' lengths instead of the table's capacity.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;  // query heads per KV head
constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

// Round a float32 to bf16 and back (the stock body's in-kernel K/V cast).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One element of a bf16 (is_bf16) or float32 array, as float32.
__device__ __forceinline__ float load_any(const void* p, size_t i,
                                          bool is_bf16) {
  return is_bf16 ? bf16_bits_to_f32(static_cast<const uint16_t*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, size_t i, float x,
                                          bool is_bf16) {
  if (is_bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(p)[i] = x;
  }
}

// 16 bytes of a K/V row in shared memory as float32 values of bf16 (a
// bf16 pool: exact; a float32 pool: rounded to bf16 here).
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = round_bf16(v.x);
  x[1] = round_bf16(v.y);
  x[2] = round_bf16(v.z);
  x[3] = round_bf16(v.w);
}

__device__ __forceinline__ float value_bf16(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float value_bf16(float x) { return round_bf16(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
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

// TP: pool element type (__nv_bfloat16 or float); D: head_dim.
template <typename TP, int D>
__global__ void __launch_bounds__(NTHREADS)
stock_split_kernel(const void* __restrict__ q, int q_bf16,
                   const TP* __restrict__ k_pool,
                   const TP* __restrict__ v_pool,
                   const int* __restrict__ table,
                   const int* __restrict__ q_pos, float* __restrict__ o_part,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   int KVH, int G, int NB, int BLK, int MB, int layer,
                   int split, float scale) {
  constexpr int TILE = sizeof(TP) == 2 ? 64 : 32;  // slots per tile
  constexpr int TPS = NTHREADS / TILE;   // threads per slot in the scores
  constexpr int VEC = 16 / sizeof(TP);   // elements per 16-byte chunk
  constexpr int CHUNKS = D / VEC;        // chunks per K/V row
  static_assert(CHUNKS % TPS == 0, "chunks split evenly over a slot");
  // TPS chunks of padding: a quarter-warp's 16-byte reads of K rows land
  // in distinct banks.
  constexpr int LD = D + TPS * VEC;
  constexpr int GSTEP = NTHREADS / D;    // threads sharing an output column
  constexpr int NG = (MAXG + GSTEP - 1) / GSTEP;
  __shared__ __align__(16) float q_s[MAXG * D];
  // Raw bytes: a __shared__ array of __nv_bfloat16 would need a
  // constructor.
  __shared__ __align__(16) unsigned char k_raw[TILE * LD * sizeof(TP)];
  __shared__ __align__(16) unsigned char v_raw[TILE * LD * sizeof(TP)];
  TP* k_s = reinterpret_cast<TP*>(k_raw);
  TP* v_s = reinterpret_cast<TP*>(v_raw);
  __shared__ float p_s[MAXG * TILE];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];
  __shared__ bool real_s[TILE];

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int length = min(max(q_pos[b], 0), MB * BLK);
  const int start = sp * split;
  if (start >= length) return;  // the combine pass reads live splits only
  const int end = min(start + split, length);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KVH * G;

  for (int i = tid; i < G * D; i += NTHREADS) {
    // The scaled query, rounded to q's dtype (JAX :528).
    const float x = load_any(q, ((size_t)b * H + h * G) * D + i, q_bf16) *
                    scale;
    q_s[i] = q_bf16 ? round_bf16(x) : x;
  }
  if (tid < MAXG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int* trow = table + (size_t)b * MB;
  const size_t plane = ((size_t)layer * KVH + h) * NB;
  const int dd = tid % D, g0 = tid / D;  // this thread's output column(s)
  float acc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) acc[i] = 0.f;

  for (int s0 = start; s0 < end; s0 += TILE) {
    const int n = min(TILE, end - s0);
    __syncthreads();  // the previous tile's shared reads are done
    for (int c = tid; c < n * CHUNKS; c += NTHREADS) {
      const int j = c / CHUNKS;
      const int col = (c % CHUNKS) * VEC;
      const int slot = s0 + j;
      const int blk = trow[slot / BLK];
      if (blk >= 0 && blk < NB) {
        const size_t src = ((plane + blk) * BLK + slot % BLK) * D + col;
        cp_async16(&k_s[j * LD + col], k_pool + src);
        cp_async16(&v_s[j * LD + col], v_pool + src);
      } else {  // sentinel: never read; zero values
        *reinterpret_cast<uint4*>(&k_s[j * LD + col]) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(&v_s[j * LD + col]) = make_uint4(0, 0, 0, 0);
      }
      if (col == 0) real_s[j] = blk >= 0 && blk < NB;
    }
    cp_async_wait_all();
    __syncthreads();

    // Scores: slot j = tid / TPS over chunks part, part + TPS, ...
    {
      const int j = tid / TPS, part = tid % TPS;
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
      if (j < n) {
        const TP* kr = k_s + j * LD;
#pragma unroll
        for (int i = 0; i < CHUNKS / TPS; ++i) {
          const int col = (i * TPS + part) * VEC;
          float kx[VEC];
          load_chunk(kr + col, kx);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              const float* qr = q_s + g * D + col;
#pragma unroll
              for (int e = 0; e < VEC; ++e) dot[g] += qr[e] * kx[e];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
#pragma unroll
        for (int off = 1; off < TPS; off <<= 1) {
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        }
      }
      if (j < n && part == 0) {
        const bool real = real_s[j];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) p_s[g * TILE + j] = real ? dot[g] : MASK_VALUE;
        }
      }
    }
    __syncthreads();

    // Online softmax update, one warp per query head.  Every score is
    // finite (a real dot product or MASK_VALUE), so after the first tile
    // m is finite and exp(m_old - m_new) is exact 0 on the first update.
    for (int g = warp; g < G; g += NWARPS) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[g * TILE + j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(p_s[g * TILE + j] - m_new);
        sum += p;
        p_s[g * TILE + j] = p;  // P stays float32, as in the stock body
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = g0 + i * GSTEP;
      if (g < G) acc[i] *= alpha_s[g];
    }
    for (int j = 0; j < n; ++j) {
      const float v = value_bf16(v_s[j * LD + dd]);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int g = g0 + i * GSTEP;
        if (g < G) acc[i] += p_s[g * TILE + j] * v;
      }
    }
  }
  __syncthreads();

  const size_t part0 = ((size_t)b * KVH + h) * n_split + sp;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = g0 + i * GSTEP;
    if (g < G) o_part[(part0 * G + g) * D + dd] = acc[i];
  }
  if (tid < G) {
    m_part[part0 * G + tid] = m_s[tid];
    l_part[part0 * G + tid] = l_s[tid];
  }
}

// One block per (KV head, row): the live splits joined to (out, m, l), the
// step's own slot merged in, the result stored in q's dtype.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
stock_combine_kernel(const void* __restrict__ q,
                     const void* __restrict__ k_new,
                     const void* __restrict__ v_new, int q_bf16,
                     const float* __restrict__ o_part,
                     const float* __restrict__ m_part,
                     const float* __restrict__ l_part,
                     const int* __restrict__ q_pos, void* __restrict__ out,
                     int KVH, int G, int capacity, int split, int n_split,
                     int round_out, float scale) {
  constexpr int GSTEP = NTHREADS / D;
  constexpr int NG = (MAXG + GSTEP - 1) / GSTEP;
  constexpr int WPG = D / 32;  // warps per output column group
  __shared__ float M_s[MAXG], L_s[MAXG];
  __shared__ float red_s[MAXG][WPG];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = KVH * G;
  const int length = min(max(q_pos[b], 0), capacity);
  const int n_live = (length + split - 1) / split;
  const size_t part0 = ((size_t)b * KVH + h) * n_split;

  if (tid < G) {
    float M = -INFINITY;
    for (int s = 0; s < n_live; ++s) {
      M = fmaxf(M, m_part[(part0 + s) * G + tid]);
    }
    float L = 0.f;
    if (n_live > 0) {
      for (int s = 0; s < n_live; ++s) {
        const size_t i = (part0 + s) * G + tid;
        L += l_part[i] * expf(m_part[i] - M);
      }
    }
    M_s[tid] = M;
    L_s[tid] = L;
  }

  const int dd = tid % D, g0 = tid / D;
  const size_t kv = ((size_t)b * KVH + h) * D + dd;
  const float kn = load_any(k_new, kv, q_bf16);
  const float vn = load_any(v_new, kv, q_bf16);
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = g0 + i * GSTEP;  // uniform across a warp
    const float qx =
        g < G ? load_any(q, ((size_t)b * H + h * G + g) * D + dd, q_bf16)
              : 0.f;
    const float part = warp_sum(qx * kn);
    if (lane == 0 && g < G) red_s[g][warp % WPG] = part;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = g0 + i * GSTEP;
    if (g >= G) continue;
    float dot = 0.f;
#pragma unroll
    for (int w = 0; w < WPG; ++w) dot += red_s[g][w];
    const float s_new = dot * scale;
    const float M = M_s[g], L = L_s[g];
    float o = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const size_t pi = (part0 + s) * G + g;
      o += expf(m_part[pi] - M) * o_part[pi * D + dd];
    }
    float pool = L > 0.f ? o / L : 0.f;
    if (round_out) pool = round_bf16(pool);
    const float lse = L > 0.f ? M + logf(L) : -INFINITY;
    const float m_tot = fmaxf(lse, s_new);
    const float w_pool = expf(lse - m_tot);
    const float p_new = expf(s_new - m_tot);
    const float res = (pool * w_pool + p_new * vn) / (w_pool + p_new);
    store_any(out, ((size_t)b * H + h * G + g) * D + dd, res, q_bf16);
  }
}

template <typename TP, int D>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_pool, const void* v_pool, const int* table,
           const int* q_pos, float* o_part, float* m_part, float* l_part,
           void* out, int B, int KVH, int G, int NB, int BLK, int MB,
           int layer, int q_bf16, int split, int n_split, float scale,
           cudaStream_t st) {
  const dim3 grid_split(n_split, KVH, B);
  stock_split_kernel<TP, D><<<grid_split, NTHREADS, 0, st>>>(
      q, q_bf16, static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), table, q_pos, o_part, m_part, l_part,
      KVH, G, NB, BLK, MB, layer, split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // JAX stores the pool output in q's dtype when G % 8 == 0 (float32
  // otherwise): a bf16 q rounds it once here.
  const int round_out = q_bf16 && G % 8 == 0;
  stock_combine_kernel<D><<<dim3(KVH, B), NTHREADS, 0, st>>>(
      q, k_new, v_new, q_bf16, o_part, m_part, l_part, q_pos, out, KVH, G,
      MB * BLK, split, n_split, round_out, scale);
  return (int)cudaGetLastError();
}

template <typename TP>
int dispatch_d(int D, const void* q, const void* k_new, const void* v_new,
               const void* k_pool, const void* v_pool, const int* table,
               const int* q_pos, float* o_part, float* m_part, float* l_part,
               void* out, int B, int KVH, int G, int NB, int BLK, int MB,
               int layer, int q_bf16, int split, int n_split, float scale,
               cudaStream_t st) {
  if (D == 128) {
    return launch<TP, 128>(q, k_new, v_new, k_pool, v_pool, table, q_pos,
                           o_part, m_part, l_part, out, B, KVH, G, NB, BLK,
                           MB, layer, q_bf16, split, n_split, scale, st);
  }
  if (D == 64) {
    return launch<TP, 64>(q, k_new, v_new, k_pool, v_pool, table, q_pos,
                          o_part, m_part, l_part, out, B, KVH, G, NB, BLK,
                          MB, layer, q_bf16, split, n_split, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype (q, k_new, v_new, out) and pool_dtype: 0 = float32, 1 =
// bfloat16.  split: slots per block of the split pass (a multiple of 64);
// n_split = ceil(MB*BLK / split), the scratch's split axis.  scale =
// 1/sqrt(d).  Launches the split pass and the combine pass on `stream`
// and does not synchronise.  Returns the first launch's cudaError_t (0 on
// success).
extern "C" int stock_paged_decode(const void* q, const void* k_new,
                                  const void* v_new, const void* k_pool,
                                  const void* v_pool, const int* table,
                                  const int* q_pos, float* o_part,
                                  float* m_part, float* l_part, void* out,
                                  int B, int KVH, int G, int D, int NB,
                                  int BLK, int MB, int layer, int q_dtype,
                                  int pool_dtype, int split, int n_split,
                                  float scale, void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0 || G > MAXG || NB <= 0 || BLK <= 0 ||
      MB <= 0 || layer < 0 || B > 65535 || KVH > 65535 || split <= 0 ||
      split % 64 != 0 || n_split <= 0 ||
      (long)n_split * split < (long)MB * BLK || q_dtype < 0 || q_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 1) {
    return dispatch_d<__nv_bfloat16>(D, q, k_new, v_new, k_pool, v_pool,
                                     table, q_pos, o_part, m_part, l_part,
                                     out, B, KVH, G, NB, BLK, MB, layer,
                                     q_dtype, split, n_split, scale, st);
  }
  if (pool_dtype == 0) {
    return dispatch_d<float>(D, q, k_new, v_new, k_pool, v_pool, table,
                             q_pos, o_part, m_part, l_part, out, B, KVH, G,
                             NB, BLK, MB, layer, q_dtype, split, n_split,
                             scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

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
// HBM bandwidth, and what keeps a kernel from it is how much of that K/V
// is in flight at once and how many round trips to memory each block
// waits for in turn.  The design is split-KV flash-decoding, as the paged
// kernel's (paged_decode.cu, which keeps the positional mask, T > 1 and
// int8 pools that this slot does not take):
//   * Split pass: one block per (split of `split` slots, KV head, row),
//     four warps.  A block whose split starts at or past the row's length
//     returns at once.  The block first lists its split's source rows in
//     shared memory (the flat slot, -2 for a sentinel entry, -1 past the
//     row's length; any block size works, and a run of 16 slots may
//     cross a page).  Then each warp runs on its own, with no block-wide
//     barrier: it takes the split's 16-slot chunks w, w + 4, w + 8, ...
//     and keeps NST = 2 of them in flight in its own ring of shared
//     memory (cp.async, 16 bytes a copy; a sentinel or a slot past the
//     length is zero-filled by the copy itself and never read).  The
//     split size is the wrapper's (STOCK_SPLIT, 512 slots): measured at
//     the serving shape against 128 and 256, it gave the fewest partials
//     for the combine pass to read and the least device time (PERF.md).
//   * Tensor cores for every dtype: S = q3 K^T and O += P V by mma.sync
//     m16n8k16 (bf16 in, float32 accumulate), the G <= 8 query heads of
//     the KV head as the rows of one m-tile (rows G..15 are zero).  K and
//     V are bf16 values whatever the pool: a bf16 pool's tile is the
//     operand as it lies, a float32 pool's values are rounded to bf16 as
//     each fragment is read (the function rounds K/V to bf16 anyway).
//     The stock body keeps q3 and P in float32, so the kernel hands the
//     tensor cores float32 values split into bf16 terms: a float32 q3
//     and every P as hi + mid + lo (three products; each term the rounded
//     remainder of the ones before it, so the three carry the float32
//     value); a bf16 q3 is one term.  The products are exact and the sums
//     float32, so the result is the CUDA-core arithmetic's up to
//     summation order.  A float32 q thus runs on the tensor cores too,
//     not on the CUDA cores: one body for every dtype, its loads and
//     pipeline shared, at the price of three products where one would do.
//   * The online softmax per warp in float32, natural base (expf), as the
//     stock body; sentinel slots score MASK_VALUE, slots past the length
//     -inf.  Each warp keeps its own (m, l, acc) in registers; the four
//     are joined in shared memory at the end into the split's
//     unnormalised partial (o, m, l), in a fixed order.
//   * Combine pass: one block per (KV head, row) reads the row's live
//     splits only, rescales them to the common max (out, m, l), and folds
//     in the step's own slot (the merge above), so the model receives the
//     layer's attention output from two launches and no torch arithmetic.
//   * No atomics and a fixed order of every sum: identical inputs give
//     bit-identical outputs.
// Not done yet (later work): a grid sized from the rows' lengths instead
// of the table's capacity (the lengths live on the card), and the combine
// folded into the split pass's last block.

#include "flash_common.cuh"

namespace {

using flash::ld32;
using flash::mma_bf16;
using flash::pack_bf16x2;
using flash::pack_raw;
using flash::warp_sum;

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;         // query heads per KV head
constexpr int CS = 16;          // slots per chunk: one P.V k-step
constexpr int NST = 2;          // chunks in flight per warp
constexpr int NP = 3;           // bf16 terms of P
constexpr int MAX_SPLIT = 512;  // slots per split the block lists
constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

// Round a float32 to bf16 and back (the stock body's in-kernel K/V cast).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The two bf16 values of a packed word, as float32.
__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
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

// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A warp's ring of NST chunk stages: K rows then V rows of CS slots each,
// row strides padded so that the fragment reads below hit distinct banks
// (bf16: 4 bytes a lane at stride D + 8; float32 K: 8 bytes a lane at
// stride D + 8, float32 V: 4 bytes a lane at stride D + 4).  Ahead of the
// rings, the split's source rows (int [MAX_SPLIT]).  TP: the pool's
// element (uint16_t for bf16, float).
template <typename TP, int D>
struct Ring {
  static constexpr bool F32 = sizeof(TP) == 4;
  static constexpr int VEC = 16 / sizeof(TP);  // elements per copy
  static constexpr int LDK = D + 8;
  static constexpr int LDV = F32 ? D + 4 : D + 8;
  static constexpr int K_BYTES = CS * LDK * (int)sizeof(TP);
  static constexpr int STAGE = K_BYTES + CS * LDV * (int)sizeof(TP);
  static constexpr int WARP_BYTES = NST * STAGE;
  static constexpr int RING0 = MAX_SPLIT * 4;
  static constexpr int BYTES = RING0 + NWARPS * WARP_BYTES;
  static_assert(BYTES <= 232448, "shared memory of one block");
  // The join area (per warp: MAXG rows of acc, m, l) reuses the rings.
  static_assert((MAXG * D + 2 * MAXG) * 4 <= WARP_BYTES, "join area");
  static_assert(STAGE % 16 == 0 && (LDK * sizeof(TP)) % 16 == 0 &&
                    (LDV * sizeof(TP)) % 16 == 0,
                "16-byte copies");
};

// Start the copies of one chunk (CS source rows `src`) into `stage`, each
// lane a share of the rows' 16-byte pieces.
template <typename TP, int D>
__device__ __forceinline__ void copy_chunk(unsigned char* stage,
                                           const TP* __restrict__ kplane,
                                           const TP* __restrict__ vplane,
                                           const int* src, int lane) {
  using R = Ring<TP, D>;
  constexpr int CH = D / R::VEC;  // copies per row
#pragma unroll
  for (int c = lane; c < CS * CH; c += 32) {
    const int j = c / CH, col = (c % CH) * R::VEC;
    const int flat = src[j];
    const size_t off = (size_t)(flat < 0 ? 0 : flat) * D + col;
    const int bytes = flat < 0 ? 0 : 16;
    cp_async16(stage + (j * R::LDK + col) * sizeof(TP), kplane + off, bytes);
    cp_async16(stage + R::K_BYTES + (j * R::LDV + col) * sizeof(TP),
               vplane + off, bytes);
  }
}

// Two adjacent K elements of a row (the mma B fragment along d) as a
// bf16 pair; a float32 pool's values are rounded here.
__device__ __forceinline__ uint32_t k_pair(const uint16_t* p) {
  return ld32(p);
}
__device__ __forceinline__ uint32_t k_pair(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16x2(x.x, x.y);
}

// V at rows r and r + 1 of column col (the mma B fragment along the
// slots) as a bf16 pair.
__device__ __forceinline__ uint32_t v_pair(const uint16_t* v, int ld, int r,
                                           int col) {
  return pack_raw(v[r * ld + col], v[(r + 1) * ld + col]);
}
__device__ __forceinline__ uint32_t v_pair(const float* v, int ld, int r,
                                           int col) {
  return pack_bf16x2(v[r * ld + col], v[(r + 1) * ld + col]);
}

// The split pass's instance, as the C entry point reports it: 1 + 2*QF32
// + (float32 pool); the wrapper names it (``stock_instance_name``).
template <typename TP, bool QF32>
constexpr int instance_code() {
  return 1 + 2 * QF32 + (sizeof(TP) == 4);
}

// The split pass.  TP: pool element (uint16_t bf16 or float); D:
// head_dim; QF32: q is float32 (q3 in three bf16 terms), else bf16.
template <typename TP, int D, bool QF32>
__global__ void __launch_bounds__(NTHREADS)
stock_split_kernel(const void* __restrict__ q, const TP* __restrict__ k_pool,
                   const TP* __restrict__ v_pool,
                   const int* __restrict__ table,
                   const int* __restrict__ q_pos, float* __restrict__ o_part,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   int KVH, int G, int NB, int BLK, int MB, int layer,
                   int split, float scale) {
  using R = Ring<TP, D>;
  constexpr int KSTEPS = D / 16, DBLK = D / 8;
  constexpr int NQ = QF32 ? 3 : 1;  // bf16 terms of q3
  extern __shared__ __align__(128) unsigned char smem[];
  int* src_s = reinterpret_cast<int*>(smem);

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int length = min(max(q_pos[b], 0), MB * BLK);
  const int start = sp * split;
  if (start >= length) return;  // the combine pass reads live splits only
  const int end = min(start + split, length);
  const int nch = (end - start + CS - 1) / CS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;

  const int* trow = table + (size_t)b * MB;
  for (int i = tid; i < nch * CS; i += NTHREADS) {
    const int slot = start + i;
    int flat = -1;  // past the row's length
    if (slot < end) {
      const int blk = trow[slot / BLK];
      flat = blk >= 0 && blk < NB ? blk * BLK + slot % BLK : -2;
    }
    src_s[i] = flat;
  }
  __syncthreads();

  // From here each warp runs alone over chunks warp, warp + NWARPS, ...
  const size_t plane = ((size_t)layer * KVH + h) * NB * BLK;  // in slots
  const TP* kplane = k_pool + plane * D;
  const TP* vplane = v_pool + plane * D;
  unsigned char* ring = smem + R::RING0 + warp * R::WARP_BYTES;
  const int n_mine = nch > warp ? (nch - warp + NWARPS - 1) / NWARPS : 0;
#pragma unroll
  for (int s = 0; s < NST; ++s) {
    if (s < n_mine) {
      copy_chunk<TP, D>(ring + s * R::STAGE, kplane, vplane,
                        src_s + (warp + NWARPS * s) * CS, lane);
    }
    cp_async_commit();
  }

  // q3's A fragments for row grp (rows >= G, and rows 8..15, are zero):
  // features kk*16 + 2*tig (+1) and +8 (+9); a float32 q3 as three bf16
  // terms, each the rounded remainder of the ones before it.
  uint32_t qa[NQ][KSTEPS][2];
  {
    const bool live = grp < G;
    const size_t qrow = ((size_t)(b * KVH + h) * G + (live ? grp : 0)) * D;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = kk * 16 + tig * 2 + 8 * half;
        float x0 = 0.f, x1 = 0.f;
        if (live) {
          if constexpr (QF32) {
            const float2 v =
                *reinterpret_cast<const float2*>(static_cast<const float*>(q) +
                                                 qrow + c);
            x0 = v.x * scale;
            x1 = v.y * scale;
          } else {
            const uint32_t w =
                ld32(static_cast<const uint16_t*>(q) + qrow + c);
            x0 = lo_f32(w) * scale;
            x1 = hi_f32(w) * scale;
          }
        }
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          const uint32_t p = pack_bf16x2(x0, x1);  // rounds: q3 in bf16
          qa[t][kk][half] = p;
          x0 -= lo_f32(p);
          x1 -= hi_f32(p);
        }
      }
    }
  }

  float m_run = -INFINITY, l_run = 0.f;  // row grp; l over this lane's slots
  float o[DBLK][4];
#pragma unroll
  for (int nb = 0; nb < DBLK; ++nb) {
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  }

  for (int i = 0; i < n_mine; ++i) {
    unsigned char* stage = ring + (i % NST) * R::STAGE;
    const TP* kt = reinterpret_cast<const TP*>(stage);
    const TP* vt = reinterpret_cast<const TP*>(stage + R::K_BYTES);
    const int* src = src_s + (warp + NWARPS * i) * CS;
    cp_async_wait<NST - 1>();
    __syncwarp();  // the chunk's copies, by every lane, have landed

    // S = q3 K^T: 16 rows x 16 slots, two n-blocks of 8 slots.
    float sc[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const TP* kr = kt + (nb * 8 + grp) * R::LDK + kk * 16 + tig * 2;
        const uint32_t b0 = k_pair(kr), b1 = k_pair(kr + 8);
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          const uint32_t a[4] = {qa[t][kk][0], 0u, qa[t][kk][1], 0u};
          mma_bf16(sc[nb], a, b0, b1);
        }
      }
    }

    // Row grp's scores: a sentinel slot MASK_VALUE, a slot past the
    // length -inf; the online softmax.  The chunk's first slot lies
    // within the length, so the running max is finite after it.
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int flat = src[nb * 8 + tig * 2 + e];
        const float s =
            flat >= 0 ? sc[nb][e] : (flat == -2 ? MASK_VALUE : -INFINITY);
        sc[nb][e] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      o[nb][0] *= alpha;
      o[nb][1] *= alpha;
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(sc[nb][e] - m_new);
        l_run += p;
        sc[nb][e] = p;
      }
    }

    // O += P V with P as NP bf16 terms, as q3 above: slots 2 tig (+1)
    // from n-block 0, 2 tig + 8 (+9) from n-block 1 (rows 8..15 zero).
    uint32_t pa[NP][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      float x0 = sc[nb][0], x1 = sc[nb][1];
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        const uint32_t w = pack_bf16x2(x0, x1);
        pa[t][2 * nb] = w;
        pa[t][2 * nb + 1] = 0u;
        x0 -= lo_f32(w);
        x1 -= hi_f32(w);
      }
    }
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      const int col = nb * 8 + grp;
      const uint32_t b0 = v_pair(vt, R::LDV, tig * 2, col);
      const uint32_t b1 = v_pair(vt, R::LDV, tig * 2 + 8, col);
#pragma unroll
      for (int t = 0; t < NP; ++t) mma_bf16(o[nb], pa[t], b0, b1);
    }
    __syncwarp();  // every lane has read the stage: refill it
    if (i + NST < n_mine) {
      copy_chunk<TP, D>(stage, kplane, vplane,
                        src_s + (warp + NWARPS * (i + NST)) * CS, lane);
    }
    cp_async_commit();
  }

  // Join the warps: acc, m and l per warp into shared memory (over the
  // rings), then the split's partial, summed over the warps in order.
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  cp_async_wait<0>();
  __syncthreads();
  float* jo = reinterpret_cast<float*>(smem + R::RING0);  // [4][MAXG][D]
  float* jm = jo + NWARPS * MAXG * D;                     // [4][MAXG]
  float* jl = jm + NWARPS * MAXG;                         // [4][MAXG]
  if (grp < G) {
    float* orow = jo + (warp * MAXG + grp) * D;
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      *reinterpret_cast<float2*>(orow + nb * 8 + tig * 2) =
          make_float2(o[nb][0], o[nb][1]);
    }
    if (tig == 0) {
      jm[warp * MAXG + grp] = m_run;
      jl[warp * MAXG + grp] = l_run;
    }
  }
  __syncthreads();
  const size_t part = ((size_t)b * KVH + h) * gridDim.x + sp;
  for (int idx = tid; idx < G * D; idx += NTHREADS) {
    const int g = idx / D, c = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, jm[w * MAXG + g]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = jm[w * MAXG + g];  // -inf: the warp had no chunk
      const float wt = mw == -INFINITY ? 0.f : expf(mw - M);
      acc += wt * jo[(w * MAXG + g) * D + c];
      lsum += wt * jl[w * MAXG + g];
    }
    o_part[(part * G + g) * D + c] = acc;
    if (c == 0) {
      m_part[part * G + g] = M;
      l_part[part * G + g] = lsum;
    }
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

// The split pass's launch: its dynamic shared memory (above 48 KB) is
// opted into once per device; *instance is set once the launch succeeds.
template <typename TP, int D, bool QF32>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q,
                         const void* k_pool, const void* v_pool,
                         const int* table, const int* q_pos, float* o_part,
                         float* m_part, float* l_part, int KVH, int G, int NB,
                         int BLK, int MB, int layer, int split, float scale,
                         int* instance) {
  constexpr int bytes = Ring<TP, D>::BYTES;
  auto kernel = stock_split_kernel<TP, D, QF32>;
  static int opted_device = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != opted_device) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_device = dev;
  }
  kernel<<<grid, NTHREADS, bytes, st>>>(
      q, static_cast<const TP*>(k_pool), static_cast<const TP*>(v_pool),
      table, q_pos, o_part, m_part, l_part, KVH, G, NB, BLK, MB, layer,
      split, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) *instance = instance_code<TP, QF32>();
  return err;
}

template <int D>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* k_pool, const void* v_pool, const int* table,
           const int* q_pos, float* o_part, float* m_part, float* l_part,
           void* out, int B, int KVH, int G, int NB, int BLK, int MB,
           int layer, int q_bf16, int pool_bf16, int split, int n_split,
           float scale, cudaStream_t st, int* instance) {
  const dim3 grid(n_split, KVH, B);
  cudaError_t err;
#define STOCK_SPLIT_ARGS                                                   \
  grid, st, q, k_pool, v_pool, table, q_pos, o_part, m_part, l_part, KVH, \
      G, NB, BLK, MB, layer, split, scale, instance
  if (pool_bf16) {
    err = q_bf16 ? launch_split<uint16_t, D, false>(STOCK_SPLIT_ARGS)
                 : launch_split<uint16_t, D, true>(STOCK_SPLIT_ARGS);
  } else {
    err = q_bf16 ? launch_split<float, D, false>(STOCK_SPLIT_ARGS)
                 : launch_split<float, D, true>(STOCK_SPLIT_ARGS);
  }
#undef STOCK_SPLIT_ARGS
  if (err != cudaSuccess) return (int)err;
  // JAX stores the pool output in q's dtype when G % 8 == 0 (float32
  // otherwise): a bf16 q rounds it once here.
  const int round_out = q_bf16 && G % 8 == 0;
  stock_combine_kernel<D><<<dim3(KVH, B), NTHREADS, 0, st>>>(
      q, k_new, v_new, q_bf16, o_part, m_part, l_part, q_pos, out, KVH, G,
      MB * BLK, split, n_split, round_out, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype (q, k_new, v_new, out) and pool_dtype: 0 = float32, 1 =
// bfloat16.  split: slots per block of the split pass (a multiple of 16,
// at most 512); n_split = ceil(MB*BLK / split), the scratch's split axis.
// scale = 1/sqrt(d).  Launches the split pass and the combine pass on
// `stream` and does not synchronise.  Returns the first failing launch's
// cudaError_t (0 on success); *instance is the split pass's instance once
// its launch succeeds (instance_code: 1 bf16 q and pool, 2 bf16 q and a
// float32 pool, 3 float32 q and a bf16 pool, 4 float32 q and pool), 0
// if it did not launch.
extern "C" int stock_paged_decode(const void* q, const void* k_new,
                                  const void* v_new, const void* k_pool,
                                  const void* v_pool, const int* table,
                                  const int* q_pos, float* o_part,
                                  float* m_part, float* l_part, void* out,
                                  int B, int KVH, int G, int D, int NB,
                                  int BLK, int MB, int layer, int q_dtype,
                                  int pool_dtype, int split, int n_split,
                                  float scale, void* stream,
                                  int* instance) {
  *instance = 0;
  if (B <= 0 || KVH <= 0 || G <= 0 || G > MAXG || NB <= 0 || BLK <= 0 ||
      MB <= 0 || layer < 0 || B > 65535 || KVH > 65535 || split <= 0 ||
      split % CS != 0 || split > MAX_SPLIT || n_split <= 0 ||
      (long)n_split * split < (long)MB * BLK || (long)NB * BLK > INT_MAX ||
      q_dtype < 0 || q_dtype > 1 || pool_dtype < 0 || pool_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return launch<128>(q, k_new, v_new, k_pool, v_pool, table, q_pos, o_part,
                       m_part, l_part, out, B, KVH, G, NB, BLK, MB, layer,
                       q_dtype, pool_dtype, split, n_split, scale, st,
                       instance);
  }
  if (D == 64) {
    return launch<64>(q, k_new, v_new, k_pool, v_pool, table, q_pos, o_part,
                      m_part, l_part, out, B, KVH, G, NB, BLK, MB, layer,
                      q_dtype, pool_dtype, split, n_split, scale, st,
                      instance);
  }
  return (int)cudaErrorInvalidValue;
}

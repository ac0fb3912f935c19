// Flash-attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel `_flash_forward` of
// jax_llama_tpu/ops/flash_attention.py (pallas_call at :868; bodies
// `_flash_kernel`, `_flash_tri_tile_update`, `_tri_gate`), reached from
// `flash_attention` / `_flash_fwd` there, and its int8 branch
// (`flash_attention_quantized`, :629; the int8 branches of `_flash_kernel`
// at :293-294, :400-433, :471-474 and the scale planes at :850-864).  The
// function:
//
//   out[b, t, h] = sum_s softmax_s(q[b,t,h] . k[b,s,h/G] / sqrt(d)) v[b,s,h/G]
//
// over the slots s with 0 <= kv_pos[b,s] <= q_pos[b,t] (kv_pos -1 marks a
// padding or unwritten slot and is treated as +INT_MAX, so one compare
// masks it).  A query row that sees no live slot writes 0.
//
// Two options, each its own template instance so the inference launch
// (neither) runs the code it always ran:
//   * lse: the row logsumexp in natural log, float32 [B, KVH, G*T], from
//     the running base-2 max and sum ((m + log2 l) * ln 2, JAX :505-509);
//     +inf for a row with no live slot, so the backward's P = exp(s - lse)
//     is 0 there.  The backward kernels (flash_bwd.cu) rebuild P from it.
//   * dropout: inverted probability dropout (JAX :453-468).  The
//     accumulator's P is scaled by keep / (1 - rate) while the
//     denominator's P is left alone, which is dropout on the normalised
//     weights.  The keep bit is the hash of flash_common.cuh on the
//     element's global (packed row, slot), so the backward rebuilds it.
//
// Layout: q and out [B, T, H, d], k and v [B, S, KVH, d], all contiguous;
// q_pos [B, T] and kv_pos [B, S] int32.  GQA is packed into the query rows
// as the JAX wrapper packs it: packed row r = g*T + t of KV head kvh is
// query head h = kvh*G + g at token t.  The packing is done by address
// arithmetic here, so no packed copy of q or out is made.
//
// What bounds it on an H100.  At the training shape (B = 4, T = S =
// 2048, H = 32, KVH = 8, d = 128, causal) the live (query, slot) pairs
// need ~138 GFLOP on the tensor cores against ~170 MB moved: operations
// bound it (0.139 ms at the bf16 peak, the bytes 0.05 ms).  At the prefill shape (B = 4,
// T = S = 512, left padding) and the serving insert (B = 8, T = S =
// 1024) the bytes (q, k, v and out once) and the FLOPs are within a few
// times of each other; at decode (T = 1 over a long cache) it is
// streaming K/V once per KV head.  Between the tiles, the exp/max/rescale
// work runs on the CUDA cores.  Three bf16 instances:
//   * The Hopper instance (flash_fwd_wgmma; bf16, d = 128, T a multiple
//     of 128: training, prefill, the serving inserts), one block per (128
//     packed rows of one query head, KV head, batch), 288 threads:
//     - a producer warp loads the block's Q tile once and keeps NST = 2
//       stages of 128-slot K/V tiles in flight with TMA (4-D tensor maps
//       over [B, T, H, d] and [B, S, KVH, d], 128-byte swizzle: a d = 128
//       row is two 64-element boxes), completion signalled on mbarriers;
//       it also copies each tile's kv_pos (and, with dropout, the tile's
//       column hash words) into the stage, skips tiles that no row of the
//       block may attend, and marks a tile that every row may attend in
//       full, which then takes no compare;
//     - two consumer warpgroups of 64 rows each run S = Q K^T as wgmma
//       m64n128k16 with both operands in shared memory (K-major), the
//       online softmax in registers in base 2, and O += P V as wgmma with
//       P from registers (rounded to bf16) and V from shared memory as an
//       MN-major operand; a consumer releases a stage on its mbarrier
//       only after the wgmma reading it has completed;
//     - the wgmma accumulator maps thread (warp w, lane) to rows 16 w +
//       lane/4 (+8) and columns 8 i + 2 (lane % 4) (+1) of the 64-row
//       slab: the dropout hash and the lse take each element's global
//       (packed row, slot) from that, so the bits are the plain version's.
//     Grid rows run the late query tiles (the most K/V under a causal
//     mask) first.  The tensor maps are encoded per call on the host
//     (hopper_common.cuh).
//   * The split-KV instance (flash_fwd_split; bf16, d = 64 or 128, at
//     most 16 packed rows G*T, no dropout: T = 1 decode over a long
//     cache).  Decode is streaming K/V once per KV head, so what bounds it
//     is how much of the cache is in flight at once: a grid of one block
//     per (batch, KV head) would leave most SMs idle and each block
//     walking the whole cache in turn.  So two passes, as paged_decode.cu:
//     - a split pass, one block per (run of `split` slots, KV head,
//       batch), four warps.  The block lists its run's positions and the
//       16-slot chunks that hold a live slot for some row (a run with none
//       loads nothing and writes max -inf); each warp then runs alone over
//       the listed chunks w, w + 4, ... with NST = 2 of them in flight in
//       its own cp.async ring; q.k and P.v by mma.sync m16n8k16 with the
//       <= 16 packed rows as one m-tile; base-2 online softmax per warp;
//       the four warps joined in shared memory, in a fixed order, into the
//       run's float32 partial (out, max, sum);
//     - a combine pass, one block per (KV head, batch), that merges the
//       runs by their max in a fixed order (no atomics: repeated calls are
//       bit-identical) and writes out in bf16 and, when asked, lse.
//     The run length is the wrapper's FLASH_SPLIT (SPLIT here; the entry
//     point rejects a run count computed from another value), chosen by a
//     sweep on the card (PERF.md).
//   * The mma.sync instance (every other bf16 call: ragged T, d = 64,
//     T = 1 with dropout or more than 16 packed rows; and the int8 cache
//     below): one block per (batch, KV head, 64 packed rows), four warps
//     of 16 rows; Q fragments, scores and the output accumulator in
//     registers; K/V tiles copied through registers into padded shared
//     memory, one tile at a time.
//   All pack GQA so each K/V tile is read once per KV head and query
//   tile, skip dead KV tiles (the block's last live slot bounds the walk,
//   the JAX wrapper's per-q-tile bound :794-803; tiles below it with no
//   live slot are never loaded), run the online softmax in base 2
//   (log2(e) folded into the scale) in fp32, and round P to the input
//   dtype for P.V as the JAX kernel does.
//
// The float32 path is a plain CUDA-core kernel (one warp per packed row)
// kept for callers that run the model in float32; the main path is bf16.
//
// int8 KV (`flash_fwd_int8`, the Q8 instances; inference only: no lse, no
// dropout): k and v are int8 [B, S, KVH, d] with float32 per-slot-per-head
// scales k_scale, v_scale [B, S, KVH]; the effective keys and values are
// k * k_scale and v * v_scale.  Each K/V tile is read as int8 (half the
// bytes of bf16) and converted into the bf16 shared-memory tile that the
// bf16 instance fills (int8 magnitudes up to 127 are exact in bf16), so
// the mma.sync fragments and their bank-conflict-free padding are the
// bf16 instance's; the tile's BN scales per KV head are read at stride
// KVH into shared memory.  Each score is multiplied by its slot's k_scale
// before the mask (an unwritten slot has scale 0 and payload 0, and a
// score of 0 is not -inf, so the mask must come after the fold), and
// each probability by its slot's v_scale before it is rounded to bf16 for
// P.V, as the JAX kernel folds them.  The float32 instance converts the
// int8 tile to float32 and folds the same way.  The Hopper int8 instance
// (flash_fwd_int8_wgmma; bf16 q, d = 128, T a multiple of 128: every int8
// insert and prefill) is the bf16 Hopper instance with a producer
// warpgroup in place of its producer warp, 384 threads:
//   * one producer thread keeps NL = 3 landing stages of 64 int8 slots
//     (K and V, a d = 128 row being one 128-byte TMA box) in flight,
//     its cursor running ahead over the live tiles;
//   * the four producer warps (one on each SM sub-partition) widen each
//     landing stage into the bf16 K/V stage the consumers read (exactly:
//     int8 magnitudes fit bf16), with generic stores in the 128-byte
//     swizzled layout that TMA would have written, copy the tile's
//     positions and its per-slot k_scale and v_scale (stride KVH) beside
//     it, then fence.proxy.async and arrive: wgmma reads the stage
//     through the async proxy;
//   * the consumers are the bf16 instance's, folding each slot's k_scale
//     into S before the mask and its v_scale into P before the bf16
//     rounding.
// Shared memory: Q 32 KB, two bf16 K/V stages 128 KB, the int8 landing
// ring 48 KB (three stages of two 64-slot 8 KB tiles; two 128-slot stages
// would not fit in 227 KB beside the rest).
//
// Every entry point reports the instance it launched through its last
// `int*` (1 float32, 2 mma_sync, 3 wgmma, 4 split_kv; 0 if nothing
// launched), and flash_fwd_split also how many kernels it launched.

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

// The instance codes the entry points report.
constexpr int INST_FLOAT32 = 1, INST_MMA_SYNC = 2, INST_WGMMA = 3,
              INST_SPLIT_KV = 4;

// Four int8 values (one word) as four exact float32 values without an
// int-to-float conversion: each byte, offset by 128, becomes the low byte
// of the float 2^23 + (x + 128), from which 2^23 + 128 is subtracted.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) -
           8388736.f;
  }
}

// Sixteen int8 values (one 16-byte word) as sixteen bf16 values, packed in
// pairs: two 16-byte words.
__device__ __forceinline__ void int8x16_to_bf16(uint4 x, uint4& lo,
                                                uint4& hi) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    int8x4_to_f32(w[i], f);
    o[2 * i] = pack_bf16x2(f[0], f[1]);
    o[2 * i + 1] = pack_bf16x2(f[2], f[3]);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// Sixteen int8 values from 16 global bytes, as bf16 (exact), into 32
// bytes of shared memory.
__device__ __forceinline__ void store_int8_as_bf16(uint16_t* dst, uint4 x) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  int8x16_to_bf16(x, d4[0], d4[1]);
}

// 16 bytes global -> shared without a register; src_bytes 0 fills zeros.
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

// Q8: k and v are int8 with float32 scales (k_scale, v_scale [B, S, KVH]);
// otherwise bf16 and the scale pointers are unused.
template <int D, bool LSE, bool DROP, bool Q8>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,
                      const void* __restrict__ k_any,
                      const void* __restrict__ v_any,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ kv_pos,
                      uint16_t* __restrict__ out, float* __restrict__ lse,
                      int T, int S, int H, int KVH, float scale_log2,
                      Dropout drop) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim");
  static_assert(!(Q8 && (LSE || DROP)), "the int8 instance is inference-only");
  constexpr int LD = D + 8;  // padded shared row, in bf16 elements
  constexpr int KSTEPS = D / 16;
  constexpr int DBLK = D / 8;
  constexpr int NBLK = BN / 8;
  const uint16_t* k = static_cast<const uint16_t*>(k_any);
  const uint16_t* v = static_cast<const uint16_t*>(v_any);
  __shared__ __align__(16) uint16_t ks[BN * LD];
  __shared__ __align__(16) uint16_t vs[BN * LD];
  __shared__ int kps[BN];
  __shared__ float ksc_s[Q8 ? BN : 1], vsc_s[Q8 ? BN : 1];
  __shared__ int qmax_s, last_s;

  const int G = H / KVH;
  const int R = G * T;
  const int b = blockIdx.z, kvh = blockIdx.y, row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;

  const int n_tiles = kv_tile_bound(q_pos, kv_pos, b, T, S, R, row0, BM, BN,
                                    &qmax_s, &last_s);
  const int qmax = qmax_s;

  // This thread's two packed rows: grp and grp + 8 of the warp's 16.
  int qp[2];
  const uint16_t* qrow[2];
  size_t orow[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + grp + 8 * i;
    valid[i] = r < R;
    const int t = valid[i] ? r % T : 0;
    const int h = kvh * G + (valid[i] ? r / T : 0);
    qp[i] = valid[i] ? q_pos[b * T + t] : -1;  // -1: attends nothing
    orow[i] = ((size_t)(b * T + t) * H + h) * D;
    qrow[i] = q + orow[i];
  }
  // Dropout: the hash words of this thread's two packed rows.
  uint32_t base_lo = 0, base_hi = 0, rw[2] = {0u, 0u};
  if constexpr (DROP) {
    drop_bases(drop, b, kvh, base_lo, base_hi);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rw[i] = row_word(base_lo, row0 + warp * 16 + grp + 8 * i);
    }
  }

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = valid[0] ? ld32(qrow[0] + c) : 0u;
    qf[kk][1] = valid[1] ? ld32(qrow[1] + c) : 0u;
    qf[kk][2] = valid[0] ? ld32(qrow[0] + c + 8) : 0u;
    qf[kk][3] = valid[1] ? ld32(qrow[1] + c + 8) : 0u;
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial row sums over this thread's columns
  float o[DBLK][4];
#pragma unroll
  for (int nb = 0; nb < DBLK; ++nb) {
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * BN;
    __syncthreads();  // the previous tile's shared reads are done
    bool live = false;
    if (tid < BN) {
      const int s = s0 + tid;
      const int kp = s < S ? remap_pos(kv_pos[(size_t)b * S + s]) : INT_MAX;
      kps[tid] = kp;
      live = kp <= qmax;
    }
    if (!__syncthreads_or(live)) continue;  // dead tile: no K/V traffic

    if constexpr (Q8) {
      // int8 rows, 16 values a load, widened into the bf16 tile; the
      // tile's scales of this KV head (stride KVH).
      const int8_t* k8 = static_cast<const int8_t*>(k_any);
      const int8_t* v8 = static_cast<const int8_t*>(v_any);
      for (int c = tid; c < BN * (D / 16); c += NTHREADS) {
        const int row = c / (D / 16);
        const int col = (c % (D / 16)) * 16;
        const int s = s0 + row;
        uint4 kq = make_uint4(0, 0, 0, 0), vq = make_uint4(0, 0, 0, 0);
        if (s < S) {
          const size_t g = ((size_t)(b * S + s) * KVH + kvh) * D + col;
          kq = *reinterpret_cast<const uint4*>(k8 + g);
          vq = *reinterpret_cast<const uint4*>(v8 + g);
        }
        store_int8_as_bf16(&ks[row * LD + col], kq);
        store_int8_as_bf16(&vs[row * LD + col], vq);
      }
      if (tid < BN) {
        const int s = s0 + tid;
        const size_t g = (size_t)(b * S + s) * KVH + kvh;
        ksc_s[tid] = s < S ? k_scale[g] : 0.f;
        vsc_s[tid] = s < S ? v_scale[g] : 0.f;
      }
    } else {
      for (int c = tid; c < BN * (D / 8); c += NTHREADS) {
        const int row = c / (D / 8);
        const int col = (c % (D / 8)) * 8;
        const int s = s0 + row;
        uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
        if (s < S) {
          const size_t g = ((size_t)(b * S + s) * KVH + kvh) * D + col;
          kv4 = *reinterpret_cast<const uint4*>(k + g);
          vv4 = *reinterpret_cast<const uint4*>(v + g);
        }
        *reinterpret_cast<uint4*>(&ks[row * LD + col]) = kv4;
        *reinterpret_cast<uint4*>(&vs[row * LD + col]) = vv4;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BN slots.
    float sc[NBLK][4];
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NBLK; ++nb) {
        const uint16_t* kr = &ks[(nb * 8 + grp) * LD + kk * 16 + tig * 2];
        mma_bf16(sc[nb], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale into the base-2 domain (int8: times the slot's k_scale), then
    // mask, row max.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = nb * 8 + tig * 2 + (e & 1);
        const int kp = kps[col];
        float s = sc[nb][e] * scale_log2;
        if constexpr (Q8) s *= ksc_s[col];
        s = kp <= qp[i] ? s : -INFINITY;
        sc[nb][e] = s;
        mx[i] = fmaxf(mx[i], s);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - m_use[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      o[nb][0] *= alpha[0];
      o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1];
      o[nb][3] *= alpha[1];
    }
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
      uint32_t cw[2] = {0u, 0u};
      if constexpr (DROP) {
        cw[0] = col_word(base_hi, s0 + nb * 8 + tig * 2);
        cw[1] = col_word(base_hi, s0 + nb * 8 + tig * 2 + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nb][e] - m_use[e >> 1]);
        l[e >> 1] += p;  // the denominator keeps every probability
        if constexpr (DROP) {
          sc[nb][e] = keep(rw[e >> 1], cw[e & 1], drop.threshold)
                          ? p * drop.inv : 0.f;
        } else if constexpr (Q8) {
          sc[nb][e] = p * vsc_s[nb * 8 + tig * 2 + (e & 1)];
        } else {
          sc[nb][e] = p;
        }
      }
    }

    // O += P V: the score accumulators of n-blocks 2j, 2j+1 are exactly
    // the A fragment of k-step j; P is rounded to bf16 here.
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16x2(sc[2 * j][0], sc[2 * j][1]);
      a[1] = pack_bf16x2(sc[2 * j][2], sc[2 * j][3]);
      a[2] = pack_bf16x2(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      a[3] = pack_bf16x2(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      const int r0 = j * 16 + tig * 2;
#pragma unroll
      for (int nb = 0; nb < DBLK; ++nb) {
        const int col = nb * 8 + grp;
        const uint32_t b0 = pack_raw(vs[r0 * LD + col], vs[(r0 + 1) * LD + col]);
        const uint32_t b1 =
            pack_raw(vs[(r0 + 8) * LD + col], vs[(r0 + 9) * LD + col]);
        mma_bf16(o[nb], a, b0, b1);
      }
    }
  }

  // Normalise and store; rows that saw no live slot (l == 0) write 0.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    if constexpr (LSE) {
      if (tig == 0) {
        const int r = row0 + warp * 16 + grp + 8 * i;
        lse[((size_t)b * KVH + kvh) * R + r] =
            l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : INFINITY;
      }
    }
    const float den = l[i] == 0.f ? 1.f : l[i];
    uint16_t* orp = out + orow[i];
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      *reinterpret_cast<uint32_t*>(orp + nb * 8 + tig * 2) =
          pack_bf16x2(o[nb][2 * i] / den, o[nb][2 * i + 1] / den);
    }
  }
}

// float32: one warp per packed query row, lane j owns features j, j+32, ...
constexpr int F32_ROWS = 8;
constexpr int F32_BN = 32;

// DPL: features per lane (head_dim = 32 * DPL).  Q8: k and v are int8
// with float32 scales [B, S, KVH], folded as the bf16 instance folds them.
template <int DPL, bool Q8>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const void* __restrict__ k_any,
                     const void* __restrict__ v_any,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, float* __restrict__ out,
                     float* __restrict__ lse, int T, int S, int H, int KVH,
                     float scale_log2, bool with_drop, Dropout drop) {
  constexpr int D = 32 * DPL;
  using KV = typename std::conditional<Q8, int8_t, float>::type;
  const KV* k = static_cast<const KV*>(k_any);
  const KV* v = static_cast<const KV*>(v_any);
  __shared__ float ks[F32_BN * D];
  __shared__ float vs[F32_BN * D];
  __shared__ int kps[F32_BN];
  __shared__ float ksc_s[Q8 ? F32_BN : 1], vsc_s[Q8 ? F32_BN : 1];
  __shared__ int qmax_s, last_s;

  const int G = H / KVH;
  const int R = G * T;
  const int b = blockIdx.z, kvh = blockIdx.y, row0 = blockIdx.x * F32_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int n_tiles = kv_tile_bound(q_pos, kv_pos, b, T, S, R, row0,
                                    F32_ROWS, F32_BN, &qmax_s, &last_s);
  const int qmax = qmax_s;

  const int r = row0 + warp;
  const bool valid = r < R;
  const int t = valid ? r % T : 0;
  const int h = kvh * G + (valid ? r / T : 0);
  const int qp = valid ? q_pos[b * T + t] : -1;
  const size_t orow = ((size_t)(b * T + t) * H + h) * D;
  float qv[DPL], acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qv[i] = valid ? q[orow + lane + 32 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  uint32_t base_lo = 0, base_hi = 0, rw = 0;
  if (with_drop) {
    drop_bases(drop, b, kvh, base_lo, base_hi);
    rw = row_word(base_lo, r);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * F32_BN;
    __syncthreads();
    bool live = false;
    if (tid < F32_BN) {
      const int s = s0 + tid;
      const int kp = s < S ? remap_pos(kv_pos[(size_t)b * S + s]) : INT_MAX;
      kps[tid] = kp;
      live = kp <= qmax;
    }
    if (!__syncthreads_or(live)) continue;
    for (int c = tid; c < F32_BN * D; c += blockDim.x) {
      const int row = c / D, col = c % D;
      const int s = s0 + row;
      const size_t g = ((size_t)(b * S + s) * KVH + kvh) * D + col;
      ks[c] = s < S ? static_cast<float>(k[g]) : 0.f;
      vs[c] = s < S ? static_cast<float>(v[g]) : 0.f;
    }
    if constexpr (Q8) {
      if (tid < F32_BN) {
        const int s = s0 + tid;
        const size_t g = (size_t)(b * S + s) * KVH + kvh;
        ksc_s[tid] = s < S ? k_scale[g] : 0.f;
        vsc_s[tid] = s < S ? v_scale[g] : 0.f;
      }
    }
    __syncthreads();
    for (int j = 0; j < F32_BN; ++j) {
      if (kps[j] > qp) continue;  // uniform across the warp
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) dot += qv[i] * ks[j * D + lane + 32 * i];
      float s = warp_sum(dot) * scale_log2;
      if constexpr (Q8) s *= ksc_s[j];
      const float m_new = fmaxf(m, s);
      const float alpha = exp2f(m - m_new);
      const float p = exp2f(s - m_new);
      l = l * alpha + p;
      float pa = p;
      if constexpr (Q8) pa = p * vsc_s[j];
      if (with_drop) {
        pa = keep(rw, col_word(base_hi, s0 + j), drop.threshold)
                 ? p * drop.inv : 0.f;
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        acc[i] = acc[i] * alpha + pa * vs[j * D + lane + 32 * i];
      }
      m = m_new;
    }
  }
  if (valid) {
    const float den = l == 0.f ? 1.f : l;
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[orow + lane + 32 * i] = acc[i] / den;
    if (lse != nullptr && lane == 0) {
      lse[((size_t)b * KVH + kvh) * R + r] =
          l > 0.f ? (m + log2f(l)) * LN2 : INFINITY;
    }
  }
}

template <int D, bool LSE, bool DROP, bool Q8 = false>
void launch_bf16(dim3 grid, cudaStream_t st, const void* q, const void* k,
                 const void* v, const int* q_pos, const int* kv_pos, void* out,
                 float* lse, int T, int S, int H, int KVH, float scale_log2,
                 Dropout drop, const float* k_scale = nullptr,
                 const float* v_scale = nullptr) {
  flash_fwd_bf16_kernel<D, LSE, DROP, Q8><<<grid, NTHREADS, 0, st>>>(
      static_cast<const uint16_t*>(q), k, v, k_scale, v_scale, q_pos, kv_pos,
      static_cast<uint16_t*>(out), lse, T, S, H, KVH, scale_log2, drop);
}

template <int D>
void dispatch_bf16(dim3 grid, cudaStream_t st, const void* q, const void* k,
                   const void* v, const int* q_pos, const int* kv_pos,
                   void* out, float* lse, int T, int S, int H, int KVH,
                   float scale_log2, bool with_drop, Dropout drop) {
  if (with_drop) {
    launch_bf16<D, true, true>(grid, st, q, k, v, q_pos, kv_pos, out, lse, T,
                               S, H, KVH, scale_log2, drop);
  } else if (lse != nullptr) {
    launch_bf16<D, true, false>(grid, st, q, k, v, q_pos, kv_pos, out, lse, T,
                                S, H, KVH, scale_log2, drop);
  } else {
    launch_bf16<D, false, false>(grid, st, q, k, v, q_pos, kv_pos, out, lse,
                                 T, S, H, KVH, scale_log2, drop);
  }
}


// ---------------------------------------------------------------------------
// The Hopper instance: bf16, d = 128, T a multiple of 128 (the training
// shape, the prefill and the serving inserts).  One block per (128 packed
// rows of one query head, KV head, batch): a producer warp keeps NST K/V
// stages in flight with TMA and two consumer warpgroups of 64 rows each
// run S = Q K^T and O += P V on wgmma (see the file's header).
// ---------------------------------------------------------------------------

namespace wg {

constexpr int D = 128;
constexpr int BM = 128;              // packed rows per block
constexpr int BN = 128;              // kv slots per tile
constexpr int NST = 2;               // K/V stages
constexpr int NCONS = 256;           // two consumer warpgroups
constexpr int NTHREADS = NCONS + 32; // and one producer warp
constexpr int ROW = 128;             // bytes per swizzled row (64 bf16)
constexpr int Q_BYTES = BM * D * 2;
constexpr int KV_BYTES = BN * D * 2; // one K or V tile: two 64-column boxes
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + Q_BYTES;
constexpr int OFF_V = OFF_K + NST * KV_BYTES;
constexpr int OFF_KP = OFF_V + NST * KV_BYTES;   // int kv_pos [NST][BN]
constexpr int OFF_CW = OFF_KP + NST * BN * 4;    // dropout col words
constexpr int OFF_META = OFF_CW + NST * BN * 4;  // tile, full [NST]; 3 ints
constexpr int OFF_BAR = OFF_META + 64;           // q, full[NST], empty[NST]
constexpr int BYTES = OFF_BAR + (1 + 2 * NST) * 8;
constexpr int SMEM = BYTES + 1024;               // + slack to align to 1024
// The int8 instance: the same layout, then the stages' per-slot scales,
// the landing ring's barriers and, 1024-aligned, its NL stages of int8 K
// then V, LBN slots each (TMA, no swizzle: a slot's d = 128 bytes is one
// row), read by a producer warpgroup.
constexpr int NPROD = 128;                        // the producer warpgroup
constexpr int NTHREADS8 = NCONS + NPROD;
constexpr int LBN = 64;                           // slots per landing stage
constexpr int NL = 3;                             // landing stages
constexpr int LAND_BYTES = 2 * LBN * D;           // K then V, int8
constexpr int OFF_SC = BYTES;                     // float k_scale, v_scale
constexpr int OFF_LBAR = OFF_SC + 2 * NST * BN * 4;  // full[NL], empty[NL]
constexpr int OFF_LAND = (OFF_LBAR + 2 * NL * 8 + 1023) / 1024 * 1024;
constexpr int BYTES8 = OFF_LAND + NL * LAND_BYTES;
constexpr int SMEM8 = BYTES8 + 1024;
static_assert(SMEM8 <= 232448, "the int8 instance's shared memory");
static_assert(BN % LBN == 0 && BN == NPROD, "a landing stage per half tile");

}  // namespace wg

// The int8 instance's producer warpgroup (threads NCONS .. NCONS + 127):
// Q once; the live tiles' int8 K/V halves into the landing ring (TMA,
// issued by producer thread 0, NL stages ahead); each landing stage
// widened into the bf16 stage's 128-byte-swizzled K and V tiles (the
// layout TMA writes for the bf16 instance) by all four warps; the tile's
// positions and scales beside it; a stage with tile -1 ends the walk.
__device__ __forceinline__ void produce_int8(
    unsigned char* smem, uint32_t base, const CUtensorMap& tq,
    const CUtensorMap& tk, const CUtensorMap& tv,
    const int* __restrict__ kv_pos, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, int b, int kvh, int h, int t0, int S,
    int KVH, int n_tiles, int qmax, int qmin) {
  using namespace wg;
  using namespace hopper;
  const int pt = threadIdx.x - NCONS, pw = pt >> 5, lane = pt & 31;
  int* kp_s = reinterpret_cast<int*>(smem + OFF_KP);
  float* ksc_s = reinterpret_cast<float*>(smem + OFF_SC);
  float* vsc_s = ksc_s + NST * BN;
  int* tile_s = reinterpret_cast<int*>(smem + OFF_META);
  int* full_s = tile_s + NST;
  const uint32_t bar_q = base + OFF_BAR;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + NST + s); };
  auto land_full = [&](int s) { return base + OFF_LBAR + 8u * s; };
  auto land_empty = [&](int s) { return base + OFF_LBAR + 8u * (NL + s); };
  const int* kvrow = kv_pos + (size_t)b * S;

  if (pt == 0) {
    mbar_arrive_tx(bar_q, Q_BYTES);
    tma_load_4d(base + OFF_Q, &tq, bar_q, 0, h, t0, b);
    tma_load_4d(base + OFF_Q + BM * ROW, &tq, bar_q, 64, h, t0, b);
  }
  // Warp-wide: the first tile at or after t that some row of the block
  // may attend (n_tiles if none); *full: every row may attend all of it.
  auto next_live = [&](int t, bool* full) {
    for (; t < n_tiles; ++t) {
      bool live = false, all = true;
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int s = t * BN + lane + 32 * i;
        const int kp = s < S ? remap_pos(kvrow[s]) : INT_MAX;
        live |= kp <= qmax;
        all &= kp <= qmin;
      }
      if (__any_sync(0xffffffffu, live)) {
        if (full != nullptr) *full = __all_sync(0xffffffffu, all);
        break;
      }
    }
    return t;
  };
  // Warp 0's cursor: landing stage `issued` holds half `ihalf` of tile
  // `itile`; it is issued once the stage's previous half is widened.
  int itile = 0, ihalf = 0, issued = 0;
  auto issue_next = [&]() {
    const int ls = issued % NL;
    mbar_wait(land_empty(ls), ((issued / NL) & 1u) ^ 1u);
    if (lane == 0) {
      const uint32_t dst = base + OFF_LAND + ls * LAND_BYTES;
      const int s0 = itile * BN + ihalf * LBN;
      mbar_arrive_tx(land_full(ls), LAND_BYTES);
      tma_load_4d(dst, &tk, land_full(ls), 0, kvh, s0, b);
      tma_load_4d(dst + LBN * D, &tv, land_full(ls), 0, kvh, s0, b);
    }
    ++issued;
    if (++ihalf == 2) {
      ihalf = 0;
      itile = next_live(itile + 1, nullptr);
    }
  };
  if (pw == 0) {
    itile = next_live(0, nullptr);
    while (issued < NL && itile < n_tiles) issue_next();
  }

  int stage = 0, c = 0;
  uint32_t phase = 0;
  bool full = false;
  for (int t = next_live(0, &full); t < n_tiles;
       t = next_live(t + 1, &full)) {
    mbar_wait(bar_empty(stage), phase ^ 1u);
    {  // the tile's positions and scales, one slot a thread (BN == NPROD)
      const int s = t * BN + pt;
      const size_t g = ((size_t)b * S + s) * KVH + kvh;
      kp_s[stage * BN + pt] = s < S ? remap_pos(kvrow[s]) : INT_MAX;
      ksc_s[stage * BN + pt] = s < S ? k_scale[g] : 0.f;
      vsc_s[stage * BN + pt] = s < S ? v_scale[g] : 0.f;
      if (pt == 0) {
        tile_s[stage] = t;
        full_s[stage] = full;
      }
    }
    unsigned char* kd = smem + OFF_K + stage * KV_BYTES;
    unsigned char* vd = smem + OFF_V + stage * KV_BYTES;
    for (int half = 0; half < 2; ++half, ++c) {
      const int ls = c % NL;
      mbar_wait(land_full(ls), (c / NL) & 1u);
      const unsigned char* k8 = smem + OFF_LAND + ls * LAND_BYTES;
      const unsigned char* v8 = k8 + LBN * D;
      // 16 int8 values (slot r of the half, features 16 j ..) become two
      // 16-byte bf16 chunks 2 (j % 4) and + 1 of box j / 4, at the
      // swizzled positions (chunk ^ row % 8).  A quarter-warp holds one
      // slot's eight j; the box-1 half writes its odd chunk first, so
      // the eight first stores hit eight distinct bank groups.
#pragma unroll
      for (int i = 0; i < LBN * (D / 16) / NPROD; ++i) {
        const int x = pt + NPROD * i;
        const int r = x >> 3, j = x & 7;
        const int row = half * LBN + r;
        const uint4 kq = *reinterpret_cast<const uint4*>(k8 + r * D + 16 * j);
        const uint4 vq = *reinterpret_cast<const uint4*>(v8 + r * D + 16 * j);
        uint4 klo, khi, vlo, vhi;
        int8x16_to_bf16(kq, klo, khi);
        int8x16_to_bf16(vq, vlo, vhi);
        const int c0 = 2 * (j & 3), sw = row & 7;
        const int off = (j >> 2) * BN * ROW + row * ROW;
        const int a0 = off + ((c0 ^ sw) << 4), a1 = off + (((c0 + 1) ^ sw) << 4);
        if (j < 4) {
          *reinterpret_cast<uint4*>(kd + a0) = klo;
          *reinterpret_cast<uint4*>(kd + a1) = khi;
          *reinterpret_cast<uint4*>(vd + a0) = vlo;
          *reinterpret_cast<uint4*>(vd + a1) = vhi;
        } else {
          *reinterpret_cast<uint4*>(kd + a1) = khi;
          *reinterpret_cast<uint4*>(kd + a0) = klo;
          *reinterpret_cast<uint4*>(vd + a1) = vhi;
          *reinterpret_cast<uint4*>(vd + a0) = vlo;
        }
      }
      mbar_arrive(land_empty(ls));
      if (pw == 0 && itile < n_tiles) issue_next();
    }
    // The widened tile is read by wgmma (the async proxy).
    fence_proxy_async_shared();
    mbar_arrive(bar_full(stage));
    if (++stage == NST) {
      stage = 0;
      phase ^= 1u;
    }
  }
  mbar_wait(bar_empty(stage), phase ^ 1u);
  if (pt == 0) tile_s[stage] = -1;
  mbar_arrive(bar_full(stage));
}

// The Hopper instances' body.  Q8 = false: bf16 K/V by TMA, one producer
// warp (NTHREADS); Q8 = true: int8 K/V widened by a producer warpgroup
// (NTHREADS8), scales folded as the mma.sync Q8 instance folds them.
template <bool LSE, bool DROP, bool Q8>
__device__ __forceinline__ void wgmma_body(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    uint16_t* __restrict__ out, float* __restrict__ lse, int T, int S, int H,
    int KVH, float scale_log2, Dropout drop) {
  using namespace wg;
  using namespace hopper;
  static_assert(!(Q8 && (LSE || DROP)), "the int8 instance is inference-only");
  constexpr int NTH = Q8 ? NTHREADS8 : NTHREADS;
  extern __shared__ unsigned char smem_raw[];
  // TMA boxes and swizzle atoms want 1024-byte alignment.
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  int* kp_s = reinterpret_cast<int*>(smem + OFF_KP);
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(smem + OFF_CW);
  float* ksc_s = reinterpret_cast<float*>(smem + OFF_SC);  // [NST][BN]
  float* vsc_s = ksc_s + NST * BN;
  int* tile_s = reinterpret_cast<int*>(smem + OFF_META);
  int* full_s = tile_s + NST;
  int* red_s = full_s + NST;  // the block's max and min q_pos, last slot
  const uint32_t bar_q = base + OFF_BAR;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + NST + s); };
  auto land_full = [&](int s) { return base + OFF_LBAR + 8u * s; };
  auto land_empty = [&](int s) { return base + OFF_LBAR + 8u * (NL + s); };

  const int G = H / KVH;
  const int R = G * T;
  // Late query tiles (the most live K/V under a causal mask) first.
  const int t0 = (T / BM - 1 - (int)blockIdx.y) * BM;
  int x = blockIdx.x;
  const int g = x % G;
  x /= G;
  const int kvh = x % KVH, b = x / KVH;
  const int h = kvh * G + g;
  const int row0 = g * T + t0;  // the block's first packed row
  const int tid = threadIdx.x;

  if (tid == 0) {
    red_s[0] = INT_MIN;
    red_s[1] = INT_MAX;
    red_s[2] = -1;
    mbar_init(bar_q, 1);
    for (int s = 0; s < NST; ++s) {
      // The producer warp's lanes (bf16) or warpgroup's threads (int8).
      mbar_init(bar_full(s), Q8 ? NPROD : 32);
      mbar_init(bar_empty(s), NCONS);  // every consumer thread
    }
    if constexpr (Q8) {
      for (int s = 0; s < NL; ++s) {
        mbar_init(land_full(s), 1);
        mbar_init(land_empty(s), NPROD);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();
  // The block's query positions and the last slot any of them may attend
  // (kv_tile_bound's bound, over the whole block).
  if (tid < BM) {
    const int p = q_pos[(size_t)b * T + t0 + tid];
    atomicMax(&red_s[0], p);
    atomicMin(&red_s[1], p);
  }
  __syncthreads();
  const int qmax = red_s[0], qmin = red_s[1];
  {
    int last = -1;
    for (int s = tid; s < S; s += NTH) {
      if (remap_pos(kv_pos[(size_t)b * S + s]) <= qmax) last = s;
    }
    if (last >= 0) atomicMax(&red_s[2], last);
  }
  __syncthreads();
  const int n_tiles = (red_s[2] + BN) / BN;

  const int warp = tid >> 5, lane = tid & 31;
  uint32_t base_lo = 0, base_hi = 0;
  if constexpr (DROP) drop_bases(drop, b, kvh, base_lo, base_hi);
  if constexpr (Q8) {
    if (warp >= NCONS / 32) {
      produce_int8(smem, base, tq, tk, tv, kv_pos, k_scale, v_scale, b, kvh,
                   h, t0, S, KVH, n_tiles, qmax, qmin);
      return;
    }
  } else if (warp == NCONS / 32) {
    // Producer: Q once, then each live tile's K, V (TMA), positions (plain
    // loads) and, with dropout, the hash words of its BN slots into the
    // next free stage; a tile no row may attend is skipped, and a stage
    // whose tile is -1 ends the walk.
    if (lane == 0) {
      mbar_arrive_tx(bar_q, Q_BYTES);
      tma_load_4d(base + OFF_Q, &tq, bar_q, 0, h, t0, b);
      tma_load_4d(base + OFF_Q + BM * ROW, &tq, bar_q, 64, h, t0, b);
    }
    const int* kvrow = kv_pos + (size_t)b * S;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int s0 = tile * BN;
      int kp[BN / 32];
      bool live = false, full = true;
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int s = s0 + lane + 32 * i;
        kp[i] = s < S ? remap_pos(kvrow[s]) : INT_MAX;
        live |= kp[i] <= qmax;
        full &= kp[i] <= qmin;
      }
      if (!__any_sync(0xffffffffu, live)) continue;
      full = __all_sync(0xffffffffu, full);
      mbar_wait(bar_empty(stage), phase ^ 1u);
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        kp_s[stage * BN + lane + 32 * i] = kp[i];
        if constexpr (DROP) {
          cw_s[stage * BN + lane + 32 * i] =
              col_word(base_hi, s0 + lane + 32 * i);
        }
      }
      if (lane == 0) {
        tile_s[stage] = tile;
        full_s[stage] = full;
        const uint32_t kd = base + OFF_K + stage * KV_BYTES;
        const uint32_t vd = base + OFF_V + stage * KV_BYTES;
        mbar_arrive_tx(bar_full(stage), 2 * KV_BYTES);
        tma_load_4d(kd, &tk, bar_full(stage), 0, kvh, s0, b);
        tma_load_4d(kd + BN * ROW, &tk, bar_full(stage), 64, kvh, s0, b);
        tma_load_4d(vd, &tv, bar_full(stage), 0, kvh, s0, b);
        tma_load_4d(vd + BN * ROW, &tv, bar_full(stage), 64, kvh, s0, b);
      } else {
        mbar_arrive(bar_full(stage));
      }
      if (++stage == NST) {
        stage = 0;
        phase ^= 1u;
      }
    }
    mbar_wait(bar_empty(stage), phase ^ 1u);
    if (lane == 0) tile_s[stage] = -1;
    mbar_arrive(bar_full(stage));
    return;
  }

  // Consumers: warpgroup wgi owns the block's rows [64 wgi, 64 wgi + 64);
  // in the wgmma accumulator, warp wl's lane holds rows 16 wl + lane/4
  // (+8) and columns 8 i + 2 (lane % 4) (+1) of chunk i.
  const int wgi = tid >> 7, wl = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;
  int qp[2], rloc[2];
  uint32_t rw[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rloc[i] = 64 * wgi + 16 * wl + grp + 8 * i;
    qp[i] = q_pos[(size_t)b * T + t0 + rloc[i]];
    if constexpr (DROP) rw[i] = row_word(base_lo, row0 + rloc[i]);
  }
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial row sums over this thread's columns
  const uint32_t qa = base + OFF_Q + wgi * 64 * ROW;

  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(bar_full(stage), phase);
    const int tile = tile_s[stage];
    if (tile < 0) break;
    const bool full = full_s[stage] != 0;
    const int* kp = kp_s + stage * BN;
    const uint32_t* cws = cw_s + stage * BN;
    const float* ksc = ksc_s + stage * BN;
    const float* vsc = vsc_s + stage * BN;
    const uint32_t kb = base + OFF_K + stage * KV_BYTES;
    const uint32_t vb = base + OFF_V + stage * KV_BYTES;

    // S = Q K^T: 8 k-steps of 16, four in each 64-column box; within a
    // swizzled row a k-step is 32 bytes on from the last.
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_m64n128_ss(
          sc, sw128_desc(qa + (kk >> 2) * BM * ROW + off, 16, 1024),
          sw128_desc(kb + (kk >> 2) * BN * ROW + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);

    // Base-2 scores; the per-element mask only on a tile that some row
    // may not attend in full; row max over the quad.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[4 * i + e] * scale_log2;
        // int8: times the slot's k_scale before the mask (an unwritten
        // slot has scale 0, and a score of 0 is not -inf).
        if constexpr (Q8) s *= ksc[8 * i + 2 * tig + (e & 1)];
        if (!full && kp[8 * i + 2 * tig + (e & 1)] > qp[e >> 1]) s = -INFINITY;
        sc[4 * i + e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i + 2 * r] *= alpha;
        o[4 * i + 2 * r + 1] *= alpha;
      }
    }
    // P (dropped where the hash says, times 1 / (1 - rate)), rounded to
    // bf16 into the A fragments: chunks 2j, 2j+1 are k-step j.
    uint32_t pa[8][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint2 cw = make_uint2(0u, 0u);
      if constexpr (DROP) {
        cw = *reinterpret_cast<const uint2*>(cws + 8 * i + 2 * tig);
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(sc[4 * i + e] - m_use[e >> 1]);
        l[e >> 1] += pe;  // the denominator keeps every probability
        if constexpr (DROP) {
          p[e] = keep(rw[e >> 1], (e & 1) ? cw.y : cw.x, drop.threshold)
                     ? pe * drop.inv
                     : 0.f;
        } else if constexpr (Q8) {
          p[e] = pe * vsc[8 * i + 2 * tig + (e & 1)];  // before the rounding
        } else {
          p[e] = pe;
        }
      }
      pa[i >> 1][2 * (i & 1)] = pack_bf16x2(p[0], p[1]);
      pa[i >> 1][2 * (i & 1) + 1] = pack_bf16x2(p[2], p[3]);
    }

    // O += P V: V is the MN-major B operand (d contiguous): 8 slots of
    // 128 bytes per swizzle atom (stride 1024 bytes along k), the second
    // 64 columns one box (BN rows) on; k-step j starts 16 rows on.
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wgmma_m64n128_rs(o, pa[j], sw128_desc(vb + j * 16 * ROW, BN * ROW, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
    mbar_arrive(bar_empty(stage));
    if (++stage == NST) {
      stage = 0;
      phase ^= 1u;
    }
  }

  // Normalise and store; a row that saw no live slot (l == 0) writes 0.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (LSE) {
      if (tig == 0) {
        lse[((size_t)b * KVH + kvh) * R + row0 + rloc[r]] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : INFINITY;
      }
    }
    const float den = l[r] == 0.f ? 1.f : l[r];
    uint16_t* orow = out + ((size_t)(b * T + t0 + rloc[r]) * H + h) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * tig) =
          pack_bf16x2(o[4 * i + 2 * r] / den, o[4 * i + 2 * r + 1] / den);
    }
  }
}

template <bool LSE, bool DROP>
__global__ void __launch_bounds__(wg::NTHREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos,
                       uint16_t* __restrict__ out, float* __restrict__ lse,
                       int T, int S, int H, int KVH, float scale_log2,
                       Dropout drop) {
  wgmma_body<LSE, DROP, false>(tq, tk, tv, q_pos, kv_pos, nullptr, nullptr,
                               out, lse, T, S, H, KVH, scale_log2, drop);
}

// tk, tv: int8 maps in boxes of LBN slots (encode_int8_4d).
__global__ void __launch_bounds__(wg::NTHREADS8, 1)
flash_fwd_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ kv_pos,
                            uint16_t* __restrict__ out, int T, int S, int H,
                            int KVH, float scale_log2) {
  wgmma_body<false, false, true>(tq, tk, tv, q_pos, kv_pos, k_scale, v_scale,
                                 out, nullptr, T, S, H, KVH, scale_log2,
                                 Dropout{0u, 0u, 0u, 1.f, 0u, 0u});
}

template <bool LSE, bool DROP>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, const int* q_pos, const int* kv_pos,
                 void* out, float* lse, int B, int T, int S, int H, int KVH,
                 float scale_log2, Dropout drop, cudaStream_t st) {
  auto kernel = flash_fwd_wgmma_kernel<LSE, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * KVH * (H / KVH)), (unsigned)(T / wg::BM));
  kernel<<<grid, wg::NTHREADS, wg::SMEM, st>>>(
      tq, tk, tv, q_pos, kv_pos, static_cast<uint16_t*>(out), lse, T, S, H,
      KVH, scale_log2, drop);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The split-KV instance: bf16, at most MAXR packed rows, no dropout (T = 1
// decode).  A split pass over runs of `split` slots, then a combine pass
// (see the file's header).
// ---------------------------------------------------------------------------

namespace sk {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXR = 16;        // packed rows G*T: one m16 tile
constexpr int CS = 16;          // slots per chunk: one P.V k-step
constexpr int NST = 2;          // chunks in flight per warp
constexpr int SPLIT = 256;      // slots per run (the wrapper's FLASH_SPLIT)
constexpr int MAX_SPLIT = 512;  // the longest run a block lists
constexpr int MAX_CHUNKS = MAX_SPLIT / CS;  // 32: one warp's ballot

// Dynamic shared memory: the run's positions and live chunk list, then
// each warp's ring of NST chunks (K rows then V rows, padded so that the
// fragment reads hit distinct banks).  The join reuses the rings.
template <int D>
struct Ring {
  static constexpr int LD = D + 8;  // bf16 elements per padded row
  static constexpr int K_BYTES = CS * LD * 2;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int WARP_BYTES = NST * STAGE;
  static constexpr int RING0 = (MAX_SPLIT + MAX_CHUNKS + 4) * 4;
  static constexpr int BYTES = RING0 + NWARPS * WARP_BYTES;
  static_assert(RING0 % 16 == 0 && (LD * 2) % 16 == 0, "16-byte copies");
  static_assert((MAXR * D + 2 * MAXR) * NWARPS * 4 <= NWARPS * WARP_BYTES,
                "join area");
};

}  // namespace sk

template <int D>
__global__ void __launch_bounds__(sk::NTHREADS)
flash_fwd_split_kernel(const uint16_t* __restrict__ q,
                       const uint16_t* __restrict__ k,
                       const uint16_t* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int T, int S, int H,
                       int KVH, int split, float scale_log2) {
  using namespace sk;
  using RG = Ring<D>;
  constexpr int KSTEPS = D / 16, DBLK = D / 8, LD = RG::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  int* pos_s = reinterpret_cast<int*>(smem);  // [MAX_SPLIT] remapped
  int* chunk_s = pos_s + MAX_SPLIT;           // live chunks, in order
  int* nlive_s = chunk_s + MAX_CHUNKS;

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH, R = G * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int start = sp * split;
  const int n_slots = min(split, S - start);  // > 0: n_split = ceil(S/split)
  const int nch = (n_slots + CS - 1) / CS;
  const size_t part = ((size_t)b * KVH + kvh) * gridDim.x + sp;

  int qmax = INT_MIN;  // the row's last query position
  for (int t = 0; t < T; ++t) qmax = max(qmax, q_pos[(size_t)b * T + t]);
  const int* kvrow = kv_pos + (size_t)b * S + start;
  for (int i = tid; i < nch * CS; i += NTHREADS) {
    pos_s[i] = i < n_slots ? remap_pos(kvrow[i]) : INT_MAX;
  }
  __syncthreads();
  if (warp == 0) {
    bool live = false;
    if (lane < nch) {
#pragma unroll
      for (int j = 0; j < CS; ++j) live |= pos_s[lane * CS + j] <= qmax;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) chunk_s[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) *nlive_s = __popc(mask);
  }
  __syncthreads();
  const int n_live = *nlive_s;
  if (n_live == 0) {
    // No slot of the run is live for any row: no K/V traffic, and the
    // combine pass skips the run by its max.
    if (tid < R) {
      m_part[part * R + tid] = -INFINITY;
      l_part[part * R + tid] = 0.f;
    }
    return;
  }

  // From here each warp runs alone over the live chunks warp, warp + 4, ..
  const size_t row_stride = (size_t)KVH * D;  // elements from slot to slot
  const uint16_t* kplane = k + ((size_t)b * S * KVH + kvh) * D;
  const uint16_t* vplane = v + ((size_t)b * S * KVH + kvh) * D;
  unsigned char* ring = smem + RG::RING0 + warp * RG::WARP_BYTES;
  const int n_mine = n_live > warp ? (n_live - warp + NWARPS - 1) / NWARPS : 0;
  // Start the copies of live chunk i of this warp into `stage`: 16-byte
  // pieces; a slot past the run (or the cache) is zero-filled, not read.
  auto copy_chunk = [&](unsigned char* stage, int i) {
    constexpr int CH = D / 8;  // copies per row
    const int c0 = chunk_s[warp + NWARPS * i] * CS;
#pragma unroll
    for (int x = lane; x < CS * CH; x += 32) {
      const int j = x / CH, col = (x % CH) * 8;
      const bool in = c0 + j < n_slots;
      const size_t off = (size_t)(start + (in ? c0 + j : 0)) * row_stride + col;
      cp_async16(stage + (j * LD + col) * 2, kplane + off, in ? 16 : 0);
      cp_async16(stage + RG::K_BYTES + (j * LD + col) * 2, vplane + off,
                 in ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < NST; ++s) {
    if (s < n_mine) copy_chunk(ring + s * RG::STAGE, s);
    cp_async_commit();
  }

  // This thread's packed rows grp and grp + 8 (a row past R attends
  // nothing) and their A fragments.
  int qp[2];
  uint32_t qa[KSTEPS][4];
  {
    const uint16_t* qrow[2];
    bool valid[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = grp + 8 * i;
      valid[i] = r < R;
      const int t = valid[i] ? r % T : 0, g = valid[i] ? r / T : 0;
      qp[i] = valid[i] ? q_pos[(size_t)b * T + t] : -1;
      qrow[i] = q + ((size_t)(b * T + t) * H + kvh * G + g) * D;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = kk * 16 + tig * 2;
      qa[kk][0] = valid[0] ? ld32(qrow[0] + c) : 0u;
      qa[kk][1] = valid[1] ? ld32(qrow[1] + c) : 0u;
      qa[kk][2] = valid[0] ? ld32(qrow[0] + c + 8) : 0u;
      qa[kk][3] = valid[1] ? ld32(qrow[1] + c + 8) : 0u;
    }
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial row sums over this lane's slots
  float o[DBLK][4];
#pragma unroll
  for (int nb = 0; nb < DBLK; ++nb) {
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  }

  for (int i = 0; i < n_mine; ++i) {
    unsigned char* stage = ring + (i % NST) * RG::STAGE;
    const uint16_t* kt = reinterpret_cast<const uint16_t*>(stage);
    const uint16_t* vt = reinterpret_cast<const uint16_t*>(stage + RG::K_BYTES);
    const int* kp = pos_s + chunk_s[warp + NWARPS * i] * CS;
    cp_async_wait<NST - 1>();
    __syncwarp();  // the chunk's copies, by every lane, have landed

    // S = Q K^T: 16 rows x 16 slots, two n-blocks of 8 slots.
    float sc[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const uint16_t* kr = kt + (nb * 8 + grp) * LD + kk * 16 + tig * 2;
        mma_bf16(sc[nb], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // Base-2 scores, the positional mask, the online softmax.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = kp[nb * 8 + tig * 2 + (e & 1)] <= qp[e >> 1]
                            ? sc[nb][e] * scale_log2
                            : -INFINITY;
        sc[nb][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int nb = 0; nb < DBLK; ++nb) {
        o[nb][2 * r] *= alpha;
        o[nb][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nb][e] - m_use[e >> 1]);
        l[e >> 1] += p;
        sc[nb][e] = p;
      }
    }

    // O += P V: P (rounded to bf16) is the A fragment of one k-step.
    uint32_t a[4];
    acc_to_a(a, sc[0], sc[1]);
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      const int col = nb * 8 + grp;
      const uint32_t b0 =
          pack_raw(vt[(2 * tig) * LD + col], vt[(2 * tig + 1) * LD + col]);
      const uint32_t b1 = pack_raw(vt[(2 * tig + 8) * LD + col],
                                   vt[(2 * tig + 9) * LD + col]);
      mma_bf16(o[nb], a, b0, b1);
    }
    __syncwarp();  // every lane has read the stage: refill it
    if (i + NST < n_mine) copy_chunk(stage, i + NST);
    cp_async_commit();
  }

  // Join the warps: (o, m, l) per warp into shared memory over the rings,
  // then the run's partial, summed over the warps in order.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* jo = reinterpret_cast<float*>(smem + RG::RING0);  // [4][MAXR][D]
  float* jm = jo + NWARPS * MAXR * D;                      // [4][MAXR]
  float* jl = jm + NWARPS * MAXR;                          // [4][MAXR]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = grp + 8 * i;
    if (r >= R) continue;
    float* orow = jo + (warp * MAXR + r) * D;
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      *reinterpret_cast<float2*>(orow + nb * 8 + tig * 2) =
          make_float2(o[nb][2 * i], o[nb][2 * i + 1]);
    }
    if (tig == 0) {
      jm[warp * MAXR + r] = m[i];
      jl[warp * MAXR + r] = l[i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, jm[w * MAXR + r]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = jm[w * MAXR + r];  // -inf: nothing live in the warp
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - M);
      acc += wt * jo[(w * MAXR + r) * D + c];
      lsum += wt * jl[w * MAXR + r];
    }
    o_part[(part * R + r) * D + c] = acc;
    if (c == 0) {
      m_part[part * R + r] = M;
      l_part[part * R + r] = lsum;
    }
  }
}

// One block per (KV head, batch): the runs' partials merged by their max
// (a run whose max is -inf holds nothing and is not read), out in bf16 and
// lse in natural log; a row with no live slot gets out 0 and lse +inf.
template <int D>
__global__ void __launch_bounds__(sk::NTHREADS)
flash_fwd_combine_kernel(const float* __restrict__ o_part,
                         const float* __restrict__ m_part,
                         const float* __restrict__ l_part,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int T, int H, int KVH,
                         int n_split) {
  using namespace sk;
  __shared__ float M_s[MAXR], L_s[MAXR];
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = H / KVH, R = G * T;
  const size_t part0 = ((size_t)b * KVH + kvh) * n_split;
  if (tid < R) {
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) {
      M = fmaxf(M, m_part[(part0 + s) * R + tid]);
    }
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ms = m_part[(part0 + s) * R + tid];
      if (ms != -INFINITY) L += l_part[(part0 + s) * R + tid] * exp2f(ms - M);
    }
    M_s[tid] = M;
    L_s[tid] = L;
    if (lse != nullptr) {
      lse[((size_t)b * KVH + kvh) * R + tid] =
          L > 0.f ? (M + log2f(L)) * LN2 : INFINITY;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const float M = M_s[r], L = L_s[r];
    float acc = 0.f;
    if (L > 0.f) {
      for (int s = 0; s < n_split; ++s) {
        const float ms = m_part[(part0 + s) * R + r];
        if (ms == -INFINITY) continue;
        acc += exp2f(ms - M) * o_part[((part0 + s) * R + r) * D + c];
      }
    }
    const int g = r / T, t = r % T;
    out[((size_t)(b * T + t) * H + kvh * G + g) * D + c] =
        __float2bfloat16_rn(L > 0.f ? acc / L : 0.f);
  }
}

// Both passes; partials: float32 scratch of B*KVH*n_split*R*(D+2) values
// (o, then the maxes, then the sums).  *kernels counts the passes that
// launched.
template <int D>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         float* lse, float* partials, int B, int T, int S,
                         int H, int KVH, int split, int n_split,
                         float scale_log2, cudaStream_t st, int* kernels) {
  constexpr int bytes = sk::Ring<D>::BYTES;
  auto kernel = flash_fwd_split_kernel<D>;
  static int opted_device = -1;  // dynamic shared memory above 48 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != opted_device) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_device = dev;
  }
  const size_t rows = (size_t)B * KVH * n_split * (H / KVH) * T;
  float* m_part = partials + rows * D;
  float* l_part = m_part + rows;
  kernel<<<dim3(n_split, KVH, B), sk::NTHREADS, bytes, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), q_pos, kv_pos, partials, m_part,
      l_part, T, S, H, KVH, split, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *kernels = 1;
  flash_fwd_combine_kernel<D><<<dim3(KVH, B), sk::NTHREADS, 0, st>>>(
      partials, m_part, l_part, static_cast<__nv_bfloat16*>(out), lse, T, H,
      KVH, n_split);
  err = cudaGetLastError();
  if (err == cudaSuccess) *kernels = 2;
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse: NULL, or float32 [B, KVH, G*T].
// with_drop != 0 applies dropout with the given seed words, threshold and
// 1 / (1 - rate); the bf16 path then needs lse.  Launches the mma.sync
// (bf16) or float32 instance on `stream` and does not synchronise.
// Returns the cudaError_t of the launch (0 on success); *instance is the
// instance launched (1 float32, 2 mma_sync), 0 if none.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         float* lse, int B, int T, int S, int H, int KVH, int D,
                         int dtype, float scale_log2, int with_drop,
                         unsigned int seed_lo, unsigned int seed_hi,
                         unsigned int threshold, float inv_keep,
                         unsigned int b_off, unsigned int h_off,
                         void* stream, int* instance) {
  *instance = 0;
  if (B <= 0 || T <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || B > 65535 ||
      KVH > 65535 || (with_drop && lse == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long R = (long)(H / KVH) * T;
  const Dropout drop{seed_lo, seed_hi, threshold, inv_keep, b_off,
                     h_off};
  int code = 0;
  if (dtype == 1) {
    dim3 grid((unsigned)((R + BM - 1) / BM), KVH, B);
    if (D == 128) {
      dispatch_bf16<128>(grid, st, q, k, v, q_pos, kv_pos, out, lse, T, S, H,
                         KVH, scale_log2, with_drop != 0, drop);
    } else if (D == 64) {
      dispatch_bf16<64>(grid, st, q, k, v, q_pos, kv_pos, out, lse, T, S, H,
                        KVH, scale_log2, with_drop != 0, drop);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    code = INST_MMA_SYNC;
  } else if (dtype == 0) {
    dim3 grid((unsigned)((R + F32_ROWS - 1) / F32_ROWS), KVH, B);
    const float* qq = static_cast<const float*>(q);
    const float* kk = static_cast<const float*>(k);
    const float* vv = static_cast<const float*>(v);
    float* oo = static_cast<float*>(out);
    if (D == 128) {
      flash_fwd_f32_kernel<4, false><<<grid, F32_ROWS * 32, 0, st>>>(
          qq, kk, vv, nullptr, nullptr, q_pos, kv_pos, oo, lse, T, S, H, KVH,
          scale_log2, with_drop != 0, drop);
    } else if (D == 64) {
      flash_fwd_f32_kernel<2, false><<<grid, F32_ROWS * 32, 0, st>>>(
          qq, kk, vv, nullptr, nullptr, q_pos, kv_pos, oo, lse, T, S, H, KVH,
          scale_log2, with_drop != 0, drop);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    code = INST_FLOAT32;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *instance = code;
  return (int)err;
}

// The split-KV instance at `split` slots a run (a multiple of 16, at most
// 512), for the sweep that chose SPLIT; arguments as flash_fwd's, plus
// partials (float32 scratch of B*KVH*n_split*G*T*(d+2) values) and
// n_split = ceil(S / split).  Takes bf16 at d = 64 or 128 with at most 16
// packed rows G*T and no dropout, and rejects any other call with
// cudaErrorInvalidValue (those run flash_fwd).  *instance is 4 once the
// split pass launched; *kernels counts the passes launched (2 on
// success).
extern "C" int flash_fwd_split_at(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* out, float* lse, float* partials, int B, int T,
    int S, int H, int KVH, int D, int dtype, int split, int n_split,
    float scale_log2, int with_drop, unsigned int seed_lo,
    unsigned int seed_hi, unsigned int threshold, float inv_keep,
    unsigned int b_off, unsigned int h_off,
    void* stream, int* instance, int* kernels) {
  (void)seed_lo, (void)seed_hi, (void)threshold, (void)inv_keep;
  (void)b_off, (void)h_off;
  *instance = 0;
  *kernels = 0;
  if (B <= 0 || T <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || B > 65535 ||
      KVH > 65535 || (long)(H / KVH) * T > sk::MAXR || dtype != 1 ||
      with_drop || partials == nullptr || split <= 0 ||
      split % sk::CS != 0 || split > sk::MAX_SPLIT ||
      n_split != (int)(((long)S + split - 1) / split)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128) {
    err = launch_split<128>(q, k, v, q_pos, kv_pos, out, lse, partials, B, T,
                            S, H, KVH, split, n_split, scale_log2, st,
                            kernels);
  } else if (D == 64) {
    err = launch_split<64>(q, k, v, q_pos, kv_pos, out, lse, partials, B, T,
                           S, H, KVH, split, n_split, scale_log2, st,
                           kernels);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (*kernels > 0) *instance = INST_SPLIT_KV;
  return (int)err;
}

// The split-KV instance as the wrapper launches it: runs of SPLIT slots,
// so n_split must be ceil(S / SPLIT) (a count computed from another value
// is rejected); otherwise flash_fwd_split_at's contract.
extern "C" int flash_fwd_split(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* out, float* lse, float* partials, int B, int T,
    int S, int H, int KVH, int D, int dtype, int n_split, float scale_log2,
    int with_drop, unsigned int seed_lo, unsigned int seed_hi,
    unsigned int threshold, float inv_keep,
    unsigned int b_off, unsigned int h_off, void* stream, int* instance,
    int* kernels) {
  return flash_fwd_split_at(q, k, v, q_pos, kv_pos, out, lse, partials, B, T,
                            S, H, KVH, D, dtype, sk::SPLIT, n_split,
                            scale_log2, with_drop, seed_lo, seed_hi,
                            threshold, inv_keep,
                            b_off, h_off, stream, instance, kernels);
}

// The int8-KV forward: q and out [B, T, H, d] (dtype 0 = float32, 1 =
// bfloat16), k and v int8 [B, S, KVH, d], k_scale and v_scale float32
// [B, S, KVH], positions as flash_fwd's.  No lse, no dropout.  Launches
// the mma.sync (bf16) or float32 instance on `stream` and does not
// synchronise.  Returns the cudaError_t of the launch (0 on success);
// *instance is the instance launched (1 float32, 2 mma_sync), 0 if none.
extern "C" int flash_fwd_int8(const void* q, const void* k, const void* v,
                              const float* k_scale, const float* v_scale,
                              const int* q_pos, const int* kv_pos, void* out,
                              int B, int T, int S, int H, int KVH, int D,
                              int dtype, float scale_log2, void* stream,
                              int* instance) {
  *instance = 0;
  if (B <= 0 || T <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || B > 65535 ||
      KVH > 65535 || k_scale == nullptr || v_scale == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long R = (long)(H / KVH) * T;
  const Dropout none{0u, 0u, 0u, 1.f};
  int code = 0;
  if (dtype == 1) {
    dim3 grid((unsigned)((R + BM - 1) / BM), KVH, B);
    if (D == 128) {
      launch_bf16<128, false, false, true>(grid, st, q, k, v, q_pos, kv_pos,
                                           out, nullptr, T, S, H, KVH,
                                           scale_log2, none, k_scale,
                                           v_scale);
    } else if (D == 64) {
      launch_bf16<64, false, false, true>(grid, st, q, k, v, q_pos, kv_pos,
                                          out, nullptr, T, S, H, KVH,
                                          scale_log2, none, k_scale, v_scale);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    code = INST_MMA_SYNC;
  } else if (dtype == 0) {
    dim3 grid((unsigned)((R + F32_ROWS - 1) / F32_ROWS), KVH, B);
    const float* qq = static_cast<const float*>(q);
    float* oo = static_cast<float*>(out);
    if (D == 128) {
      flash_fwd_f32_kernel<4, true><<<grid, F32_ROWS * 32, 0, st>>>(
          qq, k, v, k_scale, v_scale, q_pos, kv_pos, oo, nullptr, T, S, H,
          KVH, scale_log2, false, none);
    } else if (D == 64) {
      flash_fwd_f32_kernel<2, true><<<grid, F32_ROWS * 32, 0, st>>>(
          qq, k, v, k_scale, v_scale, q_pos, kv_pos, oo, nullptr, T, S, H,
          KVH, scale_log2, false, none);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    code = INST_FLOAT32;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *instance = code;
  return (int)err;
}

// The Hopper int8 instance (TMA landing ring, widened in shared memory,
// wgmma): bf16 q with D = 128 and T a multiple of 128; arguments as
// flash_fwd_int8's.  Encodes the tensor maps for this call.  Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for a
// shape it does not take or a map the encoder refuses; *instance is 3
// once it launched, 0 if not.
extern "C" int flash_fwd_int8_wgmma(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, const int* q_pos, const int* kv_pos, void* out,
    int B, int T, int S, int H, int KVH, int D, int dtype, float scale_log2,
    void* stream, int* instance) {
  *instance = 0;
  if (B <= 0 || T <= 0 || T % wg::BM != 0 || T / wg::BM > 65535 || S <= 0 ||
      KVH <= 0 || H % KVH != 0 || D != wg::D || dtype != 1 ||
      k_scale == nullptr || v_scale == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_bf16_4d(&tq, q, D, H, T, B, wg::BM) ||
      !hopper::encode_int8_4d(&tk, k, D, KVH, S, B, wg::LBN) ||
      !hopper::encode_int8_4d(&tv, v, D, KVH, S, B, wg::LBN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM8);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)(T / wg::BM));
  flash_fwd_int8_wgmma_kernel<<<grid, wg::NTHREADS8, wg::SMEM8,
                                static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, k_scale, v_scale, q_pos, kv_pos,
      static_cast<uint16_t*>(out), T, S, H, KVH, scale_log2);
  err = cudaGetLastError();
  if (err == cudaSuccess) *instance = INST_WGMMA;
  return (int)err;
}

// The Hopper instance (TMA + wgmma): bf16 q, k, v with D = 128 and T a
// multiple of 128; arguments as flash_fwd's.  Encodes the three tensor
// maps (they hold the base pointers) for this call.  Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for a
// shape it does not take or a tensor map the encoder refuses; *instance
// is 3 once it launched, 0 if not.
extern "C" int flash_fwd_wgmma(const void* q, const void* k, const void* v,
                               const int* q_pos, const int* kv_pos, void* out,
                               float* lse, int B, int T, int S, int H,
                               int KVH, int D, int dtype, float scale_log2,
                               int with_drop, unsigned int seed_lo,
                               unsigned int seed_hi, unsigned int threshold,
                               float inv_keep,
                               unsigned int b_off, unsigned int h_off,
                               void* stream, int* instance) {
  *instance = 0;
  if (B <= 0 || T <= 0 || T % wg::BM != 0 || T / wg::BM > 65535 || S <= 0 ||
      KVH <= 0 || H % KVH != 0 || D != wg::D || dtype != 1 ||
      (with_drop && lse == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_bf16_4d(&tq, q, D, H, T, B, wg::BM) ||
      !hopper::encode_bf16_4d(&tk, k, D, KVH, S, B, wg::BN) ||
      !hopper::encode_bf16_4d(&tv, v, D, KVH, S, B, wg::BN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed_lo, seed_hi, threshold, inv_keep, b_off,
                     h_off};
  int err;
  if (with_drop) {
    err = launch_wgmma<true, true>(tq, tk, tv, q_pos, kv_pos, out, lse, B, T,
                                   S, H, KVH, scale_log2, drop, st);
  } else if (lse != nullptr) {
    err = launch_wgmma<true, false>(tq, tk, tv, q_pos, kv_pos, out, lse, B,
                                    T, S, H, KVH, scale_log2, drop, st);
  } else {
    err = launch_wgmma<false, false>(tq, tk, tv, q_pos, kv_pos, out, lse, B,
                                     T, S, H, KVH, scale_log2, drop, st);
  }
  if (err == 0) *instance = INST_WGMMA;
  return err;
}

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
// What bounds it on an H100: memory.  At the main path's prefill shape
// (B = 4, T = S = 512, H = 32, KVH = 8, d = 128, causal with left
// padding) the call must move q, k, v and out once, about 40 MB, while
// the live (query, slot) pairs need only about 4 GFLOP of tensor-core
// work, so the least time is set by HBM bandwidth; at decode (T = 1 over
// a long cache) it is streaming K/V once per KV head.  Between the
// tiles, the exp/max/rescale work runs on the CUDA cores.  What the
// design does about it:
//   * bf16 products run on the tensor cores (mma.sync m16n8k16, fp32
//     accumulate); each warp owns 16 packed query rows and keeps its Q
//     fragments, scores and output accumulator in registers, so the score
//     tile never touches shared or device memory.
//   * GQA packing reads each K/V tile from HBM once per KV head and query
//     tile, instead of once per query head.
//   * Dead KV tiles are skipped: the block first finds the last slot that
//     any of its rows may attend (the per-q-tile bound of the JAX wrapper,
//     :794-803) and stops there; tiles below it with no live slot (left
//     padding) are skipped without loading K or V.
//   * The online softmax runs in base 2 (log2(e) folded into the scale),
//     in fp32; P is rounded to the input dtype for the P.V product, as in
//     the JAX kernel.
// Not done yet (later work): a cp.async or TMA pipeline that overlaps the
// next tile's loads with this tile's math (each block now waits on every
// K/V tile load, which is what keeps it well above the memory bound),
// wgmma, split-KV for decode.
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
// int8 tile to float32 and folds the same way.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

// Sixteen int8 values from 16 global bytes, as bf16 (exact), into 32
// bytes of shared memory.
__device__ __forceinline__ void store_int8_as_bf16(uint16_t* dst, uint4 x) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float b0 = static_cast<float>(static_cast<int8_t>(w[i]));
    const float b1 = static_cast<float>(static_cast<int8_t>(w[i] >> 8));
    const float b2 = static_cast<float>(static_cast<int8_t>(w[i] >> 16));
    const float b3 = static_cast<float>(static_cast<int8_t>(w[i] >> 24));
    out[2 * i] = pack_bf16x2(b0, b1);
    out[2 * i + 1] = pack_bf16x2(b2, b3);
  }
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  d4[0] = make_uint4(out[0], out[1], out[2], out[3]);
  d4[1] = make_uint4(out[4], out[5], out[6], out[7]);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse: NULL, or float32 [B, KVH, G*T].
// with_drop != 0 applies dropout with the given seed words, threshold and
// 1 / (1 - rate); the bf16 path then needs lse.  Returns the cudaError_t of
// the launch (0 on success).  Launches on `stream` and does not synchronise.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         float* lse, int B, int T, int S, int H, int KVH, int D,
                         int dtype, float scale_log2, int with_drop,
                         unsigned int seed_lo, unsigned int seed_hi,
                         unsigned int threshold, float inv_keep,
                         void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || B > 65535 ||
      KVH > 65535 || (with_drop && lse == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long R = (long)(H / KVH) * T;
  const Dropout drop{seed_lo, seed_hi, threshold, inv_keep};
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
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The int8-KV forward: q and out [B, T, H, d] (dtype 0 = float32, 1 =
// bfloat16), k and v int8 [B, S, KVH, d], k_scale and v_scale float32
// [B, S, KVH], positions as flash_fwd's.  No lse, no dropout.  Returns the
// cudaError_t of the launch (0 on success).  Launches on `stream` and does
// not synchronise.
extern "C" int flash_fwd_int8(const void* q, const void* k, const void* v,
                              const float* k_scale, const float* v_scale,
                              const int* q_pos, const int* kv_pos, void* out,
                              int B, int T, int S, int H, int KVH, int D,
                              int dtype, float scale_log2, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || B > 65535 ||
      KVH > 65535 || k_scale == nullptr || v_scale == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long R = (long)(H / KVH) * T;
  const Dropout none{0u, 0u, 0u, 1.f};
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
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

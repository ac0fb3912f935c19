// Flash-attention backward for Hopper (sm_90a), plain C entry points.
//
// Replaces the TPU kernels of `_flash_backward` in
// jax_llama_tpu/ops/flash_attention.py (:1178; pallas_calls at :1271 and
// :1301): `_flash_dq_kernel` (:926) and `_flash_dkv_kernel` (:1044).  With
// S = Q K^T * scale, P = exp(S - lse) on the attended slots (0 elsewhere),
// dP = dO V^T, the dropout keep mask D scaled by 1 / (1 - rate) (all ones
// without dropout), Delta = rowsum(dO * O) (computed by the caller):
//
//   dS = P * (D * dP - Delta) * scale
//   dQ = dS K                    (kernel flash_bwd_dq)
//   dV = (D * P)^T dO,  dK = dS^T Q   (kernel flash_bwd_dkv)
//
// GQA is packed as in the forward: packed row r = g*T + t of KV head kvh
// is query head kvh*G + g at token t, by address arithmetic.  dK/dV of a
// KV head sum over all G*T packed rows of its group in one block's sweep,
// so no atomics are needed.  Padding rows and rows that see no live slot
// (lse = +inf) contribute nothing.  The dropout bits are those of the
// forward (flash_common.cuh), hashed from the global (packed row, slot).
//
// Layout: q, dO and dq [B, T, H, d]; k, v, dk and dv [B, S, KVH, d]; lse
// and Delta float32 [B, KVH, G*T]; q_pos [B, T], kv_pos [B, S] int32.
//
// What bounds them on an H100: operations.  At the training shape (B = 4,
// T = S = 2048, H = 32, KVH = 8, d = 128, causal) the two kernels need
// about 14*d FLOP per live (row, slot) pair: 6*d in dQ (S, dP, dQ) and
// 8*d in dK/dV (S, dP, dV, dK), ~0.5 TFLOP in all, against ~0.2 GB of
// inputs and outputs.  What the design does about it:
//   * bf16 products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulate).  Each warp owns 16 rows (dQ: packed query rows; dK/dV:
//     KV slots) and keeps its accumulators and score tiles in registers;
//     the score accumulators of one product are fed back as the A operand
//     of the next (P -> dV, dS -> dQ and dK), rounded to bf16 as the JAX
//     kernels round them.
//   * The four operand tiles of a block (Q, dO, K, V: 64 rows each) live in
//     padded shared memory (70 KB at d = 128, dynamic).
//   * Whole tiles with no attended pair are skipped before their loads:
//     dQ stops at the last KV tile any of its rows may attend and skips
//     dead tiles below it; dK/dV skips row tiles whose largest position is
//     below the block's smallest slot position, and writes zeros at once
//     for a tile of dead slots.
// Not done yet (later work): wgmma, a cp.async/TMA double buffer, the
// ragged diagonal bodies of the JAX kernels.
//
// The float32 paths are plain CUDA-core kernels (one warp per packed row
// or per slot) for callers that train in float32 and for the gradient
// checks; the main path is bf16.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_bytes() {
  return 4 * BN * (D + 8) * 2;  // four padded bf16 tiles of 64 rows
}

// Copy rows [row0, row0 + 64) of the packed plane (kv head kvh) of a
// [B, T, H, D] tensor into a padded shared tile; rows past R are zeros.
template <int D>
__device__ __forceinline__ void load_rows(uint16_t* tile, const uint16_t* src,
                                          int b, int kvh, int row0, int R,
                                          int T, int H, int G) {
  constexpr int LD = D + 8;
  for (int c = threadIdx.x; c < BM * (D / 8); c += NTHREADS) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const int r = row0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < R) {
      const int t = r % T, h = kvh * G + r / T;
      val = *reinterpret_cast<const uint4*>(
          src + ((size_t)(b * T + t) * H + h) * D + col);
    }
    *reinterpret_cast<uint4*>(&tile[row * LD + col]) = val;
  }
}

// Copy slots [s0, s0 + 64) of kv head kvh of a [B, S, KVH, D] tensor into a
// padded shared tile; slots past S are zeros.
template <int D>
__device__ __forceinline__ void load_slots(uint16_t* tile, const uint16_t* src,
                                           int b, int kvh, int s0, int S,
                                           int KVH) {
  constexpr int LD = D + 8;
  for (int c = threadIdx.x; c < BN * (D / 8); c += NTHREADS) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const int s = s0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S) {
      val = *reinterpret_cast<const uint4*>(
          src + ((size_t)(b * S + s) * KVH + kvh) * D + col);
    }
    *reinterpret_cast<uint4*>(&tile[row * LD + col]) = val;
  }
}

// acc[16 x 8*NB] = A-rows [ra, ra+16) of `a` times rows [rb0, rb0 + 8*NB)
// of `bt`, both row-major [rows][D] tiles with stride D + 8: A B^T over
// the feature axis (S = Q K^T, dP = dO V^T, and their transposes).
template <int D, int NB>
__device__ __forceinline__ void rows_dot(float (&acc)[NB][4],
                                         const uint16_t* a, int ra,
                                         const uint16_t* bt, int rb0) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a(af, a, LD, ra, kk * 16);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint16_t* br = &bt[(rb0 + nb * 8 + grp) * LD + kk * 16 + tig * 2];
      mma_bf16(acc[nb], af, ld32(br), ld32(br + 8));
    }
  }
}

// out[16 x D] += A[16 x 8*NB] (score accumulators, n-blocks 2j and 2j+1
// forming k-step j) times rows [rk0, rk0 + 8*NB) of the row-major tile
// `bt` (the k axis is the tile's row axis): P V, dS K, P^T dO, dS^T Q.
template <int D, int NB>
__device__ __forceinline__ void acc_times_rows(float (&out)[D / 8][4],
                                               const float (&c)[NB][4],
                                               const uint16_t* bt, int rk0) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    uint32_t a[4];
    acc_to_a(a, c[2 * j], c[2 * j + 1]);
    const int r0 = rk0 + j * 16 + tig * 2;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int col = nb * 8 + grp;
      const uint32_t b0 = pack_raw(bt[r0 * LD + col], bt[(r0 + 1) * LD + col]);
      const uint32_t b1 =
          pack_raw(bt[(r0 + 8) * LD + col], bt[(r0 + 9) * LD + col]);
      mma_bf16(out[nb], a, b0, b1);
    }
  }
}

// dQ: one block per (b, KV head, 64 packed rows), sweeping the 64-slot KV
// tiles up to the block's bound.
template <int D, bool DROP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ g,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ kv_pos,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, int T, int S, int H,
                         int KVH, float scale, Dropout drop) {
  constexpr int LD = D + 8;
  constexpr int NBLK = BN / 8;
  constexpr int DBLK = D / 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* gs = qs + BM * LD;
  uint16_t* ks = gs + BM * LD;
  uint16_t* vs = ks + BN * LD;
  __shared__ int kps[BN];
  __shared__ int qmax_s, last_s;

  const int G = H / KVH;
  const int R = G * T;
  const int b = blockIdx.z, kvh = blockIdx.y, row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const float scale_log2 = scale * LOG2E;

  const int n_tiles = kv_tile_bound(q_pos, kv_pos, b, T, S, R, row0, BM, BN,
                                    &qmax_s, &last_s);
  const int qmax = qmax_s;
  load_rows<D>(qs, q, b, kvh, row0, R, T, H, G);
  load_rows<D>(gs, g, b, kvh, row0, R, T, H, G);

  int qp[2];
  float lse2[2], dlt[2];
  uint32_t base_lo = 0, base_hi = 0, rw[2] = {0u, 0u};
  if constexpr (DROP) drop_bases(drop, b, kvh, base_lo, base_hi);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + grp + 8 * i;
    const bool valid = r < R;
    const size_t lrow = ((size_t)b * KVH + kvh) * R + r;
    qp[i] = valid ? q_pos[b * T + r % T] : -1;  // -1: attends nothing
    lse2[i] = valid ? lse[lrow] * LOG2E : INFINITY;
    dlt[i] = valid ? delta[lrow] : 0.f;
    if constexpr (DROP) rw[i] = row_word(base_lo, r);
  }

  float acc[DBLK][4];
#pragma unroll
  for (int nb = 0; nb < DBLK; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
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
    load_slots<D>(ks, k, b, kvh, s0, S, KVH);
    load_slots<D>(vs, v, b, kvh, s0, S, KVH);
    __syncthreads();

    float sc[NBLK][4], dp[NBLK][4];
    rows_dot<D, NBLK>(sc, qs, warp * 16, ks, 0);
    rows_dot<D, NBLK>(dp, gs, warp * 16, vs, 0);
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
      uint32_t cw[2] = {0u, 0u};
      if constexpr (DROP) {
        cw[0] = col_word(base_hi, s0 + nb * 8 + tig * 2);
        cw[1] = col_word(base_hi, s0 + nb * 8 + tig * 2 + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kp = kps[nb * 8 + tig * 2 + (e & 1)];
        const float p =
            kp <= qp[i] ? exp2f(sc[nb][e] * scale_log2 - lse2[i]) : 0.f;
        float d = dp[nb][e];
        if constexpr (DROP) {
          d = keep(rw[i], cw[e & 1], drop.threshold) ? d * drop.inv : 0.f;
        }
        sc[nb][e] = p * (d - dlt[i]) * scale;  // dS
      }
    }
    acc_times_rows<D, NBLK>(acc, sc, ks, 0);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + grp + 8 * i;
    if (r >= R) continue;
    const int t = r % T, h = kvh * G + r / T;
    uint16_t* out = dq + ((size_t)(b * T + t) * H + h) * D;
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      *reinterpret_cast<uint32_t*>(out + nb * 8 + tig * 2) =
          pack_bf16x2(acc[nb][2 * i], acc[nb][2 * i + 1]);
    }
  }
}

// dK/dV: one block per (b, KV head, 64 slots), sweeping all G*T packed
// rows of the group in tiles of 64, each tile in two halves of 32 rows to
// keep the transposed score tiles small.
template <int D, bool DROP>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const uint16_t* __restrict__ g,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int T, int S, int H, int KVH, float scale,
                          Dropout drop) {
  constexpr int LD = D + 8;
  constexpr int DBLK = D / 8;
  constexpr int HALF = BM / 2;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* gs = qs + BM * LD;
  uint16_t* ks = gs + BM * LD;
  uint16_t* vs = ks + BN * LD;
  __shared__ int kps[BN];
  __shared__ int qps[BM];
  __shared__ float lse2s[BM], dlts[BM];
  __shared__ int kmin_s;

  const int G = H / KVH;
  const int R = G * T;
  const int b = blockIdx.z, kvh = blockIdx.y, s0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const float scale_log2 = scale * LOG2E;

  if (tid == 0) kmin_s = INT_MAX;
  __syncthreads();
  if (tid < BN) {
    const int s = s0 + tid;
    const int kp = s < S ? remap_pos(kv_pos[(size_t)b * S + s]) : INT_MAX;
    kps[tid] = kp;
    atomicMin(&kmin_s, kp);
  }
  load_slots<D>(ks, k, b, kvh, s0, S, KVH);
  load_slots<D>(vs, v, b, kvh, s0, S, KVH);
  __syncthreads();
  const int kmin = kmin_s;

  uint32_t base_lo = 0, base_hi = 0, cw[2] = {0u, 0u};
  if constexpr (DROP) {
    drop_bases(drop, b, kvh, base_lo, base_hi);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cw[i] = col_word(base_hi, s0 + warp * 16 + grp + 8 * i);
    }
  }
  int kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kp[i] = kps[warp * 16 + grp + 8 * i];

  float dka[DBLK][4], dva[DBLK][4];
#pragma unroll
  for (int nb = 0; nb < DBLK; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nb][e] = dva[nb][e] = 0.f;
  }

  const int n_row_tiles = kmin == INT_MAX ? 0 : (R + BM - 1) / BM;
  for (int rt = 0; rt < n_row_tiles; ++rt) {
    const int r0 = rt * BM;
    __syncthreads();  // the previous tile's shared reads are done
    bool live = false;
    if (tid < BM) {
      const int r = r0 + tid;
      const bool valid = r < R;
      const size_t lrow = ((size_t)b * KVH + kvh) * R + r;
      const int qp = valid ? q_pos[b * T + r % T] : -1;
      qps[tid] = qp;
      lse2s[tid] = valid ? lse[lrow] * LOG2E : INFINITY;
      dlts[tid] = valid ? delta[lrow] : 0.f;
      live = qp >= kmin;
    }
    if (!__syncthreads_or(live)) continue;  // no row here sees these slots
    load_rows<D>(qs, q, b, kvh, r0, R, T, H, G);
    load_rows<D>(gs, g, b, kvh, r0, R, T, H, G);
    __syncthreads();

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int rb = half * HALF;
      // S^T and dP^T for this warp's 16 slots x 32 rows.
      constexpr int HB = HALF / 8;
      float st[HB][4], dpt[HB][4];
      rows_dot<D, HB>(st, ks, warp * 16, qs, rb);
      rows_dot<D, HB>(dpt, vs, warp * 16, gs, rb);
#pragma unroll
      for (int nb = 0; nb < HB; ++nb) {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int row = rb + nb * 8 + tig * 2 + c2;
          const int qp = qps[row];
          const float l2 = lse2s[row], dl = dlts[row];
          uint32_t rw = 0;
          if constexpr (DROP) rw = row_word(base_lo, r0 + row);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + c2;
            const float p =
                kp[i] <= qp ? exp2f(st[nb][e] * scale_log2 - l2) : 0.f;
            float pv = p, d = dpt[nb][e];
            if constexpr (DROP) {
              const bool kept = keep(rw, cw[i], drop.threshold);
              pv = kept ? p * drop.inv : 0.f;
              d = kept ? d * drop.inv : 0.f;
            }
            st[nb][e] = pv;                     // (D * P)^T
            dpt[nb][e] = p * (d - dl) * scale;  // dS^T
          }
        }
      }
      acc_times_rows<D, HB>(dva, st, gs, rb);
      acc_times_rows<D, HB>(dka, dpt, qs, rb);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + warp * 16 + grp + 8 * i;
    if (s >= S) continue;
    const size_t o = ((size_t)(b * S + s) * KVH + kvh) * D;
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      *reinterpret_cast<uint32_t*>(dk + o + nb * 8 + tig * 2) =
          pack_bf16x2(dka[nb][2 * i], dka[nb][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + o + nb * 8 + tig * 2) =
          pack_bf16x2(dva[nb][2 * i], dva[nb][2 * i + 1]);
    }
  }
}

// float32: dQ with one warp per packed row (8 rows a block), lane j owning
// features j, j+32, ...; K/V tiles of 32 slots in shared memory.
constexpr int F32_ROWS = 8;
constexpr int F32_BN = 32;

template <int DPL>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ kv_pos,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int T, int S, int H, int KVH,
                        float scale, bool with_drop, Dropout drop) {
  constexpr int D = 32 * DPL;
  __shared__ float ks[F32_BN * D];
  __shared__ float vs[F32_BN * D];
  __shared__ int kps[F32_BN];
  __shared__ int qmax_s, last_s;

  const int G = H / KVH;
  const int R = G * T;
  const int b = blockIdx.z, kvh = blockIdx.y, row0 = blockIdx.x * F32_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float scale_log2 = scale * LOG2E;

  const int n_tiles = kv_tile_bound(q_pos, kv_pos, b, T, S, R, row0,
                                    F32_ROWS, F32_BN, &qmax_s, &last_s);
  const int qmax = qmax_s;

  const int r = row0 + warp;
  const bool valid = r < R;
  const int t = valid ? r % T : 0;
  const int h = kvh * G + (valid ? r / T : 0);
  const int qp = valid ? q_pos[b * T + t] : -1;
  const size_t orow = ((size_t)(b * T + t) * H + h) * D;
  const size_t lrow = ((size_t)b * KVH + kvh) * R + r;
  const float l2 = valid ? lse[lrow] * LOG2E : INFINITY;
  const float dl = valid ? delta[lrow] : 0.f;
  float qv[DPL], gv[DPL], acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qv[i] = valid ? q[orow + lane + 32 * i] : 0.f;
    gv[i] = valid ? g[orow + lane + 32 * i] : 0.f;
    acc[i] = 0.f;
  }
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
      const size_t gi = ((size_t)(b * S + s) * KVH + kvh) * D + col;
      ks[c] = s < S ? k[gi] : 0.f;
      vs[c] = s < S ? v[gi] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < F32_BN; ++j) {
      if (kps[j] > qp) continue;  // uniform across the warp
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        sd += qv[i] * ks[j * D + lane + 32 * i];
        pd += gv[i] * vs[j * D + lane + 32 * i];
      }
      const float p = exp2f(warp_sum(sd) * scale_log2 - l2);
      float d = warp_sum(pd);
      if (with_drop) {
        d = keep(rw, col_word(base_hi, s0 + j), drop.threshold)
                ? d * drop.inv : 0.f;
      }
      const float ds = p * (d - dl) * scale;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += ds * ks[j * D + lane + 32 * i];
    }
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) dq[orow + lane + 32 * i] = acc[i];
  }
}

// float32 dK/dV: one warp per slot (8 slots a block), sweeping the group's
// packed rows in tiles of 32 (Q and dO rows in shared memory).
template <int DPL>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ kv_pos,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int T, int S, int H, int KVH, float scale,
                         bool with_drop, Dropout drop) {
  constexpr int D = 32 * DPL;
  constexpr int RT = 32;  // rows per tile
  __shared__ float qs[RT * D];
  __shared__ float gs[RT * D];
  __shared__ int qps[RT];
  __shared__ float lse2s[RT], dlts[RT];
  __shared__ int kmin_s;

  const int G = H / KVH;
  const int R = G * T;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = blockIdx.x * F32_ROWS + warp;
  const bool valid = s < S;
  const float scale_log2 = scale * LOG2E;

  const int kp = valid ? remap_pos(kv_pos[(size_t)b * S + s]) : INT_MAX;
  if (tid == 0) kmin_s = INT_MAX;
  __syncthreads();
  if (lane == 0) atomicMin(&kmin_s, kp);
  const size_t srow = ((size_t)(b * S + (valid ? s : 0)) * KVH + kvh) * D;
  float kv[DPL], vv[DPL], dka[DPL], dva[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    kv[i] = valid ? k[srow + lane + 32 * i] : 0.f;
    vv[i] = valid ? v[srow + lane + 32 * i] : 0.f;
    dka[i] = dva[i] = 0.f;
  }
  uint32_t base_lo = 0, base_hi = 0, cw = 0;
  if (with_drop) {
    drop_bases(drop, b, kvh, base_lo, base_hi);
    cw = col_word(base_hi, s);
  }
  __syncthreads();
  const int kmin = kmin_s;

  const int n_row_tiles = kmin == INT_MAX ? 0 : (R + RT - 1) / RT;
  for (int rt = 0; rt < n_row_tiles; ++rt) {
    const int r0 = rt * RT;
    __syncthreads();
    bool live = false;
    if (tid < RT) {
      const int r = r0 + tid;
      const bool rv = r < R;
      const size_t lrow = ((size_t)b * KVH + kvh) * R + r;
      const int qp = rv ? q_pos[b * T + r % T] : -1;
      qps[tid] = qp;
      lse2s[tid] = rv ? lse[lrow] * LOG2E : INFINITY;
      dlts[tid] = rv ? delta[lrow] : 0.f;
      live = qp >= kmin;
    }
    if (!__syncthreads_or(live)) continue;
    for (int c = tid; c < RT * D; c += blockDim.x) {
      const int row = c / D, col = c % D;
      const int r = r0 + row;
      float qv = 0.f, gv = 0.f;
      if (r < R) {
        const int t = r % T, h = kvh * G + r / T;
        const size_t gi = ((size_t)(b * T + t) * H + h) * D + col;
        qv = q[gi];
        gv = g[gi];
      }
      qs[c] = qv;
      gs[c] = gv;
    }
    __syncthreads();
    for (int j = 0; j < RT; ++j) {
      if (kp > qps[j]) continue;  // uniform across the warp
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        sd += kv[i] * qs[j * D + lane + 32 * i];
        pd += vv[i] * gs[j * D + lane + 32 * i];
      }
      const float p = exp2f(warp_sum(sd) * scale_log2 - lse2s[j]);
      float d = warp_sum(pd), pv = p;
      if (with_drop) {
        const bool kept =
            keep(row_word(base_lo, r0 + j), cw, drop.threshold);
        pv = kept ? p * drop.inv : 0.f;
        d = kept ? d * drop.inv : 0.f;
      }
      const float ds = p * (d - dlts[j]) * scale;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        dva[i] += pv * gs[j * D + lane + 32 * i];
        dka[i] += ds * qs[j * D + lane + 32 * i];
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      dk[srow + lane + 32 * i] = dka[i];
      dv[srow + lane + 32 * i] = dva[i];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D, bool DROP>
cudaError_t launch_dq_bf16(dim3 grid, cudaStream_t st, const void* q,
                           const void* k, const void* v, const void* g,
                           const int* q_pos, const int* kv_pos,
                           const float* lse, const float* delta, void* dq,
                           int T, int S, int H, int KVH, float scale,
                           Dropout drop) {
  auto kernel = flash_bwd_dq_bf16_kernel<D, DROP>;
  cudaError_t err = allow_smem(kernel, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem_bytes<D>(), st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(g), q_pos,
      kv_pos, lse, delta, static_cast<uint16_t*>(dq), T, S, H, KVH, scale,
      drop);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv_bf16(dim3 grid, cudaStream_t st, const void* q,
                            const void* k, const void* v, const void* g,
                            const int* q_pos, const int* kv_pos,
                            const float* lse, const float* delta, void* dk,
                            void* dv, int T, int S, int H, int KVH,
                            float scale, Dropout drop) {
  auto kernel = flash_bwd_dkv_bf16_kernel<D, DROP>;
  cudaError_t err = allow_smem(kernel, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem_bytes<D>(), st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(g), q_pos,
      kv_pos, lse, delta, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), T, S, H, KVH, scale, drop);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int S, int H, int KVH) {
  return B <= 0 || T <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 ||
         B > 65535 || KVH > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D is 64 or 128.  `scale` is
// 1 / sqrt(d).  with_drop != 0 rebuilds the forward's dropout mask from
// the seed words, threshold and 1 / (1 - rate).  Each returns the
// cudaError_t of its launch (0 on success), launches on `stream` and does
// not synchronise.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* g, const int* q_pos,
                            const int* kv_pos, const float* lse,
                            const float* delta, void* dq, int B, int T, int S,
                            int H, int KVH, int D, int dtype, float scale,
                            int with_drop, unsigned int seed_lo,
                            unsigned int seed_hi, unsigned int threshold,
                            float inv_keep, void* stream) {
  if (bad_shape(B, T, S, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long R = (long)(H / KVH) * T;
  const Dropout drop{seed_lo, seed_hi, threshold, inv_keep};
  if (dtype == 1) {
    dim3 grid((unsigned)((R + BM - 1) / BM), KVH, B);
#define FLASH_DQ(DIM, DR)                                                  \
  return (int)launch_dq_bf16<DIM, DR>(grid, st, q, k, v, g, q_pos, kv_pos, \
                                      lse, delta, dq, T, S, H, KVH, scale, \
                                      drop)
    if (D == 128) {
      if (with_drop) FLASH_DQ(128, true);
      FLASH_DQ(128, false);
    }
    if (D == 64) {
      if (with_drop) FLASH_DQ(64, true);
      FLASH_DQ(64, false);
    }
#undef FLASH_DQ
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    dim3 grid((unsigned)((R + F32_ROWS - 1) / F32_ROWS), KVH, B);
    const float *qq = static_cast<const float*>(q),
                *kk = static_cast<const float*>(k),
                *vv = static_cast<const float*>(v),
                *gg = static_cast<const float*>(g);
    float* out = static_cast<float*>(dq);
    if (D == 128) {
      flash_bwd_dq_f32_kernel<4><<<grid, F32_ROWS * 32, 0, st>>>(
          qq, kk, vv, gg, q_pos, kv_pos, lse, delta, out, T, S, H, KVH, scale,
          with_drop != 0, drop);
    } else if (D == 64) {
      flash_bwd_dq_f32_kernel<2><<<grid, F32_ROWS * 32, 0, st>>>(
          qq, kk, vv, gg, q_pos, kv_pos, lse, delta, out, T, S, H, KVH, scale,
          with_drop != 0, drop);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* g, const int* q_pos,
                             const int* kv_pos, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int T, int S, int H, int KVH, int D, int dtype,
                             float scale, int with_drop, unsigned int seed_lo,
                             unsigned int seed_hi, unsigned int threshold,
                             float inv_keep, void* stream) {
  if (bad_shape(B, T, S, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed_lo, seed_hi, threshold, inv_keep};
  if (dtype == 1) {
    dim3 grid((unsigned)((S + BN - 1) / BN), KVH, B);
#define FLASH_DKV(DIM, DR)                                                   \
  return (int)launch_dkv_bf16<DIM, DR>(grid, st, q, k, v, g, q_pos, kv_pos,  \
                                       lse, delta, dk, dv, T, S, H, KVH,     \
                                       scale, drop)
    if (D == 128) {
      if (with_drop) FLASH_DKV(128, true);
      FLASH_DKV(128, false);
    }
    if (D == 64) {
      if (with_drop) FLASH_DKV(64, true);
      FLASH_DKV(64, false);
    }
#undef FLASH_DKV
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    dim3 grid((unsigned)((S + F32_ROWS - 1) / F32_ROWS), KVH, B);
    const float *qq = static_cast<const float*>(q),
                *kk = static_cast<const float*>(k),
                *vv = static_cast<const float*>(v),
                *gg = static_cast<const float*>(g);
    float *ok = static_cast<float*>(dk), *ov = static_cast<float*>(dv);
    if (D == 128) {
      flash_bwd_dkv_f32_kernel<4><<<grid, F32_ROWS * 32, 0, st>>>(
          qq, kk, vv, gg, q_pos, kv_pos, lse, delta, ok, ov, T, S, H, KVH,
          scale, with_drop != 0, drop);
    } else if (D == 64) {
      flash_bwd_dkv_f32_kernel<2><<<grid, F32_ROWS * 32, 0, st>>>(
          qq, kk, vv, gg, q_pos, kv_pos, lse, delta, ok, ov, T, S, H, KVH,
          scale, with_drop != 0, drop);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

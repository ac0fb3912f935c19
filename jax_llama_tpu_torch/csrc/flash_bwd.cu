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
// so no atomics are needed and two calls on the same inputs give the same
// bits.  Padding rows and rows that see no live slot (lse = +inf)
// contribute nothing.  The dropout bits are those of the forward
// (flash_common.cuh), hashed from the global (packed row, slot).
//
// Layout: q, dO and dq [B, T, H, d]; k, v, dk and dv [B, S, KVH, d]; lse
// and Delta float32 [B, KVH, G*T]; q_pos [B, T], kv_pos [B, S] int32.
//
// What bounds them on an H100: operations.  At the training shape (B = 4,
// T = S = 2048, H = 32, KVH = 8, d = 128, causal) the two kernels need
// about 14*d FLOP per live (row, slot) pair: 6*d in dQ (S, dP, dQ) and
// 8*d in dK/dV (S, dP, dV, dK), ~0.5 TFLOP in all, against ~0.2 GB of
// inputs and outputs.  Each kernel has three instances, each its own C
// entry point, which reports the instance it launched through an int*:
//
//   * The Hopper instances (flash_bwd_dq_wgmma, flash_bwd_dkv_wgmma; bf16,
//     d = 128, T a multiple of 128: the training shape).  TMA loads (4-D
//     tensor maps, 128-byte swizzle, two 64-column boxes per d = 128 row)
//     feed a ring of NST = 3 stages with full/empty mbarriers; two
//     consumer warpgroups run every product on wgmma.
//     - dQ: one block per (128 packed rows of one query head, KV head,
//       batch), 288 threads: a producer warp loads Q and dO once and
//       streams K/V in 64-slot tiles up to the block's last attended slot,
//       with each tile's positions and dropout slot words beside it.  Each
//       consumer warpgroup owns 64 rows: S = Q K^T and dP = dO V^T
//       (m64n64k16, both operands K-major in shared memory), P and dS in
//       registers, then dQ += dS K (m64n128k16) with dS as the register A
//       operand (the accumulator layout, rounded to bf16) and K as an
//       MN-major B operand.  dQ is written once, in bf16.
//     - dK/dV: one block per (128 KV slots, KV head, batch), 256 threads:
//       K and V are loaded once and Q and dO stream in 64-row tiles over
//       the G*T packed rows, the rows' q_pos, lse and Delta beside them by
//       bulk copies.  Each consumer warpgroup owns 64 slots and keeps their
//       dK and dV accumulators (128 floats a thread) for the whole sweep:
//       S^T = K Q^T and dP^T = V dO^T (m64n64k16), P^T and dS^T in
//       registers, then dV += (D*P)^T dO and dK += dS^T Q (m64n128k16,
//       register A, dO and Q MN-major).  A ninth (producer) warp would put
//       three warps on one SM sub-partition and cap every thread at 168
//       registers, where these consumers spill (setmaxnreg moves registers
//       at run time but ptxas still allocates within the cap), so consumer
//       thread 0 issues the loads, refilling a stage once every thread has
//       released it.  The accumulator's rows are slots and its columns
//       packed rows, so the dropout hash takes its slot word per thread and
//       a row word per column.
//     Whole tiles are skipped by positions before their loads (dQ: a K/V
//     tile whose smallest position is above every row of the block; dK/dV:
//     a row tile whose largest q_pos is below the block's smallest slot
//     position), and per consumer warpgroup the same way; the per-element
//     mask runs only on a tile that straddles the diagonal or holds an
//     empty slot (remapped to INT_MAX).  The grid runs the heaviest blocks
//     first under a causal mask: dQ's late query tiles, dK/dV's early slots.
//   * The mma.sync instances (every other bf16 call: d = 64, ragged T):
//     one block per (b, KV head, 64 rows or slots), four warps of 16 rows;
//     tiles copied through registers into padded shared memory (70 KB at
//     d = 128), one at a time; m16n8k16 products with the score
//     accumulators fed back as the A operand of the next product.
//   * The float32 instances: plain CUDA-core kernels (one warp per packed
//     row or per slot) for callers that train in float32 and for the
//     gradient checks; the main path is bf16.
#include "flash_common.cuh"
#include "hopper_common.cuh"

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

// ---------------------------------------------------------------------------
// The Hopper instances: bf16, d = 128, T a multiple of 128 (see the file's
// header).  Threads 0-255 are the two consumer warpgroups.
// ---------------------------------------------------------------------------

namespace wgb {

constexpr int D = 128;
constexpr int ROW = 128;  // bytes per swizzled row (64 bf16)
constexpr int NCONS = 256;  // two consumer warpgroups
constexpr int NST = 3;      // ring stages
constexpr int META = 4;     // ints per stage

// dQ: 128 packed rows of one query head a block, 64-slot K/V tiles; a
// producer warp beside the consumers.
namespace dq {
constexpr int NTHREADS = NCONS + 32;
constexpr int BM = 128, BN = 64;
constexpr int ROWS_BYTES = BM * D * 2;  // Q or dO: two 64-column boxes
constexpr int KV_BYTES = BN * D * 2;    // one K or V tile
constexpr int OFF_Q = 0;
constexpr int OFF_G = OFF_Q + ROWS_BYTES;
constexpr int OFF_K = OFF_G + ROWS_BYTES;
constexpr int OFF_V = OFF_K + NST * KV_BYTES;
constexpr int OFF_KP = OFF_V + NST * KV_BYTES;   // int kv_pos [NST][BN]
constexpr int OFF_CW = OFF_KP + NST * BN * 4;    // dropout slot words
constexpr int OFF_META = OFF_CW + NST * BN * 4;  // [NST][META], reductions
constexpr int OFF_BAR = OFF_META + 128;  // rows, full[NST], empty[NST]
constexpr int SMEM = OFF_BAR + (1 + 2 * NST) * 8 + 1024;  // + alignment
}  // namespace dq

// dK/dV: 128 KV slots a block, 64-row Q/dO tiles; no producer warp (its
// ninth warp would cap every thread at 168 registers, and the consumers
// hold 128 accumulators each): consumer thread 0 issues the loads.
namespace dkv {
constexpr int NTHREADS = NCONS;
constexpr int BN = 128, BM = 64;
constexpr int MAX_TILES = 1024;         // T / BM: T up to 65536
constexpr int KV_BYTES = BN * D * 2;    // K or V of the block's slots
constexpr int ROWS_BYTES = BM * D * 2;  // one Q or dO tile
constexpr int ROW_DATA = 3 * BM * 4;    // a tile's q_pos, lse, Delta
constexpr int OFF_K = 0;
constexpr int OFF_V = OFF_K + KV_BYTES;
constexpr int OFF_Q = OFF_V + KV_BYTES;
constexpr int OFF_G = OFF_Q + NST * ROWS_BYTES;
constexpr int OFF_ROWS = OFF_G + NST * ROWS_BYTES;  // [NST][3][BM]
constexpr int OFF_TQ = OFF_ROWS + NST * ROW_DATA;   // int [2][MAX_TILES]
constexpr int OFF_KP = OFF_TQ + 2 * MAX_TILES * 4;  // int kv_pos [BN]
constexpr int OFF_META = OFF_KP + BN * 4;           // [NST][META], reds
constexpr int OFF_BAR = OFF_META + 128;  // k/v, full[NST], empty[NST]
constexpr int SMEM = OFF_BAR + (1 + 2 * NST) * 8 + 1024;
}  // namespace dkv

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// The block's dynamic shared memory, aligned up to 1024 bytes (TMA boxes
// and swizzle atoms); its shared address in *base.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw,
                                                       uint32_t* base) {
  const uint32_t raw_addr = hopper::smem_addr(raw);
  *base = (raw_addr + 1023u) & ~1023u;
  return raw + (*base - raw_addr);
}

// The descriptor of k-step kk (16 of d) of a K-major tile of `rows` rows
// whose two 64-column boxes lie one after the other from `addr`.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int rows, int kk) {
  return hopper::sw128_desc(addr + (kk >> 2) * rows * ROW + (kk & 3) * 32, 16,
                            1024);
}

// The descriptor of k-step j (16 rows) of the same tile read as an
// MN-major B operand (d across N; the second box is the next 64 of N).
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int rows, int j) {
  return hopper::sw128_desc(addr + j * 16 * ROW, rows * ROW, 1024);
}

}  // namespace wgb

template <bool DROP>
__global__ void __launch_bounds__(wgb::dq::NTHREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dq, int T, int S, int H,
                          int KVH, float scale, Dropout drop) {
  using namespace wgb;
  using namespace wgb::dq;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, &base);
  int* kp_s = reinterpret_cast<int*>(smem + OFF_KP);
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(smem + OFF_CW);
  int* meta_s = reinterpret_cast<int*>(smem + OFF_META);
  // The block's max and min q_pos, its last attended slot, and each
  // consumer warpgroup's max and min q_pos.
  int* red_s = meta_s + NST * META;
  const uint32_t bar_rows = base + OFF_BAR;
  auto bar_full = [&](int s) { return bar_rows + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_rows + 8u * (1 + NST + s); };

  const int G = H / KVH;
  const int R = G * T;
  // Late query tiles (the most K/V under a causal mask) first.
  const int t0 = (T / BM - 1 - (int)blockIdx.y) * BM;
  int x = blockIdx.x;
  const int g = x % G;
  x /= G;
  const int kvh = x % KVH, b = x / KVH;
  const int h = kvh * G + g;
  const int row0 = g * T + t0;  // the block's first packed row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    red_s[0] = red_s[3] = red_s[4] = INT_MIN;
    red_s[1] = red_s[5] = red_s[6] = INT_MAX;
    red_s[2] = -1;
    mbar_init(bar_rows, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full(s), 32);      // the producer warp's lanes
      mbar_init(bar_empty(s), NCONS);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < BM) {
    const int p = q_pos[(size_t)b * T + t0 + tid];
    atomicMax(&red_s[0], p);
    atomicMin(&red_s[1], p);
    atomicMax(&red_s[3 + (tid >> 6)], p);
    atomicMin(&red_s[5 + (tid >> 6)], p);
  }
  __syncthreads();
  const int qmax = red_s[0];
  {
    int last = -1;
    for (int s = tid; s < S; s += NTHREADS) {
      if (remap_pos(kv_pos[(size_t)b * S + s]) <= qmax) last = s;
    }
    if (last >= 0) atomicMax(&red_s[2], last);
  }
  __syncthreads();
  const int n_tiles = (red_s[2] + BN) / BN;
  uint32_t base_lo = 0, base_hi = 0;
  if constexpr (DROP) drop_bases(drop, b, kvh, base_lo, base_hi);

  if (warp == NCONS / 32) {
    // Producer: Q and dO once, then each live K/V tile with its positions
    // (and, with dropout, its slot hash words) into the next free stage;
    // a stage whose tile is -1 ends the walk.
    if (lane == 0) {
      mbar_arrive_tx(bar_rows, 2 * ROWS_BYTES);
      tma_load_4d(base + OFF_Q, &tq, bar_rows, 0, h, t0, b);
      tma_load_4d(base + OFF_Q + BM * ROW, &tq, bar_rows, 64, h, t0, b);
      tma_load_4d(base + OFF_G, &tg, bar_rows, 0, h, t0, b);
      tma_load_4d(base + OFF_G + BM * ROW, &tg, bar_rows, 64, h, t0, b);
    }
    const int* kvrow = kv_pos + (size_t)b * S;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int s0 = tile * BN;
      int kp[BN / 32];
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int s = s0 + lane + 32 * i;
        kp[i] = s < S ? remap_pos(kvrow[s]) : INT_MAX;
        lo = min(lo, kp[i]);
        hi = max(hi, kp[i]);
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      if (lo > qmax) continue;  // no row of the block attends a slot here
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
        meta_s[stage * META] = tile;
        meta_s[stage * META + 1] = lo;
        meta_s[stage * META + 2] = hi;
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
    if (lane == 0) meta_s[stage * META] = -1;
    mbar_arrive(bar_full(stage));
    return;
  }

  // Consumers: warpgroup wgi owns the block's rows [64 wgi, 64 wgi + 64);
  // in a wgmma accumulator, warp wl's lane holds rows 16 wl + lane/4 (+8)
  // and columns 8 i + 2 (lane % 4) (+1) of chunk i.
  const int wgi = tid >> 7, wl = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int wg_qmax = red_s[3 + wgi], wg_qmin = red_s[5 + wgi];
  const float scale_log2 = scale * LOG2E;
  int qp[2], rloc[2];
  float lse2[2], dlt[2];
  uint32_t rw[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rloc[i] = 64 * wgi + 16 * wl + grp + 8 * i;
    qp[i] = q_pos[(size_t)b * T + t0 + rloc[i]];
    const size_t lrow = ((size_t)b * KVH + kvh) * R + row0 + rloc[i];
    lse2[i] = lse[lrow] * LOG2E;  // +inf on a row with no live slot: P = 0
    dlt[i] = delta[lrow];
    if constexpr (DROP) rw[i] = row_word(base_lo, row0 + rloc[i]);
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t qa = base + OFF_Q + wgi * 64 * ROW;
  const uint32_t ga = base + OFF_G + wgi * 64 * ROW;

  mbar_wait(bar_rows, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(bar_full(stage), phase);
    const int* meta = meta_s + stage * META;
    if (meta[0] < 0) break;
    if (meta[1] <= wg_qmax) {  // some row of this warpgroup attends here
      // No compare where every slot is live and below every row.
      const bool full = meta[2] <= wg_qmin;
      const int* kp = kp_s + stage * BN;
      const uint32_t* cws = cw_s + stage * BN;
      const uint32_t kb = base + OFF_K + stage * KV_BYTES;
      const uint32_t vb = base + OFF_V + stage * KV_BYTES;

      // S = Q K^T and dP = dO V^T: 8 k-steps of 16 each.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_m64n64_ss(sc, kmajor(qa, BM, kk), kmajor(kb, BN, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_m64n64_ss(dp, kmajor(ga, BM, kk), kmajor(vb, BN, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      // dS = P (D dP - Delta) scale, rounded to bf16 into the A fragments:
      // chunks 2j, 2j+1 are k-step j.
      uint32_t da[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * i + 2 * tig;
        const int2 kpp = *reinterpret_cast<const int2*>(kp + c);
        uint2 cw = make_uint2(0u, 0u);
        if constexpr (DROP) cw = *reinterpret_cast<const uint2*>(cws + c);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kpe = (e & 1) ? kpp.y : kpp.x;
          const float p = (full || kpe <= qp[r])
                              ? exp2f(sc[4 * i + e] * scale_log2 - lse2[r])
                              : 0.f;
          float d = dp[4 * i + e];
          if constexpr (DROP) {
            d = keep(rw[r], (e & 1) ? cw.y : cw.x, drop.threshold)
                    ? d * drop.inv
                    : 0.f;
          }
          ds[e] = p * (d - dlt[r]) * scale;
        }
        da[i >> 1][2 * (i & 1)] = pack_bf16x2(ds[0], ds[1]);
        da[i >> 1][2 * (i & 1) + 1] = pack_bf16x2(ds[2], ds[3]);
      }

      // dQ += dS K: K is the MN-major B operand (d across N).
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wgmma_m64n128_rs(acc, da[j], mnmajor(kb, BN, j));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
    }
    mbar_arrive(bar_empty(stage));
    if (++stage == NST) {
      stage = 0;
      phase ^= 1u;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint16_t* orow = dq + ((size_t)(b * T + t0 + rloc[r]) * H + h) * D;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * tig) =
          pack_bf16x2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

template <bool DROP>
__global__ void __launch_bounds__(wgb::dkv::NTHREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ kv_pos,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           uint16_t* __restrict__ dk,
                           uint16_t* __restrict__ dv, int T, int S, int H,
                           int KVH, float scale, Dropout drop) {
  using namespace wgb;
  using namespace wgb::dkv;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, &base);
  int* kp_s = reinterpret_cast<int*>(smem + OFF_KP);
  // The smallest and largest q_pos of each 64-token tile.
  int* tlo_s = reinterpret_cast<int*>(smem + OFF_TQ);
  int* thi_s = tlo_s + MAX_TILES;
  int* meta_s = reinterpret_cast<int*>(smem + OFF_META);
  // The block's smallest slot position; each consumer warpgroup's
  // smallest and largest.
  int* red_s = meta_s + NST * META;
  const uint32_t bar_kv = base + OFF_BAR;
  auto bar_full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8u * (1 + NST + s); };

  const int G = H / KVH;
  const int R = G * T;
  const int n_tt = T / BM;
  const int kvh = blockIdx.x % KVH, b = blockIdx.x / KVH;
  // Early slots (every later row attends them under a causal mask) first.
  const int s0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    red_s[0] = red_s[1] = red_s[2] = INT_MAX;
    red_s[3] = red_s[4] = INT_MIN;
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full(s), 1);             // thread 0's arrival
      mbar_init(bar_empty(s), NTHREADS);     // every thread
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < BN) {
    const int s = s0 + tid;
    const int kp = s < S ? remap_pos(kv_pos[(size_t)b * S + s]) : INT_MAX;
    kp_s[tid] = kp;
    atomicMin(&red_s[0], kp);
    atomicMin(&red_s[1 + (tid >> 6)], kp);
    atomicMax(&red_s[3 + (tid >> 6)], kp);
  }
  for (int tt = warp; tt < n_tt; tt += NTHREADS / 32) {
    const int* qrow = q_pos + (size_t)b * T + tt * BM;
    const int lo = warp_min(min(qrow[lane], qrow[lane + 32]));
    const int hi = warp_max(max(qrow[lane], qrow[lane + 32]));
    if (lane == 0) {
      tlo_s[tt] = lo;
      thi_s[tt] = hi;
    }
  }
  __syncthreads();
  const int kmin = red_s[0];
  uint32_t base_lo = 0, base_hi = 0;
  if constexpr (DROP) drop_bases(drop, b, kvh, base_lo, base_hi);

  // The loads, issued by thread 0: K and V once, then the live 64-row
  // tiles of the group's packed rows in order (query head g, token tile
  // tt) -- Q and dO by TMA, the rows' q_pos, lse and Delta by bulk copies
  // -- into the next stage of the ring once every thread has released it;
  // a stage whose first row is -1 ends the sweep.  A row tile whose
  // largest q_pos is below every slot of the block is never loaded.
  int cur_g = kmin == INT_MAX ? G : 0, cur_tt = 0;  // every slot dead: none
  int pstage = 0;
  uint32_t pphase = 0;
  bool ended = false;
  auto fill = [&]() {
    while (cur_g < G && thi_s[cur_tt] < kmin) {
      if (++cur_tt == n_tt) {
        cur_tt = 0;
        ++cur_g;
      }
    }
    mbar_wait(bar_empty(pstage), pphase ^ 1u);
    int* meta = meta_s + pstage * META;
    if (cur_g < G) {
      const int t0 = cur_tt * BM, r0 = cur_g * T + t0;
      const int h = kvh * G + cur_g;
      const size_t lrow = ((size_t)b * KVH + kvh) * R + r0;
      meta[0] = r0;
      meta[1] = cur_tt;
      const uint32_t full = bar_full(pstage);
      const uint32_t qd = base + OFF_Q + pstage * ROWS_BYTES;
      const uint32_t gd = base + OFF_G + pstage * ROWS_BYTES;
      const uint32_t rd = base + OFF_ROWS + pstage * ROW_DATA;
      mbar_arrive_tx(full, 2 * ROWS_BYTES + ROW_DATA);
      tma_load_4d(qd, &tq, full, 0, h, t0, b);
      tma_load_4d(qd + BM * ROW, &tq, full, 64, h, t0, b);
      tma_load_4d(gd, &tg, full, 0, h, t0, b);
      tma_load_4d(gd + BM * ROW, &tg, full, 64, h, t0, b);
      bulk_load(rd, q_pos + (size_t)b * T + t0, BM * 4, full);
      bulk_load(rd + BM * 4, lse + lrow, BM * 4, full);
      bulk_load(rd + 2 * BM * 4, delta + lrow, BM * 4, full);
      if (++cur_tt == n_tt) {
        cur_tt = 0;
        ++cur_g;
      }
    } else {
      meta[0] = -1;
      mbar_arrive(bar_full(pstage));
      ended = true;
    }
    if (++pstage == NST) {
      pstage = 0;
      pphase ^= 1u;
    }
  };
  if (tid == 0) {
    mbar_arrive_tx(bar_kv, 2 * KV_BYTES);
    tma_load_4d(base + OFF_K, &tk, bar_kv, 0, kvh, s0, b);
    tma_load_4d(base + OFF_K + BN * ROW, &tk, bar_kv, 64, kvh, s0, b);
    tma_load_4d(base + OFF_V, &tv, bar_kv, 0, kvh, s0, b);
    tma_load_4d(base + OFF_V + BN * ROW, &tv, bar_kv, 64, kvh, s0, b);
    for (int i = 0; i < NST && !ended; ++i) fill();
  }
  __syncwarp();

  // Warpgroup wgi owns the block's slots [64 wgi, 64 wgi + 64).  The
  // accumulators are transposed: warp wl's lane holds slots 16 wl +
  // lane/4 (+8) as rows and the tile's packed rows 8 i + 2 (lane % 4)
  // (+1) as the columns of chunk i.
  const int wgi = tid >> 7, wl = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int wg_kmin = red_s[1 + wgi], wg_kmax = red_s[3 + wgi];
  const float scale_log2 = scale * LOG2E;
  int sl[2], kp[2];
  uint32_t cw[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sl[i] = 64 * wgi + 16 * wl + grp + 8 * i;
    kp[i] = kp_s[sl[i]];
    if constexpr (DROP) cw[i] = col_word(base_hi, s0 + sl[i]);
  }
  float dka[64], dva[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t ka = base + OFF_K + wgi * 64 * ROW;
  const uint32_t va = base + OFF_V + wgi * 64 * ROW;

  mbar_wait(bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(bar_full(stage), phase);
    const int* meta = meta_s + stage * META;
    const int r0 = meta[0];
    if (r0 < 0) break;
    if (thi_s[meta[1]] >= wg_kmin) {  // some row attends this warpgroup
      // No compare where every row is at or past every live slot.
      const bool full = tlo_s[meta[1]] >= wg_kmax;
      const int* rows =
          reinterpret_cast<const int*>(smem + OFF_ROWS + stage * ROW_DATA);
      const float* rowsf = reinterpret_cast<const float*>(rows);
      const uint32_t qb = base + OFF_Q + stage * ROWS_BYTES;
      const uint32_t gb = base + OFF_G + stage * ROWS_BYTES;

      // S^T = K Q^T and dP^T = V dO^T.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_m64n64_ss(st, kmajor(ka, BN, kk), kmajor(qb, BM, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_m64n64_ss(dpt, kmajor(va, BN, kk), kmajor(gb, BM, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(st);
      reg_fence(dpt);

      // (D P)^T and dS^T, rounded to bf16 into the A fragments.
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * i + 2 * tig;
        const int2 qpp = *reinterpret_cast<const int2*>(rows + c);
        const float2 ls = *reinterpret_cast<const float2*>(rowsf + BM + c);
        const float2 dl =
            *reinterpret_cast<const float2*>(rowsf + 2 * BM + c);
        uint32_t rw[2] = {0u, 0u};
        if constexpr (DROP) {
          rw[0] = row_word(base_lo, r0 + c);
          rw[1] = row_word(base_lo, r0 + c + 1);
        }
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int si = e >> 1;  // slot sl[si]
          const int o = e & 1;    // packed row r0 + c + o
          // lse = +inf on a row with no live slot: P = 0 there.
          const float p = (full || kp[si] <= (o ? qpp.y : qpp.x))
                              ? exp2f(st[4 * i + e] * scale_log2 -
                                      (o ? ls.y : ls.x) * LOG2E)
                              : 0.f;
          float pe = p, d = dpt[4 * i + e];
          if constexpr (DROP) {
            const bool kept = keep(rw[o], cw[si], drop.threshold);
            pe = kept ? p * drop.inv : 0.f;
            d = kept ? d * drop.inv : 0.f;
          }
          pv[e] = pe;
          ds[e] = p * (d - (o ? dl.y : dl.x)) * scale;
        }
        pa[i >> 1][2 * (i & 1)] = pack_bf16x2(pv[0], pv[1]);
        pa[i >> 1][2 * (i & 1) + 1] = pack_bf16x2(pv[2], pv[3]);
        da[i >> 1][2 * (i & 1)] = pack_bf16x2(ds[0], ds[1]);
        da[i >> 1][2 * (i & 1) + 1] = pack_bf16x2(ds[2], ds[3]);
      }

      // dV += (D P)^T dO, dK += dS^T Q: dO and Q as MN-major B operands.
      reg_fence(dva);
      reg_fence(dka);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
        wgmma_m64n128_rs(dva, pa[j], mnmajor(gb, BM, j));
      }
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
        wgmma_m64n128_rs(dka, da[j], mnmajor(qb, BM, j));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dva);
      reg_fence(dka);
    }
    mbar_arrive(bar_empty(stage));
    if (tid == 0 && !ended) fill();
    __syncwarp();
    if (++stage == NST) {
      stage = 0;
      phase ^= 1u;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = s0 + sl[i];
    if (s >= S) continue;
    const size_t o = ((size_t)(b * S + s) * KVH + kvh) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<uint32_t*>(dk + o + 8 * j + 2 * tig) =
          pack_bf16x2(dka[4 * j + 2 * i], dka[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + o + 8 * j + 2 * tig) =
          pack_bf16x2(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  }
}

// The four tensor maps of a Hopper launch (q, dO, k, v): q and dO in boxes
// of `q_rows` rows, k and v in boxes of `kv_rows`; false if the encoder
// refuses one.
bool encode_maps(CUtensorMap* maps, const void* q, const void* g,
                 const void* k, const void* v, int B, int T, int S, int H,
                 int KVH, int q_rows, int kv_rows) {
  using hopper::encode_bf16_4d;
  const int D = wgb::D;
  return encode_bf16_4d(&maps[0], q, D, H, T, B, q_rows) &&
         encode_bf16_4d(&maps[1], g, D, H, T, B, q_rows) &&
         encode_bf16_4d(&maps[2], k, D, KVH, S, B, kv_rows) &&
         encode_bf16_4d(&maps[3], v, D, KVH, S, B, kv_rows);
}

template <bool DROP>
cudaError_t launch_dq_wgmma(dim3 grid, cudaStream_t st, const CUtensorMap* m,
                            const int* q_pos, const int* kv_pos,
                            const float* lse, const float* delta, void* dq,
                            int T, int S, int H, int KVH, float scale,
                            Dropout drop) {
  auto kernel = flash_bwd_dq_wgmma_kernel<DROP>;
  cudaError_t err = allow_smem(kernel, wgb::dq::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wgb::dq::NTHREADS, wgb::dq::SMEM, st>>>(
      m[0], m[1], m[2], m[3], q_pos, kv_pos, lse, delta,
      static_cast<uint16_t*>(dq), T, S, H, KVH, scale, drop);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t launch_dkv_wgmma(dim3 grid, cudaStream_t st,
                             const CUtensorMap* m, const int* q_pos,
                             const int* kv_pos, const float* lse,
                             const float* delta, void* dk, void* dv, int T,
                             int S, int H, int KVH, float scale,
                             Dropout drop) {
  auto kernel = flash_bwd_dkv_wgmma_kernel<DROP>;
  cudaError_t err = allow_smem(kernel, wgb::dkv::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wgb::dkv::NTHREADS, wgb::dkv::SMEM, st>>>(
      m[0], m[1], m[2], m[3], q_pos, kv_pos, lse, delta,
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), T, S, H, KVH,
      scale, drop);
  return cudaGetLastError();
}

// The shapes the Hopper instances take.
bool wgmma_shape(int B, int T, int S, int H, int KVH, int D, int dtype) {
  return !bad_shape(B, T, S, H, KVH) && T % wgb::dq::BM == 0 &&
         T / wgb::dkv::BM <= wgb::dkv::MAX_TILES &&
         S / wgb::dkv::BN < 65535 && D == wgb::D && dtype == 1;
}

// What each C entry point reports through its `instance` argument.
constexpr int INSTANCE_FLOAT32 = 1;
constexpr int INSTANCE_MMA_SYNC = 2;
constexpr int INSTANCE_WGMMA = 3;

}  // namespace

// The mma.sync (bf16) and float32 instances of dQ.
static int dq_classic(const void* q, const void* k, const void* v,
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

// The mma.sync (bf16) and float32 instances of dK/dV.
static int dkv_classic(const void* q, const void* k, const void* v,
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

// dtype: 0 = float32, 1 = bfloat16; D is 64 or 128.  `scale` is
// 1 / sqrt(d).  with_drop != 0 rebuilds the forward's dropout mask from
// the seed words, threshold and 1 / (1 - rate).  Each returns the
// cudaError_t of its launch (0 on success), launches on `stream`, does not
// synchronise, and sets *instance to the instance it launched (1 float32,
// 2 mma.sync, 3 the Hopper instance), 0 when nothing launched.  The
// `_wgmma` entry points take only the Hopper instance's shapes (bf16,
// D = 128, T a multiple of 128) and return cudaErrorInvalidValue for any
// other, or for a tensor map the encoder refuses; they encode the four
// tensor maps (which hold the base pointers) for each call.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* g, const int* q_pos,
                            const int* kv_pos, const float* lse,
                            const float* delta, void* dq, int B, int T, int S,
                            int H, int KVH, int D, int dtype, float scale,
                            int with_drop, unsigned int seed_lo,
                            unsigned int seed_hi, unsigned int threshold,
                            float inv_keep, void* stream, int* instance) {
  *instance = 0;
  const int err = dq_classic(q, k, v, g, q_pos, kv_pos, lse, delta, dq, B, T,
                             S, H, KVH, D, dtype, scale, with_drop, seed_lo,
                             seed_hi, threshold, inv_keep, stream);
  if (err == 0) *instance = dtype == 0 ? INSTANCE_FLOAT32 : INSTANCE_MMA_SYNC;
  return err;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* g, const int* q_pos,
                             const int* kv_pos, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int T, int S, int H, int KVH, int D, int dtype,
                             float scale, int with_drop, unsigned int seed_lo,
                             unsigned int seed_hi, unsigned int threshold,
                             float inv_keep, void* stream, int* instance) {
  *instance = 0;
  const int err = dkv_classic(q, k, v, g, q_pos, kv_pos, lse, delta, dk, dv,
                              B, T, S, H, KVH, D, dtype, scale, with_drop,
                              seed_lo, seed_hi, threshold, inv_keep, stream);
  if (err == 0) *instance = dtype == 0 ? INSTANCE_FLOAT32 : INSTANCE_MMA_SYNC;
  return err;
}

extern "C" int flash_bwd_dq_wgmma(const void* q, const void* k,
                                  const void* v, const void* g,
                                  const int* q_pos, const int* kv_pos,
                                  const float* lse, const float* delta,
                                  void* dq, int B, int T, int S, int H,
                                  int KVH, int D, int dtype, float scale,
                                  int with_drop, unsigned int seed_lo,
                                  unsigned int seed_hi,
                                  unsigned int threshold, float inv_keep,
                                  void* stream, int* instance) {
  *instance = 0;
  CUtensorMap maps[4];
  if (!wgmma_shape(B, T, S, H, KVH, D, dtype) ||
      !encode_maps(maps, q, g, k, v, B, T, S, H, KVH, wgb::dq::BM,
                   wgb::dq::BN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed_lo, seed_hi, threshold, inv_keep};
  const dim3 grid((unsigned)(B * H), (unsigned)(T / wgb::dq::BM));
  const cudaError_t err =
      with_drop ? launch_dq_wgmma<true>(grid, st, maps, q_pos, kv_pos, lse,
                                        delta, dq, T, S, H, KVH, scale, drop)
                : launch_dq_wgmma<false>(grid, st, maps, q_pos, kv_pos, lse,
                                         delta, dq, T, S, H, KVH, scale,
                                         drop);
  if (err == cudaSuccess) *instance = INSTANCE_WGMMA;
  return (int)err;
}

extern "C" int flash_bwd_dkv_wgmma(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const int* q_pos, const int* kv_pos,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int B, int T, int S,
                                   int H, int KVH, int D, int dtype,
                                   float scale, int with_drop,
                                   unsigned int seed_lo, unsigned int seed_hi,
                                   unsigned int threshold, float inv_keep,
                                   void* stream, int* instance) {
  *instance = 0;
  CUtensorMap maps[4];
  if (!wgmma_shape(B, T, S, H, KVH, D, dtype) ||
      !encode_maps(maps, q, g, k, v, B, T, S, H, KVH, wgb::dkv::BM,
                   wgb::dkv::BN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed_lo, seed_hi, threshold, inv_keep};
  const dim3 grid((unsigned)(B * KVH),
                  (unsigned)((S + wgb::dkv::BN - 1) / wgb::dkv::BN));
  const cudaError_t err =
      with_drop
          ? launch_dkv_wgmma<true>(grid, st, maps, q_pos, kv_pos, lse, delta,
                                   dk, dv, T, S, H, KVH, scale, drop)
          : launch_dkv_wgmma<false>(grid, st, maps, q_pos, kv_pos, lse,
                                    delta, dk, dv, T, S, H, KVH, scale, drop);
  if (err == cudaSuccess) *instance = INSTANCE_WGMMA;
  return (int)err;
}

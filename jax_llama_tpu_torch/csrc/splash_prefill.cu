// Splash prefill for Hopper (sm_90a), plain C entry point: the "splash"
// slot of the kernel-selection layer.
//
// Replaces the TPU kernel that jax_llama_tpu/ops/kernels.py launches at
// :264 (the upstream `make_splash_mha_single_device` with one
// `CausalMask(offset=chunk_offset)` per head), reached from
// `splash_prefill` (:224) and `splash_prefill_attention` (:277).  The
// function, for one prefill chunk of an insert:
//
//   q' = round(q * d^-0.25), k' = round(k * d^-0.25)   (each to its dtype,
//        as JAX rounds `q * scale` and `k * scale`, :269-270)
//   out[b, t, h] = sum_{j <= t + offset} softmax_j(q'[b,t,h] . k'[b,j,h/G])
//                  v[b, j, h/G]
//
// with a float32 softmax and the output in q's dtype.  `offset` is a
// static int (the chunk's first position): no position or slot array is
// read, and every query row attends at least column 0.
//
// Layout: q and out [B, T, H, d], k and v [B, S, KVH, d], contiguous; GQA
// is native (query head h reads KV head h / G).  d = 128; T and S are
// multiples of 64 here (the wrapper asks 128, as `splash_eligible` does).
//
// What bounds it on an H100: at the serving insert (B = 8, T = S = 1024,
// H = 32, d = 128, offset 0) the live (query, column) pairs need ~69
// GFLOP of tensor-core work, ~0.07 ms at the bf16 peak, against ~67 MB
// of q, k, v and out, ~0.02 ms of HBM: operations bound it.  The design
// is written apart from the flash kernel (flash_fwd.cu, which packs the G
// heads of a KV head into one block's rows and masks every tile from
// position arrays):
//   * One block per (64-query tile, query head, row), 4 warps of 16 rows.
//     The mask is the static offset alone: the K/V loop stops at
//     min(S, tile end + offset), so tiles wholly above the diagonal are
//     never loaded, and only tiles that reach past the tile's first
//     row's limit apply a mask.
//   * K/V tiles of 64 columns are double-buffered in dynamic shared
//     memory: the next tile's cp.async copies are in flight while this
//     tile's products run.
//   * K is scaled by d^-0.25 and rounded to bf16 once per tile in shared
//     memory; q once into the warps' registers.
//   * bf16 products on the tensor cores (mma.sync m16n8k16, float32
//     accumulate); scores, the online softmax (base 2) and the output
//     accumulator stay in registers; P is rounded to bf16 for the P.V
//     product (upstream splash keeps P in float32: a difference of at
//     most one bf16 rounding per term).
//   * A 64-query tile, not 128: at ~170 registers a thread, 8 warps of a
//     128-query tile would fit one block per SM; three 4-warp blocks fit.
// The float32 instance (float32 activations) runs on the CUDA cores: one
// warp per query row, 32-column tiles.
// Not done yet (later work): wgmma and TMA, a persistent schedule that
// balances the causal triangle's uneven tiles.

#include "flash_common.cuh"

namespace {

using flash::ld32;
using flash::mma_bf16;
using flash::pack_bf16x2;
using flash::pack_raw;
using flash::warp_sum;

constexpr int SBM = 64;            // query rows per block
constexpr int SBN = 64;            // cache columns per K/V tile
constexpr int SWARPS = SBM / 16;   // 16 rows per warp
constexpr int STHREADS = SWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Two bf16 values (one 32-bit word) times `s`, each rounded to bf16.
__device__ __forceinline__ uint32_t scale_word(uint32_t w, float s) {
  return pack_bf16x2(__uint_as_float(w << 16) * s,
                     __uint_as_float(w & 0xffff0000u) * s);
}

template <int D>
constexpr int smem_bytes() {
  return 2 * 2 * SBN * (D + 8) * 2;  // 2 stages x (K, V) x padded tile
}

template <int D>
__global__ void __launch_bounds__(STHREADS)
splash_bf16_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
                   int T, int S, int H, int KVH, int offset, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim");
  constexpr int LD = D + 8;  // padded shared row, in bf16 elements
  constexpr int KSTEPS = D / 16;
  constexpr int DBLK = D / 8;
  constexpr int NBLK = SBN / 8;
  constexpr int TILE = SBN * LD;
  extern __shared__ __align__(16) uint16_t smem[];  // [stage][K, V][TILE]

  const int G = H / KVH;
  const int q0 = blockIdx.x * SBM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  // The block's last row attends up to column q0 + SBM - 1 + offset.
  const int n_cols = min(S, q0 + SBM + offset);
  const int n_tiles = (n_cols + SBN - 1) / SBN;

  auto load_tile = [&](int tile, int stage) {
    uint16_t* ks = smem + stage * 2 * TILE;
    uint16_t* vs = ks + TILE;
    const int s0 = tile * SBN;
    for (int c = tid; c < SBN * (D / 8); c += STHREADS) {
      const int row = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      const int s = s0 + row;
      if (s < S) {
        const size_t g = ((size_t)(b * S + s) * KVH + kvh) * D + col;
        cp_async16(&ks[row * LD + col], k + g);
        cp_async16(&vs[row * LD + col], v + g);
      } else {
        *reinterpret_cast<uint4*>(&ks[row * LD + col]) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(&vs[row * LD + col]) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // This thread's two query rows (grp and grp + 8 of the warp's 16), their
  // column limits, and their scaled q fragments.
  int limit[2];
  size_t orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + warp * 16 + grp + 8 * i;
    limit[i] = t + offset;
    orow[i] = ((size_t)(b * T + t) * H + h) * D;
  }
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = scale_word(ld32(q + orow[0] + c), scale);
    qf[kk][1] = scale_word(ld32(q + orow[1] + c), scale);
    qf[kk][2] = scale_word(ld32(q + orow[0] + c + 8), scale);
    qf[kk][3] = scale_word(ld32(q + orow[1] + c + 8), scale);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial row sums over this thread's columns
  float o[DBLK][4];
#pragma unroll
  for (int nb = 0; nb < DBLK; ++nb) {
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    uint16_t* ks = smem + stage * 2 * TILE;
    const uint16_t* vs = ks + TILE;
    const int s0 = tile * SBN;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the other stage is free
    // k' = round(k * d^-0.25), once per tile.
    for (int c = tid; c < SBN * (D / 8); c += STHREADS) {
      uint4* p = reinterpret_cast<uint4*>(
          &ks[(c / (D / 8)) * LD + (c % (D / 8)) * 8]);
      uint4 x = *p;
      x.x = scale_word(x.x, scale);
      x.y = scale_word(x.y, scale);
      x.z = scale_word(x.z, scale);
      x.w = scale_word(x.w, scale);
      *p = x;
    }
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);

    // S = Q' K'^T for this warp's 16 rows x SBN columns.
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

    // Base 2; the causal-offset mask only where the tile reaches past the
    // block's first row's limit.
    const bool diag = s0 + SBN - 1 > q0 + offset;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NBLK; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float s = sc[nb][e] * LOG2E;
        if (diag && s0 + nb * 8 + tig * 2 + (e & 1) > limit[i]) {
          s = -INFINITY;
        }
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
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nb][e] - m_use[e >> 1]);
        l[e >> 1] += p;
        sc[nb][e] = p;
      }
    }

    // O += P V: the score accumulators of n-blocks 2j, 2j+1 are the A
    // fragment of k-step j; P is rounded to bf16 here.
#pragma unroll
    for (int j = 0; j < SBN / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16x2(sc[2 * j][0], sc[2 * j][1]);
      a[1] = pack_bf16x2(sc[2 * j][2], sc[2 * j][3]);
      a[2] = pack_bf16x2(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      a[3] = pack_bf16x2(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      const int r0 = j * 16 + tig * 2;
#pragma unroll
      for (int nb = 0; nb < DBLK; ++nb) {
        const int col = nb * 8 + grp;
        const uint32_t b0 =
            pack_raw(vs[r0 * LD + col], vs[(r0 + 1) * LD + col]);
        const uint32_t b1 =
            pack_raw(vs[(r0 + 8) * LD + col], vs[(r0 + 9) * LD + col]);
        mma_bf16(o[nb], a, b0, b1);
      }
    }
  }

  // Normalise and store (every row attended column 0, so l > 0).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint16_t* orp = out + orow[i];
#pragma unroll
    for (int nb = 0; nb < DBLK; ++nb) {
      *reinterpret_cast<uint32_t*>(orp + nb * 8 + tig * 2) =
          pack_bf16x2(o[nb][2 * i] / l[i], o[nb][2 * i + 1] / l[i]);
    }
  }
}

// float32: one warp per query row of 8 consecutive rows of one head; lane
// j owns features j, j+32, ...
constexpr int F32_ROWS = 8;
constexpr int F32_BN = 32;

template <int DPL>
__global__ void __launch_bounds__(F32_ROWS * 32)
splash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int T, int S, int H, int KVH, int offset, float scale) {
  constexpr int D = 32 * DPL;
  __shared__ float ks[F32_BN * D];
  __shared__ float vs[F32_BN * D];
  const int G = H / KVH;
  const int q0 = blockIdx.x * F32_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = q0 + warp;
  const int limit = t + offset;
  const int n_cols = min(S, q0 + F32_ROWS + offset);
  const size_t orow = ((size_t)(b * T + t) * H + h) * D;
  float qv[DPL], acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    qv[i] = q[orow + lane + 32 * i] * scale;  // q', float32
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < n_cols; s0 += F32_BN) {
    __syncthreads();
    for (int c = tid; c < F32_BN * D; c += F32_ROWS * 32) {
      const int row = c / D, col = c % D;
      const int s = s0 + row;
      const size_t g = ((size_t)(b * S + s) * KVH + kvh) * D + col;
      ks[c] = s < S ? k[g] * scale : 0.f;  // k', float32
      vs[c] = s < S ? v[g] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < F32_BN; ++j) {
      if (s0 + j > limit || s0 + j >= S) break;  // uniform across the warp
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) dot += qv[i] * ks[j * D + lane + 32 * i];
      const float s = warp_sum(dot) * LOG2E;
      const float m_new = fmaxf(m, s);
      const float alpha = exp2f(m - m_new);
      const float p = exp2f(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        acc[i] = acc[i] * alpha + p * vs[j * D + lane + 32 * i];
      }
      m = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) out[orow + lane + 32 * i] = acc[i] / l;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  scale =
// d^-0.25.  Returns the cudaError_t of the launch (0 on success).
// Launches on `stream` and does not synchronise.
extern "C" int splash_prefill(const void* q, const void* k, const void* v,
                              void* out, int B, int T, int S, int H, int KVH,
                              int D, int offset, int dtype, float scale,
                              void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 || B > 65535 ||
      H > 65535 || offset < 0 || T % SBM != 0 || S % SBN != 0 || D != 128) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    constexpr int bytes = smem_bytes<128>();
    static bool opted_in = false;  // above 48 KB: dynamic shared memory
    if (!opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          splash_bf16_kernel<128>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
      opted_in = true;
    }
    const dim3 grid(T / SBM, H, B);
    splash_bf16_kernel<128><<<grid, STHREADS, bytes, st>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), T, S,
        H, KVH, offset, scale);
  } else if (dtype == 0) {
    const dim3 grid(T / F32_ROWS, H, B);
    splash_f32_kernel<4><<<grid, F32_ROWS * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), T, S, H, KVH,
        offset, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

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
// multiples of 128 (the wrapper's rule, as `splash_eligible`'s).
//
// What bounds it on an H100: at the serving insert (B = 8, T = S = 1024,
// H = 32, d = 128, offset 0) the live (query, column) pairs need ~69
// GFLOP of tensor-core work, ~0.07 ms at the bf16 peak, against ~67 MB
// of q, k, v and out, ~0.02 ms of HBM: operations bound it.  The bf16
// instance is the flash forward's Hopper design (flash_fwd.cu, namespace
// wg) without position arrays, lse or dropout:
//   * A persistent grid: one block per SM walks the work items (128 query
//     rows of one query head of one row) i = blockIdx.x, + gridDim.x, ...,
//     late query tiles first (they hold the most live columns), so the
//     next item's Q and first K/V tiles load under the current item's
//     last tiles and stores.  384 threads: a producer warpgroup and two
//     consumer warpgroups of 64 rows.
//   * The producer keeps NST = 3 K/V stages in flight with TMA, issued by
//     one thread whose cursor runs ahead across items (4-D tensor maps
//     over [B, S, KVH, d], two 64-column boxes of 128 slots per tile,
//     128-byte swizzle); an item's Q lands once both consumer warpgroups
//     have issued their last product on the previous item's Q.  The mask
//     is the static offset alone: an item's walk ends at min(S, t0 + 128
//     + offset), so tiles wholly above the diagonal are never loaded.
//   * The two roundings, in shared memory.  TMA lands K unscaled; the
//     producer's four warps (one on each SM sub-partition) scale each
//     stage in place to k' = round(k d^-0.25) (elementwise, so the
//     swizzle does not matter), make their writes visible to the async
//     proxy (fence.proxy.async) and only then release the stage to the
//     consumers, whose wgmma reads it.  They scale tile t while the
//     consumers run tile t - 1, and the stage of t - 1 is refilled once
//     the consumers release it.  One producer warp scaling alone was
//     slower (PERF.md).  Each consumer warpgroup scales its own 64
//     rows of Q once the same way, then syncs on a named barrier of its
//     128 threads.
//   * S = Q'K'^T by wgmma m64n128k16 from shared memory; base-2 online
//     softmax in registers; the per-element mask only on a tile that
//     crosses a row's limit (column <= t + offset); O += P V by wgmma
//     with P from registers, rounded to bf16 (upstream splash keeps P in
//     float32: a difference of at most one bf16 rounding per term).
//   * Ping-pong between the two consumer warpgroups (FA3's schedule): two
//     named barriers make their S products alternate, so one warpgroup's
//     softmax overlaps the other's tensor-core work (PERF.md).
//   * 168 registers a thread at most (384 threads).
// The float32 instance (float32 activations) runs on the CUDA cores: one
// warp per query row, 32-column tiles.
// Not done yet (later work): a schedule that balances the causal
// triangle's uneven items across SMs by their cost (today: round robin,
// longest first), and overlap of one warpgroup's softmax with its own
// next S (registers: 168 a thread at most).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using flash::pack_bf16x2;
using flash::warp_sum;

constexpr float LOG2E = 1.4426950408889634f;

// Two bf16 values (one 32-bit word) times `s`, each rounded to bf16.
__device__ __forceinline__ uint32_t scale_word(uint32_t w, float s) {
  return pack_bf16x2(__uint_as_float(w << 16) * s,
                     __uint_as_float(w & 0xffff0000u) * s);
}

// 16 bytes of bf16 in shared memory scaled in place.
__device__ __forceinline__ void scale_16b(unsigned char* p, float s) {
  uint4* v = reinterpret_cast<uint4*>(p);
  uint4 x = *v;
  x.x = scale_word(x.x, s);
  x.y = scale_word(x.y, s);
  x.z = scale_word(x.z, s);
  x.w = scale_word(x.w, s);
  *v = x;
}

namespace sw {

constexpr int D = 128;
constexpr int BM = 128;               // query rows per block
constexpr int BN = 128;               // columns per K/V tile
constexpr int NST = 3;                // K/V stages
constexpr int NCONS = 256;             // two consumer warpgroups
constexpr int NPROD = 128;             // four producer warps
constexpr int NTHREADS = NCONS + NPROD;
constexpr int ROW = 128;              // bytes per swizzled row (64 bf16)
constexpr int Q_BYTES = BM * D * 2;
constexpr int KV_BYTES = BN * D * 2;  // one K or V tile: two 64-column boxes
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + Q_BYTES;
constexpr int OFF_V = OFF_K + NST * KV_BYTES;
// Barriers: Q landed, Q free, then load, full and empty per stage.
constexpr int OFF_BAR = OFF_V + NST * KV_BYTES;
constexpr int BYTES = OFF_BAR + (2 + 3 * NST) * 8;
constexpr int SMEM = BYTES + 1024;               // + slack to align to 1024
static_assert(SMEM <= 232448, "shared memory of one block");

// The producer's TMA loads of K/V tile (s0 .. s0 + BN) into stage s,
// counted on that stage's load barrier (the producer's first thread).
__device__ __forceinline__ void issue_kv(const CUtensorMap* tk,
                                         const CUtensorMap* tv, uint32_t base,
                                         int s, int s0, int kvh, int b) {
  using namespace hopper;
  const uint32_t bar = base + OFF_BAR + 8u * (2 + s);
  const uint32_t kd = base + OFF_K + s * KV_BYTES;
  const uint32_t vd = base + OFF_V + s * KV_BYTES;
  mbar_arrive_tx(bar, 2 * KV_BYTES);
  tma_load_4d(kd, tk, bar, 0, kvh, s0, b);
  tma_load_4d(kd + BN * ROW, tk, bar, 64, kvh, s0, b);
  tma_load_4d(vd, tv, bar, 0, kvh, s0, b);
  tma_load_4d(vd + BN * ROW, tv, bar, 64, kvh, s0, b);
}

// Work item i: 128 query rows (from t0) of query head h of row b, late
// query tiles first, and its K/V tile count.
struct Item {
  int t0, h, b, kvh, n;
  __device__ Item(int i, int B, int T, int S, int H, int G, int offset) {
    const int x = i % (B * H), y = i / (B * H);
    t0 = (T / BM - 1 - y) * BM;
    h = x % H;
    b = x / H;
    kvh = h / G;
    n = (min(S, t0 + BM + offset) + BN - 1) / BN;
  }
};

}  // namespace sw

__global__ void __launch_bounds__(sw::NTHREADS, 1)
splash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    uint16_t* __restrict__ out, int B, int T, int S, int H,
                    int KVH, int offset, float scale) {
  using namespace sw;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  // TMA boxes and swizzle atoms want 1024-byte alignment.
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  const uint32_t bar_q = base + OFF_BAR;          // Q landed
  const uint32_t bar_q_free = bar_q + 8u;         // Q read by both groups
  auto bar_load = [&](int s) { return bar_q + 8u * (2 + s); };
  auto bar_full = [&](int s) { return bar_q + 8u * (2 + NST + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (2 + 2 * NST + s); };

  const int G = H / KVH;
  const int n_items = B * H * (T / BM);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_free, NCONS);
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_load(s), 1);
      mbar_init(bar_full(s), NPROD);
      mbar_init(bar_empty(s), NCONS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NCONS / 32) {
    // Producer.  The first warp waits for released stages and its first
    // thread issues; the issue cursor (item ii, tile it) runs NST tiles
    // ahead of the scaling walk, across this block's items.  For each
    // tile g of the walk: wait for its bytes, scale K in place (all four
    // warps), release it to the consumers, and refill the stage of g - 1
    // with the cursor's next tile once the consumers have released g - 1.
    const int ptid = tid - NCONS;
    const bool issuer = ptid == 0, waiter = warp == NCONS / 32;
    int ii = blockIdx.x, it = 0, issued = 0;
    Item cur(ii < n_items ? ii : 0, B, T, S, H, G, offset);
    auto issue_next = [&]() {
      if (issuer) {
        issue_kv(&tk, &tv, base, issued % NST, it * BN, cur.kvh, cur.b);
      }
      ++issued;
      if (++it == cur.n) {
        it = 0;
        ii += gridDim.x;
        if (ii < n_items) cur = Item(ii, B, T, S, H, G, offset);
      }
    };
    for (int k = 0; k < NST && ii < n_items; ++k) issue_next();
    int g = 0;
    int k = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++k) {
      const Item item(i, B, T, S, H, G, offset);
      if (issuer) {
        if (k > 0) mbar_wait(bar_q_free, (k - 1) & 1u);
        mbar_arrive_tx(bar_q, Q_BYTES);
        tma_load_4d(base + OFF_Q, &tq, bar_q, 0, item.h, item.t0, item.b);
        tma_load_4d(base + OFF_Q + BM * ROW, &tq, bar_q, 64, item.h, item.t0,
                    item.b);
      }
      for (int t = 0; t < item.n; ++t, ++g) {
        const int s = g % NST;
        mbar_wait(bar_load(s), (g / NST) & 1u);
        unsigned char* kt = smem + OFF_K + s * KV_BYTES;
#pragma unroll 8
        for (int j = ptid; j < KV_BYTES / 16; j += NPROD) {
          scale_16b(kt + 16 * j, scale);
        }
        fence_proxy_async_shared();
        mbar_arrive(bar_full(s));
        const int u = g - 1;  // the tile whose stage is refilled next
        if (waiter && u >= 0 && ii < n_items) {
          mbar_wait(bar_empty(u % NST), (u / NST) & 1u);
          issue_next();
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wgi owns the item's rows [64 wgi, 64 wgi + 64);
  // in the wgmma accumulator, warp wl's lane holds rows 16 wl + lane/4
  // (+8) and columns 8 i + 2 (lane % 4) (+1) of chunk i.
  const int wgi = tid >> 7, wl = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const uint32_t qa = base + OFF_Q + wgi * 64 * ROW;
  int g = 0, k = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++k) {
    const Item item(i, B, T, S, H, G, offset);
    const int r_first = item.t0 + 64 * wgi;
    int limit[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      limit[r] = r_first + 16 * wl + grp + 8 * r + offset;
    }
    float o[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) o[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    // q' = round(q d^-0.25) for this warpgroup's 64 rows (both boxes).
    mbar_wait(bar_q, k & 1u);
    for (int j = tid & 127; j < 2 * 64 * ROW / 16; j += 128) {
      const int box = j / (64 * ROW / 16), c = j % (64 * ROW / 16);
      scale_16b(smem + OFF_Q + box * BM * ROW + wgi * 64 * ROW + 16 * c,
                scale);
    }
    fence_proxy_async_shared();
    named_bar_sync(1 + wgi, 128);

    // Ping-pong: warpgroup w issues its S products only after the other
    // has issued its own (named barrier 3 + w, which the other arrives
    // at), so one warpgroup's softmax runs under the other's products.
    // Both walk every tile (a tile past all of warpgroup 0's rows is
    // masked whole), so each barrier sees item.n syncs and item.n
    // arrivals an item: warpgroup 1 arrives once ahead and skips its last.
    if (wgi == 1) named_bar_arrive(3, NCONS);
    for (int t = 0; t < item.n; ++t, ++g) {
      const int s = g % NST, s0 = t * BN;
      mbar_wait(bar_full(s), (g / NST) & 1u);
      const bool full = s0 + BN - 1 <= r_first + offset;
      const uint32_t kb = base + OFF_K + s * KV_BYTES;
      const uint32_t vb = base + OFF_V + s * KV_BYTES;
      // S = Q'K'^T: 8 k-steps of 16, four in each 64-column box; within a
      // swizzled row a k-step is 32 bytes on from the last.
      float sc[64];
      named_bar_sync(3 + wgi, NCONS);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        wgmma_m64n128_ss(
            sc, sw128_desc(qa + (kk >> 2) * BM * ROW + off, 16, 1024),
            sw128_desc(kb + (kk >> 2) * BN * ROW + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      if (!(wgi == 1 && t == item.n - 1)) named_bar_arrive(4 - wgi, NCONS);
      wgmma_wait_all();
      reg_fence(sc);
      if (t == item.n - 1) mbar_arrive(bar_q_free);  // the item's Q is read

      // Base-2 scores; the offset mask only where the tile crosses a row's
      // limit; row max over the quad.  Every row attended column 0 in tile
      // 0, so the running max is finite from then on, and a tile masked
      // whole adds p = 0 with alpha = 1.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * LOG2E;
          if (!full && s0 + 8 * j + 2 * tig + (e & 1) > limit[e >> 1]) {
            x = -INFINITY;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
        for (int j = 0; j < 16; ++j) {
          o[4 * j + 2 * r] *= alpha;
          o[4 * j + 2 * r + 1] *= alpha;
        }
      }
      // P rounded to bf16 into the A fragments: chunks 2j, 2j+1 are k-step
      // j.
      uint32_t pa[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(sc[4 * j + e] - m_use[e >> 1]);
          l[e >> 1] += p[e];
        }
        pa[j >> 1][2 * (j & 1)] = pack_bf16x2(p[0], p[1]);
        pa[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(p[2], p[3]);
      }
      // O += P V: V is the MN-major B operand (d contiguous): 8 slots of
      // 128 bytes per swizzle atom (stride 1024 bytes along k), the second
      // 64 columns one box (BN rows) on; k-step j starts 16 rows on.
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wgmma_m64n128_rs(o, pa[j],
                         sw128_desc(vb + j * 16 * ROW, BN * ROW, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      mbar_arrive(bar_empty(s));
    }

    // Normalise and store (every row attended column 0, so l > 0).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r_first + 16 * wl + grp + 8 * r;
      uint16_t* orow = out + ((size_t)(item.b * T + t) * H + item.h) * D;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tig) =
            pack_bf16x2(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
      }
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

// The instance, as the C entry point reports it; the wrapper names it
// (``splash_instance_name``).
constexpr int INSTANCE_WGMMA = 1;
constexpr int INSTANCE_FLOAT32 = 2;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  scale =
// d^-0.25.  bf16 runs the Hopper instance: it encodes the three tensor
// maps (they hold the base pointers) for this call.  Returns the
// cudaError_t of the launch (0 on success), cudaErrorInvalidValue for a
// shape it does not take or a tensor map the encoder refuses.  Launches
// on `stream` and does not synchronise.  *instance is the instance
// launched once its launch succeeds (INSTANCE_WGMMA, INSTANCE_FLOAT32),
// 0 if none did.
extern "C" int splash_prefill(const void* q, const void* k, const void* v,
                              void* out, int B, int T, int S, int H, int KVH,
                              int D, int offset, int dtype, float scale,
                              void* stream, int* instance) {
  *instance = 0;
  if (B <= 0 || T <= 0 || S <= 0 || KVH <= 0 || H % KVH != 0 ||
      offset < 0 || T % sw::BM != 0 || S % sw::BN != 0 || D != sw::D ||
      (long)B * H * (T / sw::BM) > 2147483647L) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    CUtensorMap tq, tk, tv;
    if (!hopper::encode_bf16_4d(&tq, q, D, H, T, B, sw::BM) ||
        !hopper::encode_bf16_4d(&tk, k, D, KVH, S, B, sw::BN) ||
        !hopper::encode_bf16_4d(&tv, v, D, KVH, S, B, sw::BN)) {
      return (int)cudaErrorInvalidValue;
    }
    // Once per device: the opt-in above 48 KB of dynamic shared memory,
    // and the SM count that sizes the persistent grid (one block per SM,
    // or one per item).
    static int cached_device = -1, n_sm = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev != cached_device) {
      err = cudaFuncSetAttribute(splash_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 sw::SMEM);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                     dev);
      }
      if (err != cudaSuccess) return (int)err;
      cached_device = dev;
    }
    const long n_items = (long)B * H * (T / sw::BM);
    const unsigned grid = (unsigned)(n_items < n_sm ? n_items : n_sm);
    splash_wgmma_kernel<<<grid, sw::NTHREADS, sw::SMEM, st>>>(
        tq, tk, tv, static_cast<uint16_t*>(out), B, T, S, H, KVH, offset,
        scale);
    err = cudaGetLastError();
    if (err == cudaSuccess) *instance = INSTANCE_WGMMA;
    return (int)err;
  } else if (dtype == 0) {
    if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(T / F32_ROWS, H, B);
    splash_f32_kernel<4><<<grid, F32_ROWS * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), T, S, H, KVH,
        offset, scale);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) *instance = INSTANCE_FLOAT32;
    return (int)err;
  }
  return (int)cudaErrorInvalidValue;
}

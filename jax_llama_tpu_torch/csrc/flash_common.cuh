// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): bf16 mma.sync fragments, the positional mask's -1 remap,
// the block's live-KV-tile bound, and the dropout hash.
//
// The dropout hash is `_dropout_keep` / `_mix32` of
// jax_llama_tpu/ops/flash_attention.py (:81, :100), bit for bit: element
// (packed row r, kv slot c) of plane (batch b, KV head h) is kept iff
//   mix32(mix32(base_lo ^ r) ^ mix32(base_hi ^ (c * 0x9E3779B9))) >= thr
// with plane = mix32(b * 0x9E3779B9 + h * 0x85EBCA6B + 1),
// base_lo = mix32(seed_lo ^ plane), base_hi = mix32(seed_hi ^ plane ^
// 0x85EBCA6B) and thr = min(floor(rate * 2^32), 2^32 - 1).  It is a pure
// function of the global (row, slot), so the forward and both backward
// kernels, whatever their tiling, draw the same bits.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <math.h>

namespace flash {

constexpr int BM = 64;             // packed query rows per block
constexpr int BN = 64;             // kv slots per tile
constexpr int NWARPS = BM / 16;    // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dropout parameters of one launch; `inv` is 1 / (1 - rate).
struct Dropout {
  uint32_t seed_lo, seed_hi, threshold;
  float inv;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The per-(batch, KV head) row and column bases of the hash.
__device__ __forceinline__ void drop_bases(const Dropout& dp, uint32_t b,
                                           uint32_t h, uint32_t& base_lo,
                                           uint32_t& base_hi) {
  const uint32_t plane = mix32(b * 0x9E3779B9u + h * 0x85EBCA6Bu + 1u);
  base_lo = mix32(dp.seed_lo ^ plane);
  base_hi = mix32(dp.seed_hi ^ plane ^ 0x85EBCA6Bu);
}

__device__ __forceinline__ uint32_t row_word(uint32_t base_lo, uint32_t r) {
  return mix32(base_lo ^ r);
}

__device__ __forceinline__ uint32_t col_word(uint32_t base_hi, uint32_t c) {
  return mix32(base_hi ^ (c * 0x9E3779B9u));
}

__device__ __forceinline__ bool keep(uint32_t rw, uint32_t cw, uint32_t thr) {
  return mix32(rw ^ cw) >= thr;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// The A fragment of rows [r, r+16) x features [c, c+16) of a row-major
// bf16 tile in shared memory with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile,
                                       int ld, int r, int c) {
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const uint16_t* p0 = tile + (r + grp) * ld + c + tig * 2;
  const uint16_t* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// The score accumulators of n-blocks 2j, 2j+1 are the A fragment of
// k-step j; the values are rounded to bf16 here.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

__device__ __forceinline__ int remap_pos(int p) { return p < 0 ? INT_MAX : p; }

// Block-wide: the largest query position among rows [row0, row0+rows) of
// the packed plane, and the tile bound 1 + (last kv tile holding a slot
// with remapped position <= that maximum).  Needs blockDim.x >= rows.
__device__ __forceinline__ int kv_tile_bound(const int* __restrict__ q_pos,
                                             const int* __restrict__ kv_pos,
                                             int b, int T, int S, int R,
                                             int row0, int rows, int tile,
                                             int* qmax_s, int* last_s) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    *qmax_s = INT_MIN;
    *last_s = -1;
  }
  __syncthreads();
  if (tid < rows && row0 + tid < R) {
    atomicMax(qmax_s, q_pos[b * T + (row0 + tid) % T]);
  }
  __syncthreads();
  const int qmax = *qmax_s;
  int last = -1;
  for (int s = tid; s < S; s += blockDim.x) {
    if (remap_pos(kv_pos[(size_t)b * S + s]) <= qmax) last = s;
  }
  if (last >= 0) atomicMax(last_s, last);
  __syncthreads();
  return (*last_s + tile) / tile;  // 0 when no slot is live
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

}  // namespace flash

// Shared pieces of the WMMA flash-attention forward kernel (flash_fwd.cu).
//
// Layout: q/k/v/g are [B, S, H, D] row-major ("bshd", the port's public
// layout), read in place through the row stride H*D — no transposes. Row
// statistics m/l/d are [B, S, H] f32. Tiles are 64 rows; a block has 8 warps
// laid out as 4 row groups x 2 column halves. Shared-memory tiles carry a
// small pad on their leading dimension against bank conflicts; every pad
// keeps the 32-byte fragment alignment WMMA needs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace bft {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int NTHREADS = 256;   // 8 warps
constexpr float NEG = -1e30f;   // the JAX kernels' mask value (_NEG)
constexpr int LDS = BK + 4;     // f32 [BQ][BK] score tiles
constexpr int LDP = BK + 8;     // bf16 [BQ][BK] probability tiles

template <int D> struct Ld {
  static constexpr int H16 = D + 8;  // bf16 [64][D] tiles
  static constexpr int F32 = D + 4;  // f32 [64][D] tiles
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 64 rows of D bf16 (row r at src + r*stride) -> smem [64][D+8]; rows at or
// past `valid` are zero-filled (the ragged edge of the last tile).
template <int D>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src,
                                               long stride, int valid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Ld<D>::H16 + c * 8) = val;
  }
}

// smem f32 [64][D+4] -> the first `valid` rows at dst + r*stride.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst, const float* src,
                                               long stride, int valid) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < valid * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<float4*>(dst + r * stride + c * 4) =
        *reinterpret_cast<const float4*>(src + r * Ld<D>::F32 + c * 4);
  }
}

// Causal tile classes of 64x64 tiles, the JAX predicates (flash.py:138-143):
// a tile pair is LIVE unless the whole key tile lies after the last query
// row, and INTERIOR (no mask needed) when the whole key tile lies at or
// before the first query row. (The backward kernels, flash_bwd.cu, use
// their own tile sizes.)
__device__ __forceinline__ bool tile_live(int q_first, int k_first) {
  return k_first <= q_first + BQ - 1;
}
__device__ __forceinline__ bool tile_interior(int q_first, int k_first) {
  return k_first + BK - 1 <= q_first;
}

// S tile: warp (rw, ch) computes rows 16rw..16rw+15, key columns
// 32ch..32ch+31 of Q K^T (bf16 operands, f32 accumulation) into sS.
template <int D>
__device__ __forceinline__ void scores_qk(float* sS, const bf16* sQ, const bf16* sK,
                                          int rw, int ch) {
  constexpr int LDH = Ld<D>::H16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + 16 * rw * LDH + kk, LDH);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, sK + (32 * ch + 16 * j) * LDH + kk, LDH);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(sS + 16 * rw * LDS + 32 * ch + 16 * j, acc[j], LDS,
                            wmma::mem_row_major);
}

}  // namespace bft

// K1: flash-attention forward partials of a query tile against one K/V block.
//
// Replaces: bluefog_tpu/parallel/flash.py `_kernel` (:79-145), launched by
// `flash_block` (:148-213) on a (B*H, Sq/tq, Sk/tk) grid whose last axis the
// TPU runs in order, carrying the online softmax in the output refs.
//
// Computes, per (batch*head, query row):
//   s = (q . k^T) * scale            bf16 operands, f32 accumulation
//   m = rowmax(s),  l = rowsum(exp(s - m)),  o = sum exp(s - m) . V
// leaving o unnormalised (o / l is the attention output), so a later ring
// step can merge blocks. q_off/k_off are runtime ints: one build serves any
// global positions. Causal tiles come in the JAX kernel's three classes:
// dead tiles are skipped, interior tiles run unmasked, diagonal tiles mask
// with -1e30 and zero p (a row masked through a whole tile keeps m=-1e30,
// where exp(0)=1 would otherwise leak into l). The cast points are the JAX
// kernel's: the scale is applied after the product and p is rounded to bf16
// before P.V.
//
// Design on Hopper: blocks run in parallel in no order, so the sequential K
// axis becomes a loop inside the block. One block of 8 warps owns one
// (b*h, 64-row q tile) and walks the 64-row K/V tiles; the running o, m, l
// stay in shared memory (o is rescaled by alpha each tile, which WMMA's
// opaque accumulator layout cannot do in registers). Products are
// bf16 WMMA (16x16x16, f32 accumulate) on shared-memory tiles; the softmax
// is warp-per-row with shuffles. Ragged edges: the last q and k tiles are
// zero-filled and the columns past Sk are masked, so S need not divide 64.
// m/l are written [B, S, H] directly (no TPU lane-8 padding). Causal blocks
// are issued heaviest-first (last q tile first) to balance the tail.
//
// Bound on the H100 (B=1, H=16, S=8192, D=128, causal): tensor-core FLOPs,
// 2 products of 2*(S*S/2)*D*H = 2.7e11 FLOP -> 0.28 ms at 989 TFLOP/s;
// bytes (q, k, v in bf16, o/m/l out in f32) are 0.17 GB -> 0.05 ms at
// 3.35 TB/s, so the kernel is bound by operations.
// This simple kernel is far from that bound: no cp.async/TMA pipelining and
// WMMA rather than wgmma; those wait for a later change.
#include "flash_common.cuh"

namespace bft {

template <int D>
struct FwdSmem {
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(bf16) * BQ * Ld<D>::H16);
  static constexpr size_t v = align128(k + sizeof(bf16) * BK * Ld<D>::H16);
  static constexpr size_t o = align128(v + sizeof(bf16) * BK * Ld<D>::H16);
  static constexpr size_t s = align128(o + sizeof(float) * BQ * Ld<D>::F32);
  static constexpr size_t p = align128(s + sizeof(float) * BQ * LDS);
  static constexpr size_t stats = align128(p + sizeof(bf16) * BQ * LDP);
  static constexpr size_t bytes = align128(stats + sizeof(float) * 3 * BQ);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int Sq, int Sk, int H, int q_off, int k_off, int causal,
                 float scale) {
  constexpr int LDH = Ld<D>::H16;
  constexpr int LDF = Ld<D>::F32;
  constexpr int HALF = D / 2;
  constexpr int NJ = HALF / 16;
  using L = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sM = reinterpret_cast<float*>(smem + L::stats);
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp & 3, ch = warp >> 2;
  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long stride = (long)H * D;
  const int q0 = qi * BQ;
  const int q_valid = min(BQ, Sq - q0);
  const int q_first = q_off + q0;
  const bf16* kbase = k + (long)b * Sk * stride + (long)h * D;
  const bf16* vbase = v + (long)b * Sk * stride + (long)h * D;

  load_rows_bf16<D>(sQ, q + ((long)b * Sq + q0) * stride + (long)h * D, stride,
                    q_valid);
  for (int i = tid; i < BQ * D; i += NTHREADS) sO[(i / D) * LDF + i % D] = 0.f;
  if (tid < BQ) {
    sM[tid] = NEG;
    sL[tid] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k_first = k_off + kj * BK;
    bool masked = false;
    if (causal) {
      if (!tile_live(q_first, k_first)) break;  // later tiles are dead too
      masked = !tile_interior(q_first, k_first);
    }
    const int k_valid = min(BK, Sk - kj * BK);
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    load_rows_bf16<D>(sK, kbase + (long)kj * BK * stride, stride, k_valid);
    load_rows_bf16<D>(sV, vbase + (long)kj * BK * stride, stride, k_valid);
    __syncthreads();
    scores_qk<D>(sS, sQ, sK, rw, ch);
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7; lane owns columns lane and
    // lane+32 of each
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const int qpos = q_first + r;
      float s0 = sS[r * LDS + lane] * scale;
      float s1 = sS[r * LDS + lane + 32] * scale;
      bool a0 = lane < k_valid, a1 = lane + 32 < k_valid;
      if (masked) {
        a0 = a0 && qpos >= k_first + lane;
        a1 = a1 && qpos >= k_first + lane + 32;
      }
      if (!a0) s0 = NEG;
      if (!a1) s1 = NEG;
      const float m_prev = sM[r], l_prev = sL[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_prev - m_new);
      const float p0 = a0 ? expf(s0 - m_new) : 0.f;
      const float p1 = a1 ? expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = alpha * l_prev + psum;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // o = alpha * o + P.V on warp (rw, ch)'s rows 16rw.., columns ch*D/2..
    for (int i = lane; i < 16 * HALF; i += 32) {
      const int r = 16 * rw + i / HALF;
      sO[r * LDF + ch * HALF + i % HALF] *= sA[r];
    }
    __syncwarp();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wmma::load_matrix_sync(acc[j], sO + 16 * rw * LDF + ch * HALF + 16 * j, LDF,
                             wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sP + 16 * rw * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, sV + kk * LDH + ch * HALF + 16 * j, LDH);
        wmma::mma_sync(acc[j], a, bv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wmma::store_matrix_sync(sO + 16 * rw * LDF + ch * HALF + 16 * j, acc[j], LDF,
                              wmma::mem_row_major);
  }
  __syncthreads();

  store_rows_f32<D>(o + ((long)b * Sq + q0) * stride + (long)h * D, sO, stride,
                    q_valid);
  for (int r = tid; r < q_valid; r += NTHREADS) {
    const long idx = ((long)b * Sq + q0 + r) * H + h;
    m_out[idx] = sM[r];
    l_out[idx] = sL[r];
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o, void* m,
                  void* l, int B, int Sq, int Sk, int H, int q_off, int k_off,
                  int causal, float scale, cudaStream_t stream) {
  const size_t bytes = FwdSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), Sq, Sk, H, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace bft

extern "C" int bft_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* m, void* l, int B, int Sq, int Sk, int H, int D,
                             int q_off, int k_off, int causal, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bft::launch<64>(q, k, v, o, m, l, B, Sq, Sk, H, q_off, k_off, causal,
                           scale, s);
  if (D == 128)
    return bft::launch<128>(q, k, v, o, m, l, B, Sq, Sk, H, q_off, k_off, causal,
                            scale, s);
  return (int)cudaErrorInvalidValue;
}

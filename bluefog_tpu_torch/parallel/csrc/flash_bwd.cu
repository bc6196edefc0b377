// K2 + K3: flash-attention-2 backward of a query block against one K/V block.
//
// Replaces: bluefog_tpu/parallel/flash.py `_dq_kernel` (:283-311, pass 1 of
// `flash_block_bwd`, :391-413) and `_dkv_kernel` (:314-348, pass 2, :415-441),
// with their shared tile recompute `_bwd_tiles` (:216-267).
//
// Both passes rebuild the probability tile from the saved GLOBAL row stats
// (m, l) and d = sum(dO * O), with the forward's offset-based causal classes:
//   s   = (q . k^T) * scale               bf16 operands, f32 accumulation
//   p   = exp(s - m)  (zeroed where masked; unnormalised, in [0, 1])
//   g'  = g * inv_l                       g arrives in f32, stays f32
//   dp  = g' . V^T                        f32 g' x bf16 V
//   ds  = p * (dp - d * inv_l)            = dS of the normalised softmax
//   K2: dq = sum_k bf16(ds) . K * scale
//   K3: dv = sum_q p^T . g',   dk = sum_q bf16(ds)^T . Q * scale
// The cast points are the JAX kernels': g is f32 through g', dp and dv; ds
// is rounded to the bf16 input type for the dq and dk products. The two
// products with an f32 operand (dp and dv) run on TF32 tensor cores
// (10-bit mantissa, f32 accumulation): V is bf16 and so exact in TF32, and
// g' and p lose bits only below bf16's own precision of the outputs'
// consumers (the gradients are cast to bf16). A row whose l is 0 (no live
// key at all) gets inv_l = 0 rather than inf, in the kernel and in its plain
// version alike, so a dead row yields zero gradients.
//
// Design on Hopper: no sequential grid and no atomics. K2 gives one block
// of 8 warps to each (b*h, 64-row q tile) and loops over K/V tiles inside
// the block, dq accumulating in WMMA registers; K3 gives one block to each
// (b*h, 64-row k tile) and loops over q tiles, dk and dv accumulating in
// registers. Score, dp and ds tiles live in shared memory (~144 KB per
// block, dynamic, above the 48 KB static limit), each warp recomputing the
// elementwise part of exactly the 16x32 region its own products wrote, so
// only the products that cross warps need a block barrier. Ragged edges
// are zero-filled and masked, as in the forward.
//
// Bound on the H100 (B=1, H=16, S=8192, D=128, causal), tensor-core FLOPs
// at 989 TFLOP/s dense bf16 (the TF32 products run at half that rate):
// K2 runs 3 products (s, dp, dq) of 2*(S*S/2)*D*H = 1.37e11 FLOP each
// -> 0.42 ms; K3 runs 4 (s, dp, dv, dk) -> 0.56 ms. Bytes (q, k, v bf16,
// g f32, stats, f32 outputs) are ~0.2-0.3 GB -> under 0.1 ms, so both are
// bound by operations. This simple version is far from that bound (no
// copy pipelining, WMMA not wgmma, one block per SM for shared memory).
#include "flash_common.cuh"

namespace bft {

template <int D>
struct BwdSmem {
  static constexpr size_t a = 0;  // sQ (K2: the fixed q tile; K3: per step)
  static constexpr size_t b = align128(a + sizeof(bf16) * 64 * Ld<D>::H16);  // sK
  static constexpr size_t v = align128(b + sizeof(bf16) * 64 * Ld<D>::H16);  // sV f32
  static constexpr size_t g = align128(v + sizeof(float) * 64 * Ld<D>::F32);  // g' f32
  static constexpr size_t s = align128(g + sizeof(float) * 64 * Ld<D>::F32);
  static constexpr size_t dp = align128(s + sizeof(float) * BQ * LDS);
  static constexpr size_t ds = align128(dp + sizeof(float) * BQ * LDS);
  static constexpr size_t stats = align128(ds + sizeof(bf16) * BQ * LDP);
  static constexpr size_t bytes = align128(stats + sizeof(float) * 3 * BQ);
};

// Row stats of the q tile: m, inv_l (0 where l == 0), d * inv_l.
__device__ __forceinline__ void load_row_stats(float* sM, float* sIL, float* sDL,
                                               const float* m, const float* l,
                                               const float* d, long base, int H,
                                               int valid) {
  const int r = threadIdx.x;
  if (r < BQ) {
    float mv = 0.f, il = 0.f, dl = 0.f;
    if (r < valid) {
      const long idx = base + (long)r * H;
      const float lv = l[idx];
      mv = m[idx];
      il = lv > 0.f ? 1.0f / lv : 0.f;
      dl = d[idx] * il;
    }
    sM[r] = mv;
    sIL[r] = il;
    sDL[r] = dl;
  }
}

// dp tile: warp (rw, ch) computes rows 16rw.., key columns 32ch.. of
// g' . V^T on TF32 tensor cores into sDP.
template <int D>
__device__ __forceinline__ void scores_dp(float* sDP, const float* sG, const float* sV,
                                          int rw, int ch) {
  constexpr int LDF = Ld<D>::F32;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 8) {
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> a;
    wmma::load_matrix_sync(a, sG + 16 * rw * LDF + kk, LDF);
    to_tf32(a);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::col_major> bv;
      wmma::load_matrix_sync(bv, sV + (32 * ch + 16 * j) * LDF + kk, LDF);
      to_tf32(bv);
      wmma::mma_sync(acc[j], a, bv, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(sDP + 16 * rw * LDS + 32 * ch + 16 * j, acc[j], LDS,
                            wmma::mem_row_major);
}

// Elementwise recompute on warp (rw, ch)'s own 16x32 region: p (optionally
// written back over s) and ds in bf16.
__device__ __forceinline__ void probs_and_ds(float* sS, const float* sDP, bf16* sDS,
                                             const float* sM, const float* sDL,
                                             int rw, int ch, int lane, float scale,
                                             bool masked, int q_first, int k_first,
                                             int q_valid, int k_valid, bool keep_p) {
  const int c = 32 * ch + lane;
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * rw + i;
    bool allowed = r < q_valid && c < k_valid;
    if (masked) allowed = allowed && q_first + r >= k_first + c;
    const float s = sS[r * LDS + c] * scale;
    const float p = allowed ? expf(s - sM[r]) : 0.f;
    const float ds = p * (sDP[r * LDS + c] - sDL[r]);
    if (keep_p) sS[r * LDS + c] = p;
    sDS[r * LDP + c] = __float2bfloat16(ds);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ d, float* __restrict__ dq, int Sq,
                    int Sk, int H, int q_off, int k_off, int causal, float scale) {
  constexpr int LDH = Ld<D>::H16;
  constexpr int LDF = Ld<D>::F32;
  constexpr int HALF = D / 2;
  constexpr int NJ = HALF / 16;
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::a);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::b);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sG = reinterpret_cast<float*>(smem + L::g);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sM = reinterpret_cast<float*>(smem + L::stats);
  float* sIL = sM + BQ;
  float* sDL = sIL + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp & 3, ch = warp >> 2;
  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long stride = (long)H * D;
  const int q0 = qi * BQ;
  const int q_valid = min(BQ, Sq - q0);
  const int q_first = q_off + q0;
  const long qrow = ((long)b * Sq + q0) * stride + (long)h * D;
  const bf16* kbase = k + (long)b * Sk * stride + (long)h * D;
  const bf16* vbase = v + (long)b * Sk * stride + (long)h * D;

  load_row_stats(sM, sIL, sDL, m, l, d, ((long)b * Sq + q0) * H + h, H, q_valid);
  load_rows_bf16<D>(sQ, q + qrow, stride, q_valid);
  __syncthreads();
  load_rows_f32_scaled<D>(sG, g + qrow, stride, q_valid, sIL);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int nk = (Sk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k_first = k_off + kj * BK;
    bool masked = false;
    if (causal) {
      if (!tile_live(q_first, k_first)) break;  // later tiles are dead too
      masked = !tile_interior(q_first, k_first);
    }
    const int k_valid = min(BK, Sk - kj * BK);
    __syncthreads();  // the previous tile's readers of sK/sV/sDS are done
    load_rows_bf16<D>(sK, kbase + (long)kj * BK * stride, stride, k_valid);
    load_rows_bf16_as_f32<D>(sV, vbase + (long)kj * BK * stride, stride, k_valid);
    __syncthreads();
    scores_qk<D>(sS, sQ, sK, rw, ch);
    scores_dp<D>(sDP, sG, sV, rw, ch);
    __syncwarp();
    probs_and_ds(sS, sDP, sDS, sM, sDL, rw, ch, lane, scale, masked, q_first,
                 k_first, q_valid, k_valid, false);
    __syncthreads();
    // dq += ds . K on warp (rw, ch)'s rows 16rw.., columns ch*D/2..
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sDS + 16 * rw * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
        wmma::load_matrix_sync(bk, sK + kk * LDH + ch * HALF + 16 * j, LDH);
        wmma::mma_sync(acc[j], a, bk, acc[j]);
      }
    }
  }
  __syncthreads();  // sG becomes the output staging tile
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int t = 0; t < acc[j].num_elements; ++t) acc[j].x[t] *= scale;
    wmma::store_matrix_sync(sG + 16 * rw * LDF + ch * HALF + 16 * j, acc[j], LDF,
                            wmma::mem_row_major);
  }
  __syncthreads();
  store_rows_f32<D>(dq + qrow, sG, stride, q_valid);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ d, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int H, int q_off,
                     int k_off, int causal, float scale) {
  constexpr int LDH = Ld<D>::H16;
  constexpr int LDF = Ld<D>::F32;
  constexpr int HALF = D / 2;
  constexpr int NJ = HALF / 16;
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::a);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::b);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sG = reinterpret_cast<float*>(smem + L::g);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds);
  float* sM = reinterpret_cast<float*>(smem + L::stats);
  float* sIL = sM + BQ;
  float* sDL = sIL + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp & 3, ch = warp >> 2;
  const int kj = blockIdx.x;  // low k tiles carry the most causal work
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long stride = (long)H * D;
  const int k0 = kj * BK;
  const int k_valid = min(BK, Sk - k0);
  const int k_first = k_off + k0;
  const long krow = ((long)b * Sk + k0) * stride + (long)h * D;

  load_rows_bf16<D>(sK, k + krow, stride, k_valid);
  load_rows_bf16_as_f32<D>(sV, v + krow, stride, k_valid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_dk[NJ];
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc_dv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::fill_fragment(acc_dk[j], 0.f);
    wmma::fill_fragment(acc_dv[j], 0.f);
  }

  const int nq = (Sq + BQ - 1) / BQ;
  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * BQ;
    const int q_first = q_off + q0;
    bool masked = false;
    if (causal) {
      if (!tile_live(q_first, k_first)) continue;  // whole k tile in the future
      masked = !tile_interior(q_first, k_first);
    }
    const int q_valid = min(BQ, Sq - q0);
    const long qrow = ((long)b * Sq + q0) * stride + (long)h * D;
    __syncthreads();  // the previous step's readers of sQ/sG/sS/sDS are done
    load_row_stats(sM, sIL, sDL, m, l, d, ((long)b * Sq + q0) * H + h, H, q_valid);
    load_rows_bf16<D>(sQ, q + qrow, stride, q_valid);
    __syncthreads();
    load_rows_f32_scaled<D>(sG, g + qrow, stride, q_valid, sIL);
    __syncthreads();
    scores_qk<D>(sS, sQ, sK, rw, ch);
    scores_dp<D>(sDP, sG, sV, rw, ch);
    __syncwarp();
    probs_and_ds(sS, sDP, sDS, sM, sDL, rw, ch, lane, scale, masked, q_first,
                 k_first, q_valid, k_valid, true);
    __syncthreads();
    // warp (rw, ch) owns k rows 16rw.., columns ch*D/2.. of dk and dv
#pragma unroll
    for (int kk = 0; kk < BQ; kk += 8) {  // dv += p^T . g'  (TF32)
      wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major> a;
      wmma::load_matrix_sync(a, sS + kk * LDS + 16 * rw, LDS);
      to_tf32(a);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> bg;
        wmma::load_matrix_sync(bg, sG + kk * LDF + ch * HALF + 16 * j, LDF);
        to_tf32(bg);
        wmma::mma_sync(acc_dv[j], a, bg, acc_dv[j]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ; kk += 16) {  // dk += ds^T . q  (bf16)
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, sDS + kk * LDP + 16 * rw, LDP);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bq;
        wmma::load_matrix_sync(bq, sQ + kk * LDH + ch * HALF + 16 * j, LDH);
        wmma::mma_sync(acc_dk[j], a, bq, acc_dk[j]);
      }
    }
  }
  __syncthreads();  // sG becomes the output staging tile
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int t = 0; t < acc_dk[j].num_elements; ++t) acc_dk[j].x[t] *= scale;
    wmma::store_matrix_sync(sG + 16 * rw * LDF + ch * HALF + 16 * j, acc_dk[j], LDF,
                            wmma::mem_row_major);
  }
  __syncthreads();
  store_rows_f32<D>(dk + krow, sG, stride, k_valid);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    wmma::store_matrix_sync(sG + 16 * rw * LDF + ch * HALF + 16 * j, acc_dv[j], LDF,
                            wmma::mem_row_major);
  __syncthreads();
  store_rows_f32<D>(dv + krow, sG, stride, k_valid);
}

template <typename Kernel>
static int prepare(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int D>
static int launch_dq(const void* q, const void* k, const void* v, const void* g,
                     const void* m, const void* l, const void* d, void* dq, int B,
                     int Sq, int Sk, int H, int q_off, int k_off, int causal,
                     float scale, cudaStream_t stream) {
  const size_t bytes = BwdSmem<D>::bytes;
  int err = prepare(flash_bwd_dq_kernel<D>, bytes);
  if (err) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(d), static_cast<float*>(dq), Sq, Sk, H, q_off, k_off,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dkv(const void* q, const void* k, const void* v, const void* g,
                      const void* m, const void* l, const void* d, void* dk, void* dv,
                      int B, int Sq, int Sk, int H, int q_off, int k_off, int causal,
                      float scale, cudaStream_t stream) {
  const size_t bytes = BwdSmem<D>::bytes;
  int err = prepare(flash_bwd_dkv_kernel<D>, bytes);
  if (err) return err;
  const dim3 grid((Sk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(d), static_cast<float*>(dk), static_cast<float*>(dv),
      Sq, Sk, H, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace bft

extern "C" int bft_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const void* m, const void* l,
                                const void* d, void* dq, int B, int Sq, int Sk, int H,
                                int D, int q_off, int k_off, int causal, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bft::launch_dq<64>(q, k, v, g, m, l, d, dq, B, Sq, Sk, H, q_off, k_off,
                              causal, scale, s);
  if (D == 128)
    return bft::launch_dq<128>(q, k, v, g, m, l, d, dq, B, Sq, Sk, H, q_off, k_off,
                               causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bft_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* m, const void* l,
                                 const void* d, void* dk, void* dv, int B, int Sq,
                                 int Sk, int H, int D, int q_off, int k_off,
                                 int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bft::launch_dkv<64>(q, k, v, g, m, l, d, dk, dv, B, Sq, Sk, H, q_off,
                               k_off, causal, scale, s);
  if (D == 128)
    return bft::launch_dkv<128>(q, k, v, g, m, l, d, dk, dv, B, Sq, Sk, H, q_off,
                                k_off, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K2 + K3: flash-attention-2 backward of a query block against one K/V block,
// written for Hopper (wgmma, TMA, mbarriers, bf16 operands).
//
// Replaces: bluefog_tpu/parallel/flash.py `_dq_kernel` (:283-311, pass 1 of
// `flash_block_bwd`, :391-413) and `_dkv_kernel` (:314-348, pass 2, :415-441),
// with their shared tile recompute `_bwd_tiles` (:216-267).
//
// Both passes rebuild the normalised probabilities from the saved GLOBAL row
// stats, with the forward's offset-based causal classes:
//   s   = q . k^T                          bf16 operands, f32 accumulation
//   P   = exp2(s * scale * log2(e) - lse2) = exp(s*scale - m) / l
//   dp  = g_b . V^T                         g_b = bf16(g), bf16 products
//   ds  = P * (dp - d)
//   K2: dq = sum_k bf16(ds) . K * scale
//   K3: dv = sum_q bf16(P)^T . g_b,   dk = sum_q bf16(ds)^T . Q * scale
// This equals JAX's p_un * (dp * inv_l - d * inv_l) and p_un^T . (g * inv_l).
// The wrapper (flash.py `_bwd_operands`) casts g to bf16 once per call (exact
// on the main path, whose g is the widened cotangent of a bf16 output) and
// packs [B*H, Sq_pad, 2] f32 row stats (lse2, d), lse2 = m*log2(e) + log2(l):
// +inf where l == 0 (a row with no live key gets zero gradients) and on the
// pad rows past Sq, so P is 0 there with no mask.
//
// Bound on the H100 (B=1, H=16, S=8192, D=128, causal), tensor-core FLOPs at
// 989 TFLOP/s dense bf16: K2 runs 3 products (s, dp, dq) of
// 2*(S*S/2)*D*H = 1.37e11 FLOP each -> 0.417 ms; K3 runs 4 (s, dp, dv, dk)
// -> 0.556 ms. Bytes (~0.2-0.3 GB) take under 0.1 ms at 3.35 TB/s, so both
// are bound by operations.
//
// Design. Each block has three warpgroups: two consumers of 64 rows each and
// a producer whose one thread issues every copy (setmaxnreg gives the
// consumers 240 registers and the producer 24).
//   K2: a block owns (b*h, 128 q rows). Q and g_b are loaded once; 64-row K
//     and V tiles stream through a ring of STAGES buffers, each filled by TMA
//     and completed on a "full" mbarrier, released by the consumers on an
//     "empty" one. S = Q.K^T and dP = g_b.V^T are SS wgmma (both operands
//     in shared memory); P and dS are built in registers from the
//     accumulator fragments; dQ += dS.K is RS wgmma (A from registers, K
//     read MN-major). dq stays in registers until the f32 store.
//   K3: a block owns (b*h, 128 k rows). K and V are loaded once; 64-row Q
//     and g_b tiles and their row stats (a bulk copy) stream through the
//     ring. The transposed products S^T = K.Q^T and dP^T = V.g_b^T give
//     accumulators with k rows, so P^T and dS^T feed dV += P^T.g_b and
//     dK += dS^T.Q as RS wgmma directly. dk and dv stay in registers.
//   In both, a consumer commits S and dP as two groups and computes P while
//   dP runs on the tensor cores.
// What this does about the four limits of the earlier WMMA version: copies
// are asynchronous (TMA) and run ahead of the products by the ring's depth,
// with no block barrier in the loop; every product is wgmma on 128-byte
// swizzled tiles, with S, dP and dS never leaving registers; every operand
// is bf16 (no TF32, no f32 V or g tile, no transposed copy: wgmma reads the
// same bytes K-major or MN-major); and the block keeps ~130 KB of shared
// memory at D=128, with K3 streaming the 2-byte g_b instead of rescaling
// the f32 g of every q tile.
//
// No atomics and no second pass; runtime q_off/k_off; causal tiles are dead
// (skipped), interior (unmasked) or diagonal (masked, P zeroed), per
// consumer warpgroup; a ragged last K tile is zero-filled by TMA and masked.
// Blocks are issued heaviest-first. Outputs are bit-identical across
// launches (a fixed order of products per element).
#include "hopper.cuh"

namespace bft {

using namespace hopper;

constexpr int ROWS = 64;           // rows of one consumer warpgroup, of a streamed tile
constexpr int BLOCK_ROWS = 128;    // rows a block owns (two consumer warpgroups)
constexpr int STAGES = 2;          // depth of the copy ring
constexpr int THREADS = 384;       // two consumer warpgroups + one producer

// Byte offsets into the (1024-aligned) dynamic shared memory: the two
// 128-row operands loaded once (`big` each), then the ring, whose stages hold
// two 64-row tiles (`tile` each) and K3's row stats, then the mbarriers.
template <int D>
struct BwdLayout {
  static constexpr int NR = D / 64;                          // regions per row
  static constexpr uint32_t big_region = BLOCK_ROWS * REGION_ROW;   // 16 KB
  static constexpr uint32_t tile_region = ROWS * REGION_ROW;        // 8 KB
  static constexpr uint32_t big = NR * big_region;           // one [128, D] tile
  static constexpr uint32_t tile = NR * tile_region;         // one [64, D] tile
  static constexpr uint32_t stats = ROWS * 8;                // (lse2, d) x 64 rows
  static constexpr uint32_t stage = 2 * tile + 1024;         // two tiles + stats, aligned
  static constexpr uint32_t ring = 2 * big;
  static constexpr uint32_t bars = ring + STAGES * stage;
  static constexpr uint32_t bytes = bars + 8 * (2 * STAGES + 1) + 1024;  // + alignment slack
};

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_g,
                    const float2* __restrict__ stats, float* __restrict__ dq, int Sq,
                    int Sk, int Sq_pad, int H, int q_off, int k_off, int causal,
                    float scale) {
  using L = BwdLayout<D>;
  constexpr int NR = L::NR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t sQ = base, sG = base + L::big;
  const uint32_t full = base + L::bars, empty = full + 8 * STAGES, once = empty + 8 * STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = qt * BLOCK_ROWS;
  const int nk = (Sk + ROWS - 1) / ROWS;
  const int n_iter = causal ? live_prefix(q_off + q0, BLOCK_ROWS, k_off, nk, ROWS) : nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(once, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    reg_dealloc<24>();
    if (threadIdx.x == 256 && n_iter > 0) {
      mbar_arrive_expect_tx(once, 2 * L::big);
      for (int r = 0; r < NR; ++r) {
        tma_load_4d(sQ + r * L::big_region, &tm_q, once, 64 * r, h, q0, b);
        tma_load_4d(sG + r * L::big_region, &tm_g, once, 64 * r, h, q0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t sK = base + L::ring + s * L::stage, sV = sK + L::tile;
        mbar_arrive_expect_tx(full + 8 * s, 2 * L::tile);
        for (int r = 0; r < NR; ++r) {
          tma_load_4d(sK + r * L::tile_region, &tm_k, full + 8 * s, 64 * r, h, it * ROWS, b);
          tma_load_4d(sV + r * L::tile_region, &tm_v, full + 8 * s, 64 * r, h, it * ROWS, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64*wg ..
    reg_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = 64 * wg + 16 * warp + lane / 4;  // and row + 8
    const float2 st_lo = stats[(size_t)bh * Sq_pad + q0 + row];
    const float2 st_hi = stats[(size_t)bh * Sq_pad + q0 + row + 8];
    const int qw_first = q_off + q0 + 64 * wg;
    const int qpos = q_off + q0 + row;
    const float c = scale * LOG2E;
    const uint32_t aQ = sQ + 64 * wg * REGION_ROW, aG = sG + 64 * wg * REGION_ROW;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    if (n_iter > 0) mbar_wait(once, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const uint32_t sK = base + L::ring + s * L::stage, sV = sK + L::tile;
      const int k_first = k_off + it * ROWS;
      const int k_valid = min(ROWS, Sk - it * ROWS);
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      if (!causal || k_first <= qw_first + ROWS - 1) {  // live for this warpgroup
        const bool masked =
            k_valid < ROWS || (causal && k_first + ROWS - 1 > qw_first);
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;
          wgmma_ss_n64<0>(sc, desc_k_major(aQ + (ks / 4) * L::big_region + off),
                          desc_k_major(sK + (ks / 4) * L::tile_region + off), ks > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;
          wgmma_ss_n64<0>(dp, desc_k_major(aG + (ks / 4) * L::big_region + off),
                          desc_k_major(sV + (ks / 4) * L::tile_region + off), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // S is done; P is computed while dP runs
        fence_regs(sc);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool hi = (i / 2) % 2;
          float p = ex2(fmaf(sc[i], c, -(hi ? st_hi.x : st_lo.x)));
          if (masked) {
            const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
            if (col >= k_valid || (causal && qpos + 8 * hi < k_first + col)) p = 0.f;
          }
          sc[i] = p;
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= dp[i] - ((i / 2) % 2 ? st_hi.y : st_lo.y);  // dS
        uint32_t a[4][4];
        to_a_frags(sc, a);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint64_t db = desc_mn_major(sK + t * 16 * REGION_ROW, L::tile_region);
          if constexpr (D == 128)
            wgmma_rs_n128<1>(acc, a[t], db, 1);
          else
            wgmma_rs_n64<1>(acc, a[t], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // f32 store: element i at row (+8 for (i/2)%2), column 8*(i/4) + 2*(lane%4)
    const long stride = (long)H * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + row + 8 * half;
      if (r < Sq) {
        float* out = dq + ((long)b * Sq + r) * stride + (long)h * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_g,
                     const float2* __restrict__ stats, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int Sq_pad, int H,
                     int q_off, int k_off, int causal, float scale) {
  using L = BwdLayout<D>;
  constexpr int NR = L::NR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t sK = base, sV = base + L::big;
  const uint32_t full = base + L::bars, empty = full + 8 * STAGES, once = empty + 8 * STAGES;

  const int kt = blockIdx.y;  // low k tiles carry the most causal work
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = kt * BLOCK_ROWS;
  const int nq = (Sq + ROWS - 1) / ROWS;
  // live q tiles form a suffix: the first one whose last row reaches k0
  int qi0 = 0;
  if (causal) {
    const int t = k_off + k0 - q_off - (ROWS - 1);
    qi0 = t <= 0 ? 0 : min(nq, (t + ROWS - 1) / ROWS);
  }
  const int n_iter = nq - qi0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(once, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    reg_dealloc<24>();
    if (threadIdx.x == 256 && n_iter > 0) {
      mbar_arrive_expect_tx(once, 2 * L::big);
      for (int r = 0; r < NR; ++r) {
        tma_load_4d(sK + r * L::big_region, &tm_k, once, 64 * r, h, k0, b);
        tma_load_4d(sV + r * L::big_region, &tm_v, once, 64 * r, h, k0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int q0 = (qi0 + it) * ROWS;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t sQ = base + L::ring + s * L::stage, sG = sQ + L::tile;
        mbar_arrive_expect_tx(full + 8 * s, 2 * L::tile + L::stats);
        for (int r = 0; r < NR; ++r) {
          tma_load_4d(sQ + r * L::tile_region, &tm_q, full + 8 * s, 64 * r, h, q0, b);
          tma_load_4d(sG + r * L::tile_region, &tm_g, full + 8 * s, 64 * r, h, q0, b);
        }
        bulk_load(sG + L::tile, stats + (size_t)bh * Sq_pad + q0, L::stats, full + 8 * s);
      }
    }
  } else {  // consumers: warpgroup wg owns k rows k0 + 64*wg ..
    reg_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = 64 * wg + 16 * warp + lane / 4;  // and row + 8
    const int kw_first = k_off + k0 + 64 * wg;
    const int kpos = k_off + k0 + row;
    const float c = scale * LOG2E;
    const uint32_t aK = sK + 64 * wg * REGION_ROW, aV = sV + 64 * wg * REGION_ROW;

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    if (n_iter > 0) mbar_wait(once, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const uint32_t sQ = base + L::ring + s * L::stage, sG = sQ + L::tile;
      const float2* st = reinterpret_cast<const float2*>(smem + L::ring + s * L::stage +
                                                         2 * L::tile);
      const int q_first = q_off + (qi0 + it) * ROWS;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      if (!causal || kw_first <= q_first + ROWS - 1) {  // live for this warpgroup
        const bool masked = causal && kw_first + ROWS - 1 > q_first;
        float sc[32], dp[32];  // S^T, dP^T: k rows x q columns
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;
          wgmma_ss_n64<0>(sc, desc_k_major(aK + (ks / 4) * L::big_region + off),
                          desc_k_major(sQ + (ks / 4) * L::tile_region + off), ks > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;
          wgmma_ss_n64<0>(dp, desc_k_major(aV + (ks / 4) * L::big_region + off),
                          desc_k_major(sG + (ks / 4) * L::tile_region + off), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // S^T is done; P^T is computed while dP^T runs
        fence_regs(sc);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);  // q row of the tile
          float p = ex2(fmaf(sc[i], c, -st[col].x));
          if (masked && q_first + col < kpos + 8 * ((i / 2) % 2)) p = 0.f;
          sc[i] = p;
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          dp[i] = sc[i] * (dp[i] - st[col].y);  // dS^T
        }
        uint32_t ap[4][4], ads[4][4];
        to_a_frags(sc, ap);
        to_a_frags(dp, ads);
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint64_t dg = desc_mn_major(sG + t * 16 * REGION_ROW, L::tile_region);
          const uint64_t dqd = desc_mn_major(sQ + t * 16 * REGION_ROW, L::tile_region);
          if constexpr (D == 128) {
            wgmma_rs_n128<1>(acc_dv, ap[t], dg, 1);
            wgmma_rs_n128<1>(acc_dk, ads[t], dqd, 1);
          } else {
            wgmma_rs_n64<1>(acc_dv, ap[t], dg, 1);
            wgmma_rs_n64<1>(acc_dk, ads[t], dqd, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_dv);
        fence_regs(acc_dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    const long stride = (long)H * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = k0 + row + 8 * half;
      if (r < Sk) {
        const long at = ((long)b * Sk + r) * stride + (long)h * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int i = 4 * j + 2 * half;
          *reinterpret_cast<float2*>(dk + at + 8 * j) =
              make_float2(acc_dk[i] * scale, acc_dk[i + 1] * scale);
          *reinterpret_cast<float2*>(dv + at + 8 * j) = make_float2(acc_dv[i], acc_dv[i + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static int pad_rows(int S) { return (S + BLOCK_ROWS - 1) / BLOCK_ROWS * BLOCK_ROWS; }

template <int D>
static int launch_dq(const void* q, const void* k, const void* v, const void* g_b,
                     const void* stats, void* dq, int B, int Sq, int Sk, int H,
                     int q_off, int k_off, int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg;
  int err = make_map(&mq, q, B, Sq, H, D, BLOCK_ROWS);
  if (!err) err = make_map(&mk, k, B, Sk, H, D, ROWS);
  if (!err) err = make_map(&mv, v, B, Sk, H, D, ROWS);
  if (!err) err = make_map(&mg, g_b, B, Sq, H, D, BLOCK_ROWS);
  if (err) return err;
  const uint32_t bytes = BwdLayout<D>::bytes;
  err = (int)cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  const dim3 grid(B * H, (Sq + BLOCK_ROWS - 1) / BLOCK_ROWS);
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, mg, static_cast<const float2*>(stats), static_cast<float*>(dq), Sq, Sk,
      pad_rows(Sq), H, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dkv(const void* q, const void* k, const void* v, const void* g_b,
                      const void* stats, void* dk, void* dv, int B, int Sq, int Sk, int H,
                      int q_off, int k_off, int causal, float scale,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mg;
  int err = make_map(&mq, q, B, Sq, H, D, ROWS);
  if (!err) err = make_map(&mk, k, B, Sk, H, D, BLOCK_ROWS);
  if (!err) err = make_map(&mv, v, B, Sk, H, D, BLOCK_ROWS);
  if (!err) err = make_map(&mg, g_b, B, Sq, H, D, ROWS);
  if (err) return err;
  const uint32_t bytes = BwdLayout<D>::bytes;
  err = (int)cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  const dim3 grid(B * H, (Sk + BLOCK_ROWS - 1) / BLOCK_ROWS);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, mg, static_cast<const float2*>(stats), static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, pad_rows(Sq), H, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace bft

// g_b: bf16 [B, Sq, H, D]; stats: f32 [B*H, Sq_pad, 2] (lse2, d), Sq_pad = Sq
// rounded up to 128 (flash.py `_bwd_operands`).
extern "C" int bft_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g_b, const void* stats, void* dq, int B,
                                int Sq, int Sk, int H, int D, int q_off, int k_off,
                                int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bft::launch_dq<64>(q, k, v, g_b, stats, dq, B, Sq, Sk, H, q_off, k_off, causal,
                              scale, s);
  if (D == 128)
    return bft::launch_dq<128>(q, k, v, g_b, stats, dq, B, Sq, Sk, H, q_off, k_off, causal,
                               scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bft_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g_b, const void* stats, void* dk, void* dv,
                                 int B, int Sq, int Sk, int H, int D, int q_off, int k_off,
                                 int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return bft::launch_dkv<64>(q, k, v, g_b, stats, dk, dv, B, Sq, Sk, H, q_off, k_off,
                               causal, scale, s);
  if (D == 128)
    return bft::launch_dkv<128>(q, k, v, g_b, stats, dk, dv, B, Sq, Sk, H, q_off, k_off,
                                causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

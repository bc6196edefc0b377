// K1: flash-attention forward partials of a query block against one K/V block,
// written for Hopper (wgmma, TMA, mbarriers, online softmax in registers).
//
// Replaces: bluefog_tpu/parallel/flash.py `_kernel` (:79-145), launched by
// `flash_block` (:148-213) on a (B*H, Sq/tq, Sk/tk) grid whose last axis the
// TPU runs in order, carrying the online softmax in the output refs.
//
// Computes, per (batch*head, query row):
//   s = (q . k^T) * scale            bf16 operands, f32 accumulation
//   m = rowmax(s),  l = rowsum(exp(s - m)),  o = sum bf16(exp(s - m)) . V
// leaving o unnormalised (o / l is the attention output), so a later ring
// step can merge blocks. q_off/k_off are runtime ints: one build serves any
// global positions. The cast points are the JAX kernel's: the scale is
// applied after the product, m is kept in scaled units, p is rounded to bf16
// at the running max before P.V, and l sums the unrounded p. A row with no
// live key keeps m = -1e30, l = 0, o = 0, as in the JAX kernel.
//
// Bound on the H100 (B=1, H=16, S=8192, D=128, causal): tensor-core FLOPs,
// 2 products of 2*(S*S/2)*D*H = 2.7e11 FLOP -> 0.28 ms at 989 TFLOP/s;
// bytes (q, k, v in bf16, o/m/l out in f32) are 0.17 GB -> 0.05 ms at
// 3.35 TB/s, so the kernel is bound by operations.
//
// Design. A block owns (b*h, 128 q rows) and has three warpgroups: two
// consumers of 64 rows each and a producer whose one thread issues every
// copy (setmaxnreg gives the consumers 240 registers and the producer 24).
// The producer loads Q once and streams KROWS-row K and V tiles through a
// ring of STAGES buffers, each filled by TMA (4-d maps over [B, S, H, D],
// 128-byte swizzle, rows past S zero-filled) and completed on a "full"
// mbarrier, released by the consumers on an "empty" one. Per K tile a
// consumer warpgroup
//   1. runs S = Q.K^T as SS wgmma (both operands K-major in shared memory)
//      into registers;
//   2. does the online softmax on wgmma's accumulator layout: a thread holds
//      two rows (lane/4 and lane/4 + 8 of its warp's 16), so the row max is
//      fmaxf over its values and two shuffles inside the quad; the raw max
//      is scaled once per row, p = ex2(s*scale*log2e - m*log2e) is one FFMA
//      and one ex2, alpha = ex2((m_prev - m)*log2e), masked elements enter
//      as -inf (p = 0), and each thread keeps its own share of l, summed
//      across the quad once at the end;
//   3. rescales the running O by alpha in registers and adds P.V as RS wgmma
//      (P's bf16 A fragments built from the S accumulator, V read MN-major
//      from the same tile bytes).
// O, S and P never touch shared memory; o is stored as f32 from the
// accumulator, m and l by one thread of each quad.
//
// With OVERLAP (on), the P.V of tile j-1 is issued together with the S of
// tile j and runs on the tensor cores under the softmax of tile j. A stage
// is then held for two tiles, so the ring is 3 deep, and the first tile is
// peeled so that every product of the loop body is issued and waited on one
// path (with a branch there, ptxas serialises the wgmma: C7518). K/V tiles
// are 128 rows (S as m64n128): each S product reads Q from shared memory once
// per 128 keys instead of 64. Shared memory at D=128: 32 KB Q + 3 x 64 KB.
// `scripts/torch_port_fwd_variants.py` times these choices against 64-row
// tiles, other ring depths and no overlap on the card (PERF.md).
//
// No atomics, a fixed order of operations per element: outputs repeat bit
// for bit. Causal tiles are dead (skipped), interior (unmasked) or diagonal
// (masked), per consumer warpgroup; a ragged last K tile is zero-filled and
// its columns past Sk masked; stores are predicated on row < Sq. Blocks are
// issued heaviest-first.
#include <math_constants.h>

#include "hopper.cuh"

namespace bft {

using namespace hopper;

constexpr int ROWS = 64;           // q rows of one consumer warpgroup
constexpr int BLOCK_ROWS = 128;    // q rows a block owns (two consumer warpgroups)
constexpr int KROWS = 128;         // rows of a streamed K/V tile
constexpr int STAGES = 3;          // depth of the copy ring
constexpr bool OVERLAP = true;     // P.V of the previous tile under this softmax
constexpr int THREADS = 384;       // two consumer warpgroups + one producer
constexpr float NEG = -1e30f;      // the JAX kernel's mask value (_NEG)

// Byte offsets into the (1024-aligned) dynamic shared memory: Q (loaded
// once), then the ring, whose stages hold a K and a V tile, then the
// mbarriers.
template <int D>
struct FwdLayout {
  static constexpr int NR = D / 64;                                 // regions per row
  static constexpr uint32_t q_region = BLOCK_ROWS * REGION_ROW;     // 16 KB
  static constexpr uint32_t kv_region = KROWS * REGION_ROW;
  static constexpr uint32_t q = NR * q_region;                      // one [128, D] tile
  static constexpr uint32_t tile = NR * kv_region;                  // one [KROWS, D] tile
  static constexpr uint32_t stage = 2 * tile;
  static constexpr uint32_t bars = q + STAGES * stage;
  static constexpr uint32_t bytes = bars + 8 * (2 * STAGES + 1) + 1024;  // + alignment slack
};

// S[64 x 2N] = Q_wg . K^T over D, both from shared memory (N = KROWS / 2
// values a thread).
template <int D, int N>
__device__ __forceinline__ void scores(float (&sc)[N], uint32_t aQ, uint32_t sK) {
  using L = FwdLayout<D>;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;
    const uint64_t da = desc_k_major(aQ + (ks / 4) * L::q_region + off);
    const uint64_t db = desc_k_major(sK + (ks / 4) * L::kv_region + off);
    if constexpr (N == 64)
      wgmma_ss_n128<0>(sc, da, db, ks > 0);
    else
      wgmma_ss_n64<0>(sc, da, db, ks > 0);
  }
  wgmma_commit();
}

// O[64 x D] += P . V, P from registers, V MN-major from shared memory.
template <int D>
__device__ __forceinline__ void add_pv(float (&acc)[D / 2], const uint32_t (&a)[KROWS / 16][4],
                                       uint32_t sV) {
  using L = FwdLayout<D>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < KROWS / 16; ++t) {
    const uint64_t db = desc_mn_major(sV + t * 16 * REGION_ROW, L::kv_region);
    if constexpr (D == 128)
      wgmma_rs_n128<1>(acc, a[t], db, 1);
    else
      wgmma_rs_n64<1>(acc, a[t], db, 1);
  }
  wgmma_commit();
}

// One K tile's online softmax in registers, on wgmma's accumulator layout:
// sc holds the raw scores of this thread's two rows (lane/4 and lane/4 + 8 of
// its warp's 16; element i is in row (i/2)%2) and becomes p. The running max
// m (scaled units, reduced across the quad) and this thread's share of l are
// updated, and alpha gets each row's rescale factor. Where `masked`, columns
// at or past lim[row] enter as -inf, so their p is 0.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool masked,
                                               const int (&lim)[2], int lane, float scale) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int hi = (i / 2) % 2;
    if (masked && 8 * (i / 4) + 2 * (lane % 4) + (i % 2) >= lim[hi]) sc[i] = -CUDART_INF_F;
    mx[hi] = fmaxf(mx[hi], sc[i]);
  }
  float mb[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
    const float m_new = fmaxf(m[hi], mx[hi] * scale);  // the raw max, scaled once
    alpha[hi] = ex2((m[hi] - m_new) * LOG2E);
    m[hi] = m_new;
    mb[hi] = m_new * LOG2E;
    l[hi] *= alpha[hi];
  }
  const float c = scale * LOG2E;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int hi = (i / 2) % 2;
    sc[i] = ex2(fmaf(sc[i], c, -mb[hi]));  // -inf (masked) -> 0
    l[hi] += sc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Sk,
                 int H, int q_off, int k_off, int causal, float scale) {
  using L = FwdLayout<D>;
  constexpr int NR = L::NR;
  constexpr int SN = KROWS / 2;  // S values a thread holds
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t sQ = base, ring = base + L::q;
  const uint32_t full = base + L::bars, empty = full + 8 * STAGES, once = empty + 8 * STAGES;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = qt * BLOCK_ROWS;
  const int nk = (Sk + KROWS - 1) / KROWS;
  const int n_iter = causal ? live_prefix(q_off + q0, BLOCK_ROWS, k_off, nk, KROWS) : nk;

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
      mbar_arrive_expect_tx(once, L::q);
      for (int r = 0; r < NR; ++r)
        tma_load_4d(sQ + r * L::q_region, &tm_q, once, 64 * r, h, q0, b);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t sK = ring + s * L::stage, sV = sK + L::tile;
        mbar_arrive_expect_tx(full + 8 * s, 2 * L::tile);
        for (int r = 0; r < NR; ++r) {
          tma_load_4d(sK + r * L::kv_region, &tm_k, full + 8 * s, 64 * r, h, it * KROWS, b);
          tma_load_4d(sV + r * L::kv_region, &tm_v, full + 8 * s, 64 * r, h, it * KROWS, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64*wg ..
    reg_alloc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = 64 * wg + 16 * warp + lane / 4;  // and row + 8
    const int qw_first = q_off + q0 + 64 * wg;
    const int qpos = q_off + q0 + row;
    const uint32_t aQ = sQ + 64 * wg * REGION_ROW;
    // live tiles of this warpgroup: a prefix of the block's
    const int n_live = causal ? live_prefix(qw_first, ROWS, k_off, nk, KROWS) : nk;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {NEG, NEG};  // scaled row max of rows lo, hi
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    uint32_t a[KROWS / 16][4];    // bf16 P of the tile whose P.V is next

    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (it % STAGES));
    };
    auto v_tile = [&](int it) { return ring + (it % STAGES) * L::stage + L::tile; };
    auto issue_s = [&](float (&sc)[SN], int it) {
      mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
      scores<D>(sc, aQ, ring + (it % STAGES) * L::stage);
    };
    auto softmax = [&](float (&sc)[SN], int it, float (&alpha)[2]) {
      const int k_first = k_off + it * KROWS;
      const int k_valid = min(KROWS, Sk - it * KROWS);
      const bool masked = k_valid < KROWS || (causal && k_first + KROWS - 1 > qw_first);
      const int lim[2] = {causal ? min(k_valid, qpos + 1 - k_first) : k_valid,
                          causal ? min(k_valid, qpos + 9 - k_first) : k_valid};
      online_softmax(sc, m_run, l_run, alpha, masked, lim, lane, scale);
    };

    if (n_iter > 0) mbar_wait(once, 0);
    if constexpr (OVERLAP) {
      // the first tile is peeled, so every wgmma of the loop body is issued
      // and waited on one path (ptxas serialises them otherwise)
      if (n_live > 0) {
        float sc[SN], alpha[2];
        issue_s(sc, 0);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(sc, 0, alpha);  // o is still 0: no rescale
        to_a_frags(sc, a);
        for (int it = 1; it < n_live; ++it) {
          issue_s(sc, it);
          add_pv<D>(acc, a, v_tile(it - 1));
          wgmma_wait<1>();  // S is done; the previous P.V runs under the softmax
          fence_regs(sc);
          softmax(sc, it, alpha);
          wgmma_wait<0>();
          fence_regs(a);
          fence_regs(acc);
          release(it - 1);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
          to_a_frags(sc, a);
        }
        add_pv<D>(acc, a, v_tile(n_live - 1));
        wgmma_wait<0>();
        fence_regs(a);
        fence_regs(acc);
        release(n_live - 1);
      }
    } else {
      for (int it = 0; it < n_live; ++it) {
        float sc[SN], alpha[2];
        issue_s(sc, it);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(sc, it, alpha);
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
        to_a_frags(sc, a);
        add_pv<D>(acc, a, v_tile(it));
        wgmma_wait<0>();
        fence_regs(a);
        fence_regs(acc);
        release(it);
      }
    }
    for (int it = n_live; it < n_iter; ++it) {  // tiles dead for this warpgroup
      mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
      release(it);
    }

#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      l_run[hi] += __shfl_xor_sync(0xffffffffu, l_run[hi], 1);
      l_run[hi] += __shfl_xor_sync(0xffffffffu, l_run[hi], 2);
    }
    // f32 store: element i at row (+8 for (i/2)%2), column 8*(i/4) + 2*(lane%4)
    const long stride = (long)H * D;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = q0 + row + 8 * hi;
      if (r < Sq) {
        float* out = o + ((long)b * Sq + r) * stride + (long)h * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
        if (lane % 4 == 0) {
          const long at = ((long)b * Sq + r) * H + h;
          m_out[at] = m_run[hi];
          l_out[at] = l_run[hi];
        }
      }
    }
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o, void* m,
                  void* l, int B, int Sq, int Sk, int H, int q_off, int k_off,
                  int causal, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, B, Sq, H, D, BLOCK_ROWS);
  if (!err) err = make_map(&mk, k, B, Sk, H, D, KROWS);
  if (!err) err = make_map(&mv, v, B, Sk, H, D, KROWS);
  if (err) return err;
  const uint32_t bytes = FwdLayout<D>::bytes;
  err = (int)cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) return err;
  const dim3 grid(B * H, (Sq + BLOCK_ROWS - 1) / BLOCK_ROWS);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      Sq, Sk, H, q_off, k_off, causal, scale);
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

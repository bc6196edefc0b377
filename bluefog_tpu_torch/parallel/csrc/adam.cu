// The optimizer update: Adam and AdamW over many f32 tensors in one pass.
//
// Replaces no Pallas kernel. The JAX package steps optax.adam inside its
// jitted training step, where XLA fuses the update into one loop over the
// state. The port's torch.optim.Adam on CUDA runs torch's foreach chain
// instead (_multi_tensor_adam): lerp on m, mul and addcmul on v, sqrt into a
// new list, div and add on it, addcdiv on p, about eight passes and 72-84 B
// a parameter. This kernel makes it one pass.
//
// Computes, per element, in f32, with the roundings of torch's foreach chain
// on CUDA (each of its kernels rounds once, and nvcc contracts a product
// added to a sum into one fma there as here), so the two agree bit for bit:
//   g = g + wd*p                  (mode 1, Adam's L2 decay)        one fma
//   p = p * (1 - lr*wd)           (mode 2, AdamW's decoupled decay)
//   m = m + w*(g - m)             (torch's lerp, w = 1 - beta1 < 0.5;
//                                  g - (g - m)*(1 - w) otherwise)   one fma
//   v = v*beta2, then v + (1 - beta2)*(g*g)                        one fma
//   d = sqrt(v) / sqrt(bc2) + eps
//   p = p + step*(m / d)          (step = -lr / bc1)               one fma
// The host computes the bias corrections bc1 = 1 - beta1^t and bc2 =
// 1 - beta2^t in double from the step count t, as torch does, and passes
// each factor rounded to f32, as torch's scalar arguments are.
//
// Bound on the H100: each element reads p, g, m and v and writes p, m and v
// once, 28 B; for the 1,414,105,088 parameters of Pythia-1.4B's widths that
// is 39.6 GB, 11.8 ms at 3.35 TB/s. No operation count comes near it.
//
// Design. One launch covers up to kMaxTensors tensors: the host passes their
// pointers and lengths as a kernel argument (a __grid_constant__ table, no
// copy to the card and no sync), with each tensor's first chunk, so a block
// finds its tensor by a binary search over the table. A block owns one chunk
// of kChunk elements; blocks are many and short, so the last wave of a launch
// is short too. Each thread moves 16-byte vectors of p, g, m and v with
// streaming loads and stores (the state is far larger than L2), all four
// loads issued before the arithmetic; a chunk whose four pointers are not
// 16-byte aligned, and the ragged tail of a tensor, go element by element.
// Nothing is written to device memory but p, m and v.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTensors = 64;
constexpr int kThreads = 256;
constexpr int kChunk = 8192;  // elements a block: 8 vectors a thread

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  int64_t n[kMaxTensors];
  int first[kMaxTensors + 1];  // first chunk of each tensor; first[count]: all
  int count;
};

struct Hyper {
  float w;         // 1 - beta1, the lerp weight
  float beta2;
  float c2;        // 1 - beta2
  float bc2_sqrt;  // sqrt(1 - beta2^t)
  float eps;
  float step;      // -lr / (1 - beta1^t)
  float decay;     // mode 1: wd; mode 2: 1 - lr*wd
  int mode;        // 0 no weight decay, 1 L2 (Adam), 2 decoupled (AdamW)
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const Hyper& h) {
  if (h.mode == 1) g = __fmaf_rn(h.decay, p, g);
  if (h.mode == 2) p = __fmul_rn(p, h.decay);
  const float diff = __fsub_rn(g, m);
  m = fabsf(h.w) < 0.5f ? __fmaf_rn(h.w, diff, m)
                        : __fmaf_rn(-diff, __fsub_rn(1.0f, h.w), g);
  v = __fmaf_rn(h.c2, __fmul_rn(g, g), __fmul_rn(v, h.beta2));
  const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), h.bc2_sqrt), h.eps);
  p = __fmaf_rn(h.step, __fdiv_rn(m, d), p);
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Table t, const Hyper h) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the last tensor whose first chunk <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const int64_t start = int64_t(b - t.first[lo]) * kChunk;
  const int len = int(min(int64_t(kChunk), t.n[lo] - start));
  float* __restrict__ p = t.p[lo] + start;
  const float* __restrict__ g = t.g[lo] + start;
  float* __restrict__ m = t.m[lo] + start;
  float* __restrict__ v = t.v[lo] + start;

  int done = 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(v);
  if ((bits & 15) == 0) {
    const int n4 = len >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
#pragma unroll 2
    for (int j = threadIdx.x; j < n4; j += kThreads) {
      float4 pj = __ldcs(p4 + j);
      const float4 gj = __ldcs(g4 + j);
      float4 mj = __ldcs(m4 + j);
      float4 vj = __ldcs(v4 + j);
      adam_one(pj.x, gj.x, mj.x, vj.x, h);
      adam_one(pj.y, gj.y, mj.y, vj.y, h);
      adam_one(pj.z, gj.z, mj.z, vj.z, h);
      adam_one(pj.w, gj.w, mj.w, vj.w, h);
      __stcs(p4 + j, pj);
      __stcs(m4 + j, mj);
      __stcs(v4 + j, vj);
    }
    done = n4 << 2;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads) {
    float pj = p[j], mj = m[j], vj = v[j];
    adam_one(pj, g[j], mj, vj, h);
    p[j] = pj;
    m[j] = mj;
    v[j] = vj;
  }
}

}  // namespace

// One update of `count` tensors that share their hyper-parameters and step:
// p/g/m/v hold each tensor's four device pointers, n its length. Tensors of
// length 0 are skipped. Launches on `stream` as many times as the table
// needs (written to *launches) and returns the first launch error, or 0.
extern "C" int bft_adam(const uint64_t* p, const uint64_t* g, const uint64_t* m,
                        const uint64_t* v, const int64_t* n, int count,
                        float w, float beta2, float c2, float bc2_sqrt,
                        float eps, float step, float decay, int mode,
                        void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{w, beta2, c2, bc2_sqrt, eps, step, decay, mode};
  *launches = 0;
  Table t;
  t.count = 0;
  int64_t chunks = 0;
  for (int i = 0; i <= count; ++i) {
    const bool last = i == count;
    if (!last && n[i] <= 0) continue;
    const int64_t need = last ? 0 : (n[i] + kChunk - 1) / kChunk;
    if (t.count == kMaxTensors || (last && t.count) ||
        (t.count && chunks + need > INT32_MAX)) {
      t.first[t.count] = int(chunks);
      adam_kernel<<<unsigned(chunks), kThreads, 0, s>>>(t, h);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return int(err);
      ++*launches;
      t.count = 0;
      chunks = 0;
    }
    if (last) break;
    if (need > INT32_MAX) return int(cudaErrorInvalidValue);
    const int k = t.count++;
    t.p[k] = reinterpret_cast<float*>(p[i]);
    t.g[k] = reinterpret_cast<const float*>(g[i]);
    t.m[k] = reinterpret_cast<float*>(m[i]);
    t.v[k] = reinterpret_cast<float*>(v[i]);
    t.n[k] = n[i];
    t.first[k] = int(chunks);
    chunks += need;
  }
  return 0;
}

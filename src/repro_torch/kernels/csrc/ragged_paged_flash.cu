// Ragged paged flash attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/ragged_paged_flash.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:ragged_paged_flash
// (pallas_call body _ragged_decode_kernel): attention for a flat pack of T
// query tokens from any serving slots.  Token t reads its slot's KV through
// token -> slot[t] -> block-table row ptab[slot] -> pool page, and sees the
// first lens[t] entries of that context (lens = q_pos + 1, so intra-pack
// causality is a length cut).  Online softmax with a float32 accumulator,
// scale hd^-0.5; int8 pools are dequantized with their per-entry scale rows
// right after each page load; lens == 0 gives zeros; sentinel block-table
// entries clamp to the last pool page (their entries lie beyond lens).
//
// What bounds it on an H100: BYTES.  The least traffic is the unique KV pages
// the pack's slots touch (values, plus scale rows for int8), q and the
// output, over 3.35 TB/s.  The arithmetic is about 4 * sum(lens) * G * kvH *
// hd FLOPs, a few operations per byte read — far below the ~295 FLOP/byte the
// card needs before compute could bound it.
//
// Design (right and simple first): one thread block per (token, KV head).
// The TPU grid's sequential page axis becomes a loop inside the block over
// the ceil(lens/page) visible pages.  Each page's K and V tiles are staged
// in shared memory as float32 (dequantized on the way in); one warp computes
// each (query head, row) score with a shuffle reduction, one warp per query
// head runs the online-softmax update, and the G x hd accumulator lives in
// shared memory.  G need not be a power of two (qwen2-1.5b has G = 6).
// Tokens of one slot re-read that slot's pages (the L2 catches most of it);
// TMA, wgmma and split-K over pages are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the JAX kernel's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// q, out: (T, kvH, G, hd); kp, vp: (npages, page, kvH, hd); ks, vs:
// (npages, page, kvH); ptab: (B, pps); slot, lens: (T,).  All contiguous.
template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kThreads) ragged_paged_flash_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp, const KT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int32_t* __restrict__ ptab, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ lens, QT* __restrict__ out, int kvH, int G, int hd,
    int page, int npages, int B, int pps, float scale) {
  extern __shared__ float smem[];
  const int GH = G * hd;
  float* q_s = smem;             // (G, hd) scaled query heads
  float* k_s = q_s + GH;         // (page, hd) K tile
  float* v_s = k_s + page * hd;  // (page, hd) V tile
  float* p_s = v_s + page * hd;  // (G, page) scores, then probabilities
  float* acc_s = p_s + G * page; // (G, hd) running numerator
  float* m_s = acc_s + GH;       // (G,) running max
  float* l_s = m_s + G;          // (G,) running denominator
  float* c_s = l_s + G;          // (G,) this page's rescale factor

  const int t = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qo = ((size_t)t * kvH + h) * GH;

  for (int i = tid; i < GH; i += kThreads) {
    q_s[i] = to_float(q[qo + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int len = lens[t];
  const int b = min(max(slot[t], 0), B - 1);
  const int n_pages = len > 0 ? min((len + page - 1) / page, pps) : 0;
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
    const int p = min(max(ptab[(size_t)b * pps + j], 0), npages - 1);
    const int n_valid = len - j * page;  // >= 1 on every visited page
    const size_t row0 = (size_t)p * page;

    for (int i = tid; i < page * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const size_t src = ((row0 + r) * kvH + h) * hd + d;
      float kx = to_float(kp[src]), vx = to_float(vp[src]);
      if (kQuant) {
        const size_t si = (row0 + r) * kvH + h;
        kx *= ks[si];
        vx *= vs[si];
      }
      k_s[i] = kx;
      v_s[i] = vx;
    }
    __syncthreads();

    for (int pr = warp; pr < G * page; pr += kWarps) {
      const int g = pr / page, r = pr - g * page;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += q_s[g * hd + d] * k_s[r * hd + d];
      s = warp_sum(s);
      if (lane == 0) p_s[pr] = r < n_valid ? s : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * page;
      float mx = kNegInf;
      for (int r = lane; r < page; r += 32) mx = fmaxf(mx, pg[r]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < page; r += 32) {
        const float e = r < n_valid ? expf(pg[r] - m_new) : 0.f;
        pg[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < GH; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* pg = p_s + g * page;
      float a = acc_s[i] * c_s[g];
      for (int r = 0; r < page; ++r) a += pg[r] * v_s[r * hd + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < GH; i += kThreads)
    store(out + qo + i, acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
}

template <typename QT, typename KT, bool kQuant>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* ptab, const void* slot, const void* lens,
                   void* out, int T, int kvH, int G, int hd, int page, int npages, int B,
                   int pps, float scale, size_t smem, cudaStream_t stream) {
  auto kern = ragged_paged_flash_kernel<QT, KT, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(T, kvH), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp), static_cast<const KT*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int32_t*>(ptab), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(lens), static_cast<QT*>(out), kvH, G, hd, page, npages,
      B, pps, scale);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (int8 reads the ks/vs scale pools).  Returns the cudaError_t of the launch.
extern "C" int ragged_paged_flash(int q_dtype, int kv_dtype, const void* q, const void* kp,
                                  const void* vp, const void* ks, const void* vs,
                                  const void* ptab, const void* slot, const void* lens,
                                  void* out, int T, int kvH, int G, int hd, int page,
                                  int npages, int B, int pps, float scale, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * G * hd + (size_t)2 * page * hd +
                                       (size_t)G * page + 3 * (size_t)G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPF_LAUNCH(QT, KT, QUANT)                                                        \
  return (int)launch<QT, KT, QUANT>(q, kp, vp, ks, vs, ptab, slot, lens, out, T, kvH, G, \
                                    hd, page, npages, B, pps, scale, smem, st)
  if (q_dtype == 0) {
    if (kv_dtype == 0) RPF_LAUNCH(float, float, false);
    if (kv_dtype == 1) RPF_LAUNCH(float, __nv_bfloat16, false);
    if (kv_dtype == 2) RPF_LAUNCH(float, int8_t, true);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) RPF_LAUNCH(__nv_bfloat16, float, false);
    if (kv_dtype == 1) RPF_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
    if (kv_dtype == 2) RPF_LAUNCH(__nv_bfloat16, int8_t, true);
  }
#undef RPF_LAUNCH
  return (int)cudaErrorInvalidValue;
}

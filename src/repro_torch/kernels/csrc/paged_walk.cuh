// The page walk of the two-phase decode kernel for Hopper (sm_90a),
// paged_flash_decode.cu (one decode token per slot), its only user:
// ragged_paged_flash.cu, which shared it until it was rebuilt with query
// tiles, split-K and tensor-core scores, no longer includes it.  The kernel
// resolves a query row to a block-table row and a visible length, then
// runs the online softmax below over that row's pages.
//
// paged_attend: one thread block holds the G query heads of one KV head
// (q_row, (G, hd)) and walks the ceil(len/page) visible pages of its
// block-table row.  Each page's K and V tiles are staged in shared memory as
// float32 (int8 pages dequantized with their per-entry scale rows on the
// way in); one warp computes each (query head, row) score with a shuffle
// reduction, one warp per query head runs the online-softmax update, and the
// G x hd accumulator lives in shared memory.  Scores are float32 with q
// scaled by hd^-0.5, masked past len with -1e30 (the JAX kernels' NEG_INF);
// len == 0 gives zeros; block-table entries outside [0, npages) (the
// sentinel npages marks an unmapped page) clamp into the pool, and their
// entries lie beyond len.  G need not be a power of two (qwen2-1.5b has
// G = 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF

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

// Bytes of dynamic shared memory paged_attend needs; the Python wrappers
// mirror it (_smem_bytes) to refuse shapes that do not fit.
inline size_t smem_bytes(int G, int hd, int page) {
  return sizeof(float) * ((size_t)2 * G * hd + (size_t)2 * page * hd + (size_t)G * page +
                          3 * (size_t)G);
}

// q_row, out_row: (G, hd) of one (query row, KV head); kp, vp: (npages,
// page, kvH, hd); ks, vs: (npages, page, kvH); ptab_row: (pps,) the block
// table row this query reads; len: its visible entries.  Call from every
// thread of a kThreads block with the block's dynamic shared memory.
template <typename QT, typename KT, bool kQuant>
__device__ __forceinline__ void paged_attend(
    const QT* __restrict__ q_row, QT* __restrict__ out_row, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ ks, const float* __restrict__ vs,
    const int32_t* __restrict__ ptab_row, int len, int h, int kvH, int G, int hd, int page,
    int npages, int pps, float scale, float* smem) {
  const int GH = G * hd;
  float* q_s = smem;             // (G, hd) scaled query heads
  float* k_s = q_s + GH;         // (page, hd) K tile
  float* v_s = k_s + page * hd;  // (page, hd) V tile
  float* p_s = v_s + page * hd;  // (G, page) scores, then probabilities
  float* acc_s = p_s + G * page; // (G, hd) running numerator
  float* m_s = acc_s + GH;       // (G,) running max
  float* l_s = m_s + G;          // (G,) running denominator
  float* c_s = l_s + G;          // (G,) this page's rescale factor

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < GH; i += kThreads) {
    q_s[i] = to_float(q_row[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int n_pages = len > 0 ? min((len + page - 1) / page, pps) : 0;
  __syncthreads();

  for (int j = 0; j < n_pages; ++j) {
    const int p = min(max(ptab_row[j], 0), npages - 1);
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
    store(out_row + i, acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
}

// Launch<QT, KT, kQuant>::run(args...) for the dtype codes of the C
// entries: q_dtype 0 float32, 1 bfloat16; kv_dtype 0 float32, 1 bfloat16,
// 2 int8 (int8 reads the ks/vs scale pools).  Returns a cudaError_t.
template <template <typename, typename, bool> class Launch, typename... Args>
int dispatch(int q_dtype, int kv_dtype, Args... args) {
  if (q_dtype == 0) {
    if (kv_dtype == 0) return (int)Launch<float, float, false>::run(args...);
    if (kv_dtype == 1) return (int)Launch<float, __nv_bfloat16, false>::run(args...);
    if (kv_dtype == 2) return (int)Launch<float, int8_t, true>::run(args...);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return (int)Launch<__nv_bfloat16, float, false>::run(args...);
    if (kv_dtype == 1) return (int)Launch<__nv_bfloat16, __nv_bfloat16, false>::run(args...);
    if (kv_dtype == 2) return (int)Launch<__nv_bfloat16, int8_t, true>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

// Raise the block's dynamic shared-memory limit where it exceeds the 48 KB
// default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace paged

// Causal flash attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/flash_attention.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (pallas_call body _kernel): q (BH, S, hd) over k, v (BKV, S, hd), query row
// bh reading K/V row bh / G with G = BH / BKV.  q is scaled in float32 by
// hd^-0.5; scores are float32, masked with -1e30 where row < col or, with a
// window, where row - col >= window; the softmax runs online (m, l, acc in
// float32); p is rounded to v's dtype before the PV product, the row sum l
// is taken before that rounding and clamped at 1e-30; the output is cast to
// q's dtype.  K tiles entirely above the diagonal or entirely older than
// the window are skipped.  Unlike the TPU kernel, a masked key gets p = 0
// outright, so a row whose first visited tile is all masked (a window) adds
// no exp(-1e30 - m) terms that a later rescale would have to wipe.
//
// What bounds it on an H100 at the training shape (qwen2-1.5b, batch 2, S
// 4096: BH 24, BKV 4, hd 128, bf16): OPERATIONS.  4 * hd FLOPs for each of
// the S(S+1)/2 causal (row, col) pairs of each of the 24 rows is 1.03e11
// FLOPs, 0.104 ms at the 989 TFLOP/s of bf16 tensor cores; the bytes (q, k,
// v read once and the output written once, 59 MB) take 0.018 ms.
//
// Design (right and simple first): one 256-thread block per (bh, 64-row query
// tile), the heaviest tiles (nearest the end of the sequence) launched first.
// The TPU grid's sequential K axis becomes a loop inside the block over the
// 64-row K/V tiles up to the diagonal.  q, K and V tiles are staged in shared
// memory as float32 with 16-byte global loads (K and V share one buffer, so
// two blocks fit on an SM); each thread computes a 4 x 4 score tile and a
// 4 x 8 slice of the 64 x hd accumulator with float32 FMAs, and keeps its
// rows' m and l in registers (the 16 threads of a row reduce with shuffles).
// It does not use the tensor cores, so its ceiling is the card's 67 TFLOP/s
// of float32 FMA (1.5 ms here), some 15x above the bf16 bound.  wgmma, TMA
// and a pipelined K/V ring are the work of a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMaxHd = 128;    // 16 threads x 4 columns x 2
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kLdP = kBK + kPad;
constexpr float kNegInf = -1e30f;  // the JAX kernel's NEG_INF

__device__ __forceinline__ void load_vec(const float* __restrict__ src, float* dst, float mul) {
  float4 v = *reinterpret_cast<const float4*>(src);
  v.x *= mul;
  v.y *= mul;
  v.z *= mul;
  v.w *= mul;
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ src, float* dst,
                                         float mul) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    dst[2 * e] = f.x * mul;
    dst[2 * e + 1] = f.y * mul;
  }
}

// Rows [row0, row0 + 64) of a (S, hd) matrix into shared memory (row stride
// hd + kPad floats), times mul; rows at or beyond S are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int row0,
                                          int S, int hd, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = hd / kVec;
  for (int i = threadIdx.x; i < 64 * nvec; i += kThreads) {
    const int r = i / nvec, c = (i - r * nvec) * kVec;
    float* d = dst + r * (hd + kPad) + c;
    if (row0 + r < S) {
      load_vec(src + (size_t)(row0 + r) * hd + c, d, mul);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = 0.f;
    }
  }
}

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Reductions over the 16 threads of one row: lanes 0-15 and 16-31 of a warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q, out: (BH, S, hd); k, v: (BKV, S, hd); all contiguous and 16-byte
// aligned, hd a multiple of 8 and at most 128.  window <= 0 means none.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int hd, int G, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + kPad;
  float* q_s = smem;             // (64, ld) scaled query tile
  float* kv_s = q_s + kBQ * ld;  // (64, ld) K tile, then V tile
  float* p_s = kv_s + kBK * ld;  // (64, kLdP) probabilities

  const int nq = gridDim.x;
  const int qi = nq - 1 - blockIdx.x;  // long rows first
  const int bh = blockIdx.y;
  const int q0 = qi * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = q + (size_t)bh * S * hd;
  const T* kb = k + (size_t)(bh / G) * S * hd;
  const T* vb = v + (size_t)(bh / G) * S * hd;

  load_tile(qb, q_s, q0, S, hd, scale);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }
  const bool col0 = 4 * tx < hd, col1 = 4 * tx + 64 < hd;
  const int k_last = min(q0 + kBQ - 1, S - 1);  // last key any row here sees

  for (int k0 = 0; k0 <= k_last; k0 += kBK) {
    if (window > 0 && q0 - (k0 + kBK - 1) >= window) continue;  // block-uniform
    __syncthreads();  // the previous tile's V and P are consumed
    load_tile(kb, kv_s, k0, S, hd, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < S && row >= col && (window <= 0 || row - col < window);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to(p, v);
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();  // every thread is done with K; P is written
    load_tile(vb, kv_s, k0, S, hd, 1.f);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= corr[i];
    for (int r = 0; r < kBK; ++r) {
      float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
      if (col0) v0 = *reinterpret_cast<const float4*>(kv_s + r * ld + 4 * tx);
      if (col1) v1 = *reinterpret_cast<const float4*>(kv_s + r * ld + 4 * tx + 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kLdP + r];
        acc[i][0] = fmaf(p, v0.x, acc[i][0]);
        acc[i][1] = fmaf(p, v0.y, acc[i][1]);
        acc[i][2] = fmaf(p, v0.z, acc[i][2]);
        acc[i][3] = fmaf(p, v0.w, acc[i][3]);
        acc[i][4] = fmaf(p, v1.x, acc[i][4]);
        acc[i][5] = fmaf(p, v1.y, acc[i][5]);
        acc[i][6] = fmaf(p, v1.z, acc[i][6]);
        acc[i][7] = fmaf(p, v1.w, acc[i][7]);
      }
    }
  }

  T* ob = out + (size_t)bh * S * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = acc[i][e] / den;
    if (col0) store4(ob + (size_t)row * hd + 4 * tx, o);
    if (col1) store4(ob + (size_t)row * hd + 4 * tx + 64, o + 4);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int S,
                   int hd, int G, int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T>;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (hd + kPad) + (size_t)kBQ * kLdP);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out), S,
                                         hd, G, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it).  window <= 0 means
// none.  Returns the cudaError_t of the launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, int BH, int BKV, int S, int hd, int window,
                               float scale, void* stream) {
  if (BKV <= 0 || BH % BKV != 0 || hd % 8 != 0 || hd > kMaxHd || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = BH / BKV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(q, k, v, out, BH, S, hd, G, window, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, BH, S, hd, G, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Row RMSNorm for Hopper (sm_90a), bound through a plain C interface and
// loaded with ctypes (repro_torch/kernels/rmsnorm.py).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:rmsnorm (pallas_call body
// _kernel): out = x * rsqrt(mean(x^2) + eps) * scale for each row of x
// (R, D), float32 or bfloat16, with float32 statistics and a float32 scale
// (D,); the output is in x's type.
//
// What bounds it on an H100: BYTES.  Each row is read once and written
// once (plus the scale, once), about 3 FLOPs per element: at the training
// activations (8192 x 1536, bfloat16) that is 50 MB, 15 us at 3.35 TB/s.
//
// Design: three routes, chosen by the wrapper (rmsnorm_plan) from R, D, the
// type and the pointers' alignment, and refused here when their needs are
// unmet.
//   "cached": 16-byte loads and stores (8 bf16 or 4 float32 a thread per
//     access, the scale read as float4), each row held in registers between
//     the sum of squares and the scaling, so x is read from device memory
//     once.  A thread holds exactly ceil(vectors / threads_per_row) vectors
//     (a template parameter, at most kCacheVecs): a register array sized to
//     the row keeps three 256-thread blocks on an SM where an array of 8
//     kept two.  threads_per_row (32, 64, 128 or 256 of a 256-thread block)
//     is picked so the grid fills the card: a warp per row at the training
//     activations (1024 blocks), a block per row at the 256-row serving
//     pack (256 blocks, not 32).  Rows wider than a warp reduce through
//     shared memory.
//   "reread": the same vector loads for rows too wide for the register
//     cache (more than 256 x kCacheVecs vectors); each row is read twice.
//   "scalar": one warp per row with scalar loads, read twice, for rows that
//     are not 16-byte aligned (D * itemsize not a multiple of 16, or a base
//     pointer off alignment, as a slice of a 1-D tensor can be).
// The TPU kernel's row blocks (block_rows, padded) only tile its grid; here
// the last block masks rows past R instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Route { kScalar = 0, kCached = 1, kReread = 2 };

constexpr int kBlock = 256;
constexpr int kCacheVecs = 8;  // 16-byte vectors a thread holds (128 bytes)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A 16-byte vector as float32 values, and back.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      const float2 t = __bfloat1622float2(b);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&b);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& v) {
  float f[Vec<T>::N];
  Vec<T>::unpack(v, f);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) s = fmaf(f[i], f[i], s);
  return s;
}

// out vector v of a row: x * r * scale, the scale read as float4.
template <typename T>
__device__ __forceinline__ uint4 scaled(const uint4& v, const float* __restrict__ scale, int vi,
                                        float r) {
  float f[Vec<T>::N];
  Vec<T>::unpack(v, f);
  const float4* s4 = reinterpret_cast<const float4*>(scale) + vi * (Vec<T>::N / 4);
#pragma unroll
  for (int i = 0; i < Vec<T>::N / 4; ++i) {
    const float4 s = __ldg(s4 + i);
    f[4 * i] = f[4 * i] * r * s.x;
    f[4 * i + 1] = f[4 * i + 1] * r * s.y;
    f[4 * i + 2] = f[4 * i + 2] * r * s.z;
    f[4 * i + 3] = f[4 * i + 3] * r * s.w;
  }
  return Vec<T>::pack(f);
}

// The sum over the kTpr threads of one row; every thread of the block calls
// it (it may hold a barrier).
template <int kTpr>
__device__ __forceinline__ float row_sum(float x) {
  x = warp_sum(x);
  if constexpr (kTpr > 32) {
    __shared__ float part[kBlock / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) part[warp] = x;
    __syncthreads();
    const int first = (threadIdx.x / kTpr) * (kTpr / 32);
    x = 0.f;
#pragma unroll
    for (int w = 0; w < kTpr / 32; ++w) x += part[first + w];
  }
  return x;
}

// "cached": kBlock / kTpr rows a block, the row in kVpt vectors a thread.
template <typename T, int kTpr, int kVpt>
__global__ void __launch_bounds__(kBlock) rms_cached_kernel(const T* __restrict__ x,
                                                           const float* __restrict__ scale,
                                                           T* __restrict__ out, int R, int D,
                                                           float eps) {
  const int row = blockIdx.x * (kBlock / kTpr) + threadIdx.x / kTpr;
  const int lt = threadIdx.x % kTpr;
  const int nv = D / Vec<T>::N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  uint4 cache[kVpt];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVpt; ++i) {  // every load in flight before any use
    const int v = lt + i * kTpr;
    if (row < R && v < nv) cache[i] = __ldcs(xr + v);
  }
#pragma unroll
  for (int i = 0; i < kVpt; ++i)
    if (row < R && lt + i * kTpr < nv) ss += sum_squares<T>(cache[i]);
  ss = row_sum<kTpr>(ss);
  if (row >= R) return;
  const float r = rsqrtf(ss / (float)D + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < kVpt; ++i) {
    const int v = lt + i * kTpr;
    if (v < nv) __stcs(orow + v, scaled<T>(cache[i], scale, v, r));
  }
}

// "reread": a block per row, vector loads, the row read twice.
template <typename T>
__global__ void __launch_bounds__(kBlock) rms_reread_kernel(const T* __restrict__ x,
                                                           const float* __restrict__ scale,
                                                           T* __restrict__ out, int D,
                                                           float eps) {
  const int row = blockIdx.x;
  const int nv = D / Vec<T>::N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  float ss = 0.f;
  for (int v = threadIdx.x; v < nv; v += kBlock) ss += sum_squares<T>(__ldg(xr + v));
  ss = row_sum<kBlock>(ss);
  const float r = rsqrtf(ss / (float)D + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * D);
  for (int v = threadIdx.x; v < nv; v += kBlock)
    __stcs(orow + v, scaled<T>(__ldcs(xr + v), scale, v, r));
}

// "scalar": one warp per row, eight rows a block, scalar loads, read twice.
template <typename T>
__global__ void __launch_bounds__(kBlock) rms_scalar_kernel(const T* __restrict__ x,
                                                           const float* __restrict__ scale,
                                                           T* __restrict__ out, int R, int D,
                                                           float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_float(xr[d]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)D + eps);
  for (int d = lane; d < D; d += 32) store(orow + d, to_float(xr[d]) * r * scale[d]);
}

template <typename T, int kTpr, int kVpt>
cudaError_t launch_cached(const void* x, const void* scale, void* out, int R, int D, float eps,
                          cudaStream_t st) {
  constexpr int rows = kBlock / kTpr;
  rms_cached_kernel<T, kTpr, kVpt><<<(R + rows - 1) / rows, kBlock, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), R, D,
      eps);
  return cudaGetLastError();
}

// The instance whose register array holds exactly `vpt` vectors.
template <typename T, int kTpr>
cudaError_t launch_cached(int vpt, const void* x, const void* scale, void* out, int R, int D,
                          float eps, cudaStream_t st) {
  switch (vpt) {
    case 1: return launch_cached<T, kTpr, 1>(x, scale, out, R, D, eps, st);
    case 2: return launch_cached<T, kTpr, 2>(x, scale, out, R, D, eps, st);
    case 3: return launch_cached<T, kTpr, 3>(x, scale, out, R, D, eps, st);
    case 4: return launch_cached<T, kTpr, 4>(x, scale, out, R, D, eps, st);
    case 5: return launch_cached<T, kTpr, 5>(x, scale, out, R, D, eps, st);
    case 6: return launch_cached<T, kTpr, 6>(x, scale, out, R, D, eps, st);
    case 7: return launch_cached<T, kTpr, 7>(x, scale, out, R, D, eps, st);
    case 8: return launch_cached<T, kTpr, 8>(x, scale, out, R, D, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(int route, int tpr, const void* x, const void* scale, void* out, int R, int D,
                   float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if (route == kScalar) {
    rms_scalar_kernel<T><<<(R + kBlock / 32 - 1) / (kBlock / 32), kBlock, 0, st>>>(xt, sc, ot, R,
                                                                                   D, eps);
    return cudaGetLastError();
  }
  // the vector routes: 16-byte rows and pointers
  if ((size_t)D * sizeof(T) % 16 != 0 || !aligned16(x) || !aligned16(scale) || !aligned16(out))
    return cudaErrorInvalidValue;
  const int nv = D / Vec<T>::N;
  if (route == kReread) {
    rms_reread_kernel<T><<<R, kBlock, 0, st>>>(xt, sc, ot, D, eps);
    return cudaGetLastError();
  }
  if (route != kCached || tpr <= 0) return cudaErrorInvalidValue;
  const int vpt = (nv + tpr - 1) / tpr;
  if (vpt > kCacheVecs) return cudaErrorInvalidValue;
  switch (tpr) {
    case 32: return launch_cached<T, 32>(vpt, x, scale, out, R, D, eps, st);
    case 64: return launch_cached<T, 64>(vpt, x, scale, out, R, D, eps, st);
    case 128: return launch_cached<T, 128>(vpt, x, scale, out, R, D, eps, st);
    case 256: return launch_cached<T, 256>(vpt, x, scale, out, R, D, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// route: 0 "scalar", 1 "cached", 2 "reread" (the Route enum; the wrapper
// passes ROUTES.index(route)); threads_per_row: 32, 64, 128 or 256, read by
// "cached" only.  dtype (x and out): 0 float32, 1 bfloat16.  Returns the
// cudaError_t of the launch; refuses a route whose needs are unmet.
extern "C" int rmsnorm(int route, int threads_per_row, int dtype, const void* x,
                       const void* scale, void* out, int R, int D, float eps, void* stream) {
  if (R <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(route, threads_per_row, x, scale, out, R, D, eps, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(route, threads_per_row, x, scale, out, R, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

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
// Design (right and simple first): one warp per row, eight rows per
// 256-thread block.  The warp sums the squares of its row with a shuffle
// reduction, then reads the row again (from L1/L2) to scale and store it.
// The TPU kernel's row blocks (block_rows, padded) only tile the grid; here
// the last block masks rows past R instead.  Vector loads and keeping the
// row in registers are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // one warp per row

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x, out: (R, D); scale: (D,).  All contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(const T* __restrict__ x,
                                                          const float* __restrict__ scale,
                                                          T* __restrict__ out, int R, int D,
                                                          float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_float(xr[d]);
    ss = fmaf(v, v, ss);
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)D + eps);
  for (int d = lane; d < D; d += 32) store(orow + d, to_float(xr[d]) * r * scale[d]);
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int R, int D, float eps,
                   cudaStream_t stream) {
  rmsnorm_kernel<T><<<(R + kRows - 1) / kRows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), R, D,
      eps);
  return cudaGetLastError();
}

}  // namespace

// dtype (x and out): 0 float32, 1 bfloat16.  Returns the cudaError_t of the
// launch.
extern "C" int rmsnorm(int dtype, const void* x, const void* scale, void* out, int R, int D,
                       float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, scale, out, R, D, eps, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, scale, out, R, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

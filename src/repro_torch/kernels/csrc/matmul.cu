// Tiled matrix product C = A B for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/matmul.py).
//
// Replaces the TPU kernel repro/kernels/matmul.py:matmul (pallas_call bodies
// _kernel_vmem and _kernel_hbm): A (M, K) times B (K, N), float32 or
// bfloat16 inputs, float32 accumulation, under one of the two accumulation
// policies that stand for the paper's memory modes:
//
//   accum "vmem" ("cache" mode): the float32 accumulator stays on chip, in
//     registers, for the whole K loop, and C is written once in its output
//     type.  One launch.
//   accum "hbm" ("flat" mode): C is float32 in device memory and is read,
//     added to and written back once per bk-wide slice of K, as the TPU
//     kernel revisits its output block on every K step.  The wrapper makes
//     one launch per slice (ceil(K / bk) of them), each reading C with
//     __ldcg and writing it with __stcg (through L2, past L1), so no
//     compiler can keep C in registers across slices: every pass moves
//     M x N x 8 bytes.  The wrapper casts to the output type at the end.
//
// What bounds it on an H100: OPERATIONS for the square products of the
// paper's sweep (2 M N K FLOPs; at N = 4096 that is 1.4e11 FLOPs against
// 200 MB moved), over 67 TFLOP/s for float32 inputs (the card's float32
// rate outside the tensor cores; this kernel uses no TF32) and 989 TFLOP/s
// for bfloat16.  The hbm policy adds 8 M N bytes a pass.
//
// Design (right and simple first): one 256-thread block per 128 x 128 tile
// of C, each thread an 8 x 8 register micro-tile (two 4 x 4 quadrants 64
// rows and 64 columns apart, read from shared memory as float4), a 16-deep K
// step staged in shared memory as float32 (A transposed), and the next K
// step's global loads held in registers while the current one is computed.
// Ragged edges are masked on load (zeros, as the TPU kernel's zero padding)
// and on store, so no operand is copied.  Float32 FMAs only: no tensor
// cores, TMA or wgmma (later work), so the bfloat16 bound is far away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLd = kBM + 4;   // padded shared-memory row (kBM == kBN)
constexpr int kLoads = kBM * kBK / kThreads;  // A (and B) elements per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// A: (M, K), B: (K, N), C: (M, N), all row-major and contiguous.  Sums
// k in [k0, k1).  kAccGlobal: C is float32 and C += the slice's product
// (the hbm policy); otherwise C = the product in OutT (the vmem policy).
template <typename T, typename OutT, bool kAccGlobal>
__global__ void __launch_bounds__(kThreads) matmul_kernel(
    const T* __restrict__ A, const T* __restrict__ B, OutT* __restrict__ C, int M, int N,
    int K, int k0, int k1) {
  __shared__ __align__(16) float As[kBK][kLd];  // A tile, transposed: As[k][m]
  __shared__ __align__(16) float Bs[kBK][kLd];  // B tile: Bs[k][n]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // loader coordinates: A row (tid >> 4) + 16 j, column tid & 15;
  // B row (tid >> 7) + 2 j, column tid & 127
  const int a_r = tid >> 4, a_c = tid & 15, b_r = tid >> 7, b_c = tid & 127;

  float ra[kLoads], rb[kLoads];
  auto load = [&](int k) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int m = m0 + a_r + 16 * j, ka = k + a_c;
      ra[j] = (m < M && ka < k1) ? to_float(A[(size_t)m * K + ka]) : 0.f;
      const int kb = k + b_r + 2 * j, n = n0 + b_c;
      rb[j] = (kb < k1 && n < N) ? to_float(B[(size_t)kb * N + n]) : 0.f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      As[a_c][a_r + 16 * j] = ra[j];
      Bs[b_r + 2 * j][b_c] = rb[j];
    }
  };

  float acc[8][8] = {};
  load(k0);
  stage();
  __syncthreads();
  for (int k = k0; k < k1; k += kBK) {
    const bool more = k + kBK < k1;
    if (more) load(k + kBK);  // in flight while this step computes
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      OutT* c = C + (size_t)m * N + n;
      if constexpr (kAccGlobal) {
        __stcg(reinterpret_cast<float*>(c), __ldcg(reinterpret_cast<const float*>(c)) + acc[i][j]);
      } else {
        store(c, acc[i][j]);
      }
    }
  }
}

template <typename T, typename OutT, bool kAccGlobal>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K, int k0, int k1,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_kernel<T, OutT, kAccGlobal><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<OutT*>(c), M, N, K, k0,
      k1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_in(int out_dtype, int accum_global, const void* a, const void* b, void* c,
                      int M, int N, int K, int k0, int k1, cudaStream_t stream) {
  if (accum_global) return launch<T, float, true>(a, b, c, M, N, K, k0, k1, stream);
  if (out_dtype == 0) return launch<T, float, false>(a, b, c, M, N, K, k0, k1, stream);
  if (out_dtype == 1) return launch<T, __nv_bfloat16, false>(a, b, c, M, N, K, k0, k1, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// in_dtype (A and B) and out_dtype: 0 float32, 1 bfloat16.  accum_global 0:
// C (out_dtype) = A[:, k0:k1] B[k0:k1]; 1: C (float32) += that product.
// Returns the cudaError_t of the launch.
extern "C" int matmul(int in_dtype, int out_dtype, int accum_global, const void* a,
                      const void* b, void* c, int M, int N, int K, int k0, int k1,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return (int)launch_in<float>(out_dtype, accum_global, a, b, c, M, N, K, k0, k1, st);
  if (in_dtype == 1)
    return (int)launch_in<__nv_bfloat16>(out_dtype, accum_global, a, b, c, M, N, K, k0, k1,
                                         st);
  return (int)cudaErrorInvalidValue;
}

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
//     one launch per slice (ceil(K / bk) of them), each summing only k in
//     [k0, k1), reading C with __ldcg and writing it with __stcg (through
//     L2, past L1), so no compiler can keep C in registers across slices:
//     every pass moves M x N x 8 bytes.  The wrapper casts to the output
//     type at the end.
//
// Ragged M, N and K edges (and k1) are masked, never padded by a copy.
//
// What bounds it on an H100: OPERATIONS for the square products of the
// paper's sweep (2 M N K FLOPs; at N = 4096 that is 1.4e11 FLOPs against
// 200 MB moved), over 67 TFLOP/s for float32 inputs (the card's float32
// rate outside the tensor cores) and 989 TFLOP/s for bfloat16.  The hbm
// policy adds 8 M N bytes a pass.
//
// Four routes; the wrapper picks one from the dtype, the row strides, the
// slice start and the pointers' alignment (never from a failed build or
// launch) and passes it in:
//
// float32 ("fma_async", "fma_scalar"), the sweep's type: float32 FMA, no
// TF32 (the tolerances and the 67 TFLOP/s bound assume true float32).  One
// 256-thread block per 128 x 128 tile of C, 8 warps of 64 x 32, each thread
// an 8 x 8 tile (rows 4 apart in two groups 32 apart, columns in two float4
// groups 16 apart).  A 4-stage shared-memory ring of 16-deep K steps with
// one __syncthreads per step; A is kept as stored (k contiguous, rows padded
// to 20 floats so the rows a quarter-warp reads sit on other banks) and read
// as float4 of 4 k values with broadcast, B as float4 rows.  "fma_async"
// fills the ring with 16-byte cp.async (zero fill past the edges and k1);
// it needs K, N and k0 multiples of 4 and 16-byte aligned pointers.
// "fma_scalar" fills the same ring with masked scalar loads.  At most 128
// registers, so two blocks share an SM.
//
// bfloat16 ("wgmma_tma", "wgmma_staged"): the tensor cores.  128 x 128 tiles
// of C, two consumer warpgroups of 64 rows each, 64-deep K steps:
// wgmma m64n128k16 from 128B-swizzled shared memory (A K-major, B read
// MN-major through the transpose bit).  "wgmma_tma": warp 8 keeps a 4-stage
// ring full by TMA (2-D tensor maps whose K extent is k1, so the hardware
// zero-fills past the slice and the edges), with full and empty mbarriers;
// the consumers keep one wgmma group in flight.  TMA needs 16-byte-aligned
// row strides and box starts (K, N and k0 multiples of 8) and base
// pointers; "wgmma_staged" takes every other shape: the 256 threads load
// the next tile with masked scalar loads into registers while the current
// one multiplies, and store it into the same swizzled layout (double
// buffer).  The epilogue casts and
// stores (vmem) or adds to the float32 C (hbm).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// the wrapper's ROUTES, in order
enum Route { kFmaAsync = 0, kFmaScalar = 1, kWgmmaTma = 2, kWgmmaStaged = 3 };

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The hbm policy reads C before it adds and writes: each epilogue first
// loads all the C values it will update (load_run, through L2), then adds
// and stores (store_run), so the loads are in flight together instead of
// each waiting behind the previous store.

// C[row, col + e] for e < n into x (zeros past N).  `vec`: the n values may
// come as one aligned vector load.
template <int n>
__device__ __forceinline__ void load_run(const float* __restrict__ C, int N, int row, int col,
                                         float* x, bool vec) {
  const float* c = C + (size_t)row * N + col;
  if (vec && col + n <= N) {
    if constexpr (n == 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(c));
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(c));
      x[0] = v.x, x[1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < n; ++e) x[e] = col + e < N ? __ldcg(c + e) : 0.f;
}

// The n values x[e] into C[row, col + e], masked at N: cast to OutT, or,
// kAccGlobal, float32 through L2 (past L1).  `vec`: as one aligned vector
// store where the run lies inside N.
template <int n, typename OutT, bool kAccGlobal>
__device__ __forceinline__ void store_run(OutT* __restrict__ C, int N, int row, int col,
                                          const float* x, bool vec) {
  OutT* c = C + (size_t)row * N + col;
  if (vec && col + n <= N) {
    if constexpr (kAccGlobal) {
      if constexpr (n == 4) {
        __stcg(reinterpret_cast<float4*>(c), make_float4(x[0], x[1], x[2], x[3]));
      } else {
        __stcg(reinterpret_cast<float2*>(c), make_float2(x[0], x[1]));
      }
    } else if constexpr (sizeof(OutT) == 4) {
      if constexpr (n == 4) {
        *reinterpret_cast<float4*>(c) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
        *reinterpret_cast<float2*>(c) = make_float2(x[0], x[1]);
      }
    } else {
      uint32_t w[n / 2];
#pragma unroll
      for (int e = 0; e < n / 2; ++e) w[e] = sm90::pack_bf16(x[2 * e], x[2 * e + 1]);
      if constexpr (n == 4) {
        *reinterpret_cast<uint2*>(c) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<uint32_t*>(c) = w[0];
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < n; ++e) {
    if (col + e >= N) break;
    if constexpr (kAccGlobal) {
      __stcg(reinterpret_cast<float*>(c) + e, x[e]);
    } else {
      store1(c + e, x[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: "fma_async" and "fma_scalar"

// kFG float4 column groups per thread: warp tiles of 64 x 16 kFG
constexpr int kFG = 2, kFMinBlocks = 2;
constexpr int kFBM = 128, kFBN = 64 * kFG, kFBK = 16, kFStages = 4, kFThreads = 256;
constexpr int kFLdA = kFBK + 4;  // A row stride in floats: 80 bytes
constexpr int kFStageFloats = kFBM * kFLdA + kFBK * kFBN;
constexpr size_t kFSmemBytes = sizeof(float) * kFStages * kFStageFloats;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One K step into a ring stage: A rows [m0, m0 + kFBM) x k [k, k + kFBK)
// as As[row][k] (row stride kFLdA), B k rows [k, k + kFBK) x [n0, n0 +
// kFBN) as Bs[k][col]; zeros past M, N and k1, in 4-float chunks.
template <bool kAsync>
__device__ __forceinline__ void f32_load_stage(float* As, float* Bs, const float* __restrict__ A,
                                               const float* __restrict__ B, int M, int N, int K,
                                               int m0, int n0, int k, int k1) {
  constexpr int kARow = kFBK / 4, kBRow = kFBN / 4;  // chunks per row
#pragma unroll
  for (int j = 0; j < kFBM * kARow / kFThreads; ++j) {
    const int e = threadIdx.x + kFThreads * j;
    const int ar = e / kARow, ac = (e % kARow) * 4, m = m0 + ar, ka = k + ac;
    float* da = As + ar * kFLdA + ac;
    if constexpr (kAsync) {
      const int na = m < M ? max(0, min(4, k1 - ka)) : 0;
      cp_async16(da, na ? A + (size_t)m * K + ka : A, 4 * na);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) da[x] = (m < M && ka + x < k1) ? A[(size_t)m * K + ka + x] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kFBK * kBRow / kFThreads; ++j) {
    const int e = threadIdx.x + kFThreads * j;
    const int br = e / kBRow, bc = (e % kBRow) * 4, kb = k + br, n = n0 + bc;
    float* db = Bs + br * kFBN + bc;
    if constexpr (kAsync) {
      const int nb = kb < k1 ? max(0, min(4, N - n)) : 0;
      cp_async16(db, nb ? B + (size_t)kb * N + n : B, 4 * nb);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) db[x] = (kb < k1 && n + x < N) ? B[(size_t)kb * N + n + x] : 0.f;
    }
  }
}

template <bool kAsync, typename OutT, bool kAccGlobal>
__global__ void __launch_bounds__(kFThreads, kFMinBlocks)
    matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      OutT* __restrict__ C, int M, int N, int K, int k0, int k1) {
  extern __shared__ float4 f32_smem[];
  float* smem = reinterpret_cast<float*>(f32_smem);
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 16 * kFG;  // 2 x 4 warps
  const int tm = lane >> 2, tn = lane & 3;
  const int ntiles = (k1 - k0 + kFBK - 1) / kFBK;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < ntiles) {
      float* st = smem + s * kFStageFloats;
      f32_load_stage<kAsync>(st, st + kFBM * kFLdA, A, B, M, N, K, m0, n0, k0 + s * kFBK, k1);
    }
    cp_async_commit();
  }

  float acc[8][4 * kFG];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kFG; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kFStages - 2>();  // step t has landed
    __syncthreads();                // ... for every thread; step t - 1 is consumed
    const int nt = t + kFStages - 1;
    if (nt < ntiles) {
      float* st = smem + (nt % kFStages) * kFStageFloats;
      f32_load_stage<kAsync>(st, st + kFBM * kFLdA, A, B, M, N, K, m0, n0, k0 + nt * kFBK, k1);
    }
    cp_async_commit();
    const float* as = smem + (t % kFStages) * kFStageFloats;
    const float* bs = as + kFBM * kFLdA;
#pragma unroll
    for (int k4 = 0; k4 < kFBK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            as + (wm + tm * 4 + (i & 3) + (i >> 2) * 32) * kFLdA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[kFG];
#pragma unroll
        for (int g = 0; g < kFG; ++g)
          b[g] = *reinterpret_cast<const float4*>(bs + (k4 + kk) * kFBN + wn + 16 * g + tn * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = reinterpret_cast<const float*>(&a[i])[kk];
#pragma unroll
          for (int j = 0; j < 4 * kFG; ++j)
            acc[i][j] = fmaf(av, reinterpret_cast<const float*>(b)[j], acc[i][j]);
        }
      }
    }
  }

  // rows in two halves of 4, so one half's loads of C fit in registers
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (kAccGlobal) {
      float old[4][4 * kFG];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = m0 + wm + tm * 4 + ii + h * 32;
#pragma unroll
        for (int g = 0; g < kFG; ++g) {
          if (row < M)
            load_run<4>(reinterpret_cast<const float*>(C), N, row, n0 + wn + 16 * g + tn * 4,
                        &old[ii][4 * g], vec);
          else
            old[ii][4 * g] = old[ii][4 * g + 1] = old[ii][4 * g + 2] = old[ii][4 * g + 3] = 0.f;
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 4 * kFG; ++j) acc[4 * h + ii][j] += old[ii][j];
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = m0 + wm + tm * 4 + ii + h * 32;
      if (row >= M) continue;
#pragma unroll
      for (int g = 0; g < kFG; ++g)
        store_run<4, OutT, kAccGlobal>(C, N, row, n0 + wn + 16 * g + tn * 4,
                                       &acc[4 * h + ii][4 * g], vec);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: "wgmma_tma" and "wgmma_staged"

constexpr int kGBM = 128, kGBN = 128, kGBK = 64;
constexpr int kGABytes = kGBM * 128;      // A tile: 128 rows of 64 k
constexpr int kGBBox = kGBK * 128;        // one B box: 64 k rows of 64 n
constexpr int kGBBytes = 2 * kGBBox;      // B tile: two boxes across n
constexpr int kGStages = 4;
constexpr int kGThreads = 288;  // warpgroups 0-1 compute, warp 8 loads
constexpr int kGConsumerWarps = 8;

struct TmaSmem {
  alignas(1024) uint8_t a[kGStages][kGABytes];
  alignas(1024) uint8_t b[kGStages][kGBBytes];
  uint64_t full[kGStages], empty[kGStages];
};

struct StagedSmem {
  alignas(1024) uint8_t a[2][kGABytes];
  alignas(1024) uint8_t b[2][kGBBytes];
};

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(uint8_t* raw) {
  return *reinterpret_cast<Smem*>(raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023));
}

// acc += this warpgroup's 64 rows of the A tile times the B tile (64 deep).
__device__ __forceinline__ void wgmma_tile(float (&acc)[64], const uint8_t* a_tile,
                                           const uint8_t* b_tile, int wg) {
  const uint32_t a = sm90::smem_u32(a_tile) + wg * 64 * 128;
  const uint32_t b = sm90::smem_u32(b_tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_ss_n128<1>(acc, sm90::wgmma_desc(a + 32 * kk, 16, 1024),
                           sm90::wgmma_desc(b + kk * 16 * 128, kGBBox, 1024), 1);
}

// The warpgroup's 64 x 128 accumulator tile into C at (row0, n0).
template <typename OutT, bool kAccGlobal>
__device__ __forceinline__ void store_acc(float (&acc)[64], OutT* __restrict__ C, int M, int N,
                                          int row0, int n0) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + 16 * ((threadIdx.x >> 5) & 3) + lane / 4;
  const bool vec = (N & 1) == 0;
  if constexpr (kAccGlobal) {
    float old[64];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = r + 8 * ((i >> 1) & 1);
      if (row < M)
        load_run<2>(reinterpret_cast<const float*>(C), N, row,
                    n0 + 8 * (i >> 2) + 2 * (lane & 3), &old[i], vec);
      else
        old[i] = old[i + 1] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += old[i];
  }
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = r + 8 * ((i >> 1) & 1);
    if (row < M)
      store_run<2, OutT, kAccGlobal>(C, N, row, n0 + 8 * (i >> 2) + 2 * (lane & 3), &acc[i], vec);
  }
}

template <typename OutT, bool kAccGlobal>
__global__ void __launch_bounds__(kGThreads, 1)
    matmul_wgmma_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                            const __grid_constant__ CUtensorMap map_b, OutT* __restrict__ C,
                            int M, int N, int k0, int k1) {
  extern __shared__ uint8_t tma_smem_raw[];
  TmaSmem& sm = aligned_smem<TmaSmem>(tma_smem_raw);
  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * kGBN;
  const int ntiles = (k1 - k0 + kGBK - 1) / kGBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], kGConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kGConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kGStages, k = k0 + t * kGBK;
        if (t >= kGStages) sm90::mbar_wait(&sm.empty[s], (t / kGStages - 1) & 1);
        sm90::mbar_expect_tx(&sm.full[s], kGABytes + kGBBytes);
        sm90::tma_load_2d(sm.a[s], &map_a, &sm.full[s], k, m0);
        sm90::tma_load_2d(sm.b[s], &map_b, &sm.full[s], n0, k);
        sm90::tma_load_2d(sm.b[s] + kGBBox, &map_b, &sm.full[s], n0 + 64, k);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kGStages;
    sm90::mbar_wait(&sm.full[s], (t / kGStages) & 1);
    sm90::wgmma_fence();
    wgmma_tile(acc, sm.a[s], sm.b[s], wg);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // step t - 1's products are done: release its stage
    __syncwarp();
    if (t > 0 && lane == 0) sm90::mbar_arrive(&sm.empty[(t - 1) % kGStages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  store_acc<OutT, kAccGlobal>(acc, C, M, N, m0 + 64 * wg, n0);
}

template <typename OutT, bool kAccGlobal>
__global__ void __launch_bounds__(256, 1)
    matmul_wgmma_staged_kernel(const __nv_bfloat16* __restrict__ A,
                               const __nv_bfloat16* __restrict__ B, OutT* __restrict__ C, int M,
                               int N, int K, int k0, int k1) {
  extern __shared__ uint8_t staged_smem_raw[];
  StagedSmem& sm = aligned_smem<StagedSmem>(staged_smem_raw);
  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * kGBN;
  const int ntiles = (k1 - k0 + kGBK - 1) / kGBK;
  const int tid = threadIdx.x, wg = tid / 128;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // element e = tid + 256 j of the A tile is (e / 64, e % 64), of the B
  // tile (e / 128, e % 128): consecutive threads read consecutive columns
  __nv_bfloat16 ra[32], rb[32];
  auto load = [&](int k) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int e = tid + 256 * j;
      const int m = m0 + (e >> 6), ka = k + (e & 63);
      ra[j] = (m < M && ka < k1) ? A[(size_t)m * K + ka] : zero;
      const int kb = k + (e >> 7), n = n0 + (e & 127);
      rb[j] = (kb < k1 && n < N) ? B[(size_t)kb * N + n] : zero;
    }
  };
  auto stage = [&](int s) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int e = tid + 256 * j;
      *reinterpret_cast<__nv_bfloat16*>(sm.a[s] + sm90::swizzle128(e >> 6, e & 63)) = ra[j];
      const int c = e & 127;
      *reinterpret_cast<__nv_bfloat16*>(sm.b[s] + (c >> 6) * kGBBox +
                                        sm90::swizzle128(e >> 7, c & 63)) = rb[j];
    }
    sm90::fence_proxy_async();  // the stores become visible to wgmma
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  load(k0);
  stage(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const bool more = t + 1 < ntiles;
    if (more) load(k0 + (t + 1) * kGBK);  // in flight while this step multiplies
    sm90::wgmma_fence();
    wgmma_tile(acc, sm.a[t & 1], sm.b[t & 1], wg);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    if (more) stage((t + 1) & 1);  // that buffer's products finished a step ago
    __syncthreads();
  }
  sm90::fence_regs(acc);
  store_acc<OutT, kAccGlobal>(acc, C, M, N, m0 + 64 * wg, n0);
}

// ---------------------------------------------------------------------------
// launches

template <typename OutT, bool kAccGlobal>
cudaError_t launch(int route, const void* a, const void* b, void* c, int M, int N, int K, int k0,
                   int k1, cudaStream_t stream) {
  OutT* C = static_cast<OutT*>(c);
  if (route == kFmaAsync || route == kFmaScalar) {
    auto kern = route == kFmaAsync ? matmul_f32_kernel<true, OutT, kAccGlobal>
                                   : matmul_f32_kernel<false, OutT, kAccGlobal>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kFSmemBytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
    kern<<<grid, kFThreads, kFSmemBytes, stream>>>(static_cast<const float*>(a),
                                                   static_cast<const float*>(b), C, M, N, K,
                                                   k0, k1);
    return cudaGetLastError();
  }
  const dim3 grid((N + kGBN - 1) / kGBN, (M + kGBM - 1) / kGBM);
  if (route == kWgmmaTma) {
    CUtensorMap ma, mb;
    const cuuint64_t da[2] = {(cuuint64_t)k1, (cuuint64_t)M}, sa[1] = {(cuuint64_t)K * 2};
    const cuuint64_t db[2] = {(cuuint64_t)N, (cuuint64_t)k1}, sb[1] = {(cuuint64_t)N * 2};
    const cuuint32_t box_a[2] = {64, kGBM}, box_b[2] = {64, kGBK};
    cudaError_t e = sm90::bf16_tensor_map(&ma, a, 2, da, sa, box_a);
    if (e == cudaSuccess) e = sm90::bf16_tensor_map(&mb, b, 2, db, sb, box_b);
    if (e != cudaSuccess) return e;
    auto kern = matmul_wgmma_tma_kernel<OutT, kAccGlobal>;
    const size_t smem = sizeof(TmaSmem) + 1024;  // + room to align to 1024
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kGThreads, smem, stream>>>(ma, mb, C, M, N, k0, k1);
    return cudaGetLastError();
  }
  auto kern = matmul_wgmma_staged_kernel<OutT, kAccGlobal>;
  const size_t smem = sizeof(StagedSmem) + 1024;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, 256, smem, stream>>>(static_cast<const __nv_bfloat16*>(a),
                                    static_cast<const __nv_bfloat16*>(b), C, M, N, K, k0, k1);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// route: 0 "fma_async", 1 "fma_scalar" (float32 inputs), 2 "wgmma_tma", 3
// "wgmma_staged" (bfloat16 inputs); a route whose layout needs are not met
// is refused.  in_dtype (A and B) and out_dtype: 0 float32, 1 bfloat16.
// accum_global 0: C (out_dtype) = A[:, k0:k1] B[k0:k1]; 1: C (float32) +=
// that product.  Returns the cudaError_t of the launch.
extern "C" int matmul(int route, int in_dtype, int out_dtype, int accum_global, const void* a,
                      const void* b, void* c, int M, int N, int K, int k0, int k1,
                      void* stream) {
  const bool f32 = route == kFmaAsync || route == kFmaScalar;
  if (route < 0 || route > kWgmmaStaged || in_dtype != (f32 ? 0 : 1) || M <= 0 || N <= 0 ||
      k0 < 0 || k1 <= k0 || k1 > K)
    return (int)cudaErrorInvalidValue;
  if (route == kFmaAsync &&
      (K % 4 || N % 4 || k0 % 4 || !aligned16(a) || !aligned16(b)))
    return (int)cudaErrorInvalidValue;
  if (route == kWgmmaTma && (K % 8 || N % 8 || k0 % 8 || !aligned16(a) || !aligned16(b)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (accum_global) return (int)launch<float, true>(route, a, b, c, M, N, K, k0, k1, st);
  if (out_dtype == 0) return (int)launch<float, false>(route, a, b, c, M, N, K, k0, k1, st);
  if (out_dtype == 1)
    return (int)launch<__nv_bfloat16, false>(route, a, b, c, M, N, K, k0, k1, st);
  return (int)cudaErrorInvalidValue;
}

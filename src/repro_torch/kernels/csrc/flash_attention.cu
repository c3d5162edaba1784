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
// Two variants; the wrapper picks one from the dtype and head_dim (never
// from a failed build or launch) and passes it in:
//
// "wgmma" (bf16, hd 64 or 128: the training path).  One block per (bh,
// 128-row query tile), the heaviest tiles (nearest the end of the sequence)
// dispatched first.  Warp 8 is the producer: one thread loads the q tile
// once and keeps 64-key K and V tiles in flight through a 3-stage ring in
// shared memory, by TMA (3-D tensor maps over (BH or BKV, S, hd), so rows
// past S are zero-filled and never read another head's rows), 128-byte
// swizzle, each tile a row of 64-column boxes, each stage with its own
// K-full, V-full and empty mbarriers.  Warpgroups 0 and 1 each own 64 query
// rows: S = Q K^T is wgmma m64n64k16 from shared memory (q and K K-major, as
// stored); the softmax runs in registers on the accumulators; O += P V is
// wgmma m64n(hd)k16 with P from registers and V from shared memory, read
// transposed through the descriptor's transpose bit.  Key tiles wholly
// below the diagonal (and inside the window) skip the mask; tiles above
// the diagonal or wholly older than the window are skipped.  On tensor
// cores the TPU kernel's arithmetic holds as follows: bf16 x bf16 products
// are exact in float32 and wgmma accumulates in float32, so the score is
// q_f32 . k_f32 as there; the hd^-0.5 scale is applied to that float32
// score (times log2 e, for exp2) instead of to q, which differs by float32
// rounding only; the row sum l is taken from the float32 p, and then p is
// rounded to bf16 in registers as the A operand of the PV product.  What
// this design leaves for later: overlapping one tile's softmax with the
// next tile's QK^T, 128-key tiles with setmaxnreg, a TMA store of O.
//
// "simt" (float32, the parity route, and any other hd, a multiple of 8 up
// to 256; TF32 would change the float32 result): one 256-thread block per
// (bh, 64-row query tile), heaviest first.  The TPU grid's sequential K axis
// becomes a loop inside the block over the 64-row K/V tiles up to the
// diagonal.  q, K and V tiles are staged in shared memory as float32 with
// 16-byte global loads (K and V share one buffer); each thread computes a
// 4 x 4 score tile and a 4 x (4 NC) slice of the 64 x hd accumulator with
// float32 FMAs — NC = ceil(hd / 64) groups of 4 columns, at 4 tx + 64 g —
// and keeps its rows' m and l in registers (the 16 threads of a row reduce
// with shuffles).  The kernel is instantiated for NC = 1..4: up to hd 128
// two blocks fit on an SM (at hd 128, 84,992 B of shared memory each); at
// hd 256 one block takes 150,528 B, so those instantiations are bound for
// one block an SM.  Its ceiling is the card's 67 TFLOP/s of float32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// the wrapper's VARIANTS, in order
enum Variant { kSimt = 0, kWgmma = 1 };

// ---------------------------------------------------------------------------
// the "simt" variant

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMaxHd = 256;    // 16 threads x 4 columns x 4 groups
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
// aligned, hd a multiple of 8 with ceil(hd / 64) == NC.  window <= 0 means
// none.  Up to hd 128 two blocks share an SM, past it one.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 2 : 1) flash_attention_kernel(
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

  // acc[i][4 g + e]: row ty + 16 i, column 4 tx + 64 g + e
  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[i][e] = 0.f;
  }
  bool col_ok[NC];  // this thread's column group g lies inside hd
#pragma unroll
  for (int g = 0; g < NC; ++g) col_ok[g] = 4 * tx + 64 * g < hd;
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
      for (int e = 0; e < 4 * NC; ++e) acc[i][e] *= corr[i];
    for (int r = 0; r < kBK; ++r) {
      float4 vv[NC];
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        vv[g] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col_ok[g]) vv[g] = *reinterpret_cast<const float4*>(kv_s + r * ld + 4 * tx + 64 * g);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kLdP + r];
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          acc[i][4 * g + 0] = fmaf(p, vv[g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p, vv[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, vv[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, vv[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }

  T* ob = out + (size_t)bh * S * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float o[4 * NC];
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) o[e] = acc[i][e] / den;
#pragma unroll
    for (int g = 0; g < NC; ++g)
      if (col_ok[g]) store4(ob + (size_t)row * hd + 4 * tx + 64 * g, o + 4 * g);
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* out, int BH, int S,
                      int hd, int G, int window, float scale, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NC>;
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

// The "simt" kernel instantiated for the hd's number of 64-column groups.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int S,
                   int hd, int G, int window, float scale, cudaStream_t stream) {
  switch ((hd + 63) / 64) {
    case 1: return launch_nc<T, 1>(q, k, v, out, BH, S, hd, G, window, scale, stream);
    case 2: return launch_nc<T, 2>(q, k, v, out, BH, S, hd, G, window, scale, stream);
    case 3: return launch_nc<T, 3>(q, k, v, out, BH, S, hd, G, window, scale, stream);
    case 4: return launch_nc<T, 4>(q, k, v, out, BH, S, hd, G, window, scale, stream);
  }
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// the "wgmma" variant (bf16, hd 64 or 128)

constexpr int kWgBQ = 128;       // query rows per block: two warpgroups of 64
constexpr int kWgBK = 64;        // keys per K/V tile
constexpr int kWgStages = 3;     // K/V ring depth
constexpr int kWgThreads = 288;  // warpgroups 0-1 compute, warp 8 loads
constexpr int kWgConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WgSmem {
  static constexpr int kBoxes = HD / 64;         // 64-column swizzle boxes per row
  static constexpr int kQBox = kWgBQ * 128;      // bytes of one q box
  static constexpr int kKvBox = kWgBK * 128;     // bytes of one K or V box
  static constexpr int kKvBytes = kBoxes * kKvBox;
  alignas(1024) uint8_t q[kBoxes * kQBox];
  alignas(1024) uint8_t k[kWgStages][kKvBytes];
  alignas(1024) uint8_t v[kWgStages][kKvBytes];
  uint64_t q_full, k_full[kWgStages], v_full[kWgStages], empty[kWgStages];
};

// One block per (bh = blockIdx.x, query tile nq - 1 - blockIdx.y).  The
// tensor maps cover q (BH, S, hd) and k, v (BKV, S, hd) in boxes of
// (1, rows, 64).  out: (BH, S, hd) bf16.  window <= 0 means none.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out, int S, int G,
    int window, float scale_log2) {
  using Smem = WgSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBQ;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kWgBK : 0;
  const int kt_hi = (min(q0 + kWgBQ, S) - 1) / kWgBK;
  const int ntiles = kt_hi - kt_lo + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.empty[s], kWgConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWgConsumerWarps) {  // the producer
    if (lane == 0) {
      const int bkv = bh / G;
      sm90::mbar_expect_tx(&sm.q_full, sizeof(sm.q));
      for (int b = 0; b < Smem::kBoxes; ++b)
        sm90::tma_load_3d(sm.q + b * Smem::kQBox, &map_q, &sm.q_full, 64 * b, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages) sm90::mbar_wait(&sm.empty[s], (t / kWgStages - 1) & 1);
        const int k0 = (kt_lo + t) * kWgBK;
        sm90::mbar_expect_tx(&sm.k_full[s], Smem::kKvBytes);
        for (int b = 0; b < Smem::kBoxes; ++b)
          sm90::tma_load_3d(sm.k[s] + b * Smem::kKvBox, &map_k, &sm.k_full[s], 64 * b, k0, bkv);
        sm90::mbar_expect_tx(&sm.v_full[s], Smem::kKvBytes);
        for (int b = 0; b < Smem::kBoxes; ++b)
          sm90::tma_load_3d(sm.v[s] + b * Smem::kKvBox, &map_v, &sm.v_full[s], 64 * b, k0, bkv);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [r_lo, r_lo + 64); this thread's rows are
  // r0 and r0 + 8 (the accumulator layout of sm90.cuh)
  const int wg = warp / 4;
  const int r_lo = q0 + 64 * wg;
  const int r0 = r_lo + 16 * (warp % 4) + lane / 4;
  const bool live = r_lo < S;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part
  const uint32_t q_addr = sm90::smem_u32(sm.q) + wg * 64 * 128;

  sm90::mbar_wait(&sm.q_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kWgStages;
    const uint32_t parity = (t / kWgStages) & 1;
    const int k0 = (kt_lo + t) * kWgBK;
    const bool skip = !live || k0 > r_lo + 63 ||
                      (window > 0 && r_lo - (k0 + kWgBK - 1) >= window);
    sm90::mbar_wait(&sm.k_full[s], parity);
    if (!skip) {
      // S = Q K^T over the tile's 64 keys, in float32
      float sc[32];
      const uint32_t k_addr = sm90::smem_u32(sm.k[s]);
      sm90::wgmma_fence();
#pragma unroll
      for (int b = 0; b < Smem::kBoxes; ++b)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::wgmma_ss_n64<0>(
              sc, sm90::wgmma_desc(q_addr + b * Smem::kQBox + 32 * kk, 16, 1024),
              sm90::wgmma_desc(k_addr + b * Smem::kKvBox + 32 * kk, 16, 1024), b + kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // scale, mask, online softmax; p = 0 outright where masked
      const bool unmasked =
          k0 + kWgBK - 1 <= r_lo && (window <= 0 || r_lo + 63 - k0 < window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * scale_log2;
        if (!unmasked) {
          const int row = r0 + 8 * ((i >> 1) & 1);
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (col > row || (window > 0 && row - col >= window)) x = kNegInf;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      uint32_t pa[4][4];  // P as the A operand, one k16 step per key group
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = sc[i] == kNegInf ? 0.f : exp2f(sc[i] - m[r]);
        const float p1 = sc[i + 1] == kNegInf ? 0.f : exp2f(sc[i + 1] - m[r]);
        l[r] += p0 + p1;  // the sum before p is rounded to bf16
        pa[i >> 3][(i >> 1) & 3] = sm90::pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V
      sm90::mbar_wait(&sm.v_full[s], parity);
      const uint32_t v_addr = sm90::smem_u32(sm.v[s]);
      sm90::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sm90::wgmma_desc(v_addr + kk * 16 * 128, Smem::kKvBox, 1024);
        if constexpr (HD == 128) {
          sm90::wgmma_rs_n128<1>(o, pa[kk], dv, 1);
        } else {
          sm90::wgmma_rs_n64<1>(o, pa[kk], dv, 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    } else {
      sm90::mbar_wait(&sm.v_full[s], parity);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);  // this warp is done with stage s
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + ((size_t)bh * S + row) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint32_t packed = sm90::pack_bf16(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = packed;
    }
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int BH, int BKV,
                         int S, int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)S * HD * 2};
  const cuuint64_t dq[3] = {HD, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t dkv[3] = {HD, (cuuint64_t)S, (cuuint64_t)BKV};
  const cuuint32_t box_q[3] = {64, kWgBQ, 1}, box_kv[3] = {64, kWgBK, 1};
  cudaError_t e = sm90::bf16_tensor_map(&mq, q, 3, dq, strides, box_q);
  if (e == cudaSuccess) e = sm90::bf16_tensor_map(&mk, k, 3, dkv, strides, box_kv);
  if (e == cudaSuccess) e = sm90::bf16_tensor_map(&mv, v, 3, dkv, strides, box_kv);
  if (e != cudaSuccess) return e;
  auto kern = flash_wgmma_kernel<HD>;
  const size_t smem = sizeof(WgSmem<HD>) + 1024;  // + room to align to 1024
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (S + kWgBQ - 1) / kWgBQ);
  kern<<<grid, kWgThreads, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(out), S,
                                           BH / BKV, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// variant: a Variant (wgmma: bf16 with hd 64 or 128 only; simt: any hd, a
// multiple of 8 up to 256).  dtype: 0
// float32, 1 bfloat16 (q, k, v and out share it).  window <= 0 means none.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention(int variant, int dtype, const void* q, const void* k,
                               const void* v, void* out, int BH, int BKV, int S, int hd,
                               int window, float scale, void* stream) {
  if (BKV <= 0 || BH % BKV != 0 || hd % 8 != 0 || hd > kMaxHd || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = BH / BKV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (hd == 128) return (int)launch_wgmma<128>(q, k, v, out, BH, BKV, S, window, scale, st);
    if (hd == 64) return (int)launch_wgmma<64>(q, k, v, out, BH, BKV, S, window, scale, st);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != kSimt) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(q, k, v, out, BH, S, hd, G, window, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, out, BH, S, hd, G, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Ragged paged flash attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/ragged_paged_flash.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:ragged_paged_flash
// (pallas_call body _ragged_decode_kernel): attention for a flat pack of T
// query tokens from any serving slots.  Token t reads its slot's KV through
// token -> slot[t] -> block-table row ptab[slot] -> pool page, and sees the
// first lens[t] entries of that context (lens = q_pos + 1, so intra-pack
// causality is a length cut).  Scores are float32 with q scaled by hd^-0.5,
// masked with -1e30; int8 pools use their per-entry scale rows; lens == 0
// gives zeros; sentinel block-table entries clamp into the pool (their
// entries lie beyond lens).  Any G, not only powers of two.
//
// What bounds it on an H100: BYTES.  The least traffic is the unique KV pages
// the pack's slots touch (plus scale rows for int8), q and the output, over
// 3.35 TB/s; the arithmetic is a few operations per byte read.
//
// Design.  One call is three kernels on the stream, counted as one launch by
// the wrapper:
//   1. ragged_plan_kernel (one block) cuts the pack into query tiles: a tile
//      starts where the slot changes, or every TT tokens into a run of one
//      slot, so a tile is up to TT consecutive tokens of one slot (TT = 16
//      for qwen2-1.5b's G = 6: 96 query rows).  It writes the tiles' first
//      tokens.  Any token order is right; the engine's packs, which hold
//      each slot's tokens as one run, give the fewest tiles.
//   2. The attention kernel.  Block (x, kv head and row chunk, split j)
//      serves tiles x, x + gridDim.x, ... for the key range [j KS, (j + 1)
//      KS) of the tile's visible context (split-K; KS, from the wrapper, is
//      at least 128 keys and at most 1/16 of a row): every row of the tile
//      (its tokens' G query heads) reads each K/V tile of that range once,
//      up to the tile's longest lens, and masks at its own lens.  A row
//      whose context fits one split writes its output directly; the others
//      write a float32 partial (running max m, denominator l, numerator
//      acc) to a workspace.  A split that lies wholly past a row's lens is
//      neither written nor read for that row.  The grid has a fixed size
//      from shapes alone (no host synchronisation); blocks with no work
//      return at once.
//      Variant "mma" (bfloat16 q over bfloat16 or int8 pools, hd 64 or 128,
//      16-byte aligned): six warps, one m16 row tile each; 64-key K/V tiles
//      arrive by 16-byte cp.async in a two-stage ring (rows padded to keep
//      the fragment loads free of bank conflicts; each step's 64 pool rows
//      are looked up once, into shared memory, then copied); QK^T and PV
//      run on mma.sync m16n8k16 bf16 with float32 accumulators, the online
//      softmax in registers, P rounded to bf16 after its row sum.  int8 pages are widened to bf16 in shared
//      memory (exact for -127..127); the K scale multiplies the float32
//      score, the V scale is folded into P before it is rounded.
//      Variant "simt" (everything else; the float32 parity route): the same
//      tiles and splits, 32 rows and 32 keys a step, float32 FMA, K/V
//      dequantized to float32 in shared memory on the way in.
//   3. ragged_merge_kernel combines the partials of rows with two or more
//      splits (max-rescaled sums) into the output.
// Left for later: TMA page loads, wgmma, a persistent grid, fusing the plan
// and merge kernels into the attention kernel, and spreading a decode
// tile's single m16 row tile over the six warps (one warp computes while
// five only load).

#include <type_traits>

#include "paged.cuh"

namespace {

using namespace paged;

enum Variant { kSimt = 0, kMma = 1 };

constexpr int kTileTokens = 16;    // most pack tokens in one query tile
constexpr int kMaxSplits = 16;     // most key splits of a block-table row
constexpr int kPlanThreads = 1024;

constexpr int kMmaThreads = 192;  // six warps, one m16 row tile each
constexpr int kMmaRows = 96;
constexpr int kMmaKeys = 64;  // keys per ring step

constexpr int kSimtThreads = 128;
constexpr int kSimtRows = 32;
constexpr int kSimtKeys = 32;

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int32_t* ptab;
  const int32_t* slot;
  const int32_t* lens;
  void* out;
  const int32_t* tiles;  // [0] the number of tiles, [1 + k] tile k's first token
  float* ws_acc;         // (NS, T, kvH, G, hd) partial numerators
  float* ws_ml;          // (NS, T, kvH, G, 2) partial (m, l)
  int T, kvH, G, hd, page, npages, B, pps, S, KS, TT, RM;
  float scale;
};

// Visible entries of a token: lens clamped to [0, S] (the block-table row
// holds S = pps * page entries).
__device__ __forceinline__ int visible(const Params& p, int t) {
  return min(max(p.lens[t], 0), p.S);
}
__device__ __forceinline__ int n_splits(int L, int KS) { return L > 0 ? (L + KS - 1) / KS : 0; }

// ---------------------------------------------------------------------------
// 1. the plan

struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MaxOp {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Inclusive scan over the kPlanThreads threads of the block.
template <typename Op>
__device__ int block_scan(int x, int* warp_tot, Op op, int identity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(x, y);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kPlanThreads / 32 ? warp_tot[lane] : identity;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, y);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = op(x, warp_tot[warp - 1]);
  __syncthreads();  // warp_tot is free for the next scan
  return x;
}

// tiles[1 + k] = first token of tile k, tiles[0] = the number of tiles.  A
// tile starts at t where slot[t] != slot[t - 1], or TT tokens after the
// previous start in the same run.
__global__ void __launch_bounds__(kPlanThreads) ragged_plan_kernel(const int32_t* __restrict__ slot,
                                                                  int T, int TT,
                                                                  int32_t* __restrict__ tiles) {
  __shared__ int warp_tot[32];
  __shared__ int carry_run, carry_n;
  if (threadIdx.x == 0) carry_run = carry_n = 0;
  __syncthreads();
  for (int c0 = 0; c0 < T; c0 += kPlanThreads) {
    const int t = c0 + threadIdx.x;
    const bool in = t < T;
    const bool brk = in && (t == 0 || slot[t] != slot[t - 1]);
    const int run = max(block_scan(brk ? t : -1, warp_tot, MaxOp(), -1), carry_run);
    const bool start = in && (t - run) % TT == 0;
    const int k = block_scan(start ? 1 : 0, warp_tot, SumOp(), 0);
    if (start) tiles[carry_n + k] = t;  // 1 + (carry_n + k - 1)
    __syncthreads();
    if (threadIdx.x == kPlanThreads - 1) {
      carry_run = run;
      carry_n += k;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) tiles[0] = carry_n;
}

// ---------------------------------------------------------------------------
// 2. shared by both attention variants

struct TileInfo {
  int start, n_tok, lmax, b;
  int len[kTileTokens];
};

// Warp 0 reads tile `tile`'s tokens: the run of up to TT tokens from its
// start that share its slot, their visible lengths and the longest.  `start`
// was read by the caller together with the tile count.
__device__ __forceinline__ void read_tile(const Params& p, int start, TileInfo& ti) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int tok = min(start + lane, p.T - 1);
  const int s_tok = p.slot[tok];  // in flight together with the next two loads
  const int l_tok = min(max(p.lens[tok], 0), p.S);
  const int s0 = p.slot[start];
  const bool same = lane < p.TT && start + lane < p.T && s_tok == s0;
  const unsigned stop = __ballot_sync(0xffffffffu, !same);
  const int n = __ffs(stop) - 1;  // lanes >= TT never match, so stop != 0
  const int L = lane < n ? l_tok : 0;
  const int lmax = __reduce_max_sync(0xffffffffu, L);
  if (lane < n) ti.len[lane] = L;
  if (lane == 0) {
    ti.start = start;
    ti.n_tok = n;
    ti.lmax = lmax;
    ti.b = min(max(s0, 0), p.B - 1);
  }
}

// Where row `fr` of a tile (token fr / G, query head fr % G) finishes:
// directly into the output, or as split j's partial, or not at all.
template <typename QT, typename F>
__device__ __forceinline__ void finish_row(const Params& p, const TileInfo& ti, int h, int j,
                                           int fr, float m, float l, F&& acc_at) {
  const int i = fr / p.G, gg = fr - i * p.G;
  const int t = ti.start + i;
  const int ns = n_splits(ti.len[i], p.KS);
  const size_t row = ((size_t)t * p.kvH + h) * p.G + gg;
  if (j == 0 && ns <= 1) {
    acc_at(static_cast<QT*>(p.out) + row * p.hd, 1.f / fmaxf(l, 1e-30f));
  } else if (j < ns) {
    const size_t prow = (size_t)j * p.T * p.kvH * p.G + row;
    acc_at(p.ws_acc + prow * p.hd, 1.f);
    p.ws_ml[prow * 2] = m;
    p.ws_ml[prow * 2 + 1] = l;
  }
}

// The pool row ((page * P + offset) * kvH + h) of key `a` of block-table row
// `prow`, or -1 past `ke` (a key the tile does not need: zeros instead).
__device__ __forceinline__ int key_row(const Params& p, const int32_t* prow, int a, int ke,
                                       int h) {
  if (a >= ke) return -1;
  const int pg = min(max(prow[a / p.page], 0), p.npages - 1);
  return (pg * p.page + a % p.page) * p.kvH + h;
}

// ---------------------------------------------------------------------------
// 2a. the tensor-core variant

// Shared-memory layout of the mma variant (bytes; at most 98,816 at hd 128
// with int8 pools, so two blocks share an SM): q rows, a two-stage ring of
// raw K and V tiles, for int8 the tiles widened to bf16 and the stages'
// scale rows.  A bf16 row is hd * 2
// bytes plus 16 of padding: 8 rows then fall on distinct banks.
template <int HD, bool kQuant>
struct MmaSmem {
  static constexpr int kRow = HD * 2 + 16;                  // bf16 row stride
  static constexpr int kRawRow = kQuant ? HD + 16 : kRow;   // pool row stride
  static constexpr int kQ = 0;
  static constexpr int kRaw = kQ + kMmaRows * kRow;          // [stage][K|V][key]
  static constexpr int kConv = kRaw + 2 * 2 * kMmaKeys * kRawRow;  // [K|V][key]
  static constexpr int kScales = kConv + (kQuant ? 2 * kMmaKeys * kRow : 0);  // [stage][K|V][key]
  static constexpr int kBytes = kScales + (kQuant ? 2 * 2 * kMmaKeys * 4 : 0);
};

template <int HD, bool kQuant>
__global__ void __launch_bounds__(kMmaThreads, 2) ragged_mma_kernel(const Params p) {
  using KT = typename std::conditional<kQuant, int8_t, __nv_bfloat16>::type;
  using L = MmaSmem<HD, kQuant>;
  constexpr int kChunks = HD * (int)sizeof(KT) / 16;  // 16-byte chunks in a pool row
  extern __shared__ __align__(16) char smem[];
  __shared__ TileInfo ti;
  __shared__ int key_rows[kMmaKeys];  // the step's pool rows (key_row)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y % p.kvH, chunk = blockIdx.y / p.kvH, j = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const KT* kp = static_cast<const KT*>(p.kp);
  const KT* vp = static_cast<const KT*>(p.vp);
  const int n_tiles = p.tiles[0];
  const int first = p.tiles[1 + blockIdx.x];  // gridDim.x <= T: always in the buffer

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile is done with ti and the buffers
    read_tile(p, tile == blockIdx.x ? first : p.tiles[1 + tile], ti);
    __syncthreads();
    const int rows = min(kMmaRows, ti.n_tok * p.G - chunk * kMmaRows);
    const int kb = j * p.KS;
    if (rows <= 0 || (j > 0 && kb >= ti.lmax)) continue;
    const int ke = min(kb + p.KS, ti.lmax);
    const int nsteps = ke > kb ? (ke - kb + kMmaKeys - 1) / kMmaKeys : 0;
    const int32_t* prow = p.ptab + (size_t)ti.b * p.pps;

    auto load_step = [&](int s, int st) {
      if (tid < kMmaKeys) key_rows[tid] = key_row(p, prow, kb + s * kMmaKeys + tid, ke, h);
      __syncthreads();
      for (int i = tid; i < 2 * kMmaKeys * kChunks; i += kMmaThreads) {
        const int which = i / (kMmaKeys * kChunks);
        const int rem = i - which * kMmaKeys * kChunks;
        const int r = rem / kChunks, c = rem - r * kChunks;
        const int e = key_rows[r];
        cp_async16(smem + L::kRaw + ((st * 2 + which) * kMmaKeys + r) * L::kRawRow + c * 16,
                   (which ? vp : kp) + (e < 0 ? 0 : (size_t)e * HD + c * (16 / sizeof(KT))),
                   e < 0 ? 0 : 16);
      }
      if (kQuant) {
        for (int i = tid; i < 2 * kMmaKeys; i += kMmaThreads) {
          const int which = i / kMmaKeys, r = i - which * kMmaKeys;
          const int e = key_rows[r];
          cp_async4(smem + L::kScales + ((st * 2 + which) * kMmaKeys + r) * 4,
                    (which ? p.vs : p.ks) + max(e, 0), e < 0 ? 0 : 4);
        }
      }
      cp_async_commit();
    };
    if (nsteps > 0) load_step(0, 0);

    // q rows of this chunk (zeros past the tile), then each warp's A fragments
    for (int i = tid; i < kMmaRows * (HD / 8); i += kMmaThreads) {
      const int r = i / (HD / 8), c = i - r * (HD / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows) {
        const int fr = chunk * kMmaRows + r;
        const int tq = ti.start + fr / p.G, gg = fr % p.G;
        v = *reinterpret_cast<const uint4*>(q + (((size_t)tq * p.kvH + h) * p.G + gg) * HD +
                                            c * 8);
      }
      *reinterpret_cast<uint4*>(smem + L::kQ + r * L::kRow + c * 16) = v;
    }
    __syncthreads();
    const int r0 = warp * 16 + g, r1 = r0 + 8;
    const bool busy = warp * 16 < rows;
    const int len0 = r0 < rows ? ti.len[(chunk * kMmaRows + r0) / p.G] : 0;
    const int len1 = r1 < rows ? ti.len[(chunk * kMmaRows + r1) / p.G] : 0;
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const char* q0 = smem + L::kQ + r0 * L::kRow + (kk * 16 + 2 * tig) * 2;
      const char* q1 = q0 + 8 * L::kRow;
      qa[kk][0] = lds32(q0);
      qa[kk][1] = lds32(q1);
      qa[kk][2] = lds32(q0 + 16);
      qa[kk][3] = lds32(q1 + 16);
    }

    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    for (int s = 0; s < nsteps; ++s) {
      const int st = s & 1;
      if (s + 1 < nsteps) {
        load_step(s + 1, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const char* kt = smem + L::kRaw + (st * 2 + 0) * kMmaKeys * L::kRawRow;
      const char* vt = smem + L::kRaw + (st * 2 + 1) * kMmaKeys * L::kRawRow;
      const float* kscale = reinterpret_cast<const float*>(smem + L::kScales) + st * 2 * kMmaKeys;
      const float* vscale = kscale + kMmaKeys;
      if (kQuant) {  // widen the stage's int8 rows to bf16 (exact)
        for (int i = tid; i < 2 * kMmaKeys * (HD / 8); i += kMmaThreads) {
          const int which = i / (kMmaKeys * (HD / 8));
          const int rem = i - which * kMmaKeys * (HD / 8);
          const int r = rem / (HD / 8), c = rem - r * (HD / 8);
          const uint2 raw = *reinterpret_cast<const uint2*>(
              (which ? vt : kt) + r * L::kRawRow + c * 8);
          const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
          uint4 w;
          w.x = pack_bf16(b8[0], b8[1]);
          w.y = pack_bf16(b8[2], b8[3]);
          w.z = pack_bf16(b8[4], b8[5]);
          w.w = pack_bf16(b8[6], b8[7]);
          *reinterpret_cast<uint4*>(smem + L::kConv + (which * kMmaKeys + r) * L::kRow +
                                    c * 16) = w;
        }
        __syncthreads();
        kt = smem + L::kConv;
        vt = smem + L::kConv + kMmaKeys * L::kRow;
      }
      if (busy) {
        const int k0 = kb + s * kMmaKeys;
        float sc[kMmaKeys / 8][4];
#pragma unroll
        for (int n = 0; n < kMmaKeys / 8; ++n) {
          sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
          const char* krow = kt + (n * 8 + g) * L::kRow + 4 * tig;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            mma_bf16(sc[n], qa[kk], lds32(krow + kk * 32), lds32(krow + kk * 32 + 16));
        }
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = n * 8 + 2 * tig + (e & 1);
            float x = sc[n][e] * p.scale;
            if (kQuant) x *= kscale[key];
            x = k0 + key < (e < 2 ? len0 : len1) ? x : kNegInf;
            sc[n][e] = x;
          }
          mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
        }
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = n * 8 + 2 * tig + (e & 1);
            const bool vis = k0 + key < (e < 2 ? len0 : len1);
            const float pe = vis ? expf(sc[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
            if (e < 2) sum0 += pe; else sum1 += pe;
            sc[n][e] = kQuant ? pe * vscale[key] : pe;
          }
        }
        l0 = l0 * c0 + sum0;
        l1 = l1 * c1 + sum1;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][0] *= c0;
          o[n][1] *= c0;
          o[n][2] *= c1;
          o[n][3] *= c1;
        }
#pragma unroll
        for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                  pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                  pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                  pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
          const int mat = lane >> 3;
          const char* vrow =
              vt + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * L::kRow + (mat >> 1) * 16;
#pragma unroll
          for (int dn = 0; dn < HD / 16; ++dn) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vrow + dn * 32);
            mma_bf16(o[2 * dn], pa, b[0], b[1]);
            mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
          }
        }
      }
      __syncthreads();  // the stage (and the widened tiles) may be refilled
    }

    if (busy) {
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= rows) continue;
        finish_row<__nv_bfloat16>(
            p, ti, h, j, chunk * kMmaRows + r, half ? m1 : m0, half ? l1 : l0,
            [&](auto* dst, float mul) {
#pragma unroll
              for (int n = 0; n < HD / 8; ++n) {
                const float a = o[n][2 * half] * mul, b = o[n][2 * half + 1] * mul;
                using D = typename std::remove_pointer<decltype(dst)>::type;
                if constexpr (std::is_same<D, float>::value)
                  *reinterpret_cast<float2*>(dst + n * 8 + 2 * tig) = make_float2(a, b);
                else
                  *reinterpret_cast<uint32_t*>(dst + n * 8 + 2 * tig) = pack_bf16(a, b);
              }
            });
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2b. the float32 FMA variant

// Floats of shared memory (135,680 bytes at the wrapper's largest hd, 256):
// q and the numerators (rows x hd), K (keys x (hd + 1)) and V (keys x hd)
// as float32, scores (rows x keys), m, l and the step's rescale per row.
__host__ __device__ constexpr size_t simt_smem_floats(int hd) {
  return (size_t)2 * kSimtRows * hd + (size_t)kSimtKeys * (hd + 1) + (size_t)kSimtKeys * hd +
         (size_t)kSimtRows * kSimtKeys + 3 * kSimtRows;
}

template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kSimtThreads) ragged_simt_kernel(const Params p) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ TileInfo ti;
  __shared__ int key_rows[kSimtKeys];  // the step's pool rows (key_row)
  const int hd = p.hd;
  float* q_s = fsm;                          // (rows, hd), scaled
  float* acc_s = q_s + kSimtRows * hd;       // (rows, hd)
  float* k_s = acc_s + kSimtRows * hd;       // (keys, hd + 1)
  float* v_s = k_s + kSimtKeys * (hd + 1);   // (keys, hd)
  float* s_s = v_s + kSimtKeys * hd;         // (rows, keys)
  float* m_s = s_s + kSimtRows * kSimtKeys;  // (rows,)
  float* l_s = m_s + kSimtRows;
  float* c_s = l_s + kSimtRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y % p.kvH, chunk = blockIdx.y / p.kvH, j = blockIdx.z;
  const QT* q = static_cast<const QT*>(p.q);
  const KT* kp = static_cast<const KT*>(p.kp);
  const KT* vp = static_cast<const KT*>(p.vp);
  const int n_tiles = p.tiles[0];
  const int first = p.tiles[1 + blockIdx.x];  // gridDim.x <= T: always in the buffer

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();
    read_tile(p, tile == blockIdx.x ? first : p.tiles[1 + tile], ti);
    __syncthreads();
    const int rows = min(kSimtRows, ti.n_tok * p.G - chunk * kSimtRows);
    const int kb = j * p.KS;
    if (rows <= 0 || (j > 0 && kb >= ti.lmax)) continue;
    const int ke = min(kb + p.KS, ti.lmax);
    const int32_t* prow = p.ptab + (size_t)ti.b * p.pps;
    auto row_len = [&](int r) { return ti.len[(chunk * kSimtRows + r) / p.G]; };

    for (int i = tid; i < rows * hd; i += kSimtThreads) {
      const int r = i / hd, d = i - r * hd;
      const int fr = chunk * kSimtRows + r;
      const int tq = ti.start + fr / p.G, gg = fr % p.G;
      q_s[i] = to_float(q[(((size_t)tq * p.kvH + h) * p.G + gg) * hd + d]) * p.scale;
      acc_s[i] = 0.f;
    }
    for (int r = tid; r < rows; r += kSimtThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }

    for (int k0 = kb; k0 < ke; k0 += kSimtKeys) {
      __syncthreads();  // the last step is done with k_s, v_s and s_s
      if (tid < kSimtKeys) key_rows[tid] = key_row(p, prow, k0 + tid, ke, h);
      __syncthreads();
      for (int i = tid; i < kSimtKeys * hd; i += kSimtThreads) {
        const int r = i / hd, d = i - r * hd;
        const int e = key_rows[r];
        float kx = 0.f, vx = 0.f;
        if (e >= 0) {
          kx = to_float(kp[(size_t)e * hd + d]);
          vx = to_float(vp[(size_t)e * hd + d]);
          if (kQuant) {
            kx *= p.ks[e];
            vx *= p.vs[e];
          }
        }
        k_s[r * (hd + 1) + d] = kx;
        v_s[i] = vx;
      }
      __syncthreads();
      for (int i = tid; i < rows * kSimtKeys; i += kSimtThreads) {
        const int r = i / kSimtKeys, k = i - r * kSimtKeys;
        const float* qr = q_s + r * hd;
        const float* kr = k_s + k * (hd + 1);
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
        s_s[i] = k0 + k < row_len(r) ? s : kNegInf;
      }
      __syncthreads();
      for (int r = warp; r < rows; r += kSimtThreads / 32) {
        const float x = s_s[r * kSimtKeys + lane];  // kSimtKeys == 32
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(x));
        const float e = k0 + lane < row_len(r) ? expf(x - m_new) : 0.f;
        s_s[r * kSimtKeys + lane] = e;
        const float sum = warp_sum(e);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          c_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
      for (int i = tid; i < rows * hd; i += kSimtThreads) {
        const int r = i / hd, d = i - r * hd;
        const float* pr = s_s + r * kSimtKeys;
        float a = acc_s[i] * c_s[r];
        for (int k = 0; k < kSimtKeys; ++k) a = fmaf(pr[k], v_s[k * hd + d], a);
        acc_s[i] = a;
      }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kSimtThreads / 32) {
      finish_row<QT>(p, ti, h, j, chunk * kSimtRows + r, m_s[r], l_s[r],
                     [&](auto* dst, float mul) {
                       for (int d = lane; d < hd; d += 32)
                         store(dst + d, acc_s[r * hd + d] * mul);
                     });
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the merge

constexpr int kMergeThreads = 256;

// Block (token, KV head); a warp per query head: lane s < ns reads split s's
// (m, l), the warp forms the weights exp(m_s - max m) and the denominator,
// then each lane sums its hd / 32 columns over the splits.
template <typename QT>
__global__ void __launch_bounds__(kMergeThreads) ragged_merge_kernel(const Params p) {
  const int t = blockIdx.x, h = blockIdx.y;
  const int ns = n_splits(visible(p, t), p.KS);
  if (ns <= 1) return;  // written by split 0 already
  const int lane = threadIdx.x & 31;
  const size_t plane = (size_t)p.T * p.kvH * p.G;
  for (int gg = threadIdx.x >> 5; gg < p.G; gg += kMergeThreads / 32) {
    const size_t row = ((size_t)t * p.kvH + h) * p.G + gg;
    float m = kNegInf, l = 0.f;
    if (lane < ns) {
      const float2 ml = *reinterpret_cast<const float2*>(p.ws_ml + (lane * plane + row) * 2);
      m = ml.x;
      l = ml.y;
    }
    const float mx = warp_max(m);  // every lane shuffles
    const float w = lane < ns ? expf(m - mx) : 0.f;
    const float inv = 1.f / fmaxf(warp_sum(w * l), 1e-30f);
    const float* acc = p.ws_acc + row * p.hd;
    for (int d0 = 0; d0 < p.hd; d0 += 32) {  // every lane on every shuffle
      const int d = d0 + lane;
      float v[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)  // all loads in flight at once
        v[s] = s < ns && d < p.hd ? acc[s * plane * p.hd + d] : 0.f;
      float num = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        num = fmaf(__shfl_sync(0xffffffffu, w, s), v[s], num);
      if (d < p.hd) store(static_cast<QT*>(p.out) + row * p.hd + d, num * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// launches

// Blocks along x: enough for one pass over the tiles of a pack whose slots
// each form one run (ceil(T / TT) + B), and never more than T.
inline int grid_x(const Params& p) {
  const long nb = (long)(p.T + p.TT - 1) / p.TT + p.B;
  return (int)(nb < p.T ? nb : p.T);
}

template <typename Kernel>
cudaError_t launch_attend(Kernel kern, size_t smem, int threads, const Params& p, int NS,
                          cudaStream_t st) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int chunks = (p.TT * p.G + p.RM - 1) / p.RM;
  kern<<<dim3(grid_x(p), p.kvH * chunks, NS), threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_simt(int kv_dtype, const Params& p, int NS, cudaStream_t st) {
  const size_t smem = sizeof(float) * simt_smem_floats(p.hd);
  if (kv_dtype == 0)
    return launch_attend(ragged_simt_kernel<QT, float, false>, smem, kSimtThreads, p, NS, st);
  if (kv_dtype == 1)
    return launch_attend(ragged_simt_kernel<QT, __nv_bfloat16, false>, smem, kSimtThreads, p,
                         NS, st);
  if (kv_dtype == 2)
    return launch_attend(ragged_simt_kernel<QT, int8_t, true>, smem, kSimtThreads, p, NS, st);
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_mma(int kv_dtype, const Params& p, int NS, cudaStream_t st) {
  if (kv_dtype == 1)
    return launch_attend(ragged_mma_kernel<HD, false>, MmaSmem<HD, false>::kBytes, kMmaThreads,
                         p, NS, st);
  if (kv_dtype == 2)
    return launch_attend(ragged_mma_kernel<HD, true>, MmaSmem<HD, true>::kBytes, kMmaThreads, p,
                         NS, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// variant: 0 "simt", 1 "mma" (the Variant enum; the wrapper passes
// VARIANTS.index(ragged_variant(...))).  q_dtype: 0 float32, 1 bfloat16.
// kv_dtype: 0 float32, 1 bfloat16, 2 int8 (int8 reads the ks/vs scale
// pools).  tiles: T + 1 int32 of scratch; ws: float32 scratch of NS * T *
// kvH * G * (hd + 2) values where NS = ceil(pps * page / split_keys) > 1,
// else unused.  split_keys is a positive multiple of 64.  Returns the
// cudaError_t of the launches; refuses a variant whose needs are unmet.
extern "C" int ragged_paged_flash(int variant, int q_dtype, int kv_dtype, const void* q,
                                  const void* kp, const void* vp, const void* ks,
                                  const void* vs, const void* ptab, const void* slot,
                                  const void* lens, void* out, void* tiles, void* ws, int T,
                                  int kvH, int G, int hd, int page, int npages, int B, int pps,
                                  int split_keys, float scale, void* stream) {
  if (T <= 0 || kvH <= 0 || G <= 0 || hd <= 0 || page <= 0 || npages <= 0 || B <= 0 ||
      pps < 0 || split_keys <= 0 || split_keys % kMmaKeys != 0 ||
      (kv_dtype == 2) != (ks != nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
           static_cast<const int32_t*>(ptab), static_cast<const int32_t*>(slot),
           static_cast<const int32_t*>(lens), out, static_cast<const int32_t*>(tiles),
           nullptr, nullptr, T, kvH, G, hd, page, npages, B, pps, pps * page, split_keys,
           0, 0, scale};
  const int S = p.S;
  const int NS = S > 0 ? (S + split_keys - 1) / split_keys : 1;
  if (NS > kMaxSplits || (NS > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  p.ws_acc = static_cast<float*>(ws);
  p.ws_ml = NS > 1 ? p.ws_acc + (size_t)NS * T * kvH * G * hd : nullptr;
  p.RM = variant == kMma ? kMmaRows : kSimtRows;
  p.TT = G >= p.RM ? 1 : (p.RM / G < kTileTokens ? p.RM / G : kTileTokens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (variant == kMma) {
    if (q_dtype != 1 || (kv_dtype != 1 && kv_dtype != 2) || (hd != 64 && hd != 128) ||
        !aligned16(q) || !aligned16(kp) || !aligned16(vp) || !aligned16(out))
      return (int)cudaErrorInvalidValue;
  } else if (variant != kSimt || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }

  ragged_plan_kernel<<<1, kPlanThreads, 0, st>>>(p.slot, T, p.TT, static_cast<int32_t*>(tiles));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (variant == kMma)
    e = hd == 128 ? launch_mma<128>(kv_dtype, p, NS, st) : launch_mma<64>(kv_dtype, p, NS, st);
  else
    e = q_dtype == 0 ? launch_simt<float>(kv_dtype, p, NS, st)
                     : launch_simt<__nv_bfloat16>(kv_dtype, p, NS, st);
  if (e != cudaSuccess || NS <= 1) return (int)e;
  if (q_dtype == 0)
    ragged_merge_kernel<float><<<dim3(T, kvH), kMergeThreads, 0, st>>>(p);
  else
    ragged_merge_kernel<__nv_bfloat16><<<dim3(T, kvH), kMergeThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Paged flash-decode attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/paged_flash_decode.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:paged_flash_decode
// (pallas_call body _paged_decode_kernel): the decode tick of the two-phase
// serving path, one query token per slot.  Slot b's G query heads of KV head
// h read the slot's block-table row ptab[b] and see its first lens[b]
// entries (clamped to the row's pps * page).  Scores are float32 with q
// scaled by hd^-0.5, masked past lens with -1e30; int8 pools are dequantized
// with their per-entry scale rows; lens == 0 gives zeros; block-table
// entries clamp into [0, npages) (the sentinel npages marks an unmapped
// page; its entries lie beyond lens).  A slot the engine left idle keeps its
// old lens and block-table row: the kernel reads those pages and the engine
// ignores the row.
//
// What bounds it on an H100: BYTES.  The least traffic is the KV pages the
// live lens reach (values, plus scale rows for int8), q, the output and the
// block-table entries used, over 3.35 TB/s: 6.2 MB, 1.9 us, for 8 slots of
// up to 2048 keys in bf16.  The arithmetic is 4 * sum(lens) * G * kvH * hd
// FLOPs, a few operations per byte read.  At such sizes the time goes to
// the chain of dependent loads each block waits on and to filling the card.
//
// Design.  One kernel launch a call; the tiling follows from shapes alone,
// so the wrapper makes no host synchronisation:
//   - Grid (key split j, KV head h x row chunk c, slot b).  A block takes
//     up to 16 query heads of one KV head (an m16 tile; qwen2-1.5b's G = 6
//     is one chunk) and the keys [j KS, (j + 1) KS) of its slot (KS from the
//     wrapper, a multiple of 64).  A split that lies wholly past the slot's
//     lens returns at once; split 0 always runs, so lens == 0 writes zeros.
//   - The block reads lens[b] and, alongside, the block-table entries its
//     split spans (clamped into the pool) into shared memory; each key step
//     then resolves its pool rows from there, once per key.
//   - Every warp on keys: each 4-warp step of K keys gives each warp its
//     own K/4 keys.  A warp keeps its own running max, denominator and
//     accumulator; at the block's end the four warps' states combine
//     through shared memory.
//   - A slot whose lens fit one split writes its output directly.
//     Otherwise each split writes a float32 partial (m, l, unnormalised acc)
//     and takes a ticket (an atomic counter per slot, KV head and row chunk);
//     the split that draws the last ticket resets the counter and merges
//     every split's partial into the output: a warp a row for the (m, l)
//     pairs, then up to 16 splits' loads of a float4 of columns in flight
//     at once in each thread (one L2 round trip at a time was most of the
//     kernel's time).
//   Variant "mma" (bfloat16 q over bfloat16 or int8 pools, hd 64 or 128,
//     16-byte aligned): 64-key steps, 16 keys a warp.  q and the K/V rows
//     arrive by 16-byte cp.async in a two-stage ring (q with the first
//     step), rows padded by 16 bytes so that fragment loads and ldmatrix
//     are free of bank conflicts.  QK^T and PV run on mma.sync m16n8k16 bf16
//     with float32 accumulators; the q fragments stay in registers (rows >=
//     G are zero and never written); P is rounded to bf16 after its row sum.
//     int8 rows are widened to bf16 by each warp for its own keys (exact for
//     -127..127; by byte permutes and float adds, not the int-to-float
//     conversion, which runs at an eighth of their rate); the K scale
//     multiplies the float32 score, the V scale is folded into P before it
//     is rounded.
//   Variant "simt" (everything else; the float32 parity route): the same
//     grid and splits, 32-key steps, 8 keys a warp, K/V dequantized to
//     float32 in shared memory by plain loads, float32 FMA.
// Left for later: TMA page loads, a persistent grid.

#include <type_traits>

#include "paged.cuh"

namespace {

using namespace paged;

enum Variant { kSimt = 0, kMma = 1 };

constexpr int kThreads = 128;  // four warps, each on its own keys
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;         // query heads a block takes: one m16 tile
constexpr int kMaxSplits = 32;    // most key splits of a block-table row (a warp's lanes)
constexpr int kMergeBatch = 16;   // partial loads a merging thread keeps in flight
constexpr int kMaxPages = 512;    // most block-table entries one split spans
constexpr int kMaxHeadDim = 256;  // the simt variant's largest hd
constexpr int kStages = 2;        // the mma variant's cp.async ring
constexpr int kMmaKeys = 64;      // keys per step: 16 a warp
constexpr int kSimtKeys = 32;     // keys per step: 8 a warp

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int32_t* ptab;
  const int32_t* lens;
  void* out;
  float* ws_acc;     // (NS, B, kvH, G, hd) partial numerators
  float* ws_ml;      // (NS, B, kvH, G, 2) partial (m, l)
  int32_t* tickets;  // (B, kvH * chunks), 0 between calls
  int B, kvH, G, hd, page, npages, pps, S, KS;
  float scale;
};

// The block's share of the work.
struct Split {
  int b, h, j;  // slot, KV head, key split
  int rows;     // query heads of this row chunk (<= kRows)
  size_t row0;  // the chunk's first output row ((b * kvH + h) * G + c * kRows)
  int L;        // the slot's visible entries, lens clamped to [0, S]
  int kb, ke;   // this split's keys: [kb, ke), ke = min(kb + KS, L)
  int p0;       // the block-table column of the split's first key
};

// Shared state of the combine and the merge.
struct FinishSmem {
  float wt[kMaxSplits][kRows];  // weight of each warp's, then each split's, state
  float inv[kRows];             // 1 / a row's combined denominator
  float m[kRows], l[kRows];     // a row's combined max and denominator
  int last;                     // this block drew the last ticket
};

// Reads the slot's visible length and, alongside it, the block-table
// entries the split spans (clamped into the pool) into pg_s.  Returns false
// for a split wholly past the visible length.  Called by every thread.
__device__ __forceinline__ bool begin_split(const Params& p, Split& sp, int* pg_s, int* len_s) {
  const int c = blockIdx.y / p.kvH;
  sp.h = blockIdx.y - c * p.kvH;
  sp.b = blockIdx.z;
  sp.j = blockIdx.x;
  sp.rows = min(kRows, p.G - c * kRows);
  sp.row0 = ((size_t)sp.b * p.kvH + sp.h) * p.G + (size_t)c * kRows;
  sp.kb = sp.j * p.KS;
  sp.p0 = sp.kb / p.page;
  const int n_pg = min((sp.kb + p.KS - 1) / p.page, p.pps - 1) - sp.p0 + 1;
  const int32_t* prow = p.ptab + (size_t)sp.b * p.pps;
  if (threadIdx.x == 0) *len_s = min(max(p.lens[sp.b], 0), p.S);
  for (int i = threadIdx.x; i < n_pg; i += kThreads)
    pg_s[i] = min(max(prow[sp.p0 + i], 0), p.npages - 1);
  __syncthreads();
  sp.L = *len_s;
  sp.ke = min(sp.kb + p.KS, sp.L);
  return sp.j == 0 || sp.kb < sp.L;
}

// The pool row ((page * P + offset) * kvH + h) of key `a`, or -1 past the
// split's last visible key (zeros are loaded instead).
__device__ __forceinline__ int key_row(const Params& p, const Split& sp, const int* pg_s, int a) {
  if (a >= sp.ke) return -1;
  const int col = a / p.page;
  return (pg_s[col - sp.p0] * p.page + (a - col * p.page)) * p.kvH + sp.h;
}

__device__ __forceinline__ float lane_of(float v, int) { return v; }
__device__ __forceinline__ float lane_of(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The merge's sums: each output value of the block's rows is the weighted
// sum (fs.wt) of the ns splits' partial numerators, over fs.inv.  A thread
// takes VT (float or float4) columns at a time and keeps kMergeBatch
// splits' loads of them in flight at once.
template <typename QT, typename VT>
__device__ __forceinline__ void merge_columns(const Params& p, const Split& sp, int ns,
                                              size_t plane, const FinishSmem& fs) {
  constexpr int V = sizeof(VT) / sizeof(float);
  const int hd = p.hd, per_row = hd / V;
  QT* out = static_cast<QT*>(p.out);
  for (int i = threadIdx.x; i < sp.rows * per_row; i += kThreads) {
    const int r = i / per_row, d = (i - r * per_row) * V;
    const float* col = p.ws_acc + (sp.row0 + r) * hd + d;
    float a[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = 0.f;
    for (int s0 = 0; s0 < ns; s0 += kMergeBatch) {
      VT v[kMergeBatch];
#pragma unroll
      for (int s = 0; s < kMergeBatch; ++s)
        v[s] = s0 + s < ns ? __ldcg(reinterpret_cast<const VT*>(col + (s0 + s) * plane * hd))
                           : VT{};
#pragma unroll
      for (int s = 0; s < kMergeBatch; ++s) {
        const float w = fs.wt[s0 + s][r];
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = fmaf(w, lane_of(v[s], k), a[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) store(out + (sp.row0 + r) * hd + d + k, a[k] * fs.inv[r]);
  }
}

// Combines the four warps' softmax states of each row — acc_w (kWarps,
// kRows, hd) numerators, m_w and l_w (kWarps, kRows) — then writes the
// output (the slot's lens fit one split) or this split's partial; the split
// that draws the last ticket merges every split's partial into the output.
// Called by every thread after a __syncthreads.
template <typename QT>
__device__ void finish(const Params& p, const Split& sp, const float* acc_w, const float* m_w,
                       const float* l_w, FinishSmem& fs) {
  const int tid = threadIdx.x, hd = p.hd;
  if (tid < sp.rows) {
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_w[w * kRows + tid]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_w[w * kRows + tid] - M);
      fs.wt[w][tid] = e;
      l = fmaf(e, l_w[w * kRows + tid], l);
    }
    fs.m[tid] = M;
    fs.l[tid] = l;
    fs.inv[tid] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  QT* out = static_cast<QT*>(p.out);
  const int ns = sp.L > 0 ? (sp.L + p.KS - 1) / p.KS : 0;
  auto combined = [&](int r, int d) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(fs.wt[w][r], acc_w[(w * kRows + r) * hd + d], a);
    return a;
  };
  if (ns <= 1) {
    for (int i = tid; i < sp.rows * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      store(out + (sp.row0 + r) * hd + d, combined(r, d) * fs.inv[r]);
    }
    return;
  }
  const size_t plane = (size_t)p.B * p.kvH * p.G;  // rows of one split's partials
  const size_t mine = (size_t)sp.j * plane + sp.row0;
  for (int i = tid; i < sp.rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    p.ws_acc[(mine + r) * hd + d] = combined(r, d);
  }
  if (tid < sp.rows) {
    p.ws_ml[(mine + tid) * 2] = fs.m[tid];
    p.ws_ml[(mine + tid) * 2 + 1] = fs.l[tid];
  }
  __threadfence();  // the partial is visible before the ticket is drawn
  __syncthreads();
  if (tid == 0) {
    int32_t* ticket = p.tickets + (size_t)sp.b * gridDim.y + blockIdx.y;
    fs.last = atomicAdd(ticket, 1) == ns - 1;
    if (fs.last) *ticket = 0;  // ready for the next call
  }
  __syncthreads();
  if (!fs.last) return;
  __threadfence();
  // the last split: merge the ns partials, reading past L1 (which may hold
  // stale lines).  A warp a row: lane s reads split s's (m, l); every lane
  // shuffles.
  const int lane = tid & 31;
  for (int r = tid >> 5; r < sp.rows; r += kWarps) {
    const float* ml = p.ws_ml + (lane * plane + sp.row0 + r) * 2;
    const float m = lane < ns ? __ldcg(ml) : kNegInf;
    const float l = lane < ns ? __ldcg(ml + 1) : 0.f;
    const float M = warp_max(m);
    const float e = lane < ns ? expf(m - M) : 0.f;
    const float lsum = warp_sum(e * l);
    fs.wt[lane][r] = e;  // 0 past ns
    if (lane == 0) fs.inv[r] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  if (hd % 4 == 0)
    merge_columns<QT, float4>(p, sp, ns, plane, fs);
  else
    merge_columns<QT, float>(p, sp, ns, plane, fs);
}

// ---------------------------------------------------------------------------
// the tensor-core variant

// Shared-memory layout of the mma variant (bytes; 73,984 at hd 128 with
// bf16 pools, 77,056 with int8): the q rows, the ring of raw K and V rows,
// for int8 the stages' scale rows and each warp's keys widened to bf16.
// After the loop the same memory holds the warps' states for the combine.
// A bf16 row is hd * 2 bytes plus 16 of padding: 8 rows then fall on
// distinct banks.
template <int HD, bool kQuant>
struct MmaSmem {
  static constexpr int kRow = HD * 2 + 16;                 // bf16 row stride
  static constexpr int kRawRow = kQuant ? HD + 16 : kRow;  // pool row stride
  static constexpr int kQ = 0;                             // (kRows, kRow)
  static constexpr int kRaw = kQ + kRows * kRow;           // [stage][K|V][key]
  static constexpr int kScales = kRaw + kStages * 2 * kMmaKeys * kRawRow;  // [stage][K|V][key]
  static constexpr int kConv = kScales + (kQuant ? kStages * 2 * kMmaKeys * 4 : 0);
  static constexpr int kLoop = kConv + (kQuant ? kWarps * 2 * 16 * kRow : 0);  // [warp][K|V][16]
  static constexpr int kAcc = 0;  // (kWarps, kRows, HD) float32
  static constexpr int kM = kAcc + kWarps * kRows * HD * 4;
  static constexpr int kL = kM + kWarps * kRows * 4;
  static constexpr int kEnd = kL + kWarps * kRows * 4;
  static constexpr int kBytes = kLoop > kEnd ? kLoop : kEnd;
};

// Four int8 values (one 32-bit word, lowest byte first) as two bf16 pairs,
// exactly and without int-to-float conversions (an eighth of the float-add
// rate on Hopper):
// each byte with its sign bit flipped, x + 128, becomes the low mantissa
// byte of the float 2^23 + x + 128, from which 2^23 + 128 is subtracted.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7541)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7542)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7543)) - kBias;
  return make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
}

template <int HD, bool kQuant>
__global__ void __launch_bounds__(kThreads) decode_mma_kernel(const Params p) {
  using KT = typename std::conditional<kQuant, int8_t, __nv_bfloat16>::type;
  using Lay = MmaSmem<HD, kQuant>;
  constexpr int kChunks = HD * (int)sizeof(KT) / 16;  // 16-byte chunks in a pool row
  constexpr int kWarpKeys = kMmaKeys / kWarps;        // 16
  extern __shared__ __align__(16) char smem[];
  __shared__ int pg_s[kMaxPages];
  __shared__ int key_rows[kStages][kMmaKeys];
  __shared__ int len_s;
  __shared__ FinishSmem fs;

  Split sp;
  if (!begin_split(p, sp, pg_s, &len_s)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const KT* kp = static_cast<const KT*>(p.kp);
  const KT* vp = static_cast<const KT*>(p.vp);
  const int nsteps = sp.ke > sp.kb ? (sp.ke - sp.kb + kMmaKeys - 1) / kMmaKeys : 0;

  // step s's K and V rows (and int8 scales) into stage s % kStages, one
  // commit group
  auto load_step = [&](int s) {
    const int st = s % kStages;
    int* rows = key_rows[st];
    if (tid < kMmaKeys) rows[tid] = key_row(p, sp, pg_s, sp.kb + s * kMmaKeys + tid);
    __syncthreads();
    for (int i = tid; i < 2 * kMmaKeys * kChunks; i += kThreads) {
      const int which = i / (kMmaKeys * kChunks);
      const int rem = i - which * kMmaKeys * kChunks;
      const int r = rem / kChunks, c = rem - r * kChunks;
      const int e = rows[r];
      cp_async16(smem + Lay::kRaw + ((st * 2 + which) * kMmaKeys + r) * Lay::kRawRow + c * 16,
                 (which ? vp : kp) + (e < 0 ? 0 : (size_t)e * HD + c * (16 / sizeof(KT))),
                 e < 0 ? 0 : 16);
    }
    if (kQuant) {
      for (int i = tid; i < 2 * kMmaKeys; i += kThreads) {
        const int which = i / kMmaKeys, r = i - which * kMmaKeys;
        const int e = rows[r];
        cp_async4(smem + Lay::kScales + ((st * 2 + which) * kMmaKeys + r) * 4,
                  (which ? p.vs : p.ks) + max(e, 0), e < 0 ? 0 : 4);
      }
    }
    cp_async_commit();
  };
  if (nsteps > 0) {
    for (int i = tid; i < kRows * (HD / 8); i += kThreads) {  // q joins step 0's group
      const int r = i / (HD / 8), c = i - r * (HD / 8);
      cp_async16(smem + Lay::kQ + r * Lay::kRow + c * 16,
                 q + (r < sp.rows ? (sp.row0 + r) * HD + c * 8 : 0), r < sp.rows ? 16 : 0);
    }
    load_step(0);
  }
  if (nsteps > 1) load_step(1);

  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  for (int s = 0; s < nsteps; ++s) {
    const int st = s % kStages;
    if (s + 1 < nsteps)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const char* q0 = smem + Lay::kQ + g * Lay::kRow + (kk * 16 + 2 * tig) * 2;
        const char* q1 = q0 + 8 * Lay::kRow;
        qa[kk][0] = lds32(q0);
        qa[kk][1] = lds32(q1);
        qa[kk][2] = lds32(q0 + 16);
        qa[kk][3] = lds32(q1 + 16);
      }
    }
    const int kw = sp.kb + s * kMmaKeys + warp * kWarpKeys;  // this warp's first key
    if (kw < sp.ke) {  // warp-uniform
      const char* kt = smem + Lay::kRaw + ((st * 2 + 0) * kMmaKeys + warp * kWarpKeys) * Lay::kRawRow;
      const char* vt = smem + Lay::kRaw + ((st * 2 + 1) * kMmaKeys + warp * kWarpKeys) * Lay::kRawRow;
      const float* kscale =
          reinterpret_cast<const float*>(smem + Lay::kScales) + st * 2 * kMmaKeys + warp * kWarpKeys;
      const float* vscale = kscale + kMmaKeys;
      if (kQuant) {  // widen this warp's int8 rows to bf16 (exact)
        char* conv = smem + Lay::kConv + warp * 2 * kWarpKeys * Lay::kRow;
        for (int i = lane; i < 2 * kWarpKeys * (HD / 8); i += 32) {
          const int which = i / (kWarpKeys * (HD / 8));
          const int rem = i - which * kWarpKeys * (HD / 8);
          const int r = rem / (HD / 8), c = rem - r * (HD / 8);
          const uint2 raw =
              *reinterpret_cast<const uint2*>((which ? vt : kt) + r * Lay::kRawRow + c * 8);
          const uint2 lo = widen4(raw.x), hi = widen4(raw.y);
          *reinterpret_cast<uint4*>(conv + (which * kWarpKeys + r) * Lay::kRow + c * 16) =
              make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
        __syncwarp();
        kt = conv;
        vt = conv + kWarpKeys * Lay::kRow;
      }
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        const char* krow = kt + (n * 8 + g) * Lay::kRow + 4 * tig;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma_bf16(sc[n], qa[kk], lds32(krow + kk * 32), lds32(krow + kk * 32 + 16));
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + 2 * tig + (e & 1);
          float x = sc[n][e] * p.scale;
          if (kQuant) x *= kscale[key];
          sc[n][e] = kw + key < sp.ke ? x : kNegInf;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
      }
      for (int off = 1; off < 4; off <<= 1) {  // the four lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + 2 * tig + (e & 1);
          const float pe = kw + key < sp.ke ? expf(sc[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          if (e < 2)
            sum0 += pe;
          else
            sum1 += pe;
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
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
      const int mat = lane >> 3;
      const char* vrow = vt + ((mat & 1) * 8 + (lane & 7)) * Lay::kRow + (mat >> 1) * 16;
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + dn * 32);
        mma_bf16(o[2 * dn], pa, b[0], b[1]);
        mma_bf16(o[2 * dn + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // the stage (and the widened rows) may be refilled
    if (s + kStages < nsteps) load_step(s + kStages);
  }

  // the warp's state into shared memory (the ring is free: every copy landed)
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* acc_w = reinterpret_cast<float*>(smem + Lay::kAcc);
  float* m_w = reinterpret_cast<float*>(smem + Lay::kM);
  float* l_w = reinterpret_cast<float*>(smem + Lay::kL);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    if (r >= sp.rows) continue;
    float* dst = acc_w + (warp * kRows + r) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * half], o[n][2 * half + 1]);
    if (tig == 0) {
      m_w[warp * kRows + r] = half ? m1 : m0;
      l_w[warp * kRows + r] = half ? l1 : l0;
    }
  }
  __syncthreads();
  finish<__nv_bfloat16>(p, sp, acc_w, m_w, l_w, fs);
}

// ---------------------------------------------------------------------------
// the float32 FMA variant

constexpr int kSimtWarpKeys = kSimtKeys / kWarps;  // 8

// Floats of shared memory (150,208 bytes at the largest hd, 256): q scaled
// (kRows x (hd + 1)), K (keys x (hd + 1)) and V (keys x hd) as float32,
// each warp's scores (kRows x its keys), numerators (kRows x hd), max and
// denominator (kRows each).
__host__ __device__ constexpr size_t simt_smem_floats(int hd) {
  return (size_t)kRows * (hd + 1) + (size_t)kSimtKeys * (hd + 1) + (size_t)kSimtKeys * hd +
         (size_t)kWarps * kRows * kSimtWarpKeys + (size_t)kWarps * kRows * hd +
         2 * (size_t)kWarps * kRows;
}

template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kThreads) decode_simt_kernel(const Params p) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ int pg_s[kMaxPages];
  __shared__ int key_rows[kSimtKeys];
  __shared__ int len_s;
  __shared__ FinishSmem fs;

  Split sp;
  if (!begin_split(p, sp, pg_s, &len_s)) return;
  const int hd = p.hd, hp = hd + 1;
  float* q_s = fsm;                                       // (kRows, hd + 1)
  float* k_s = q_s + kRows * hp;                          // (keys, hd + 1)
  float* v_s = k_s + kSimtKeys * hp;                      // (keys, hd)
  float* s_s = v_s + kSimtKeys * hd;                      // (warps, kRows, warp keys)
  float* acc_w = s_s + kWarps * kRows * kSimtWarpKeys;    // (warps, kRows, hd)
  float* m_w = acc_w + kWarps * kRows * hd;               // (warps, kRows)
  float* l_w = m_w + kWarps * kRows;                      // (warps, kRows)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const QT* q = static_cast<const QT*>(p.q);
  const KT* kp = static_cast<const KT*>(p.kp);
  const KT* vp = static_cast<const KT*>(p.vp);
  for (int i = tid; i < sp.rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    q_s[r * hp + d] = to_float(q[(sp.row0 + r) * hd + d]) * p.scale;
  }
  float* acc = acc_w + warp * kRows * hd;
  for (int i = lane; i < kRows * hd; i += 32) acc[i] = 0.f;
  float* sc = s_s + warp * kRows * kSimtWarpKeys;
  float m = kNegInf, l = 0.f;  // lane r < rows holds row r's

  for (int k0 = sp.kb; k0 < sp.ke; k0 += kSimtKeys) {
    __syncthreads();  // the last step is done with k_s and v_s
    if (tid < kSimtKeys) key_rows[tid] = key_row(p, sp, pg_s, k0 + tid);
    __syncthreads();
    for (int i = tid; i < kSimtKeys * hd; i += kThreads) {
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
      k_s[r * hp + d] = kx;
      v_s[i] = vx;
    }
    __syncthreads();
    const int kw = k0 + warp * kSimtWarpKeys;  // this warp's first key
    if (kw >= sp.ke) continue;                 // warp-uniform
    for (int i = lane; i < sp.rows * kSimtWarpKeys; i += 32) {
      const int r = i / kSimtWarpKeys, k = i - r * kSimtWarpKeys;
      const float* qr = q_s + r * hp;
      const float* kr = k_s + (warp * kSimtWarpKeys + k) * hp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      sc[i] = kw + k < sp.ke ? s : kNegInf;
    }
    __syncwarp();
    float corr = 1.f;
    if (lane < sp.rows) {
      float* sr = sc + lane * kSimtWarpKeys;
      float mx = kNegInf;
      for (int k = 0; k < kSimtWarpKeys; ++k) mx = fmaxf(mx, sr[k]);
      const float mn = fmaxf(m, mx);
      float sum = 0.f;
      for (int k = 0; k < kSimtWarpKeys; ++k) {
        const float e = kw + k < sp.ke ? expf(sr[k] - mn) : 0.f;
        sr[k] = e;
        sum += e;
      }
      corr = expf(m - mn);
      l = l * corr + sum;
      m = mn;
    }
    __syncwarp();
    const float* vw = v_s + warp * kSimtWarpKeys * hd;
    for (int r = 0; r < sp.rows; ++r) {
      const float cr = __shfl_sync(0xffffffffu, corr, r);  // every lane shuffles
      const float* pr = sc + r * kSimtWarpKeys;
      for (int d = lane; d < hd; d += 32) {
        float a = acc[r * hd + d] * cr;
        for (int k = 0; k < kSimtWarpKeys; ++k) a = fmaf(pr[k], vw[k * hd + d], a);
        acc[r * hd + d] = a;
      }
    }
  }
  if (lane < sp.rows) {
    m_w[warp * kRows + lane] = m;
    l_w[warp * kRows + lane] = l;
  }
  __syncthreads();
  finish<QT>(p, sp, acc_w, m_w, l_w, fs);
}

// ---------------------------------------------------------------------------
// launches: the shared-memory limit is raised once per kernel instance

template <int HD, bool kQuant>
cudaError_t launch_mma(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = MmaSmem<HD, kQuant>::kBytes;
  static const cudaError_t attr = allow_smem(decode_mma_kernel<HD, kQuant>, smem);
  if (attr != cudaSuccess) return attr;
  decode_mma_kernel<HD, kQuant><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, bool kQuant>
cudaError_t launch_simt(const Params& p, dim3 grid, cudaStream_t st) {
  static const cudaError_t attr = allow_smem(decode_simt_kernel<QT, KT, kQuant>,
                                             sizeof(float) * simt_smem_floats(kMaxHeadDim));
  if (attr != cudaSuccess) return attr;
  decode_simt_kernel<QT, KT, kQuant>
      <<<grid, kThreads, sizeof(float) * simt_smem_floats(p.hd), st>>>(p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_simt_for(int kv_dtype, const Params& p, dim3 grid, cudaStream_t st) {
  if (kv_dtype == 0) return launch_simt<QT, float, false>(p, grid, st);
  if (kv_dtype == 1) return launch_simt<QT, __nv_bfloat16, false>(p, grid, st);
  if (kv_dtype == 2) return launch_simt<QT, int8_t, true>(p, grid, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// variant: 0 "simt", 1 "mma" (the Variant enum; the wrapper passes
// VARIANTS.index(variant)).  q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0
// float32, 1 bfloat16, 2 int8 (int8 reads the ks/vs scale pools).  With NS =
// ceil(pps * page / split_keys) > 1 splits, ws is float32 scratch of NS * B
// * kvH * G * (hd + 2) values and tickets B * kvH * ceil(G / 16) int32 that
// are 0 (the kernel leaves them 0); both are unused with one split.
// split_keys is a positive multiple of 64.  Returns the cudaError_t of the
// launch; refuses a variant whose needs are unmet.
extern "C" int paged_flash_decode(int variant, int q_dtype, int kv_dtype, const void* q,
                                  const void* kp, const void* vp, const void* ks, const void* vs,
                                  const void* ptab, const void* lens, void* out, void* ws,
                                  void* tickets, int B, int kvH, int G, int hd, int page,
                                  int npages, int pps, int split_keys, float scale,
                                  void* stream) {
  if (B <= 0 || kvH <= 0 || G <= 0 || hd <= 0 || hd > kMaxHeadDim || page <= 0 || npages <= 0 ||
      pps < 0 || split_keys <= 0 || split_keys % kMmaKeys != 0 ||
      (kv_dtype == 2) != (ks != nullptr) || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 ||
      kv_dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int S = pps * page;
  const int NS = S > 0 ? (S + split_keys - 1) / split_keys : 1;
  const int chunks = (G + kRows - 1) / kRows;
  if (NS > kMaxSplits || (split_keys - 1) / page + 2 > kMaxPages || B > 65535 ||
      (long)kvH * chunks > 65535 || (NS > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
           static_cast<const int32_t*>(ptab), static_cast<const int32_t*>(lens), out,
           static_cast<float*>(ws), nullptr, static_cast<int32_t*>(tickets), B, kvH, G, hd,
           page, npages, pps, S, split_keys, scale};
  p.ws_ml = NS > 1 ? p.ws_acc + (size_t)NS * B * kvH * G * hd : nullptr;
  const dim3 grid(NS, kvH * chunks, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (variant == kMma) {
    if (q_dtype != 1 || (kv_dtype != 1 && kv_dtype != 2) || (hd != 64 && hd != 128) ||
        !aligned16(q) || !aligned16(kp) || !aligned16(vp))
      return (int)cudaErrorInvalidValue;
    if (hd == 128)
      return (int)(kv_dtype == 1 ? launch_mma<128, false>(p, grid, st)
                                 : launch_mma<128, true>(p, grid, st));
    return (int)(kv_dtype == 1 ? launch_mma<64, false>(p, grid, st)
                               : launch_mma<64, true>(p, grid, st));
  }
  if (variant != kSimt) return (int)cudaErrorInvalidValue;
  return (int)(q_dtype == 0 ? launch_simt_for<float>(kv_dtype, p, grid, st)
                            : launch_simt_for<__nv_bfloat16>(kv_dtype, p, grid, st));
}

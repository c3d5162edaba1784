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
// the ceil(lens/page) visible pages: paged::paged_attend, which
// paged_flash_decode.cu shares (paged_walk.cuh describes its tiles, warps
// and online softmax).  This kernel only resolves token -> slot -> block-
// table row.  Tokens of one slot re-read that slot's pages (the L2 catches
// most of it); TMA, wgmma and split-K over pages are left for later work.

#include "paged_walk.cuh"

namespace {

// q, out: (T, kvH, G, hd); kp, vp: (npages, page, kvH, hd); ks, vs:
// (npages, page, kvH); ptab: (B, pps); slot, lens: (T,).  All contiguous.
template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(paged::kThreads) ragged_paged_flash_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp, const KT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int32_t* __restrict__ ptab, const int32_t* __restrict__ slot,
    const int32_t* __restrict__ lens, QT* __restrict__ out, int kvH, int G, int hd,
    int page, int npages, int B, int pps, float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, h = blockIdx.y;
  const size_t qo = ((size_t)t * kvH + h) * G * hd;
  const int b = min(max(slot[t], 0), B - 1);
  paged::paged_attend<QT, KT, kQuant>(q + qo, out + qo, kp, vp, ks, vs,
                                      ptab + (size_t)b * pps, lens[t], h, kvH, G, hd,
                                      page, npages, pps, scale, smem);
}

template <typename QT, typename KT, bool kQuant>
struct Launch {
  static cudaError_t run(const void* q, const void* kp, const void* vp, const void* ks,
                         const void* vs, const void* ptab, const void* slot,
                         const void* lens, void* out, int T, int kvH, int G, int hd,
                         int page, int npages, int B, int pps, float scale,
                         cudaStream_t stream) {
    auto kern = ragged_paged_flash_kernel<QT, KT, kQuant>;
    const size_t smem = paged::smem_bytes(G, hd, page);
    cudaError_t e = paged::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(T, kvH), paged::kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(kp), static_cast<const KT*>(vp),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int32_t*>(ptab), static_cast<const int32_t*>(slot),
        static_cast<const int32_t*>(lens), static_cast<QT*>(out), kvH, G, hd, page,
        npages, B, pps, scale);
    return cudaGetLastError();
  }
};

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (int8 reads the ks/vs scale pools).  Returns the cudaError_t of the launch.
extern "C" int ragged_paged_flash(int q_dtype, int kv_dtype, const void* q, const void* kp,
                                  const void* vp, const void* ks, const void* vs,
                                  const void* ptab, const void* slot, const void* lens,
                                  void* out, int T, int kvH, int G, int hd, int page,
                                  int npages, int B, int pps, float scale, void* stream) {
  return paged::dispatch<Launch>(q_dtype, kv_dtype, q, kp, vp, ks, vs, ptab, slot, lens,
                                 out, T, kvH, G, hd, page, npages, B, pps, scale,
                                 static_cast<cudaStream_t>(stream));
}

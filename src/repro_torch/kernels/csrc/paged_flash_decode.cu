// Paged flash-decode attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/paged_flash_decode.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:paged_flash_decode
// (pallas_call body _paged_decode_kernel): the decode tick of the two-phase
// serving path, one query token per slot.  Slot b's G query heads of KV head
// h read the slot's block-table row ptab[b] and see its first lens[b]
// entries.  Online softmax with a float32 accumulator, scale hd^-0.5; int8
// pools are dequantized with their per-entry scale rows right after each
// page load; lens == 0 gives zeros; sentinel block-table entries clamp to
// the last pool page (their entries lie beyond lens).  A slot the engine
// left idle keeps its old lens and block-table row: the kernel reads those
// pages (every index clamped into the pool) and the engine ignores the row.
//
// What bounds it on an H100: BYTES.  The least traffic is the KV pages the
// live lens reach (values, plus scale rows for int8), q, the output and the
// block-table entries used, over 3.35 TB/s.  The arithmetic is 4 * sum(lens)
// * G * kvH * hd FLOPs, a few operations per byte read.
//
// Design (right and simple first): one thread block per (slot, KV head),
// holding the slot's G query heads; the TPU grid's sequential page axis is a
// loop inside the block.  That page walk is paged::paged_attend
// (paged_walk.cuh), the same code as ragged_paged_flash.cu's, with the slot
// taken from the block row and no token -> slot indirection.  A decode tick
// of 8 slots and 2 KV heads launches 16 blocks on 132 SMs: split-K over
// pages, vectorised or TMA page loads and tensor-core scores are later work.

#include "paged_walk.cuh"

namespace {

// q, out: (B, kvH, G, hd); kp, vp: (npages, page, kvH, hd); ks, vs:
// (npages, page, kvH); ptab: (B, pps); lens: (B,).  All contiguous.
template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(paged::kThreads) paged_flash_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp, const KT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int32_t* __restrict__ ptab, const int32_t* __restrict__ lens,
    QT* __restrict__ out, int kvH, int G, int hd, int page, int npages, int pps,
    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t qo = ((size_t)b * kvH + h) * G * hd;
  paged::paged_attend<QT, KT, kQuant>(q + qo, out + qo, kp, vp, ks, vs,
                                      ptab + (size_t)b * pps, lens[b], h, kvH, G, hd,
                                      page, npages, pps, scale, smem);
}

template <typename QT, typename KT, bool kQuant>
struct Launch {
  static cudaError_t run(const void* q, const void* kp, const void* vp, const void* ks,
                         const void* vs, const void* ptab, const void* lens, void* out,
                         int B, int kvH, int G, int hd, int page, int npages, int pps,
                         float scale, cudaStream_t stream) {
    auto kern = paged_flash_decode_kernel<QT, KT, kQuant>;
    const size_t smem = paged::smem_bytes(G, hd, page);
    cudaError_t e = paged::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(B, kvH), paged::kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(kp), static_cast<const KT*>(vp),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int32_t*>(ptab), static_cast<const int32_t*>(lens),
        static_cast<QT*>(out), kvH, G, hd, page, npages, pps, scale);
    return cudaGetLastError();
  }
};

}  // namespace

// q_dtype: 0 float32, 1 bfloat16.  kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (int8 reads the ks/vs scale pools).  Returns the cudaError_t of the launch.
extern "C" int paged_flash_decode(int q_dtype, int kv_dtype, const void* q, const void* kp,
                                  const void* vp, const void* ks, const void* vs,
                                  const void* ptab, const void* lens, void* out, int B,
                                  int kvH, int G, int hd, int page, int npages, int pps,
                                  float scale, void* stream) {
  return paged::dispatch<Launch>(q_dtype, kv_dtype, q, kp, vp, ks, vs, ptab, lens, out, B,
                                 kvH, G, hd, page, npages, pps, scale,
                                 static_cast<cudaStream_t>(stream));
}

"""Paged flash-decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py:paged_flash_decode`` (the Pallas
TPU kernel), the attention of the two-phase serving path's decode tick: one
query token per slot over that slot's block-table pages.
``paged_flash_decode`` launches the hand-written kernel in
``csrc/paged_flash_decode.cu`` for CUDA tensors, and runs
``paged_flash_decode_ref`` only for CPU tensors; there is no fallback from
one to the other.  ``launches`` counts kernel launches (the plain version
does not count), so a run can show that its decode ticks went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ragged_paged_flash as _rpf

NEG_INF = -1e30

# kernel launches since the last reset (the caller sets it back to 0)
launches = 0

_MAX_HEAD_DIM = 256
_MAX_SMEM = 227 * 1024  # bytes of shared memory one Hopper block may use


def paged_flash_decode_ref(q, kp, vp, ptab, lens, ks=None, vs=None):
    """Plain PyTorch decode attention: gather every slot's context through
    its (clamped) block-table row, mask entries at or beyond ``lens``,
    softmax in float32.  ``lens == 0`` slots come out as zeros, like the
    kernel.  Shapes as ``paged_flash_decode``."""
    B, kvH, G, hd = q.shape
    npages, page = kp.shape[0], kp.shape[1]
    pps = ptab.shape[1]
    idx = ptab.long().clamp(0, npages - 1)

    def context(pool, scales):
        x = pool[idx].float()  # (B, pps, page, kvH, hd)
        if scales is not None:
            x = x * scales[idx].float()[..., None]
        return x.reshape(B, pps * page, kvH, hd)

    k, v = context(kp, ks), context(vp, vs)
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k) * hd ** -0.5
    mask = (torch.arange(pps * page, device=q.device)[None]
            < lens.long()[:, None])[:, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    p = torch.where(mask, p, 0.0)
    return torch.einsum("bkgs,bskd->bkgd", p, v).to(q.dtype)


def _check(q, kp, vp, ptab, lens, ks, vs):
    _rpf.check_pools(q, kp, vp, ks, vs)
    B = q.shape[0]
    if ptab.ndim != 2 or ptab.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"ptab must be (B, pps) and lens (B,) with B = {B}; "
                         f"got {tuple(ptab.shape)} and {tuple(lens.shape)}")
    for name, t in (("ptab", ptab), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    _rpf.check_same_device_contiguous([q, kp, vp, ptab, lens, ks, vs])


def _smem_bytes(G: int, hd: int, page: int) -> int:
    # must match paged::smem_bytes in csrc/paged_walk.cuh
    return 4 * (2 * G * hd + 2 * page * hd + G * page + 3 * G)


def check_kernel_fits(q, kp) -> None:
    """Refuse shapes the page walk's shared memory cannot hold."""
    _, _, G, hd = q.shape
    if hd > _MAX_HEAD_DIM or _smem_bytes(G, hd, kp.shape[1]) > _MAX_SMEM:
        raise ValueError(f"head_dim {hd} / page {kp.shape[1]} / G {G} exceed "
                         f"the kernel's shared memory")


def _lib():
    from repro_torch.kernels import build

    fn = build.load("paged_flash_decode").paged_flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_flash_decode(q, kp, vp, ptab, lens, ks=None, vs=None):
    """Decode attention over a paged KV pool, one query token per slot.

    q: (B, kvH, G, hd) float32/bfloat16; kp, vp: (n_pages, page, kvH, hd)
    float32/bfloat16/int8 (a per-layer view of a stacked pool is fine: it is
    contiguous); ks, vs: (n_pages, page, kvH) float32 scale pools, for int8
    pools only; ptab: (B, pps) int32 block table (entries >= n_pages are
    unmapped and clamp into the pool); lens: (B,) int32 visible entries per
    slot (0: the slot's output is zeros).  Returns (B, kvH, G, hd) in q's
    dtype."""
    global launches
    _check(q, kp, vp, ptab, lens, ks, vs)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, kp, vp, ptab, lens, ks, vs)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_kernel_fits(q, kp)
    B, kvH, G, hd = q.shape
    npages, page = kp.shape[0], kp.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _lib()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_rpf._Q_CODES[q.dtype], _rpf._KV_CODES[kp.dtype], ptr(q),
                 ptr(kp), ptr(vp), ptr(ks), ptr(vs), ptr(ptab), ptr(lens),
                 ptr(out), B, kvH, G, hd, page, npages, ptab.shape[1],
                 hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode launch failed: CUDA error {err}")
    launches += 1
    return out

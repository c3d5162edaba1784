"""Ragged paged flash attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py:ragged_paged_flash`` (the Pallas
TPU kernel).  ``ragged_paged_flash`` launches the hand-written kernel in
``csrc/ragged_paged_flash.cu`` for CUDA tensors, and runs
``ragged_paged_flash_ref`` only for CPU tensors; there is no fallback from
one to the other.  ``launches`` counts kernel launches (the plain version
does not count), so a run can show that its attention went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# kernel launches since the last reset (the caller sets it back to 0)
launches = 0

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_HEAD_DIM = 256
_MAX_SMEM = 227 * 1024  # bytes of shared memory one Hopper block may use


def ragged_paged_flash_ref(q, kp, vp, ptab, slot, lens, ks=None, vs=None):
    """Plain PyTorch ragged paged attention: gather every token's slot
    context through the (clamped) block table, mask entries at or beyond
    ``lens``, softmax in float32.  ``lens == 0`` rows come out as zeros,
    like the kernel.  Shapes as ``ragged_paged_flash``."""
    T, kvH, G, hd = q.shape
    npages, page = kp.shape[0], kp.shape[1]
    B, pps = ptab.shape
    idx = ptab.long().clamp(0, npages - 1)
    sl = slot.long()

    def context(pool, scales):
        x = pool[idx].float()  # (B, pps, page, kvH, hd)
        if scales is not None:
            x = x * scales[idx].float()[..., None]
        return x.reshape(B, pps * page, kvH, hd)[sl]  # (T, S, kvH, hd)

    k, v = context(kp, ks), context(vp, vs)
    s = torch.einsum("tkgd,tskd->tkgs", q.float(), k) * hd ** -0.5
    mask = (torch.arange(pps * page, device=q.device)[None]
            < lens.long()[:, None])[:, None, None, :]
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    p = torch.where(mask, p, 0.0)
    return torch.einsum("tkgs,tskd->tkgd", p, v).to(q.dtype)


def check_pools(q, kp, vp, ks, vs) -> None:
    """The query and pool checks both paged kernels share (this one and
    ``paged_flash_decode``): q (rows, kvH, G, hd) float32/bfloat16 over
    pools (n_pages, page, kvH, hd) float32/bfloat16/int8, float32 scale
    pools for int8 pools only."""
    if q.ndim != 4 or kp.ndim != 4:
        raise ValueError(f"q must be (rows,kvH,G,hd) and kp (n_pages,page,kvH,hd);"
                         f" got {tuple(q.shape)} and {tuple(kp.shape)}")
    _, kvH, G, hd = q.shape
    if kp.shape != vp.shape or kp.shape[2:] != (kvH, hd):
        raise ValueError(f"pool shapes {tuple(kp.shape)}/{tuple(vp.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_CODES)}")
    if kp.dtype not in _KV_CODES or vp.dtype != kp.dtype:
        raise TypeError(f"pool dtypes {kp.dtype}/{vp.dtype} not supported")
    if (kp.dtype == torch.int8) != (ks is not None) or (ks is None) != (vs is None):
        raise ValueError("int8 pools need both scale pools ks/vs, and only "
                         "int8 pools take them")
    if ks is not None and (ks.shape != kp.shape[:3] or vs.shape != kp.shape[:3]
                           or ks.dtype != torch.float32
                           or vs.dtype != torch.float32):
        raise ValueError("scale pools must be float32 (n_pages, page, kvH)")


def check_same_device_contiguous(tensors) -> None:
    """Every given tensor (None entries skipped) on one device, contiguous."""
    tensors = [t for t in tensors if t is not None]
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def check_kernel_fits(q, kp) -> None:
    """Refuse shapes the kernel's shared memory cannot hold."""
    _, _, G, hd = q.shape
    if hd > _MAX_HEAD_DIM or _smem_bytes(G, hd, kp.shape[1]) > _MAX_SMEM:
        raise ValueError(f"head_dim {hd} / page {kp.shape[1]} / G {G} exceed "
                         f"the kernel's shared memory")


def _check(q, kp, vp, ptab, slot, lens, ks, vs):
    check_pools(q, kp, vp, ks, vs)
    T = q.shape[0]
    if ptab.ndim != 2 or slot.shape != (T,) or lens.shape != (T,):
        raise ValueError("ptab must be (B, pps); slot and lens (T,)")
    for name, t in (("ptab", ptab), ("slot", slot), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    check_same_device_contiguous([q, kp, vp, ptab, slot, lens, ks, vs])


def _smem_bytes(G: int, hd: int, page: int) -> int:
    # must match paged::smem_bytes in csrc/paged_walk.cuh
    return 4 * (2 * G * hd + 2 * page * hd + G * page + 3 * G)


def _lib():
    from repro_torch.kernels import build

    lib = build.load("ragged_paged_flash")
    fn = lib.ragged_paged_flash
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=None, vs=None):
    """Ragged-pack attention over a paged KV pool (one serving tick).

    q: (T, kvH, G, hd) float32/bfloat16; kp, vp: (n_pages, page, kvH, hd)
    float32/bfloat16/int8 (a per-layer view of a stacked pool is fine: it is
    contiguous); ks, vs: (n_pages, page, kvH) float32 scale pools, for int8
    pools only; ptab: (B, pps) int32 block table (entries >= n_pages are
    unmapped); slot, lens: (T,) int32 — each token's slot and visible length
    (``q_pos + 1``; 0 for an invalid token, whose output is zeros).
    Returns (T, kvH, G, hd) in q's dtype."""
    global launches
    _check(q, kp, vp, ptab, slot, lens, ks, vs)
    if q.device.type == "cpu":
        return ragged_paged_flash_ref(q, kp, vp, ptab, slot, lens, ks, vs)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_kernel_fits(q, kp)
    T, kvH, G, hd = q.shape
    npages, page = kp.shape[0], kp.shape[1]
    out = torch.empty_like(q)
    if T == 0:
        return out
    fn = _lib()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_Q_CODES[q.dtype], _KV_CODES[kp.dtype], ptr(q), ptr(kp),
                 ptr(vp), ptr(ks), ptr(vs), ptr(ptab), ptr(slot), ptr(lens),
                 ptr(out), T, kvH, G, hd, page, npages, ptab.shape[0],
                 ptab.shape[1], hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_flash launch failed: CUDA error {err}")
    launches += 1
    return out

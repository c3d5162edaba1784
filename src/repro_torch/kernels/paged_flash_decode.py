"""Paged flash-decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py:paged_flash_decode`` (the Pallas
TPU kernel), the attention of the two-phase serving path's decode tick: one
query token per slot over that slot's block-table pages.
``paged_flash_decode`` launches the hand-written kernel in
``csrc/paged_flash_decode.cu`` for CUDA tensors, and runs
``paged_flash_decode_ref`` only for CPU tensors; there is no fallback from
one to the other.  The kernel splits each slot's keys over blocks of
``split_keys`` keys and has two variants, chosen by ``kernel_variant`` from
dtypes, head_dim and alignment alone (the serving kernel's rule,
``ragged_paged_flash.ragged_variant``): "mma" (tensor cores) for bfloat16
q over bfloat16 or int8 pools at head_dim 64 or 128, "simt" (float32 FMA,
the parity route) otherwise.  ``launches`` counts kernel launches (the
plain version does not count), ``launches_by_variant`` splits them by
variant, so a run can show that its decode ticks went through the kernel.

A program counted and never run (tensors on ``meta``, or ``FakeTensor``s
on ``cuda``: ``op_cost.counted_only``) gets an empty output and its
registered cost, and launches nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import op_cost
from repro_torch.kernels import ragged_paged_flash as _rpf

NEG_INF = -1e30

# kernel launches since the last reset (the caller sets it back to 0, and
# every entry of launches_by_variant with reset_launches())
launches = 0
VARIANTS = _rpf.VARIANTS
launches_by_variant = dict.fromkeys(VARIANTS, 0)

# Keys of a block-table row one block takes, at least: chosen on the H100
# from {64, 128, 256} by chip_smoke.py's phase 3 (PERF.md).
SPLIT_KEYS = 128
_MAX_SPLITS = 32  # the kernel's kMaxSplits
_MAX_SPLIT_PAGES = 512  # the kernel's kMaxPages
_ROWS = 16  # query heads one block takes (kRows)
_WARPS = 4
_MAX_HEAD_DIM = 256
_MAX_SMEM = 227 * 1024 - 8 * 1024  # a Hopper block's, less the static part


def reset_launches() -> None:
    """Set ``launches`` and every ``launches_by_variant`` count to 0."""
    global launches
    launches = 0
    for v in VARIANTS:
        launches_by_variant[v] = 0


def kernel_variant(q, kp, vp) -> str:
    """The variant a call on these tensors takes: ``ragged_variant`` of
    their dtypes and head_dim, with the 16-byte alignment of q and both
    pools."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, kp, vp))
    return _rpf.ragged_variant(q.dtype, kp.dtype, q.shape[-1], aligned)


def split_keys(S: int) -> int:
    """Keys of a block-table row (``S`` = pps * page) one block takes:
    ``SPLIT_KEYS``, or more where a row would need more than 32 splits; a
    multiple of 64."""
    per = -(-S // _MAX_SPLITS)
    return max(SPLIT_KEYS, -(-per // 64) * 64)


def n_splits(S: int) -> int:
    """Key splits a row of ``S`` keys is cut into (at least 1)."""
    return max(1, -(-S // split_keys(S)))


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


def _smem_bytes(variant: str, kv_dtype, hd: int) -> int:
    """Dynamic shared memory of one block; mirrors ``MmaSmem`` and
    ``simt_smem_floats`` in csrc/paged_flash_decode.cu."""
    if variant == "mma":
        quant = kv_dtype == torch.int8
        row = 2 * hd + 16
        raw = hd + 16 if quant else row
        loop = _ROWS * row + 2 * 2 * 64 * raw
        if quant:
            loop += 2 * 2 * 64 * 4 + _WARPS * 2 * 16 * row
        return max(loop, 4 * (_WARPS * _ROWS * hd + 2 * _WARPS * _ROWS))
    return 4 * (_ROWS * (hd + 1) + 32 * (hd + 1) + 32 * hd + _WARPS * _ROWS * 8
                + _WARPS * _ROWS * hd + 2 * _WARPS * _ROWS)


def check_kernel_fits(q, kp, vp, ptab) -> None:
    """Refuse shapes the kernel cannot take: head_dim above 256, a split
    spanning more than 512 block-table entries, or more shared memory than
    a block has."""
    hd, page = q.shape[-1], kp.shape[1]
    keys = split_keys(ptab.shape[1] * page)
    variant = kernel_variant(q, kp, vp)
    if (hd > _MAX_HEAD_DIM or (keys - 1) // page + 2 > _MAX_SPLIT_PAGES
            or _smem_bytes(variant, kp.dtype, hd) > _MAX_SMEM):
        raise ValueError(f"head_dim {hd} / page {page} / {keys}-key splits "
                         f"exceed the kernel's limits")


# the split counters of each device: int32 zeros, grown on demand; the
# kernel's last split of each (slot, KV head, row chunk) sets its counter
# back to 0, so one buffer serves every call on the device's stream
_TICKETS: dict = {}


def _tickets(device, n: int):
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def cost(q, kp, vp, ptab, lens, ks=None, vs=None) -> tuple:
    """(FLOPs, bytes) of one decode tick, its roofline bound's: the KV
    pages and scale rows the live lens reach, the live slots' q rows, the
    used block-table entries and every slot's lens read once, the whole
    output written once; FLOPs 4 * sum(lens) * G * kvH * hd.  Reads
    ``lens`` and ``ptab`` on the host (``cost_without_data`` where they
    have none)."""
    if op_cost.counted_only(lens):
        return _rpf.cost_without_data(q, kp, ks, ptab, with_slot=False)
    B, kvH, G, hd = q.shape
    lens_c = lens.cpu().numpy()
    kv_bytes, entries = _rpf.kv_reached(kp, ks, ptab, {
        b: int(lens_c[b]) for b in np.nonzero(lens_c > 0)[0]})
    row = kvH * G * hd * q.element_size()
    nbytes = (kv_bytes + int((lens_c > 0).sum()) * row + B * row + B * 4
              + entries * 4)
    return 4.0 * float(lens_c.sum()) * G * kvH * hd, nbytes


op_cost.register_kernel_cost("paged_flash_decode", cost)


def _lib():
    from repro_torch.kernels import build

    fn = build.load("paged_flash_decode").paged_flash_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
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
    dtype.  Makes no host synchronisation: the grid and the scratch sizes
    follow from shapes alone."""
    global launches
    _check(q, kp, vp, ptab, lens, ks, vs)
    if op_cost.counted_only(q):
        op_cost.kernel_launched("paged_flash_decode", q, kp, vp, ptab, lens,
                                ks, vs)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, kp, vp, ptab, lens, ks, vs)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_kernel_fits(q, kp, vp, ptab)
    B, kvH, G, hd = q.shape
    npages, page = kp.shape[0], kp.shape[1]
    pps = ptab.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if npages == 0 or page == 0:
        raise ValueError("the pools must not be empty")
    variant = kernel_variant(q, kp, vp)
    keys = split_keys(pps * page)
    ns = n_splits(pps * page)
    ws = tickets = None
    if ns > 1:
        ws = torch.empty(ns * B * kvH * G * (hd + 2), dtype=torch.float32,
                         device=q.device)
        tickets = _tickets(q.device, B * kvH * -(-G // _ROWS))
    fn = _lib()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(VARIANTS.index(variant), _rpf._Q_CODES[q.dtype],
                 _rpf._KV_CODES[kp.dtype], ptr(q), ptr(kp), ptr(vp), ptr(ks),
                 ptr(vs), ptr(ptab), ptr(lens), ptr(out), ptr(ws),
                 ptr(tickets), B, kvH, G, hd, page, npages, pps, keys,
                 hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode launch failed: CUDA error {err}")
    launches += 1
    launches_by_variant[variant] += 1
    op_cost.kernel_launched("paged_flash_decode", q, kp, vp, ptab, lens, ks, vs)
    return out

"""Ragged paged flash attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/flash_attention.py:ragged_paged_flash`` (the Pallas
TPU kernel).  ``ragged_paged_flash`` launches the hand-written kernel in
``csrc/ragged_paged_flash.cu`` for CUDA tensors, and runs
``ragged_paged_flash_ref`` only for CPU tensors; there is no fallback from
one to the other.  The kernel has two variants, chosen by
``ragged_variant`` from dtypes, head_dim and alignment alone: "mma"
(tensor cores, ``mma.sync`` bf16) for bfloat16 q over bfloat16 or int8
pools at head_dim 64 or 128, "simt" (float32 FMA) for everything else —
float32 q is the parity route, where bf16 products would change the
result.  One call runs three kernels (plan, attention, merge) and counts
as one launch: ``launches`` counts calls that launched (the plain version
does not count), ``launches_by_variant`` splits them by variant.

A program counted and never run (tensors on ``meta``, or ``FakeTensor``s
on ``cuda``: ``op_cost.counted_only``) gets an empty output and its
registered cost, and launches nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import op_cost

NEG_INF = -1e30

# kernel launches since the last reset (the caller sets it back to 0, and
# every entry of launches_by_variant with reset_launches())
launches = 0
VARIANTS = ("simt", "mma")
launches_by_variant = dict.fromkeys(VARIANTS, 0)

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_HEAD_DIM = 256
_MIN_SPLIT_KEYS = 128  # keys of context one block takes at least
_MAX_SPLITS = 16


def reset_launches() -> None:
    """Set ``launches`` and every ``launches_by_variant`` count to 0."""
    global launches
    launches = 0
    for v in VARIANTS:
        launches_by_variant[v] = 0


def ragged_variant(q_dtype, kv_dtype, hd: int, aligned: bool = True) -> str:
    """The kernel variant for q of ``q_dtype`` over pools of ``kv_dtype``
    at head_dim ``hd``: "mma" for bfloat16 q over bfloat16 or int8 pools
    at hd 64 or 128 with q and the pools 16-byte aligned (``aligned``),
    "simt" otherwise.  A documented choice of type and shape, never a
    reaction to a failed build or launch."""
    mma = (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
           and hd in (64, 128) and aligned)
    return "mma" if mma else "simt"


def split_keys(S: int) -> int:
    """Keys of a block-table row (``S`` = pps * page) one block takes: at
    least 128, a multiple of 64, and at most 16 splits a row (the merge
    kernel's limit)."""
    per = -(-S // _MAX_SPLITS)
    return max(_MIN_SPLIT_KEYS, -(-per // 64) * 64)


def n_splits(S: int) -> int:
    """Split-K blocks a row of ``S`` keys is cut into (at least 1)."""
    return max(1, -(-S // split_keys(S)))


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


def _check(q, kp, vp, ptab, slot, lens, ks, vs):
    check_pools(q, kp, vp, ks, vs)
    T = q.shape[0]
    if ptab.ndim != 2 or slot.shape != (T,) or lens.shape != (T,):
        raise ValueError("ptab must be (B, pps); slot and lens (T,)")
    for name, t in (("ptab", ptab), ("slot", slot), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    check_same_device_contiguous([q, kp, vp, ptab, slot, lens, ks, vs])


def kv_reached(kp, ks, ptab, row_lens) -> tuple:
    """(bytes, block-table entries) of the KV the given block-table rows
    reach: ``row_lens`` maps a row to its longest visible length; each
    unique pool page counts once, K and V, with its scale rows for int8."""
    page = kp.shape[1]
    pages, entries = set(), 0
    for b, n_len in row_lens.items():
        n = -(-n_len // page)
        entries += n
        pages.update(np.minimum(ptab[b, :n].cpu().numpy(),
                                kp.shape[0] - 1).tolist())
    page_bytes = page * kp.shape[2] * kp.shape[3] * kp.element_size()
    if ks is not None:
        page_bytes += page * kp.shape[2] * 4
    return 2 * len(pages) * page_bytes, entries


def cost_without_data(q, kp, ks, ptab, *, with_slot: bool) -> tuple:
    """(FLOPs, bytes) of a call whose block table and lengths hold no data
    (a program counted and never run, ``op_cost.counted_only``): every one
    of q's rows live at its full table of pps * page entries, over as
    many distinct pool pages as the pool and the table allow -- the most
    the shapes allow, where a call with data counts what its lengths
    reach.  ``with_slot``: the rows carry a slot index (the ragged
    kernel), read for each."""
    n, kvH, G, hd = q.shape
    B, pps = ptab.shape
    page = kp.shape[1]
    page_bytes = page * kp.shape[2] * kp.shape[3] * kp.element_size()
    if ks is not None:
        page_bytes += page * kp.shape[2] * 4
    kv_bytes = 2 * min(kp.shape[0], B * pps) * page_bytes
    row = kvH * G * hd * q.element_size()
    nbytes = (kv_bytes + 2 * n * row + n * 4 + with_slot * n * 4
              + B * pps * 4)
    return 4.0 * n * pps * page * G * kvH * hd, nbytes


def cost(q, kp, vp, ptab, slot, lens, ks=None, vs=None) -> tuple:
    """(FLOPs, bytes) of one call, its roofline bound's.  Bytes: each input
    the result depends on read once (the KV pages the live tokens, lens >
    0, reach, their scale rows, those tokens' q rows, ``lens`` for every
    row and ``slot`` for the live ones, the block-table entries they use)
    and the whole output written once.  FLOPs 4 * sum(lens) * G * kvH *
    hd.  Reads ``lens``, ``slot`` and ``ptab`` on the host
    (``cost_without_data`` where they have none)."""
    if op_cost.counted_only(lens):
        return cost_without_data(q, kp, ks, ptab, with_slot=True)
    T, kvH, G, hd = q.shape
    lens_c, slot_c = lens.cpu().numpy(), slot.cpu().numpy()
    live = lens_c > 0
    n_live = int(live.sum())
    kv_bytes, entries = kv_reached(kp, ks, ptab, {
        b: int(lens_c[live & (slot_c == b)].max())
        for b in np.unique(slot_c[live]).tolist()})
    row = kvH * G * hd * q.element_size()
    nbytes = (kv_bytes + n_live * row + T * row + T * 4 + n_live * 4
              + entries * 4)
    return 4.0 * float(lens_c.sum()) * G * kvH * hd, nbytes


op_cost.register_kernel_cost("ragged_paged_flash", cost)


def _lib():
    from repro_torch.kernels import build

    lib = build.load("ragged_paged_flash")
    fn = lib.ragged_paged_flash
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=None, vs=None):
    """Ragged-pack attention over a paged KV pool (one serving tick).

    q: (T, kvH, G, hd) float32/bfloat16; kp, vp: (n_pages, page, kvH, hd)
    float32/bfloat16/int8 (a per-layer view of a stacked pool is fine: it is
    contiguous); ks, vs: (n_pages, page, kvH) float32 scale pools, for int8
    pools only; ptab: (B, pps) int32 block table (entries >= n_pages are
    unmapped); slot, lens: (T,) int32 — each token's slot and visible length
    (``q_pos + 1``; 0 for an invalid token, whose output is zeros).  Tokens
    may come in any order; a slot's tokens in one run are fastest.
    Returns (T, kvH, G, hd) in q's dtype.  Makes no host synchronisation:
    the grid and the scratch sizes follow from shapes alone."""
    global launches
    _check(q, kp, vp, ptab, slot, lens, ks, vs)
    if op_cost.counted_only(q):
        op_cost.kernel_launched("ragged_paged_flash", q, kp, vp, ptab, slot,
                                lens, ks, vs)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ragged_paged_flash_ref(q, kp, vp, ptab, slot, lens, ks, vs)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    T, kvH, G, hd = q.shape
    npages, page = kp.shape[0], kp.shape[1]
    B, pps = ptab.shape
    if hd > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} exceeds the kernel's {_MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if npages == 0 or page == 0 or B == 0:
        raise ValueError("the pools and the block table must not be empty")
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, kp, vp))
    variant = ragged_variant(q.dtype, kp.dtype, hd, aligned)
    S = pps * page
    ns = n_splits(S)
    tiles = torch.empty(T + 1, dtype=torch.int32, device=q.device)
    ws = (torch.empty(ns * T * kvH * G * (hd + 2), dtype=torch.float32,
                      device=q.device) if ns > 1 else None)
    fn = _lib()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(VARIANTS.index(variant), _Q_CODES[q.dtype], _KV_CODES[kp.dtype],
                 ptr(q), ptr(kp), ptr(vp), ptr(ks), ptr(vs), ptr(ptab),
                 ptr(slot), ptr(lens), ptr(out), ptr(tiles), ptr(ws), T, kvH,
                 G, hd, page, npages, B, pps, split_keys(S), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_flash launch failed: CUDA error {err}")
    launches += 1
    launches_by_variant[variant] += 1
    op_cost.kernel_launched("ragged_paged_flash", q, kp, vp, ptab, slot, lens,
                            ks, vs)
    return out

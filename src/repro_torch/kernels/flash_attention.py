"""Causal flash attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``repro/kernels/flash_attention.py:flash_attention`` (the Pallas TPU
kernel).  ``flash_attention`` launches the hand-written kernel in
``csrc/flash_attention.cu`` for CUDA tensors, and runs
``flash_attention_ref`` only for CPU tensors; there is no fallback from one
to the other.  The kernel has two variants, chosen by ``flash_variant`` from
the dtype and head_dim alone: "wgmma" (tensor cores, TMA) for bfloat16 at
head_dim 64 or 128, "simt" (float32 FMA) for float32 — the parity route,
where TF32 would change the result — and for any other head_dim, a
multiple of 8 up to 256 (gemma3-4b's global layers run it at 256).
``launches`` counts kernel launches (the plain version does not count), and
``launches_by_variant`` splits them by variant, so a run can show that its
attention went through the kernel it expected.

A program counted and never run (tensors on ``meta``, or ``FakeTensor``s
on ``cuda``: ``op_cost.counted_only``) gets an empty output and its
registered cost, and launches nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import op_cost

NEG_INF = -1e30

# kernel launches since the last reset (the caller sets it back to 0, and
# every entry of launches_by_variant with reset_launches())
launches = 0
VARIANTS = ("simt", "wgmma")
launches_by_variant = dict.fromkeys(VARIANTS, 0)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


def reset_launches() -> None:
    """Set ``launches`` and every ``launches_by_variant`` count to 0."""
    global launches
    launches = 0
    for v in VARIANTS:
        launches_by_variant[v] = 0


def flash_variant(dtype, hd: int) -> str:
    """The kernel variant for q, k, v of ``dtype`` and head_dim ``hd``:
    "wgmma" for bfloat16 at hd 64 or 128 (the shapes its TMA boxes and
    wgmma tiles are built for), "simt" otherwise.  A documented choice of
    shape and type, never a reaction to a failed build or launch."""
    return "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "simt"


def flash_attention_ref(q, k, v, window: Optional[int] = None):
    """Plain PyTorch causal attention with the kernel's arithmetic: float32
    scores of ``q * hd**-0.5`` against k, masked with ``NEG_INF``, p =
    exp(s - rowmax) rounded to v's dtype before the PV product, the row sum
    taken before that rounding and clamped at 1e-30, the output cast to q's
    dtype.  Shapes as ``flash_attention``."""
    BH, S, hd = q.shape
    BKV = k.shape[0]
    G = BH // BKV
    qf = q.float().reshape(BKV, G, S, hd) * hd ** -0.5
    s = torch.einsum("kgqd,ktd->kgqt", qf, k.float())
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    ok = rows >= cols
    if window is not None:
        ok &= (rows - cols) < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("kgqt,ktd->kgqd", p.to(v.dtype).float(), v.float()) / l
    return o.reshape(BH, S, hd).to(q.dtype)


def _check(q, k, v, bq: int, bk: int, window) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"q must be (BH,S,hd) and k, v (BKV,S,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, hd = q.shape
    if k.shape[1:] != (S, hd) or k.shape[0] == 0 or BH % k.shape[0] != 0:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}: "
                         f"BH must be a multiple of BKV")
    # the Pallas kernel's tiling rule (_flash_attention); the CUDA kernel
    # tiles by itself, so bq/bk change nothing else
    bq, bk = min(bq, S), min(bk, S)
    if S % max(bq, 1) != 0 or S % max(bk, 1) != 0:
        raise ValueError(f"S={S} is not a multiple of bq={bq} and bk={bk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {list(_CODES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def flops(q, window: Optional[int] = None) -> float:
    """4 * hd FLOPs for each (row, col) pair the mask keeps (0 <= row - col
    < window, S without one) in each of the BH rows."""
    BH, S, hd = q.shape
    W = S if window is None else min(window, S)
    pairs = W * S - W * (W - 1) // 2
    return 4.0 * hd * pairs * BH


def cost(q, k, v, *, bq: int = 128, bk: int = 128,
         window: Optional[int] = None) -> tuple:
    """(FLOPs, bytes) of one call, its roofline bound's: q, k and v read
    once and the output written once; ``flops`` of the mask."""
    return flops(q, window), (2 * q.numel() + 2 * k.numel()) * q.element_size()


op_cost.register_kernel_cost("flash_attention", cost)


def _lib():
    from repro_torch.kernels import build

    fn = build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, bq: int = 128, bk: int = 128,
                    window: Optional[int] = None):
    """Causal (optionally sliding-window) flash attention forward.

    q: (BH, S, hd); k, v: (BKV, S, hd) with BH a multiple of BKV: query row
    ``bh`` attends to K/V row ``bh // (BH // BKV)``.  float32 or bfloat16,
    all three alike, contiguous.  ``bq``/``bk`` are the Pallas kernel's
    tiles: S must be a multiple of each (capped at S), as there; the CUDA
    kernel picks its own tiles, and its variant by ``flash_variant``.
    Returns (BH, S, hd) in q's dtype."""
    global launches
    _check(q, k, v, bq, bk, window)
    if op_cost.counted_only(q):
        op_cost.kernel_launched("flash_attention", q, k, v, window=window)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    BH, S, hd = q.shape
    if hd % 8 != 0 or hd > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 up to "
                         f"{_MAX_HEAD_DIM}, got {hd}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    variant = flash_variant(q.dtype, hd)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(VARIANTS.index(variant), _CODES[q.dtype], q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
                 k.shape[0], S, hd, 0 if window is None else int(window),
                 hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    launches_by_variant[variant] += 1
    op_cost.kernel_launched("flash_attention", q, k, v, window=window)
    return out

"""Row RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm`` (the Pallas TPU kernel):
``x * rsqrt(mean(x²) + eps) * scale`` over the last axis, float32
statistics, the output in x's dtype.  ``rmsnorm`` launches the hand-written
kernel in ``csrc/rmsnorm.cu`` for CUDA tensors and runs ``rmsnorm_ref``
only for CPU tensors; there is no fallback from one to the other.
``launches`` counts kernel launches (the plain version does not count),
``launches_by_route`` splits them by route.  ``rmsnorm_plan`` picks the
route and the threads per row from R, D, the type and the alignment alone:
16-byte vector loads with the row held in registers ("cached"), the same
loads reading the row twice where it is too wide for the register cache
("reread"), or scalar loads where rows are not 16-byte aligned
("scalar").  The TPU kernel's ``block_rows`` only tiles its grid (rows are
padded to it), which changes no result.

A program counted and never run (tensors on ``meta``, or ``FakeTensor``s
on ``cuda``: ``op_cost.counted_only``) gets an empty output and its
registered cost, and launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import op_cost

# kernel launches since the last reset (the caller sets it back to 0, and
# every entry of launches_by_route with reset_launches())
launches = 0
ROUTES = ("scalar", "cached", "reread")
launches_by_route = dict.fromkeys(ROUTES, 0)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK = 256  # threads of a block (csrc/rmsnorm.cu kBlock)
_CACHE_VECS = 8  # 16-byte vectors a thread holds (kCacheVecs)
_FILL_BLOCKS = 2 * 132  # two blocks for each of an H100's 132 SMs


def reset_launches() -> None:
    """Set ``launches`` and every ``launches_by_route`` count to 0."""
    global launches
    launches = 0
    for r in ROUTES:
        launches_by_route[r] = 0


def rmsnorm_plan(R: int, D: int, itemsize: int, aligned: bool = True):
    """(route, threads per row) for R rows of D values of ``itemsize``
    bytes.  Rows not 16-byte aligned (D * itemsize not a multiple of 16, or
    a pointer off alignment: ``aligned`` False) take "scalar" (a warp per
    row).  Rows of more than 256 x 8 vectors take "reread" (a block per
    row).  Otherwise "cached", with the fewest threads per row (32, 64, 128
    or 256) that hold the row in 8 vectors a thread and, where the rows
    allow, give the grid at least ``_FILL_BLOCKS`` blocks."""
    if not aligned or (D * itemsize) % 16:
        return "scalar", 32
    nv = D * itemsize // 16
    if nv > _BLOCK * _CACHE_VECS:
        return "reread", _BLOCK
    tpr = 32
    while tpr < _BLOCK and (-(-nv // tpr) > _CACHE_VECS or (
            -(-R // (_BLOCK // tpr)) < _FILL_BLOCKS and tpr < nv)):
        tpr *= 2
    return "cached", tpr


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """Plain PyTorch RMSNorm — the JAX package's
    ``kernels/ref.py:rmsnorm_ref``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _check(x, scale):
    if x.ndim < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"x must be (..., D) and scale (D,); got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _CODES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_CODES)}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if scale.device != x.device:
        raise ValueError("x and scale must be on one device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")


def _lib():
    from repro_torch.kernels import build

    fn = build.load("rmsnorm").rmsnorm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def cost(x, scale, *, eps: float = 1e-6) -> tuple:
    """(FLOPs, bytes) of one call, its roofline bound's: x read and the
    output written once, the scale read once; 4 FLOPs an element."""
    return (4.0 * x.numel(),
            2 * x.numel() * x.element_size() + scale.numel() * scale.element_size())


op_cost.register_kernel_cost("rmsnorm", cost)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x: (..., D) float32/bfloat16; scale: (D,) float32.  Returns x's shape
    and dtype."""
    global launches
    _check(x, scale)
    if op_cost.counted_only(x):
        op_cost.kernel_launched("rmsnorm", x, scale, eps=eps)
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    D = x.shape[-1]
    R = x.numel() // max(D, 1)
    out = torch.empty_like(x)
    if R == 0 or D == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, out))
    route, tpr = rmsnorm_plan(R, D, x.element_size(), aligned)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ROUTES.index(route), tpr, _CODES[x.dtype], x.data_ptr(),
                 scale.data_ptr(), out.data_ptr(), R, D, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")
    launches += 1
    launches_by_route[route] += 1
    op_cost.kernel_launched("rmsnorm", x, scale, eps=eps)
    return out

"""Tiled matrix product: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``repro/kernels/matmul.py:matmul`` (the Pallas TPU kernel), the
paper's central operation, with its two accumulation policies:

- ``accum="vmem"`` (the paper's "cache" mode): the float32 accumulator stays
  on chip for the whole K loop and C is written once.  One launch.
- ``accum="hbm"`` ("flat" mode): C is float32 in device memory, read and
  written back once per ``bk``-wide slice of K — one launch per slice,
  ceil(K / bk) of them — then cast to the output type.

``block=(bm, bk, bn)`` keeps the TPU kernel's meaning where it changes what
is computed or moved: ``bk`` sets the number of C passes of the ``hbm``
policy.  ``bm``/``bn`` (and ``bk`` under ``vmem``) only cut the TPU grid
and pad the operands with zeros there, which changes no result; the CUDA
kernel picks its own 128 x 128 output tiles and masks the ragged edges
(and each slice's end) instead of padding.

``matmul`` launches the hand-written kernel in ``csrc/matmul.cu`` for CUDA
tensors and runs ``matmul_ref`` only for CPU tensors; there is no fallback
from one to the other.  Each launch takes one of four routes, chosen by
``matmul_route`` from the dtype and the layout alone: float32 runs float32
FMA, bfloat16 runs wgmma on the tensor cores; each takes its fast route
("fma_async" through a cp.async ring, "wgmma_tma" through a TMA ring) where
the row strides, the slice start and the pointers are 16-byte aligned, and
otherwise loads through registers ("fma_scalar", "wgmma_staged").  ``launches`` counts kernel launches (one per call
under ``vmem``, one per K slice under ``hbm``; the plain version does not
count) and ``launches_by_route`` splits them by route.

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
ROUTES = ("fma_async", "fma_scalar", "wgmma_tma", "wgmma_staged")
launches_by_route = dict.fromkeys(ROUTES, 0)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACCUMS = ("vmem", "hbm")


def reset_launches() -> None:
    """Set ``launches`` and every ``launches_by_route`` count to 0."""
    global launches
    launches = 0
    for r in ROUTES:
        launches_by_route[r] = 0


def matmul_route(dtype, K: int, N: int, k0: int = 0,
                 aligned: bool = True) -> str:
    """The kernel route of one launch over a (M, K) x (K, N) product's
    slice starting at ``k0``, with ``aligned`` telling whether both base
    pointers are 16-byte aligned.  Both types take their fast route where
    the row strides (K and N elements) and the slice start are multiples of
    16 bytes, as 16-byte cp.async and TMA boxes need: float32 "fma_async",
    else "fma_scalar"; bfloat16 "wgmma_tma", else "wgmma_staged".  A
    documented choice of type and layout, never a reaction to a failed
    build or launch."""
    item = 4 if dtype == torch.float32 else 2
    fast = aligned and all((n * item) % 16 == 0 for n in (K, N, k0))
    if dtype == torch.float32:
        return "fma_async" if fast else "fma_scalar"
    return "wgmma_tma" if fast else "wgmma_staged"


def matmul_ref(a, b, out_dtype=None):
    """Plain PyTorch product: float32 operands, float32 result, cast to
    ``out_dtype`` (default a's dtype) — the JAX package's
    ``kernels/ref.py:matmul_ref``."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def _check(a, b, block, accum, out_dtype):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a must be (M, K) and b (K, N); got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype not in _CODES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share one dtype of {list(_CODES)}; got "
                        f"{a.dtype}, {b.dtype}")
    if (out_dtype or a.dtype) not in _CODES:
        raise TypeError(f"out_dtype {out_dtype} not in {list(_CODES)}")
    if accum not in ACCUMS:
        raise ValueError(f"accum must be one of {ACCUMS}, got {accum!r}")
    if len(block) != 3 or min(block) < 1:
        raise ValueError(f"block must be three positive sizes, got {block}")
    if b.device != a.device:
        raise ValueError("a and b must be on one device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")


def k_slices(K: int, block, accum: str):
    """The K ranges [k0, k1) of the kernel's passes over C: all of K once
    under ``vmem``; under ``hbm`` one per ``bk``-wide slice, bk capped at K
    as the TPU kernel caps its blocks, the last slice ragged where the TPU
    kernel zero-pads K to ``Kp`` (so there are ``Kp // bk`` of them)."""
    if accum == "vmem" or K == 0:
        return [(0, K)]
    bk = min(block[1], K)
    return [(k0, min(k0 + bk, K)) for k0 in range(0, K, bk)]


def k_passes(K: int, block, accum: str) -> int:
    """Passes over C (kernel launches) of one call."""
    return len(k_slices(K, block, accum))


def policy_bytes(M: int, K: int, N: int, dtype, block, accum: str,
                 out_dtype=None) -> int:
    """Bytes one (M, K) x (K, N) call must move under its policy: A and B
    read once in ``dtype``.  ``vmem`` writes C once in the output type;
    ``hbm`` reads and writes a float32 C once per pass (``k_passes``), and
    where the output type is not float32, reads that C once more for the
    cast and writes the output."""
    item = torch.empty((), dtype=dtype).element_size()
    out_dtype = out_dtype or dtype
    out_item = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (M * K + K * N) * item
    if accum == "vmem":
        return nbytes + M * N * out_item
    nbytes += 2 * k_passes(K, block, accum) * M * N * 4
    if out_dtype != torch.float32:
        nbytes += M * N * (4 + out_item)
    return nbytes


def cost(a, b, *, block=(256, 256, 256), accum: str = "vmem",
         out_dtype=None) -> tuple:
    """(FLOPs, bytes) of one call, its roofline bound's: 2 M N K and
    ``policy_bytes``."""
    (M, K), N = a.shape, b.shape[1]
    return 2.0 * M * N * K, policy_bytes(M, K, N, a.dtype, block, accum,
                                         out_dtype)


op_cost.register_kernel_cost("matmul", cost)


def _lib():
    from repro_torch.kernels import build

    fn = build.load("matmul").matmul
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def matmul(a, b, *, block=(256, 256, 256), accum: str = "vmem",
           out_dtype=None):
    """C = A·B with float32 accumulation.  a: (M, K), b: (K, N), float32 or
    bfloat16 alike, contiguous; returns (M, N) in ``out_dtype`` (default
    a's dtype).  ``block``/``accum`` as in the module docstring."""
    global launches
    _check(a, b, block, accum, out_dtype)
    out_dtype = out_dtype or a.dtype
    if op_cost.counted_only(a):
        op_cost.kernel_launched("matmul", a, b, block=block, accum=accum,
                                out_dtype=out_dtype)
        return torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                           device=a.device)
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    (M, K), N = a.shape, b.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"dimensions {M}, {K}, {N} exceed the kernel's int32")
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=out_dtype, device=a.device)
    hbm = accum == "hbm"
    c = (torch.zeros((M, N), dtype=torch.float32, device=a.device) if hbm
         else torch.empty((M, N), dtype=out_dtype, device=a.device))
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        for k0, k1 in k_slices(K, block, accum):
            route = matmul_route(a.dtype, K, N, k0, aligned)
            err = fn(ROUTES.index(route), _CODES[a.dtype], _CODES[c.dtype],
                     int(hbm), a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N,
                     K, k0, k1, stream)
            if err != 0:
                raise RuntimeError(f"matmul launch failed: CUDA error {err}")
            launches += 1
            launches_by_route[route] += 1
    op_cost.kernel_launched("matmul", a, b, block=block, accum=accum,
                            out_dtype=out_dtype)
    return c.to(out_dtype) if hbm else c

"""Public kernel entry points and the paged pool's int8 and page helpers.

Counterpart of ``repro.kernels.ops``: the entry points of the five kernels
(ragged paged attention, paged flash-decode attention, causal flash
attention and its differentiable grouped-layout form
``flash_attention_grouped``, the training path's attention; the tiled
matmul; RMSNorm), the symmetric int8 KV quantization of the
serving pools (one float32 scale per pool entry per KV head, absmax over the
head dim), the quantize-on-write scatter, and the copy-on-write page copy.

The pools are updated IN PLACE (``kv_scatter_quantized``, ``copy_pages``):
that replaces JAX's buffer donation, so a pool keeps its ``data_ptr()`` for
the engine's whole life.  Where JAX scatters with ``mode="drop"`` (the
sentinel page ``n_pages`` marks a write that must not land), the writes
here go through ``scatter_live``: every entry writes, at a shape fixed by
the inputs' shapes, and a dropped entry writes bytes that are already
there or that a live entry writes too.  No boolean index, so no
``nonzero`` and no host synchronisation: the serving steps can be captured
in a CUDA graph.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import paged_flash_decode as _pfd
from repro_torch.kernels import ragged_paged_flash as _rpf
from repro_torch.kernels import rmsnorm as _rn


def matmul(a, b, *, block=(256, 256, 256), accum="vmem", out_dtype=None):
    """C = A·B, float32 accumulation; ``accum`` "vmem" keeps the
    accumulator on chip, "hbm" revisits a float32 C in device memory once
    per ``block[1]``-wide K slice.  CUDA tensors launch the hand-written
    kernel (``kernels/csrc/matmul.cu``), CPU tensors run its plain PyTorch
    version."""
    return _mm.matmul(a, b, block=block, accum=accum, out_dtype=out_dtype)


def flash_attention(q, k, v, *, bq=128, bk=128, window=None):
    """Causal flash attention: q (BH,S,hd), k/v (BKV,S,hd) -> (BH,S,hd).
    CUDA tensors launch the hand-written kernel
    (``kernels/csrc/flash_attention.cu``), CPU tensors run its plain
    PyTorch version."""
    return _fa.flash_attention(q, k, v, bq=bq, bk=bk, window=window)


def paged_flash_decode(q, kp, vp, ptab, lens, ks=None, vs=None):
    """Decode-tick attention, one query token per slot, over a
    block-table-paged KV pool.  q: (B,kvH,G,hd); kp/vp:
    (n_pages,page,kvH,hd); ptab: (B,pps) int32; lens: (B,) int32 ->
    (B,kvH,G,hd).  int8 pools pass their scale pools ``ks``/``vs``.  CUDA
    tensors launch the hand-written kernel
    (``kernels/csrc/paged_flash_decode.cu``), CPU tensors run its plain
    PyTorch version."""
    return _pfd.paged_flash_decode(q, kp, vp, ptab, lens, ks=ks, vs=vs)


def ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=None, vs=None):
    """Ragged-pack serving attention over a block-table-paged KV pool.
    q: (T,kvH,G,hd); slot/lens: (T,) int32; kp/vp: (n_pages,page,kvH,hd);
    ptab: (B,pps) int32 -> (T,kvH,G,hd).  int8 pools pass their scale pools
    ``ks``/``vs`` ((n_pages,page,kvH) float32).  CUDA tensors launch the
    hand-written kernel (``kernels/csrc/ragged_paged_flash.cu``), CPU
    tensors run its plain PyTorch version."""
    return _rpf.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)


def rmsnorm(x, scale, *, eps=1e-6):
    """Row RMSNorm of x (..., D) with a float32 scale (D,), float32
    statistics, in x's dtype.  CUDA tensors launch the hand-written kernel
    (``kernels/csrc/rmsnorm.cu``), CPU tensors run its plain PyTorch
    version."""
    return _rn.rmsnorm(x, scale, eps=eps)


def _flash_grouped_local(q, k, v, window):
    """Grouped-layout kernel call.
    q: (B,S,kvH,G,hd); k,v: (B,S,kvH,hd) -> (B,S,kvH,G,hd)."""
    B, S, kvH, G, hd = q.shape
    # contiguous first: reshape alone may return a strided view (B == 1)
    qk = q.movedim(1, 3).contiguous().view(B * kvH * G, S, hd)
    kk = k.movedim(1, 2).contiguous().view(B * kvH, S, hd)
    vk = v.movedim(1, 2).contiguous().view(B * kvH, S, hd)
    bq = bk = max(min(128, S), 1)
    o = flash_attention(qk, kk, vk, bq=bq, bk=bk, window=window)
    return o.reshape(B, kvH, G, S, hd).movedim(3, 1)


def _ref_grouped(q, k, v, window):
    """The chunked attention that the backward pass differentiates (JAX has
    no backward kernel either)."""
    from repro_torch.models.layers.attention import _chunked_attn

    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    return _chunked_attn(q, k, v, pos, pos, True, window,
                         min(128, S) if S % min(128, S) == 0 else S)


class _FlashGrouped(torch.autograd.Function):
    """JAX's ``custom_vjp`` ``_flash_grouped``: the kernel forward; the
    backward recomputes ``_ref_grouped`` from the saved q, k, v and returns
    its vector-Jacobian product.  The mesh (``shard_map``) branch of JAX's
    forward waits for the multi-GPU slice."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return _flash_grouped_local(q, k, v, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = _ref_grouped(q, k, v, ctx.window)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention_grouped(q, k, v, *, window=None):
    """Differentiable grouped-layout flash attention.
    q: (B,S,kvH,G,hd); k,v: (B,S,kvH,hd) -> (B,S,kvH,G,hd)."""
    return _FlashGrouped.apply(q, k, v, window)


# ---------------------------------------------------------------------------
# int8 KV quantization (paged serving pools)


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 quantization of KV rows: one scale per (.., kvH) row.

    x: (..., kvH, hd) -> (int8 rows, float32 scales (..., kvH)).
    scale = absmax/127 (clamped away from zero); values round half to even
    (``torch.round``, like ``jnp.round``) into [-127, 127]."""
    xf = x.float()
    s = torch.amax(torch.abs(xf), dim=-1) / 127.0
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(xf / s[..., None]), -127.0, 127.0)
    return q.to(torch.int8), s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype=torch.float32):
    """Inverse of ``quantize_kv``: q (..., kvH, hd) int8, s (..., kvH)."""
    return (q.float() * s[..., None].float()).to(dtype)


def live_writes(page: torch.Tensor, n_pages: int) -> torch.Tensor:
    """Mask of scatter targets that exist: JAX drops writes to page ids
    outside [0, n_pages) (the sentinel ``n_pages`` above all)."""
    return (page >= 0) & (page < n_pages)


def scatter_live(pairs, index, live) -> None:
    """``dst[index] = values`` for each (dst, values) of ``pairs``, in
    place, where ``live`` is set — JAX's ``.at[index].set(values,
    mode="drop")`` with the dropped entries marked by ``live`` == False.

    Shape-static: all N entries write.  A dropped entry takes the target and
    the value of the first live entry (``argmax`` of ``live``), so a target
    that several entries hit receives the same bytes from each and
    ``index_put_``'s unspecified order cannot matter; with no live entry,
    every entry writes entry 0's target with its own current value.
    ``live``: bool of any shape S; ``index``: a tuple of int64 tensors of
    shape S, already clamped into ``dst``'s range; ``values``: S + the
    shape of one ``dst`` entry."""
    n = live.numel()
    live = live.reshape(n)
    first = torch.argmax(live.to(torch.uint8))
    src = torch.where(live, torch.arange(n, device=live.device), first)
    keep = live[src]
    idx = tuple(i.reshape(n)[src] for i in index)
    for dst, values in pairs:
        new = values.reshape((n,) + values.shape[len(index[0].shape):])
        new = new[src].to(dst.dtype)
        put = keep.reshape((n,) + (1,) * (new.ndim - 1))
        dst.index_put_(idx, torch.where(put, new, dst[idx]))


def kv_scatter_quantized(pool, scales, rows, page, off):
    """Fused quantize-on-write KV scatter for int8 paged pools: quantizes
    all of ``rows`` ((T, kvH, hd)) and writes values into ``pool[page,
    off]`` and scales into ``scales[page, off]``, in place.  Sentinel pages
    drop both writes (``scatter_live``).  Returns (pool, scales), the same
    tensors."""
    q, s = quantize_kv(rows)
    n_pages = pool.shape[0]
    scatter_live([(pool, q), (scales, s)],
                 (page.clamp(0, n_pages - 1), off), live_writes(page, n_pages))
    return pool, scales


def copy_pages(pool, src, dst, axis=None):
    """Copy-on-write page copy, in place: ``pool[..., dst[i], ...] =
    pool[..., src[i], ...]`` for each pair, IN ORDER.

    pool: (..., n_pages, page, kvH, hd) (``axis=None`` means ``ndim - 4``)
    or a (..., n_pages, page, kvH) scale pool (``axis = ndim - 3``); a
    leading layer axis rides along.  src/dst: (K,) ints; indices clamp to
    ``n_pages - 1``, so sentinel pairs become a self-copy of the last page,
    which is a no-op and is skipped."""
    ax = pool.ndim - 4 if axis is None else axis
    n = pool.shape[ax]
    for s, d in zip(torch.as_tensor(src).tolist(), torch.as_tensor(dst).tolist()):
        s, d = min(s, n - 1), min(d, n - 1)
        if s != d:
            pool.select(ax, d).copy_(pool.select(ax, s))
    return pool

"""Error-feedback int8 gradient compression for data-parallel reduction —
``repro.optim.compress``.

``compressed_psum_local`` replaces the float32 gradient all-reduce over
the 'data' group with: rowwise-absmax int8 quantization (JAX's ``_quant``
is the optimizer state's ``quantize``, as here) -> an all-gather
of the int8 rows and their float32 scales -> a local dequantized sum.
The quantization error is carried in an error-feedback residual
(``EFState``) added back before the next step's compression, which
restores convergence.

JAX runs this inside ``shard_map`` over 'data'; the port runs one
process per rank, so a rank holds its own residual — its slice of JAX's
``(world, ...)`` residual leaf — and ``make_ddp_value_and_grad`` takes
its rows of the global batch.  As in JAX, this is the pure-DP regime
(parameters replicated over 'data'); under FSDP the reduction is a
reduce-scatter, and compressing that is later work.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.optim.quantized_state import dequantize, quantize
from repro_torch.parallel.sharding import (all_gather_cat, axes_size,
                                          axis_coordinate, axis_group)


def compressed_psum_local(x: torch.Tensor, group):
    """int8-compressed mean of ``x`` over ``group``: (mean, this rank's
    quantization error)."""
    qx = quantize(x)
    # (W, ...) int8 rows and their scales on the wire, in group order
    every = {k: all_gather_cat(v[None], group) for k, v in qx.items()}
    total = torch.sum(dequantize(every), dim=0)
    err = x - dequantize(qx)  # local error feedback
    return total / every["q"].shape[0], err


class EFState(NamedTuple):
    residual: torch.Tensor


def ef_init(x: torch.Tensor) -> EFState:
    return EFState(torch.zeros_like(x, dtype=torch.float32))


def ef_compressed_mean(x: torch.Tensor, ef: EFState, group):
    """Error-feedback compressed mean: compress (x + residual), keep the
    quantization error as the next residual."""
    xc = x.float() + ef.residual
    mean, err = compressed_psum_local(xc, group)
    return mean.to(x.dtype), EFState(err)


def ef_init_tree(params, world: int):
    """This rank's residuals: zeros of ``(1,) + p.shape`` per parameter
    (any pytree of tensors), its slice of JAX's ``(world, ...)`` leaf
    sharded over the data axis of ``world`` ranks."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    return tree_map(lambda p: torch.zeros((1,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def make_ddp_value_and_grad(loss_fn, mesh, axis: str = "data"):
    """DDP gradient step with int8 error-feedback compressed reduction.

    Returns ``fn(params, ef, batch) -> (loss, grads, new_ef)``: ``params``
    (a pytree of tensors) replicated, ``batch`` (a pytree of tensors) the
    global batch, of which this rank takes its rows along ``axis``, and
    ``ef`` this rank's residuals (``ef_init_tree``).  ``loss`` is the mean
    over ``axis`` of the ranks' losses, ``grads`` the compressed mean of
    their gradients."""
    group = axis_group(mesh, axis)
    world = axes_size(mesh, axis)
    rank = axis_coordinate(mesh, axis)

    def rows(b):
        n = b.shape[0] // world
        return b[rank * n:(rank + 1) * n]

    def fn(params, ef, batch):
        leaves, spec = tree_flatten(params)
        with torch.enable_grad():
            work = [p.detach().requires_grad_() for p in leaves]
            loss = loss_fn(tree_unflatten(work, spec), tree_map(rows, batch))
            grads = torch.autograd.grad(loss, work)
        means, news = [], []
        for g, e in zip(grads, tree_flatten(ef)[0], strict=True):
            m, ne = ef_compressed_mean(g, EFState(e[0]), group)
            means.append(m)
            news.append(ne.residual[None])
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        return (loss / world, tree_unflatten(means, spec),
                tree_unflatten(news, spec))

    return fn

"""GPipe-style pipeline parallelism over a 'pipe' mesh axis —
``repro.parallel.pipeline``.

Each rank of the 'pipe' axis holds one stage's parameters (its slice of
the leading stage dim); microbatches stream around a ring with the
classic (M + P - 1)-tick fill/drain schedule, and at the end the last
stage's outputs are summed over the axis so that every rank holds them.
JAX runs this under ``shard_map`` with ``ppermute``; here each rank runs
its own stage; the ring shift is a ``torch.autograd.Function`` whose
backward shifts the other way, and the final sum is ``sharding.sum_over``,
which passes the gradient of the (replicated) output to the last stage's
term, so the result is differentiable.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.parallel.sharding import (axes_size, axis_coordinate,
                                          axis_group, sum_over)


def _shift(x: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    """Send ``x`` to the group rank ``send_to`` and return what
    ``recv_from`` sent, both posted at once (no ordering deadlock)."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, send_to), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, recv_from), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Stage i's output to stage i + 1 (mod P); backward, the gradient
    from stage i + 1 back to stage i."""

    @staticmethod
    def forward(ctx, y, group, stage, n):
        ctx.group, ctx.stage, ctx.n = group, stage, n
        return _shift(y, group, (stage + 1) % n, (stage - 1) % n)

    @staticmethod
    def backward(ctx, g):
        return (_shift(g, ctx.group, (ctx.stage - 1) % ctx.n,
                       (ctx.stage + 1) % ctx.n), None, None, None)


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches, mesh,
                   axis: str = "pipe"):
    """Run ``stage_fn(params_p, x)`` over the P pipeline stages of ``axis``.

    stage_params: this rank's stage, a pytree of tensors with a leading
                  dim of 1 — its slice of JAX's (P, ...)
                  leaves sharded over ``axis``.
    x_microbatches: (M, B, ...) microbatches, the same on every rank.
    Returns the final stage's (M, B, ...) outputs on every rank."""
    n_stages = axes_size(mesh, axis)
    stage = axis_coordinate(mesh, axis)
    group = axis_group(mesh, axis)
    params = tree_map(lambda p: p[0], stage_params)
    xs = x_microbatches
    M = xs.shape[0]
    first = torch.tensor(stage == 0, device=xs.device)
    last = torch.tensor(stage == n_stages - 1, device=xs.device)
    buf = torch.zeros_like(xs[0])
    outs = []
    for t in range(M + n_stages - 1):
        # stage 0 ingests microbatch t (zeros once none remain); the other
        # stages keep what the ring brought them — a where over both, as
        # JAX's, so every tick's shift is in every rank's graph
        mb = xs[t] if t < M else torch.zeros_like(xs[0])
        buf = torch.where(first, mb, buf)
        y = stage_fn(params, buf)
        if t >= n_stages - 1:  # the last stage emits microbatch t - (P - 1)
            outs.append(y)
        if t < M + n_stages - 2:  # the last tick's shift feeds nothing
            buf = _RingShift.apply(y, group, stage, n_stages)
    out = torch.stack(outs)
    # only the LAST stage's outputs are meaningful: sum them to every rank
    return sum_over(torch.where(last, out, torch.zeros_like(out)), group)

"""AdamW with float32 or int8-quantized moments — ``repro.optim.adamw``.

Parameters, gradients and moments are lists of tensors in one order (a
``Model``'s ``parameters()`` order); the state is {"m": [...], "v": [...],
"step": 0-dim int32 tensor}, each moment a float32 tensor or, with
``state_dtype="int8"``, {"q": int8, "qscale": float32 rowwise}
(``optim.quantized_state``).  Where JAX returns new arrays, this module
updates IN PLACE under ``torch.no_grad()`` — parameters, moments (an int8
moment's ``q`` and ``qscale``) and, when clipping, the gradients — so a
step holds no second copy of any of them.

Sharded (``apply_updates(..., specs=)`` under a mesh): every leaf is the
rank's shard of a parameter laid out by its spec
(``parallel.sharding.param_specs``).  The update is elementwise, so it
runs on the shards as they are; the two whole-tensor reductions go over
the mesh: the clipping norm counts each element once (a leaf replicated
over 'model' is held by every 'model' rank and is counted once, not once
per rank), and an int8 moment's row maximum is taken over the ranks that
split its last axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.optim.quantized_state import dequantize, is_quantized, quantize


@dataclass(frozen=True)
class AdamWCfg:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    state_dtype: str = "float32"  # "float32" | "int8"


def _leaves(params):
    return list(params.parameters()) if isinstance(params, torch.nn.Module) \
        else list(params)


def _zeros_like_state(p: torch.Tensor, cfg: AdamWCfg):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return quantize(z) if cfg.state_dtype == "int8" else z


def init_opt_state(params, cfg: AdamWCfg):
    """Zero moments for a ``Model`` or a list of tensors: float32, or
    quantized zeros with ``state_dtype="int8"``."""
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None
    return {
        "m": [_zeros_like_state(p, cfg) for p in leaves],
        "v": [_zeros_like_state(p, cfg) for p in leaves],
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tensors, replicas=None, group=None):
    """sqrt of the sum of squares of every element of ``tensors``.  Over
    shards: ``replicas`` gives each tensor's number of ranks that hold the
    same shard and ``group`` the ranks of the mesh; each shard's sum is
    divided by its replicas and the total summed over the group, so each
    element of the whole tensors counts once."""
    if group is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tensors))
    import torch.distributed as dist

    total = sum(torch.sum(torch.square(x.float())) / r
                for x, r in zip(tensors, replicas))
    dist.all_reduce(total, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm, replicas=None, group=None):
    """Scales ``grads`` IN PLACE by min(1, max_norm / (norm + 1e-9)) and
    returns (grads, norm); ``replicas``/``group`` as ``global_norm``."""
    gn = global_norm(grads, replicas, group)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in grads:
        g.copy_(g.float() * scale)
    return grads, gn


def _shard_reductions(specs, mesh):
    """(replicas per leaf, the mesh's group, the row group per leaf) for
    leaves laid out by ``specs`` on ``mesh``; no groups on a mesh of one
    rank, where every reduction is the rank's own."""
    from repro_torch.parallel.sharding import axes_size, axis_group, axis_names

    world = axes_size(mesh, axis_names(mesh))
    if world == 1:
        return None, None, [None] * len(specs)
    replicas, rows = [], []
    for spec in specs:
        held = 1
        for entry in spec:
            held *= axes_size(mesh, entry)
        replicas.append(world // held)
        last = spec[-1] if spec else None
        rows.append(axis_group(mesh, last) if axes_size(mesh, last) > 1
                    else None)
    return replicas, axis_group(mesh, axis_names(mesh)), rows


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWCfg, lr, *, specs=None,
                  mesh=None):
    """One AdamW step, IN PLACE on ``params`` (a ``Model`` or list of
    tensors), ``state`` and (when clipping) ``grads``.  ``lr`` is a float
    or a 0-dim tensor.  An int8 moment is dequantized, updated in float32
    and requantized, as JAX does.  With ``specs`` (each leaf's spec, in
    order) and ``mesh``, the leaves are this rank's shards (module
    docstring).  Returns (params, state, metrics)."""
    metrics = {}
    leaves = _leaves(params)
    replicas, group, rows = (_shard_reductions(specs, mesh)
                             if specs is not None else
                             (None, None, [None] * len(leaves)))
    if cfg.grad_clip is not None:
        grads, gn = clip_by_global_norm(grads, cfg.grad_clip, replicas, group)
        metrics["grad_norm"] = gn
    step = state["step"] + 1
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    for p, g, m, v, row in zip(leaves, grads, state["m"], state["v"], rows):
        gf = g.float()
        mf = dequantize(m) if is_quantized(m) else m
        vf = dequantize(v) if is_quantized(v) else v
        mf.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        vf.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (u + cfg.weight_decay * pf))
        for moment, new in ((m, mf), (v, vf)):
            if is_quantized(moment):
                for k, t in quantize(new, row).items():
                    moment[k].copy_(t)
    state["step"] = step
    return params, state, metrics

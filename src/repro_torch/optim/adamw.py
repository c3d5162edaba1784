"""AdamW with float32 or int8-quantized moments — ``repro.optim.adamw``.

Parameters, gradients and moments are lists of tensors in one order (a
``Model``'s ``parameters()`` order); the state is {"m": [...], "v": [...],
"step": 0-dim int32 tensor}, each moment a float32 tensor or, with
``state_dtype="int8"``, {"q": int8, "qscale": float32 rowwise}
(``optim.quantized_state``).  Where JAX returns new arrays, this module
updates IN PLACE under ``torch.no_grad()`` — parameters, moments (an int8
moment's ``q`` and ``qscale``) and, when clipping, the gradients — so a
step holds no second copy of any of them.
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


def global_norm(tensors):
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """Scales ``grads`` IN PLACE by min(1, max_norm / (norm + 1e-9)) and
    returns (grads, norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in grads:
        g.copy_(g.float() * scale)
    return grads, gn


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWCfg, lr):
    """One AdamW step, IN PLACE on ``params`` (a ``Model`` or list of
    tensors), ``state`` and (when clipping) ``grads``.  ``lr`` is a float
    or a 0-dim tensor.  An int8 moment is dequantized, updated in float32
    and requantized, as JAX does.  Returns (params, state, metrics)."""
    metrics = {}
    if cfg.grad_clip is not None:
        grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
        metrics["grad_norm"] = gn
    step = state["step"] + 1
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    for p, g, m, v in zip(_leaves(params), grads, state["m"], state["v"]):
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
                for k, t in quantize(new).items():
                    moment[k].copy_(t)
    state["step"] = step
    return params, state, metrics

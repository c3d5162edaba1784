"""RMSNorm — the plain path of ``repro.models.layers.norms.rmsnorm``.

Scales stay float32 (the JAX package stores them so and never casts them);
statistics are taken in float32 and the result is cast back to x's dtype.
"""
from __future__ import annotations

import torch


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dtype)

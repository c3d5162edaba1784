"""RMSNorm — ``repro.models.layers.norms.rmsnorm``, with its plain path
and its kernel route.

Scales stay float32 (the JAX package stores them so and never casts them);
statistics are taken in float32 and the result is cast back to x's dtype.
``use_kernel=True`` goes through ``kernels.ops.rmsnorm`` (the hand-written
CUDA kernel for CUDA tensors, its plain version on the CPU).  The default
is False and no model path sets it, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6, *,
            use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        return kops.rmsnorm(x.contiguous(), params["scale"].float(), eps=eps)
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dtype)

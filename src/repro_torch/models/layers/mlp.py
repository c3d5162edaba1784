"""Dense FFN (optionally gated / SwiGLU) — ``repro.models.layers.mlp``.

Serving weights are stored in the activation dtype once at load, where JAX
casts at every use; the values are the same.  Training weights stay in the
parameter dtype and are cast here, at every use, as in JAX.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLPCfg

# jax.nn.gelu defaults to the tanh approximation; torch's to the exact form
_ACTS = {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
         "relu": F.relu}


def mlp_fwd(params, cfg: MLPCfg, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    act = _ACTS[cfg.act]
    up = x @ params["w_up"].to(dt)
    if cfg.gated:
        h = act(x @ params["w_gate"].to(dt)) * up
    else:
        h = act(up)
    return h @ params["w_down"].to(dt)

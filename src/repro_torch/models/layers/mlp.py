"""Dense FFN (optionally gated / SwiGLU) — ``repro.models.layers.mlp``.

Serving weights are stored in the activation dtype once at load, where JAX
casts at every use; the values are the same.  Training weights stay in the
parameter dtype and are cast here, at every use, as in JAX.

Under the train step's 'model' split (JAX's "act_ff": GSPMD splits the
hidden width over 'model') ``w_gate`` and ``w_up`` are column-parallel and
``w_down`` row-parallel: a rank runs its d_ff/N columns and the partial
outputs are summed over 'model' (``parallel.sharding.model_part``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLPCfg
from repro_torch.parallel.sharding import (copy_to_model, model_part,
                                           reduce_from_model)

# jax.nn.gelu defaults to the tanh approximation; torch's to the exact form
_ACTS = {"silu": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
         "relu": F.relu}


def mlp_fwd(params, cfg: MLPCfg, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    act = _ACTS[cfg.act]
    part = model_part(params["w_up"])
    if part is not None:
        x = copy_to_model(x, part)
    up = x @ params["w_up"].to(dt)
    if cfg.gated:
        h = act(x @ params["w_gate"].to(dt)) * up
    else:
        h = act(up)
    out = h @ params["w_down"].to(dt)
    return out if part is None else reduce_from_model(out, part)

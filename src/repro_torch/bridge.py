"""Numpy bridge between the JAX package's pytrees and this port's tensors.

The JAX package keeps parameters and the paged decode state as pytrees of
arrays; the tests turn those into numpy (``jax.tree.map(np.asarray, ...)``)
and hand them here, so this module never sees JAX.

- ``params_from_numpy`` builds the port's ``Model`` from the numpy pytree of
  ``repro.models.model.init_params``.  Stages keep the stacked leading layer
  axis (a ``repeats == 1`` stage, unstacked in JAX, gains a layer axis of
  1); matrices, biases and the embedding are cast to the activation dtype,
  norm scales stay float32.
- ``state_from_numpy`` / ``state_to_numpy`` convert the paged decode state
  ({"layers": [[{kp, vp, [ks, vs], ptab, kpos, slen}]]}) both ways, with
  the same layer-axis rule, leaf dtypes unchanged.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm


def _tensor(a, dtype=None, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch cannot take it directly
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Dict, cfg: ModelCfg, device) -> M.Model:
    """The port's ``Model`` from a numpy pytree of JAX parameters."""
    M.check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    stages = []
    for st, sp in zip(cfg.stages, tree["stages"]):
        blocks = sp if st.repeats > 1 else [
            {g: {k: np.asarray(v)[None] for k, v in leaves.items()}
             for g, leaves in bp.items()} for bp in sp]
        stages.append([tfm.Block({
            g: {k: _tensor(v, torch.float32 if g.endswith("norm") else dt,
                           device) for k, v in leaves.items()}
            for g, leaves in bp.items()}) for bp in blocks])
    return M.Model(_tensor(tree["embed"]["tok_embed"], dt, device), stages,
                   _tensor(tree["final_norm"]["scale"], torch.float32, device))


def state_from_numpy(tree: Dict, cfg: ModelCfg, device) -> Dict:
    """The port's paged decode state from a numpy JAX state pytree."""
    layers = []
    for st, ss in zip(cfg.stages, tree["layers"]):
        layers.append([{k: _tensor(np.asarray(v) if st.repeats > 1
                                   else np.asarray(v)[None], device=device)
                        for k, v in cache.items()} for cache in ss])
    return {"layers": layers}


def state_to_numpy(state: Dict, cfg: ModelCfg) -> Dict:
    """A numpy pytree laid out like the JAX state (bf16 leaves as float32)."""
    def arr(t: torch.Tensor, repeats: int):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        return a if repeats > 1 else a[0]

    return {"layers": [[{k: arr(v, st.repeats) for k, v in cache.items()}
                        for cache in ss]
                       for st, ss in zip(cfg.stages, state["layers"])]}

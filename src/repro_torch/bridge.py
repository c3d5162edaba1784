"""Numpy bridge between the JAX package's pytrees and this port's tensors.

The JAX package keeps parameters and the paged decode state as pytrees of
arrays; the tests turn those into numpy (``jax.tree.map(np.asarray, ...)``)
and hand them here, so this module never sees JAX.

- ``params_from_numpy`` builds the port's ``Model`` from the numpy pytree of
  ``repro.models.model.init_params``.  Stages keep the stacked leading layer
  axis (a ``repeats == 1`` stage, unstacked in JAX, gains a layer axis of
  1); in the serving layout matrices, biases and the embedding are cast to
  the activation dtype and norm scales, the xLSTM gates, Mamba's
  ``A_log``/``dt_b``/``ssm_D`` and the MoE router stay float32
  (``transformer.leaf_dtype``); in the training layout
  (``for_training=True``) every leaf is in the parameter dtype, with grads.
  Nested groups (the mLSTM's ``out_norm``, an MoE's ``ffn.dense``) stay
  nested.
  An untied config's ``head.out_head`` (d, V) is a matrix like the others,
  and so is a frontend's ``frontend.frontend_proj`` (d/2, d); the audio
  tree has no ``embed``, the vision tree has both.
- ``params_to_numpy`` / ``grads_to_numpy`` lay a ``Model``'s parameters,
  or a list of tensors in ``Model.parameters()`` order (gradients, AdamW
  moments), out like the JAX pytree, so tests compare leaf by leaf.
- ``state_from_numpy`` / ``state_to_numpy`` convert a decode state both
  ways, with the same layer-axis rule, leaf dtypes unchanged: the paged
  serving state ({"layers": [[{kp, vp, [ks, vs], ptab, kpos, slen} or,
  for a windowed layer, {k, v, kpos, slen}; for an mLSTM layer {C, n, m,
  conv}, for an sLSTM layer {sh, sc, sn, sm}, for a Mamba layer {h,
  conv}]]}) and the lock-step state
  ({"layers": [[{k, v, k_pos, pos} or a recurrent layer's]], "pos"}),
  whose top-level "pos" is a 0-d scalar on both sides.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm


def _map(tree: Dict, fn) -> Dict:
    """``fn`` over the leaves of a nested dict."""
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tensor(a, dtype=None, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch cannot take it directly
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Dict, cfg: ModelCfg, device,
                      for_training: bool = False) -> M.Model:
    """The port's ``Model`` from a numpy pytree of JAX parameters, in the
    serving layout or, with ``for_training``, the training layout."""
    M.check_supported(cfg)
    dt = getattr(torch, cfg.param_dtype if for_training else cfg.dtype)
    norm_dt = dt if for_training else torch.float32
    stages = []
    for st, sp in zip(cfg.stages, tree["stages"]):
        def leaf(a, stacked=st.repeats > 1):
            a = np.asarray(a)
            return _tensor(a if stacked else a[None], device=device)

        stages.append([tfm.Block({
            g: tfm.cast_leaves(_map(leaves, leaf), dt, for_training, (g,))
            for g, leaves in bp.items()}, for_training) for bp in sp])
    def top(group, leaf, dtype=dt):
        return (None if group not in tree
                else _tensor(tree[group][leaf], dtype, device))

    return M.Model(top("embed", "tok_embed"), stages,
                   top("final_norm", "scale", norm_dt), for_training,
                   top("head", "out_head"), top("frontend", "frontend_proj"))


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def grads_to_numpy(params: M.Model, tensors: Sequence[torch.Tensor],
                   cfg: ModelCfg) -> Dict:
    """``tensors`` (one per parameter, in ``params.parameters()`` order) as
    a numpy pytree laid out like JAX's parameters (bf16 as float32)."""
    names = [n for n, _ in params.named_parameters()]
    if len(names) != len(tensors):
        raise ValueError(f"{len(tensors)} tensors for {len(names)} parameters")
    out = {"stages": [[{} for _ in st.pattern] for st in cfg.stages]}
    for name, t in zip(names, tensors):
        path = name.split(".")
        if path[0] == "stages":
            s, i, groups, leaf = int(path[1]), int(path[2]), path[3:-1], path[-1]
            a = _numpy(t)
            node = out["stages"][s][i]
            for g in groups:  # nested groups: out_norm, an MoE's dense
                node = node.setdefault(g, {})
            node[leaf] = a if cfg.stages[s].repeats > 1 else a[0]
        else:
            out.setdefault(path[0], {})[path[1]] = _numpy(t)
    return out


def params_to_numpy(params: M.Model, cfg: ModelCfg) -> Dict:
    """The parameters as a numpy pytree laid out like JAX's."""
    return grads_to_numpy(params, list(params.parameters()), cfg)


def state_from_numpy(tree: Dict, cfg: ModelCfg, device) -> Dict:
    """The port's decode state (paged or lock-step) from a numpy JAX state
    pytree."""
    layers = []
    for st, ss in zip(cfg.stages, tree["layers"]):
        layers.append([{k: _tensor(np.asarray(v) if st.repeats > 1
                                   else np.asarray(v)[None], device=device)
                        for k, v in cache.items()} for cache in ss])
    out = {"layers": layers}
    if "pos" in tree:
        out["pos"] = _tensor(tree["pos"], device=device)
    return out


def state_to_numpy(state: Dict, cfg: ModelCfg) -> Dict:
    """A numpy pytree laid out like the JAX state (bf16 leaves as float32)."""
    out = {"layers": [[{k: _numpy(v) if st.repeats > 1
                        else np.asarray(_numpy(v)[0])
                        for k, v in cache.items()} for cache in ss]
                      for st, ss in zip(cfg.stages, state["layers"])]}
    if "pos" in state:
        out["pos"] = _numpy(state["pos"])
    return out

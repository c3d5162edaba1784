"""The training step: loss -> grads -> AdamW update — ``repro.train.train_step``.

The state is {"params": Model (training layout), "opt": {m, v, step}}; the
step updates it IN PLACE and returns it.  Gradients come from
``torch.autograd.grad`` over every parameter, which raises if one is not
reached.  The sharding specs of the JAX module (``train_state_specs``,
``batch_specs``) wait for the multi-GPU slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWCfg, apply_updates, init_opt_state


def init_train_state(generator: torch.Generator, cfg: ModelCfg,
                     opt_cfg: AdamWCfg, *, device=None):
    params = M.init_params(cfg, generator=generator, device=device,
                           for_training=True)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def make_train_step(cfg: ModelCfg, opt_cfg: AdamWCfg, lr_fn: Callable,
                    microbatches: int = 1):
    """-> train_step(state, batch) -> (state, metrics).  With
    ``microbatches > 1`` every key of the batch (tokens or audio
    features, labels, image features) splits along its leading axis and
    the gradients accumulate in the parameter dtype, as in JAX."""

    def train_step(state, batch):
        params = state["params"]
        leaves = list(params.parameters())
        if microbatches == 1:
            loss, mets = M.loss_fn(params, cfg, batch)
            grads = list(torch.autograd.grad(loss, leaves))
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            grads = [torch.zeros_like(p) for p in leaves]
            ls, ms = [], []
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, m = M.loss_fn(params, cfg, mb)
                for a, g in zip(grads, torch.autograd.grad(l, leaves)):
                    a.add_(g.to(a.dtype) / microbatches)
                ls.append(l.detach())
                ms.append(m)
            loss = torch.stack(ls).mean()
            mets = {k: torch.stack([m[k].detach().to(loss.device) for m in ms]).mean()
                    for k in ms[0]}

        lr = lr_fn(state["opt"]["step"])
        _, state["opt"], om = apply_updates(leaves, grads, state["opt"],
                                            opt_cfg, lr)
        metrics = {"loss": loss.detach(), "lr": lr,
                   **{k: v.detach() for k, v in mets.items()}, **om}
        return state, metrics

    return train_step

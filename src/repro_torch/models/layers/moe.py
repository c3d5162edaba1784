"""Mixture-of-Experts FFN — ``repro.models.layers.moe``.

Two forms, as in JAX:

- ``"dispatch"`` (the default): capacity-bounded dispatch and combine
  einsums.  Each batch row's S tokens share a capacity of
  ``C = max(k, ceil(S k cf / E))`` slots an expert; priority is token
  order (a cumulative sum over the flattened k slots), and a slot past the
  capacity lands in the overflow column C, which the dispatch tensor does
  not have — that is how a drop happens (JAX's ``one_hot`` of C gives a
  zero row).  One-hot tensors are comparisons against an ``arange``, so
  an out-of-range index needs no check and no host synchronisation.
- ``"ragged"``: dropless.  Eagerly, JAX's sort + ``ragged_dot``: the slots
  sorted by expert (a stable sort, as ``jnp.argsort``), the group sizes
  read on the host, and one product per expert's group.  Under CUDA stream
  capture no host read is allowed, so the step runs the dispatch form at
  capacity T (the tokens of the call): an expert receives at most one slot
  a token, so no slot can overflow and the result is the same function.
  A count without data (``core.op_cost.without_data``: ``meta`` or fake
  tensors) has no group sizes to read: it takes the balanced routing,
  T k / E slots an expert, the load the balance loss aims at.  The whole
  layer's products do not depend on the sizes; a rank's share of them
  under the 'model' split does.

The router runs in float32 (its weight stays float32 in the serving
layout: ``FLOAT32_LEAVES``); ``top_k`` breaks ties toward the lower expert
index, as ``jax.lax.top_k`` does (a stable descending sort, where
``torch.topk`` promises no order).  The expert products are plain batched
matrix products, as JAX's are.  ``lshard`` (sharding only) is dropped;
under a mesh the auxiliary losses are the global batch's (``_aux_losses``).

Under the train step's 'model' split (JAX's "expert" and "act_expert") a
rank's expert leaves are its E/N experts (``parallel.sharding
.model_part``).  Every rank routes every token with the replicated router,
so the ties, the slot order and the capacity are the whole layer's; it
then runs only its experts' products, in either form, and the combined
outputs are summed over 'model'.  The gates enter the split region beside
the tokens, so the router's gradient is the whole layer's on every rank.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoECfg
from repro_torch.core import op_cost
from repro_torch.models.layers.common import dense_init
from repro_torch.models.layers.mlp import mlp_fwd
from repro_torch.parallel.sharding import (batch_shards, batch_sum,
                                           copy_to_model, model_part,
                                           reduce_from_model)

# leaves JAX reads in float32 (never cast to the activation dtype)
FLOAT32_LEAVES = ("router",)


def init_moe(generator, d: int, cfg: MoECfg, layers: int, *,
             device=None) -> Dict:
    """Random MoE weights stacked over ``layers``: the router (d, E), the
    experts' gate and up (E, d, F) and down (E, F, d) projections, and the
    ``dense`` group of a dense residual (arctic's parallel FFN, llama4's
    shared expert).  Each leaf is a zero-argument callable that draws the
    float32 tensor, so that the caller casts each one as it is drawn: at
    full width one float32 expert tensor is 21.5 GB (llama4)."""
    E, Fd = cfg.num_experts, cfg.d_ff
    L = (layers,)

    def draw(shape, fan_in):
        return functools.partial(dense_init, generator, L + shape, fan_in,
                                 device=device)

    p = {"router": draw((d, E), d), "we_gate": draw((E, d, Fd), d),
         "we_up": draw((E, d, Fd), d), "we_down": draw((E, Fd, d), Fd)}
    if cfg.dense_residual is not None:
        m = cfg.dense_residual
        p["dense"] = {"w_up": draw((d, m.d_ff), d),
                      "w_down": draw((m.d_ff, d), m.d_ff)}
        if m.gated:
            p["dense"]["w_gate"] = draw((d, m.d_ff), d)
    return p


def _route(params, cfg: MoECfg, x):
    """Router in float32: (gates (B, S, k), idx (B, S, k), probs and
    logits (B, S, E))."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # JAX's top_k order: descending, ties toward the lower index
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :cfg.top_k]
    gates = torch.gather(probs, -1, idx)
    if cfg.top_k > 1:
        gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    return gates, idx, probs, logits


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _aux_losses(probs, idx, logits, num_experts: int) -> Dict:
    """Switch-style load-balance loss (top-1 assignment against the mean
    router probability) and the router z-loss.  Under a mesh whose batch
    axes split the batch, the means are the global batch's: the load and
    importance sums (and the z term's) are summed over the batch axes
    before the product (``sharding.batch_sum``, differentiable), since a
    mean over ranks of per-rank products is not the global loss."""
    top1 = _one_hot(idx[..., 0], num_experts, torch.float32)
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    tokens = idx.shape[0] * idx.shape[1] * batch_shards()
    load = batch_sum(torch.sum(top1, dim=(0, 1))) / tokens
    importance = batch_sum(torch.sum(probs, dim=(0, 1))) / tokens
    z = batch_sum(torch.sum(lse2)) / tokens
    lb = num_experts * torch.sum(load * importance)
    return {"moe_lb_loss": lb, "moe_z_loss": z}


def moe_fwd(params, cfg: MoECfg, x) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, D) -> (y (B, S, D), {"moe_lb_loss", "moe_z_loss"})."""
    if cfg.impl == "ragged":
        return _moe_fwd_ragged(params, cfg, x)
    return _moe_fwd_dispatch(params, cfg, x)


def capacity(cfg: MoECfg, S: int) -> int:
    """JAX's per-row capacity, the same Python arithmetic."""
    k = cfg.top_k
    return max(k, int(-(-S * k * cfg.capacity_factor // cfg.num_experts)))


def _experts(params, xin, dt):
    """The gated expert FFN on xin (B, E, C, D) -> (B, E, C, D)."""
    g = torch.einsum("becd,edf->becf", xin, params["we_gate"].to(dt))
    u = torch.einsum("becd,edf->becf", xin, params["we_up"].to(dt))
    return torch.einsum("becf,efd->becd", F.silu(g) * u,
                        params["we_down"].to(dt))


def slot_positions(idx, num_experts: int):
    """Each routing slot's place in its expert's queue, in token order:
    idx (B, S, k) -> (onehot (B, S*k, E) int32, pos (B, S*k, E): the
    position where routed, -1 elsewhere).  A slot at pos >= C is dropped."""
    B, S, k = idx.shape
    onehot = _one_hot(idx.reshape(B, S * k), num_experts, torch.int32)
    return onehot, torch.cumsum(onehot, dim=1) * onehot - 1


def _experts_of(params, part):
    """The experts this rank runs: all of them, or its E/N under the
    'model' split."""
    n = params["we_gate"].shape[0]
    lo = 0 if part is None else part.coord * n
    return slice(lo, lo + n)


def _dispatch(params, cfg: MoECfg, x, gates, idx, C: int, part=None):
    """The dispatch/combine form at capacity ``C`` an expert and batch
    row: (B, S, D); under the 'model' split the rank's experts' share."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    dt = x.dtype
    onehot, pos = slot_positions(idx, E)
    keep = (pos >= 0) & (pos < C)
    pos = torch.where(keep, pos, C)  # the overflow column: a zero row
    mine = _experts_of(params, part)
    onehot, pos = onehot[..., mine], pos[..., mine]
    E = onehot.shape[-1]
    disp = _one_hot(pos, C, dt) * onehot.to(dt)[..., None]  # (B, S*k, E, C)
    disp = disp.reshape(B, S, k, E, C)
    dispatch = torch.sum(disp, dim=2)  # (B, S, E, C)
    combine = torch.sum(disp * gates.to(dt)[..., None, None], dim=2)
    xin = torch.einsum("bsec,bsd->becd", dispatch, x)
    eo = _experts(params, xin, dt)
    return torch.einsum("becd,bsec->bsd", eo, combine)


def _residual(params, cfg: MoECfg, x, y, part=None):
    """y, the experts' output (a rank's partial sum under the 'model'
    split: summed here), plus the dense residual's."""
    if part is not None:
        y = reduce_from_model(y, part)
    if cfg.dense_residual is not None:
        y = y + mlp_fwd(params["dense"], cfg.dense_residual, x)
    return y


def _split_inputs(params, x, gates):
    """(the expert leaves' ``ModelPart`` or None, x, gates), the two
    entering the split region where there is one."""
    part = model_part(params["we_gate"])
    if part is None:
        return None, x, gates
    return part, copy_to_model(x, part), copy_to_model(gates, part)


def _moe_fwd_dispatch(params, cfg: MoECfg, x) -> Tuple[torch.Tensor, Dict]:
    gates, idx, probs, logits = _route(params, cfg, x)
    aux = _aux_losses(probs, idx, logits, cfg.num_experts)
    part, xe, ge = _split_inputs(params, x, gates)
    y = _dispatch(params, cfg, xe, ge, idx, capacity(cfg, x.shape[1]), part)
    return _residual(params, cfg, x, y, part), aux


def _capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _moe_fwd_ragged(params, cfg: MoECfg, x) -> Tuple[torch.Tensor, Dict]:
    """Dropless MoE: no capacity, no drops."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    dt = x.dtype
    gates, idx, probs, logits = _route(params, cfg, x)
    aux = _aux_losses(probs, idx, logits, E)
    part, xe, ge = _split_inputs(params, x, gates)
    T = B * S
    if _capturing():
        # one row of T tokens: an expert gets at most T slots, none drops
        y = _dispatch(params, cfg, xe.reshape(1, T, D), ge.reshape(1, T, k),
                      idx.reshape(1, T, k), T, part).reshape(B, S, D)
        return _residual(params, cfg, x, y, part), aux
    xt = xe.reshape(T, D)
    flat_idx = idx.reshape(T * k)
    flat_gate = ge.reshape(T * k).to(dt)
    order = torch.argsort(flat_idx, stable=True)
    inv = torch.argsort(order, stable=True)
    xs = xt[order // k]  # (T*k, D): each sorted slot's source token
    if op_cost.without_data(flat_idx):  # a count: the balanced routing
        q, r = divmod(T * k, E)
        sizes = [q + (e < r) for e in range(E)]
    else:
        sizes = torch.bincount(flat_idx, minlength=E).tolist()  # host read
    mine = _experts_of(params, part)
    outs, start = [], 0
    for e, n in enumerate(sizes):
        if n and mine.start <= e < mine.stop:
            rows = xs[start:start + n]
            j = e - mine.start
            h = (F.silu(rows @ params["we_gate"][j].to(dt))
                 * (rows @ params["we_up"][j].to(dt)))
            outs.append(h @ params["we_down"][j].to(dt))
        elif n:  # another rank's expert: its slots add 0 here
            outs.append(xs.new_zeros((n, D)))
        start += n
    eo = torch.cat(outs) if outs else xs.new_zeros((0, D))
    eo = eo[inv] * flat_gate[:, None]  # back to slot order
    y = torch.sum(eo.reshape(T, k, D), dim=1).reshape(B, S, D)
    return _residual(params, cfg, x, y, part), aux

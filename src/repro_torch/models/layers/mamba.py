"""Mamba-1 selective SSM mixer (jamba's sequence mixer) —
``repro.models.layers.mamba``.

The same arithmetic as the JAX package, step for step: the training
forward runs the recurrence sequentially (the data-dependent decay has no
cheap parallel form for Mamba-1), building the (B, d_in, d_state)
discretized operands per step and never the (B, S, d_in, d_state) tensor;
the state h is float32 and each step upcasts its inputs, which stay in the
activation dtype between steps.  JAX's nested scan (chunks of 64 steps,
each chunk checkpointed) becomes a loop over chunks, each under
``torch.utils.checkpoint`` when gradients are on, so the backward pass
keeps one state a chunk, not one a step.  Both loops run through
``core.op_cost.time_loop``: on tensors without data (a count of the card's
program) one middle chunk and one middle step stand for the others.
Serving and the lock-step decode run ``mamba_decode``, the single-step
cell.  ``lshard`` is dropped.

Parameters keep JAX's leaf names (``in_proj, conv_w, conv_b, x_proj,
dt_w, dt_b, A_log, ssm_D, out_proj``); the ones JAX uses in float32
whatever the activation dtype (``FLOAT32_LEAVES``) stay float32 in the
serving layout.  State dicts hold one layer; ``init_mamba_state`` stacks
``layers`` of them.

Under the train step's 'model' split (JAX's "tensor" entries of these
leaves) a rank holds d_in/N inner channels (``parallel.sharding
.model_part`` of ``ssm_D``): its columns of each half of ``in_proj`` (the
train step cuts them from the whole leaf), its channels of the conv, the
step sizes, the decay and the skip, and its rows of ``x_proj`` and
``out_proj``.  The channels run through the conv and the scan on their
own; ``x_proj`` contracts over them, so dt's low-rank input, B and C are
summed over 'model' and re-enter the split region; ``out_proj``'s partial
outputs are summed over 'model'.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import MambaCfg
from repro_torch.core import op_cost
from repro_torch.models.layers.common import dense_init
from repro_torch.models.layers.conv import causal_depthwise_conv, conv_step
from repro_torch.parallel.sharding import (copy_to_model, model_part,
                                           reduce_from_model)

# leaves JAX reads in float32: the decay, the step's bias, and the skip
# (float32 in the decode step)
FLOAT32_LEAVES = ("A_log", "dt_b", "ssm_D")


def _dims(d: int, cfg: MambaCfg):
    d_in = cfg.expand * d
    dt_rank = cfg.dt_rank or -(-d // 16)
    return d_in, dt_rank


def init_mamba(generator, d: int, cfg: MambaCfg, layers: int, *,
               device=None) -> Dict:
    """Random Mamba weights stacked over ``layers``, JAX's scheme: fan-in
    truncated normals, a zero conv bias, the step bias at -4.6
    (softplus^-1(0.01)), ``A_log = log(1..d_state)`` per channel and a unit
    skip.  Each leaf is a zero-argument callable drawing the float32 tensor
    (the caller casts each one as it is drawn, as ``moe.init_moe``'s)."""
    d_in, dt_rank = _dims(d, cfg)
    L = (layers,)
    f32 = dict(dtype=torch.float32, device=device)

    def draw(shape, fan_in):
        return functools.partial(dense_init, generator, L + shape, fan_in,
                                 device=device)

    def full(shape, value):
        return functools.partial(torch.full, L + shape, value, **f32)

    def a_log():
        n = torch.arange(1, cfg.d_state + 1, **f32)
        return torch.log(n).expand(L + (d_in, cfg.d_state)).clone()

    return {
        "in_proj": draw((d, 2 * d_in), d),
        "conv_w": draw((cfg.d_conv, d_in), cfg.d_conv),
        "conv_b": full((d_in,), 0.0),
        "x_proj": draw((d_in, dt_rank + 2 * cfg.d_state), d_in),
        "dt_w": draw((dt_rank, d_in), dt_rank),
        "dt_b": full((d_in,), -4.6),
        "A_log": a_log,
        "ssm_D": full((d_in,), 1.0),
        "out_proj": draw((d_in, d), d_in),
    }


def _preprocess(params, cfg: MambaCfg, x):
    """The input projection: (x_in, z), each (B, S, d_in) (d_in/N under
    the 'model' split: the working copy holds the rank's columns of each
    half)."""
    xz = x @ params["in_proj"].to(x.dtype)
    return torch.chunk(xz, 2, dim=-1)


def _ssm_inputs(params, cfg: MambaCfg, x_c, dt_rank: int, part=None):
    """The step sizes dt (float32, softplus) and the input and output
    matrices B, C (float32) of the conv'd input x_c (B, S, d_in); under
    the 'model' split x_proj's partial products are summed first."""
    dt_ = x_c.dtype
    proj = x_c @ params["x_proj"].to(dt_)
    if part is not None:
        proj = copy_to_model(reduce_from_model(proj, part), part)
    dt_low = proj[..., :dt_rank]
    Bmat = proj[..., dt_rank:dt_rank + cfg.d_state]
    Cmat = proj[..., dt_rank + cfg.d_state:]
    dt_full = dt_low @ params["dt_w"].to(dt_)
    dt = F.softplus(dt_full.float() + params["dt_b"].float())
    return dt, Bmat.float(), Cmat.float()


def _scan(h, A, x_c, dt, Bm, Cm, out_dtype):
    """The recurrence over the steps of one chunk: h (B, d_in, N) float32;
    x_c, dt (B, L, d_in), Bm, Cm (B, L, N) in the activation dtype,
    upcast per step.  Returns (h, y (B, L, d_in) in ``out_dtype``)."""

    def step(t, h):
        x_t, dt_t = x_c[:, t].float(), dt[:, t].float()
        B_t, C_t = Bm[:, t].float(), Cm[:, t].float()
        dA = torch.exp(dt_t[:, :, None] * A[None])  # (B, d_in, N)
        dBx = (dt_t * x_t)[:, :, None] * B_t[:, None, :]
        h = dA * h + dBx
        return h, torch.einsum("ben,bn->be", h, C_t).to(out_dtype)

    h, ys = op_cost.time_loop(x_c.shape[1], step, h, x_c)
    return h, torch.stack(ys, dim=1)


def mamba_fwd(params, cfg: MambaCfg, x, chunk: int = 64):
    """The training forward: x (B, S, D) -> (B, S, D).  Chunks of
    ``chunk`` steps (one chunk of S when S is no multiple), each chunk
    checkpointed while gradients are on."""
    B, S, D = x.shape
    dt_ = x.dtype
    _, dt_rank = _dims(D, cfg)
    part = model_part(params["ssm_D"])
    if part is not None:
        x = copy_to_model(x, part)
    x_in, z = _preprocess(params, cfg, x)
    d_in = x_in.shape[-1]
    x_c = F.silu(causal_depthwise_conv(x_in, params["conv_w"], params["conv_b"]))
    dt, Bmat, Cmat = _ssm_inputs(params, cfg, x_c, dt_rank, part)
    A = -torch.exp(params["A_log"].float())  # (d_in, N)
    # the scan's inputs in the activation dtype, as JAX keeps them
    dt, Bmat, Cmat = dt.to(dt_), Bmat.to(dt_), Cmat.to(dt_)
    L = min(chunk, S)
    if S % L:
        L = S
    h = torch.zeros((B, d_in, cfg.d_state), dtype=torch.float32,
                    device=x.device)
    scan = functools.partial(_scan, out_dtype=dt_)

    def chunk_step(i, h):
        c = i * L
        xs = (x_c[:, c:c + L], dt[:, c:c + L], Bmat[:, c:c + L],
              Cmat[:, c:c + L])
        if torch.is_grad_enabled():
            return ckpt.checkpoint(scan, h, A, *xs, use_reentrant=False)
        return scan(h, A, *xs)

    h, ys = op_cost.time_loop(S // L, chunk_step, h, x_c)
    y = torch.cat(ys, dim=1)
    y = (y + (x_c * params["ssm_D"].to(dt_)).to(dt_)) * F.silu(z)
    out = y @ params["out_proj"].to(dt_)
    return out if part is None else reduce_from_model(out, part)


def init_mamba_state(cfg: MambaCfg, d: int, batch: int, dtype, *,
                     layers: int = 1, device=None) -> Dict:
    """Fresh Mamba state, stacked over ``layers``: h (B, d_in, d_state)
    float32 and the conv's last d_conv - 1 inputs in the activation dtype,
    all 0."""
    d_in, _ = _dims(d, cfg)
    lead = (layers, batch)
    return {"h": torch.zeros(lead + (d_in, cfg.d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (cfg.d_conv - 1, d_in), dtype=dtype,
                                device=device)}


def mamba_decode(params, cfg: MambaCfg, x_t, state):
    """One decode step: x_t (B, 1, D), ``state`` one layer's leaves ->
    (out (B, 1, D), the new state), functional.  The skip and the output
    stay float32 until the gate, as in JAX's decode step."""
    dt_ = x_t.dtype
    x_in, z = _preprocess(params, cfg, x_t)
    x_in, z = x_in[:, 0], z[:, 0]
    xc_t, conv_state = conv_step(x_in, state["conv"], params["conv_w"],
                                 params["conv_b"])
    xc_t = F.silu(xc_t)
    dt, Bmat, Cmat = _ssm_inputs(params, cfg, xc_t[:, None, :],
                                 _dims(x_t.shape[-1], cfg)[1])
    dt_t, B_t, C_t = dt[:, 0], Bmat[:, 0], Cmat[:, 0]
    A = -torch.exp(params["A_log"].float())
    xf = xc_t.float()
    dA = torch.exp(dt_t[:, :, None] * A[None])
    h = dA * state["h"] + (dt_t * xf)[:, :, None] * B_t[:, None, :]
    y = torch.einsum("ben,bn->be", h, C_t) + xf * params["ssm_D"].float()
    y = y.to(dt_) * F.silu(z)
    out = (y @ params["out_proj"].to(dt_))[:, None, :]
    return out, {"h": h, "conv": conv_state}

"""Blocks and stages of the ragged serving step.

Counterpart of the serving part of ``repro.models.transformer``.  A stage's
repeats keep JAX's stacked layout — every parameter and state leaf of a
pattern position carries a leading layer axis (``transformer.py:97-100`` of
the JAX package) — and the ``lax.scan`` over that axis becomes a Python
loop over per-layer views.  The views share storage with the stacked
tensors, so the in-place cache writes of each layer land in the stacked
state.

Only dense global-attention blocks with a dense FFN are in this slice;
mamba, xLSTM and MoE mixers raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from repro_torch.configs.base import BlockCfg, ModelCfg, Stage
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.common import dense_init
from repro_torch.models.layers.mlp import mlp_fwd
from repro_torch.models.layers.norms import rmsnorm

# per-slot pool leaves shared by every slot: survive slot resets
POOL_LEAVES = ("kp", "vp", "ks", "vs")


def check_block(blk: BlockCfg) -> None:
    """Raise for blocks outside the ported slice."""
    if blk.mixer != "attn":
        raise NotImplementedError(
            f"mixer {blk.mixer!r} is not ported yet: mamba/xLSTM mixers and "
            "cross-attention come with the hybrid-mixer slice")
    attn.check_attn(blk.attn)
    if blk.ffn == "moe":
        raise NotImplementedError(
            "MoE FFNs are not ported yet: they come with the hybrid-mixer slice")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One pattern position of a stage, its leaves stacked over the stage's
    repeats.  Parameter names follow the JAX pytree: ``mixer_norm.scale``,
    ``mixer.{wq,wk,wv,wo,bq,bk,bv}``, ``ffn_norm.scale``,
    ``ffn.{w_up,w_gate,w_down}``."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for group, leaves in tensors.items():
            setattr(self, group, nn.ParameterDict(
                {k: _param(v) for k, v in leaves.items()}))


def init_block(generator, cfg: ModelCfg, blk: BlockCfg, repeats: int, *,
               dtype, device) -> Block:
    """Random block weights, stacked over ``repeats``: float32 truncated
    normals cast once to the activation ``dtype``; norm scales (ones) and
    zero biases as in JAX, the scales kept float32."""
    check_block(blk)
    d, a, m = cfg.d_model, blk.attn, blk.mlp
    kvH, hd = a.num_kv_heads, a.head_dim
    G = a.num_heads // kvH
    L = (repeats,)

    def dense(shape, fan_in=None):
        w = dense_init(generator, L + shape, fan_in or shape[0], device=device)
        return w.to(dtype)

    def zeros(shape):
        return torch.zeros(L + shape, dtype=dtype, device=device)

    mixer = {"wq": dense((d, kvH, G, hd)), "wk": dense((d, kvH, hd)),
             "wv": dense((d, kvH, hd)),
             "wo": dense((kvH, G, hd, d), kvH * G * hd)}
    if a.qkv_bias:
        mixer.update(bq=zeros((kvH, G, hd)), bk=zeros((kvH, hd)),
                     bv=zeros((kvH, hd)))
    ones = lambda: torch.ones(L + (d,), device=device)  # noqa: E731
    tensors = {"mixer_norm": {"scale": ones()}, "mixer": mixer}
    if blk.ffn == "mlp":
        ffn = {"w_up": dense((d, m.d_ff)),
               "w_down": dense((m.d_ff, d), m.d_ff)}
        if m.gated:
            ffn["w_gate"] = dense((d, m.d_ff))
        tensors.update(ffn_norm={"scale": ones()}, ffn=ffn)
    return Block(tensors)


def layer_view(tree, r: int):
    """Layer ``r`` of a stacked block: {group: {leaf: tensor[r]}} for a
    ``Block``, {leaf: tensor[r]} for a state dict.  Views, not copies."""
    if isinstance(tree, nn.Module):
        return {name: {k: v[r] for k, v in group.items()}
                for name, group in tree.named_children()}
    return {k: v[r] for k, v in tree.items()}


def init_stage_state_paged(cfg: ModelCfg, stage: Stage, batch: int,
                           cache_len: int, dtype, *, page_size: int,
                           n_pages: int, kv_dtype=None, device=None):
    """One paged cache per pattern position, stacked over the repeats."""
    out = []
    for blk in stage.pattern:
        check_block(blk)
        out.append(attn.init_paged_cache(
            blk.attn, batch, cache_len, dtype, page_size=page_size,
            n_pages=n_pages, kv_dtype=kv_dtype, layers=stage.repeats,
            device=device))
    return out


def block_step_ragged(params, cfg: ModelCfg, blk: BlockCfg, x, state, slot,
                      q_pos, seq_idx, valid, *, width: int,
                      flash_decode: bool = False):
    """One layer of the ragged step; ``params``/``state`` are one layer's
    views.  ``seq_idx``/``width`` feed the recurrent repack of hybrid
    mixers, which this slice does not have; they stay for the signature."""
    check_block(blk)
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    m, state = attn.ragged_attention_step(params["mixer"], blk.attn, h, state,
                                          slot, q_pos, valid,
                                          flash_decode=flash_decode)
    x = x + m
    if blk.ffn is not None:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        x = x + mlp_fwd(params["ffn"], blk.mlp, h)
    return x, state


def stage_step_ragged(params, cfg: ModelCfg, stage: Stage, x, states, slot,
                      q_pos, seq_idx, valid, *, width: int,
                      flash_decode: bool = False):
    """The layer loop that replaces JAX's scan: repeat r runs every pattern
    position on layer r's views of the stacked params and state."""
    for r in range(stage.repeats):
        for i, blk in enumerate(stage.pattern):
            x, _ = block_step_ragged(layer_view(params[i], r), cfg, blk, x,
                                     layer_view(states[i], r), slot, q_pos,
                                     seq_idx, valid, width=width,
                                     flash_decode=flash_decode)
    return x, states


def reset_stage_slots(stage: Stage, states: List[dict], init_states,
                      mask, ptab_rows, prefix_len):
    """Admission, in place: for slots where ``mask`` is set, install
    ``ptab_rows`` into the block tables, make the first ``prefix_len``
    positions live in ``kpos`` (the inherited prefix) and start ``slen`` at
    ``prefix_len``; other per-slot leaves come from the fresh-init template
    ``init_states``.  Pool leaves (values and int8 scales) are shared by all
    slots and left alone.  mask: (B,) bool; ptab_rows: (B, pps);
    prefix_len: (B,)."""
    for s_blk, i_blk in zip(states, init_states):
        for name, leaf in s_blk.items():
            if name in POOL_LEAVES:
                continue
            # leaves are (layers, B, ...): broadcast the slot mask
            m = mask.reshape((1, -1) + (1,) * (leaf.ndim - 2))
            if name == "kpos":
                iota = torch.arange(leaf.shape[-1], dtype=leaf.dtype,
                                    device=leaf.device)[None, :]
                src = torch.where(iota < prefix_len[:, None], iota, -1)
            elif name == "slen":
                src = prefix_len.to(leaf.dtype)
            elif name == "ptab":
                src = ptab_rows.to(leaf.dtype)
            else:
                src = i_blk[name]
            leaf.copy_(torch.where(m, src, leaf))
    return states

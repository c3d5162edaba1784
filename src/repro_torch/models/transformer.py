"""Blocks and stages: the training forward, the two serving steps (ragged
pack and two-phase) and the lock-step decode.

Counterpart of ``repro.models.transformer``.  A stage's repeats keep JAX's
stacked layout — every parameter and state leaf of a pattern position
carries a leading layer axis (``transformer.py:97-100`` of the JAX package)
— and the ``lax.scan`` over that axis becomes a Python loop over per-layer
views.  The views share storage with the stacked tensors, so the in-place
cache writes of each layer land in the stacked state, and the gradients of
the training forward land in the stacked parameters.

Attention blocks (global or windowed) with a dense FFN are ported; mamba,
xLSTM and MoE mixers raise ``NotImplementedError``.  A stage's layer loop
runs repeat r over every pattern position before repeat r + 1, JAX's scan
order.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import BlockCfg, ModelCfg, Stage
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.common import dense_init
from repro_torch.models.layers.mlp import mlp_fwd
from repro_torch.models.layers.norms import rmsnorm

# per-slot pool leaves shared by every slot: survive slot resets
POOL_LEAVES = ("kp", "vp", "ks", "vs")

# MoE auxiliary losses; always zero in the ported slices (no MoE FFN yet)
ZERO_AUX = {"moe_lb_loss": torch.zeros(()), "moe_z_loss": torch.zeros(())}


def _add_aux(a, b):
    return {k: a[k] + b[k] for k in a}


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


class Block(nn.Module):
    """One pattern position of a stage, its leaves stacked over the stage's
    repeats.  Parameter names follow the JAX pytree: ``mixer_norm.scale``,
    ``mixer.{wq,wk,wv,wo,bq,bk,bv}``, ``ffn_norm.scale``,
    ``ffn.{w_up,w_gate,w_down}``.  ``trainable`` sets ``requires_grad``."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]],
                 trainable: bool = False):
        super().__init__()
        for group, leaves in tensors.items():
            setattr(self, group, nn.ParameterDict(
                {k: nn.Parameter(v, requires_grad=trainable)
                 for k, v in leaves.items()}))


def init_block(generator, cfg: ModelCfg, blk: BlockCfg, repeats: int, *,
               dtype, device, trainable: bool = False) -> Block:
    """Random block weights, stacked over ``repeats``: float32 truncated
    normals cast once to ``dtype``; norm scales (ones) and zero biases as in
    JAX.  Serving (``dtype`` the activation dtype) keeps the scales float32;
    ``trainable`` (``dtype`` the parameter dtype) stores every leaf in
    ``dtype``, with gradients."""
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
    scale_dt = dtype if trainable else torch.float32
    ones = lambda: torch.ones(L + (d,), dtype=scale_dt, device=device)  # noqa: E731
    tensors = {"mixer_norm": {"scale": ones()}, "mixer": mixer}
    if blk.ffn == "mlp":
        ffn = {"w_up": dense((d, m.d_ff)),
               "w_down": dense((m.d_ff, d), m.d_ff)}
        if m.gated:
            ffn["w_gate"] = dense((d, m.d_ff))
        tensors.update(ffn_norm={"scale": ones()}, ffn=ffn)
    return Block(tensors, trainable)


def layer_view(tree, r: int):
    """Layer ``r`` of a stacked block: {group: {leaf: tensor[r]}} for a
    ``Block``, {leaf: tensor[r]} for a state dict.  Views, not copies."""
    if isinstance(tree, nn.Module):
        return {name: {k: v[r] for k, v in group.items()}
                for name, group in tree.named_children()}
    return {k: v[r] for k, v in tree.items()}


def _layers(block: Block, repeats: int) -> List[Dict]:
    """Per-layer views of a stacked block for the training forward:
    ``unbind`` makes one autograd node per leaf, whose backward stacks the
    layers' gradients once (indexing would zero-fill a full-size gradient
    per layer)."""
    views = [{} for _ in range(repeats)]
    for name, group in block.named_children():
        cols = {k: v.unbind(0) for k, v in group.items()}
        for r in range(repeats):
            views[r][name] = {k: c[r] for k, c in cols.items()}
    return views


# ---------------------------------------------------------------------------
# Training forward


def block_fwd(params, cfg: ModelCfg, blk: BlockCfg, x, *, positions=None,
              enc=None):
    """One layer (``params`` its views); returns (x, aux), aux always of
    ``ZERO_AUX``'s structure."""
    check_block(blk)
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    x = x + attn.attention_fwd(params["mixer"], blk.attn, h,
                               positions=positions, enc=enc,
                               q_chunk=cfg.attn_q_chunk,
                               use_flash=cfg.use_flash)
    if blk.ffn is not None:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        x = x + mlp_fwd(params["ffn"], blk.mlp, h)
    return x, dict(ZERO_AUX)


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"`` (JAX's
    ``checkpoint_dots``): keep matmul outputs, recompute the rest."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``jax.checkpoint`` as ``torch.utils.checkpoint``: "none" is the
    identity, "full" saves nothing inside ``fn`` (its inputs only) and
    recomputes it in the backward pass, "dots" saves matmul outputs."""
    if mode == "none":
        return fn
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def stage_fwd(params, cfg: ModelCfg, stage: Stage, x, *, positions=None,
              enc=None):
    """The training forward of a stage: remat'd groups of the pattern's
    blocks, each block remat'd again inside (JAX's nested remat: the
    backward pass recomputes each block once), over the stacked layers.
    JAX's ``_barrier`` serializes FSDP parameter gathers; on one device it
    is the identity and has no counterpart here, nor has the ``lshard`` of
    the saved boundaries (``seq_shard_residuals``), a no-op without a
    mesh."""

    def one_block(block_params, y, blk):
        return block_fwd(block_params, cfg, blk, y, positions=positions,
                         enc=enc)

    def group(y, group_params):
        aux = dict(ZERO_AUX)
        for i, blk in enumerate(stage.pattern):
            blk_fn = _remat(functools.partial(one_block, blk=blk), cfg.remat)
            y, a = blk_fn(group_params[i], y)
            aux = _add_aux(aux, a)
        return y, aux

    group = _remat(group, cfg.remat)
    views = [_layers(b, stage.repeats) for b in params]
    aux = dict(ZERO_AUX)
    for r in range(stage.repeats):
        x, a = group(x, [v[r] for v in views])
        aux = _add_aux(aux, a)
    return x, aux


# ---------------------------------------------------------------------------
# Serving steps


def init_stage_state_paged(cfg: ModelCfg, stage: Stage, batch: int,
                           cache_len: int, dtype, *, page_size: int,
                           n_pages: int, window_extra: int = 0,
                           kv_dtype=None, device=None):
    """One serving cache per pattern position (paged for global layers,
    per-slot circular buffers ``window_extra`` entries past the window for
    windowed ones), stacked over the repeats."""
    out = []
    for blk in stage.pattern:
        check_block(blk)
        out.append(attn.init_paged_cache(
            blk.attn, batch, cache_len, dtype, page_size=page_size,
            n_pages=n_pages, window_extra=window_extra, kv_dtype=kv_dtype,
            layers=stage.repeats, device=device))
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


def block_step_paged(params, cfg: ModelCfg, blk: BlockCfg, x, state, q_pos,
                     valid, *, flash_decode: bool = False):
    """One layer of the two-phase step (x: (B, C, D); ``params``/``state``
    one layer's views).  Attention mixers with a dense FFN only: the
    recurrent rolls of JAX's hybrid mixers raise in ``check_block``."""
    check_block(blk)
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    m, state = attn.paged_attention_step(params["mixer"], blk.attn, h, state,
                                         q_pos, valid,
                                         flash_decode=flash_decode)
    x = x + m
    if blk.ffn is not None:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        x = x + mlp_fwd(params["ffn"], blk.mlp, h)
    return x, state


def stage_step_paged(params, cfg: ModelCfg, stage: Stage, x, states, q_pos,
                     valid, *, flash_decode: bool = False):
    """The two-phase step's layer loop, as ``stage_step_ragged``'s."""
    for r in range(stage.repeats):
        for i, blk in enumerate(stage.pattern):
            x, _ = block_step_paged(layer_view(params[i], r), cfg, blk, x,
                                    layer_view(states[i], r), q_pos, valid,
                                    flash_decode=flash_decode)
    return x, states


def reset_stage_slots(stage: Stage, states: List[dict], init_states,
                      mask, ptab_rows, prefix_len):
    """Admission, in place: for slots where ``mask`` is set, install
    ``ptab_rows`` into the block tables, make the first ``prefix_len``
    positions live in ``kpos`` (the inherited prefix; a windowed layer's
    buffer index is not its position, but it never inherits one) and start
    ``slen`` at ``prefix_len``; the other per-slot leaves, a windowed
    layer's k/v buffers, are filled in place with their fresh-init value,
    which ``init_states`` holds as a number (0; JAX restores them from a
    copy of the fresh state, which is the same, without a full-size
    template).  Pool leaves (values and int8 scales) are shared by all
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
                leaf.masked_fill_(m, i_blk[name])
                continue
            leaf.copy_(torch.where(m, src, leaf))
    return states


def rollback_stage_slots(stage: Stage, states: List[dict], mask, new_len):
    """Speculative rejection, in place (JAX ``rollback_stage_slots``): for
    masked slots, ``kpos`` entries holding a position >= ``new_len`` drop
    to -1 and ``slen`` clamps down to ``new_len``; pools, scale pools and
    block tables are left alone.  ``kpos`` stores absolute positions, so
    the rejected tail is exactly the entries at or past ``new_len``.
    Leaves are (layers, B, ...); mask, new_len: (B,)."""
    for s_blk in states:
        kpos, slen = s_blk["kpos"], s_blk["slen"]
        m = mask[None, :]
        nl = new_len.to(kpos.dtype)[None, :]
        kpos.copy_(torch.where(m[..., None] & (kpos >= nl[..., None]), -1, kpos))
        slen.copy_(torch.where(m, torch.minimum(slen, nl.to(slen.dtype)), slen))
    return states


# ---------------------------------------------------------------------------
# Lock-step decode (the reference engine)


def init_stage_state(cfg: ModelCfg, stage: Stage, batch: int, cache_len: int,
                     dtype, *, device=None):
    """One lock-step cache per pattern position (``attention.init_cache``),
    stacked over the repeats (JAX ``init_stage_state``)."""
    out = []
    for blk in stage.pattern:
        check_block(blk)
        out.append(attn.init_cache(blk.attn, batch, cache_len, dtype,
                                   layers=stage.repeats, device=device))
    return out


def block_decode(params, cfg: ModelCfg, blk: BlockCfg, x, state, *,
                 sp_decode: bool = False):
    """One layer of the lock-step decode (x: (B, 1, D); ``params``/``state``
    one layer's views; the cache is updated in place)."""
    check_block(blk)
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    m, state = attn.attention_decode(params["mixer"], blk.attn, h, state,
                                     sp_decode=sp_decode)
    x = x + m
    if blk.ffn is not None:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        x = x + mlp_fwd(params["ffn"], blk.mlp, h)
    return x, state


def stage_decode(params, cfg: ModelCfg, stage: Stage, x, states, *,
                 sp_decode: bool = False):
    """The lock-step decode's layer loop, as ``stage_step_ragged``'s."""
    for r in range(stage.repeats):
        for i, blk in enumerate(stage.pattern):
            x, _ = block_decode(layer_view(params[i], r), cfg, blk, x,
                                layer_view(states[i], r), sp_decode=sp_decode)
    return x, states

"""Blocks and stages: the training forward, the two serving steps (ragged
pack and two-phase) and the lock-step decode.

Counterpart of ``repro.models.transformer``.  A stage's repeats keep JAX's
stacked layout — every parameter and state leaf of a pattern position
carries a leading layer axis (``transformer.py:97-100`` of the JAX package)
— and the ``lax.scan`` over that axis becomes a Python loop over per-layer
views.  The views share storage with the stacked tensors, so the in-place
cache writes of each layer land in the stacked state, and the gradients of
the training forward land in the stacked parameters.

Attention blocks (global, windowed, bidirectional or cross-attention
over the vision stub's encoder states ``enc``) and the recurrent mixers
(mLSTM, sLSTM, Mamba), each with a dense FFN, an MoE FFN or none, are
ported.  A stage's layer loop runs
repeat r over every pattern position before repeat r + 1, JAX's scan order.
A recurrent mixer's serving and decode state is advanced functionally, one
step at a time, and written back into its layer's views once the step's
roll is done.  The training forward returns the MoE layers' auxiliary
losses summed over the layers, as JAX's ``_add_aux`` sums them; the
serving paths drop them, as JAX's do.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import BlockCfg, ModelCfg, Stage
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mamba, moe, xlstm
from repro_torch.models.layers.common import dense_init
from repro_torch.models.layers.mlp import mlp_fwd
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.parallel import sharding

# per-slot pool leaves shared by every slot: survive slot resets
POOL_LEAVES = ("kp", "vp", "ks", "vs")

# the fresh value of every per-slot leaf that an admission restores from
# the reset template: a windowed layer's buffers and the recurrent states
# (the sLSTM stabilizer starts at -1e30, everything else at 0)
FRESH_VALUES = {"k": 0.0, "v": 0.0, "C": 0.0, "n": 0.0, "m": 0.0,
                "conv": 0.0, "sh": 0.0, "sc": 0.0, "sn": 0.0, "sm": xlstm.NEG,
                "h": 0.0}

# the recurrent mixers: their training forward and single-step decode
RECURRENT_FWD = {"mlstm": xlstm.mlstm_fwd, "slstm": xlstm.slstm_fwd,
                 "mamba": mamba.mamba_fwd}
RECURRENT_DECODE = {"mlstm": xlstm.mlstm_decode, "slstm": xlstm.slstm_decode,
                    "mamba": mamba.mamba_decode}
RECURRENT_MIXERS = tuple(RECURRENT_FWD)

# the identity of the MoE auxiliary losses' sum (a block without an MoE
# FFN adds it)
ZERO_AUX = {"moe_lb_loss": torch.zeros(()), "moe_z_loss": torch.zeros(())}

# leaves the serving layout keeps float32 because JAX computes with them
# in float32 whatever the activation dtype
FLOAT32_LEAVES = xlstm.FLOAT32_LEAVES + mamba.FLOAT32_LEAVES + moe.FLOAT32_LEAVES


def _add_aux(a, b):
    return {k: a[k] + b[k] for k in a}


def check_block(blk: BlockCfg) -> None:
    """Raise for a mixer the JAX package does not have either."""
    if blk.mixer not in ("attn", "cross_attn") + RECURRENT_MIXERS:
        raise ValueError(f"unknown mixer {blk.mixer!r}")


def mixer_cfg(blk: BlockCfg):
    """The config of a recurrent mixer: ``blk.mamba`` or ``blk.xlstm``."""
    return blk.mamba if blk.mixer == "mamba" else blk.xlstm


def ffn_fwd(params, blk: BlockCfg, h):
    """The block's FFN on h: (out, aux), aux the MoE's auxiliary losses or
    ``ZERO_AUX`` for a dense FFN."""
    if blk.ffn == "moe":
        return moe.moe_fwd(params, blk.moe, h)
    return mlp_fwd(params, blk.mlp, h), dict(ZERO_AUX)


def _param_dict(leaves: Dict, trainable: bool) -> nn.ParameterDict:
    """A (possibly nested) dict of tensors as a ``ParameterDict``: a nested
    dict (the mLSTM's ``out_norm``) becomes a nested ``ParameterDict``, so
    its leaf is named ``mixer.out_norm.scale`` as JAX's path reads."""
    return nn.ParameterDict(
        {k: (_param_dict(v, trainable) if isinstance(v, dict)
             else nn.Parameter(v, requires_grad=trainable))
         for k, v in leaves.items()})


def leaf_dtype(groups, name: str, dtype, trainable: bool) -> torch.dtype:
    """The stored dtype of parameter ``name`` under the group path
    ``groups`` (e.g. ("mixer", "out_norm")).  The training layout stores
    every leaf in ``dtype``, the parameter dtype.  The serving layout
    stores them in ``dtype``, the activation dtype, except where JAX
    computes in float32 whatever the activation dtype: norm scales, the
    xLSTM gates' weights and biases, Mamba's decay, step bias and skip, and
    the MoE router (``FLOAT32_LEAVES``)."""
    if trainable:
        return dtype
    if groups[-1].endswith("norm") or name in FLOAT32_LEAVES:
        return torch.float32
    return dtype


def cast_leaves(leaves: Dict, dtype, trainable: bool, groups=()) -> Dict:
    """``leaves`` (a group's, possibly nested) cast by ``leaf_dtype``.  A
    leaf may be a zero-argument callable that draws it: each is drawn and
    cast in turn, so one float32 leaf at a time is live."""
    return {k: (cast_leaves(v, dtype, trainable, groups + (k,))
                if isinstance(v, dict)
                else (v() if callable(v) else v).to(
                    leaf_dtype(groups, k, dtype, trainable)))
            for k, v in leaves.items()}


class Block(nn.Module):
    """One pattern position of a stage, its leaves stacked over the stage's
    repeats.  Parameter names follow the JAX pytree: ``mixer_norm.scale``,
    ``mixer.{wq,wk,wv,wo,bq,bk,bv}`` (attention) or the recurrent mixers'
    leaves (``mixer.out_norm.scale`` nested), ``ffn_norm.scale``,
    ``ffn.{w_up,w_gate,w_down}`` (dense) or ``ffn.{router,we_gate,we_up,
    we_down}`` and ``ffn.dense.*`` (MoE).  ``trainable`` sets
    ``requires_grad``."""

    def __init__(self, tensors: Dict[str, Dict[str, torch.Tensor]],
                 trainable: bool = False):
        super().__init__()
        for group, leaves in tensors.items():
            setattr(self, group, _param_dict(leaves, trainable))


def init_block(generator, cfg: ModelCfg, blk: BlockCfg, repeats: int, *,
               dtype, device, trainable: bool = False) -> Block:
    """Random block weights, stacked over ``repeats``: float32 truncated
    normals, norm scales (ones), zero biases (the xLSTM forget gates' 3.0,
    Mamba's step bias and decay) as in JAX, each cast by ``leaf_dtype`` as
    soon as it is drawn, so that the peak is the block's stored bytes plus
    one float32 leaf (an MoE's expert tensors are 21.5 GB each in float32
    at llama4's width): serving (``dtype`` the activation dtype) keeps
    ``FLOAT32_LEAVES`` and the scales float32; ``trainable`` (``dtype`` the
    parameter dtype) stores every leaf in ``dtype``, with gradients."""
    check_block(blk)
    d, m = cfg.d_model, blk.mlp
    L = (repeats,)

    def dense(shape, fan_in=None):  # drawn when cast_leaves reaches it
        return functools.partial(dense_init, generator, L + shape,
                                 fan_in or shape[0], device=device)

    def zeros(shape):
        return torch.zeros(L + shape, dtype=torch.float32, device=device)

    if blk.mixer == "mlstm":
        mixer = xlstm.init_mlstm(generator, d, blk.xlstm, repeats, device=device)
    elif blk.mixer == "slstm":
        mixer = xlstm.init_slstm(generator, d, blk.xlstm, repeats, device=device)
    elif blk.mixer == "mamba":
        mixer = mamba.init_mamba(generator, d, blk.mamba, repeats, device=device)
    else:
        a = blk.attn
        kvH, hd = a.num_kv_heads, a.head_dim
        G = a.num_heads // kvH
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
    elif blk.ffn == "moe":
        tensors.update(ffn_norm={"scale": ones()},
                       ffn=moe.init_moe(generator, d, blk.moe, repeats,
                                        device=device))
    return Block({g: cast_leaves(leaves, dtype, trainable, (g,))
                  for g, leaves in tensors.items()}, trainable)


def _view(group, r: int) -> Dict:
    return {k: (_view(v, r) if isinstance(v, nn.ParameterDict) else v[r])
            for k, v in group.items()}


def layer_view(tree, r: int):
    """Layer ``r`` of a stacked block: {group: {leaf: tensor[r]}} (nested
    groups nested) for a ``Block``, {leaf: tensor[r]} for a state dict.
    Views, not copies."""
    if isinstance(tree, nn.Module):
        return {name: _view(group, r) for name, group in tree.named_children()}
    return {k: v[r] for k, v in tree.items()}


def _unbind(group, repeats: int) -> List[Dict]:
    cols = {k: (_unbind(v, repeats) if isinstance(v, nn.ParameterDict)
                else v.unbind(0)) for k, v in group.items()}
    return [{k: c[r] for k, c in cols.items()} for r in range(repeats)]


def _layers(block: Block, repeats: int) -> List[Dict]:
    """Per-layer views of a stacked block for the training forward:
    ``unbind`` makes one autograd node per leaf, whose backward stacks the
    layers' gradients once (indexing would zero-fill a full-size gradient
    per layer)."""
    views = [{} for _ in range(repeats)]
    for name, group in block.named_children():
        for r, view in enumerate(_unbind(group, repeats)):
            views[r][name] = view
    return views


# ---------------------------------------------------------------------------
# Training forward


def block_fwd(params, cfg: ModelCfg, blk: BlockCfg, x, *, positions=None,
              enc=None):
    """One layer (``params`` its views); returns (x, aux), aux of
    ``ZERO_AUX``'s structure: an MoE FFN's auxiliary losses, else zeros.
    A cross-attention layer attends over ``enc``."""
    check_block(blk)
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    if blk.mixer in RECURRENT_MIXERS:
        m = RECURRENT_FWD[blk.mixer](params["mixer"], mixer_cfg(blk), h)
    else:
        m = attn.attention_fwd(params["mixer"], blk.attn, h,
                               positions=positions, enc=enc,
                               q_chunk=cfg.attn_q_chunk,
                               use_flash=cfg.use_flash)
    x = x + m
    aux = dict(ZERO_AUX)
    if blk.ffn is not None:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        f, aux = ffn_fwd(params["ffn"], blk, h)
        x = x + f
    return x, aux


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
    recomputes it in the backward pass, "dots" saves matmul outputs.

    Each call takes a snapshot of the ambient mesh and rules
    (``sharding.ambient``) and installs it around every run of ``fn``:
    the forward and the recomputation, which on a card runs on autograd's
    device thread, where the thread-local ambient stack is empty.  A
    nested remat'd call inside ``fn`` takes its snapshot from the one
    installed, so it sees the same."""
    if mode == "none":
        return fn
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def call(*args):
        snapshot = sharding.ambient()

        def run(*a):
            with sharding.installed(snapshot):
                return fn(*a)

        return ckpt.checkpoint(run, *args, use_reentrant=False, **kw)

    return call


def stage_fwd(params, cfg: ModelCfg, stage: Stage, x, *, positions=None,
              enc=None):
    """The training forward of a stage: remat'd groups of the pattern's
    blocks, each block remat'd again inside (JAX's nested remat: the
    backward pass recomputes each block once), over the stacked layers.
    JAX's ``_barrier`` serializes FSDP parameter gathers; on one device it
    is the identity and has no counterpart here.  ``enc`` (the
    cross-attention layers' encoder states) goes into each remat'd call as
    an argument, beside the hidden states.

    The saved boundaries (JAX's ``seq_shard_residuals`` and its
    "act_res_seq" rule): under remat, with gradients on, where the ambient
    rules split the sequence over 'model' (``sharding.res_seq_split``),
    a block's output is kept as the rank's S/N rows (``keep_rows``) and
    the next block gathers its input whole inside its remat'd function
    (``gather_rows``), so what checkpointing saves at every block and
    group boundary, and what the recomputation regathers, is the rank's
    rows.  The stage's input is cut to the rank's rows before the first
    group and its output gathered after the last.  Inside a block every
    op sees whole rows.  Without gradients nothing is saved, and the
    boundary is left whole."""
    rows = None
    if (cfg.remat != "none" and cfg.seq_shard_residuals and x.shape[1] > 1
            and torch.is_grad_enabled()):
        rows = sharding.res_seq_split(x.shape[1])

    def one_block(block_params, y, e, blk):
        if rows is not None:
            y = sharding.gather_rows(y, rows)
        y, a = block_fwd(block_params, cfg, blk, y, positions=positions,
                         enc=e)
        if rows is not None:
            y = sharding.keep_rows(y, rows)
        return y, a

    def group(y, group_params, e):
        aux = dict(ZERO_AUX)
        for i, blk in enumerate(stage.pattern):
            blk_fn = _remat(functools.partial(one_block, blk=blk), cfg.remat)
            y, a = blk_fn(group_params[i], y, e)
            aux = _add_aux(aux, a)
        return y, aux

    group = _remat(group, cfg.remat)
    views = [_layers(b, stage.repeats) for b in params]
    aux = dict(ZERO_AUX)
    if rows is not None:
        x = sharding.keep_rows(x, rows)
    for r in range(stage.repeats):
        x, a = group(x, [v[r] for v in views], enc)
        aux = _add_aux(aux, a)
    if rows is not None:
        x = sharding.gather_rows(x, rows)
    return x, aux


# ---------------------------------------------------------------------------
# Serving steps


_INIT_STATE = {"mlstm": xlstm.init_mlstm_state, "slstm": xlstm.init_slstm_state,
               "mamba": mamba.init_mamba_state}


def _init_recurrent_state(cfg: ModelCfg, blk: BlockCfg, batch: int, dtype,
                          layers: int, device):
    return _INIT_STATE[blk.mixer](mixer_cfg(blk), cfg.d_model, batch, dtype,
                                  layers=layers, device=device)


def init_stage_state_paged(cfg: ModelCfg, stage: Stage, batch: int,
                           cache_len: int, dtype, *, page_size: int,
                           n_pages: int, window_extra: int = 0,
                           kv_dtype=None, device=None):
    """One serving cache per pattern position (paged for global layers,
    per-slot circular buffers ``window_extra`` entries past the window for
    windowed ones, per-slot recurrent states for xLSTM mixers), stacked
    over the repeats."""
    out = []
    for blk in stage.pattern:
        check_block(blk)
        if blk.mixer in RECURRENT_MIXERS:
            out.append(_init_recurrent_state(cfg, blk, batch, dtype,
                                             stage.repeats, device))
            continue
        out.append(attn.init_paged_cache(
            blk.attn, batch, cache_len, dtype, page_size=page_size,
            n_pages=n_pages, window_extra=window_extra, kv_dtype=kv_dtype,
            layers=stage.repeats, device=device))
    return out


def store_state(state: Dict, new: Dict) -> None:
    """Write a recurrent layer's new state into its views, in place."""
    for name, leaf in state.items():
        leaf.copy_(new[name])


def _masked_recurrent_roll(blk: BlockCfg, p, h, s, valid):
    """JAX ``_masked_recurrent_roll``: the single-step decode of ``blk``'s
    mixer over the C positions of h (B, C, D), each slot's state advancing
    only where ``valid`` (B, C) is set — pad tails and idle slots keep
    their state bit-identical.  The loop replaces JAX's scan; ``s`` (one
    layer's views) is written once, after the last step.  Returns the
    outputs (B, C, D)."""
    dec = RECURRENT_DECODE[blk.mixer]
    cur = dict(s)
    ys = []
    for t in range(h.shape[1]):
        y, new = dec(p, mixer_cfg(blk), h[:, t:t + 1], cur)
        v = valid[:, t]
        cur = {k: torch.where(v.reshape((-1,) + (1,) * (a.ndim - 1)), a, cur[k])
               for k, a in new.items()}
        ys.append(y[:, 0])
    store_state(s, cur)
    return torch.stack(ys, dim=1)


def _ragged_recurrent_roll(blk: BlockCfg, p, h, s, slot, seq_idx, valid,
                           width: int):
    """JAX ``_ragged_recurrent_roll``: the pack's tokens scattered by (slot,
    intra-slot ordinal) into a dense (B, width) layout, the masked roll
    over it, the outputs gathered back by the same indices.  The scheduler
    packs at most ``width`` tokens a slot, in position order.  JAX's
    ``mode="drop"`` scatter (invalid entries aim at column ``width``)
    becomes the shape-static ``kops.scatter_live``.  h: (1, T, D);
    slot/seq_idx/valid: (T,).  Returns (1, T, D); invalid rows are junk."""
    B = next(iter(s.values())).shape[0]
    h0 = h[0]
    col = torch.where(valid, seq_idx, width).long()
    slot = slot.long()
    live = (col >= 0) & (col < width) & (slot >= 0) & (slot < B)
    dense = h0.new_zeros((B, width, h0.shape[-1]))
    vdense = torch.zeros((B, width), dtype=torch.bool, device=h0.device)
    kops.scatter_live([(dense, h0), (vdense, valid)],
                      (slot.clamp(0, B - 1), col.clamp(0, width - 1)), live)
    y_dense = _masked_recurrent_roll(blk, p, dense, s, vdense)
    return y_dense[slot.clamp(0, B - 1), col.clamp(max=width - 1)][None]


def block_step_ragged(params, cfg: ModelCfg, blk: BlockCfg, x, state, slot,
                      q_pos, seq_idx, valid, *, width: int,
                      flash_decode: bool = False):
    """One layer of the ragged step; ``params``/``state`` are one layer's
    views.  ``seq_idx``/``width`` feed the recurrent repack of the xLSTM
    mixers (``_ragged_recurrent_roll``)."""
    check_block(blk)
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    if blk.mixer in RECURRENT_MIXERS:
        m = _ragged_recurrent_roll(blk, params["mixer"], h, state, slot,
                                   seq_idx, valid, width)
    else:
        m, state = attn.ragged_attention_step(params["mixer"], blk.attn, h,
                                              state, slot, q_pos, valid,
                                              flash_decode=flash_decode)
    x = x + m
    if blk.ffn is not None:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        x = x + ffn_fwd(params["ffn"], blk, h)[0]
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
    one layer's views): attention, or the masked recurrent roll of an
    xLSTM mixer over the C positions."""
    check_block(blk)
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    if blk.mixer in RECURRENT_MIXERS:
        m = _masked_recurrent_roll(blk, params["mixer"], h, state, valid)
    else:
        m, state = attn.paged_attention_step(params["mixer"], blk.attn, h,
                                             state, q_pos, valid,
                                             flash_decode=flash_decode)
    x = x + m
    if blk.ffn is not None:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        x = x + ffn_fwd(params["ffn"], blk, h)[0]
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
    ``slen`` at ``prefix_len``; the other per-slot leaves (a windowed
    layer's k/v buffers, a recurrent layer's states) are filled in place
    with their fresh-init value, which ``init_states`` holds as a number
    (``FRESH_VALUES``: JAX restores them from a copy of the fresh state,
    which holds the same values, without a full-size template).  Pool
    leaves (values and int8 scales) are shared by all slots and left
    alone.  mask: (B,) bool; ptab_rows: (B, pps);
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
    to -1 and ``slen`` clamps down to ``new_len``; every other leaf —
    pools, scale pools, block tables, windowed and recurrent state — is
    left alone.  ``kpos`` stores absolute positions, so the rejected tail
    is exactly the entries at or past ``new_len``.  Leaves are (layers, B,
    ...); mask, new_len: (B,)."""
    m = mask[None, :]
    for s_blk in states:
        if "kpos" in s_blk:
            kpos = s_blk["kpos"]
            nl = new_len.to(kpos.dtype)[None, :]
            kpos.copy_(torch.where(m[..., None] & (kpos >= nl[..., None]), -1,
                                   kpos))
        if "slen" in s_blk:
            slen = s_blk["slen"]
            nl = new_len.to(slen.dtype)[None, :]
            slen.copy_(torch.where(m, torch.minimum(slen, nl), slen))
    return states


# ---------------------------------------------------------------------------
# Lock-step decode (the reference engine)


def init_stage_state(params, cfg: ModelCfg, stage: Stage, batch: int,
                     cache_len: int, dtype, enc=None, *, device=None):
    """One lock-step cache per pattern position (``attention.init_cache``,
    or a recurrent layer's fresh state), stacked over the repeats (JAX
    ``init_stage_state``).  A cross-attention position's cache is ``enc``
    projected by each repeat's own weights (``params``, the stage's
    stacked blocks), stacked: JAX's ``vmap`` over the stacked parameters
    (``transformer.py:226-240``)."""
    out = []
    for i, blk in enumerate(stage.pattern):
        check_block(blk)
        if blk.mixer in RECURRENT_MIXERS:
            out.append(_init_recurrent_state(cfg, blk, batch, dtype,
                                             stage.repeats, device))
        elif blk.mixer == "cross_attn":
            reps = [attn.init_cross_cache(layer_view(params[i], r)["mixer"],
                                          blk.attn, enc)
                    for r in range(stage.repeats)]
            out.append({k: torch.stack([c[k] for c in reps]) for k in reps[0]})
        else:
            out.append(attn.init_cache(blk.attn, batch, cache_len, dtype,
                                       layers=stage.repeats, device=device))
    return out


def block_decode(params, cfg: ModelCfg, blk: BlockCfg, x, state, *,
                 sp_decode: bool = False):
    """One layer of the lock-step decode (x: (B, 1, D); ``params``/``state``
    one layer's views; the cache or recurrent state is updated in place)."""
    check_block(blk)
    h = rmsnorm(params["mixer_norm"], x, cfg.norm_eps)
    if blk.mixer in RECURRENT_MIXERS:
        m, new = RECURRENT_DECODE[blk.mixer](params["mixer"], mixer_cfg(blk),
                                             h, state)
        store_state(state, new)
    else:
        m, state = attn.attention_decode(params["mixer"], blk.attn, h, state,
                                         sp_decode=sp_decode)
    x = x + m
    if blk.ffn is not None:
        h = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
        x = x + ffn_fwd(params["ffn"], blk, h)[0]
    return x, state


def stage_decode(params, cfg: ModelCfg, stage: Stage, x, states, *,
                 sp_decode: bool = False):
    """The lock-step decode's layer loop, as ``stage_step_ragged``'s."""
    for r in range(stage.repeats):
        for i, blk in enumerate(stage.pattern):
            x, _ = block_decode(layer_view(params[i], r), cfg, blk, x,
                                layer_view(states[i], r), sp_decode=sp_decode)
    return x, states

"""Model entry points: init, forward and loss (training), paged state, the
ragged and two-phase steps and their control-plane companions (serving),
and the lock-step decode state, prefill and decode step (the reference
engine).

Counterpart of ``repro.models.model``.  Parameters live in a ``Model``
``nn.Module`` whose parameter names follow the JAX pytree paths
(``embed.tok_embed``, ``stages.0.0.mixer.wq``, ``final_norm.scale``), with
each stage's per-layer tensors stacked on a leading layer axis.  Two
layouts:

- serving (the default): matrices, biases and the embedding table are
  stored in the activation dtype (``cfg.dtype``), cast once at load where
  JAX casts its float32 parameters at every use; RMSNorm scales stay
  float32; nothing requires grad.
- training (``for_training=True``): every leaf in ``cfg.param_dtype``, as
  JAX stores it, with ``requires_grad``; the layers cast at use.

The serving state is a plain pytree of tensors ({"layers": [[cache per
pattern position] per stage]}) that every serving function here updates in
place; the lock-step decode state adds a top-level scalar "pos".

Supported: every config of the registry.  Blocks are attention — global,
windowed (sliding-window, as gemma3's local layers), bidirectional
(hubert) or cross-attention over the vision stub's features — or recurrent
mixers (mLSTM, sLSTM: xlstm-350m; Mamba: jamba), each with a dense FFN, an
MoE FFN (llama4, arctic, jamba) or none, with a tied or an untied output
head (``head.out_head``, (d, V), as JAX's ``{"head": {"out_head"}}``).
The audio frontend (hubert) replaces the embedding with
``frontend.frontend_proj`` over ``batch["feats"]`` and always has a head;
the vision frontend (llama-3.2-vision) keeps the embedding and projects
``batch["img_feats"]`` into the cross-attention layers' ``enc``;
``abs_pos="sinusoidal"`` adds sinusoidal encodings to the inputs on every
path JAX adds them.  As in JAX, only the training forward and the
lock-step decode take frontend configs: the paged serving steps (and so
the engines) serve decoder token models (``check_servable``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import embeddings as emb
from repro_torch.models.layers.common import dense_init, embed_init
from repro_torch.models.layers.norms import rmsnorm

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3


def check_supported(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` for any config outside the port."""
    if cfg.abs_pos not in ("none", "sinusoidal"):
        raise NotImplementedError(
            f"abs_pos={cfg.abs_pos!r}: the JAX package computes only "
            "sinusoidal absolute positions")
    for st in cfg.stages:
        for blk in st.pattern:
            tfm.check_block(blk)


def check_servable(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` for configs the serving paths do not
    take: frontends and encoders (JAX ``init_paged_state``; JAX's
    reference engine fails on them too)."""
    check_supported(cfg)
    if cfg.frontend is not None or cfg.is_encoder:
        raise NotImplementedError("paged serving covers decoder token models")


class Model(nn.Module):
    """Parameter container mirroring the JAX pytree (see module docstring);
    ``out_head`` becomes ``head.out_head`` and ``frontend_proj`` (audio and
    vision) ``frontend.frontend_proj``; ``tok_embed`` is None for the
    audio frontend, which has no embedding.  ``trainable`` sets
    ``requires_grad`` of the embedding, frontend, final norm and head
    (blocks carry their own)."""

    def __init__(self, tok_embed, stages, final_scale: torch.Tensor,
                 trainable: bool = False, out_head: torch.Tensor = None,
                 frontend_proj: torch.Tensor = None):
        super().__init__()
        self.embed = None if tok_embed is None else nn.ParameterDict(
            {"tok_embed": nn.Parameter(tok_embed, requires_grad=trainable)})
        self.frontend = None if frontend_proj is None else nn.ParameterDict(
            {"frontend_proj": nn.Parameter(frontend_proj,
                                           requires_grad=trainable)})
        self.stages = nn.ModuleList(nn.ModuleList(st) for st in stages)
        self.final_norm = nn.ParameterDict(
            {"scale": nn.Parameter(final_scale, requires_grad=trainable)})
        self.head = None if out_head is None else nn.ParameterDict(
            {"out_head": nn.Parameter(out_head, requires_grad=trainable)})

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device


def init_params(cfg: ModelCfg, *, generator: torch.Generator = None,
                device=None, for_training: bool = False) -> Model:
    """Random weights with the JAX package's scheme (truncated-normal
    fan-in dense weights, truncated-normal embedding, unit norm scales,
    zero biases), drawn from ``generator`` on ``device`` (default: seed 0
    on ``cuda``), in the serving layout or, with ``for_training``, the
    training layout (module docstring).  The frontend projection is
    (d_model/2, d_model), and untied and audio configs have a head, as in
    JAX.  Not the JAX bits: tests bridge JAX's weights instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, cfg.param_dtype if for_training else cfg.dtype)
    tok = front = head = None
    if cfg.frontend != "audio":
        tok = embed_init(generator, (cfg.vocab_size, cfg.d_model),
                         device=dev).to(dt)
    if cfg.frontend is not None:
        front = emb.init_frontend(generator, cfg.d_model // 2, cfg.d_model,
                                  device=dev)["frontend_proj"].to(dt)
    stages = [[tfm.init_block(generator, cfg, blk, st.repeats, dtype=dt,
                              device=dev, trainable=for_training)
               for blk in st.pattern]
              for st in cfg.stages]
    final = torch.ones(cfg.d_model, device=dev,
                       dtype=dt if for_training else torch.float32)
    if not cfg.tie_embeddings or cfg.frontend == "audio":
        head = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                          device=dev).to(dt)
    return Model(tok, stages, final, trainable=for_training, out_head=head,
                 frontend_proj=front)


def _logits(params: Model, cfg: ModelCfg, x: torch.Tensor) -> torch.Tensor:
    """The output head: ``head.out_head`` where there is one (untied
    configs, audio), the embedding's transpose otherwise (JAX
    ``model.py:78, 138``)."""
    if params.head is None:
        return emb.logits_from_hidden({}, x, tied_embed=params.embed["tok_embed"])
    return emb.logits_from_hidden(params.head, x)


def _add_positions(cfg: ModelCfg, x: torch.Tensor, positions) -> torch.Tensor:
    """x plus the sinusoidal encodings at ``positions`` ((S,) or (B, S),
    ints) where ``cfg.abs_pos`` asks for them, cast to x's dtype before
    the add, as JAX adds them."""
    if cfg.abs_pos == "sinusoidal":
        x = x + emb.sinusoidal_at(positions, cfg.d_model, x.dtype)
    return x


def encode_images(params: Model, cfg: ModelCfg, img_feats):
    """The vision stub's encoder states: ``img_feats`` (B, n_img, d/2)
    projected to (B, n_img, d) in the activation dtype; None for other
    configs."""
    if cfg.frontend != "vision":
        return None
    return emb.apply_frontend(params.frontend, img_feats,
                              getattr(torch, cfg.dtype))


def _embed_inputs(params: Model, cfg: ModelCfg, batch):
    """(x (B, S, D), enc or None), JAX ``_embed_inputs``: the audio
    frontend over ``batch["feats"]`` or the embedding of
    ``batch["tokens"]``, plus sinusoidal positions 0..S-1 where
    ``abs_pos`` says; the vision frontend over ``batch["img_feats"]``."""
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        x = emb.apply_frontend(params.frontend, batch["feats"], dt)
    else:
        x = emb.embed_tokens(params.embed, batch["tokens"].long(), dt)
    x = _add_positions(cfg, x, torch.arange(x.shape[1], device=x.device))
    return x, encode_images(params, cfg, batch.get("img_feats"))


# ---------------------------------------------------------------------------
# Forward / loss (training)


def forward(params: Model, cfg: ModelCfg, batch) -> Tuple[torch.Tensor, Dict]:
    """batch["tokens"]: (B, S) ints — for the audio frontend
    batch["feats"]: (B, S, d/2) instead; the vision frontend adds
    batch["img_feats"]: (B, n_img, d/2) — -> (logits (B, S, V) in the
    activation dtype, aux dict)."""
    check_supported(cfg)
    x, enc = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = dict(tfm.ZERO_AUX)
    for st, sp in zip(cfg.stages, params.stages):
        x, a = tfm.stage_fwd(sp, cfg, st, x, positions=positions, enc=enc)
        aux = tfm._add_aux(aux, a)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(params, cfg, x), aux


def _xent(logits, labels):
    """Per-token cross entropy in float32: logsumexp minus the target
    logit.  JAX picks the target with a (B,S,V) one-hot mask (1.2 GB at
    qwen2-1.5b's vocab and 8192 tokens); ``gather`` gives the same values."""
    lf = logits.float()
    tgt = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - tgt  # (B,S)


def loss_fn(params: Model, cfg: ModelCfg, batch) -> Tuple[torch.Tensor, Dict]:
    """-> (total loss, metrics {"ce_loss", "moe_lb_loss", "moe_z_loss"}):
    the cross entropy plus the MoE layers' summed load-balance and z losses
    under ``MOE_LB_WEIGHT`` and ``MOE_Z_WEIGHT`` (zero without an MoE
    FFN); ``batch["loss_mask"]``, when present, weights the tokens."""
    logits, aux = forward(params, cfg, batch)
    per_tok = _xent(logits, batch["labels"])
    if "loss_mask" in batch:
        mask = batch["loss_mask"].float()
        loss = torch.sum(per_tok * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    else:
        loss = torch.mean(per_tok)
    total = (loss + MOE_LB_WEIGHT * aux["moe_lb_loss"]
             + MOE_Z_WEIGHT * aux["moe_z_loss"])
    return total, {"ce_loss": loss, **aux}


# ---------------------------------------------------------------------------
# Paged serving


def init_paged_state(params: Model, cfg: ModelCfg, batch: int, cache_len: int,
                     *, page_size: int, n_pages: int, window_extra: int = 0,
                     kv_dtype=None) -> Dict:
    """Decode state for the paged serving engine, on the params' device:
    block-table-indexed KV pools of ``n_pages`` pages of ``page_size`` per
    global layer, per-slot circular buffers per windowed layer.  Every slot
    tracks its own position.  ``kv_dtype`` (None | "float32" | "bfloat16" |
    "int8") selects the pools' storage; int8 pools carry float32 scale
    pools.  ``window_extra`` must be at least ``prefill_chunk - 1`` when
    prefill is chunked (see ``attention.init_paged_cache``).  Frontend and
    encoder configs raise ``NotImplementedError``, as in JAX."""
    check_servable(cfg)
    dt = getattr(torch, cfg.dtype)
    return {"layers": [tfm.init_stage_state_paged(
        cfg, st, batch, cache_len, dt, page_size=page_size, n_pages=n_pages,
        window_extra=window_extra, kv_dtype=kv_dtype, device=params.device)
        for st in cfg.stages]}


def paged_step(params: Model, cfg: ModelCfg, state, tokens, q_pos, valid, *,
               with_logits: bool = True, flash_decode: bool = False):
    """One step of the two-phase serving path: C tokens per slot at per-slot
    absolute positions.  tokens/q_pos/valid: (B, C) tensors on the params'
    device.  C == 1 is a decode tick (returns logits (B, C, V)); C > 1 a
    prefill chunk, whose caller passes ``with_logits=False`` to skip the
    final norm and the head (returns None).  Invalid entries write nothing.
    Returns (logits, state), the state updated in place."""
    dt = getattr(torch, cfg.dtype)
    x = emb.embed_tokens(params.embed, tokens.long(), dt)  # (B,C,D)
    x = _add_positions(cfg, x, q_pos)
    for st, sp, ss in zip(cfg.stages, params.stages, state["layers"]):
        x, _ = tfm.stage_step_paged(sp, cfg, st, x, ss, q_pos, valid,
                                    flash_decode=flash_decode)
    if not with_logits:
        return None, state
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(params, cfg, x), state


def ragged_step(params: Model, cfg: ModelCfg, state, tokens, slot, q_pos,
                seq_idx, valid, logit_idx, *, width: int,
                flash_decode: bool = False):
    """One ragged token-budget step: T tokens from any mix of slots/phases.

    tokens/slot/q_pos/seq_idx/valid: (T,) tensors on the params' device;
    logit_idx: (B,) index into the pack of each slot's sampled token (T =
    no sample; that row's logits are garbage the engine ignores).  Writes
    the pack into the state in place and returns (logits (B, V), state).
    A speculative engine passes (B, R) instead — row 0 the slot's decode
    token, rows 1..R-1 its packed draft tokens, T where unused — and gets
    (B, R, V) back: only those B·R rows go through the final norm and the
    head."""
    dt = getattr(torch, cfg.dtype)
    x = emb.embed_tokens(params.embed, tokens.long()[None], dt)  # (1,T,D)
    x = _add_positions(cfg, x, q_pos)
    for st, sp, ss in zip(cfg.stages, params.stages, state["layers"]):
        x, _ = tfm.stage_step_ragged(sp, cfg, st, x, ss, slot, q_pos, seq_idx,
                                     valid, width=width,
                                     flash_decode=flash_decode)
    # only the sampled rows go through the final norm and the head
    flat = logit_idx.reshape(-1).long()
    sel = x[0][torch.clamp(flat, max=x.shape[1] - 1)]
    sel = rmsnorm(params.final_norm, sel, cfg.norm_eps)
    logits = _logits(params, cfg, sel)
    return logits.reshape(logit_idx.shape + logits.shape[-1:]), state


def reset_template(state) -> Dict:
    """The reset template of a serving state: the fresh value of each
    per-slot leaf that an admission restores, as a number
    (``transformer.FRESH_VALUES``: a windowed layer's k/v buffers and the
    recurrent states), laid out like ``state``'s layers."""
    return {"layers": [[{k: tfm.FRESH_VALUES[k] for k in c
                         if k in tfm.FRESH_VALUES} for c in ss]
                       for ss in state["layers"]]}


def reset_paged_slots(cfg: ModelCfg, state, init_state, mask, ptab_rows,
                      prefix_len) -> Dict:
    """Admission, in place: for slots where ``mask`` is set, install the
    host-allocated block-table rows, make the ``prefix_len`` inherited
    prefix positions live, and fill a windowed layer's k/v buffers and a
    recurrent layer's states with their fresh values, which ``init_state``
    holds as a number per leaf (``reset_template``; {"layers": [[{}]]}
    where every layer is global).  Pools are shared and untouched — they
    double as the prefix cache."""
    for st, ss, is0 in zip(cfg.stages, state["layers"], init_state["layers"]):
        tfm.reset_stage_slots(st, ss, is0, mask, ptab_rows, prefix_len)
    return state


def rollback_paged_slots(cfg: ModelCfg, state, mask, new_len) -> Dict:
    """Speculative rejection, in place: for slots where ``mask`` is set,
    every written KV row at a position >= ``new_len`` (the slot's next
    write position after its accepted draft prefix) goes dead — its
    ``kpos`` entry drops to -1 and ``slen`` clamps to ``new_len``.  Pools,
    scale pools and block tables stay untouched: the rejected rows lie in
    pages the slot owns alone and the next tick's writes overwrite them.
    mask: (B,) bool; new_len: (B,) int32, both on the state's device.
    Masked writes only (no boolean indexing, no host synchronisation), so
    it can run between graph replays on the step's stream."""
    for st, ss in zip(cfg.stages, state["layers"]):
        tfm.rollback_stage_slots(st, ss, mask, new_len)
    return state


def paged_leaves(state):
    """Yield (key, leaf, page axis) for every paged-pool leaf of ``state``:
    ``kp``/``vp`` values with their page axis at ``ndim - 4`` and int8
    ``ks``/``vs`` scale rows at ``ndim - 3`` (a leading layer axis rides
    along).  ``key`` ("layers.<stage>.<position>.<name>") names the leaf in
    ``gather_kv_page``'s result."""
    for i, stage_state in enumerate(state["layers"]):
        for j, cache in enumerate(stage_state):
            for name in tfm.POOL_LEAVES:
                if name in cache:
                    leaf = cache[name]
                    ax = leaf.ndim - (4 if name in ("kp", "vp") else 3)
                    yield f"layers.{i}.{j}.{name}", leaf, ax


def copy_kv_pages(cfg: ModelCfg, state, src, dst) -> Dict:
    """Copy-on-write, in place: duplicate pool pages ``src[i] -> dst[i]``
    in every layer's pools, int8 scale rows with their pages.  Sentinel
    pairs (``n_pages``) are no-ops (see ``kernels.ops.copy_pages``)."""
    for _, leaf, ax in paged_leaves(state):
        kops.copy_pages(leaf, src, dst, axis=ax)
    return state


def gather_kv_page(cfg: ModelCfg, state, page: int) -> Dict[str, torch.Tensor]:
    """One pool page's rows in every paged leaf — K/V values and, for int8
    pools, their scale rows — as {key: view} (``paged_leaves`` keys): the
    unit the tiered pool demotes to host RAM.  Views, not copies: the
    caller copies them out before the page is reused (the engine's demote
    mover does so on the stream the page's next writer runs on)."""
    return {key: leaf.select(ax, page) for key, leaf, ax in paged_leaves(state)}


def insert_kv_page(cfg: ModelCfg, state, page_data, page: int) -> Dict:
    """Write one demoted page's rows (``gather_kv_page``'s layout) into
    every paged leaf at device page ``page``, in place — the promotion
    write.  Scale rows travel with their values, so an int8 page comes back
    bit-exact.  The copies are ``non_blocking``: from pinned host rows they
    are queued on the current stream without waiting for the host."""
    for key, leaf, ax in paged_leaves(state):
        leaf.select(ax, page).copy_(page_data[key], non_blocking=True)
    return state


# ---------------------------------------------------------------------------
# Lock-step decode (the reference engine's path)


def init_decode_state(params: Model, cfg: ModelCfg, batch: int,
                      cache_len: int, enc_feats=None) -> Dict:
    """Fresh lock-step decode state on the params' device: one
    ``attention.init_cache`` per self-attention layer, the projected K/V of
    the vision stub's features per cross-attention layer
    (``attention.init_cross_cache`` over ``enc_feats`` (B, n_img, d/2),
    which vision configs need), and the top-level position "pos" (a 0-d
    int32 tensor), which every slot shares."""
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    dev = params.device
    enc = encode_images(params, cfg, enc_feats)
    return {"layers": [tfm.init_stage_state(sp, cfg, st, batch, cache_len, dt,
                                            enc, device=dev)
                       for st, sp in zip(cfg.stages, params.stages)],
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def decode_step(params: Model, cfg: ModelCfg, state, tokens_t, *,
                sp_decode: bool = False):
    """One lock-step decode token per batch row: tokens_t (B, 1) ints ->
    (logits (B, 1, V), state), the state updated in place (every
    self-attention layer's cache and "pos" advance by one; cross-attention
    caches stay).  Sinusoidal positions, where ``abs_pos`` says, are taken
    at "pos"."""
    dt = getattr(torch, cfg.dtype)
    x = emb.embed_tokens(params.embed, tokens_t.long(), dt)
    x = _add_positions(cfg, x, state["pos"].reshape(1))
    for st, sp, ss in zip(cfg.stages, params.stages, state["layers"]):
        x, _ = tfm.stage_decode(sp, cfg, st, x, ss, sp_decode=sp_decode)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    state["pos"].add_(1)
    return _logits(params, cfg, x), state


@torch.no_grad()
def prefill(params: Model, cfg: ModelCfg, state, tokens, enc_feats=None) -> Dict:
    """Teacher-forced prompt ingestion into a lock-step state, in place:
    tokens (B, S), and for vision configs ``enc_feats`` (B, n_img, d/2).
    Each self-attention layer runs the full-sequence attention (the
    chunked route, never flash, as in JAX) for the hidden states and
    writes its cache (``attention.prefill_cache``); a cross-attention
    layer attends over the projected features and leaves its cache as
    ``init_decode_state`` made it; a recurrent layer rolls its state over
    the prompt (``_roll_recurrent``); every "pos" becomes S."""
    x, enc = _embed_inputs(params, cfg, {"tokens": tokens,
                                         "img_feats": enc_feats})
    S = tokens.shape[1]
    positions = torch.arange(S, device=x.device)
    for st, sp, ss in zip(cfg.stages, params.stages, state["layers"]):
        x = _stage_prefill(sp, cfg, st, x, ss, positions, enc)
    state["pos"].fill_(S)
    return state


def _stage_prefill(params, cfg: ModelCfg, stage, x, states, positions, enc):
    """One stage of ``prefill``: the layer loop of ``stage_step_ragged``,
    each self-attention layer's output from ``attention_fwd`` and its
    cache from ``prefill_cache``, each cross-attention layer's output from
    ``attention_fwd`` over ``enc``, each recurrent layer's from
    ``_roll_recurrent``."""
    for r in range(stage.repeats):
        for i, blk in enumerate(stage.pattern):
            tfm.check_block(blk)
            bp, cache = tfm.layer_view(params[i], r), tfm.layer_view(states[i], r)
            h = rmsnorm(bp["mixer_norm"], x, cfg.norm_eps)
            if blk.mixer in tfm.RECURRENT_MIXERS:
                x = x + _roll_recurrent(blk, bp["mixer"], h, cache)
            elif blk.mixer == "cross_attn":
                x = x + attn.attention_fwd(bp["mixer"], blk.attn, h, enc=enc,
                                           q_chunk=cfg.attn_q_chunk)
            else:
                x = x + attn.attention_fwd(bp["mixer"], blk.attn, h,
                                           positions=positions,
                                           q_chunk=cfg.attn_q_chunk)
                attn.prefill_cache(bp["mixer"], blk.attn, cache, h, positions)
            if blk.ffn is not None:
                h = rmsnorm(bp["ffn_norm"], x, cfg.norm_eps)
                x = x + tfm.ffn_fwd(bp["ffn"], blk, h)[0]
    return x


def _roll_recurrent(blk, p, h, state):
    """Prefill a recurrent mixer (JAX ``_roll_recurrent``): the outputs
    from the parallel form, the state from the single-step decode rolled
    over every position of h (B, S, D), written into ``state`` (one
    layer's views) in place.  Returns the outputs."""
    c = tfm.mixer_cfg(blk)
    out = tfm.RECURRENT_FWD[blk.mixer](p, c, h)
    cur = dict(state)
    for t in range(h.shape[1]):
        _, cur = tfm.RECURRENT_DECODE[blk.mixer](p, c, h[:, t:t + 1], cur)
    tfm.store_state(state, cur)
    return out

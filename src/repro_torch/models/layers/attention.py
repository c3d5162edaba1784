"""Attention: GQA with RoPE over a paged KV pool for the two serving steps
(the ragged pack and the two-phase (B, C) step), full-sequence attention
for training and prefill (causal or bidirectional, self- or
cross-attention), and the lock-step decode cache.

Counterpart of ``repro.models.layers.attention`` (all but the multi-device
decode).  Layouts follow the JAX package: q is
grouped (.., kvH, G, hd) with G = num_heads // num_kv_heads, weights are
stored grouped — wq (D,kvH,G,hd), wo (kvH,G,hd,D) — and the pool is
kp/vp (n_pages, page, kvH, hd) with a block table ptab (B, pps), per-slot
absolute positions kpos (B, pps*page) (-1 = never written) and fill counts
slen (B,).  int8 pools add float32 scale pools ks/vs (n_pages, page, kvH).

Differences from JAX, on purpose:

- The cache is updated IN PLACE: the step writes into the tensors of the
  ``cache`` dict it is given and returns the same dict.  That replaces
  donation; the pools keep their ``data_ptr()``.
- Writes JAX drops with ``mode="drop"`` (the sentinel page ``n_pages``, the
  sentinel kpos index ``pps*page``) go through ``kernels.ops.scatter_live``,
  whose shapes follow from the inputs' shapes alone (no boolean index, no
  host synchronisation), so that a serving step can be captured in a CUDA
  graph; gathers JAX clips with ``mode="clip"`` clamp their indices.
- Serving weights are cast to the activation dtype once at load, not at
  each use; training weights stay in the parameter dtype and are cast at
  each use, as in JAX.
- The ragged step's windowed layers score each token against every slot's
  circular buffer and mask out the other slots (``_ragged_window_attn``),
  where JAX gathers a (T, cap) copy of each token's slot buffer: the same
  function, without the per-token copy.

Windowed layers (``cfg.window``) keep per-slot circular buffers of
``min(window, cache_len) + window_extra`` entries in the serving state, and
a shared circular buffer of ``min(window, max_len)`` entries in the
lock-step cache.  Cross-attention layers (``cfg.cross``: the vision stub)
take K/V from the encoder states ``enc``, without RoPE and never causal;
their lock-step cache is the projected K/V of ``enc``
(``init_cross_cache``), which decoding reads and never writes.  They have
no serving cache: the paged serving steps take decoder token models only,
as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttnCfg
from repro_torch.kernels import ops as kops
from repro_torch.models.layers.embeddings import apply_rope

NEG_INF = -1e30


def _project_q(params, cfg: AttnCfg, x):
    """x (.., D) -> q (.., kvH, G, hd)."""
    wq = params["wq"].to(x.dtype)
    q = (x @ wq.reshape(wq.shape[0], -1)).reshape(*x.shape[:-1], *wq.shape[1:])
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    return q


def _project_kv(params, cfg: AttnCfg, x):
    """x (.., D) -> k, v (.., kvH, hd)."""
    out = []
    for w, bias in (("wk", "bk"), ("wv", "bv")):
        wt = params[w].to(x.dtype)
        t = (x @ wt.reshape(wt.shape[0], -1)).reshape(*x.shape[:-1], *wt.shape[1:])
        if cfg.qkv_bias:
            t = t + params[bias].to(x.dtype)
        out.append(t)
    return out[0], out[1]


def _out_proj(params, cfg: AttnCfg, o):
    """o (.., kvH, G, hd) -> (.., D): contraction over (kvH, G, hd)."""
    wo = params["wo"].to(o.dtype)
    return o.reshape(*o.shape[:-3], -1) @ wo.reshape(-1, wo.shape[-1])


# One device holds the whole pool, so the JAX package's replicate-before-
# contract variant (which keeps sums device-count-independent under a KV-head
# mesh) is the plain projection here.
_out_proj_replicated = _out_proj


def kv_cache_dtype(kv_dtype, act_dtype) -> torch.dtype:
    """Resolve a ``kv_dtype`` name ("float32" | "bfloat16" | "int8"); None
    follows the activation dtype."""
    return act_dtype if kv_dtype is None else getattr(torch, kv_dtype)


def init_paged_cache(cfg: AttnCfg, batch: int, cache_len: int, dtype, *,
                     page_size: int, n_pages: int, window_extra: int = 0,
                     kv_dtype=None, layers: int = 1, device=None):
    """Serving cache of one attention layer, stacked over ``layers`` (a
    stage's repeats): every leaf has a leading layer axis.

    A global layer gets a paged cache; ``kv_dtype`` (None | "float32" |
    "bfloat16" | "int8") sets the pool's storage dtype, and int8 pools add
    float32 scale pools ``ks``/``vs``.  A windowed layer gets per-slot
    circular buffers k/v (B, cap, kvH, hd) with ``cap = min(window,
    cache_len) + window_extra`` and per-slot ``kpos``/``slen``: a C-token
    chunk evicts the C oldest entries, so chunked prefill needs
    ``window_extra`` of at least C - 1 (the engine passes C).  The buffers
    stay in the activation dtype whatever ``kv_dtype`` is, as in JAX: int8
    quantizes the global layers only.  Cross-attention layers have no
    serving cache: ``NotImplementedError``, as JAX's
    ``init_block_state_paged`` raises."""
    if cfg.cross:
        raise NotImplementedError("paged serving covers token models only")
    kvH, hd = cfg.num_kv_heads, cfg.head_dim
    L = (layers,)
    if cfg.window is not None:
        cap = min(cfg.window, cache_len) + window_extra
        return {
            "k": torch.zeros(L + (batch, cap, kvH, hd), dtype=dtype, device=device),
            "v": torch.zeros(L + (batch, cap, kvH, hd), dtype=dtype, device=device),
            "kpos": torch.full(L + (batch, cap), -1, dtype=torch.int32,
                               device=device),
            "slen": torch.zeros(L + (batch,), dtype=torch.int32, device=device),
        }
    kvd = kv_cache_dtype(kv_dtype, dtype)
    pps = -(-cache_len // page_size)
    cache = {
        "kp": torch.zeros(L + (n_pages, page_size, kvH, hd), dtype=kvd, device=device),
        "vp": torch.zeros(L + (n_pages, page_size, kvH, hd), dtype=kvd, device=device),
        "ptab": torch.full(L + (batch, pps), n_pages, dtype=torch.int32, device=device),
        "kpos": torch.full(L + (batch, pps * page_size), -1, dtype=torch.int32,
                           device=device),
        "slen": torch.zeros(L + (batch,), dtype=torch.int32, device=device),
    }
    if kvd == torch.int8:
        cache["ks"] = torch.zeros(L + (n_pages, page_size, kvH), device=device)
        cache["vs"] = torch.zeros(L + (n_pages, page_size, kvH), device=device)
    return cache


def _mask_bias(q_pos, k_pos, causal: bool, window):
    """(Sq, Sk) additive bias in float32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    ok &= k_pos[None, :] >= 0  # invalid (unwritten) cache slots carry pos=-1
    return torch.where(ok, 0.0, NEG_INF).float()


def _softmax_attn(q, k, v, bias):
    """q: (B,Sq,kvH,G,hd)  k,v: (B,Sk,kvH,hd)  bias: (Sq,Sk) -> (B,Sq,kvH,G,hd)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgqt", q, k).float() * scale
    p = torch.softmax(s + bias, dim=-1).to(q.dtype)
    return torch.einsum("bkgqt,btkd->bqkgd", p, v)


def _chunked_attn(q, k, v, q_positions, k_positions, causal, window, q_chunk):
    """A loop over query chunks (JAX's ``lax.scan``); memory ~ one
    (q_chunk x Sk) score block per chunk."""
    S = q.shape[1]
    out = []
    for c in range(0, S, q_chunk):
        bias = _mask_bias(q_positions[c:c + q_chunk], k_positions, causal, window)
        out.append(_softmax_attn(q[:, c:c + q_chunk], k, v, bias))
    return torch.cat(out, dim=1)


def attention_fwd(params, cfg: AttnCfg, x, *, positions=None, enc=None,
                  q_chunk: int = 128, use_flash: bool = False):
    """Full-sequence attention (training, prefill).  x: (B, S, D); for a
    cross-attention layer ``enc`` (B, T, D), the encoder states its K/V
    come from, at key positions 0..T-1, without RoPE and never causal.
    Three routes, as in JAX: ``use_flash`` goes through the flash kernel
    (``kernels.ops.flash_attention_grouped``) only for causal
    self-attention without a window, S == T; otherwise a full softmax when
    ``S <= 2*q_chunk`` or ``S % q_chunk != 0``, else the chunked softmax.
    Bidirectional layers (``causal=False``: hubert) take the last two."""
    S = x.shape[1]
    q = _project_q(params, cfg, x)
    k, v = _project_kv(params, cfg, enc if cfg.cross else x)
    T = k.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if cfg.rope_theta is not None and not cfg.cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    causal = cfg.causal and not cfg.cross
    k_positions = torch.arange(T, device=x.device)
    if use_flash and causal and cfg.window is None and S == T:
        o = kops.flash_attention_grouped(q, k, v)
    elif S <= 2 * q_chunk or S % q_chunk != 0:
        o = _softmax_attn(q, k, v, _mask_bias(positions, k_positions,
                                              causal, cfg.window))
    else:
        o = _chunked_attn(q, k, v, positions, k_positions, causal,
                          cfg.window, q_chunk)
    return _out_proj(params, cfg, o)


def _paged_masked_attn(q, k, v, kpos, q_pos, window):
    """Per-slot masked softmax: q (B,C,kvH,G,hd), k/v (B,T,kvH,hd),
    kpos (B,T), q_pos (B,C) -> (B,C,kvH,G,hd)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgqt", q, k).float() * scale
    ok = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        ok &= (q_pos[:, :, None] - kpos[:, None, :]) < window
    ok = ok[:, None, None, :, :]
    p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1).to(q.dtype)
    p = torch.where(ok, p, 0.0)
    return torch.einsum("bkgqt,btkd->bqkgd", p, v)


def _scatter_paged_kv(cache, k_new, v_new, page, off):
    """Write new K/V rows into the pool at (page, off), in place — the one
    write path of the step.  int8 pools quantize on write; sentinel pages
    drop the write either way."""
    if "ks" in cache:
        kops.kv_scatter_quantized(cache["kp"], cache["ks"], k_new, page, off)
        kops.kv_scatter_quantized(cache["vp"], cache["vs"], v_new, page, off)
        return
    n_pages = cache["kp"].shape[0]
    kops.scatter_live([(cache["kp"], k_new), (cache["vp"], v_new)],
                      (page.clamp(0, n_pages - 1), off),
                      kops.live_writes(page, n_pages))


def _write_kpos(kpos, rows, qp, q_pos, valid):
    """``kpos[rows, qp] = q_pos`` for valid entries inside [0, Tc), in
    place; JAX drops the rest (its sentinel index ``Tc``).  The four index
    tensors share one shape."""
    B, Tc = kpos.shape
    live = valid & (qp >= 0) & (qp < Tc)
    kops.scatter_live([(kpos, q_pos)],
                      (rows.clamp(0, B - 1), qp.clamp(0, Tc - 1)), live)


def _gather_paged_kv(cache, dtype):
    """Gather the whole block-table context from the pool (block-table
    entries clamp into the pool, like JAX's ``mode="clip"``), dequantizing
    int8 pools.  Returns (k, v) of shape (B, pps, P, kvH, hd) in ``dtype``."""
    idx = cache["ptab"].long().clamp(0, cache["kp"].shape[0] - 1)
    k, v = cache["kp"][idx], cache["vp"][idx]
    if "ks" in cache:
        return (kops.dequantize_kv(k, cache["ks"][idx], dtype),
                kops.dequantize_kv(v, cache["vs"][idx], dtype))
    return k.to(dtype), v.to(dtype)


def _write_window(cache, rows, q_pos, valid, k_new, v_new):
    """Write the valid tokens' K/V into a windowed layer's per-slot circular
    buffers, in place (JAX ``paged_attention_step``/``ragged_attention_step``,
    windowed branch).  A slot's tokens of one step are consecutive
    positions; when there are more than ``cap`` of them the buffer wraps
    within the write, so only each slot's last ``cap`` are kept (duplicate
    targets would race).  ``rows``/``q_pos``/``valid`` share one shape;
    ``rows`` are the tokens' slots.  Returns (the kept-token mask, their
    buffer index with the sentinel ``cap`` for the rest)."""
    B, cap = cache["kpos"].shape
    qp = q_pos.long()
    row_max = torch.full((B,), -1, dtype=torch.long, device=qp.device)
    row_max.scatter_reduce_(0, rows.reshape(-1),
                            torch.where(valid, qp, -1).reshape(-1), "amax",
                            include_self=True)
    keep = valid & (qp > row_max[rows] - cap)
    idx = torch.where(keep, torch.remainder(qp, cap), cap)
    kops.scatter_live([(cache["k"], k_new), (cache["v"], v_new)],
                      (rows, idx.clamp(0, cap - 1)), keep)
    return keep, idx


def _update_slen(slen, rows, q_pos, valid):
    """``slen[row] = max(slen[row], q_pos + 1)`` over the valid tokens, in
    place (duplicate rows take the max)."""
    slen.scatter_reduce_(
        0, rows.reshape(-1),
        torch.where(valid, q_pos + 1, 0).reshape(-1).to(slen.dtype), "amax",
        include_self=True)


def paged_attention_step(params, cfg: AttnCfg, x, cache, q_pos, valid, *,
                         flash_decode: bool = False):
    """One step of the two-phase serving path against the layer's serving
    cache: writes the C incoming tokens of each slot, then attends over
    everything written so far.

    x: (B, C, D) — C == 1 is a decode tick, C > 1 a prefill chunk; q_pos:
    (B, C) absolute positions (per slot); valid: (B, C) marks real tokens
    (invalid rows and tails write nothing and their outputs are ignored by
    the engine).  A global layer's decode tick with ``flash_decode`` goes
    through the paged flash-decode kernel (``kernels.ops.paged_flash_decode``)
    over every slot's ``slen``; every other step, prefill chunks included,
    gathers the slots' block-table context, as in JAX.  A windowed layer
    writes into its circular buffers and attends over them.  Returns (out
    (B, C, D), cache) with the cache updated in place."""
    B, C, _ = x.shape
    q = _project_q(params, cfg, x)  # (B,C,kvH,G,hd)
    k_new, v_new = _project_kv(params, cfg, x)  # (B,C,kvH,hd)
    if cfg.rope_theta is not None:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k_new = apply_rope(k_new, q_pos, cfg.rope_theta)

    rows = torch.arange(B, device=x.device)[:, None].expand(B, C)
    if "kp" not in cache:  # windowed: per-slot circular buffers
        keep, idx = _write_window(cache, rows, q_pos, valid, k_new, v_new)
        _write_kpos(cache["kpos"], rows, idx, q_pos, keep)
        _update_slen(cache["slen"], rows, q_pos, valid)
        o = _paged_masked_attn(q, cache["k"], cache["v"], cache["kpos"],
                               q_pos, cfg.window)
        return _out_proj_replicated(params, cfg, o), cache

    qp = q_pos.long()
    P = cache["kp"].shape[1]
    n_pages = cache["kp"].shape[0]
    pps = cache["ptab"].shape[-1]
    page_slot = torch.clamp(torch.div(qp, P, rounding_mode="floor"), 0, pps - 1)
    page = torch.gather(cache["ptab"].long(), 1, page_slot)  # (B,C)
    page = torch.where(valid, page, n_pages)  # sentinel: write dropped
    off = torch.remainder(qp, P)
    _scatter_paged_kv(cache, k_new, v_new, page, off)
    T = pps * P
    _write_kpos(cache["kpos"], rows, qp, q_pos, valid)
    _update_slen(cache["slen"], rows, q_pos, valid)

    if flash_decode and C == 1:
        o = kops.paged_flash_decode(q[:, 0].contiguous(), cache["kp"],
                                    cache["vp"], cache["ptab"], cache["slen"],
                                    ks=cache.get("ks"), vs=cache.get("vs"))
        return _out_proj_replicated(params, cfg, o[:, None]), cache

    k, v = _gather_paged_kv(cache, q.dtype)
    kvH, hd = cfg.num_kv_heads, cfg.head_dim
    o = _paged_masked_attn(q, k.reshape(B, T, kvH, hd), v.reshape(B, T, kvH, hd),
                           cache["kpos"], q_pos, cfg.window)
    return _out_proj_replicated(params, cfg, o), cache


def _ragged_window_attn(q, k, v, kpos, slot, q_pos, window):
    """Ragged-pack attention over per-slot circular buffers: q (T,kvH,G,hd)
    against k/v (B,cap,kvH,hd) with kpos (B,cap) -> (T,kvH,G,hd).  Each
    token scores against every slot's buffer and keeps only its own slot's
    live, causal, in-window entries: JAX's ``_paged_masked_attn`` over a
    gathered (T, cap) copy of each token's slot buffer, without the copy
    (masked entries weigh exactly 0).  A token with no visible entry gets
    zeros, as in JAX."""
    T = q.shape[0]
    B, cap, kvH, hd = k.shape
    s = torch.einsum("tkgd,nkd->tkgn", q, k.reshape(B * cap, kvH, hd))
    s = s.float() * hd ** -0.5  # (T,kvH,G,B*cap)
    qp = q_pos.long()[:, None, None]
    kp = kpos.long()[None]
    ok = ((slot.long()[:, None, None]
           == torch.arange(B, device=q.device)[None, :, None])
          & (kp >= 0) & (kp <= qp))
    if window is not None:
        ok &= (qp - kp) < window
    ok = ok.reshape(T, 1, 1, B * cap)
    p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1).to(q.dtype)
    p = torch.where(ok, p, 0.0)
    return torch.einsum("tkgn,nkd->tkgd", p, v.reshape(B * cap, kvH, hd))


def ragged_attention_step(params, cfg: AttnCfg, x, cache, slot, q_pos, valid,
                          *, flash_decode: bool = False):
    """One ragged serving step: a flat pack of T tokens from any slots.

    x: (1, T, D) hidden pack; slot/q_pos/valid: (T,) per-token slot index,
    absolute position and validity.  A global layer writes the pack's K/V
    into the pool, then attends: with ``flash_decode`` through the ragged
    paged kernel (``kernels.ops.ragged_paged_flash``), otherwise through a
    gather of every token's slot context.  A windowed layer writes into its
    per-slot circular buffers and attends over them
    (``_ragged_window_attn``) on either route, as JAX computes it outside
    its kernel.  Returns (out (1, T, D), cache) with the cache updated in
    place."""
    q = _project_q(params, cfg, x)[0]  # (T,kvH,G,hd)
    k_new, v_new = (t[0] for t in _project_kv(params, cfg, x))  # (T,kvH,hd)
    if cfg.rope_theta is not None:
        q = apply_rope(q[None], q_pos[None], cfg.rope_theta)[0]
        k_new = apply_rope(k_new[None], q_pos[None], cfg.rope_theta)[0]

    sl, qp = slot.long(), q_pos.long()
    B = cache["slen"].shape[0]
    if "kp" not in cache:  # windowed: per-slot circular buffers
        keep, idx = _write_window(cache, sl, q_pos, valid, k_new, v_new)
        _write_kpos(cache["kpos"], sl, idx, q_pos, keep)
        _update_slen(cache["slen"], sl, q_pos, valid)
        o = _ragged_window_attn(q, cache["k"], cache["v"], cache["kpos"], slot,
                                q_pos, cfg.window)
        return _out_proj_replicated(params, cfg, o[None]), cache

    P = cache["kp"].shape[1]
    n_pages = cache["kp"].shape[0]
    pps = cache["ptab"].shape[-1]
    page_slot = torch.clamp(torch.div(qp, P, rounding_mode="floor"), 0, pps - 1)
    page = cache["ptab"][sl, page_slot].long()
    page = torch.where(valid, page, n_pages)  # sentinel: write dropped
    off = torch.remainder(qp, P)
    _scatter_paged_kv(cache, k_new, v_new, page, off)
    Tc = pps * P
    _write_kpos(cache["kpos"], sl, qp, q_pos, valid)
    _update_slen(cache["slen"], sl, q_pos, valid)

    if flash_decode:
        lens = torch.where(valid, q_pos + 1, 0).to(torch.int32)
        o = kops.ragged_paged_flash(q, cache["kp"], cache["vp"], cache["ptab"],
                                    slot.to(torch.int32), lens,
                                    ks=cache.get("ks"), vs=cache.get("vs"))
        return _out_proj_replicated(params, cfg, o[None]), cache

    k_all, v_all = _gather_paged_kv(cache, q.dtype)
    kvH, hd = cfg.num_kv_heads, cfg.head_dim
    k_tok = k_all.reshape(B, Tc, kvH, hd)[sl]  # (T,Tc,kvH,hd)
    v_tok = v_all.reshape(B, Tc, kvH, hd)[sl]
    o = _paged_masked_attn(q[:, None], k_tok, v_tok, cache["kpos"][sl],
                           q_pos[:, None], cfg.window)  # (T,1,kvH,G,hd)
    return _out_proj_replicated(params, cfg, o.transpose(0, 1)), cache


# ---------------------------------------------------------------------------
# Lock-step decode (the reference engine's cache: one position for the whole
# batch)


def init_cache(cfg: AttnCfg, batch: int, max_len: int, dtype, *,
               layers: int = 1, device=None):
    """Lock-step decode cache of one attention layer, stacked over
    ``layers``: k/v (B, cap, kvH, hd) with ``cap = min(window, max_len)``
    (a circular buffer for windowed layers), the SHARED absolute position
    of each buffer entry ``k_pos`` (cap,) (-1 = never written) and the
    next position ``pos``, a scalar per layer."""
    cap = max_len if cfg.window is None else min(cfg.window, max_len)
    L = (layers,)
    kvH, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros(L + (batch, cap, kvH, hd), dtype=dtype, device=device),
        "v": torch.zeros(L + (batch, cap, kvH, hd), dtype=dtype, device=device),
        "k_pos": torch.full(L + (cap,), -1, dtype=torch.int32, device=device),
        "pos": torch.zeros(L, dtype=torch.int32, device=device),
    }


def init_cross_cache(params, cfg: AttnCfg, enc):
    """A cross-attention layer's lock-step cache: {"k", "v"} (B, T, kvH,
    hd), ``enc`` (B, T, D) projected by the layer's weights (``params``
    one layer's)."""
    k, v = _project_kv(params, cfg, enc)
    return {"k": k, "v": v}


def prefill_cache(params, cfg: AttnCfg, cache, x, positions):
    """Write a whole prompt x (B, S, D) at ``positions`` (S,) into one
    layer's lock-step cache (views of that layer), in place.  When S >= cap
    (a windowed layer) only the last ``cap`` positions are kept, each at
    ``position % cap`` of a zeroed buffer; otherwise the prompt lands at
    entries [0, S).  ``pos`` becomes S."""
    k, v = _project_kv(params, cfg, x)
    if cfg.rope_theta is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    S = x.shape[1]
    cap = cache["k"].shape[1]
    if S >= cap:
        kp = positions[-cap:]
        slots = torch.remainder(kp, cap).long()
        for name, new in (("k", k[:, -cap:]), ("v", v[:, -cap:])):
            cache[name].zero_()
            cache[name].index_copy_(1, slots, new.to(cache[name].dtype))
        cache["k_pos"].fill_(-1)
        cache["k_pos"].index_copy_(0, slots, kp.to(cache["k_pos"].dtype))
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["k_pos"][:S] = positions
    cache["pos"].fill_(S)
    return cache


def attention_decode(params, cfg: AttnCfg, x, cache, *, sp_decode: bool = False):
    """One lock-step decode token for the whole batch: x (B, 1, D) at the
    layer's ``pos``.  Writes its K/V at entry ``pos % cap`` and that entry's
    ``k_pos``, advances ``pos`` (all in place, with tensor indices), then
    attends over the buffer with the causal and window mask.  A
    cross-attention layer attends over its cache's projected encoder K/V
    with a zero bias over all T entries and leaves the cache as it is.
    Returns (out (B, 1, D), cache).  ``sp_decode`` (sequence-sharded
    decode over a mesh) raises ``NotImplementedError``."""
    if sp_decode and not cfg.cross:
        raise NotImplementedError(
            "sequence-parallel decode (sp_decode) is not ported yet: it comes "
            "with multi-GPU serving (ROADMAP.md, Queue 1)")
    q = _project_q(params, cfg, x)  # (B,1,kvH,G,hd)
    if cfg.cross:
        bias = torch.zeros((1, cache["k"].shape[1]), device=x.device)
        return _out_proj(params, cfg, _softmax_attn(q, cache["k"], cache["v"],
                                                    bias)), cache
    pos = cache["pos"].reshape(1).clone()  # this token's position
    k_new, v_new = _project_kv(params, cfg, x)  # (B,1,kvH,hd)
    if cfg.rope_theta is not None:
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    cap = cache["k"].shape[1]
    slot = torch.remainder(pos, cap).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    cache["k_pos"].index_copy_(0, slot, pos.to(cache["k_pos"].dtype))
    cache["pos"].add_(1)
    bias = _mask_bias(pos, cache["k_pos"], True, cfg.window)
    o = _softmax_attn(q, cache["k"], cache["v"], bias)
    return _out_proj(params, cfg, o), cache

"""Token embeddings, the output head, RoPE, sinusoidal positions and the
modality-frontend stubs.

Counterpart of ``repro.models.layers.embeddings``.  The audio and vision
frontends are stubs, as in JAX: their inputs are precomputed frame or
patch features (B, S, d_model/2), and ``frontend_proj`` maps them into
d_model.  In the serving layout
the embedding table is stored in the activation dtype once at load
(``models.model.init_params``, ``bridge.params_from_numpy``), so the
``.to(dtype)`` below is a no-op there; JAX casts the float32 table at every
use, which gives the same values, and so does the training layout.

Under the train step's 'model' split (JAX's "vocab" and "act_vocab") a
rank's working copy of ``tok_embed`` is its rows of the vocabulary and of
``out_head`` its columns (``parallel.sharding.model_part``): the lookup
masks the ids outside the rank's rows and sums the ranks' rows over
'model', and the head gives the rank's columns of the logits, tied or
untied (``models.model._xent`` takes the cross entropy over them).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers.common import dense_init
from repro_torch.parallel.sharding import (copy_to_model, model_part,
                                           reduce_from_model)


def embed_tokens(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    w = params["tok_embed"]
    part = model_part(w)
    if part is None:
        return w.to(dtype)[tokens]
    rows = w.shape[0]  # the rank's V/N rows: ids outside them look up 0
    local = tokens - part.coord * rows
    inside = (local >= 0) & (local < rows)
    out = w.to(dtype)[torch.where(inside, local, 0)]
    return reduce_from_model(torch.where(inside[..., None], out, 0), part)


def logits_from_hidden(params, h: torch.Tensor, *, tied_embed=None):
    """(..., D) -> (..., V); tied heads multiply by ``tok_embed.T``.  Under
    the 'model' split, (..., V/N): the rank's columns."""
    w = tied_embed if tied_embed is not None else params["out_head"]
    part = model_part(w)
    if part is not None:
        h = copy_to_model(h, part)
    w = w.to(h.dtype)
    return h @ (w.t() if tied_embed is not None else w)


def init_frontend(generator, d_in: int, d: int, *, device=None):
    """Modality frontend stub: one linear projection (d_in, d), float32."""
    return {"frontend_proj": dense_init(generator, (d_in, d), device=device)}


def apply_frontend(params, feats: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, d_in) features -> (B, S, d) in ``dtype``: both operands cast
    to ``dtype`` before the product, as JAX's einsum takes them."""
    return feats.to(dtype) @ params["frontend_proj"].to(dtype)


def sinusoidal_pos(seq_len: int, d: int, dtype, offset=0, device=None):
    """(seq_len, d) encodings of positions ``offset .. offset+seq_len-1``;
    ``offset`` may be a 0-d tensor (the lock-step decode's ``pos``)."""
    pos = torch.arange(seq_len, device=device) + offset
    return sinusoidal_at(pos, d, dtype)


def sinusoidal_at(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Sinusoidal encodings at explicit positions: (S,) or (B, S) ints ->
    (S, d) or (B, S, d) in ``dtype``, [sin | cos] halves.  The frequencies
    are float32 ``exp(-log(1e4) * arange(half) / half)`` and the angles
    float32, as JAX computes them; the cast to ``dtype`` comes last."""
    half = d // 2
    dev = positions.device
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=dev))
    freqs = torch.exp(-log_base * torch.arange(half, device=dev) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, *head_axes, hd); positions: (S,) shared across the batch,
    or (B, S) per row.  Split-half layout (the first and second halves of
    the head dim rotate together, not interleaved pairs), float32 angles —
    as ``repro.models.layers.embeddings.apply_rope``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    lead = (1,) if positions.ndim == 1 else (x.shape[0],)
    shape = lead + (x.shape[1],) + (1,) * (x.ndim - 3) + (hd // 2,)
    cos = torch.cos(ang).reshape(shape)
    sin = torch.sin(ang).reshape(shape)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

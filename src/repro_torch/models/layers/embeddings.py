"""Token embeddings, the tied output head, and RoPE.

Counterpart of ``repro.models.layers.embeddings``.  In the serving layout
the embedding table is stored in the activation dtype once at load
(``models.model.init_params``, ``bridge.params_from_numpy``), so the
``.to(dtype)`` below is a no-op there; JAX casts the float32 table at every
use, which gives the same values, and so does the training layout.
"""
from __future__ import annotations

import torch


def embed_tokens(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["tok_embed"].to(dtype)[tokens]


def logits_from_hidden(params, h: torch.Tensor, *, tied_embed=None):
    """(..., D) -> (..., V); tied heads multiply by ``tok_embed.T``."""
    if tied_embed is not None:
        w = tied_embed.to(h.dtype).t()
    else:
        w = params["out_head"].to(h.dtype)
    return h @ w


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

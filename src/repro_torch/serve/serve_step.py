"""The serving step builders of the engine.

Counterpart of ``repro.serve.serve_step.make_ragged_step``: the ragged
engine's one step over a flat (T,) token pack in which every entry carries
its own (slot, position, validity), so any mix of prefill-chunk and decode
tokens runs through the same code.  ``make_paged_step`` builds the two
steps of the two-phase path (``ragged=False``), which the JAX engine builds
inline around ``models.model.paged_step``.  JAX jits it with the state donated; here it
runs eagerly and updates the state's tensors in place, which is what
keeps the pools at fixed addresses.  Capturing it in a CUDA graph is left
for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import model as M


def make_ragged_step(cfg: ModelCfg, *, width: int, flash_decode: bool = False):
    """Build ``f(params, state, tokens, slot, q_pos, seq_idx, valid,
    logit_idx) -> (logits (B, V), state)`` with all pack vectors (T,) and
    ``logit_idx`` (B,), tensors on the params' device
    (see ``models.model.ragged_step``)."""

    @torch.no_grad()
    def ragged_step(params, state, tokens, slot, q_pos, seq_idx, valid,
                    logit_idx):
        return M.ragged_step(params, cfg, state, tokens, slot, q_pos,
                             seq_idx, valid, logit_idx, width=width,
                             flash_decode=flash_decode)

    return ragged_step


def make_paged_step(cfg: ModelCfg, *, with_logits: bool,
                    flash_decode: bool = False):
    """Build ``f(params, state, tokens, q_pos, valid) -> (logits, state)``
    with (B, C) tensors on the params' device (see
    ``models.model.paged_step``): ``with_logits=False`` for the prefill
    chunk, True for the decode tick."""

    @torch.no_grad()
    def paged_step(params, state, tokens, q_pos, valid):
        return M.paged_step(params, cfg, state, tokens, q_pos, valid,
                            with_logits=with_logits,
                            flash_decode=flash_decode)

    return paged_step

"""The lock-step reference engine, on PyTorch.

Counterpart of ``repro.serve.reference``: the seed serving engine the JAX
package keeps as the correctness baseline of the paged engines.  Prompts
are prefilled one slot at a time with batch-1 forwards
(``models.model.prefill``), every slot pays ``cache_len`` of KV (a window
for windowed layers), and positions are lock-step across slots: each
layer's ``k_pos`` and ``pos`` are shared by the batch, so only an
equal-length wave of prompts decodes correctly.  Greedy only.

Its semantics are JAX's, including the part JAX documents as wrong, so that
transcripts match token for token (``_write_slot``): a slot's batch-1 state
replaces the shared ``k_pos`` of every layer, a scalar position takes the
maximum of the pooled and the batch-1 one, and on slot reuse a later wave
decodes from what those rules leave.  The decode step runs eagerly, on the
params' device.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.models import model as M
from repro_torch.serve.handle import Request


class ReferenceEngine:
    def __init__(self, params: M.Model, cfg: ModelCfg, *, batch_size: int = 4,
                 cache_len: int = 256, greedy: bool = True, device=None):
        self.device = resolve_device(device)
        M.check_servable(cfg)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.B = batch_size
        self.cache_len = cache_len
        self._decode = lambda p, s, t: M.decode_step(p, cfg, s, t)
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * batch_size
        self._uid = 0

    def submit(self, prompt, max_tokens: int = 16, eos_id=None) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  max_tokens, eos_id))
        return self._uid

    # -- internals --------------------------------------------------------
    def _fill_slots(self, state, last_tok: np.ndarray):
        """Prefill queued requests into free slots, one at a time: each a
        batch-1 forward into a fresh batch-1 state, copied into its slot
        (``_write_slot``)."""
        for b in range(self.B):
            if self.slots[b] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            self.slots[b] = req
            one = M.init_decode_state(self.params, self.cfg, 1, self.cache_len)
            M.prefill(self.params, self.cfg, one,
                      torch.from_numpy(req.prompt[None, :]).to(self.device))
            _write_slot(self.cfg, state, one, b)
            last_tok[b, 0] = int(req.prompt[-1])
        return state

    def run(self, max_ticks: int = 256) -> Dict[int, List[int]]:
        """Drain the queue; returns {uid: generated tokens}."""
        state = M.init_decode_state(self.params, self.cfg, self.B,
                                    self.cache_len)
        last_tok = np.zeros((self.B, 1), np.int32)
        results: Dict[int, List[int]] = {}
        for _ in range(max_ticks):
            if all(s is None for s in self.slots) and not self.queue:
                break
            state = self._fill_slots(state, last_tok)
            logits, state = self._decode(
                self.params, state, torch.from_numpy(last_tok).to(self.device))
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            for b, req in enumerate(self.slots):
                if req is None:
                    continue
                tok = int(nxt[b])
                req.out_tokens.append(tok)
                if (len(req.out_tokens) >= req.max_tokens
                        or (req.eos_id is not None and tok == req.eos_id)):
                    results[req.uid] = req.out_tokens
                    self.slots[b] = None
                else:
                    last_tok[b, 0] = tok
        for req in self.slots:  # drain partials on tick budget exhaustion
            if req is not None:
                results[req.uid] = req.out_tokens
        return results


def _write_slot(cfg: ModelCfg, state, one, b: int) -> None:
    """Copy a batch-1 decode state ``one`` into slot ``b`` of the pooled
    state, in place, by JAX's rules on JAX's leaf shapes (a ``repeats ==
    1`` stage's leaves lack the port's leading layer axis there):

    - a scalar leaf (the top-level "pos", and each layer's "pos" in a
      ``repeats == 1`` stage) takes the maximum of the two: the lock-step
      position;
    - "k_pos" (shared by the batch) is replaced by the batch-1 state's;
    - any other leaf — a cache's k/v, a recurrent layer's state — is
      written at ``b`` along its batch axis, the first
      axis whose size differs between the two; where none differs (at
      ``batch_size == 1``, or a stacked stage's per-layer "pos") the leaf
      is replaced whole."""
    state["pos"].copy_(torch.maximum(state["pos"], one["pos"]))
    for st, ss, so in zip(cfg.stages, state["layers"], one["layers"]):
        lead = 1 if st.repeats == 1 else 0  # the port's extra layer axis
        for pooled, single in zip(ss, so):
            for name, pl in pooled.items():
                sl = single[name]
                if pl.ndim == lead:  # a scalar in JAX's layout
                    pl.copy_(torch.maximum(pl, sl))
                elif name == "k_pos":
                    pl.copy_(sl)
                else:
                    axis = next((i for i, (a, c) in enumerate(
                        zip(pl.shape[lead:], sl.shape[lead:])) if a != c), None)
                    if axis is None:
                        pl.copy_(sl)
                    else:
                        pl.narrow(axis + lead, b, 1).copy_(sl)

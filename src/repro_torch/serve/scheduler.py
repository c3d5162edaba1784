"""Scheduler — the serving stack's pluggable workload-policy layer.

The part of ``repro.serve.scheduler`` this slice ports: the read-only
``EngineView`` a policy sees, the ``Scheduler`` protocol with its neutral
(identity) orderings, and ``FifoScheduler`` — strict arrival-order
admission and slot-index pack order, the JAX engine's default.  A policy
returns ORDERINGS only; the engine keeps all mechanism (feasibility,
page reservation, chunking, budget accounting), so admission still stops at
the first infeasible candidate and every decoding slot packs one token per
tick.

Speculative decoding's drafter and wrapper are here too:
``prompt_lookup_draft`` (prompt lookup over a slot's own history, no second
model) and ``SpeculativeScheduler``, which delegates every ordering to its
inner policy and adds ``draft``.  The reordering policies (prefix-aware,
slo, class-then-family) come with a later slice; ``make_scheduler`` raises
``NotImplementedError`` for their names.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.handle import Request


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Read-only snapshot the engine hands a scheduler each consultation.

    ``queue``/``slot_requests`` reference live ``Request`` objects —
    schedulers must treat them as immutable.  ``match_len`` gives the
    tokens of a prompt covered by indexed full pages, probed without
    touching LRU state; ``match_split`` splits the same tokens (device,
    host).  The reordering policies that read them, and the pool probes
    behind them, come with the scheduler slice.  For
    ``decode_order``/``prefill_order`` consultations ``queue`` is empty:
    packing is a slots concern."""

    queue: Tuple[Request, ...]
    slot_requests: Tuple[Optional[Request], ...]  # None = free slot
    slot_fill: Tuple[int, ...]  # prompt tokens already in cache, per slot
    budget: int
    chunk: int
    page_size: int
    match_len: Callable[[np.ndarray], int]
    match_split: Optional[Callable[[np.ndarray], Tuple[int, int]]] = None


class Scheduler:
    """Protocol + neutral defaults (identity orderings == FIFO).

    ``admission_order`` returns indices into ``view.queue``;
    ``decode_order``/``prefill_order`` reorder the slot-id lists the engine
    computed; ``preempt_order`` ranks victim slots (consulted only by the
    preemption path of a later slice)."""

    name = "scheduler"

    def admission_order(self, view: EngineView) -> Sequence[int]:
        return range(len(view.queue))

    def decode_order(self, view: EngineView,
                     ready: Sequence[int]) -> Sequence[int]:
        return ready

    def prefill_order(self, view: EngineView,
                      filling: Sequence[int]) -> Sequence[int]:
        return filling

    def preempt_order(self, view: EngineView,
                      victims: Sequence[int]) -> Sequence[int]:
        """Lowest ``Request.priority`` first, youngest (highest uid) within
        a class."""
        return sorted(victims,
                      key=lambda b: (view.slot_requests[b].priority,
                                     -view.slot_requests[b].uid))


class FifoScheduler(Scheduler):
    """Strict arrival-order admission, slot-index pack order (the identity
    policy)."""

    name = "fifo"


def prompt_lookup_draft(history, k: int, *, ngram_max: int = 3,
                        ngram_min: int = 1) -> List[int]:
    """Up to ``k`` continuation tokens for ``history`` (a slot's prompt and
    emitted output, 1-D ints) by prompt lookup: the longest tail n-gram
    (``ngram_max`` down to ``ngram_min`` tokens) that also occurs earlier in
    the history, continued as after its LATEST earlier occurrence.  [] when
    nothing repeats: the engine then packs no draft for the slot."""
    h = np.asarray(history, dtype=np.int64).ravel()
    n = h.size
    if k < 1 or n < ngram_min + 1:
        return []
    for g in range(min(ngram_max, n - 1), ngram_min - 1, -1):
        tail = h[n - g:]
        win = np.lib.stride_tricks.sliding_window_view(h[:-1], g)
        hits = np.flatnonzero((win == tail).all(axis=1))
        # latest first; a match whose continuation is empty does not count
        for i in hits[::-1]:
            cont = h[i + g:i + g + k]
            if cont.size:
                return [int(t) for t in cont]
    return []


class SpeculativeScheduler(Scheduler):
    """Speculative drafting over any ported policy: orderings delegate to
    ``inner`` verbatim, and ``draft`` supplies a slot's prompt-lookup chain
    of at most ``spec_k`` tokens, which the engine packs into the budget
    that decode and prefill left.  ``inner`` takes what ``make_scheduler``
    does (None -> FIFO)."""

    def __init__(self, inner=None, *, spec_k: int = 4, ngram_max: int = 3,
                 ngram_min: int = 1):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if not (1 <= ngram_min <= ngram_max):
            raise ValueError(f"bad n-gram bounds ({ngram_min=}, {ngram_max=})")
        self.inner = make_scheduler(inner)
        self.spec_k = int(spec_k)
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)
        self.name = f"speculative({self.inner.name},k={self.spec_k})"

    def admission_order(self, view: EngineView) -> Sequence[int]:
        return self.inner.admission_order(view)

    def decode_order(self, view: EngineView,
                     ready: Sequence[int]) -> Sequence[int]:
        return self.inner.decode_order(view, ready)

    def prefill_order(self, view: EngineView,
                      filling: Sequence[int]) -> Sequence[int]:
        return self.inner.prefill_order(view, filling)

    def preempt_order(self, view: EngineView,
                      victims: Sequence[int]) -> Sequence[int]:
        return self.inner.preempt_order(view, victims)

    def draft(self, history, k: int) -> List[int]:
        """One slot's draft chain: at most min(k, spec_k) tokens."""
        return prompt_lookup_draft(history, min(int(k), self.spec_k),
                                   ngram_max=self.ngram_max,
                                   ngram_min=self.ngram_min)


SCHEDULERS = {"fifo": FifoScheduler, "speculative": SpeculativeScheduler}

_LATER = ("prefix-aware", "slo", "class-then-family")


def make_scheduler(spec) -> Scheduler:
    """Resolve the engine's ``scheduler=`` argument: None or "fifo" ->
    ``FifoScheduler``, "speculative" -> ``SpeculativeScheduler`` over FIFO,
    or an object of either class.  The other policies of the JAX package
    are not ported yet and raise."""
    if spec is None:
        return FifoScheduler()
    if isinstance(spec, str):
        if spec in SCHEDULERS:
            return SCHEDULERS[spec]()
        if spec in _LATER:
            raise NotImplementedError(
                f"scheduler {spec!r} is not ported yet: the reordering "
                "policies come with the scheduler slice")
        raise ValueError(f"unknown scheduler {spec!r} "
                         f"(pick from {sorted(SCHEDULERS)})")
    if not isinstance(spec, (FifoScheduler, SpeculativeScheduler)):
        raise NotImplementedError(
            f"scheduler {spec!r} is not ported yet: only FIFO and the "
            "speculative wrapper are ported; the other policies come with "
            "the scheduler slice")
    return spec

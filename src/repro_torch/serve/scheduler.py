"""Scheduler — the serving stack's pluggable workload-policy layer.

The part of ``repro.serve.scheduler`` this slice ports: the read-only
``EngineView`` a policy sees, the ``Scheduler`` protocol with its neutral
(identity) orderings, and ``FifoScheduler`` — strict arrival-order
admission and slot-index pack order, the JAX engine's default.  A policy
returns ORDERINGS only; the engine keeps all mechanism (feasibility,
page reservation, chunking, budget accounting), so admission still stops at
the first infeasible candidate and every decoding slot packs one token per
tick.

The reordering policies (prefix-aware, slo, class-then-family) and the
speculative wrapper come with a later slice; ``make_scheduler`` raises
``NotImplementedError`` for their names.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

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


SCHEDULERS = {"fifo": FifoScheduler}

_LATER = ("prefix-aware", "slo", "class-then-family", "speculative")


def make_scheduler(spec) -> Scheduler:
    """Resolve the engine's ``scheduler=`` argument: None or "fifo" ->
    ``FifoScheduler``, or a ``FifoScheduler`` object.  The other policies
    of the JAX package are not ported yet and raise."""
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
    if not isinstance(spec, FifoScheduler):
        raise NotImplementedError(
            f"scheduler {spec!r} is not ported yet: only FIFO is in this "
            "slice; the other policies come with the scheduler slice")
    return spec

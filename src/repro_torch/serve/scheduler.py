"""Scheduler — the serving stack's pluggable workload-policy layer.

A copy of ``repro.serve.scheduler`` (the port imports nothing of the JAX
package).  The pool (``serve.pool.PagePool``) and the engine's captured
step are fixed; everything workload-shaped — WHICH queued request is
admitted next, in WHAT ORDER slots contribute tokens to a tick's pack, and
WHICH running slot a preemption takes — is a policy object behind the
``Scheduler`` protocol.  A scheduler sees a read-only ``EngineView`` and
returns ORDERINGS; the engine keeps all mechanism (feasibility, page
reservation, chunking, budget accounting, parking), so two invariants hold
whatever the policy:

- **Admission stops at the first infeasible candidate**: no policy can
  cause a mid-flight OOM or strand the pool.
- **Every decoding slot packs one token per tick** (``token_budget >=
  batch_size``): reordering decides priority within the pack, never
  whether a decoder stalls.

Policies:

- ``FifoScheduler`` — strict arrival order, slot-index pack order (the
  identity policy, the engine's default).
- ``PrefixAwareScheduler`` — reorders a bounded window at the head of the
  queue by prefix family (the first full prompt page, the trie's first
  key), warm families first, so requests sharing a cached or in-flight
  prefix land in the same admission wave.
- ``SloScheduler`` — interactive (``Request.priority >= 1``) before batch
  within a bounded window, interactive prefill chunks first in the pack,
  and only batch slots as preemption victims.
- ``ClassThenFamilyScheduler`` — SLO class first, then prefix families
  within a class, tier-aware through ``EngineView.match_split`` (device
  hits before host hits before misses).
- ``SpeculativeScheduler`` — a wrapper over any of the above: orderings
  delegate verbatim, and ``draft`` proposes a slot's continuation by
  prompt lookup (``prompt_lookup_draft``) for the engine to verify.

The reordering policies share ``_BoundedReorderScheduler``'s fairness
backstop: a head of line displaced ``max_bypass`` times (overtaken, or
stuck behind a proposal that admits nobody) pins strict-FIFO rounds until
it admits.  ``preempt_order`` ranks victims: lowest priority, then
youngest, by default.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.handle import Request


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Read-only snapshot the engine hands a scheduler each consultation.

    ``queue``/``slot_requests`` reference live ``Request`` objects —
    schedulers must treat them as immutable.  ``match_len`` is
    ``PagePool.probe_prefix_len``: tokens of a prompt covered by indexed
    full pages, probed WITHOUT mutating LRU state.  ``match_split`` is the
    tier-aware refinement (``PagePool.probe_prefix_split``): the same
    tokens split (device, host) — a device hit is free, a host hit costs a
    promotion copy, a miss costs re-prefill — so policies can rank the
    three candidate classes warm > host-warm > cold.  ``None`` when the
    caller gives none (policies fall back to ``match_len``).

    For ``decode_order``/``prefill_order`` consultations ``queue`` is
    EMPTY: pack ordering is a slots concern, and snapshotting a deep
    backlog every tick would tax the hot loop for nothing.  The full queue
    is present for ``admission_order``."""

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

    Subclass and override any subset; returned orderings may be lazy
    sequences.  ``admission_order`` returns indices into ``view.queue``
    (a permutation prefix is fine — omitted indices just wait);
    ``decode_order``/``prefill_order`` reorder the slot-id lists the engine
    computed (return them unchanged for slot-index order)."""

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
        """Rank candidate victim slots for preemption (best victim first);
        return a subsequence to EXEMPT slots (an omitted slot is never
        victimized).  Default: lowest ``Request.priority`` first, youngest
        (highest uid) within a class — cheap work lost, old work kept."""
        return sorted(victims,
                      key=lambda b: (view.slot_requests[b].priority,
                                     -view.slot_requests[b].uid))


class FifoScheduler(Scheduler):
    """Strict arrival-order admission, slot-index pack order (the identity
    policy)."""

    name = "fifo"


class _BoundedReorderScheduler(Scheduler):
    """Shared fairness bookkeeping for window-reordering policies.

    Subclasses implement ``_reorder(view)`` (any permutation of the queue
    indices that leaves order beyond ``depth`` untouched); this base
    guarantees the head of line waits at most ``max_bypass`` rounds of
    EITHER kind of displacement before strict-FIFO rounds pin it to the
    front:

    - **overtakes** — some request the proposal ranked ahead of the head
      left the queue by the next consultation (admitted past it; a
      cancellation is miscounted — conservative and rare);
    - **stalls** — consecutive proposal rounds in which nobody was
      admitted at all.  Counting these is what makes the bound a LIVENESS
      guarantee: admission stops at the first infeasible candidate, so a
      reorder that ranks an infeasible request ahead of a feasible head
      would otherwise block the head indefinitely on an identical,
      never-progressing proposal.  An overtake (real progress) resets the
      stall count, so interleaved progress keeps the policy reordering.

    Both budgets refresh when the head is admitted (the head changes), so
    the backstop degrades a round to FIFO, never the policy."""

    def __init__(self, depth: int, max_bypass: int):
        if depth < 1 or max_bypass < 1:
            raise ValueError(f"bad bounds ({depth=}, {max_bypass=})")
        self.depth = depth
        self.max_bypass = max_bypass
        self._head_uid = None  # current head of line...
        self._overtakes = 0  # ...how often it was actually bypassed...
        self._stalls = 0  # ...and consecutive no-progress proposals
        self._proposed: Optional[frozenset] = None  # other uids at proposal

    def _reorder(self, view: EngineView) -> List[int]:
        raise NotImplementedError

    def admission_order(self, view: EngineView) -> Sequence[int]:
        q = view.queue
        if not q:
            return ()
        if q[0].uid != self._head_uid:
            # head admitted (or cancelled): fresh budget for the new head
            self._head_uid = q[0].uid
            self._overtakes = self._stalls = 0
            self._proposed = None
        elif self._proposed is not None:
            live = {r.uid for r in q}
            if any(u not in live for u in self._proposed):
                self._overtakes += 1
                self._stalls = 0
            else:
                self._stalls += 1
            self._proposed = None
        if max(self._overtakes, self._stalls) >= self.max_bypass:
            return range(len(q))  # fairness backstop: strict FIFO rounds
            # until this head finally admits (then the head change resets)
        order = self._reorder(view)
        if order and order[0] != 0:
            self._proposed = frozenset(r.uid for r in q[1:])
        return order


def _family_order(view: EngineView, idxs: Sequence[int]) -> List[int]:
    """Order queue indices ``idxs`` by shared-prefix family — the policy
    core the prefix-aware and class-then-family schedulers share.

    Family key = the trie's first key (first FULL prompt page; sub-page
    prompts can never share pages -> singleton families).  Families rank
    warmest-first so a resident prefix is reused before eviction pressure
    reclaims it, and with a tiered pool (``view.match_split``) DEVICE
    residency outranks HOST residency: a device hit is free, a host hit
    pays one promotion copy — warm > host-warm > cold, the three candidate
    classes of tiered admission.  Ties break FIFO by earliest member, and
    members stay in FIFO order within their family."""
    q, P = view.queue, view.page_size

    def family(r: Request):
        return (tuple(int(t) for t in r.prompt[:P])
                if len(r.prompt) >= P else ("solo", r.uid))

    def warmth(i: int) -> Tuple[int, int]:
        if view.match_split is not None:
            return view.match_split(q[i].prompt)
        return view.match_len(q[i].prompt), 0

    groups: Dict[tuple, List[int]] = {}
    for i in idxs:
        groups.setdefault(family(q[i]), []).append(i)
    ranked = sorted(groups.values(),
                    key=lambda g: (-max(warmth(i)[0] for i in g),
                                   -max(warmth(i)[1] for i in g), g[0]))
    return [i for g in ranked for i in g]


class PrefixAwareScheduler(_BoundedReorderScheduler):
    """Group the admission window by shared-prefix family (see module
    docstring and ``_family_order``).  ``depth`` bounds reordering;
    ``max_bypass`` bounds how many times the head of line can actually be
    overtaken."""

    name = "prefix-aware"

    def __init__(self, depth: int = 8, max_bypass: int = 4):
        super().__init__(depth, max_bypass)

    def _reorder(self, view: EngineView) -> List[int]:
        q = view.queue
        D = min(self.depth, len(q))
        return _family_order(view, range(D)) + list(range(D, len(q)))


class SloScheduler(_BoundedReorderScheduler):
    """Interactive-first admission and prefill packing by
    ``Request.priority`` (stable within a class, so each class is FIFO).
    ``depth`` bounds how far an interactive arrival may jump the admission
    queue; ``max_bypass`` bounds how many times a batch head of line can
    actually be jumped (the shared backstop — a saturating interactive
    stream may otherwise keep refilling the window).  ``decode_order`` is
    deliberately NOT overridden: every ready slot packs one decode token
    per tick whatever the order (engine invariant), so reordering there
    would change nothing but cost the hot loop a per-tick view."""

    name = "slo"

    def __init__(self, depth: int = 16, max_bypass: int = 4):
        super().__init__(depth, max_bypass)

    def _reorder(self, view: EngineView) -> List[int]:
        q = view.queue
        D = min(self.depth, len(q))
        window = sorted(range(D), key=lambda i: (-q[i].priority, i))
        return window + list(range(D, len(q)))

    def prefill_order(self, view: EngineView,
                      filling: Sequence[int]) -> Sequence[int]:
        return sorted(filling,
                      key=lambda b: (-view.slot_requests[b].priority, b))

    def preempt_order(self, view: EngineView,
                      victims: Sequence[int]) -> Sequence[int]:
        """Batch slots only, youngest first — the interactive class
        (priority >= 1) is NEVER victimized: preempting it would trade the
        latency SLO this policy exists to protect for batch throughput."""
        batch = [b for b in victims if view.slot_requests[b].priority < 1]
        return sorted(batch, key=lambda b: (view.slot_requests[b].priority,
                                            -view.slot_requests[b].uid))


class ClassThenFamilyScheduler(_BoundedReorderScheduler):
    """Composite policy: SLO class FIRST, prefix-family grouping WITHIN a
    class: ``slo × prefix-aware``.

    Admission partitions the window by ``Request.priority`` (higher class
    first, exactly SloScheduler's axis), then orders each class by
    ``_family_order`` — so an interactive arrival still never queues behind
    a batch prefill, while siblings of one shared prompt land in the same
    admission wave and a warm family admits before pressure reclaims its
    pages.  Tier-aware for free: ``_family_order`` reads
    ``EngineView.match_split``, so within a class device-resident families
    outrank host-resident ones outrank cold — the promotion-cost ordering
    of tiered admission.  Prefill packing is SloScheduler's
    (interactive chunks take leftover budget first); the fairness backstop
    is the shared ``_BoundedReorderScheduler`` bound."""

    name = "class-then-family"

    def __init__(self, depth: int = 16, max_bypass: int = 4):
        super().__init__(depth, max_bypass)

    def _reorder(self, view: EngineView) -> List[int]:
        q = view.queue
        D = min(self.depth, len(q))
        classes: Dict[int, List[int]] = {}
        for i in range(D):
            classes.setdefault(-q[i].priority, []).append(i)
        out: List[int] = []
        for c in sorted(classes):
            out.extend(_family_order(view, classes[c]))
        return out + list(range(D, len(q)))

    def prefill_order(self, view: EngineView,
                      filling: Sequence[int]) -> Sequence[int]:
        return sorted(filling,
                      key=lambda b: (-view.slot_requests[b].priority, b))

    def preempt_order(self, view: EngineView,
                      victims: Sequence[int]) -> Sequence[int]:
        """SloScheduler's rule: batch only, never the interactive class."""
        batch = [b for b in victims if view.slot_requests[b].priority < 1]
        return sorted(batch, key=lambda b: (view.slot_requests[b].priority,
                                            -view.slot_requests[b].uid))


def prompt_lookup_draft(history, k: int, *, ngram_max: int = 3,
                        ngram_min: int = 1) -> List[int]:
    """Propose up to ``k`` continuation tokens for ``history`` (the slot's
    prompt + emitted output, a 1-D int sequence) by prompt lookup: find the
    longest tail n-gram (``ngram_max`` down to ``ngram_min`` tokens) that
    also occurs earlier in the history, and return the tokens that followed
    its LATEST earlier occurrence.  Longer n-grams are tried first (more
    context -> higher acceptance), and among equal-length matches the most
    recent wins (recent continuations track the current phrase).  Returns
    [] when nothing repeats — the engine simply packs no drafts for the
    slot that tick, so lookup misses cost zero model work."""
    h = np.asarray(history, dtype=np.int64).ravel()
    n = h.size
    if k < 1 or n < ngram_min + 1:
        return []
    for g in range(min(ngram_max, n - 1), ngram_min - 1, -1):
        tail = h[n - g:]
        win = np.lib.stride_tricks.sliding_window_view(h[:-1], g)
        hits = np.flatnonzero((win == tail).all(axis=1))
        # scan latest-first; skip matches whose continuation is empty
        for i in hits[::-1]:
            cont = h[i + g:i + g + k]
            if cont.size:
                return [int(t) for t in cont]
    return []


class SpeculativeScheduler(Scheduler):
    """Compose speculative drafting onto any policy: orderings delegate to
    ``inner`` verbatim (so pack composition, admission fairness, and SLO
    behavior are bit-identical to the wrapped policy), and ``draft``
    supplies per-slot prompt-lookup chains of depth <= ``spec_k`` that the
    engine appends to the pack's leftover budget.  ``inner`` accepts
    anything ``make_scheduler`` does (None -> FIFO, a name, an object)."""

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
        """Draft chain for one slot: at most min(k, spec_k) tokens."""
        return prompt_lookup_draft(history, min(int(k), self.spec_k),
                                   ngram_max=self.ngram_max,
                                   ngram_min=self.ngram_min)


SCHEDULERS = {
    "fifo": FifoScheduler,
    "prefix-aware": PrefixAwareScheduler,
    "slo": SloScheduler,
    "class-then-family": ClassThenFamilyScheduler,
    "speculative": SpeculativeScheduler,
}


def make_scheduler(spec) -> Scheduler:
    """Resolve the engine's ``scheduler=`` argument: None -> FIFO, a name
    from ``SCHEDULERS``, or a ready policy object (duck-typed — anything
    with the three ordering methods)."""
    if spec is None:
        return FifoScheduler()
    if isinstance(spec, str):
        try:
            return SCHEDULERS[spec]()
        except KeyError:
            raise ValueError(f"unknown scheduler {spec!r} "
                             f"(pick from {sorted(SCHEDULERS)})") from None
    for method in ("admission_order", "decode_order", "prefill_order"):
        if not callable(getattr(spec, method, None)):
            raise TypeError(f"scheduler {spec!r} lacks {method}()")
    return spec

"""Page-lifecycle model checker: exhaustive exploration of a small-pool
twin of ``serve.pool.PagePool``.

A copy of ``repro.analysis.lifecycle`` (jax-free there too; the port keeps
its own copy, as it does of ``serve/pool.py``).  The model is held to the
port's real ``PagePool`` by ``tests/test_torch_analysis.py``, which replays
the model's op traces on a pool of the model's size.

The pool's docstring promises a lifecycle — alloc → (release) → demote →
promote → park → unpark → drop → free — and the test suite checks it
dynamically with hypothesis interleavings that must happen to reach the
bad path.  This module encodes the lifecycle as an EXPLICIT transition
system over a counting abstraction of the two-tier pool and explores the
ENTIRE reachable state space by BFS (the space is finite: a few pages, a
few host slots, refcounts capped), proving that on every reachable state:

- **no leak** — device slots are conserved: free + active + device-cached
  == n_pages, and the host tier never exceeds its capacity;
- **no double-free / negative refcount** — every counter stays in range
  and every live allocation's refcount is >= 1;
- **no parked-page eviction** — the parked population always equals the
  outstanding preempted-request park records: host eviction and cache
  storms can never touch a parked page (the preemption pinning contract).

Because the exploration is exhaustive over the abstraction, a property
that holds here holds for EVERY interleaving of the modeled operations at
this pool size — the static twin of the hypothesis properties.  The model
is deliberately a table (``DEFAULT_MODEL``: name -> (guard, apply)) so a
test can swap in a BROKEN transition (``broken_model``) and assert the
checker reports a counterexample trace for it.

Abstraction notes: pages are interchangeable, so the state tracks COUNTS
plus the multiset of live refcounts — exact for every property above
(none depends on page identity).  Refcounts cap at ``REF_CAP`` (sharing
beyond 2 adds no new transitions to the properties checked).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding

__all__ = ["PoolModel", "DEFAULT_MODEL", "broken_model", "check_lifecycle",
           "LifecycleResult"]

_RULE = "page-lifecycle"

REF_CAP = 2  # refcounts beyond 2 are bisimilar for every checked property


@dataclasses.dataclass(frozen=True)
class PoolState:
    """Counting abstraction of a two-tier pool.

    ``active`` is the sorted multiset of live allocations' refcounts; the
    other fields count entries per tier.  Device slot conservation:
    ``free + len(active) + device_cached == n_pages``.  Host occupancy:
    ``host_cached + parked <= host_slots``.  ``park_records`` counts
    preempted requests holding a park — the pinning invariant is
    ``parked == park_records`` on every reachable state."""

    free: int
    active: Tuple[int, ...]
    device_cached: int
    host_cached: int
    parked: int
    park_records: int


def _with(s: PoolState, **kw) -> PoolState:
    return dataclasses.replace(s, **kw)


def _pop_ref(active: Tuple[int, ...], ref: int) -> Tuple[int, ...]:
    out = list(active)
    out.remove(ref)
    return tuple(out)


def _push_ref(active: Tuple[int, ...], ref: int) -> Tuple[int, ...]:
    return tuple(sorted(active + (ref,)))


# -- the transition table ----------------------------------------------------
# Each op: (guard(state, n_pages, host_slots) -> bool,
#           apply(state) -> state).  Ops model PagePool's public surface at
# the lifecycle level; nondeterministic outcomes (e.g. whether a released
# page was indexed) are separate ops so BFS explores both branches.

def _ops() -> Dict[str, Tuple[Callable, Callable]]:
    return {
        # alloc: a free device page becomes a live allocation (refcount 1)
        "alloc": (
            lambda s, D, H: s.free > 0,
            lambda s: _with(s, free=s.free - 1,
                            active=_push_ref(s.active, 1))),
        # share: a prefix hit maps an existing allocation (refcount ++)
        "share": (
            lambda s, D, H: any(r < REF_CAP for r in s.active),
            lambda s: _with(s, active=_push_ref(
                _pop_ref(s.active, next(r for r in s.active
                                        if r < REF_CAP)),
                next(r for r in s.active if r < REF_CAP) + 1))),
        # release of a shared page: refcount --
        "release_shared": (
            lambda s, D, H: any(r > 1 for r in s.active),
            lambda s: _with(s, active=_push_ref(
                _pop_ref(s.active, max(s.active)), max(s.active) - 1))),
        # release of a refcount-1 UNINDEXED page: straight back to free
        "release_private": (
            lambda s, D, H: 1 in s.active,
            lambda s: _with(s, free=s.free + 1,
                            active=_pop_ref(s.active, 1))),
        # release of a refcount-1 INDEXED page: stays resident as cache
        "release_indexed": (
            lambda s, D, H: 1 in s.active,
            lambda s: _with(s, device_cached=s.device_cached + 1,
                            active=_pop_ref(s.active, 1))),
        # demote: LRU device-cached entry moves device -> host under
        # pressure; its device slot frees (needs a host slot)
        "demote": (
            lambda s, D, H: s.device_cached > 0
            and s.host_cached + s.parked < H,
            lambda s: _with(s, device_cached=s.device_cached - 1,
                            host_cached=s.host_cached + 1,
                            free=s.free + 1)),
        # drop-evict: untiered eviction (or no host room) — entry is lost
        "drop_evict": (
            lambda s, D, H: s.device_cached > 0,
            lambda s: _with(s, device_cached=s.device_cached - 1,
                            free=s.free + 1)),
        # promote: a prefix hit on a host-resident entry acquires it back
        # to the device tier as a live allocation (needs a free page)
        "promote": (
            lambda s, D, H: s.host_cached > 0 and s.free > 0,
            lambda s: _with(s, host_cached=s.host_cached - 1,
                            free=s.free - 1,
                            active=_push_ref(s.active, 1))),
        # hevict: the finite host tier drops its LRU CACHE entry to make
        # room — by construction it can only see cache entries, not parks
        "hevict": (
            lambda s, D, H: s.host_cached > 0,
            lambda s: _with(s, host_cached=s.host_cached - 1)),
        # park: preemption swaps a victim's private refcount-1 page to the
        # host tier (pinned) and records the preempted request
        "park": (
            lambda s, D, H: 1 in s.active
            and s.host_cached + s.parked < H,
            lambda s: _with(s, active=_pop_ref(s.active, 1),
                            free=s.free + 1, parked=s.parked + 1,
                            park_records=s.park_records + 1)),
        # unpark: resume promotes the parked page back into a live slot
        "unpark": (
            lambda s, D, H: s.parked > 0 and s.free > 0,
            lambda s: _with(s, parked=s.parked - 1,
                            park_records=s.park_records - 1,
                            free=s.free - 1,
                            active=_push_ref(s.active, 1))),
        # drop_parked: cancel/deadline-expiry abandons the park entirely
        "drop_parked": (
            lambda s, D, H: s.parked > 0,
            lambda s: _with(s, parked=s.parked - 1,
                            park_records=s.park_records - 1)),
        # storm: a chaos host-eviction storm clears the host CACHE tier;
        # parked pages survive by construction (the pinning contract)
        "storm": (
            lambda s, D, H: s.host_cached > 0,
            lambda s: _with(s, host_cached=0)),
    }


# -- invariants --------------------------------------------------------------

def _invariants() -> Dict[str, Callable[[PoolState, int, int],
                                        Optional[str]]]:
    def conservation(s: PoolState, D: int, H: int) -> Optional[str]:
        total = s.free + len(s.active) + s.device_cached
        if total != D:
            return (f"device slots not conserved: free={s.free} + "
                    f"active={len(s.active)} + cached={s.device_cached} "
                    f"= {total} != n_pages={D} (leak or double-free)")
        return None

    def in_range(s: PoolState, D: int, H: int) -> Optional[str]:
        if s.free < 0 or s.device_cached < 0 or s.host_cached < 0 \
                or s.parked < 0 or s.park_records < 0:
            return f"negative counter in {s}"
        if any(r < 1 for r in s.active):
            return f"live allocation with refcount < 1 in {s}"
        return None

    def host_capacity(s: PoolState, D: int, H: int) -> Optional[str]:
        if s.host_cached + s.parked > H:
            return (f"host tier over capacity: cached={s.host_cached} + "
                    f"parked={s.parked} > host_slots={H}")
        return None

    def parked_pinned(s: PoolState, D: int, H: int) -> Optional[str]:
        if s.parked != s.park_records:
            return (f"parked pages ({s.parked}) != outstanding park "
                    f"records ({s.park_records}): a parked page was "
                    "evicted (or leaked) — resume would lose live "
                    "request state")
        return None

    return {"conservation": conservation, "in-range": in_range,
            "host-capacity": host_capacity, "parked-pinned": parked_pinned}


@dataclasses.dataclass
class PoolModel:
    """A transition system instance: ops + invariants + pool sizes."""

    n_pages: int = 3
    host_slots: int = 2
    ops: Dict[str, Tuple[Callable, Callable]] = \
        dataclasses.field(default_factory=_ops)
    invariants: Dict[str, Callable] = \
        dataclasses.field(default_factory=_invariants)

    def initial(self) -> PoolState:
        return PoolState(free=self.n_pages, active=(), device_cached=0,
                         host_cached=0, parked=0, park_records=0)


DEFAULT_MODEL = PoolModel


def broken_model(which: str = "storm-drops-parks", **kw) -> PoolModel:
    """A deliberately broken transition table, for testing the checker:

    - "storm-drops-parks": the chaos storm also clears PARKED pages —
      violating the pinning contract (parked != park_records).
    - "release-leaks": releasing a private page forgets to return its
      device slot to the free list — a page leak (conservation).
    - "double-free": releasing a private page returns TWO slots —
      a double free (conservation, from the other side).
    """
    m = PoolModel(**kw)
    if which == "storm-drops-parks":
        m.ops["storm"] = (
            lambda s, D, H: s.host_cached > 0 or s.parked > 0,
            lambda s: _with(s, host_cached=0, parked=0))
    elif which == "release-leaks":
        m.ops["release_private"] = (
            lambda s, D, H: 1 in s.active,
            lambda s: _with(s, active=_pop_ref(s.active, 1)))
    elif which == "double-free":
        m.ops["release_private"] = (
            lambda s, D, H: 1 in s.active,
            lambda s: _with(s, free=s.free + 2,
                            active=_pop_ref(s.active, 1)))
    else:
        raise ValueError(f"unknown breakage {which!r}")
    return m


@dataclasses.dataclass
class LifecycleResult:
    states_explored: int
    transitions: int
    violations: List[Tuple[str, str, List[str]]]  # (invariant, msg, trace)

    @property
    def ok(self) -> bool:
        return not self.violations


def check_lifecycle(model: Optional[PoolModel] = None,
                    max_states: int = 200_000) -> LifecycleResult:
    """BFS the full reachable state space, checking every invariant at
    every state.  Returns the first violation per invariant with the op
    trace that reaches it (shortest, since BFS)."""
    model = model or PoolModel()
    D, H = model.n_pages, model.host_slots
    init = model.initial()
    seen = {init: None}  # state -> (prev_state, op) for trace rebuild
    frontier = deque([init])
    violations: List[Tuple[str, str, List[str]]] = []
    tripped = set()
    transitions = 0

    def trace(state: PoolState) -> List[str]:
        ops: List[str] = []
        while seen[state] is not None:
            state, op = seen[state]
            ops.append(op)
        return ops[::-1]

    def check(state: PoolState) -> None:
        for name, inv in model.invariants.items():
            if name in tripped:
                continue
            msg = inv(state, D, H)
            if msg:
                tripped.add(name)
                violations.append((name, msg, trace(state)))

    check(init)
    while frontier and len(seen) < max_states:
        state = frontier.popleft()
        for op, (guard, apply) in model.ops.items():
            if not guard(state, D, H):
                continue
            transitions += 1
            nxt = apply(state)
            if nxt in seen:
                continue
            seen[nxt] = (state, op)
            check(nxt)
            frontier.append(nxt)
    return LifecycleResult(states_explored=len(seen),
                           transitions=transitions, violations=violations)


def check_lifecycle_findings() -> Tuple[List[Finding], Dict]:
    """CLI adapter: run the default model, report violations as findings
    anchored at the pool module the model abstracts."""
    res = check_lifecycle()
    findings = [
        Finding(_RULE, "src/repro_torch/serve/pool.py", 1,
                f"{inv}: {msg} — counterexample: {' -> '.join(tr) or '<init>'}")
        for inv, msg, tr in res.violations]
    stats = {"states_explored": res.states_explored,
             "transitions": res.transitions,
             "exhaustive": res.states_explored < 200_000}
    return findings, stats

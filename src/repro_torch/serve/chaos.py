"""FaultInjector — deterministic, seed-driven fault source for chaos runs.

A copy of ``repro.serve.chaos`` (the port imports nothing of the JAX
package).  The engine takes a ``fault_injector=`` hook and draws each
tick's faults from it:

- **alloc_fail** — the tick admits nothing (and preempts nothing): a
  transient allocator stall.  Queued work waits; nothing breaks.
- **cancel** — one live or queued request is killed with a typed
  ``Cancelled`` (``serve.errors``): a client disappearing mid-flight.
- **evict_storm** — the host cache tier is wiped
  (``PagePool.storm_host_cache``).  PARKED pages survive — preempted live
  state is not cache — so a storm costs re-promotion and re-prefill time,
  never tokens.
- **stall** — the engine does nothing for a tick while the clock (and
  every deadline) advances.

Every draw is keyed by ``(seed, tick)`` with a fresh generator per tick,
so a fault schedule is a pure function of the seed and replays identically
however often a tick's faults are consulted.  ``log`` records every
injected fault as ``(tick, kind, detail)``.

Usage::

    eng = ServeEngine(params, cfg, ...,
                      fault_injector=FaultInjector(seed=7, p_cancel=0.02,
                                                   p_alloc_fail=0.1))
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["FaultInjector"]


class FaultInjector:
    """Seed-driven per-tick fault drawer (see module docstring).

    Each ``p_*`` is an independent per-tick probability in [0, 1];
    ``window`` optionally restricts injection to ticks in
    ``[start, stop)`` so a scenario can aim its fault wave at the loaded
    phase of a run."""

    def __init__(self, seed: int = 0, *, p_alloc_fail: float = 0.0,
                 p_cancel: float = 0.0, p_evict_storm: float = 0.0,
                 p_stall: float = 0.0, start_tick: int = 0,
                 stop_tick: Optional[int] = None):
        for name, p in (("p_alloc_fail", p_alloc_fail),
                        ("p_cancel", p_cancel),
                        ("p_evict_storm", p_evict_storm),
                        ("p_stall", p_stall)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        self.seed = int(seed)
        self.p_alloc_fail = float(p_alloc_fail)
        self.p_cancel = float(p_cancel)
        self.p_evict_storm = float(p_evict_storm)
        self.p_stall = float(p_stall)
        self.start_tick = int(start_tick)
        self.stop_tick = stop_tick
        self.log: List[tuple] = []  # (tick, kind, detail)

    def faults(self, tick: int, live_uids: Sequence[int]) -> Dict:
        """Draw tick ``tick``'s faults: {"alloc_fail": bool, "cancel":
        Optional[uid], "evict_storm": bool, "stall": bool}.  The cancel
        target is drawn uniformly from ``live_uids`` (sorted first, so the
        draw is independent of the caller's iteration order)."""
        out: Dict = {"alloc_fail": False, "cancel": None,
                     "evict_storm": False, "stall": False}
        if tick < self.start_tick or (self.stop_tick is not None
                                      and tick >= self.stop_tick):
            return out
        # fresh generator per tick: the schedule is a pure function of
        # (seed, tick) — replayable, and immune to consultation order
        rng = np.random.default_rng((self.seed, tick))
        if rng.random() < self.p_alloc_fail:
            out["alloc_fail"] = True
            self.log.append((tick, "alloc_fail", None))
        # draw unconditionally: the stall/storm draws below must not shift
        # with how many requests happen to be live this tick
        cancel_roll, pick_roll = rng.random(), rng.random()
        uids = sorted(int(u) for u in live_uids)
        if uids and cancel_roll < self.p_cancel:
            out["cancel"] = uids[int(pick_roll * len(uids))]
            self.log.append((tick, "cancel", out["cancel"]))
        if rng.random() < self.p_evict_storm:
            out["evict_storm"] = True
            self.log.append((tick, "evict_storm", None))
        if rng.random() < self.p_stall:
            out["stall"] = True
            self.log.append((tick, "stall", None))
        return out

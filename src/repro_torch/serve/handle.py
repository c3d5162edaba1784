"""Request lifecycle — the serving stack's client-facing layer.

``Request`` is the engine-internal record of one generation job;
``RequestHandle`` is what ``ServeEngine.submit`` returns to the caller: a
streaming, cancellable view of that job.

The handle subclasses ``int`` and IS the request uid — it hashes, compares,
sorts, and formats exactly like the integer ids the engine has always
returned, so every existing driver (``results[uid]``, ``sorted(uids)``,
``f"req {uid:3d}"``) keeps working unchanged while new clients get the
streaming surface:

- ``handle.tokens()`` — incremental iteration: yields each generated token
  as it is emitted, driving ``engine.tick()`` whenever it starves (the
  engine stays a pull-based, single-threaded tick loop — no background
  thread, no queue; a tick serves EVERY live request, so concurrent
  iterators interleave fairly).
- ``handle.cancel()`` — releases the request mid-flight: a queued request
  is dequeued; an admitted one has its slot freed and its page refcounts
  dropped.  Refcount-safe by construction: shared prefix pages survive as
  long as any sibling (or the prefix index) still holds them, and the
  cancelled request's own indexed prompt pages stay resident as cache.
- ``handle.done`` / ``handle.result()`` — completion flag and a blocking
  drain (ticks until this request finishes; other requests make progress
  on the same ticks).  ``result(timeout_ticks=)`` bounds the drain, and
  engine-side aborts surface as TYPED exceptions (``serve.errors``): a
  request whose ``deadline_ticks`` elapsed raises ``DeadlineExceeded``, a
  fault-injected/administrative abort raises ``Cancelled`` — never a hang,
  never a silently-truncated token list.  A CLIENT-initiated
  ``handle.cancel()`` keeps the historical contract: ``result()`` returns
  the partial output.

A copy of ``repro.serve.handle``; the JAX package's
``examples/serve_stream.py`` shows the streaming client, including the
cancel-on-timeout pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # sampling (serve.engine only; the reference engine is greedy-only):
    # temperature == 0 -> greedy argmax; seed defaults to uid at submit
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: Optional[int] = None
    # scheduling class (serve.scheduler.SloScheduler): higher admits/packs
    # first; priority >= 1 is the interactive class, 0 the batch default
    priority: int = 0
    cancelled: bool = False
    # absolute engine tick by which the request must COMPLETE (None = no
    # deadline); set by ``submit(deadline_ticks=)`` relative to the tick
    # counter at submission.  An expired request aborts with a typed
    # ``DeadlineExceeded`` recorded in ``error``.
    deadline_tick: Optional[int] = None
    # engine-side abort cause (serve.errors.DeadlineExceeded / Cancelled);
    # raised by RequestHandle.result()/tokens().  None for normal
    # completion and for client-initiated cancels.
    error: Optional[Exception] = None


class RequestHandle(int):
    """Streaming handle for one submitted request (see module docstring).

    Immutable-int identity (the uid) plus a live reference to the engine
    and its ``Request`` record; all state lives on those — the handle adds
    no bookkeeping of its own."""

    def __new__(cls, req: Request, engine) -> "RequestHandle":
        h = super().__new__(cls, req.uid)
        h._req = req
        h._engine = engine
        return h

    def __reduce__(self):
        # pickle / copy.deepcopy degrade to the plain uid int: the engine
        # reference is process-local, and pre-handle drivers that shipped
        # submit()'s return value across process or cache boundaries were
        # shipping exactly this int
        return (int, (int(self),))

    def __repr__(self) -> str:
        state = ("cancelled" if self._req.cancelled else
                 "done" if self._req.done else "live")
        return (f"RequestHandle(uid={int(self)}, {state}, "
                f"tokens={len(self._req.out_tokens)})")

    # -- state ------------------------------------------------------------
    @property
    def uid(self) -> int:
        return int(self)

    @property
    def request(self) -> Request:
        return self._req

    @property
    def done(self) -> bool:
        """True once the engine will emit no more tokens for this request
        (completed, cancelled, or drained by a truncated ``run()``)."""
        return self._req.done

    @property
    def cancelled(self) -> bool:
        return self._req.cancelled

    # -- streaming --------------------------------------------------------
    def tokens(self, max_ticks: int = 65536) -> Iterator[int]:
        """Yield this request's generated tokens as they are emitted,
        ticking the engine whenever no new token is buffered yet.

        Safe to interleave with other handles' iterators, ``tick()``, and
        ``submit()`` — every tick advances ALL live requests, and the
        iterator replays tokens emitted while it wasn't being consumed.
        Stops at ``done`` (EOS / max_tokens / cancel); ``max_ticks`` bounds
        the total engine ticks this iterator may drive.  An engine-side
        abort (deadline expiry, fault-injected cancel) raises its typed
        cause (``serve.errors``) after the partial tokens were yielded."""
        i = 0
        while True:
            while i < len(self._req.out_tokens):
                yield self._req.out_tokens[i]
                i += 1
            if self._req.done:
                if self._req.error is not None:
                    raise self._req.error
                return
            if max_ticks <= 0:
                raise TimeoutError(
                    f"request {int(self)} incomplete after the iterator's "
                    f"tick budget")
            self._engine.tick()
            max_ticks -= 1

    def result(self, max_ticks: int = 65536, *,
               timeout_ticks: Optional[int] = None) -> List[int]:
        """Drain until this request is done; returns its generated tokens
        (the partial list if it was cancelled by ``handle.cancel()``).

        ``timeout_ticks`` bounds the drain: if the engine hasn't finished
        this request within that many ticks (stalled, overloaded, or simply
        never admitting it), ``TimeoutError`` is raised instead of blocking
        indefinitely.  Engine-side aborts raise their typed cause
        (``serve.errors.DeadlineExceeded`` / ``Cancelled``), each carrying
        the partial output on ``.tokens``."""
        budget = timeout_ticks if timeout_ticks is not None else max_ticks
        for _ in self.tokens(max_ticks=budget):
            pass
        return list(self._req.out_tokens)

    def cancel(self) -> bool:
        """Stop this request now and release what it holds (module
        docstring has the refcount story).  Returns True if there was
        anything to cancel — False for an already-finished request."""
        return self._engine.cancel(self)

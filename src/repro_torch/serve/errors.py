"""Typed serving errors — the failure vocabulary of the engine.

A copy of ``repro.serve.errors`` (the port imports nothing of the JAX
package).  ``Cancelled`` is what fault injection (``serve.chaos``) and
other engine-side aborts raise.

Robust serving needs failures to be part of the API, not stack traces: a
client must be able to tell "your request can never fit" from "the engine
is momentarily full" from "your deadline passed" and react differently to
each.  Every class here still subclasses the builtin its pre-typed
predecessor raised (``ValueError`` for the submit-time rejections,
``TimeoutError`` for deadline/drain expiry), so existing ``except`` blocks
keep working while new clients can catch the precise type.

- ``RequestTooLarge`` — the request's page footprint exceeds the TOTAL
  pool, or its token span exceeds ``cache_len``: no amount of waiting,
  eviction, or preemption can ever admit it, so ``submit`` rejects it up
  front instead of letting it deadlock admission forever.
- ``EngineOverloaded`` — backpressure: the bounded admission queue
  (``ServeEngine(max_queue=)``) is full.  Transient — the caller should
  shed load or retry later; nothing about the request itself is wrong.
- ``DeadlineExceeded`` — the request's ``deadline_ticks`` budget elapsed
  before it completed; the engine aborted it (partial output preserved on
  the exception and the request record).
- ``Cancelled`` — the engine cancelled the request (fault injection, an
  administrative abort); raised from ``result()``/``tokens()`` so a
  consumer never mistakes an engine-side abort for normal completion.
  A CLIENT-initiated ``handle.cancel()`` keeps the historical contract
  instead: ``result()`` returns the partial output without raising.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = ["ServeError", "RequestTooLarge", "EngineOverloaded",
           "DeadlineExceeded", "Cancelled"]


class ServeError(Exception):
    """Base class for every typed serving failure."""


class RequestTooLarge(ServeError, ValueError):
    """The request can NEVER be admitted (footprint exceeds the pool or
    the cache): rejected at ``submit`` time, before it takes a queue slot."""


class EngineOverloaded(ServeError, RuntimeError):
    """The bounded admission queue is full — shed load or retry later."""


class _AbortError(ServeError, TimeoutError):
    """Shared shape of engine-side aborts: carries the partial output."""

    def __init__(self, msg: str, tokens: Optional[List[int]] = None):
        super().__init__(msg)
        self.tokens = list(tokens) if tokens is not None else []


class DeadlineExceeded(_AbortError):
    """The request's ``deadline_ticks`` elapsed before completion; the
    engine aborted it.  ``.tokens`` holds what was generated in time."""


class Cancelled(_AbortError):
    """The ENGINE cancelled the request (fault injection, administrative
    abort).  ``.tokens`` holds the partial output."""

"""Scheduler protocol conformance — structural checks over the registry.

A copy of ``repro.analysis.protocols`` run against the port's
``repro_torch.serve.scheduler`` (``SCHEDULERS`` and the wrapper
``SpeculativeScheduler``), over the same synthetic ``EngineView``s built
from the port's ``EngineView`` and ``Request``.

The engine trusts every policy in ``serve.scheduler.SCHEDULERS`` to honor
the ``Scheduler`` protocol's typing that the language can't express:

- ``admission_order`` returns UNIQUE indices into ``view.queue`` (a
  permutation prefix — omitted indices wait, duplicates would double-admit);
- ``decode_order`` / ``prefill_order`` return a PERMUTATION of the slot
  list the engine computed — reordering decides priority within the pack,
  never whether a slot packs at all (the engine's per-tick liveness
  invariant);
- ``preempt_order`` returns a SUBSEQUENCE-with-reorder of the candidate
  victims (a policy may exempt slots, never invent them);
- a WRAPPER policy (anything carrying an ``inner`` scheduler, today
  ``SpeculativeScheduler``) must delegate all four orderings to ``inner``
  VERBATIM — a wrapper that edits an ordering silently forks the wrapped
  policy's fairness/SLO guarantees.  This one is checked on the AST: each
  ordering method's body must be a single ``return self.inner.<same
  method>(<same arguments>)``.

These run against SYNTHETIC ``EngineView`` snapshots (mixed priorities,
shared prefixes, empty and deep queues, repeat consultations to exercise
the bounded-reorder bookkeeping), so the pass costs milliseconds and no
model is built.
"""
from __future__ import annotations

import ast
import inspect
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.analysis.findings import Finding

_RULE = "scheduler-protocol"
_ORDERINGS = ("admission_order", "decode_order", "prefill_order",
              "preempt_order")

__all__ = ["check_protocols"]


def _sched_path() -> Tuple[str, Path]:
    import repro_torch.serve.scheduler as S
    p = Path(S.__file__).resolve()
    try:
        rel = str(p.relative_to(Path(__file__).resolve().parents[3]))
    except ValueError:
        rel = "src/repro_torch/serve/scheduler.py"
    return rel, p


def _mk_request(uid: int, prompt, priority: int = 0):
    from repro_torch.serve.handle import Request
    return Request(uid=uid, prompt=np.asarray(prompt, dtype=np.int32),
                   max_tokens=8, priority=priority)


def _views() -> List:
    """Synthetic snapshots spanning the shapes policies branch on."""
    from repro_torch.serve.scheduler import EngineView
    P = 4  # page_size: prompts of len >= 4 form prefix families

    def warm(prompt) -> int:
        # first family (prefix [1,2,3,4]) is "warm", everything else cold
        p = np.asarray(prompt).ravel()
        return P if p.size >= P and list(p[:P]) == [1, 2, 3, 4] else 0

    def split(prompt) -> Tuple[int, int]:
        w = warm(prompt)
        return (w, 0) if w else (0, 0)

    shared = [1, 2, 3, 4]
    queues = [
        (),  # empty
        tuple(_mk_request(i, shared + [i], priority=i % 2)
              for i in range(6)),  # two families' worth, mixed classes
        tuple(_mk_request(10 + i, [9, 9] if i % 2 else shared + [7, i],
                          priority=0) for i in range(5)),  # sub-page solos
        tuple(_mk_request(20 + i, [5 + i] * (P + i), priority=2 - (i % 3))
              for i in range(9)),  # deep, three classes, all cold
    ]
    slot_reqs = (
        _mk_request(100, shared, priority=1),
        _mk_request(101, [7] * 6, priority=0),
        None,
        _mk_request(103, [8] * 5, priority=0),
    )
    views = []
    for q in queues:
        for ms in (None, split):
            views.append(EngineView(
                queue=q, slot_requests=slot_reqs,
                slot_fill=(4, 6, 0, 2), budget=16, chunk=8, page_size=P,
                match_len=warm, match_split=ms))
    return views


def _check_instance(name: str, sched, rel: str, line: int) -> List[Finding]:
    out: List[Finding] = []

    def bad(msg: str) -> None:
        out.append(Finding(_RULE, rel, line, f"{name}: {msg}"))

    views = _views()
    slots_with_req = [0, 1, 3]  # slot 2 is free (None) in every view
    for repeat in range(3):  # re-consult: bounded-reorder state paths
        for v in views:
            adm = list(sched.admission_order(v))
            if len(set(adm)) != len(adm):
                bad(f"admission_order returned duplicate indices {adm} "
                    f"(double-admission) for |queue|={len(v.queue)}")
            if any(not (0 <= i < len(v.queue)) for i in adm):
                bad(f"admission_order returned out-of-range index in {adm} "
                    f"for |queue|={len(v.queue)}")
            for meth in ("decode_order", "prefill_order"):
                got = list(getattr(sched, meth)(v, list(slots_with_req)))
                if sorted(got) != sorted(slots_with_req):
                    bad(f"{meth} must PERMUTE the engine's slot list "
                        f"{slots_with_req}, got {got} (a dropped slot "
                        "starves; an invented slot packs garbage)")
            vic = list(sched.preempt_order(v, list(slots_with_req)))
            if len(set(vic)) != len(vic) or \
                    any(b not in slots_with_req for b in vic):
                bad(f"preempt_order must return a subsequence of the "
                    f"candidates {slots_with_req}, got {vic}")
            if out:
                return out  # one consultation's diagnosis is enough
    return out


def _delegates_verbatim(fn: ast.FunctionDef) -> bool:
    """Body is exactly ``return self.inner.<name>(<params verbatim>)``
    (docstring allowed)."""
    body = [n for n in fn.body
            if not (isinstance(n, ast.Expr)
                    and isinstance(n.value, ast.Constant))]
    if len(body) != 1 or not isinstance(body[0], ast.Return):
        return False
    call = body[0].value
    if not isinstance(call, ast.Call) or call.keywords:
        return False
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == fn.name
            and isinstance(f.value, ast.Attribute)
            and f.value.attr == "inner"
            and isinstance(f.value.value, ast.Name)
            and f.value.value.id == "self"):
        return False
    params = [a.arg for a in fn.args.args[1:]]  # skip self
    passed = [a.id if isinstance(a, ast.Name) else None for a in call.args]
    return passed == params


def _check_wrapper_delegation(rel: str, src_path: Path) -> List[Finding]:
    """Every class that holds an ``inner`` scheduler must delegate the four
    orderings verbatim (identified by ``self.inner = ...`` in __init__)."""
    out: List[Finding] = []
    tree = ast.parse(src_path.read_text(), filename=str(src_path))
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        is_wrapper = any(
            isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Attribute) and t.attr == "inner"
                and isinstance(t.value, ast.Name) and t.value.id == "self"
                for t in n.targets)
            for n in ast.walk(cls))
        if not is_wrapper:
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        for name in _ORDERINGS:
            fn = methods.get(name)
            if fn is None:
                continue  # inherited default — base Scheduler, acceptable
            if not _delegates_verbatim(fn):
                out.append(Finding(
                    _RULE, rel, fn.lineno,
                    f"{cls.name}.{name} must delegate VERBATIM to "
                    "self.inner (single `return self.inner."
                    f"{name}(...)` with the same arguments) — editing "
                    "an ordering forks the wrapped policy's guarantees"))
    return out


def check_protocols() -> Tuple[List[Finding], Dict]:
    """Run both layers over the live registry + the scheduler module AST."""
    from repro_torch.serve.scheduler import SCHEDULERS

    rel, src_path = _sched_path()
    findings: List[Finding] = []
    for name, cls in sorted(SCHEDULERS.items()):
        try:
            line = inspect.getsourcelines(cls)[1]
        except (OSError, TypeError):
            line = 1
        sched = cls()
        findings.extend(_check_instance(name, sched, rel, line))
    findings.extend(_check_wrapper_delegation(rel, src_path))
    stats = {"schedulers": sorted(SCHEDULERS),
             "views_per_scheduler": len(_views()) * 3}
    return findings, stats

"""Capture contract checker: the port's proof that every serving program
updates the KV pools in place and can live inside one CUDA graph.

The port of ``repro.analysis.contracts``.  JAX proves from the compiled
executable's ``input_output_alias`` table that its programs DONATE the
pools.  The port has no donation: its programs write the state's tensors
in place by construction, each step is captured once into a CUDA graph
(``serve_step.CapturedStep``), and the graph replays on the same
addresses every tick.  What the speed of every later serving change rests
on is therefore:

- a step dispatches no op that makes the host wait (a capture cannot hold
  one, and an eager step would stall on it);
- every pool leaf (``POOL_LEAVES``: ``kp``/``vp`` value pools, ``ks``/``vs``
  int8 scale pools) keeps its ``data_ptr()``, and what a pack writes lands
  in that same storage — a graph replays onto the addresses it captured;
- an all-invalid pack (the capture's warm-up pack) leaves every state leaf
  bit-identical, and so does the page gather; the page insert keeps the
  pointers.

Three layers of checking, as in JAX:

1. **Runtime form** (shared with the tests): ``pool_data_ptrs`` /
   ``assert_in_place`` and the dispatch recorder ``HostSyncRecorder``, so
   the dynamic asserts of ``tests/test_torch_*.py`` and this pass read one
   pool-leaf list and one list of host-synchronising ops.  A moved pool
   pointer is always a failure: unlike JAX's backends, the port has no
   "undonated" case to tolerate.
2. **Program proof**: every program the engine builds, built through the
   engine's own builders (``serve_step.capture_ragged_step`` plain and with
   R = 1 + spec_k, ``capture_spec_rollback``, ``capture_paged_step`` for
   the chunk and the decode tick, ``make_page_gather``,
   ``make_page_insert``) over a smoke model (qwen2-1.5b smoke in float32,
   int8 pools, spec_k 2; both attention routes), run on live and idle
   packs with the checks above.  On a CUDA device the steps are captured
   (``capture=True``) and the pointer and idle checks hold across replays.
   ``compile_programs=False`` (the CLI's ``--no-compile``) skips this layer.
   ``engine_programs`` gives the same proof a built ``ServeEngine``'s own
   steps and movers, at its shapes, after it has served.
3. **Engine source cross-check** (AST): ``ServeEngine._build_steps`` and
   ``__init__`` build each program through exactly those builders,
   imported from ``serve_step``, with the engine's own ``flash_decode`` and
   ``cuda_graph`` flags (``ENGINE_BUILDERS``), so the proven programs are
   the shipped ones, not lookalikes; and no code in ``serve/`` rebinds a
   pool leaf (``state[...]["kp"] = ...``) — the port's form of JAX's
   "donated variable rebound by the call" check.
"""
from __future__ import annotations

import ast
import dataclasses
import inspect
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.models.transformer import POOL_LEAVES

__all__ = ["POOL_LEAVES", "HOST_SYNC_OPS", "HostSyncRecorder",
           "state_leaves", "pool_data_ptrs", "assert_in_place", "Program",
           "prove_program", "check_contracts", "ENGINE_BUILDERS",
           "engine_steps", "engine_programs"]

_RULE = "capture-contract"
_SERVE_DIR = Path(__file__).resolve().parents[1] / "serve"
_SERVE_STEP_REL = "src/repro_torch/serve/serve_step.py"

# ---------------------------------------------------------------------------
# Runtime form (shared with tests)

# ops that copy a count or a value to the host: a captured graph cannot
# hold them and an eager step stalls on them
HOST_SYNC_OPS = ("aten::nonzero", "aten::_local_scalar_dense",
                 "aten::masked_select")


class HostSyncRecorder(TorchDispatchMode):
    """Records every dispatched op that would make the host wait: the ops
    of ``HOST_SYNC_OPS``, and ``index``/``index_put`` with a boolean or
    byte index (which run ``nonzero``).  ``bad`` lists them in order."""

    def __init__(self):
        super().__init__()
        self.bad: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in HOST_SYNC_OPS:
            self.bad.append(name)
        elif name.startswith(("aten::index", "aten::_index_put")):
            indices = args[1] if len(args) > 1 else ()
            if isinstance(indices, (list, tuple)) and any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8) for i in indices):
                self.bad.append(f"{name} with a boolean index")
        return func(*args, **(kwargs or {}))


def state_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} for every tensor leaf of a state pytree of dicts,
    lists and tuples; paths read like JAX's ``keystr``
    (``['layers'][0][1]['kp']``)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = ((f"[{k!r}]", v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {}
    out: Dict[str, torch.Tensor] = {}
    for key, sub in items:
        out.update(state_leaves(sub, prefix + key))
    return out


def _leaf_name(path: str) -> str:
    return path.rsplit("[", 1)[-1].strip("]'\"")


def pool_data_ptrs(state) -> Dict[str, int]:
    """{path: data_ptr()} for every pool leaf of ``state``."""
    return {p: t.data_ptr() for p, t in state_leaves(state).items()
            if _leaf_name(p) in POOL_LEAVES}


def assert_in_place(before: Dict[str, int], state) -> None:
    """Runtime no-move check: ``before`` is a ``pool_data_ptrs`` snapshot
    taken before a call, ``state`` the state after it.  Raises
    AssertionError naming every pool leaf that vanished or moved."""
    after = pool_data_ptrs(state)
    missing = sorted(set(before) - set(after))
    assert not missing, f"pool leaves vanished from the state: {missing}"
    moved = {k: (before[k], after[k]) for k in before if after[k] != before[k]}
    assert not moved, f"pool leaves moved (before, after): {moved}"


# ---------------------------------------------------------------------------
# Program proof


@dataclasses.dataclass
class Program:
    """One serving program as the proof drives it.  ``run`` is the instance
    checked for pointers, writes and idleness (captured on a card), and
    ``eager`` the same program run eagerly, which the recorder watches.
    ``live`` holds two packs that write (the recorder's, then the checked
    instance's: different data, so the second pack's writes show);
    ``idle`` a pack that must leave the state bit-identical (None where the
    program has no idle form).  ``writes`` names the leaves the second live
    pack must change in their own storage; () means the program must leave
    every leaf bit-identical (the page gather)."""

    name: str
    run: Callable
    eager: Callable
    live: Tuple[Sequence, Sequence]
    idle: Optional[Sequence]
    writes: Tuple[str, ...]
    captured: Optional[bool] = None  # None: not a captured step (a mover)
    line: int = 1  # the builder's line in serve_step.py


def _sync(state) -> None:
    leaves = state_leaves(state)
    dev = next(iter(leaves.values())).device if leaves else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _changed(before: Dict[str, torch.Tensor],
             copies: Dict[str, torch.Tensor]) -> List[str]:
    return sorted(p for p, t in before.items() if not torch.equal(t, copies[p]))


def prove_program(prog: Program, state) -> Tuple[List[Finding], Dict]:
    """(a)-(d) for one program over ``state``; returns its findings and a
    record for the report."""
    findings: List[Finding] = []

    def bad(msg: str) -> None:
        findings.append(Finding(_RULE, _SERVE_STEP_REL, prog.line,
                                f"{prog.name}: {msg}"))

    # (a) no host-synchronising op, on the eager instance
    with HostSyncRecorder() as rec:
        prog.eager(*prog.live[0])
    _sync(state)
    if rec.bad:
        bad(f"dispatches host-synchronising ops {sorted(set(rec.bad))} "
            "— a captured graph cannot hold them")

    # (b) a live pack keeps every pool pointer, and its writes land in the
    #     same storage (the tensors the state held before the call)
    held = state_leaves(state)
    copies = {p: t.clone() for p, t in held.items()}
    ptrs = pool_data_ptrs(state)
    prog.run(*prog.live[1])
    _sync(state)
    try:
        assert_in_place(ptrs, state)
        kept = True
    except AssertionError as e:
        kept = False
        bad(f"{e} — a replay would write the old storage")
    now = state_leaves(state)
    rebound = sorted(p for p in held if p not in now or now[p] is not held[p])
    if rebound:
        bad(f"rebinds state leaves {rebound} to new tensors")
    changed = _changed(held, copies)
    if prog.writes:
        landed = all(any(_leaf_name(p) == w for p in changed)
                     for w in prog.writes
                     if any(_leaf_name(p) == w for p in held))
        if not landed:
            bad(f"a live pack left its leaves {list(prog.writes)} unchanged "
                f"in their storage (changed: {changed}) — its writes went "
                "elsewhere")
    else:  # (d) the gather: nothing may change
        landed = not changed
        if changed:
            bad(f"must leave the state bit-identical, changed {changed}")

    # (c) the idle pack leaves every state leaf bit-identical
    idle_ok = None
    if prog.idle is not None:
        copies = {p: t.clone() for p, t in state_leaves(state).items()}
        prog.run(*prog.idle)
        _sync(state)
        changed = _changed(state_leaves(state), copies)
        idle_ok = not changed
        if changed:
            bad(f"an idle (all-invalid) pack changed {changed} — the "
                "capture's warm-up would corrupt the state")
    if prog.captured is False:
        bad("was not captured into a CUDA graph on a CUDA device")
    record = {"host_sync_ops": len(rec.bad), "pointers_kept": kept,
              "writes_landed": landed, "idle_identical": idle_ok,
              "captured": prog.captured, "proved": not findings}
    return findings, record


# smoke dimensions of the proof (JAX's ``_smoke_setup``): batch, cache_len,
# page size, prefill chunk, ragged pack size, speculative depth
B, CACHE_LEN, PAGE, CHUNK, T, SPEC_K = 2, 64, 8, 8, 16, 2


def _smoke_setup(device):
    """qwen2-1.5b smoke in float32 with seed-0 weights on ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, M.init_params(cfg, generator=gen, device=device)


def _fresh_state(cfg, params):
    """The engine's state at the proof's size, int8 pools, both slots
    admitted: slot 0 maps pages 0..7, slot 1 pages 8..15."""
    from repro_torch.models import model as M

    pps = CACHE_LEN // PAGE
    state = M.init_paged_state(params, cfg, B, CACHE_LEN, page_size=PAGE,
                               n_pages=B * pps, window_extra=CHUNK,
                               kv_dtype="int8")
    rows = torch.arange(B * pps, dtype=torch.int32).reshape(B, pps)
    M.reset_paged_slots(cfg, state, M.reset_template(state),
                        torch.ones(B, dtype=torch.bool, device=params.device),
                        rows.to(params.device),
                        torch.zeros(B, dtype=torch.int32, device=params.device))
    return state


def _ragged_pack(rng, vocab, T, B, width, runs, R=1):
    """A (T,) pack over B slots of ``runs`` [(slot, first position,
    tokens)], each run a slot's consecutive tokens; ``logit_idx`` takes each
    run's last token (with R > 1, each slot's first run's tokens in
    order)."""
    tokens = rng.randint(0, vocab, T).astype(np.int32)
    slot, q_pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    seq, valid = np.full(T, width, np.int32), np.zeros(T, bool)
    logit_idx = np.full((B,) if R == 1 else (B, R), T, np.int32)
    n = 0
    for b, start, c in runs:
        slot[n:n + c], q_pos[n:n + c] = b, start + np.arange(c)
        seq[n:n + c], valid[n:n + c] = np.arange(c), True
        if R == 1:
            logit_idx[b] = n + c - 1
        else:
            logit_idx[b, :c] = n + np.arange(c)
        n += c
    return [tokens, slot, q_pos, seq, valid, logit_idx]


def _paged_pack(rng, vocab, B, C, starts, counts):
    tokens = rng.randint(0, vocab, (B, C)).astype(np.int32)
    q_pos = (np.asarray(starts, np.int32)[:, None]
             + np.arange(C, dtype=np.int32)[None])
    valid = np.arange(C)[None] < np.asarray(counts)[:, None]
    return [tokens, q_pos, valid]


def _step_programs(cfg, params, state, *, flash: bool, capture: bool,
                   route: str) -> List[Program]:
    """The engine's steps over ``state`` through its builders: the plain
    ragged step, the speculative one (R = 1 + spec_k), the rollback, the
    two-phase chunk and decode tick."""
    from repro_torch.serve import serve_step as SS

    dev = params.device
    width = max(CHUNK + 1, 1 + SPEC_K)
    R, V = 1 + SPEC_K, cfg.vocab_size
    rng = np.random.RandomState(7)
    on_params = (cfg, params, state)
    builders = [
        ("ragged_step", SS.capture_ragged_step, on_params,
         dict(T=T, B=B, width=width, flash_decode=flash)),
        ("verify_step", SS.capture_ragged_step, on_params,
         dict(T=T, B=B, width=width, R=R, flash_decode=flash)),
        ("spec_rollback", SS.capture_spec_rollback, (cfg, state),
         dict(B=B, device=dev)),
        ("chunk_step", SS.capture_paged_step, on_params,
         dict(B=B, C=CHUNK, with_logits=False, flash_decode=flash)),
        ("decode_step", SS.capture_paged_step, on_params,
         dict(B=B, C=1, with_logits=True, flash_decode=flash)),
    ]
    # live packs, in program order: slot 0 prefills 0..4, slot 1 0..2; both
    # verify three rows (5..7, 3..5); the rollback kills 7 and 5, then 6
    # and 4; the chunk writes 6..13 and 4..7; the decode tick 14 and 8
    live = {
        "ragged_step": [_ragged_pack(rng, V, T, B, width,
                                     [(0, 0, 5), (1, 0, 3)])
                        for _ in range(2)],
        "verify_step": [_ragged_pack(rng, V, T, B, width,
                                     [(0, 5, 3), (1, 3, 3)], R)
                        for _ in range(2)],
        "spec_rollback": [[np.ones(B, bool), np.asarray(n, np.int32)]
                          for n in ([7, 5], [6, 4])],
        "chunk_step": [_paged_pack(rng, V, B, CHUNK, [6, 4], [8, 4])
                       for _ in range(2)],
        "decode_step": [_paged_pack(rng, V, B, 1, [14, 8], [1, 1])
                        for _ in range(2)],
    }
    idle = {
        "ragged_step": SS.idle_ragged_pack(T, B, width),
        "verify_step": SS.idle_ragged_pack(T, B, width, R),
        "spec_rollback": [np.zeros(B, bool), np.zeros(B, np.int32)],
        "chunk_step": SS.idle_paged_pack(B, CHUNK),
        "decode_step": SS.idle_paged_pack(B, 1),
    }
    writes = {"spec_rollback": ("kpos",)}
    progs = []
    progs = []
    for name, builder, args, kw in builders:
        step = builder(*args, capture=capture, **kw)
        progs.append(Program(
            f"{name}[{route}]", step.run, step.run_eager, tuple(live[name]),
            idle[name], writes.get(name, POOL_LEAVES),
            step.captured if capture else None,
            inspect.getsourcelines(builder)[1]))
    return progs


def _mover_programs(state, gather, insert, pairs, demote=None
                    ) -> List[Program]:
    """The host tier's page movers (eager, on the current stream): the
    gather must leave the state alone; the insert writes each live pack's
    destination page from the rows of its source page, passed through
    ``demote`` (rows -> the rows the promotion reads) or cloned.
    ``pairs`` holds two (source, destination) pages."""
    from repro_torch.serve import serve_step as SS

    def run_gather(page):
        gather(state, page)

    def run_insert(src, page):  # the demoted rows of ``src``, promoted
        rows = gather(state, src)
        rows = (demote(rows) if demote is not None
                else {k: v.clone() for k, v in rows.items()})
        insert(state, rows, page)

    return [
        Program("page_gather", run_gather, run_gather,
                tuple((src,) for src, _ in pairs), None, (),
                line=inspect.getsourcelines(SS.make_page_gather)[1]),
        Program("page_insert", run_insert, run_insert, tuple(pairs),
                None, POOL_LEAVES,
                line=inspect.getsourcelines(SS.make_page_insert)[1]),
    ]


def _prove_all(device) -> Tuple[List[Finding], Dict[str, Dict]]:
    from repro_torch.serve import serve_step as SS

    cfg, params = _smoke_setup(device)
    capture = device.type == "cuda"
    findings: List[Finding] = []
    records: Dict[str, Dict] = {}
    for route, flash in (("gather", False), ("kernel", True)):
        state = _fresh_state(cfg, params)
        progs = _step_programs(cfg, params, state, flash=flash,
                               capture=capture, route=route)
        if route == "kernel":  # after the steps wrote pages 0 and 1; the
            # insert writes pages 14 and 15 (slot 1's last, unwritten)
            progs += _mover_programs(state, SS.make_page_gather(cfg),
                                     SS.make_page_insert(cfg),
                                     ((0, 14), (1, 15)))
        for prog in progs:
            got, records[prog.name] = prove_program(prog, state)
            findings.extend(got)
    return findings, records


def engine_steps(eng) -> Dict[str, object]:
    """{engine attribute: step} for every serving step ``eng`` (a
    ``ServeEngine``) has built."""
    from repro_torch.serve.serve_step import CapturedStep

    return {a: getattr(eng, a) for a in ENGINE_BUILDERS
            if isinstance(getattr(eng, a, None), CapturedStep)}


def engine_programs(eng) -> List[Program]:
    """The programs of a ``ServeEngine`` that has served, as the proof
    drives them: its own steps (captured where it captures) and page
    movers, at its shapes, over its state.  The live packs write the first
    positions of every live slot, then the rollback kills them back, and
    the insert promotes a live page's rows into free pages through the
    host store where the engine has one: they corrupt what the engine
    serves, so prove them once its run is over."""
    from repro_torch.serve import serve_step as SS

    state, live = eng._state, [b for b, s in enumerate(eng.slots)
                               if s is not None]
    assert live, "the engine has no live slot to write"
    free = list(eng.pool._free[:2])
    assert len(free) == 2, "the engine's pool has fewer than 2 free pages"
    R, V, B = 1 + eng._spec_k, eng.cfg.vocab_size, eng.B
    cap = [len(eng.slots[b].pages) * eng.page_size if b in live else 0
           for b in range(B)]
    rng = np.random.RandomState(0)
    mask = np.isin(np.arange(B), live)

    def paged(C):
        return [_paged_pack(rng, V, B, C, [0] * B,
                            [min(C, c) for c in cap]) for _ in range(2)]

    c = R if R > 1 else 2  # the rollback below needs positions 0 and 1
    assert c * len(live) <= eng.budget, "the live rows overflow the pack"
    packs = {
        "_ragged_step": ([_ragged_pack(rng, V, eng.budget, B, eng.width,
                                       [(b, 0, c) for b in live], R)
                          for _ in range(2)],
                         SS.idle_ragged_pack(eng.budget, B, eng.width, R)),
        "_rollback": ([[mask, np.full(B, n, np.int32)] for n in (2, 1)],
                      [np.zeros(B, bool), np.zeros(B, np.int32)]),
        "_chunk_step": (paged(eng.chunk), SS.idle_paged_pack(B, eng.chunk)),
        "_decode_step": (paged(1), SS.idle_paged_pack(B, 1)),
    }
    capture = eng.device.type == "cuda" and eng.cuda_graph
    progs = []
    for attr, step in engine_steps(eng).items():
        builder = getattr(SS, ENGINE_BUILDERS[attr][1])
        lives, idle = packs[attr]
        progs.append(Program(
            attr.strip("_"), step.run, step.run_eager, tuple(lives), idle,
            ("kpos",) if attr == "_rollback" else POOL_LEAVES,
            step.captured if capture else None,
            inspect.getsourcelines(builder)[1]))

    demote = None
    if eng._host_store:  # through a free host slot, as a demotion does
        slot = min(set(range(eng.host_pages)) - eng._host_slots)

        def demote(rows):
            for key, r in rows.items():
                eng._host_store[key][slot].copy_(r, non_blocking=True)
            return {k: v[slot] for k, v in eng._host_store.items()}

    src = eng.slots[live[0]].pages[0]
    return progs + _mover_programs(state, eng._gather_page, eng._insert_page,
                                   tuple((src, d) for d in free), demote)


# ---------------------------------------------------------------------------
# Engine source cross-check (AST)

_ENGINE_PATH = _SERVE_DIR / "engine.py"
_ENGINE_REL = "src/repro_torch/serve/engine.py"
_BUILDER_MODULE = "repro_torch.serve.serve_step"

# engine attribute -> (the method that builds it, the serve_step builder,
# {keyword: the expression the engine must pass})
_FLAGS = {"flash_decode": "self.flash_decode", "capture": "self.cuda_graph",
          "ctx": "self._ctx"}
ENGINE_BUILDERS: Dict[str, Tuple[str, str, Dict[str, str]]] = {
    "_ragged_step": ("_build_steps", "capture_ragged_step", _FLAGS),
    "_rollback": ("_build_steps", "capture_spec_rollback",
                  {"capture": "self.cuda_graph"}),
    "_chunk_step": ("_build_steps", "capture_paged_step",
                    {**_FLAGS, "with_logits": "False"}),
    "_decode_step": ("_build_steps", "capture_paged_step",
                     {**_FLAGS, "with_logits": "True"}),
    "_gather_page": ("__init__", "make_page_gather", {}),
    "_insert_page": ("__init__", "make_page_insert", {}),
}


def _call_keywords(call: ast.Call, fn: ast.FunctionDef) -> Dict[str, str]:
    """The call's keywords as source text, ``**name`` resolved through a
    ``name = dict(...)`` (or dict literal) assignment in ``fn``."""
    out: Dict[str, str] = {}
    for kw in call.keywords:
        if kw.arg is not None:
            out[kw.arg] = ast.unparse(kw.value)
            continue
        if not isinstance(kw.value, ast.Name):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == kw.value.id):
                continue
            val = node.value
            if (isinstance(val, ast.Call) and isinstance(val.func, ast.Name)
                    and val.func.id == "dict"):
                out.update({k.arg: ast.unparse(k.value)
                            for k in val.keywords if k.arg})
            elif isinstance(val, ast.Dict):
                out.update({ast.literal_eval(k): ast.unparse(v)
                            for k, v in zip(val.keys, val.values)
                            if isinstance(k, ast.Constant)})
    return out


def _check_engine_builders(tree: ast.Module) -> List[Finding]:
    """Each program attribute is built once, in its method, by its
    ``serve_step`` builder with the engine's own flags."""
    findings: List[Finding] = []

    def flag(line: int, msg: str) -> None:
        findings.append(Finding(_RULE, _ENGINE_REL, line, msg))

    imported = {a.asname or a.name: a.name for n in tree.body
                if isinstance(n, ast.ImportFrom) and n.module == _BUILDER_MODULE
                for a in n.names}
    # a module-level def or assignment of a builder's name shadows the import
    shadowed = {n.name: n.lineno for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    shadowed.update({t.id: n.lineno for n in tree.body
                     if isinstance(n, ast.Assign) for t in n.targets
                     if isinstance(t, ast.Name)})
    seen: Dict[str, int] = {}
    engine = next((n for n in tree.body if isinstance(n, ast.ClassDef)
                   and n.name == "ServeEngine"), None)
    if engine is None:
        flag(1, "no ServeEngine class — update analysis.contracts if the "
             "engine moved")
        return findings
    for fn in engine.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                for t in (tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]):
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            and t.attr in ENGINE_BUILDERS):
                        continue
                    if (isinstance(node.value, ast.Constant)
                            and node.value.value is None):
                        continue  # "not built yet"
                    where, builder, flags = ENGINE_BUILDERS[t.attr]
                    call = node.value
                    name = (call.func.id if isinstance(call, ast.Call)
                            and isinstance(call.func, ast.Name) else None)
                    seen[t.attr] = seen.get(t.attr, 0) + 1
                    if seen[t.attr] > 1:
                        flag(node.lineno, f"self.{t.attr} is built again; "
                             "the registered contract builds it once")
                    if fn.name != where:
                        flag(node.lineno, f"self.{t.attr} is assigned in "
                             f"{fn.name}(); the registered contract builds "
                             f"it once, in {where}()")
                    if name is None or imported.get(name) != builder \
                            or name in shadowed:
                        flag(node.lineno, f"self.{t.attr} is built by "
                             f"{ast.unparse(call)[:60]!r}, not by "
                             f"{builder} imported from {_BUILDER_MODULE} — "
                             "the proven program is not the shipped one")
                        continue
                    got = _call_keywords(call, fn)
                    wrong = {k: got.get(k) for k, v in flags.items()
                             if got.get(k) != v}
                    if wrong:
                        flag(node.lineno, f"self.{t.attr} = {builder}(...) "
                             f"passes {wrong}; the engine must pass "
                             f"{ {k: flags[k] for k in wrong} }")
    for attr in ENGINE_BUILDERS:
        if attr not in seen:
            flag(engine.lineno, f"ServeEngine no longer builds self.{attr} "
                 "— update analysis.contracts if the program registry "
                 "changed")
    return findings


def _check_pool_rebinding(paths: Sequence[Path]) -> List[Finding]:
    """No code in serve/ rebinds a pool leaf: ``x["kp"] = ...`` would point
    the state at a new tensor that no captured graph writes."""
    findings: List[Finding] = []
    for p in paths:
        rel = f"src/repro_torch/serve/{p.name}"
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(node, ast.AnnAssign)
                       else [])
            for tgt in targets:
                for t in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                          else [tgt]):
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.slice, ast.Constant)
                            and t.slice.value in POOL_LEAVES):
                        findings.append(Finding(
                            _RULE, rel, node.lineno,
                            f"rebinds pool leaf {t.slice.value!r} "
                            f"({ast.unparse(t)}): the pools are written in "
                            "place, never replaced — a captured graph keeps "
                            "writing the old tensor"))
    return findings


def check_contracts(compile_programs: bool = True, device=None
                    ) -> Tuple[List[Finding], Dict]:
    """Run the capture contract checker: the AST layer, then (unless
    ``compile_programs`` is False) the program proof on ``device`` (``cuda``
    unless the caller passes another; captured there).  Returns (findings,
    stats); stats holds each program's record for the CLI report."""
    findings: List[Finding] = []
    findings.extend(_check_engine_builders(ast.parse(_ENGINE_PATH.read_text())))
    findings.extend(_check_pool_rebinding(sorted(_SERVE_DIR.glob("*.py"))))
    stats: Dict = {"programs": {}}
    if not compile_programs:
        return findings, stats
    from repro_torch import resolve_device

    dev = resolve_device(device)
    got, stats["programs"] = _prove_all(dev)
    stats["device"] = str(dev)
    findings.extend(got)
    return findings, stats

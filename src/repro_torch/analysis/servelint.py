"""servelint — repo-specific AST lint for the port's serving stack.

The port of ``repro.analysis.servelint``.  The serving engine's speed rests
on discipline the type system cannot see: one captured CUDA graph per
step, built once at a registered site; static inputs loaded from whole
host arrays; no wall clock or unseeded RNG in the tick loop; no silently
swallowed failures.  These rules encode that discipline statically.

Rules (scopes in parentheses; paths are relative to ``src/repro_torch``),
each beside the JAX rule it ports:

- ``capture-outside-factory`` (all of src; JAX ``jit-outside-factory``):
  a call of ``torch.cuda.graph``, ``torch.cuda.CUDAGraph``,
  ``torch.cuda.make_graphed_callables`` or ``torch.compile`` anywhere but
  the registered sites (``CAPTURE_FACTORY_SITES``), decorator position
  included, and any ``from torch.cuda import graph`` style import of those
  names (which would hide them from this rule).  A capture in the tick path
  would capture per call; new capture sites are registered here ON
  PURPOSE, which is the review hook.
- ``hot-nondeterminism`` (serve/, kernels/; same rule): ``np.random.*``,
  wall-clock ``time.*`` reads, iteration over an unordered set, and
  torch's global RNG — ``torch.rand*``/``randint``/``randn``/``randperm``/
  ``multinomial``/``bernoulli``/``normal``/``poisson`` and the in-place
  samplers (``x.uniform_()``, ``x.normal_()``, ...) without a
  ``generator=``.  Allowlisted: the tuple-seeded ``default_rng((seed,
  ...))`` sites in ``engine.py``/``chaos.py`` (deterministic by
  construction); order-insensitive reducers over sets
  (``sum``/``min``/``max``/``len``/``all``/``any``/``sorted``).
- ``broad-except`` (all of src; same rule): bare ``except:`` or ``except
  Exception/BaseException``.  Intentional catch-alls carry a reasoned
  inline suppression instead.
- ``mutable-default`` (all of src; same rule): mutable default arguments.
- ``scalar-into-captured-step`` (serve/; JAX ``retrace-bomb``): a
  Python-scalar argument (an int/float/bool literal, ``int()``/
  ``float()``/``len()``, or arithmetic over those) to ``.run(...)`` of a
  captured step (``CAPTURED_STEP_ATTRS``) or inside the pack given to the
  engine's ``_run_step``.  ``CapturedStep._load`` writes each argument
  into its static input as ``host.numpy()[...] = a``, so a scalar silently
  fills the whole input and the step runs on a constant pack instead of
  raising.  JAX's "page id as DATA" half has no counterpart: the port's
  page movers run eagerly, so there is no trace a page id could bake into.

The analysis package itself is excluded from scanning (it builds steps and
broken transition tables as part of CHECKING them, not serving).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding, Suppressions

__all__ = ["lint_file", "lint_tree", "CAPTURE_FACTORY_SITES",
           "CAPTURED_STEP_ATTRS"]

# (path relative to src/repro_torch, enclosing function name) pairs where a
# graph capture (or a compile) is legitimate: the captured step's own
# capture, run once per step object.  Everything else is a finding — add a
# pair here deliberately when introducing a capture site.
CAPTURE_FACTORY_SITES: Set[Tuple[str, str]] = {
    ("serve/serve_step.py", "_capture"),
}
_CAPTURE_CALLS = {("torch", "cuda", "graph"), ("torch", "cuda", "CUDAGraph"),
                  ("torch", "cuda", "make_graphed_callables"),
                  ("torch", "compile")}
_CAPTURE_NAMES = {("torch.cuda", "graph"), ("torch.cuda", "CUDAGraph"),
                  ("torch.cuda", "make_graphed_callables"),
                  ("torch", "compile")}

# the engine's captured steps (``serve_step.CapturedStep``): their ``run``
# copies each argument into a static input, so arguments must be arrays
CAPTURED_STEP_ATTRS: Set[str] = {
    "_ragged_step", "_chunk_step", "_decode_step", "_rollback",
}

_HOT_SCOPES = ("serve/", "kernels/")
_RNG_ALLOWLIST_FILES = {"serve/engine.py", "serve/chaos.py"}
_TIME_ATTRS = {"time", "perf_counter", "monotonic", "time_ns",
               "process_time"}
_ORDER_FREE_REDUCERS = {"sum", "len", "min", "max", "all", "any", "sorted",
                        "set", "frozenset"}
# torch's global-RNG draws: functions of the torch namespace, and the
# in-place samplers of a tensor; either is deterministic only with an
# explicit ``generator=``
_TORCH_RNG_FUNCS = {"rand", "rand_like", "randn", "randn_like", "randint",
                    "randint_like", "randperm", "multinomial", "bernoulli",
                    "normal", "poisson"}
_TORCH_RNG_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                      "exponential_", "geometric_", "cauchy_", "log_normal_"}


def _attr_chain(node: ast.AST) -> List[str]:
    """['torch', 'cuda', 'graph'] for torch.cuda.graph, else []"""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _is_py_scalar(node: ast.AST) -> bool:
    """A fresh Python scalar: a number or bool literal, ``int()``/
    ``float()``/``len()``, or arithmetic over those."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float))  # bool is an int
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("int", "float", "len", "bool")
    if isinstance(node, ast.BinOp):
        return _is_py_scalar(node.left) or _is_py_scalar(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_py_scalar(node.operand)
    return False


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Set):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, source: str):
        self.rel = rel  # path relative to src/repro_torch, posix separators
        self.hot = rel.startswith(_HOT_SCOPES)
        self.in_serve = rel.startswith("serve/")
        self.findings: List[Finding] = []
        self._func_stack: List[str] = []
        self._parents: dict = {}
        tree = ast.parse(source)
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent
        self.visit(tree)

    # -- plumbing ---------------------------------------------------------
    def _flag(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(
            Finding(rule, f"src/repro_torch/{self.rel}", node.lineno, msg))

    def _enclosing(self) -> str:
        return self._func_stack[-1] if self._func_stack else "<module>"

    # -- defs: capture sites, mutable defaults ----------------------------
    def _visit_def(self, node) -> None:
        args = node.args
        for default in list(args.defaults) + [
                d for d in args.kw_defaults if d is not None]:
            mutable = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("list", "dict", "set"))
            if mutable:
                self._flag("mutable-default", default,
                           f"mutable default argument in {node.name}() is "
                           "shared across calls; default to None and build "
                           "inside")
        # decorators, defaults and annotations run in the enclosing scope
        for dec in node.decorator_list:
            self.visit(dec)
        self.visit(args)
        if node.returns is not None:
            self.visit(node.returns)
        self._func_stack.append(node.name)
        for stmt in node.body:
            self.visit(stmt)
        self._func_stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for alias in node.names:
            if (node.module, alias.name) in _CAPTURE_NAMES:
                self._flag("capture-outside-factory", node,
                           f"`from {node.module} import {alias.name}` hides "
                           "the capture API from this lint; call it by its "
                           f"full name ({node.module}.{alias.name}) at a "
                           "registered site")
        self.generic_visit(node)

    # -- except handlers ---------------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        names = []
        if node.type is None:
            names = ["<bare>"]
        else:
            types = (node.type.elts if isinstance(node.type, ast.Tuple)
                     else [node.type])
            for t in types:
                chain = _attr_chain(t)
                if chain and chain[-1] in ("Exception", "BaseException"):
                    names.append(chain[-1])
        if names:
            self._flag("broad-except", node,
                       f"except {'/'.join(names)} swallows unrelated "
                       "failures; catch the specific exceptions (or "
                       "suppress with a reason if the catch-all is the "
                       "point)")
        self.generic_visit(node)

    # -- loops / comprehensions: unordered-set iteration -------------------
    def _check_set_iter(self, iter_node: ast.AST, holder: ast.AST) -> None:
        if not (self.hot and _is_set_expr(iter_node)):
            return
        # an order-insensitive reducer consuming the iteration is fine:
        # sum(1 for p in set(x) ...), sorted(set(x)), max({...})
        scan: Optional[ast.AST] = holder
        while scan is not None:
            parent = self._parents.get(id(scan))
            if isinstance(parent, ast.Call) and isinstance(
                    parent.func, ast.Name) \
                    and parent.func.id in _ORDER_FREE_REDUCERS:
                return
            if isinstance(parent, (ast.stmt, type(None))):
                break
            scan = parent
        self._flag("hot-nondeterminism", iter_node,
                   "iteration order over a set is unordered across runs; "
                   "sort first or reduce order-insensitively")

    def visit_For(self, node: ast.For) -> None:
        self._check_set_iter(node.iter, node)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_set_iter(gen.iter, node)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    # -- calls and attribute reads -----------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        # a capture API referenced without a call (a decorator, a base
        # class, an alias) is a capture site too
        parent = self._parents.get(id(node))
        called = isinstance(parent, ast.Call) and parent.func is node
        if tuple(_attr_chain(node)) in _CAPTURE_CALLS and not called:
            self._check_capture_site(node, ".".join(_attr_chain(node)))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if tuple(chain) in _CAPTURE_CALLS:
            self._check_capture_site(node, ".".join(chain))
        if self.hot:
            self._check_hot_call(node, chain)
        if self.in_serve:
            self._check_captured_step_call(node)
        self.generic_visit(node)

    def _check_capture_site(self, node: ast.AST, name: str) -> None:
        if (self.rel, self._enclosing()) in CAPTURE_FACTORY_SITES:
            return
        self._flag(
            "capture-outside-factory", node,
            f"{name} used in {self._enclosing()}() — steps are captured "
            "once at registered sites (servelint.CAPTURE_FACTORY_SITES); "
            "a capture in the run path captures per call")

    def _check_hot_call(self, node: ast.Call, chain: List[str]) -> None:
        seeded = any(kw.arg == "generator" for kw in node.keywords)
        if len(chain) >= 2 and chain[0] in ("np", "numpy") \
                and chain[1] == "random":
            allowed = (self.rel in _RNG_ALLOWLIST_FILES
                       and chain[-1] == "default_rng"
                       and len(node.args) == 1
                       and isinstance(node.args[0], ast.Tuple))
            if not allowed:
                self._flag("hot-nondeterminism", node,
                           f"{'.'.join(chain)} in a serve/kernel hot path; "
                           "only tuple-seeded default_rng((seed, ...)) in "
                           "engine.py/chaos.py is deterministic by "
                           "construction")
        elif len(chain) == 2 and chain[0] == "time" \
                and chain[1] in _TIME_ATTRS:
            self._flag("hot-nondeterminism", node,
                       f"time.{chain[1]}() in a serve/kernel hot path; "
                       "wall-clock reads must never influence control flow "
                       "(measurement-only uses carry a reasoned "
                       "suppression)")
        elif len(chain) == 2 and chain[0] == "torch" \
                and chain[1] in _TORCH_RNG_FUNCS and not seeded:
            self._flag("hot-nondeterminism", node,
                       f"torch.{chain[1]}() draws from torch's global RNG "
                       "in a serve/kernel hot path; pass a seeded "
                       "generator= (or draw with a tuple-seeded numpy "
                       "default_rng on the host)")
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _TORCH_RNG_METHODS and not seeded):
            self._flag("hot-nondeterminism", node,
                       f".{node.func.attr}() draws from torch's global RNG "
                       "in a serve/kernel hot path; pass a seeded "
                       "generator=")

    def _check_captured_step_call(self, node: ast.Call) -> None:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return
        if (func.attr == "run" and isinstance(func.value, ast.Attribute)
                and func.value.attr in CAPTURED_STEP_ATTRS):
            args, where = node.args, f"{func.value.attr}.run(...)"
        elif (func.attr == "_run_step" and len(node.args) >= 2):
            pack = node.args[1]
            args = (pack.elts if isinstance(pack, (ast.Tuple, ast.List))
                    else [pack])
            where = "the pack given to _run_step(...)"
        else:
            return
        for i, arg in enumerate(args):
            if _is_py_scalar(arg):
                self._flag(
                    "scalar-into-captured-step", arg,
                    f"{where} argument {i} is a Python scalar: the step's "
                    "static input is filled with it whole (CapturedStep."
                    "_load broadcasts), so the step runs on a constant "
                    "pack instead of raising — pass a host array of the "
                    "input's shape")


def lint_file(path: Path, rel: Optional[str] = None) -> List[Finding]:
    """Lint one file.  ``rel`` overrides the src/repro_torch-relative path
    used for scoping (tests point fixture files at serve/-scoped rules)."""
    source = Path(path).read_text()
    if rel is None:
        parts = Path(path).resolve().parts
        idx = len(parts) - 1 - parts[::-1].index("repro_torch")
        rel = "/".join(parts[idx + 1:])
    findings = _Linter(rel, source).findings
    sup = Suppressions(source)
    return [sup.apply(f) for f in findings]


def lint_tree(root: Optional[Path] = None) -> List[Finding]:
    """Lint every module under ``src/repro_torch`` (the analysis package
    excluded — it builds steps and broken tables on purpose)."""
    root = Path(root) if root else Path(__file__).resolve().parents[1]
    findings: List[Finding] = []
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        if rel.startswith("analysis/"):
            continue
        findings.extend(lint_file(p, rel))
    return findings

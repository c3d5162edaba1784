"""The port's static analyzer (``repro_torch.analysis``) against JAX's
(``repro.analysis``), on the CPU:

- lifecycle: the same ``ok``, states and transitions for the default
  model; for each broken model the same violated invariants, messages and
  shortest op traces; and the model held to the port's real ``PagePool``:
  every op sequence the model allows up to ``DEPTH`` ops, replayed on a
  pool of the model's size (3 device pages, 2 host slots), agrees with the
  model's counts after every op;
- lint: the rules both packages have give the same (rule, line) findings
  on the same inline sources (the factory rule with ``jax.jit`` swapped for
  ``torch.compile``); each port-only rule has its own fixture with exact
  lines; suppression parsing and ``split_new`` match JAX's on the same
  text; the port's tree is clean, its baseline empty, and every
  suppression names its rule and gives a reason;
- protocols: both registries conform; JAX's seeded breakages are caught
  with the same messages;
- contracts: ``POOL_LEAVES`` equals JAX's; the CPU proof passes; seeded
  breakages (a pool replaced by a new tensor, an idle pack that writes, a
  ``.item()`` in a step, a lookalike or misflagged builder in the engine,
  a pool rebound in ``serve/``) are each reported;
- the CLI gate.

One ``gpu`` test runs the contracts pass on the card, where the steps are
captured and replayed.  JAX's package is imported in a fixture, so ``pytest
-m gpu`` runs where there is no JAX.
"""
import ast
import copy
import re
import textwrap
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.analysis import PASSES, run_all  # noqa: E402
from repro_torch.analysis import contracts as C  # noqa: E402
from repro_torch.analysis import lifecycle as L  # noqa: E402
from repro_torch.analysis import protocols as P  # noqa: E402
from repro_torch.analysis import servelint as S  # noqa: E402
from repro_torch.analysis.findings import (Finding, Suppressions,  # noqa: E402
                                           load_baseline, split_new)
from repro_torch.serve import serve_step as SS  # noqa: E402
from repro_torch.serve.pool import PagePool  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


@pytest.fixture(scope="module")
def jx():
    """JAX's analysis modules (its contracts module imports jax)."""
    from repro.analysis import contracts, findings, lifecycle, protocols
    from repro.analysis import servelint
    from repro.serve import scheduler

    return types.SimpleNamespace(contracts=contracts, findings=findings,
                                 lifecycle=lifecycle, protocols=protocols,
                                 servelint=servelint, scheduler=scheduler)


# ---------------------------------------------------------------------------
# lifecycle


def test_lifecycle_matches_jax(jx):
    mine, ref = L.check_lifecycle(), jx.lifecycle.check_lifecycle()
    assert mine.ok and ref.ok
    assert (mine.states_explored, mine.transitions) == \
        (ref.states_explored, ref.transitions)
    assert 50 < mine.states_explored < 200_000  # explored, not truncated


@pytest.mark.parametrize("breakage,invariant", [
    ("storm-drops-parks", "parked-pinned"),
    ("release-leaks", "conservation"),
    ("double-free", "conservation"),
])
def test_broken_models_match_jax(jx, breakage, invariant):
    # a broken table's state space need not close (a double free mints
    # pages): the shortest counterexamples lie in the first few states
    mine = L.check_lifecycle(L.broken_model(breakage), max_states=5000)
    ref = jx.lifecycle.check_lifecycle(jx.lifecycle.broken_model(breakage),
                                       max_states=5000)
    assert not mine.ok
    assert invariant in [inv for inv, _, _ in mine.violations]
    # the same invariants, messages and shortest counterexample traces
    assert mine.violations == ref.violations
    assert all(tr for _, _, tr in mine.violations)


class Unrealizable(Exception):
    """A model op whose counting guard holds but that no concrete page of
    the real pool can take."""


class _RealPool:
    """Realizes the lifecycle model's ops on a real ``PagePool`` of the
    model's size (page size 1, one fresh trie key per indexed page), and
    reads back the model's counts.  How each op maps:

    - alloc / share / release_shared: ``alloc(1)`` / ``share`` /
      ``release`` (share takes a page of the model's lowest refcount,
      release_shared one of its highest, as the model does);
    - release_private: ``release`` of a refcount-1 page the trie does not
      index (it frees);
    - release_indexed: ``index_page`` under the root, then ``release`` (it
      stays cached) — the model's nondeterminism "was the page indexed"
      resolved by indexing it;
    - demote: ``evict_one()``, which demotes while a host slot is free;
    - drop_evict: no public call — ``evict_one`` demotes whenever the host
      tier can take the page, and ``drop_cache`` drops every cached page —
      so the private ``_drop_device_node``, the path ``evict_one`` takes
      when no host slot can be had;
    - promote: ``acquire`` of a host-tier page's encoded id;
    - hevict: no public call drops one host entry (``evict_one``/``park``
      do it only to make room, ``storm_host_cache`` drops all), so the
      private ``_hevict``;
    - park / unpark / drop_parked / storm: ``park([page])`` of a refcount-1
      unindexed page, ``unpark`` / ``drop_parked`` of a park's slot,
      ``storm_host_cache()``.

    The model's counting abstraction does not track which live pages the
    trie indexes: a promoted page is indexed, so when every refcount-1
    page is a promoted one, release_private and park have no page to take
    (the real pool would cache it, or refuse the park) and raise
    ``Unrealizable``; that branch is not replayed further."""

    def __init__(self, n_pages: int, host_slots: int):
        self.pool = PagePool(n_pages, 1, host_pages=host_slots)
        self.live = []  # distinct pages with refcount >= 1
        self.parks = []  # host slot of each outstanding park
        self.keys = 0

    def _ref1(self, indexed=None):
        pool = self.pool
        got = [p for p in self.live if pool.ref(p) == 1
               and (indexed is None or pool.is_indexed(p) == indexed)]
        if not got:
            raise Unrealizable
        return got[0]

    def apply(self, op: str) -> None:
        pool = self.pool
        if op == "alloc":
            self.live += pool.alloc(1)
        elif op == "share":
            low = min(pool.ref(p) for p in self.live)
            pool.share([next(p for p in self.live if pool.ref(p) == low)])
        elif op == "release_shared":
            high = max(pool.ref(p) for p in self.live)
            pool.release([next(p for p in self.live if pool.ref(p) == high)])
        elif op == "release_private":
            p = self._ref1(indexed=False)
            pool.release([p])
            self.live.remove(p)
        elif op == "release_indexed":
            p = self._ref1()
            if not pool.is_indexed(p):
                self.keys += 1
                assert pool.index_page(pool.root, (self.keys,), p) is not None
            pool.release([p])
            self.live.remove(p)
        elif op == "demote":
            n = pool.stats["demotions"]
            assert pool.evict_one() and pool.stats["demotions"] == n + 1
        elif op == "drop_evict":
            page = next(p for p in pool._page_node if pool.ref(p) == 0)
            pool._drop_device_node(pool._page_node[page])
        elif op == "promote":
            slot = next(iter(pool._host_node))
            self.live += pool.acquire([pool.n_pages + slot])
        elif op == "hevict":
            pool._hevict(next(iter(pool._host_node.values())))
        elif op == "park":
            slots = pool.park([self._ref1(indexed=False)])
            assert slots is not None
            self.live = [p for p in self.live if pool.ref(p) > 0]
            self.parks += slots
        elif op == "unpark":
            self.live += pool.unpark([self.parks.pop(0)])
        elif op == "drop_parked":
            pool.drop_parked([self.parks.pop(0)])
        elif op == "storm":
            pool.storm_host_cache()
        else:
            raise KeyError(op)
        pool.drain_events()

    def counts(self) -> tuple:
        """The model's state, read from the real pool."""
        pool = self.pool
        live_indexed = sum(pool.is_indexed(p) for p in self.live)
        assert pool.cached_pages == pool.evictable() + live_indexed
        return (pool.free_pages,
                tuple(sorted(pool.ref(p) for p in self.live)),
                pool.evictable(), pool.host_cached_pages,
                pool.parked_pages, len(self.parks))


DEPTH = 6  # op sequences of up to this many ops


def _as_counts(s: L.PoolState) -> tuple:
    return (s.free, s.active, s.device_cached, s.host_cached, s.parked,
            s.park_records)


@pytest.mark.parametrize("first", sorted(L.PoolModel().ops))
def test_lifecycle_model_conforms_to_the_real_pool(first):
    """Every op sequence the model allows that starts with ``first``, up to
    ``DEPTH`` ops, replayed on the real pool: after each op the pool's free
    pages, cached pages (device and host), parked pages, park records and
    live refcounts equal the model's state."""
    model = L.PoolModel()
    D, H = model.n_pages, model.host_slots
    seen = {"replayed": 0, "unrealizable": 0}

    def walk(state, real, depth):
        if depth == DEPTH:
            return
        for op, (guard, apply) in model.ops.items():
            if (depth == 0 and op != first) or not guard(state, D, H):
                continue
            nxt = copy.deepcopy(real)
            try:
                nxt.apply(op)
            except Unrealizable:
                seen["unrealizable"] += 1
                continue
            want = apply(state)
            assert nxt.counts() == _as_counts(want), (op, want)
            seen["replayed"] += 1
            walk(want, nxt, depth + 1)

    init = model.initial()
    walk(init, _RealPool(D, H), 0)
    if model.ops[first][0](init, D, H):
        assert seen["replayed"] > 0
        assert seen["unrealizable"] < seen["replayed"]
    else:  # the op is not enabled on an empty pool
        assert seen == {"replayed": 0, "unrealizable": 0}


# ---------------------------------------------------------------------------
# lint


def _lint_both(jx, tmp_path, source, rel, jax_source=None):
    mine = tmp_path / "mine.py"
    mine.write_text(textwrap.dedent(source))
    ref = tmp_path / "ref.py"
    ref.write_text(textwrap.dedent(jax_source or source))
    return (S.lint_file(mine, rel=rel), jx.servelint.lint_file(ref, rel=rel))


def _keys(findings, rule=None):
    return sorted((f.rule, f.line) for f in findings
                  if not f.suppressed and (rule is None or f.rule == rule))


SHARED = {
    "hot-nondeterminism": """\
        import time

        import numpy as np


        def tick(xs, seed):
            a = np.random.rand(3)
            t = time.perf_counter()
            for x in set(xs):
                pass
            n = sum(1 for x in set(xs))
            rng = np.random.default_rng((seed, 1))
            bad = np.random.default_rng(seed)
            m = max({x for x in xs})
            return [x for x in frozenset(xs)], sorted(set(xs)), time.time()
        """,
    "broad-except": """\
        def f():
            try:
                pass
            except Exception:
                pass
            try:
                pass
            except:  # noqa: E722
                pass
            try:
                pass
            except (ValueError, BaseException):
                pass
            try:
                pass
            except ValueError:
                pass
        """,
    "mutable-default": """\
        def f(a=[], b={}, c=set(), *, d=list(), e=None, g=()):
            return a


        def h(x, y=dict()):
            return x
        """,
}


@pytest.mark.parametrize("rel", ["serve/fixture.py", "serve/engine.py",
                                 "kernels/fixture.py", "core/fixture.py"])
@pytest.mark.parametrize("rule", sorted(SHARED))
def test_shared_rules_match_jax(jx, tmp_path, rule, rel):
    mine, ref = _lint_both(jx, tmp_path, SHARED[rule], rel)
    assert _keys(mine, rule) == _keys(ref, rule)
    if rule != "hot-nondeterminism" or not rel.startswith("core/"):
        assert _keys(mine, rule), "the fixture must trip the rule"


FACTORY = """\
    import jax
    import torch


    class Engine:
        def __init__(self, f):
            self.g = {capture}(f)

        def tick(self, f):
            return {capture}(f)


    def helper(f):
        return {capture}(f)
    """


@pytest.mark.parametrize("rel", ["serve/fixture.py", "core/fixture.py"])
def test_factory_rule_matches_jax(jx, tmp_path, rel):
    """capture-outside-factory flags the lines where JAX's
    jit-outside-factory flags jax.jit (no site of the fixture is
    registered in either package)."""
    mine, ref = _lint_both(jx, tmp_path,
                           FACTORY.format(capture="torch.compile"), rel,
                           FACTORY.format(capture="jax.jit"))
    got = [line for _, line in _keys(mine, "capture-outside-factory")]
    want = [line for _, line in _keys(ref, "jit-outside-factory")]
    assert got == want == [7, 10, 14]


def _lint_port(tmp_path, source, rel):
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent(source))
    return S.lint_file(p, rel=rel)


def test_capture_outside_factory_fixture(tmp_path):
    src = """\
        import torch
        from torch.cuda import graph


        class Step:
            def _capture(self):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    pass

            def run(self):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    pass


        @torch.compile
        def f(x):
            return x


        fast = torch.cuda.make_graphed_callables(f, (1,))
        alias = torch.cuda.graph
        """
    got = _lint_port(tmp_path, src, "serve/serve_step.py")
    assert _keys(got) == [("capture-outside-factory", n)
                          for n in (2, 12, 13, 17, 22, 23)]
    # the same calls anywhere else: the registered _capture is one too
    got = _lint_port(tmp_path, src, "serve/engine.py")
    assert _keys(got) == [("capture-outside-factory", n)
                          for n in (2, 7, 8, 12, 13, 17, 22, 23)]


def test_scalar_into_captured_step_fixture(tmp_path):
    src = """\
        class Engine:
            def tick(self, arrays, tokens, valid, mask, n):
                self._ragged_step.run(*arrays)
                self._decode_step.run(tokens, 0, valid)
                self._run_step(self._rollback, (mask, True))
                self._run_step(self._chunk_step, arrays)
                self._chunk_step.run(len(arrays), n + 1, valid)
                other.run(0)
                self._run_step(self._decode_step, 3)
                self._run_step(self._ragged_step, [tokens, -1.5])
        """
    got = _lint_port(tmp_path, src, "serve/engine.py")
    assert _keys(got) == [("scalar-into-captured-step", n)
                          for n in (4, 5, 7, 7, 9, 10)]
    assert _keys(_lint_port(tmp_path, src, "core/engine.py")) == []


def test_torch_global_rng_fixture(tmp_path):
    src = """\
        import torch


        def sample(x, g):
            a = torch.rand(3)
            b = torch.randn(3, generator=g)
            c = torch.multinomial(x, 1)
            x.uniform_()
            x.normal_(generator=g)
            d = torch.randint(0, 5, (3,))
            e = torch.bernoulli(x)
            f = torch.randperm(4, generator=g)
            x.exponential_()
            return torch.randn_like(x)
        """
    lines = [5, 7, 8, 10, 11, 13, 14]
    for rel in ("serve/fixture.py", "kernels/fixture.py"):
        got = _lint_port(tmp_path, src, rel)
        assert _keys(got) == [("hot-nondeterminism", n) for n in lines]
    assert _keys(_lint_port(tmp_path, src, "models/fixture.py")) == []


SUPPRESSION_TEXT = """\
x = risky()  # servelint: ignore[broad-except] — reason a
# servelint: ignore[rule-a, rule-b] — reason b
y = also_risky()
z = 3  # servelint: ignore[] — names no rule
w = 4  # servelint: ignore[other-rule]
v = 5  # servelint: ignore[mutable-default]: colon reason
u = 6
"""


def test_suppressions_match_jax(jx):
    mine = Suppressions(SUPPRESSION_TEXT)
    ref = jx.findings.Suppressions(SUPPRESSION_TEXT)
    rules = ("broad-except", "rule-a", "rule-b", "other-rule",
             "mutable-default", "")
    lines = range(1, SUPPRESSION_TEXT.count("\n") + 2)
    got = [mine.lookup(n, r) for n in lines for r in rules]
    assert got == [ref.lookup(n, r) for n in lines for r in rules]
    assert mine.lookup(4, "broad-except") == (False, "")  # names no rule
    assert mine.lookup(3, "rule-b") == (True, "reason b")


def test_split_new_matches_jax(jx):
    rows = [("broad-except", "src/a.py", 3, False), ("rule", "src/a.py", 4, True),
            ("rule", "src/b.py", 9, False), ("other", "src/b.py", 9, False)]
    mine = [Finding(r, p, n, "m", suppressed=s) for r, p, n, s in rows]
    ref = [jx.findings.Finding(r, p, n, "m", suppressed=s) for r, p, n, s in rows]
    base = {"src/b.py:9:rule"}
    got = [[f.key for f in part] for part in split_new(mine, base)]
    want = [[f.key for f in part] for part in jx.findings.split_new(ref, base)]
    assert got == want == [["src/a.py:3:broad-except", "src/b.py:9:other"],
                           ["src/a.py:4:rule", "src/b.py:9:rule"]]


def test_port_tree_is_clean():
    found = S.lint_tree()
    unsuppressed = [str(f) for f in found if not f.suppressed]
    assert unsuppressed == []
    assert {(f.path, f.rule) for f in found} == {
        ("src/repro_torch/serve/engine.py", "hot-nondeterminism"),
        ("src/repro_torch/train/loop.py", "broad-except"),
        ("src/repro_torch/launch/dryrun.py", "broad-except"),
        ("src/repro_torch/launch/hillclimb.py", "broad-except"),
        ("src/repro_torch/core/autotune.py", "broad-except")}


def test_baseline_is_empty():
    assert load_baseline() == set(), \
        "baseline.json must stay empty: fix or inline-suppress findings"


def test_every_suppression_names_its_rule_and_a_reason():
    marker = re.compile(r"#\s*servelint:")
    full = re.compile(r"#\s*servelint:\s*ignore\[[a-z0-9_-]+(,\s*[a-z0-9_-]+)*\]"
                      r"\s*[—–:-]\s*\S")
    seen = 0
    for p in sorted(SRC.rglob("*.py")):
        for n, text in enumerate(p.read_text().splitlines(), start=1):
            if marker.search(text) and "analysis/" not in p.as_posix():
                seen += 1
                assert full.search(text), f"{p}:{n}: {text.strip()}"
    assert seen == 7
    tolerated = [f for f in S.lint_tree() if f.suppressed]
    assert len(tolerated) == 7 and all(f.reason for f in tolerated)


# ---------------------------------------------------------------------------
# protocols


def test_scheduler_registries_conform(jx):
    mine, ms = P.check_protocols()
    ref, rs = jx.protocols.check_protocols()
    assert [str(f) for f in mine] == [str(f) for f in ref] == []
    assert ms == rs
    assert set(ms["schedulers"]) >= {"fifo", "slo", "speculative"}


def _breakers(base):
    class DoubleAdmit(base):
        def admission_order(self, view):
            return [0, 0] if view.queue else []

    class SlotDropper(base):
        def decode_order(self, view, ready):
            return list(ready)[:-1]

    class Inventor(base):
        def preempt_order(self, view, victims):
            return list(victims) + [7]

    return {"dup": DoubleAdmit, "drop": SlotDropper, "invent": Inventor}


@pytest.mark.parametrize("name,word", [("dup", "duplicate"),
                                       ("drop", "PERMUTE"),
                                       ("invent", "subsequence")])
def test_broken_schedulers_caught_as_jax(jx, name, word):
    from repro_torch.serve.scheduler import Scheduler

    mine = P._check_instance(name, _breakers(Scheduler)[name](), "x.py", 1)
    ref = jx.protocols._check_instance(
        name, _breakers(jx.scheduler.Scheduler)[name](), "x.py", 1)
    assert [f.message for f in mine] == [f.message for f in ref]
    assert mine and all(word in f.message for f in mine)


def test_nondelegating_wrapper_caught_as_jax(jx, tmp_path):
    p = tmp_path / "sched.py"
    p.write_text(textwrap.dedent("""
        class SneakyWrapper:
            def __init__(self, inner):
                self.inner = inner

            def admission_order(self, view):
                return self.inner.admission_order(view)

            def decode_order(self, view, ready):
                return list(reversed(self.inner.decode_order(view, ready)))

            def preempt_order(self, view, victims):
                return self.inner.preempt_order(view, victims[:1])
    """))
    mine = P._check_wrapper_delegation("sched.py", p)
    ref = jx.protocols._check_wrapper_delegation("sched.py", p)
    assert [(f.line, f.message) for f in mine] == \
        [(f.line, f.message) for f in ref]
    assert [f.line for f in mine] == [9, 12]
    assert all("VERBATIM" in f.message for f in mine)


# ---------------------------------------------------------------------------
# contracts


def test_pool_leaves_match_jax(jx):
    assert C.POOL_LEAVES == jx.contracts.POOL_LEAVES == ("kp", "vp", "ks", "vs")


@pytest.fixture(scope="module")
def cpu_proof():
    return C.check_contracts(device="cpu")


def test_capture_contract_holds_on_the_cpu(cpu_proof):
    findings, stats = cpu_proof
    assert [str(f) for f in findings] == []
    progs = stats["programs"]
    steps = ("ragged_step", "verify_step", "spec_rollback", "chunk_step",
             "decode_step")
    assert set(progs) == {f"{s}[{r}]" for s in steps
                          for r in ("gather", "kernel")} | {"page_gather",
                                                            "page_insert"}
    for name, rec in progs.items():
        assert rec["proved"] and rec["pointers_kept"] and rec["writes_landed"]
        assert rec["host_sync_ops"] == 0 and rec["captured"] is None
        assert rec["idle_identical"] is (None if name.startswith("page_")
                                         else True)


def test_assert_in_place_rejects_a_moved_pool():
    state = {"layers": [[{"kp": torch.zeros(4), "vp": torch.zeros(4),
                          "kpos": torch.zeros(2)}]]}
    before = C.pool_data_ptrs(state)
    assert set(before) == {"['layers'][0][0]['kp']", "['layers'][0][0]['vp']"}
    state["layers"][0][0]["kpos"] = torch.ones(2)  # not a pool leaf
    C.assert_in_place(before, state)
    state["layers"][0][0]["vp"] = torch.zeros(4)
    with pytest.raises(AssertionError, match="moved"):
        C.assert_in_place(before, state)
    del state["layers"][0][0]["vp"]
    with pytest.raises(AssertionError, match="vanished"):
        C.assert_in_place(before, state)


def _broken_ragged(breakage):
    """A ragged step program over a fresh smoke state whose step is broken
    as named."""
    cfg, params = C._smoke_setup(torch.device("cpu"))
    state = C._fresh_state(cfg, params)
    width = C.CHUNK + 1
    step = SS.make_ragged_step(cfg, width=width)
    cache = state["layers"][0][0]

    def fn(*inputs):
        if breakage == "item":
            int(inputs[4].sum().item())
        out = step(params, state, *inputs)[0].float()
        if breakage == "replaces-pool":
            cache["kp"] = cache["kp"] + 0
        elif breakage == "idle-writes":
            cache["ks"].add_(1.0)
        return out

    i32 = torch.int32
    specs = [((C.T,), i32)] * 4 + [((C.T,), torch.bool), ((C.B,), i32)]
    idle = SS.idle_ragged_pack(C.T, C.B, width)
    cs = SS.CapturedStep(fn, specs, idle, device="cpu")
    rng = np.random.RandomState(0)
    live = tuple(C._ragged_pack(rng, cfg.vocab_size, C.T, C.B, width,
                                [(0, 0, 5), (1, 0, 3)]) for _ in range(2))
    return C.Program(f"ragged_step[{breakage}]", cs.run, cs.run, live, idle,
                     C.POOL_LEAVES), state


@pytest.mark.parametrize("breakage,words", [
    ("none", None),
    ("replaces-pool", "moved"),
    ("idle-writes", "idle"),
    ("item", "host-synchronising"),
])
def test_broken_step_is_reported(breakage, words):
    prog, state = _broken_ragged(breakage)
    findings, rec = C.prove_program(prog, state)
    if words is None:
        assert findings == [] and rec["proved"]
        return
    assert findings and not rec["proved"]
    assert all(f.rule == "capture-contract" for f in findings)
    assert any(words in f.message for f in findings), [str(f) for f in findings]


@pytest.mark.parametrize("ragged,spec_k,host_pages,names", [
    (True, 2, 4, ["ragged_step", "rollback", "page_gather", "page_insert"]),
    (False, 0, 0, ["chunk_step", "decode_step", "page_gather",
                   "page_insert"]),
], ids=["ragged-spec-host", "two-phase"])
def test_a_served_engines_programs_are_proved(ragged, spec_k, host_pages,
                                              names):
    """``engine_programs`` proves an engine's own steps and movers, at its
    shapes, over its state after it has served a few ticks."""
    from repro_torch.serve.engine import ServeEngine

    cfg, params = C._smoke_setup(torch.device("cpu"))
    eng = ServeEngine(params, cfg, batch_size=2, cache_len=64, page_size=8,
                      prefill_chunk=8, token_budget=16, ragged=ragged,
                      spec_k=spec_k, host_pages=host_pages, kv_dtype="int8",
                      device="cpu")
    rng = np.random.RandomState(0)
    for n in (12, 5):
        eng.submit(rng.randint(0, cfg.vocab_size, n), max_tokens=16)
    for _ in range(3):
        eng.tick()
    state = eng._state
    ptrs = C.pool_data_ptrs(state)
    progs = C.engine_programs(eng)
    assert [p.name for p in progs] == names
    assert bool(eng._host_store) is bool(host_pages)
    for prog in progs:
        findings, rec = C.prove_program(prog, state)
        assert [str(f) for f in findings] == [] and rec["proved"], rec
        assert rec["captured"] is None  # nothing is captured on the CPU
    C.assert_in_place(ptrs, state)


@pytest.mark.parametrize("old,new,attr", [
    ("self._chunk_step = capture_paged_step(",
     "self._chunk_step = lookalike_paged_step(", "_chunk_step"),
    ("kw = dict(flash_decode=self.flash_decode, capture=self.cuda_graph)",
     "kw = dict(flash_decode=False, capture=self.cuda_graph)", "_ragged_step"),
    ("capture_spec_rollback(\n                    self.cfg, self._state, "
     "B=self.B, device=self.device,\n                    "
     "capture=self.cuda_graph)",
     "capture_spec_rollback(\n                    self.cfg, self._state, "
     "B=self.B, device=self.device,\n                    capture=True)",
     "_rollback"),
    ("self._insert_page = make_page_insert(cfg)",
     "self._insert_page = make_page_insert(cfg)\n"
     "        self._gather_page = make_page_gather(cfg)", "_gather_page"),
    ("from repro_torch.serve.serve_step import (CapturedStep, ",
     "def capture_ragged_step(*a, **k):\n    pass\n\n\n"
     "from repro_torch.serve.serve_step import (CapturedStep, ",
     "_ragged_step"),
])
def test_engine_builder_drift_is_reported(old, new, attr):
    src = C._ENGINE_PATH.read_text()
    assert src.count(old) == 1, old
    findings = C._check_engine_builders(ast.parse(src.replace(old, new)))
    assert findings and all(f.rule == "capture-contract" for f in findings)
    assert any(f"self.{attr}" in f.message for f in findings), \
        [str(f) for f in findings]


def test_pool_rebinding_in_serve_is_reported(tmp_path):
    p = tmp_path / "movers.py"
    p.write_text(textwrap.dedent("""\
        def promote(state, rows):
            cache = state["layers"][0][0]
            cache["kp"].copy_(rows)
            cache["vp"] = rows.clone()
            cache["kpos"] = rows
            a, state["layers"][0][0]["ks"] = 1, rows
        """))
    found = C._check_pool_rebinding([p])
    assert [(f.line, f.rule) for f in found] == [(4, "capture-contract"),
                                                 (6, "capture-contract")]


# ---------------------------------------------------------------------------
# CLI


def test_cli_gate(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    import json

    out = tmp_path / "findings.json"
    assert main(["--fail-on-findings", "--device", "cpu",
                 "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "0 actionable, 7 tolerated" in text
    for name in PASSES:
        assert f"[{name:>9}] " in text
    dumped = json.loads(out.read_text())
    assert len(dumped) == 7 and all(f["suppressed"] for f in dumped)


def test_cli_rejects_unknown_pass():
    from repro_torch.analysis.__main__ import main

    with pytest.raises(ValueError, match="unknown passes"):
        run_all(["nope"])
    with pytest.raises(ValueError, match="unknown passes"):
        main(["--passes", "lint,nope"])


def test_the_api_defaults_to_the_card():
    """The program proof runs on ``cuda`` unless the caller asks for the
    CPU; the AST layers need no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.analysis.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.check_contracts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--passes", "contracts"])
    findings, stats = C.check_contracts(compile_programs=False)
    assert findings == [] and stats == {"programs": {}}


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.gpu
def test_capture_contract_holds_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    findings, stats = C.check_contracts(device="cuda")
    assert [str(f) for f in findings] == []
    progs = stats["programs"]
    assert len(progs) == 12 and all(r["proved"] for r in progs.values())
    for name, rec in progs.items():
        assert rec["captured"] is (None if name.startswith("page_") else True)

"""The port's reordering schedulers against the JAX package, on the CPU:
the scheduler and engine cases of tests/test_serve_api.py.

- Policies (fifo, prefix-aware, slo, class-then-family, and the
  speculative wrapper over each): one sequence of hand-built
  ``EngineView``s fed to both packages' policies gives the same admission,
  prefill, decode and preemption orders, bypass backstops included; a
  hypothesis sequence of random queues, warmth and admissions does too.
- ``make_scheduler`` resolves every name and validates as JAX's does.
- Engine: every policy on shared-prefix traffic with mixed priorities, the
  prefix-aware win on interleaved families, slo admitting an interactive
  arrival first, class-then-family over a tiered pool with host hits:
  transcripts, completion order and merged ``stats`` equal the JAX
  engine's; malformed orders raise; a duck-typed policy with no name
  serves.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import (ENGINE_KW, assert_stats_equal,  # noqa: E402
                                 jax_pkg, leak_free, load_qwen, prompts)

from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.handle import Request  # noqa: E402

NAMES = ["fifo", "prefix-aware", "slo", "class-then-family"]
SCHED_KW = dict(ENGINE_KW, batch_size=2)


def _ns(side):
    """One package's Request, EngineView and scheduler module."""
    if side == "jax":
        J = jax_pkg()
        return types.SimpleNamespace(Request=J.handle.Request,
                                     View=J.sched.EngineView, S=J.sched)
    return types.SimpleNamespace(Request=Request, View=tsched.EngineView,
                                 S=tsched)


def _both(scenario):
    """Run ``scenario(ns)`` against each package; the results must agree."""
    want = scenario(_ns("jax"))
    assert scenario(_ns("torch")) == want
    return want


def _req(ns, uid, prompt, priority=0):
    return ns.Request(uid, np.asarray(prompt, np.int32), priority=priority)


def _view(ns, queue, page_size=4, cached=(), slots=(None, None), split=None):
    """An EngineView whose ``match_len`` walks ``cached`` prompts' full
    pages (tests/test_serve_api.py's fake index)."""
    cached = [tuple(int(t) for t in c) for c in cached]

    def match_len(prompt):
        best = 0
        for c in cached:
            n = 0
            while (n + page_size <= min(len(c), len(prompt))
                   and tuple(int(t) for t in prompt[n:n + page_size])
                   == c[n:n + page_size]):
                n += page_size
            best = max(best, n)
        return best

    return ns.View(queue=tuple(queue), slot_requests=tuple(slots),
                   slot_fill=(0,) * len(slots), budget=32, chunk=16,
                   page_size=page_size, match_len=match_len, match_split=split)


A, B = [7, 7, 7, 7], [9, 9, 9, 9]


def _fifo(ns):
    s = ns.S.FifoScheduler()
    v = _view(ns, [_req(ns, 1, [1] * 8), _req(ns, 2, [2] * 8)])
    return (list(s.admission_order(v)), s.decode_order(v, [0, 1]),
            s.prefill_order(v, [1]))


def _prefix_groups(ns):
    q = [_req(ns, 1, A + [1]), _req(ns, 2, B + [2]),
         _req(ns, 3, A + [3]), _req(ns, 4, B + [4])]
    return (list(ns.S.PrefixAwareScheduler(depth=8).admission_order(
                _view(ns, q, cached=[B]))),
            list(ns.S.PrefixAwareScheduler(depth=8).admission_order(
                _view(ns, q))),
            list(ns.S.PrefixAwareScheduler(depth=2).admission_order(
                _view(ns, q, cached=[B]))))


def _prefix_bypass(ns):
    s = ns.S.PrefixAwareScheduler(depth=8, max_bypass=2)
    head = _req(ns, 1, [5, 5, 5, 5, 1])
    return [list(s.admission_order(_view(
        ns, [head] + [_req(ns, u, B + [u]) for u in uids], cached=[B])))
        for uids in ([2, 3, 4], [3, 4], [4])]


def _stall_backstop(ns):
    s = ns.S.PrefixAwareScheduler(depth=8, max_bypass=2)
    q = [_req(ns, 1, [5, 5, 5, 5, 1]), _req(ns, 2, B + [2]),
         _req(ns, 3, B + [3])]
    v = _view(ns, q, cached=[B])
    out = [list(s.admission_order(v)) for _ in range(3)]
    q2 = [_req(ns, 4, [6, 6, 6, 6, 4]), _req(ns, 2, B + [2]),
          _req(ns, 3, B + [3])]
    return out + [list(s.admission_order(_view(ns, q2, cached=[B])))]


def _slo_classes(ns):
    s = ns.S.SloScheduler()
    q = [_req(ns, 1, [1] * 8), _req(ns, 2, [2] * 8, priority=1),
         _req(ns, 3, [3] * 8), _req(ns, 4, [4] * 8, priority=2)]
    v = _view(ns, q, slots=q)
    return (list(s.admission_order(v)), s.prefill_order(v, [0, 1]),
            s.decode_order(v, [0, 1, 2, 3]))


def _bypass_by_interactive(name):
    def scenario(ns):
        s = ns.S.make_scheduler(name)
        s.max_bypass = 2
        head = _req(ns, 1, [1] * 8)
        return [list(s.admission_order(_view(
            ns, [head, _req(ns, u, [u] * 8, priority=1)]))) for u in (2, 3, 4)]
    scenario.__name__ = f"_bypass_{name}"
    return scenario


def _ctf_partitions(ns):
    q = [_req(ns, 1, A + [1]), _req(ns, 2, B + [2]),
         _req(ns, 3, A + [3], priority=1), _req(ns, 4, A + [4]),
         _req(ns, 5, B + [5], priority=1)]
    return (list(ns.S.ClassThenFamilyScheduler(depth=8).admission_order(
                _view(ns, q, cached=[B]))),
            list(ns.S.ClassThenFamilyScheduler(depth=2).admission_order(
                _view(ns, q, cached=[B]))))


D_, H_, C_ = [1, 1, 1, 1], [2, 2, 2, 2], [3, 3, 3, 3]


def _split(prompt):
    head = tuple(int(t) for t in prompt[:4])
    return (4, 0) if head == tuple(D_) else \
        (0, 4) if head == tuple(H_) else (0, 0)


def _ctf_tiers(ns):
    q = [_req(ns, 1, C_ + [1]), _req(ns, 2, H_ + [2]), _req(ns, 3, D_ + [3])]
    v = ns.View(queue=tuple(q), slot_requests=(None, None), slot_fill=(0, 0),
                budget=32, chunk=16, page_size=4,
                match_len=lambda p: sum(_split(p)), match_split=_split)
    v2 = dataclasses.replace(v, match_split=None)
    return [list(ns.S.ClassThenFamilyScheduler(depth=8).admission_order(x))
            for x in (v, v2)]


def _ctf_prefill(ns):
    s = ns.S.ClassThenFamilyScheduler()
    q = [_req(ns, 1, [1] * 8), _req(ns, 2, [2] * 8, priority=2),
         _req(ns, 3, [3] * 8, priority=1), _req(ns, 4, [4] * 8, priority=2),
         _req(ns, 5, [5] * 8)]
    v = _view(ns, (), slots=q)
    return [s.prefill_order(v, f) for f in ([0, 1, 2, 3, 4], [4, 2, 1],
                                            [0, 4])]


def _ctf_prefill_vs_tiers(ns):
    q = [_req(ns, 1, D_ + [1]), _req(ns, 2, H_ + [2]),
         _req(ns, 3, [3] * 8, priority=1)]
    s = ns.S.ClassThenFamilyScheduler(depth=8)
    cold = _view(ns, q, slots=q)
    tiered = dataclasses.replace(cold, match_len=lambda p: sum(_split(p)),
                                 match_split=_split)
    return (list(s.admission_order(tiered)),
            [s.prefill_order(v, [0, 1, 2]) for v in (cold, tiered)])


def _speculative(ns):
    out = []
    for name in NAMES:
        s = ns.S.SpeculativeScheduler(name, spec_k=3)
        q = [_req(ns, 1, A + [1]), _req(ns, 2, B + [2], priority=1),
             _req(ns, 3, A + [3])]
        v = _view(ns, q, cached=[B], slots=q)
        out.append((s.name, list(s.admission_order(v)),
                    list(s.prefill_order(v, [0, 1, 2])),
                    list(s.decode_order(v, [2, 0, 1])),
                    list(s.preempt_order(v, [0, 1, 2])),
                    s.draft([1, 2, 1, 2, 1, 2], 9)))
    return out


SCENARIOS = {
    "fifo": (_fifo, ([0, 1], [0, 1], [1])),
    "prefix-groups": (_prefix_groups, ([1, 3, 0, 2], [0, 2, 1, 3],
                                       [1, 0, 2, 3])),
    "prefix-bypass": (_prefix_bypass, None),
    "stall-backstop": (_stall_backstop, None),
    "slo-classes": (_slo_classes, ([3, 1, 0, 2], [1, 0], [0, 1, 2, 3])),
    "slo-bypass": (_bypass_by_interactive("slo"),
                   [[1, 0], [1, 0], [0, 1]]),
    "ctf-bypass": (_bypass_by_interactive("class-then-family"),
                   [[1, 0], [1, 0], [0, 1]]),
    "ctf-partitions": (_ctf_partitions, None),
    "ctf-tiers": (_ctf_tiers, [[2, 1, 0], [1, 2, 0]]),
    "ctf-prefill": (_ctf_prefill, [[1, 3, 2, 0, 4], [1, 2, 4], [0, 4]]),
    "ctf-prefill-vs-tiers": (_ctf_prefill_vs_tiers,
                             ([2, 0, 1], [[2, 0, 1], [2, 0, 1]])),
    "speculative": (_speculative, None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_policy_orders_equal_jax(name):
    scenario, expected = SCENARIOS[name]
    got = _both(scenario)
    if expected is not None:  # tests/test_serve_api.py's expectations
        assert got == expected


@settings(max_examples=25, deadline=None)
@given(name=st.sampled_from(NAMES[1:]),
       steps=st.lists(st.tuples(st.integers(1, 6), st.integers(0, 63),
                                st.integers(0, 3)), min_size=1, max_size=12),
       depth=st.integers(1, 6), max_bypass=st.integers(1, 3))
def test_policy_sequences_equal_jax(name, steps, depth, max_bypass):
    """A sequence of rounds: each round's queue, priorities and warmth
    drawn from the step, and the front of the queue admitted between
    rounds as far as the step says — the stateful bypass bookkeeping of
    both packages' policies stays in step."""
    def scenario(ns):
        s = ns.S.make_scheduler(name)
        s.depth, s.max_bypass = depth, max_bypass
        rng = np.random.RandomState(7)
        queue, uid, out = [], 0, []
        for n_new, bits, admit in steps:
            for _ in range(n_new):
                uid += 1
                fam = int(rng.randint(0, 3))
                queue.append(_req(ns, uid, [fam] * 4 + [uid],
                                  priority=int(rng.randint(0, 2))))
            cached = [[f] * 4 for f in range(3) if bits >> f & 1]
            split = (lambda p: (0, 4) if int(p[0]) == 0 and bits & 8
                     else (4, 0) if [int(p[0])] * 4 in cached else (0, 0))
            v = _view(ns, queue, cached=cached, split=split,
                      slots=queue[:3] or [None])
            order = list(s.admission_order(v))
            out.append((order, list(s.prefill_order(v, list(range(len(
                v.slot_requests))) if queue else [])),
                list(s.preempt_order(v, list(range(len(queue[:3])))))))
            taken = {order[i] for i in range(min(admit, len(order)))}
            queue = [r for i, r in enumerate(queue) if i not in taken]
        return out

    _both(scenario)


def test_make_scheduler_resolution_and_validation():
    for name in NAMES:
        assert tsched.make_scheduler(name).name == name
    assert isinstance(tsched.make_scheduler(None), tsched.FifoScheduler)
    assert isinstance(tsched.make_scheduler("speculative"),
                      tsched.SpeculativeScheduler)
    assert sorted(tsched.SCHEDULERS) == sorted(jax_pkg().sched.SCHEDULERS)
    with pytest.raises(ValueError):
        tsched.make_scheduler("lifo")
    with pytest.raises(TypeError):
        tsched.make_scheduler(object())
    custom = tsched.Scheduler()  # the protocol's defaults are a policy
    assert tsched.make_scheduler(custom) is custom
    for bad in (dict(depth=0), dict(max_bypass=0)):
        with pytest.raises(ValueError):
            tsched.PrefixAwareScheduler(**bad)


# ---------------------------------------------------------------------------
# the engine under each policy, against JAX's


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


def _pair(qwen, **kw):
    cfg, tcfg, jp, tp = qwen
    kw = dict(SCHED_KW, **kw)
    return (jax_pkg().Engine(jp, cfg, **kw),
            ServeEngine(tp, tcfg, device="cpu", **kw))


def _mixed(eng, vocab):
    [shared] = prompts(vocab, [16], seed=90)
    ps = ([np.concatenate([shared, s]) for s in prompts(vocab, [4, 6], seed=91)]
          + prompts(vocab, [7, 11], seed=92))
    uids = [eng.submit(p, max_tokens=4, priority=i % 2)
            for i, p in enumerate(ps)]
    got = eng.run()
    return [got[u] for u in uids], list(eng.completion_order)


@pytest.mark.parametrize("name", NAMES + ["speculative-slo"])
def test_engine_under_each_policy_equals_jax(qwen, name):
    """Shared-prefix traffic with mixed priorities: transcripts,
    completion order and merged stats equal JAX's under every policy; the
    transcripts equal FIFO's (policies reorder work, never change it)."""
    vocab = qwen[1].vocab_size
    if name == "speculative-slo":
        J = jax_pkg()
        je = J.Engine(qwen[2], qwen[0], scheduler=J.sched.SpeculativeScheduler(
            "slo", spec_k=3), **SCHED_KW)
        te = ServeEngine(qwen[3], qwen[1], device="cpu",
                         scheduler=tsched.SpeculativeScheduler("slo", spec_k=3),
                         **SCHED_KW)
    else:
        je, te = _pair(qwen, scheduler=name)
    got = _mixed(te, vocab)
    assert got == _mixed(je, vocab)
    assert_stats_equal(te, je.stats)
    fifo = ServeEngine(qwen[3], qwen[1], device="cpu", **SCHED_KW)
    assert got[0] == _mixed(fifo, vocab)[0]
    assert te.stats["traces"] == 1 and leak_free(te)


def _families_interleaved(eng, vocab):
    fams = prompts(vocab, [24, 24], seed=93)
    ps = [np.concatenate([fams[f], s])
          for s in prompts(vocab, [3, 4, 5], seed=94) for f in range(2)]
    uids = [eng.submit(p, max_tokens=2) for p in ps]
    got = eng.run()
    return [got[u] for u in uids]


def test_prefix_aware_beats_fifo_like_jax(qwen):
    stats = {}
    for name in ("fifo", "prefix-aware"):
        je, te = _pair(qwen, scheduler=name, batch_size=1, max_pages=5)
        assert (_families_interleaved(te, qwen[1].vocab_size)
                == _families_interleaved(je, qwen[0].vocab_size))
        assert_stats_equal(te, je.stats)
        stats[name] = te.stats
    pa, ff = stats["prefix-aware"], stats["fifo"]
    assert pa["prefix_tokens_reused"] > ff["prefix_tokens_reused"]
    assert pa["packed_tokens"] < ff["packed_tokens"]
    assert pa["evictions"] <= ff["evictions"]


@pytest.mark.parametrize("name", ["slo", "fifo"])
def test_slo_admits_interactive_first_like_jax(qwen, name):
    def run(eng, vocab):
        docs = prompts(vocab, [40, 40, 40], seed=95)
        [chat] = prompts(vocab, [5], seed=96)
        uids = [eng.submit(p, max_tokens=2) for p in docs]
        uids.append(eng.submit(chat, max_tokens=2, priority=1))
        got = eng.run()
        return [got[u] for u in uids], eng.completion_order.index(uids[-1])

    je, te = _pair(qwen, scheduler=name, batch_size=1)
    got = run(te, qwen[1].vocab_size)
    assert got == run(je, qwen[0].vocab_size)
    assert got[1] == (0 if name == "slo" else 3)
    assert_stats_equal(te, je.stats)


def _ctf_host_hits(eng, vocab):
    [fam] = prompts(vocab, [16], seed=310)
    family = [np.concatenate([fam, s]) for s in prompts(vocab, [2, 3],
                                                        seed=311)]
    for p in family:
        eng.submit(p, max_tokens=4)
    eng.run()
    [filler] = prompts(vocab, [24], seed=313)
    eng.submit(filler, max_tokens=4)
    eng.run()
    hb = [eng.submit(p, max_tokens=4) for p in family]
    hi = eng.submit(prompts(vocab, [12], seed=312)[0], max_tokens=4,
                    priority=1)
    got = eng.run()
    return [got[h] for h in hb] + [got[hi]], list(eng.completion_order)


def test_class_then_family_with_host_hits_equals_jax(qwen):
    je, te = _pair(qwen, scheduler="class-then-family", max_pages=4,
                   host_pages=12, prefill_chunk=8)
    assert _ctf_host_hits(te, qwen[1].vocab_size) == _ctf_host_hits(
        je, qwen[0].vocab_size)
    assert_stats_equal(te, je.stats)
    assert te.stats["host_hits"] >= 1 and te.stats["demotions"] >= 1
    assert leak_free(te)


def test_engine_rejects_malformed_orders(qwen):
    class BrokenAdmit(tsched.Scheduler):
        name = "broken"

        def admission_order(self, view):
            return [0, 0]

    class BrokenPack(tsched.Scheduler):
        name = "broken-pack"

        def decode_order(self, view, ready):
            return list(ready) + list(ready)

    class BrokenPreempt(tsched.SloScheduler):
        def preempt_order(self, view, victims):
            return [99]

    for sched, run in ((BrokenAdmit(), "tick"), (BrokenPack(), "run")):
        te = ServeEngine(qwen[3], qwen[1], device="cpu", scheduler=sched,
                         **SCHED_KW)
        te.submit(np.arange(1, 9, dtype=np.int32), max_tokens=2)
        with pytest.raises(ValueError):
            getattr(te, run)()
    te = ServeEngine(qwen[3], qwen[1], device="cpu", scheduler=BrokenPreempt(),
                     max_pages=4, **dict(SCHED_KW, batch_size=1))
    te.submit(prompts(qwen[1].vocab_size, [16])[0], max_tokens=16)
    for _ in range(4):
        te.tick()
    te.submit(np.arange(1, 7, dtype=np.int32), max_tokens=3, priority=1)
    with pytest.raises(ValueError, match="preempt_order"):
        te.tick()


def test_duck_typed_scheduler_without_name(qwen):
    class Nameless:
        def admission_order(self, view):
            return range(len(view.queue))

        def decode_order(self, view, ready):
            return ready

        def prefill_order(self, view, filling):
            return filling

    te = ServeEngine(qwen[3], qwen[1], device="cpu", scheduler=Nameless(),
                     **SCHED_KW)
    assert te.stats["scheduler"] == "Nameless"
    [p] = prompts(qwen[1].vocab_size, [6], seed=110)
    fifo = ServeEngine(qwen[3], qwen[1], device="cpu", **SCHED_KW)
    assert te.submit(p, max_tokens=2).result() == \
        fifo.submit(p, max_tokens=2).result()

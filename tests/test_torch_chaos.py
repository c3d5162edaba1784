"""The port's fault injection against the JAX package, on the CPU: the
scenarios of tests/test_chaos.py.

- ``FaultInjector``: the same schedule and log as JAX's for the same seed
  and probabilities; a pure function of (seed, tick), independent of the
  order of consultation and of how many requests are live.
- Chaos runs (allocation failures, cancels, host eviction storms, stalled
  ticks) through a tiered engine under the slo policy, float32 and int8
  pools: every request's outcome (tokens, typed error) and the merged
  ``stats`` equal the JAX engine's; completed transcripts equal a fault-
  free run's; both tiers drain; one trace.  A stalled clock still fires
  deadlines.
- Property: random submit / tick / cancel interleavings with priorities and
  deadlines, through an undersized tiered pool with faults, speculation off
  and on, driven through both packages' engines in lockstep: the same
  outcomes and stats after every example, completed transcripts equal to
  an unpressured run, nothing leaked.
"""
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import (ENGINE_KW, assert_stats_equal,  # noqa: E402
                                 jax_pkg, leak_free, load_qwen, outcome,
                                 prompts)

from repro_torch.serve.chaos import FaultInjector  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.errors import Cancelled, ServeError  # noqa: E402

CHAOS_KW = dict(ENGINE_KW, batch_size=2)


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


def _engines(qwen, injector_kw=None, **kw):
    """(JAX engine, port engine) with the same settings and, when
    ``injector_kw`` is given, each with its package's FaultInjector."""
    cfg, tcfg, jp, tp = qwen
    J = jax_pkg()
    jkw, tkw = dict(CHAOS_KW, **kw), dict(CHAOS_KW, **kw)
    if injector_kw is not None:
        jkw["fault_injector"] = J.chaos.FaultInjector(**injector_kw)
        tkw["fault_injector"] = FaultInjector(**injector_kw)
    return J.Engine(jp, cfg, **jkw), ServeEngine(tp, tcfg, device="cpu", **tkw)


# ---------------------------------------------------------------------------
# FaultInjector


@pytest.mark.parametrize("kw", [
    dict(seed=11, p_alloc_fail=0.4, p_cancel=0.4, p_evict_storm=0.4,
         p_stall=0.4),
    dict(seed=3, p_cancel=0.5, p_evict_storm=0.5, p_stall=0.5),
    dict(seed=7, p_alloc_fail=0.1, p_cancel=0.05, p_stall=0.05,
         p_evict_storm=0.05, start_tick=5, stop_tick=30)],
    ids=["all-0.4", "no-alloc-fail", "windowed"])
def test_fault_schedule_equals_jax(kw):
    a, b = jax_pkg().chaos.FaultInjector(**kw), FaultInjector(**kw)
    for t in range(40):
        live = list(range(t % 5))
        assert b.faults(t, live) == a.faults(t, live), t
    assert b.log == a.log and b.log


def test_fault_schedule_is_pure_function_of_seed_and_tick():
    kw = dict(p_alloc_fail=0.4, p_cancel=0.4, p_evict_storm=0.4, p_stall=0.4)
    a, b = FaultInjector(seed=11, **kw), FaultInjector(seed=11, **kw)
    sched_a = [a.faults(t, [3, 1, 2]) for t in range(40)]
    sched_b = {t: b.faults(t, [2, 3, 1]) for t in reversed(range(40))}
    for t in range(40):
        assert sched_a[t] == b.faults(t, [1, 2, 3]) == sched_b[t]
    assert any(f["alloc_fail"] for f in sched_a)
    assert any(f["cancel"] is not None for f in sched_a)


def test_fault_draws_independent_of_liveness():
    kw = dict(p_cancel=0.5, p_evict_storm=0.5, p_stall=0.5)
    a, b = FaultInjector(seed=3, **kw), FaultInjector(seed=3, **kw)
    for t in range(30):
        fa, fb = a.faults(t, [7, 8]), b.faults(t, [])
        assert fb["cancel"] is None
        assert (fa["evict_storm"], fa["stall"]) == (fb["evict_storm"],
                                                    fb["stall"])


def test_fault_window_and_validation():
    fi = FaultInjector(seed=0, p_stall=1.0, start_tick=10, stop_tick=12)
    assert [t for t in range(20) if fi.faults(t, [])["stall"]] == [10, 11]
    assert fi.log == [(10, "stall", None), (11, "stall", None)]
    for bad in (dict(p_cancel=1.5), dict(p_alloc_fail=-0.1)):
        with pytest.raises(ValueError):
            FaultInjector(**bad)


# ---------------------------------------------------------------------------
# chaos runs against JAX's


def _chaos(eng, cfg):
    handles = [eng.submit(p, max_tokens=6, priority=i % 2)
               for i, p in enumerate(prompts(cfg.vocab_size,
                                             [16, 16, 6, 6, 12, 8]))]
    eng.run()
    assert all(h.done for h in handles)
    return outcome(handles)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("seed", [3, 4, 9])
def test_chaos_run_equals_jax(qwen, seed, kv_dtype):
    cfg, tcfg, jp, tp = qwen
    inj = dict(seed=seed, p_alloc_fail=0.3, p_cancel=0.1, p_evict_storm=0.2,
               p_stall=0.2)
    je, te = _engines(qwen, inj, max_pages=8, host_pages=8, scheduler="slo",
                      kv_dtype=kv_dtype)
    want = _chaos(je, cfg)
    got = _chaos(te, tcfg)
    assert got == want
    assert_stats_equal(te, je.stats)
    assert te.fault_injector.log == je.fault_injector.log
    clean = ServeEngine(tp, tcfg, device="cpu", max_pages=16, host_pages=8,
                        scheduler="slo", kv_dtype=kv_dtype, **CHAOS_KW)
    ref = [clean.submit(p, max_tokens=6).result()
           for p in prompts(cfg.vocab_size, [16, 16, 6, 6, 12, 8])]
    n_ok = 0
    for (toks, err, _), w in zip(got, ref):
        if err is not None:
            assert err in ("Cancelled", "DeadlineExceeded")
        elif len(toks) == 6:
            assert toks == w  # survived == unchanged
            n_ok += 1
    assert n_ok >= 1
    st_ = te.stats
    assert (st_["chaos_alloc_fails"] + st_["chaos_cancels"]
            + st_["chaos_evict_storms"] + st_["chaos_stalled_ticks"]) > 0
    assert st_["traces"] == 1 and leak_free(te)


def test_chaos_errors_are_typed(qwen):
    """An engine-side cancel raises ``Cancelled`` from its handle (a
    ``ServeError``), with the partial output attached."""
    _, te = _engines(qwen, dict(seed=1, p_cancel=1.0, start_tick=3),
                     host_pages=4)
    (p,) = prompts(qwen[1].vocab_size, [8])
    h = te.submit(p, max_tokens=16)
    te.run()
    assert isinstance(h.request.error, Cancelled)
    assert isinstance(h.request.error, ServeError)
    with pytest.raises(Cancelled) as exc:
        h.result()
    assert exc.value.tokens == h.request.out_tokens and exc.value.tokens
    assert te.stats["chaos_cancels"] == 1 and leak_free(te)


def _stalled(eng, cfg):
    (p,) = prompts(cfg.vocab_size, [8])
    h = eng.submit(p, max_tokens=4, deadline_ticks=3)
    for _ in range(5):
        eng.tick()
    try:
        h.result(max_ticks=1)
    except TimeoutError as e:  # both packages' DeadlineExceeded
        return outcome([h]), type(e).__name__


def test_stall_advances_deadlines_like_jax(qwen):
    je, te = _engines(qwen, dict(seed=0, p_stall=1.0))
    assert _stalled(te, qwen[1]) == _stalled(je, qwen[0]) == (
        [([], "DeadlineExceeded", False)], "DeadlineExceeded")
    assert_stats_equal(te, je.stats)
    assert te.stats["chaos_stalled_ticks"] >= 3 and leak_free(te)


# ---------------------------------------------------------------------------
# property: pressure interleavings, both engines in lockstep


def _drive(eng, ps, ops):
    handles = []
    for op, j in ops:
        if op == "submit":
            k = j % len(ps)
            hog = len(ps[k]) > 8
            handles.append(eng.submit(
                ps[k], max_tokens=8 if hog else 3, priority=0 if hog else 1,
                deadline_ticks=None if j % 3 else 16))
        elif op == "tick":
            eng.tick()
        elif handles:
            handles[j % len(handles)].cancel()
    eng.run()
    assert all(h.done for h in handles)
    return outcome(handles)


def _lockstep(fn, qwen, spec_k):
    """One pair of engines (and an unpressured reference) shared across
    examples: later examples start from the cache and tier state earlier
    ones left, in both engines alike."""
    if not hasattr(fn, "_st"):
        _, tcfg, _, tp = qwen
        ps = prompts(tcfg.vocab_size, [16, 16, 6, 6])
        ref = ServeEngine(tp, tcfg, device="cpu", max_pages=24, **CHAOS_KW)
        expect = [ref.submit(p, max_tokens=8).result() for p in ps]
        inj = dict(seed=7, p_alloc_fail=0.1, p_cancel=0.05, p_stall=0.05,
                   p_evict_storm=0.05)
        je, te = _engines(qwen, inj, max_pages=6, host_pages=8,
                          scheduler="slo", spec_k=spec_k)
        fn._st = (je, te, ps, expect)
    return fn._st


def _check_lockstep(fn, qwen, spec_k, ops):
    je, te, ps, expect = _lockstep(fn, qwen, spec_k)
    got = _drive(te, ps, ops)
    assert got == _drive(je, ps, ops)
    assert_stats_equal(te, je.stats)
    for (toks, err, cancelled), (op, j) in zip(
            got, [o for o in ops if o[0] == "submit"]):
        k = j % len(ps)
        n = 8 if len(ps[k]) > 8 else 3
        if err is None and not cancelled and len(toks) == n:
            assert toks == expect[k][:n]
    assert leak_free(te) and te.stats["traces"] == 1


OPS = st.lists(st.tuples(st.sampled_from(["submit", "tick", "tick", "cancel"]),
                         st.integers(0, 7)), min_size=4, max_size=16)


@settings(max_examples=5, deadline=None)
@given(ops=OPS)
def test_pressure_interleavings_equal_jax(qwen, ops):
    _check_lockstep(test_pressure_interleavings_equal_jax, qwen, 0, ops)


@settings(max_examples=5, deadline=None)
@given(ops=OPS)
def test_pressure_interleavings_equal_jax_speculative(qwen, ops):
    _check_lockstep(test_pressure_interleavings_equal_jax_speculative, qwen,
                    4, ops)

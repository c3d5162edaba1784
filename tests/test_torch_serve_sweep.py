"""The engine's host-only logs and the serving sweep's helpers against the
JAX package, on the CPU (the sweep's scenarios: test_torch_serve_sweep_*.py).

- ``ServeEngine.token_log`` / ``tick_log``: on the same traffic and the
  same weights, the (uid, tick) columns of every booked token and the
  had-prefill column of every tick equal the JAX engine's, on the ragged
  and the two-phase paths and with fault-injected stalled ticks (logged
  with ``False``); ``cached_pages`` and ``_ref`` equal JAX's along the way.
- ``serve_sweep._traffic`` equals JAX's arrays; ``_p50_token_gap_ms`` gives
  JAX's number on one synthetic log object passed to both.
- On a card (``gpu``): the sweep's smoke scenarios keep their gates on the
  captured engines.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import (ENGINE_KW, jax_pkg, jax_sweep,  # noqa: E402
                                 load_qwen, prompts)

from repro_torch.benchmarks import serve_sweep as TS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.serve.chaos import FaultInjector  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


def log_columns(eng):
    """The deterministic columns of an engine's logs: (uid, tick) per
    booked token and had-prefill per tick."""
    return ([(uid, tick) for uid, tick, _ in eng.token_log],
            [hp for hp, _ in eng.tick_log])


def drive_both(qwen, lens, *, stall=None, ticks_between=3, **kw):
    """The same traffic through the JAX engine and the port's: half the
    prompts at first, the rest after ``ticks_between`` ticks; each engine's
    ``cached_pages`` and ``_ref`` after every tick.  Returns (port engine,
    JAX engine, port pool views, JAX pool views)."""
    cfg, tcfg, jp, tp = qwen
    J = jax_pkg()
    engs = []
    for Engine, params, c, chaos in (
            (J.Engine, jp, cfg, J.chaos), (ServeEngine, tp, tcfg, None)):
        ekw = dict(ENGINE_KW, **kw)
        if stall is not None:
            fi = (J.chaos.FaultInjector if chaos else FaultInjector)(
                seed=stall, p_stall=0.3)
            ekw["fault_injector"] = fi
        if Engine is ServeEngine:
            ekw["device"] = "cpu"
        eng = Engine(params, c, **ekw)
        ps = prompts(c.vocab_size, lens, seed=4)
        views = []
        half = len(ps) // 2
        for p in ps[:half]:
            eng.submit(p, max_tokens=6)
        for _ in range(ticks_between):
            eng.tick()
            views.append((eng.cached_pages, eng._ref.copy()))
        for p in ps[half:]:
            eng.submit(p, max_tokens=6)
        while not eng.idle:
            eng.tick()
            views.append((eng.cached_pages, eng._ref.copy()))
        engs.append((eng, views))
    (jeng, jviews), (teng, tviews) = engs
    return teng, jeng, tviews, jviews


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_logs_match_jax(qwen, ragged):
    teng, jeng, tviews, jviews = drive_both(
        qwen, (12, 30, 7, 21, 40, 9), ragged=ragged, batch_size=2)
    assert log_columns(teng) == log_columns(jeng)
    assert len(teng.token_log) == 6 * 6
    assert any(hp for hp, _ in teng.tick_log)
    assert not teng.tick_log[-1][0]  # the drain ends on decode ticks
    # wall times rise along each log
    for log, col in ((teng.token_log, 2), (teng.tick_log, 1)):
        times = [row[col] for row in log]
        assert times == sorted(times)
    assert len(tviews) == len(jviews)
    for (tc, tref), (jc, jref) in zip(tviews, jviews):
        assert tc == jc
        np.testing.assert_array_equal(tref, np.asarray(jref))
    assert teng.cached_pages == jeng.cached_pages > 0
    assert (teng._ref == 0).all()


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_stalled_ticks_log_like_jax(qwen, ragged):
    teng, jeng, _, _ = drive_both(qwen, (12, 30, 7, 21), stall=3,
                                  ragged=ragged, batch_size=2)
    assert teng.stats["chaos_stalled_ticks"] == \
        jeng.stats["chaos_stalled_ticks"] > 0
    assert log_columns(teng) == log_columns(jeng)
    assert len(teng.tick_log) == teng.stats["ticks"]


def test_ref_and_cached_pages_are_pool_views(qwen):
    _, tcfg, _, tp = qwen
    eng = ServeEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    assert eng._ref is eng.pool._ref
    assert eng.cached_pages == eng.pool.cached_pages == 0


@pytest.mark.parametrize("users,budget,max_tokens",
                         [(4, 124, 4), (16, 120, 8), (9, 60, 3)])
def test_traffic_matches_jax(users, budget, max_tokens):
    S = jax_sweep()
    J = jax_pkg()
    cfg = J.get_config("qwen2-1.5b", smoke=True)
    tcfg = tget("qwen2-1.5b", smoke=True)
    assert TS.MIX == S.MIX
    got = TS._traffic(tcfg, users, budget, max_tokens)
    want = S._traffic(cfg, users, budget, max_tokens)
    assert len(got) == len(want) == users
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_p50_token_gap_matches_jax():
    S = jax_sweep()
    rng = np.random.RandomState(9)
    t, token_log, tick_log = 0.0, [], []
    for tick in range(40):
        t += float(rng.uniform(1e-3, 5e-3))
        tick_log.append((bool(rng.rand() < 0.4), t))
        for uid in range(5):
            if rng.rand() < 0.6:
                token_log.append((uid, tick, t + float(rng.uniform(0, 1e-4))))
    log = types.SimpleNamespace(token_log=token_log, tick_log=tick_log)
    for skip in (0, 7):
        for under in (False, True):
            got = TS._p50_token_gap_ms(log, skip=skip,
                                       under_prefill_only=under)
            assert got == S._p50_token_gap_ms(log, skip=skip,
                                              under_prefill_only=under)
            assert got > 0
    empty = types.SimpleNamespace(token_log=[(0, 0, 1.0)], tick_log=[])
    assert np.isnan(TS._p50_token_gap_ms(empty))


@pytest.mark.gpu
def test_sweep_scenarios_keep_their_gates_on_the_card():
    """The sweep's smoke model (bf16, seed-0 weights) on the card through
    captured engines: the tiered, speculative and preemption scenarios keep
    transcripts identical, drain both tiers and trace once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, params = TS.seed_params("qwen2-1.5b", "cuda")
    tiered = TS.tiered_kv_scenario(cfg, params)
    spec = TS.speculative_scenario(cfg, params)
    pre = TS.preemption_scenario(cfg, params)
    assert tiered["token_identical"] and tiered["host_hit_rate"] == 1.0
    assert spec["token_identical"] and spec["page_leak_free"]
    assert spec["spec-on"]["accepted"] > 0
    assert pre["token_identical"] and pre["page_leak_free"]
    assert pre["preempt"]["preemptions"] > 0
    for r in (tiered["drop-on-evict"], tiered["host-tier"], spec["spec-off"],
              spec["spec-on"], pre["stall"], pre["preempt"], pre["chaos"]):
        assert r["traces"] == 1

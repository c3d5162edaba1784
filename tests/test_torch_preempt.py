"""The port's preemption against the JAX package, on the CPU: the
scenarios of tests/test_preemption.py.

- Pool: ``park`` / ``unpark`` / ``drop_parked`` and a storm beside a park,
  run on both packages' ``PagePool``s: the same results, events and stats.
- Engine: a hog fills the only slot and the whole pool, an interactive
  request (priority 1) arrives mid-decode and preempts it; the hog resumes
  by unparking (host tier) or by re-prefilling its history (no host tier),
  under the slo and class-then-family policies, float32 and int8 pools,
  with and without speculation.  Transcripts and merged ``stats`` equal the
  JAX engine's and the unpreempted run's; one trace; both tiers drain.
  ``preempt=False`` stalls instead; equal priorities never preempt.
- Typed errors and deadlines: ``RequestTooLarge``, ``EngineOverloaded``,
  ``DeadlineExceeded`` (live, and queued behind a hog), the drain bound of
  ``result(timeout_ticks=)``, an engine-side ``Cancelled``: the same
  outcomes as JAX.
- ``preempt_order``: the default ranking and the slo policies' exemption
  of the interactive class, on one view fed to both packages' policies.
- On a card (``gpu``): the captured preempting engine against
  ``cuda_graph=False`` on both resume paths.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import (ENGINE_KW, assert_stats_equal,  # noqa: E402
                                 jax_pkg, leak_free, load_qwen, outcome,
                                 prompts)

from repro_torch.configs.util import dense_lm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.errors import (Cancelled, DeadlineExceeded,  # noqa: E402
                                      EngineOverloaded, RequestTooLarge,
                                      ServeError)
from repro_torch.serve.handle import Request  # noqa: E402
from repro_torch.serve.pool import PagePool  # noqa: E402

PRE_KW = dict(ENGINE_KW, batch_size=1)


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


@pytest.fixture(scope="module")
def jax_runs(qwen):
    """Each JAX scenario runs once per module."""
    cfg, _, jp, _ = qwen
    cache = {}

    def run(scenario, **kw):
        key = (scenario.__name__, tuple(sorted(kw.items())))
        if key not in cache:
            eng = jax_pkg().Engine(jp, cfg, **{**PRE_KW, **kw})
            cache[key] = (scenario(eng, cfg), eng.stats)
        return cache[key]

    return run


def _port(qwen, **kw):
    _, tcfg, _, tp = qwen
    return ServeEngine(tp, tcfg, device="cpu", **{**PRE_KW, **kw})


# ---------------------------------------------------------------------------
# the pool's park / unpark / drop_parked against JAX's


def _park(pool):
    pages = pool.alloc(3)
    return pages, pool.park(pages), pool.parked_pages, pool.free_pages


def _park_too_big(pool):
    pages = pool.alloc(3)
    return pool.park(pages), pool.parked_pages, pool.free_pages


def _unpark(pool):
    slots = pool.park(pool.alloc(2))
    pool.drain_events()
    return pool.unpark(slots), pool.parked_pages, sorted(pool._host_free)


def _drop_parked(pool):
    slots = pool.park(pool.alloc(2))
    pool.drain_events()
    pool.drop_parked(slots + [99])  # an unknown slot is ignored
    return pool.parked_pages, sorted(pool._host_free)


def _storm_spares_parks(pool):
    slots = pool.park(pool.alloc(2))
    node, _, _, _ = pool.match_prefix(np.arange(4))
    (pg,) = pool.alloc(1)
    pool.index_page(node, (0, 1), pg)
    pool.release([pg])
    pool.evict_one()  # demotes the cached page
    return slots, pool.storm_host_cache(), pool.parked_pages, \
        sorted(pool._parked)


@pytest.mark.parametrize("script,shape", [
    (_park, (4, 4, 4)), (_park_too_big, (4, 4, 2)), (_park_too_big, (4, 4, 0)),
    (_unpark, (4, 4, 4)), (_drop_parked, (4, 4, 4)),
    (_storm_spares_parks, (8, 2, 8))],
    ids=["park", "park-too-big", "park-untiered", "unpark", "drop-parked",
         "storm-spares-parks"])
def test_pool_park_scripts_equal_jax(script, shape):
    n, P, host = shape
    jpool = jax_pkg().pool.PagePool(n, P, host_pages=host)
    tpool = PagePool(n, P, host_pages=host)
    assert script(tpool) == script(jpool)
    assert tpool.drain_events() == jpool.drain_events()
    assert tpool.stats == jpool.stats
    assert sorted(tpool._free) == sorted(jpool._free)


# ---------------------------------------------------------------------------
# preempt and resume through the engine


def _overload(eng, cfg):
    """One hog fills the only slot and the whole pool; an interactive chat
    arrives mid-decode (tests/test_preemption.py)."""
    hog, chat = prompts(cfg.vocab_size, [16, 6])
    h_hog = eng.submit(hog, max_tokens=16)
    for _ in range(4):  # prefill and a few decode ticks
        eng.tick()
    assert len(h_hog.request.out_tokens) >= 1
    h_chat = eng.submit(chat, max_tokens=3, priority=1)
    res = eng.run()
    return res[h_hog], res[h_chat], list(eng.completion_order)


def _solo(eng, cfg):
    hog, chat = prompts(cfg.vocab_size, [16, 6])
    uids = [eng.submit(hog, max_tokens=16),
            eng.submit(chat, max_tokens=3, priority=1)]
    res = eng.run()
    return res[uids[0]], res[uids[1]]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("scheduler", ["slo", "class-then-family"])
@pytest.mark.parametrize("host_pages", [6, 0], ids=["park-hit", "reprefill"])
def test_preempt_resume_equals_jax(qwen, jax_runs, host_pages, scheduler,
                                   kv_dtype):
    kw = dict(max_pages=4, host_pages=host_pages, scheduler=scheduler,
              kv_dtype=kv_dtype)
    want, jst = jax_runs(_overload, **kw)
    solo, _ = jax_runs(_solo, batch_size=2, max_pages=16, kv_dtype=kv_dtype)
    te = _port(qwen, **kw)
    got = _overload(te, qwen[1])
    assert got == want
    assert got[:2] == solo  # preemption never changes a token
    assert_stats_equal(te, jst)
    st_ = te.stats
    assert st_["preemptions"] == st_["resumes"] == 1
    assert st_["resume_park_hits"] == int(host_pages > 0)
    assert st_["resume_reprefills"] == int(host_pages == 0)
    assert (st_["preempt_pages_parked"] >= 1) == (host_pages > 0)
    assert st_["traces"] == 1 and leak_free(te)


def test_preempt_resume_speculative_equals_jax(qwen, jax_runs):
    """A preempted slot's draft state: speculation on, both resume paths
    give JAX's transcripts and stats."""
    for host in (6, 0):
        kw = dict(max_pages=4, host_pages=host, scheduler="slo", spec_k=3)
        want, jst = jax_runs(_overload, **kw)
        te = _port(qwen, **kw)
        assert _overload(te, qwen[1]) == want
        assert_stats_equal(te, jst)
        assert te.stats["preemptions"] == 1 and leak_free(te)


def test_preempt_off_stalls_like_jax(qwen, jax_runs):
    kw = dict(max_pages=4, host_pages=6, scheduler="slo", preempt=False)
    want, jst = jax_runs(_overload, **kw)
    te = _port(qwen, **kw)
    assert _overload(te, qwen[1]) == want
    assert_stats_equal(te, jst)
    assert te.stats["preemptions"] == 0 and leak_free(te)


def _peers(eng, cfg):
    for p in prompts(cfg.vocab_size, [16, 16, 16]):
        eng.submit(p, max_tokens=8)
    return eng.run()


def test_equal_priority_never_preempts_like_jax(qwen, jax_runs):
    want, jst = jax_runs(_peers, max_pages=4, host_pages=6)
    te = _port(qwen, max_pages=4, host_pages=6)
    assert _peers(te, qwen[1]) == want
    assert_stats_equal(te, jst)
    assert te.stats["preemptions"] == 0 and leak_free(te)


def test_preemption_only_on_the_ragged_path(qwen):
    assert not _port(qwen, ragged=False).preempt
    assert _port(qwen).preempt and not _port(qwen, preempt=False).preempt


# ---------------------------------------------------------------------------
# typed errors and deadlines


def _too_large(eng, cfg):
    (p,) = prompts(cfg.vocab_size, [64])
    out = []
    for q in (p, p[:40]):  # too long for the cache; too big for the pool
        try:
            eng.submit(q, max_tokens=8)
        except ValueError as e:  # both packages' RequestTooLarge
            out.append(type(e).__name__)
    (ok,) = prompts(cfg.vocab_size, [8], seed=1)
    out.append(eng.submit(ok, max_tokens=4).result())
    return out


def _overloaded(eng, cfg):
    ps = prompts(cfg.vocab_size, [8, 8, 8])
    hs = [eng.submit(p, max_tokens=2) for p in ps[:2]]
    try:
        eng.submit(ps[2], max_tokens=2)
        raised = None
    except RuntimeError as e:  # both packages' EngineOverloaded
        raised = type(e).__name__
    res = eng.run()
    return raised, [res[h] for h in hs], eng.submit(ps[2], max_tokens=2).result()


def _deadline_live(eng, cfg):
    (p,) = prompts(cfg.vocab_size, [8])
    h = eng.submit(p, max_tokens=32, deadline_ticks=6)
    eng.run()
    return outcome([h])


def _deadline_starved(eng, cfg):
    hog, chat = prompts(cfg.vocab_size, [16, 6])
    hs = [eng.submit(hog, max_tokens=16),
          eng.submit(chat, max_tokens=2, deadline_ticks=4)]
    eng.run()
    return outcome(hs)


def _timeout_ticks(eng, cfg):
    (p,) = prompts(cfg.vocab_size, [8])
    h = eng.submit(p, max_tokens=32)
    try:
        h.result(timeout_ticks=2)
        bound = None
    except TimeoutError as e:
        bound = (type(e).__name__, isinstance(e, ServeError))
    return bound, h.result()


def _engine_cancel(eng, cfg):
    (p,) = prompts(cfg.vocab_size, [8])
    h = eng.submit(p, max_tokens=32)
    for _ in range(3):
        eng.tick()
    cls = Cancelled if isinstance(eng, ServeEngine) else \
        jax_pkg().errors.Cancelled
    eng.cancel(h, error=cls("admin abort", tokens=None))
    try:
        h.result()
        raised = None
    except cls as e:
        raised = list(e.tokens)
    h2 = eng.submit(p, max_tokens=32)
    for _ in range(3):
        eng.tick()
    h2.cancel()
    return raised, h2.result(), outcome([h, h2])


@pytest.mark.parametrize("scenario,kw", [
    (_too_large, dict(max_pages=4)), (_overloaded, dict(max_queue=2)),
    (_deadline_live, {}), (_deadline_starved, dict(max_pages=4, preempt=False)),
    (_timeout_ticks, {}), (_engine_cancel, {})],
    ids=["too-large", "overloaded", "deadline-live", "deadline-starved",
         "timeout-ticks", "engine-cancel"])
def test_typed_errors_equal_jax(qwen, jax_runs, scenario, kw):
    want, jst = jax_runs(scenario, **kw)
    te = _port(qwen, **kw)
    assert scenario(te, qwen[1]) == want
    assert_stats_equal(te, jst)
    assert leak_free(te)


def test_error_types_keep_their_builtins():
    assert issubclass(RequestTooLarge, ValueError)
    assert issubclass(EngineOverloaded, RuntimeError)
    assert issubclass(DeadlineExceeded, TimeoutError)
    assert issubclass(Cancelled, ServeError)


# ---------------------------------------------------------------------------
# preempt_order on one view, both packages


def _views(specs):
    J = jax_pkg()
    out = []
    for mod_req, mod_view in ((J.handle.Request, J.sched.EngineView),
                              (Request, tsched.EngineView)):
        reqs = [mod_req(uid=u, prompt=np.arange(4), priority=pr)
                for u, pr in specs]
        out.append(mod_view(queue=(), slot_requests=tuple(reqs),
                            slot_fill=(0,) * len(reqs), budget=32, chunk=16,
                            page_size=8, match_len=lambda p: 0))
    return out


@pytest.mark.parametrize("name", ["fifo", "prefix-aware", "slo",
                                  "class-then-family"])
@pytest.mark.parametrize("specs", [
    [(0, 1), (1, 0), (2, 0), (3, 2)], [(5, 0), (2, 0), (9, 0)],
    [(1, 1), (2, 2)], [(4, 0), (3, 1), (8, 0), (1, 0)]],
    ids=["mixed", "batch", "interactive", "mixed2"])
def test_preempt_order_equals_jax(name, specs):
    jv, tv = _views(specs)
    slots = list(range(len(specs)))
    want = list(jax_pkg().sched.make_scheduler(name).preempt_order(jv, slots))
    got = list(tsched.make_scheduler(name).preempt_order(tv, slots))
    assert got == want
    if name in ("slo", "class-then-family"):  # never the interactive class
        assert all(specs[b][1] < 1 for b in got)
    if specs == [(0, 1), (1, 0), (2, 0), (3, 2)]:
        assert got == ([2, 1] if name in ("slo", "class-then-family")
                       else [2, 1, 0, 3])


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
@pytest.mark.parametrize("host_pages", [16, 0], ids=["park-hit", "reprefill"])
def test_captured_preempting_engine_matches_eager(host_pages):
    """The captured engine preempts and resumes like the eager one: equal
    transcripts and stats, pools in place, both tiers drained."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dense_lm("preempt-card-test", n_layers=2, d_model=256, n_heads=8,
                   n_kv=2, head_dim=64, d_ff=512, vocab=512, qkv_bias=True,
                   rope_theta=1e4, tie=True, max_seq_len=256)
    cfg = cfg.replace(dtype="bfloat16")
    tp = TM.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    runs = []
    for captured in (True, False):
        eng = ServeEngine(tp, cfg, device="cuda", cuda_graph=captured,
                          flash_decode=True, max_pages=4, host_pages=host_pages,
                          scheduler="slo", **PRE_KW)
        ptrs = [t.data_ptr() for t in eng.pool_tensors()]
        out = _overload(eng, cfg)
        st_ = eng.stats
        assert st_["preemptions"] == 1 and st_["traces"] == 1
        assert st_["resume_park_hits"] == int(host_pages > 0)
        assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs
        assert leak_free(eng)
        runs.append((out, {k: st_[k] for k in ("ticks", "packed_tokens",
                                               "park_demotions")}))
    assert runs[0] == runs[1]

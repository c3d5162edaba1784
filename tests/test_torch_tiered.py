"""The port's host-RAM KV tier against the JAX package, on the CPU.

- Pool: scripted tier scenarios (those of tests/test_pool.py) and a
  hypothesis interleaving of alloc / release / match+acquire / index /
  evict / park / unpark / drop_parked / storm / drop_cache, replayed
  through both packages' ``PagePool``s: the same events, stats, free
  lists and host residency after every op.
- Movers: ``gather_kv_page`` → host store → ``insert_kv_page`` brings
  every leaf (int8 values and scale rows included) back bit-exact, and the
  engine applies a drained event log in order (a slot freed by a promote
  and reused by a later demote of the same log).
- Engine: the scenarios of tests/test_tiered.py (warm replay through a
  device pool below the working set, host capacity, three waves with a
  cancel and a drop), float32 and int8 pools, ragged and two-phase, both
  attention routes: transcripts and merged ``stats`` equal the JAX
  engine's, transcripts equal the untiered engine's, one trace, both tiers
  drain, pools never move, and promoted int8 pages equal their demoted
  bytes bit for bit.
- On a card (``gpu``): the captured tiered engine against ``cuda_graph=
  False``; an int8 page round trip through the pinned store; eviction
  storms while promotions are in flight.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from _torch_serve_parity import (ENGINE_KW, assert_stats_equal,  # noqa: E402
                                 jax_pkg, leak_free, load_qwen)

from repro_torch.configs.util import dense_lm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.chaos import FaultInjector  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.pool import PagePool  # noqa: E402

# device pool (6 pages) below the working set (3 families x 3 pages and a
# generated page each): every admission evicts someone else's prefix
TIER_KW = dict(ENGINE_KW, batch_size=1, max_pages=6)


@pytest.fixture(scope="module")
def qwen():
    return load_qwen()


@pytest.fixture(scope="module")
def jax_runs(qwen):
    """Each JAX scenario runs once per module: {(scenario, kw): (result,
    merged stats)}."""
    cfg, _, jp, _ = qwen
    cache = {}

    def run(scenario, **kw):
        key = (scenario.__name__, tuple(sorted(kw.items())))
        if key not in cache:
            eng = jax_pkg().Engine(jp, cfg, **{**TIER_KW, **kw})
            cache[key] = (scenario(eng, cfg), eng.stats)
        return cache[key]

    return run


def _families(vocab, n=3, pages=3, page_size=8, seed=40):
    """n prompts of ``pages`` full pages each (tests/test_tiered.py)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, pages * page_size) for _ in range(n)]


def _wave(eng, ps, max_tokens=4):
    uids = [eng.submit(p, max_tokens=max_tokens) for p in ps]
    got = eng.run()
    return [got[u] for u in uids]


def _port(qwen, **kw):
    _, tcfg, _, tp = qwen
    return ServeEngine(tp, tcfg, device="cpu", **{**TIER_KW, **kw})


# ---------------------------------------------------------------------------
# the pool against JAX's


def _pool_state(pool):
    return (sorted(pool._free), pool._ref.tolist(), sorted(pool._host_free),
            sorted(pool._host_node), sorted(pool._parked), pool.stats,
            pool.cached_pages, pool.host_cached_pages)


def _apply(pool, op, arg, held, parks, P):
    """One op of an interleaving on ``pool``; ``held`` (page lists a caller
    owns) and ``parks`` (parked slot lists) are per pool."""
    if op == "alloc" and pool.available() >= 1 + arg % 2:
        held.append(pool.alloc(1 + arg % 2))
    elif op == "release" and held:
        pool.release(held.pop(arg % len(held)))
    elif op == "match":
        # a prompt from a small alphabet of page keys, so prefixes recur
        prompt = np.asarray([arg % 3] * P + [arg % 2] * P + [7] * (arg % P),
                            np.int32)
        node, mpages, _, _ = pool.match_prefix(prompt)
        n_host = sum(1 for p in mpages if pool.is_host(p))
        if n_host <= pool.available(mpages):
            got = pool.acquire(mpages)
            fresh = pool.alloc(1) if pool.available() >= 1 else []
            for p, j in zip(fresh, range(len(got), 2)):
                nd = pool.index_page(node, tuple(int(t) for t in
                                                 prompt[j * P:(j + 1) * P]), p)
                if nd is None:
                    break
                node = nd
            held.append(got + fresh)
    elif op == "evict":
        pool.evict_one()
    elif op == "park" and held:
        pages = held[arg % len(held)]
        if all(pool.ref(p) == 1 and not pool.is_indexed(p) for p in pages):
            slots = pool.park(pages)
            if slots is not None:
                held.remove(pages)
                parks.append(slots)
    elif op == "unpark" and parks:
        slots = parks[arg % len(parks)]
        if pool.available() >= len(slots):
            parks.remove(slots)
            held.append(pool.unpark(slots))
    elif op == "drop_parked" and parks:
        pool.drop_parked(parks.pop(arg % len(parks)))
    elif op == "storm":
        pool.storm_host_cache()
    elif op == "drop_cache":
        pool.drop_cache()


OPS = ["alloc", "release", "match", "match", "evict", "park", "unpark",
       "drop_parked", "storm", "drop_cache"]


@settings(max_examples=30, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from(OPS), st.integers(0, 11)),
                    min_size=4, max_size=40),
       host_pages=st.integers(0, 4))
def test_pool_interleavings_equal_jax(ops, host_pages):
    """Any interleaving of the tier's operations makes the same decisions
    in both pools: the same drained events, stats, free lists, refcounts,
    host residency and parks after every op; releasing everything drains
    both tiers."""
    P = 2
    jpool = jax_pkg().pool.PagePool(5, P, host_pages=host_pages)
    tpool = PagePool(5, P, host_pages=host_pages)
    side = {id(jpool): ([], []), id(tpool): ([], [])}
    for op, arg in ops:
        for pool in (jpool, tpool):
            _apply(pool, op, arg, *side[id(pool)], P)
        assert tpool.drain_events() == jpool.drain_events(), (op, arg)
        assert _pool_state(tpool) == _pool_state(jpool), (op, arg)
    for pool in (jpool, tpool):
        held, parks = side[id(pool)]
        for pages in held:
            pool.release(pages)
        for slots in parks:
            pool.drop_parked(slots)
        pool.drop_cache()
    assert tpool.drain_events() == jpool.drain_events()
    assert _pool_state(tpool) == _pool_state(jpool)
    assert tpool.free_pages == 5 and tpool.host_free_slots == host_pages


def _cache_chain(pool, prompt, P=4):
    """Index ``prompt``'s full pages as a cached chain, then release them:
    refcount-0 prefix pages, evictable under pressure."""
    node, _, _, _ = pool.match_prefix(prompt)
    pages = pool.alloc(len(prompt) // P)
    for j, p in enumerate(pages):
        node = pool.index_page(
            node, tuple(int(t) for t in prompt[j * P:(j + 1) * P]), p)
    pool.release(pages)


def _script_demote(pool):
    """A cached 2-page chain under pressure: demoted (still matchable, as
    encoded host ids) or, untiered, dropped."""
    _cache_chain(pool, np.arange(8))
    fresh = pool.alloc(2)
    out = pool.match_prefix(np.arange(8))[1:3]
    pool.release(fresh)
    return out


def _script_promote(pool):
    """The demoted chain is acquired back: each host hit takes a device
    page and a promote event."""
    _script_demote(pool)
    _, mpages, _, _ = pool.match_prefix(np.arange(8))
    n_host = sum(pool.is_host(p) for p in mpages)
    return pool.acquire(mpages) if n_host <= pool.available(mpages) else None


def _script_host_lru(pool):
    """Three one-page prefixes through two device pages: a small host tier
    evicts its LRU node."""
    for k in range(3):
        _cache_chain(pool, np.full(4, k))
        pool.release(pool.alloc(2))
    return [pool.probe_prefix_split(np.full(4, k)) for k in range(3)]


def _script_available_and_drop(pool):
    _script_demote(pool)
    _, mpages, _, _ = pool.match_prefix(np.arange(8))
    return (pool.available(mpages), pool.drop_cache(),
            pool.probe_prefix_len(np.arange(8)))


def _script_park_storm(pool):
    """A park survives a storm that takes the host cache."""
    pages = pool.alloc(1)
    slots = pool.park(pages)
    if slots is None:  # no host tier: the caller keeps its page
        pool.release(pages)
    return slots, _script_host_lru(pool), pool.storm_host_cache(), \
        pool.parked_pages


@pytest.mark.parametrize("script", [
    _script_demote, _script_promote, _script_host_lru,
    _script_available_and_drop, _script_park_storm],
    ids=lambda f: f.__name__[8:])
@pytest.mark.parametrize("host_pages", [0, 1, 4])
def test_pool_scripts_equal_jax(script, host_pages):
    """tests/test_pool.py's tier scenarios: the same results, events and
    stats from both pools, with no host tier, a one-slot one and a roomy
    one."""
    jpool = jax_pkg().pool.PagePool(2, 4, host_pages=host_pages)
    tpool = PagePool(2, 4, host_pages=host_pages)
    want = script(jpool)
    assert script(tpool) == want
    assert tpool.drain_events() == jpool.drain_events()
    assert _pool_state(tpool) == _pool_state(jpool)


# ---------------------------------------------------------------------------
# the movers


def _random_pools(state, seed=0):
    g = torch.Generator().manual_seed(seed)
    for _, leaf, _ in TM.paged_leaves(state):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g,
                                     dtype=torch.int8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_page_gather_insert_round_trip_bit_exact(qwen, kv_dtype):
    _, tcfg, _, tp = qwen
    state = TM.init_paged_state(tp, tcfg, 2, 32, page_size=8, n_pages=6,
                                kv_dtype=kv_dtype)
    _random_pools(state)
    keys = [k for k, _, _ in TM.paged_leaves(state)]
    assert len(keys) == (4 if kv_dtype == "int8" else 2)
    rows = {k: v.clone() for k, v in TM.gather_kv_page(tcfg, state, 3).items()}
    before = {k: leaf.clone() for k, leaf, _ in TM.paged_leaves(state)}
    TM.insert_kv_page(tcfg, state, rows, 5)
    for k, leaf, ax in TM.paged_leaves(state):
        assert torch.equal(leaf.select(ax, 5), before[k].select(ax, 3)), k
        for p in range(6):
            if p != 5:  # no other page moved
                assert torch.equal(leaf.select(ax, p), before[k].select(ax, p))


def test_events_apply_in_order(qwen):
    """A promote frees a host slot that a later demote of the same log
    reuses: the promote must read the slot's old bytes first."""
    _, tcfg, _, tp = qwen
    eng = ServeEngine(tp, tcfg, device="cpu", host_pages=2, kv_dtype="int8",
                      **{**TIER_KW, "max_pages": 8})
    eng._ensure_state()
    _random_pools(eng._state, seed=1)
    page = lambda p: {k: v.clone() for k, v in  # noqa: E731
                      TM.gather_kv_page(tcfg, eng._state, p).items()}
    p3, p7 = page(3), page(7)
    eng.pool.events = [("demote", 3, 0), ("promote", 0, 5), ("demote", 7, 0)]
    eng._apply_pool_events(eng._state)
    got5 = page(5)
    for k in p3:
        assert torch.equal(got5[k], p3[k]) and torch.equal(
            eng._host_store[k][0], p7[k]), k
    assert eng._host_slots == {0}
    assert all(not v.is_pinned() for v in eng._host_store.values())  # CPU


# ---------------------------------------------------------------------------
# the engine against JAX's (tests/test_tiered.py's scenarios)


def _warm_replay(eng, cfg):
    fams = _families(cfg.vocab_size)
    return _wave(eng, fams), _wave(eng, fams)


ROUTES = [dict(), dict(kv_dtype="int8"), dict(flash_decode=True),
          dict(ragged=False), dict(ragged=False, kv_dtype="int8")]
ROUTE_IDS = ["f32", "int8", "kernel-route", "two-phase", "two-phase-int8"]


@pytest.mark.parametrize("kw", ROUTES, ids=ROUTE_IDS)
def test_warm_replay_equals_jax(qwen, jax_runs, kw):
    """Three 3-page families through a 6-page pool, twice: untiered the
    replay finds nothing; tiered every family is a host hit promoted
    back.  Transcripts and merged stats equal JAX's; tiered transcripts
    equal untiered ones."""
    (want1, want2), jst = jax_runs(_warm_replay, host_pages=16, **kw)
    cold, _ = jax_runs(_warm_replay, host_pages=0, **kw)
    te = _port(qwen, host_pages=16, **kw)
    ptrs = [t.data_ptr() for t in te.pool_tensors()]
    got1, got2 = _warm_replay(te, qwen[1])
    assert (got1, got2) == (want1, want2) == cold
    assert got1 == got2
    assert_stats_equal(te, jst)
    st_ = te.stats
    assert st_["host_hits"] == 3 and st_["host_pages_promoted"] >= 3
    assert st_["demotions"] > 0 and st_["evictions"] == 0
    assert st_["traces"] == (1 if kw.get("ragged", True) else 0)
    assert st_["host_pool_pages"] == 16
    assert [t.data_ptr() for t in te.pool_tensors()] == ptrs
    assert leak_free(te)


def test_untiered_engine_equals_jax(qwen, jax_runs):
    want, jst = jax_runs(_warm_replay, host_pages=0)
    te = _port(qwen, host_pages=0)
    assert _warm_replay(te, qwen[1]) == want
    assert_stats_equal(te, jst)
    assert te.stats["host_hits"] == 0 and te.stats["evictions"] > 0
    assert te._host_store == {} and leak_free(te)


def test_prefix_cache_off_zeroes_the_tier(qwen):
    te = _port(qwen, host_pages=16, prefix_cache=False)
    assert te.host_pages == 0 and te.stats["host_pool_pages"] == 0
    _wave(te, _families(qwen[1].vocab_size))
    assert te.stats["demotions"] == 0 and leak_free(te)


def _capacity(eng, cfg):
    return _wave(eng, _families(cfg.vocab_size, seed=42))


def test_host_tier_capacity_bounds_residency_like_jax(qwen, jax_runs):
    want, jst = jax_runs(_capacity, host_pages=2)
    te = _port(qwen, host_pages=2)
    assert _capacity(te, qwen[1]) == want
    assert_stats_equal(te, jst)
    assert te.stats["host_evictions"] > 0
    assert te.pool.host_cached_pages <= 2 and len(te._host_slots) <= 2
    assert leak_free(te)


def _three_waves(eng, cfg):
    out = []
    for wave in range(3):
        out.append(_wave(eng, _families(cfg.vocab_size, seed=43 + wave),
                         max_tokens=3))
        out.append(dict(eng.stats))
    handles = [eng.submit(p, max_tokens=4)
               for p in _families(cfg.vocab_size, seed=46)]
    eng.tick()
    assert handles[1].cancel()
    eng.run()
    out.append([list(h.request.out_tokens) for h in handles])
    out.append(eng.drop_prefix_cache())
    return out


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_three_waves_cancel_and_drop_equal_jax(qwen, jax_runs, kv_dtype):
    """tests/test_tiered.py's hygiene regression: three waves under
    demotion pressure, a cancel mid-flight, then a drop that empties both
    tiers — the same transcripts and stats as JAX after every wave."""
    want, jst = jax_runs(_three_waves, host_pages=8, kv_dtype=kv_dtype)
    te = _port(qwen, host_pages=8, kv_dtype=kv_dtype)
    got = _three_waves(te, qwen[1])
    for g, w in zip(got, want):
        if isinstance(w, dict):
            for key, v in w.items():
                assert g[key] == v, key
        else:
            assert g == w
    assert_stats_equal(te, jst)
    assert te.stats["demotions"] > 0
    assert te.pool.free_pages == te.n_pages and te.pool.cached_pages == 0
    assert te.pool.host_cached_pages == 0 and not te._host_slots
    assert te.pool.host_free_slots == te.host_pages


def _rows_by_prefix(eng):
    """{prefix path of token keys: that page's rows} for every cached
    device page."""
    out, stack = {}, [((), c) for c in eng.pool.root.children.values()]
    while stack:
        path, nd = stack.pop()
        path = path + (nd.key,)
        if not eng.pool.is_host(nd.page):
            out[path] = {k: v.clone() for k, v in TM.gather_kv_page(
                eng.cfg, eng._state, nd.page).items()}
        stack.extend((path, c) for c in nd.children.values())
    return out


def test_int8_pages_come_back_bit_exact(qwen):
    """Every prefix page that a wave demoted and the replay promoted holds
    the same int8 values and scale rows as before it left the device."""
    te = _port(qwen, host_pages=16, kv_dtype="int8", max_pages=12)
    fams = _families(qwen[1].vocab_size, seed=47)
    _wave(te, fams)
    before = _rows_by_prefix(te)
    _wave(te, _families(qwen[1].vocab_size, seed=48))  # demotes them
    assert te.stats["demotions"] > 0
    _wave(te, fams)  # promotes them back
    assert te.stats["host_pages_promoted"] > 0
    after = _rows_by_prefix(te)
    common = set(before) & set(after)
    assert len(common) >= te.stats["host_pages_promoted"]
    for path in common:
        for k, v in before[path].items():
            assert torch.equal(after[path][k], v), (path, k)


# ---------------------------------------------------------------------------
# on the card


def _card_cfg():
    """A small decoder at head_dim 64 and G 4 (the serving kernel's
    tensor-core variant), bf16 activations."""
    cfg = dense_lm("tier-card-test", n_layers=2, d_model=256, n_heads=8,
                   n_kv=2, head_dim=64, d_ff=512, vocab=512, qkv_bias=True,
                   rope_theta=1e4, tie=True, max_seq_len=256)
    return cfg.replace(dtype="bfloat16")


def _card_params(cfg):
    return TM.init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                          device="cuda")


def _card_waves(eng, vocab):
    fams = _families(vocab, n=4, pages=4)
    other = _families(vocab, n=4, pages=4, seed=41)
    return [_wave(eng, w, max_tokens=6) for w in (fams, other, fams)]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_captured_tiered_engine_matches_eager(kv_dtype):
    """The captured tiered engine against the same engine run eagerly and
    against the untiered one: equal transcripts and stats, host hits, one
    graph, pools in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _card_cfg()
    tp = _card_params(cfg)
    kw = dict(ENGINE_KW, batch_size=2, max_pages=12, cache_len=128,
              flash_decode=True, kv_dtype=kv_dtype, device="cuda")
    runs = []
    for captured, host in ((True, 32), (False, 32), (True, 0)):
        eng = ServeEngine(tp, cfg, cuda_graph=captured, host_pages=host, **kw)
        ptrs = [t.data_ptr() for t in eng.pool_tensors()]
        out = _card_waves(eng, cfg.vocab_size)
        st_ = eng.stats
        assert st_["graph_captures"] == int(captured) and st_["traces"] == 1
        assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs
        assert leak_free(eng)
        if host:
            assert st_["host_hits"] > 0 and st_["host_pages_promoted"] > 0
            assert all(v.is_pinned() for v in eng._host_store.values())
        runs.append((out, {k: st_[k] for k in ("ticks", "packed_tokens",
                                               "demotions", "promotions")}))
    assert runs[0] == runs[1]
    assert runs[0][0] == runs[2][0]


@pytest.mark.gpu
def test_int8_page_round_trip_through_pinned_store():
    """Demote two int8 pages through the pinned store and promote them
    into other pages, a slot reused within one log: bit-exact, and the
    host never waited (the copies are queued, then checked after one
    synchronisation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _card_cfg()
    eng = ServeEngine(_card_params(cfg), cfg, device="cuda", host_pages=2,
                      kv_dtype="int8", **dict(ENGINE_KW, batch_size=2,
                                              max_pages=8, cache_len=128))
    eng._ensure_state()
    _random_pools(eng._state)
    page = lambda p: {k: v.clone() for k, v in  # noqa: E731
                      TM.gather_kv_page(cfg, eng._state, p).items()}
    p3, p7 = page(3), page(7)
    assert all(v.is_pinned() for v in eng._host_store.values())
    eng.pool.events = [("demote", 3, 0), ("demote", 7, 1), ("promote", 0, 5),
                       ("demote", 2, 0), ("promote", 1, 6)]
    eng._apply_pool_events(eng._state)
    torch.cuda.synchronize()
    for k in p3:
        assert torch.equal(page(5)[k], p3[k]) and torch.equal(page(6)[k], p7[k])


@pytest.mark.gpu
def test_storms_during_pending_promotions_keep_transcripts():
    """Eviction storms on most ticks of a tiered, captured run — host slots
    freed while promotions and demotions through them are still queued on
    the stream — leave every transcript equal to a fault-free run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _card_cfg()
    tp = _card_params(cfg)
    kw = dict(ENGINE_KW, batch_size=2, max_pages=12, cache_len=128,
              flash_decode=True, host_pages=32, device="cuda")
    clean = _card_waves(ServeEngine(tp, cfg, **kw), cfg.vocab_size)
    eng = ServeEngine(tp, cfg, fault_injector=FaultInjector(
        seed=5, p_evict_storm=0.7), **kw)
    assert _card_waves(eng, cfg.vocab_size) == clean
    assert eng.stats["chaos_evict_storms"] > 0 and leak_free(eng)

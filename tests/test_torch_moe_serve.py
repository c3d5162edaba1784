"""Serving the MoE models in the port against the JAX package, on the CPU:
llama4-maverick-smoke (a dense then an MoE block, top-1 with a shared
expert) and arctic-480b-smoke (top-2 with a dense residual in every block)
in float32, the same seed-0 weights on both sides through
``repro_torch.bridge`` (``test_torch_moe._load``).

- The ragged and two-phase steps' logits and every state leaf (f32 and
  int8 pools) at rtol = atol = 1e-4: the capacity of the ragged step is
  taken over the whole pack, its pad tail included, as JAX takes it; the
  steps dispatch no host-synchronising op.
- The lock-step path: ``prefill`` and ``decode_step`` (logits and state),
  the ``ReferenceEngine``'s per-tick logits and transcripts.
- The port's engine against JAX's engine on the same traffic, never
  against a solo run (the capacity, and so every drop, depends on what the
  scheduler packed): transcripts token-identical and merged stats equal
  through prefix hits with copy-on-write (ragged and two-phase, f32 and
  int8 pools), a speculative engine's verify rows (spec_k 2), and a
  preempted and resumed request (slo; park hit and re-prefill).  A wrapper
  on ``_moe_fwd_dispatch`` shows the ragged traffic dropped valid tokens'
  slots, so the capacity trap is reached.  ``impl="ragged"`` on llama4
  (``.replace`` here only): JAX's transcripts with the port's eager
  per-expert products and with the captured form (the dispatch at
  capacity T, forced on the CPU).  The engine's gates: prefix cache,
  speculation and preemption on, as JAX's.

JAX is imported lazily (fixtures).
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import assert_stats_equal  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import moe as TMoE  # noqa: E402
from repro_torch.serve import serve_step as SS  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402
from test_torch_capture import _Recorder  # noqa: E402
from test_torch_moe import ARCHS, _dropped, _flat, _load  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE = 64
B, P, NPAGES, C = 3, 8, 24, 8  # slots, page, pool pages, prefill chunk
KW = dict(batch_size=3, cache_len=CACHE, page_size=8, prefill_chunk=C,
          token_budget=24)


@pytest.fixture(scope="module", params=ARCHS)
def moe_model(request):
    return _load(request.param)


@pytest.fixture(scope="module")
def llama4():
    return _load(ARCHS[0])


def _compare_states(m, jstate, tstate):
    want = _flat(m.jax.tree.map(np.asarray, jstate))
    got = _flat(bridge.state_to_numpy(tstate, m.tcfg))
    assert got.keys() == want.keys()
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _fresh(m, kv_dtype=None):
    js = m.JM.init_paged_state(m.jp, m.cfg, B, CACHE, page_size=P,
                               n_pages=NPAGES, kv_dtype=kv_dtype)
    ts = bridge.state_from_numpy(m.jax.tree.map(np.asarray, js), m.tcfg, "cpu")
    rows = np.arange(B * (CACHE // P), dtype=np.int32).reshape(B, CACHE // P)
    rows = np.where(rows < NPAGES, rows, NPAGES).astype(np.int32)
    plen = np.zeros(B, np.int32)
    mask = np.ones(B, bool)
    js = m.JM.reset_paged_slots(m.cfg, js, js, *(m.jnp.asarray(a) for a in
                                                 (mask, rows, plen)))
    TM.reset_paged_slots(m.tcfg, ts, TM.reset_template(ts),
                         *(torch.from_numpy(a) for a in (mask, rows, plen)))
    return js, ts


def _pack(rng, cursor, chunks, T, vocab):
    """(slot, count) runs at each slot's next positions, an invalid entry
    after the first run, an invalid tail; logit_idx at each listed slot's
    last token."""
    tokens = rng.randint(0, vocab, T).astype(np.int32)
    slot, q_pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    seq, valid = np.full(T, C + 1, np.int32), np.zeros(T, bool)
    logit_idx = np.full(B, T, np.int32)
    n = 0
    for i, (b, c) in enumerate(chunks):
        slot[n:n + c], q_pos[n:n + c] = b, cursor[b] + np.arange(c)
        seq[n:n + c], valid[n:n + c] = np.arange(c), True
        logit_idx[b] = n + c - 1
        cursor[b] += c
        n += c + (i == 0)
    return tokens, slot, q_pos, seq, valid, logit_idx


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ragged_step_matches_jax(moe_model, kv_dtype):
    """Packs of prefill runs beside decode tokens (the capacity taken over
    the whole pack, its pad tail included): logits and every state leaf
    after each pack."""
    m = moe_model
    js, ts = _fresh(m, kv_dtype)
    rng = np.random.RandomState(7)
    cursor = [0] * B
    for chunks in ([(0, 8), (1, 5)], [(0, 1), (1, 8), (2, 7)],
                   [(2, 1), (0, 1), (1, 1)], [(1, 8), (0, 1), (2, 1)]):
        vecs = _pack(rng, cursor, chunks, 24, m.cfg.vocab_size)
        jl, js = m.ragged_step(m.jp, m.cfg, js,
                                  *(m.jnp.asarray(a) for a in vecs), width=C + 1)
        tl, ts = TM.ragged_step(m.tp, m.tcfg, ts,
                                *(torch.from_numpy(a) for a in vecs),
                                width=C + 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)


def test_paged_step_matches_jax(moe_model):
    """The two-phase path: a (B, C) prefill chunk (slot 2 idle, slot 1 an
    invalid tail), then decode ticks: logits and every state leaf."""
    m = moe_model
    js, ts = _fresh(m)
    rng = np.random.RandomState(11)
    tok = rng.randint(0, m.cfg.vocab_size, (B, C)).astype(np.int32)
    q_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    valid = np.zeros((B, C), bool)
    valid[0], valid[1, :3] = True, True
    steps = [(tok, q_pos, valid, False)]
    fill = [C, 3]
    for _ in range(3):
        tok = rng.randint(0, m.cfg.vocab_size, (B, 1)).astype(np.int32)
        steps.append((tok, np.asarray([[fill[0]], [fill[1]], [0]], np.int32),
                      np.asarray([[True], [True], [False]]), True))
        fill = [fill[0] + 1, fill[1] + 1]
    for tok, qp, va, with_logits in steps:
        jl, js = m.paged_step(m.jp, m.cfg, js,
                                 *(m.jnp.asarray(a) for a in (tok, qp, va)),
                                 with_logits=with_logits)
        tl, ts = TM.paged_step(m.tp, m.tcfg, ts,
                               *(torch.from_numpy(a) for a in (tok, qp, va)),
                               with_logits=with_logits)
        if with_logits:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)


@pytest.mark.parametrize("kind", ["ragged", "chunk", "decode"])
def test_moe_steps_dispatch_no_host_synchronising_op(llama4, kind):
    """The dispatch MoE inside the serving steps makes the host wait for
    nothing (its one-hots are comparisons, its drops a column past the
    dispatch tensor), so the steps can be captured."""
    m = llama4
    _, ts = _fresh(m)
    steps = {"ragged": SS.capture_ragged_step(m.tcfg, m.tp, ts, T=24, B=B,
                                              width=C + 1),
             "chunk": SS.capture_paged_step(m.tcfg, m.tp, ts, B=B, C=C,
                                            with_logits=False),
             "decode": SS.capture_paged_step(m.tcfg, m.tp, ts, B=B, C=1,
                                             with_logits=True)}
    if kind == "ragged":
        args = _pack(np.random.RandomState(2), [0] * B, [(0, 5), (1, 3)], 24,
                     m.cfg.vocab_size)
    else:
        width = C if kind == "chunk" else 1
        args = (np.zeros((B, width), np.int32),
                np.tile(np.arange(width, dtype=np.int32), (B, 1)),
                np.ones((B, width), bool))
    with _Recorder() as rec:
        steps[kind].run(*args)
    assert rec.bad == []


def test_lockstep_prefill_and_decode_match_jax(moe_model):
    """``prefill`` of a 2 x 13 prompt batch (the MoE over the whole
    sequence, as JAX's), then four ``decode_step``s: logits and every
    state leaf after each."""
    m = moe_model
    jnp = m.jnp
    tok = np.random.RandomState(5).randint(0, m.cfg.vocab_size,
                                           (2, 13)).astype(np.int32)
    js = m.prefill(m.jp, m.cfg, m.JM.init_decode_state(m.jp, m.cfg, 2, CACHE),
                      jnp.asarray(tok))
    ts = TM.init_decode_state(m.tp, m.tcfg, 2, CACHE)
    TM.prefill(m.tp, m.tcfg, ts, torch.from_numpy(tok))
    _compare_states(m, js, ts)
    nxt = tok[:, -1:]
    for _ in range(4):
        jl, js = m.decode_step(m.jp, m.cfg, js, jnp.asarray(nxt))
        tl, ts = TM.decode_step(m.tp, m.tcfg, ts, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]


def test_reference_engine_matches_jax(moe_model):
    """The lock-step ``ReferenceEngine`` on an equal-length wave over 2
    slots, then a third request in a reused slot: every tick's logits and
    the transcripts equal JAX's."""
    m = moe_model
    prompts = _prompts(m.cfg.vocab_size, [9, 9, 9], seed=8)
    logs = []
    for Eng, params, cfg, kw in ((m.Reference, m.jp, m.cfg, {}),
                                 (ReferenceEngine, m.tp, m.tcfg,
                                  {"device": "cpu"})):
        eng = Eng(params, cfg, batch_size=2, cache_len=CACHE, **kw)
        ticks = []
        decode = eng._decode

        def recording(p, s, t, decode=decode, ticks=ticks):
            logits, s = decode(p, s, t)
            ticks.append(np.asarray(logits[:, -1]))
            return logits, s

        eng._decode = recording
        uids = [eng.submit(p, max_tokens=4) for p in prompts]
        res = eng.run()
        logs.append(([res[u] for u in uids], ticks))
    (jt, jticks), (tt, tticks) = logs
    assert tt == jt and len(tticks) == len(jticks)
    for a, b in zip(tticks, jticks):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# Served transcripts, engine against engine


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in lens]


def _shared_prefix_traffic(eng, vocab, max_tokens=4):
    """Mixed lengths, two sharing a 20-token prefix (2.5 pages of 8: the
    late one inherits two pages and copies the third on write); the late
    request arrives after three ticks, once the prefix is indexed."""
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, vocab, 20)
    first = [np.concatenate([prefix, rng.randint(0, vocab, 6)])]
    first += _prompts(vocab, [5, 19, 11], seed=21)
    handles = [eng.submit(p, max_tokens=max_tokens) for p in first]
    for _ in range(3):
        eng.tick()
    late = np.concatenate([prefix, rng.randint(0, vocab, 4)])
    handles.append(eng.submit(late, max_tokens=max_tokens))
    res = eng.run()
    return [list(res[h]) for h in handles]


@pytest.fixture
def drop_counter(monkeypatch):
    """Counts the valid pack entries whose every routing slot the port's
    dispatch dropped: ``M.ragged_step`` is wrapped to note the pack's
    ``valid``, ``_moe_fwd_dispatch`` to find the slots past capacity."""
    seen = {"valid": None, "dropped": 0, "calls": 0}
    step, dispatch = TM.ragged_step, TMoE._moe_fwd_dispatch

    def ragged_step(params, cfg, state, tokens, slot, q_pos, seq_idx, valid,
                    *a, **kw):
        seen["valid"] = valid
        return step(params, cfg, state, tokens, slot, q_pos, seq_idx, valid,
                    *a, **kw)

    def counted(params, cfg, x):
        _, idx, _, _ = TMoE._route(params, cfg, x)
        gone = _dropped(idx, cfg.num_experts, TMoE.capacity(cfg, x.shape[1]))
        if seen["valid"] is not None:
            rows = gone.reshape(x.shape[1], cfg.top_k).any(-1)
            seen["dropped"] += int((rows & seen["valid"]).sum())
            seen["calls"] += 1
        return dispatch(params, cfg, x)

    monkeypatch.setattr(TM, "ragged_step", ragged_step)
    monkeypatch.setattr(TMoE, "_moe_fwd_dispatch", counted)
    return seen


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX engine run once per module, by (arch, settings)."""
    cache = {}

    def run(m, script, **kw):
        key = (m.cfg.name, script.__name__, tuple(sorted(kw.items())))
        if key not in cache:
            eng = m.Engine(m.jp, m.cfg, **{**KW, **kw})
            cache[key] = (script(eng, m.cfg.vocab_size), eng.stats)
        return cache[key]

    return run


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_transcripts_and_prefix_hits_match_jax(moe_model, jax_runs,
                                               drop_counter, ragged, kv_dtype):
    """Mixed lengths and a shared prefix through a token budget of 24 and
    chunks of 8: the transcripts token-identical to the JAX engine's, the
    prefix hit and its copy-on-write, merged stats equal.  On the ragged
    path the dispatch dropped valid tokens' slots: the capacity trap is
    reached and both packages fell into it alike."""
    m = moe_model
    kw = dict(ragged=ragged, kv_dtype=kv_dtype)
    want, jst = jax_runs(m, _shared_prefix_traffic, **kw)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", **{**KW, **kw})
    assert te.prefix_cache and te.preempt == ragged and te._spec_k == 0
    assert _shared_prefix_traffic(te, m.cfg.vocab_size) == want
    assert_stats_equal(te, jst)
    st = te.stats
    assert st["prefix_hits"] >= 1 and st["cow_copies"] >= 1, st
    assert te.reclaimable_pages == te.n_pages
    if ragged:
        assert drop_counter["calls"] > 0 and drop_counter["dropped"] > 0, \
            drop_counter


def _drafting(eng, vocab):
    """Prompts over tokens 1-4 (tests/test_speculative.py's rejection
    workload): the outputs fall into loops, which prompt lookup drafts
    from; 12 tokens each."""
    rng = np.random.RandomState(11)
    uids = [eng.submit(rng.randint(1, 5, 40), max_tokens=12) for _ in range(3)]
    res = eng.run()
    return [list(res[u]) for u in uids]


def test_speculative_engine_matches_jax(moe_model, jax_runs):
    """spec_k 2 (the verify rows ride in the ragged pack and take MoE
    capacity like any token): transcripts and the spec_* stats equal
    JAX's; drafts were made and checked."""
    m = moe_model
    want, jst = jax_runs(m, _drafting, spec_k=2)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", spec_k=2, **KW)
    assert te._spec_k == 2
    assert _drafting(te, m.cfg.vocab_size) == want
    assert_stats_equal(te, jst)
    assert te.stats["spec_drafted"] > 0


def _overload(eng, vocab):
    """A hog fills the only slot and the pool; an interactive request
    (priority 1) arrives mid-decode and preempts it."""
    hog, chat = _prompts(vocab, [16, 6], seed=0)
    h_hog = eng.submit(hog, max_tokens=12)
    for _ in range(4):
        eng.tick()
    h_chat = eng.submit(chat, max_tokens=3, priority=1)
    res = eng.run()
    return list(res[h_hog]), list(res[h_chat]), list(eng.completion_order)


@pytest.mark.parametrize("host_pages", [6, 0], ids=["park-hit", "reprefill"])
def test_preempt_and_resume_match_jax(moe_model, jax_runs, host_pages):
    """Preemption (slo) on both resume paths: the transcripts, the
    completion order and the stats equal JAX's; one preemption and
    resume."""
    m = moe_model
    kw = dict(batch_size=1, max_pages=4, host_pages=host_pages,
              scheduler="slo")
    want, jst = jax_runs(m, _overload, **kw)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", **{**KW, **kw})
    assert _overload(te, m.cfg.vocab_size) == want
    assert_stats_equal(te, jst)
    assert te.stats["preemptions"] == te.stats["resumes"] == 1


def _with_impl(cfg, impl):
    """``cfg`` with every MoE block's ``impl`` replaced."""
    def blk(b):
        return (dataclasses.replace(b, moe=dataclasses.replace(b.moe, impl=impl))
                if b.ffn == "moe" else b)
    return cfg.replace(stages=tuple(
        dataclasses.replace(st, pattern=tuple(blk(b) for b in st.pattern))
        for st in cfg.stages))


@pytest.mark.parametrize("form", ["eager", "captured"])
def test_dropless_impl_serves_like_jax(llama4, jax_runs, form, monkeypatch):
    """llama4 with ``impl="ragged"`` (dropless): the JAX engine's
    transcripts and stats, with the port's eager per-expert products and
    with the dispatch at capacity T that its captured step runs (forced
    here on the CPU)."""
    m = llama4
    cfg, tcfg = _with_impl(m.cfg, "ragged"), _with_impl(m.tcfg, "ragged")
    jm = types.SimpleNamespace(**{**vars(m), "cfg": cfg})
    want, jst = jax_runs(jm, _shared_prefix_traffic)
    if form == "captured":
        monkeypatch.setattr(TMoE, "_capturing", lambda: True)
    te = ServeEngine(m.tp, tcfg, device="cpu", **KW)
    assert _shared_prefix_traffic(te, cfg.vocab_size) == want
    assert_stats_equal(te, jst)


def test_engine_gates_match_jax(moe_model):
    """All-global MoE models keep prefix cache, speculation and preemption
    on, as JAX's engine does."""
    m = moe_model
    kw = {**KW, "spec_k": 2}
    je = m.Engine(m.jp, m.cfg, **kw)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", **kw)
    for name in ("prefix_cache", "_spec_k", "preempt", "host_pages", "n_pages",
                 "_has_paged"):
        assert getattr(te, name) == getattr(je, name), name
    assert te.prefix_cache and te._spec_k == 2 and te.preempt


def test_launcher_serves_llama4(capsys):
    from repro_torch.launch import serve as tserve

    assert tserve.main(["--arch", "llama4-maverick-400b-a17b", "--device",
                        "cpu", "--requests", "3", "--batch-size", "2",
                        "--prompt-len", "10", "--max-tokens", "3"]) == 0
    assert capsys.readouterr().out.count("req ") == 3

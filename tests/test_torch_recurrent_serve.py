"""Serving a recurrent model in the port against the JAX package, on the
CPU: xlstm-350m's smoke config (two stacked repeats of an mLSTM and an
sLSTM block) in float32, the same seed-0 weights on both sides through
``repro_torch.bridge``.

- The ragged step (the pack scattered into a (B, width) layout and the
  single-step decode rolled over it, JAX's ``_ragged_recurrent_roll``) and
  the two-phase step (the masked roll over a (B, C) chunk) after mixed
  packs, pad tails and idle slots, and a slot re-admitted mid-run (its
  sLSTM stabilizer back at -1e30): logits and every state leaf at rtol =
  atol = 1e-4.
- The lock-step path: ``prefill`` (the parallel form for the outputs, the
  decode rolled over the prompt for the state) and ``decode_step``, and the
  ``ReferenceEngine``'s per-tick logits: 1e-4.
- Transcripts of the ragged, two-phase and lock-step engines equal the JAX
  engines' (and the ragged and two-phase ones the port's own solo
  lock-step decode), among them the port of tests/test_serve.py's
  ``test_recurrent_hybrid_serves_correctly`` (3 prompts over 2 slots, so a
  slot is reused); merged stats equal JAX's key for key.
- The engine's gates and page budget equal JAX's (no prefix cache,
  speculation, preemption or host tier; one block table a slot of pages,
  none reserved); ``rollback_paged_slots`` leaves every recurrent leaf
  bit-identical, as JAX's does; the reset template holds each leaf's fresh
  value; the launchers serve and train ``xlstm-350m``.

JAX is imported lazily (a fixture).
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import assert_stats_equal  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE = 64
B, P, NPAGES, C = 3, 8, 24, 8  # slots, page, pool pages, prefill chunk


@pytest.fixture(scope="module")
def xl():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro.serve.reference import ReferenceEngine as JaxReference

    cfg = get_config("xlstm-350m", smoke=True).replace(dtype="float32")
    tcfg = tget("xlstm-350m", smoke=True).replace(dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, JM=JM,
                                 Engine=JaxEngine, Reference=JaxReference,
                                 cfg=cfg, tcfg=tcfg, jp=jp, tp=tp)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _compare_states(m, jstate, tstate):
    want = _flat(m.jax.tree.map(np.asarray, jstate))
    got = _flat(bridge.state_to_numpy(tstate, m.tcfg))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# The serving steps


def _fresh(m):
    """JAX's and the port's fresh serving states, and the port's reset
    template."""
    js = m.JM.init_paged_state(m.jp, m.cfg, B, CACHE, page_size=P,
                               n_pages=NPAGES)
    ts = bridge.state_from_numpy(m.jax.tree.map(np.asarray, js), m.tcfg, "cpu")
    return js, ts, TM.reset_template(ts)


def _reset(m, js, j0, ts, tmpl, mask):
    """Admit the masked slots on both sides (no paged layer: the block
    tables are absent, the rows unused)."""
    jnp = m.jnp
    rows = np.full((B, CACHE // P), NPAGES, np.int32)
    plen = np.zeros(B, np.int32)
    js = m.JM.reset_paged_slots(m.cfg, js, j0, jnp.asarray(mask),
                                jnp.asarray(rows), jnp.asarray(plen))
    TM.reset_paged_slots(m.tcfg, ts, tmpl, torch.from_numpy(mask),
                         torch.from_numpy(rows), torch.from_numpy(plen))
    return js


def _pack(rng, cursor, chunks, T, vocab):
    """A ragged pack of (slot, count) runs at each slot's next positions,
    an invalid entry after the first run, an invalid tail; logit_idx at
    each listed slot's last token."""
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
    assert n < T
    return tokens, slot, q_pos, seq, valid, logit_idx


def test_ragged_step_matches_jax(xl):
    """Packs of prefill runs (up to the width, C + 1) beside decode tokens,
    an idle slot now and then; after the third pack slot 1 is re-admitted
    and starts over.  Logits and every state leaf after each pack."""
    m = xl
    jnp = m.jnp
    js, ts, tmpl = _fresh(m)
    j0 = js
    js = _reset(m, js, j0, ts, tmpl, np.ones(B, bool))
    rng = np.random.RandomState(7)
    cursor = [0] * B
    plan = [[(0, 9), (1, 5)], [(0, 1), (1, 9), (2, 7)],
            [(2, 1), (0, 1), (1, 1)], None, [(1, 9), (0, 1), (2, 1)],
            [(0, 1), (1, 1), (2, 1)]]
    for chunks in plan:
        if chunks is None:  # slot 1 finishes; a new request takes it
            js = _reset(m, js, j0, ts, tmpl, np.asarray([False, True, False]))
            cursor[1] = 0
            _compare_states(m, js, ts)
            assert bool((ts["layers"][0][1]["sm"][:, 1] == -1e30).all())
            continue
        vecs = _pack(rng, cursor, chunks, 32, m.cfg.vocab_size)
        jl, js = m.JM.ragged_step(m.jp, m.cfg, js,
                                  *(jnp.asarray(a) for a in vecs), width=C + 1)
        tl, ts = TM.ragged_step(m.tp, m.tcfg, ts,
                                *(torch.from_numpy(a) for a in vecs),
                                width=C + 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)


def test_paged_step_matches_jax(xl):
    """The two-phase path: two (B, C) prefill chunks (slot 0 full, slot 1
    a short one with an invalid tail, slot 2 idle), then decode ticks for
    slots 0 and 1 with slot 2 riding along invalid.  Logits and every
    state leaf after each step."""
    m = xl
    jnp = m.jnp
    js, ts, tmpl = _fresh(m)
    js = _reset(m, js, js, ts, tmpl, np.ones(B, bool))
    rng = np.random.RandomState(11)
    fill = [0, 0]
    steps = []
    for n1 in (C, 3):
        tok = rng.randint(0, m.cfg.vocab_size, (B, C)).astype(np.int32)
        q_pos = np.stack([fill[0] + np.arange(C), fill[1] + np.arange(C),
                          np.arange(C)]).astype(np.int32)
        valid = np.zeros((B, C), bool)
        valid[0], valid[1, :n1] = True, True
        fill = [fill[0] + C, fill[1] + n1]
        steps.append((tok, q_pos, valid, False))
    for _ in range(3):
        tok = rng.randint(0, m.cfg.vocab_size, (B, 1)).astype(np.int32)
        q_pos = np.asarray([[fill[0]], [fill[1]], [0]], np.int32)
        steps.append((tok, q_pos, np.asarray([[True], [True], [False]]), True))
        fill = [fill[0] + 1, fill[1] + 1]
    for tok, qp, va, with_logits in steps:
        jl, js = m.JM.paged_step(m.jp, m.cfg, js,
                                 *(jnp.asarray(a) for a in (tok, qp, va)),
                                 with_logits=with_logits)
        tl, ts = TM.paged_step(m.tp, m.tcfg, ts,
                               *(torch.from_numpy(a) for a in (tok, qp, va)),
                               with_logits=with_logits)
        if with_logits:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)


def test_rollback_leaves_recurrent_state_bit_identical(xl):
    """``rollback_paged_slots`` on a recurrent model's advanced state: every
    leaf stays bit-identical, as JAX's ``rollback_stage_slots`` passes
    them through."""
    m = xl
    js, ts, tmpl = _fresh(m)
    js = _reset(m, js, js, ts, tmpl, np.ones(B, bool))
    vecs = _pack(np.random.RandomState(3), [0] * B, [(0, 6), (2, 4)], 32,
                 m.cfg.vocab_size)
    TM.ragged_step(m.tp, m.tcfg, ts, *(torch.from_numpy(a) for a in vecs),
                   width=C + 1)
    before = {k: v.clone() for k, v in _flat(ts).items()}
    mask, new_len = np.asarray([True, False, True]), np.asarray([2, 0, 1],
                                                                np.int32)
    TM.rollback_paged_slots(m.tcfg, ts, torch.from_numpy(mask),
                            torch.from_numpy(new_len))
    after = _flat(ts)
    assert after.keys() == before.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    jout = m.JM.rollback_paged_slots(m.cfg, js, m.jnp.asarray(mask),
                                     m.jnp.asarray(new_len))
    for a, b in zip(m.jax.tree.leaves(jout), m.jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reset_template_holds_fresh_values(xl):
    """The engine's reset template: 0 for every recurrent leaf but the
    sLSTM stabilizer's -1e30, exactly the fresh state's values."""
    _, ts, tmpl = _fresh(xl)
    fresh = TM.init_paged_state(xl.tp, xl.tcfg, B, CACHE, page_size=P,
                                n_pages=NPAGES)
    for ss, ts0 in zip(fresh["layers"], tmpl["layers"]):
        for cache, t0 in zip(ss, ts0):
            assert set(cache) == set(t0)
            for k, leaf in cache.items():
                assert bool((leaf == t0[k]).all()), k
    assert tmpl["layers"][0][1]["sm"] == -1e30


# ---------------------------------------------------------------------------
# The lock-step path


def test_lockstep_prefill_and_decode_match_jax(xl):
    """``prefill`` of a 2 x 13 prompt batch (the mLSTM's chunk of 128 falls
    back to one), then four ``decode_step``s: logits and every state leaf
    after each."""
    m = xl
    jnp = m.jnp
    tok = np.random.RandomState(5).randint(0, m.cfg.vocab_size,
                                           (2, 13)).astype(np.int32)
    js = m.JM.init_decode_state(m.jp, m.cfg, 2, CACHE)
    js = m.JM.prefill(m.jp, m.cfg, js, jnp.asarray(tok))
    ts = TM.init_decode_state(m.tp, m.tcfg, 2, CACHE)
    TM.prefill(m.tp, m.tcfg, ts, torch.from_numpy(tok))
    _compare_states(m, js, ts)
    nxt = tok[:, -1:]
    for _ in range(4):
        jl, js = m.JM.decode_step(m.jp, m.cfg, js, jnp.asarray(nxt))
        tl, ts = TM.decode_step(m.tp, m.tcfg, ts, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]


def test_reference_engine_matches_jax(xl):
    """The lock-step ``ReferenceEngine`` on an equal-length wave over 2
    slots, then a third request in a reused slot: every tick's logits and
    the transcripts equal JAX's."""
    m = xl
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
    assert tt == jt
    assert len(tticks) == len(jticks)
    for a, b in zip(tticks, jticks):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# Served transcripts and the engine's gates


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in lens]


def _solo(m, prompt, max_tokens):
    """The port's own ground truth: the lock-step engine at batch 1."""
    ref = ReferenceEngine(m.tp, m.tcfg, batch_size=1, cache_len=CACHE,
                          device="cpu")
    uid = ref.submit(prompt, max_tokens=max_tokens)
    return ref.run()[uid]


def _jax_solo(m, prompt, max_tokens):
    """tests/test_serve.py's ``_solo_decode``: prefill at batch 1, then
    greedy decode from the last prompt token."""
    jnp = m.jnp
    state = m.JM.init_decode_state(m.jp, m.cfg, 1, CACHE)
    state = m.JM.prefill(m.jp, m.cfg, state,
                         np.asarray(prompt, np.int32)[None])
    t = jnp.asarray([[int(prompt[-1])]], jnp.int32)
    out = []
    for _ in range(max_tokens):
        logits, state = m.JM.decode_step(m.jp, m.cfg, state, t)
        tok = int(jnp.argmax(logits[:, -1], -1)[0])
        out.append(tok)
        t = jnp.asarray([[tok]], jnp.int32)
    return out


def _both(m, prompts, max_tokens=4, **kw):
    """The JAX and the port engine on the same traffic: (JAX transcripts,
    the port's, JAX's engine, the port's)."""
    kw = {**dict(batch_size=2, cache_len=CACHE, page_size=8), **kw}
    je = m.Engine(m.jp, m.cfg, **kw)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", **kw)
    out = []
    for eng in (je, te):
        uids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
        res = eng.run()
        out.append([res[u] for u in uids])
    return out[0], out[1], je, te


def test_recurrent_hybrid_serves_correctly(xl):
    """The port of tests/test_serve.py's test: masked recurrent rolls keep
    per-slot states from advancing on pad tails or idle ticks; 3 prompts
    over 2 slots, so one slot is reused and its state reset.  Every
    request equals JAX's solo decode, JAX's engine and the port's solo
    lock-step engine."""
    m = xl
    prompts = _prompts(m.cfg.vocab_size, [5, 14, 9], seed=6)
    want, got, je, te = _both(m, prompts, batch_size=2, prefill_chunk=16)
    solo = [_jax_solo(m, p, 4) for p in prompts]
    assert got == want == solo == [_solo(m, p, 4) for p in prompts]
    assert te.stats["admissions"] == je.stats["admissions"] == 3
    assert_stats_equal(te, je.stats)


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_mixed_lengths_match_jax(xl, ragged):
    """Mixed lengths through a token budget of 24 and chunks of 8 (prompts
    split over several ticks, decode tokens beside prefill runs): JAX's
    transcripts, the port's solo lock-step decode, one trace on the ragged
    path, merged stats equal."""
    m = xl
    prompts = _prompts(m.cfg.vocab_size, [5, 19, 11, 26, 8], seed=21)
    want, got, je, te = _both(m, prompts, prefill_chunk=C, token_budget=24,
                              ragged=ragged)
    assert got == want == [_solo(m, p, 4) for p in prompts]
    assert te.stats["traces"] == je.stats["traces"] == (1 if ragged else 0)
    assert_stats_equal(te, je.stats)


GATE_KW = [dict(), dict(spec_k=2), dict(host_pages=16),
           dict(ragged=False, preempt=True), dict(max_pages=20),
           dict(kv_dtype="int8")]


@pytest.mark.parametrize("kw", GATE_KW, ids=lambda kw: ",".join(kw) or "default")
def test_engine_gates_match_jax(xl, kw):
    """No paged layer: prefix cache, speculation, preemption and the host
    tier are off, silently, as in JAX; the pool holds one block table a
    slot of pages (``max_pages`` aside) and a request reserves none.  Every
    attribute and stat equal JAX's, before and after serving."""
    from repro_torch.serve.handle import Request

    m = xl
    kw = {**dict(batch_size=2, cache_len=CACHE, page_size=8, prefill_chunk=16,
                 token_budget=32), **kw}
    je = m.Engine(m.jp, m.cfg, **kw)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", **kw)
    for name in ("prefix_cache", "_spec_k", "preempt", "host_pages", "n_pages",
                 "_has_paged"):
        assert getattr(te, name) == getattr(je, name), name
    assert not te._has_paged and not te.prefix_cache and te._spec_k == 0
    assert not te.preempt and te.host_pages == 0
    assert te.n_pages == kw.get("max_pages", 2 * CACHE // 8)
    prompts = _prompts(m.cfg.vocab_size, [20, 9], seed=4)
    assert te._pages_needed(Request(0, prompts[0], 3)) == 0
    assert_stats_equal(te, je.stats)
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_tokens=3)
        eng.run()
    assert_stats_equal(te, je.stats)


def test_captured_step_state_matches_jax_after_a_run(xl):
    """The engine's state after serving (its ``CapturedStep`` run eagerly
    on the CPU) equals the JAX engine's leaf for leaf."""
    m = xl
    prompts = _prompts(m.cfg.vocab_size, [12, 4, 7], seed=9)
    _, _, je, te = _both(m, prompts, batch_size=3, prefill_chunk=C,
                         token_budget=24)
    _compare_states(m, je._state, te._state)


@pytest.mark.parametrize("engine", ["ragged", "chunked", "reference"])
def test_launcher_serves_xlstm(engine, capsys):
    assert tserve.main(["--arch", "xlstm-350m", "--device", "cpu",
                        "--requests", "3", "--batch-size", "2",
                        "--prompt-len", "10", "--max-tokens", "3",
                        "--engine", engine]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3


def test_launcher_trains_xlstm(capsys):
    assert ttrain.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu",
                        "--steps", "2"]) == 0
    assert "xlstm-smoke: loss" in capsys.readouterr().out


def test_recurrent_leaves_are_not_pool_leaves():
    """Admission restores recurrent state from the template; none of its
    leaves is a shared pool leaf that survives slot churn."""
    for name in ("C", "n", "m", "conv", "sh", "sc", "sn", "sm"):
        assert name in TT.FRESH_VALUES and name not in TT.POOL_LEAVES

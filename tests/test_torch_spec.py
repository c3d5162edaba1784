"""Speculative decoding in the port against the JAX package, on the CPU:
float32 smoke configs on the same weights (through ``repro_torch.bridge``),
the scenarios of tests/test_speculative.py.

- ``prompt_lookup_draft`` equals JAX's on seeded random histories, over
  depths and n-gram bounds; ``SpeculativeScheduler`` delegates every
  ordering and validates its arguments as JAX's does.
- The engine with ``spec_k=4``: greedy transcripts token-identical to the
  same engine at ``spec_k=0`` and to the JAX engine at ``spec_k=4``, with
  equal ``spec_*``, ``ticks`` and ``traces`` stats, for qwen2-1.5b (tied),
  glm4-9b and qwen1.5-4b (untied), float32 and int8 pools, on the tiled
  (accepting) and the small-alphabet (rejecting) workloads.
- After every tick of the small-alphabet workload the port's ``kpos`` and
  ``slen`` equal JAX's (the rollback), and the pools never move.
- Temperature sampling with seeds, a chain cut by ``max_tokens``, a budget
  too tight for drafts, a ``SpeculativeScheduler`` passed as
  ``scheduler=``, and the constructor's ``ValueError``s.
- On a card (``gpu``): the captured (B, R) step and the captured rollback
  against the same engine with ``cuda_graph=False``.

JAX is imported lazily (``_jax``), so that ``pytest -m gpu`` runs where
there is no JAX.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.util import dense_lm  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCHS = ["qwen2-1.5b", "glm4-9b", "qwen1.5-4b"]
KW = dict(batch_size=3, cache_len=128, page_size=8, prefill_chunk=16,
          token_budget=48)
STATS = ("spec_k", "spec_drafted", "spec_accepted", "spec_rejected",
         "spec_rollbacks", "sampled_slot_ticks", "ticks", "ragged_ticks",
         "packed_tokens", "traces")


def _jax():
    """The JAX package's pieces these tests compare with."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model
    from repro.serve import scheduler
    from repro.serve.engine import ServeEngine as Engine

    return types.SimpleNamespace(jax=jax, get_config=get_config, M=model,
                                 sched=scheduler, Engine=Engine)


def _load(arch):
    J = _jax()
    cfg = J.get_config(arch, smoke=True).replace(dtype="float32",
                                                 param_dtype="float32")
    tcfg = tget(arch, smoke=True).replace(dtype="float32",
                                          param_dtype="float32")
    jp = J.M.init_params(J.jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(J.jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _load(request.param)


@pytest.fixture(scope="module")
def qwen():
    return _load("qwen2-1.5b")


def _tiled_prompts(vocab, n, pattern_len=6, reps=6, seed=7):
    """A short random pattern tiled: greedy continuations loop, which
    prompt lookup predicts (tests/test_speculative.py)."""
    rng = np.random.RandomState(seed)
    return [np.tile(rng.randint(0, vocab, pattern_len), reps) for _ in range(n)]


def _small_alphabet_prompts(n, seed=11):
    """Tokens 1-4 only: lookup always drafts, the model often disagrees —
    the rejection and rollback workload (tests/test_speculative.py)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 5, 40) for _ in range(n)]


def _serve(engine, prompts, **kw):
    kw.setdefault("max_tokens", 16)
    uids = [engine.submit(p, **kw) for p in prompts]
    res = engine.run()
    return [res[u] for u in uids]


# ---------------------------------------------------------------------------
# drafter and wrapper


@pytest.mark.parametrize("ngram", [(1, 3), (2, 2), (1, 1), (2, 4)],
                         ids=lambda g: f"ngram{g[0]}-{g[1]}")
@pytest.mark.parametrize("alphabet", [3, 6, 20])
def test_prompt_lookup_draft_equals_jax(ngram, alphabet):
    lo, hi = ngram
    rng = np.random.RandomState(alphabet * 10 + hi)
    hits = 0
    for _ in range(60):
        hist = rng.randint(0, alphabet, rng.randint(0, 40))
        for k in (0, 1, 3, 5):
            want = _jax().sched.prompt_lookup_draft(hist, k, ngram_max=hi, ngram_min=lo)
            got = tsched.prompt_lookup_draft(hist, k, ngram_max=hi, ngram_min=lo)
            assert got == want, (hist, k)
            hits += bool(want)
    assert hits > 0


def test_prompt_lookup_draft_cases():
    d = tsched.prompt_lookup_draft
    assert d([1, 2, 3, 4, 2, 3], 3) == [4, 2, 3]
    assert d([5, 1, 2, 6, 1, 2, 7, 1, 2], 1) == [7]  # the latest match
    assert d([1, 2, 3, 4, 5], 4) == [] and d([1], 4) == []
    assert d([9, 1, 2, 8, 2, 5, 9, 1, 2], 1, ngram_max=3) == [8]


def test_speculative_scheduler_delegates_and_validates():
    inner = tsched.FifoScheduler()
    s = tsched.SpeculativeScheduler(inner, spec_k=3)
    assert s.inner is inner and s.name == "speculative(fifo,k=3)"
    assert s.name == _jax().sched.SpeculativeScheduler(spec_k=3).name

    class V:
        queue = (1, 2)
    assert list(s.admission_order(V())) == [0, 1]
    assert s.decode_order(V(), [2, 0, 1]) == [2, 0, 1]
    assert s.prefill_order(V(), [1, 0]) == [1, 0]
    assert s.draft([1, 2, 1, 2, 1, 2], 99) == [1, 2]  # capped at spec_k
    assert s.draft([7, 8, 9, 7, 8, 9, 7, 8, 9], 99) == [7, 8, 9]
    r = tsched.make_scheduler("speculative")
    assert isinstance(r, tsched.SpeculativeScheduler) and r.inner.name == "fifo"
    for bad in (dict(spec_k=0), dict(spec_k=2, ngram_min=0),
                dict(spec_k=2, ngram_min=3, ngram_max=2)):
        with pytest.raises(ValueError):
            _jax().sched.SpeculativeScheduler(**bad)
        with pytest.raises(ValueError):
            tsched.SpeculativeScheduler(**bad)
    slo = tsched.SpeculativeScheduler("slo", spec_k=2)
    assert isinstance(slo.inner, tsched.SloScheduler)
    assert slo.name == "speculative(slo,k=2)" == _jax().sched.SpeculativeScheduler(
        "slo", spec_k=2).name
    R = types.SimpleNamespace
    reqs = (R(uid=1, priority=0), R(uid=2, priority=1), R(uid=3, priority=0))
    v = R(queue=(), slot_requests=reqs)
    assert slo.prefill_order(v, [0, 1, 2]) == [1, 0, 2]  # interactive first
    assert list(slo.preempt_order(v, [0, 1, 2])) == [2, 0]  # batch only


def test_engine_validates_spec_k(qwen):
    cfg, tcfg, jp, tp = qwen
    for kw in (dict(spec_k=-1), dict(spec_k=2, ragged=False)):
        with pytest.raises(ValueError):
            _jax().Engine(jp, cfg, **KW, **kw)
        with pytest.raises(ValueError):
            ServeEngine(tp, tcfg, device="cpu", **KW, **kw)


# ---------------------------------------------------------------------------
# the engine against JAX


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("workload", ["tiled", "small_alphabet"])
def test_greedy_transcripts_and_stats_equal_jax(model, workload, kv_dtype):
    cfg, tcfg, jp, tp = model
    prompts = (_tiled_prompts(cfg.vocab_size, 3) if workload == "tiled"
               else _small_alphabet_prompts(3))
    kw = dict(KW, kv_dtype=kv_dtype)
    je = _jax().Engine(jp, cfg, spec_k=4, **kw)
    te = ServeEngine(tp, tcfg, spec_k=4, device="cpu", **kw)
    off = ServeEngine(tp, tcfg, device="cpu", **kw)
    want = _serve(je, prompts)
    assert _serve(te, prompts) == want == _serve(off, prompts)
    ts, js = te.stats, je.stats
    for key in STATS:
        assert ts[key] == js[key], key
    assert ts["traces"] == off.stats["traces"] == 1
    assert ts["spec_drafted"] == ts["spec_accepted"] + ts["spec_rejected"]
    assert ts["kernel_launches"] == 0 and ts["graph_captures"] == 0  # CPU
    assert te.reclaimable_pages == te.n_pages
    if workload == "tiled" and tcfg.name.startswith("qwen2"):
        # the tied smoke model loops on a tiled prompt: drafts are accepted
        # and a sampled slot-tick emits more than one token
        assert ts["spec_accepted"] > 0 and ts["ticks"] < off.stats["ticks"]
        assert sum(map(len, want)) > ts["sampled_slot_ticks"]


def _kpos_slen(state, cfg):
    return [(c["kpos"], c["slen"]) for ss in state["layers"] for c in ss]


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
def test_rollback_kpos_slen_equal_jax_after_every_tick(model, kv_dtype, flash):
    cfg, tcfg, jp, tp = model
    prompts = _small_alphabet_prompts(3)
    kw = dict(KW, kv_dtype=kv_dtype, flash_decode=flash)
    je = _jax().Engine(jp, cfg, spec_k=4, **kw)
    te = ServeEngine(tp, tcfg, spec_k=4, device="cpu", **kw)
    jh = [je.submit(p, max_tokens=16) for p in prompts]
    th = [te.submit(p, max_tokens=16) for p in prompts]
    ptrs = [t.data_ptr() for t in te.pool_tensors()]
    while not je.idle:
        je.tick()
        te.tick()
        want = _kpos_slen(_jax().jax.tree.map(np.asarray, je._state), cfg)
        got = _kpos_slen(bridge.state_to_numpy(te._state, tcfg), tcfg)
        for (gk, gs), (wk, ws) in zip(got, want):
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gs, ws)
        # no slot holds a live row at or past its next write position
        for b, s in enumerate(te.slots):
            if s is not None:
                lim = max(s.pos, s.fill)
                for k, sl in got:
                    assert k[..., b, :].max() < lim and sl[..., b].max() <= lim
    assert te.idle
    assert [h.result() for h in th] == [h.result() for h in jh]
    assert te.stats["spec_rollbacks"] == je.stats["spec_rollbacks"]
    assert [t.data_ptr() for t in te.pool_tensors()] == ptrs
    if tcfg.name.startswith("qwen2"):
        assert te.stats["spec_rejected"] > 0 and te.stats["spec_rollbacks"] > 0


def test_rollback_is_masked_and_in_place(qwen):
    """``rollback_paged_slots`` alone: masked slots lose kpos >= new_len
    and clamp slen; other slots and every pool are untouched."""
    from repro_torch.models import model as TM

    _, tcfg, _, tp = qwen
    st = TM.init_paged_state(tp, tcfg, 3, 32, page_size=8, n_pages=12,
                             kv_dtype="int8")
    c = st["layers"][0][0]
    c["kpos"].copy_(torch.arange(32, dtype=torch.int32).expand_as(c["kpos"]))
    c["slen"].fill_(20)
    c["kp"].fill_(3)
    before = {k: v.clone() for k, v in c.items()}
    TM.rollback_paged_slots(tcfg, st, torch.tensor([True, False, True]),
                            torch.tensor([7, 1, 25], dtype=torch.int32))
    assert torch.equal(c["kpos"][:, 1], before["kpos"][:, 1])
    assert int(c["kpos"][0, 0].max()) == 6 and int(c["kpos"][0, 0, 7]) == -1
    assert int(c["kpos"][0, 2].max()) == 24
    assert c["slen"][0].tolist() == [7, 20, 20]
    for k in ("kp", "vp", "ks", "vs", "ptab"):
        assert torch.equal(c[k], before[k]), k


# ---------------------------------------------------------------------------
# edges


def test_identical_at_temperature_with_seeds(qwen):
    cfg, tcfg, jp, tp = qwen
    prompts = _tiled_prompts(cfg.vocab_size, 2, seed=19)
    outs = []
    for eng in (_jax().Engine(jp, cfg, spec_k=5, **KW),
                ServeEngine(tp, tcfg, spec_k=5, device="cpu", **KW),
                ServeEngine(tp, tcfg, device="cpu", **KW)):
        uids = [eng.submit(p, max_tokens=16, temperature=2.0, top_k=40,
                           seed=100 + i) for i, p in enumerate(prompts)]
        got = eng.run()
        outs.append([got[u] for u in uids])
    assert outs[0] == outs[1] == outs[2]


def test_chain_cut_by_max_tokens(qwen):
    cfg, tcfg, jp, tp = qwen
    prompts = _tiled_prompts(cfg.vocab_size, 2, seed=31)
    je = _jax().Engine(jp, cfg, spec_k=6, **KW)
    te = ServeEngine(tp, tcfg, spec_k=6, device="cpu", **KW)
    want = _serve(je, prompts, max_tokens=5)
    assert _serve(te, prompts, max_tokens=5) == want
    assert all(len(t) == 5 for t in want)
    assert _serve(ServeEngine(tp, tcfg, device="cpu", **KW), prompts,
                  max_tokens=5) == want
    for key in STATS:
        assert te.stats[key] == je.stats[key], key


def test_tight_budget_packs_no_drafts(qwen):
    cfg, tcfg, jp, tp = qwen
    [p] = _tiled_prompts(cfg.vocab_size, 1, seed=37)
    kw = dict(KW, batch_size=1, token_budget=1, prefill_chunk=1)
    te = ServeEngine(tp, tcfg, spec_k=4, device="cpu", **kw)
    got = _serve(te, [p], max_tokens=8)
    assert te.stats["spec_drafted"] == 0
    assert got == _serve(ServeEngine(tp, tcfg, device="cpu", **kw), [p],
                         max_tokens=8)
    assert got == _serve(_jax().Engine(jp, cfg, spec_k=4, **kw), [p], max_tokens=8)


def test_speculative_scheduler_passed_as_scheduler_is_honoured(qwen):
    cfg, tcfg, jp, tp = qwen
    prompts = _tiled_prompts(cfg.vocab_size, 3)
    te = ServeEngine(tp, tcfg, scheduler=tsched.SpeculativeScheduler(spec_k=3),
                     device="cpu", **KW)
    je = _jax().Engine(jp, cfg, scheduler=_jax().sched.SpeculativeScheduler(spec_k=3),
                   **KW)
    assert te.stats["spec_k"] == 3 and te.stats["scheduler"] == je.stats["scheduler"]
    assert _serve(te, prompts) == _serve(je, prompts)
    for key in STATS:
        assert te.stats[key] == je.stats[key], key


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_captured_verify_step_and_rollback_match_eager(kv_dtype):
    """The captured (B, R) ragged step and the captured rollback against
    the same engine run eagerly (``cuda_graph=False``): a small untied
    decoder at head_dim 64 and G 4 (the serving kernel's tensor-core
    variant), bf16 activations; equal transcripts and spec stats, two
    graphs captured, kernel launches counted per replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import model as TM

    tcfg = dense_lm("spec-card-test", n_layers=2, d_model=256, n_heads=8,
                    n_kv=2, head_dim=64, d_ff=512, vocab=512, qkv_bias=True,
                    rope_theta=1e4, tie=False, max_seq_len=256)
    tcfg = tcfg.replace(dtype="bfloat16")
    tp = TM.init_params(tcfg, generator=torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    prompts = _tiled_prompts(tcfg.vocab_size, 2) + _small_alphabet_prompts(2)
    runs = []
    for captured in (True, False):
        eng = ServeEngine(tp, tcfg, spec_k=4, flash_decode=True,
                          kv_dtype=kv_dtype, cuda_graph=captured, device="cuda",
                          **dict(KW, batch_size=4, token_budget=64))
        ptrs = [t.data_ptr() for t in eng.pool_tensors()]
        out = _serve(eng, prompts)
        st = eng.stats
        assert st["graph_captures"] == (2 if captured else 0)
        assert st["traces"] == 1
        assert st["kernel_launches"] == tcfg.n_layers * st["ragged_ticks"]
        assert [t.data_ptr() for t in eng.pool_tensors()] == ptrs
        runs.append((out, {k: st[k] for k in STATS}))
    assert runs[0] == runs[1]
    assert runs[0][1]["spec_drafted"] > 0

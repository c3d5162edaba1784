"""The port's lock-step decode path against the JAX package's, on the CPU:
``init_decode_state``, ``prefill`` and ``decode_step`` (the ``ReferenceEngine``'s
path), ``ReferenceEngine`` itself with its slot-copy rules, and the
launcher's ``--engine reference``.

qwen2-1.5b (one stacked stage of 2 layers) and gemma3-4b (a 3-layer pattern
in one unstacked stage: two windowed layers, window 16, then a global one)
smoke configs in float32, the same seed-0 weights on both sides through
``repro_torch.bridge``.  A 33-token prompt against window 16 wraps the
circular buffer in ``prefill_cache`` and again during decode.  Tolerances:
logits and float state leaves atol = rtol = 1e-4; integer leaves
(``k_pos``, ``pos``) and transcripts equal.  JAX is imported lazily (a
fixture).
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import attention as TA  # noqa: E402
from repro_torch.serve import reference as TR  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2-1.5b", "gemma3-4b"]
CACHE = 64


def _load(arch):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve import reference as JR

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tcfg = tget(arch, smoke=True).replace(dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, JM=JM, JR=JR, cfg=cfg,
                                 tcfg=tcfg, jp=jp, tp=tp)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _load(request.param)


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
        assert got[k].shape == want[k].shape, k
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_decode_state_layout_follows_jax(model):
    """Leaf names, shapes and dtypes of a fresh state, both ways through
    the bridge: a windowed layer's buffers hold the window, a global
    layer's ``cache_len``."""
    m = model
    js = m.JM.init_decode_state(m.jp, m.cfg, 3, CACHE)
    ts = TM.init_decode_state(m.tp, m.tcfg, 3, CACHE)
    _compare_states(m, js, ts)
    back = bridge.state_from_numpy(m.jax.tree.map(np.asarray, js), m.tcfg, "cpu")
    for k, v in _flat(back).items():
        want = _flat(ts)[k]
        assert v.shape == want.shape and v.dtype == want.dtype, k
    caps = {c["k"].shape[2] for ss in ts["layers"] for c in ss}
    windowed = any(b.attn.window for st in m.tcfg.stages for b in st.pattern)
    assert caps == ({16, CACHE} if windowed else {CACHE})


def test_prefill_and_decode_match_jax(model):
    """Prefill a 33-token prompt into a batch of 2 (from the bridged JAX
    state), then 16 greedy decode steps (positions 33-48: a windowed
    buffer's index wraps to 0 again): logits and every state leaf after
    each step."""
    m = model
    jnp = m.jnp
    decode = m.jax.jit(lambda p, s, t: m.JM.decode_step(p, m.cfg, s, t))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, m.cfg.vocab_size, (2, 33)).astype(np.int32)
    js = m.JM.init_decode_state(m.jp, m.cfg, 2, CACHE)
    ts = bridge.state_from_numpy(m.jax.tree.map(np.asarray, js), m.tcfg, "cpu")
    js = m.JM.prefill(m.jp, m.cfg, js, jnp.asarray(toks))
    assert TM.prefill(m.tp, m.tcfg, ts, torch.from_numpy(toks)) is ts
    _compare_states(m, js, ts)
    t = toks[:, -1:]
    for _ in range(16):
        jl, js = decode(m.jp, js, jnp.asarray(t))
        tl, ts = TM.decode_step(m.tp, m.tcfg, ts, torch.from_numpy(t))
        assert tl.shape == (2, 1, m.cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
        t = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    assert int(ts["pos"]) == 49


def _recording(engine, store):
    """Wrap an engine's ``_decode`` to keep each tick's logits (numpy)."""
    decode = engine._decode

    def run(p, s, t):
        logits, s = decode(p, s, t)
        store.append(np.asarray(logits if not torch.is_tensor(logits)
                                else logits.numpy()))
        return logits, s

    engine._decode = run


def _prompts(vocab, seed=0):
    """An equal-length wave of three prompts, then two shorter ones that
    wait in the queue and reuse slots 0 and 1 when the wave finishes."""
    rng = np.random.RandomState(seed)
    return ([rng.randint(0, vocab, 20) for _ in range(3)]
            + [rng.randint(0, vocab, 9) for _ in range(2)])


def _serve(engine, prompts, max_tokens=5):
    uids = [engine.submit(p, max_tokens=max_tokens) for p in prompts]
    res = engine.run()
    return [res[u] for u in uids]


def test_reference_engine_matches_jax(model):
    """Transcripts and every tick's logits equal JAX's ReferenceEngine's,
    for the wave and for the two requests that reuse its slots within the
    same run, so that whatever the lock-step rules do on slot reuse is
    reproduced.  For gemma3 (an unstacked stage: its per-layer positions
    take the maximum of the two states) the reusing requests decode from
    the wave's position 25 instead of 9, so their logits differ from a solo
    run's: the quirk is there, not fixed.  qwen2-1.5b's stacked stage
    replaces its per-layer positions instead, and matches a solo run."""
    m = model
    prompts = _prompts(m.cfg.vocab_size)
    jref = m.JR.ReferenceEngine(m.jp, m.cfg, batch_size=3, cache_len=CACHE)
    tref = TR.ReferenceEngine(m.tp, m.tcfg, batch_size=3, cache_len=CACHE,
                              device="cpu")
    jlog, tlog = [], []
    _recording(jref, jlog)
    _recording(tref, tlog)
    assert _serve(tref, prompts) == _serve(jref, prompts)
    assert len(tlog) == len(jlog) == 10
    for got, want in zip(tlog, jlog):
        np.testing.assert_allclose(got, want, **TOL)
    solo_log = []
    for p in prompts[3:]:
        one = TR.ReferenceEngine(m.tp, m.tcfg, batch_size=1, cache_len=CACHE,
                                 device="cpu")
        _recording(one, solo_log)
        _serve(one, [p])
    first = np.stack([solo_log[0][0, -1], solo_log[5][0, -1]])
    quirk = not np.allclose(tlog[5][:2, -1], first, **TOL)
    assert quirk == (m.tcfg.stages[0].repeats == 1)


@pytest.mark.parametrize("batch", [3, 1])
def test_write_slot_follows_jax_rules(model, batch):
    """``_write_slot`` on states prefilled to different lengths: every leaf
    equals JAX's ``_write_slot``'s (at batch 1 no axis differs, so leaves
    are replaced whole)."""
    m = model
    jnp = m.jnp
    rng = np.random.RandomState(batch)
    pooled = rng.randint(0, m.cfg.vocab_size, (batch, 21)).astype(np.int32)
    single = rng.randint(0, m.cfg.vocab_size, (1, 11)).astype(np.int32)
    js = m.JM.prefill(m.jp, m.cfg, m.JM.init_decode_state(m.jp, m.cfg, batch, CACHE),
                      jnp.asarray(pooled))
    jo = m.JM.prefill(m.jp, m.cfg, m.JM.init_decode_state(m.jp, m.cfg, 1, CACHE),
                      jnp.asarray(single))
    ts = TM.prefill(m.tp, m.tcfg, TM.init_decode_state(m.tp, m.tcfg, batch, CACHE),
                    torch.from_numpy(pooled))
    to = TM.prefill(m.tp, m.tcfg, TM.init_decode_state(m.tp, m.tcfg, 1, CACHE),
                    torch.from_numpy(single))
    b = batch - 1
    want = m.JR._write_slot(js, jo, b)
    TR._write_slot(m.tcfg, ts, to, b)
    _compare_states(m, want, ts)


def test_sp_decode_raises(model):
    m = model
    blk = m.tcfg.stages[0].pattern[0]
    cache = TA.init_cache(blk.attn, 1, 8, torch.float32)
    view = {k: v[0] for k, v in cache.items()}
    x = torch.zeros(1, 1, m.tcfg.d_model)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TA.attention_decode({}, blk.attn, x, view, sp_decode=True)


def test_reference_engine_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    tcfg = tget("gemma3-4b", smoke=True)
    params = TM.init_params(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.ReferenceEngine(params, tcfg)


def test_launcher_runs_the_reference_engine(capsys):
    """``--engine reference`` serves (gemma3-4b's smoke config) and, like
    the JAX launcher, prints no stats line."""
    assert tserve.main(["--arch", "gemma3-4b", "--engine", "reference",
                        "--device", "cpu", "--requests", "3",
                        "--batch-size", "3", "--max-tokens", "3",
                        "--prompt-len", "20"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "stats:" not in out

"""gemma3's two RoPE bases against the JAX package, on the CPU.

gemma3-4b FULL gives its windowed layers RoPE theta 1e4 and its global
layers theta 1e6 (``configs/gemma3_4b.py``); the smoke config uses 1e4 for
both.  Here the smoke config's global block is replaced, on both sides and
in this file only, by one at theta 1e6, so that a model with both bases
meets the reference: the ragged and two-phase steps' logits and every
state leaf after packs that outgrow the window, the lock-step prefill and
decode, the three engines' transcripts, and training with ``use_flash``
(the global layer through the flash kernel's route).  Float32, the same seed-0
weights through ``repro_torch.bridge``; logits and float state leaves at
rtol = atol = 1e-4, integer leaves and transcripts equal.  Each check
first shows that the base matters here: the port's logits at theta 1e6
differ from its logits at 1e4 by more than the tolerance.  JAX is
imported lazily (a fixture).
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE = 64
B, P, NPAGES, C = 3, 8, 30, 24
THETA = 1e6


def _with_global_theta(cfg, theta):
    """``cfg`` with every global (window-less) attention block at RoPE
    base ``theta``."""
    def blk(b):
        if b.mixer != "attn" or b.attn.window is not None:
            return b
        return dataclasses.replace(
            b, attn=dataclasses.replace(b.attn, rope_theta=theta))

    return cfg.replace(stages=tuple(
        dataclasses.replace(st, pattern=tuple(blk(b) for b in st.pattern))
        for st in cfg.stages))


@pytest.fixture(scope="module")
def gm():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro.serve.reference import ReferenceEngine as JaxReference

    base = get_config("gemma3-4b", smoke=True).replace(dtype="float32")
    tbase = tget("gemma3-4b", smoke=True).replace(dtype="float32")
    cfg, tcfg = _with_global_theta(base, THETA), _with_global_theta(tbase, THETA)
    thetas = [b.attn.rope_theta for b in tcfg.stages[0].pattern]
    assert thetas == [1e4, 1e4, THETA]
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, JM=JM,
                                 Engine=JaxEngine, Reference=JaxReference,
                                 cfg=cfg, tcfg=tcfg, tbase=tbase, jp=jp, tp=tp)


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
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _theta_matters(got, base_logits):
    """The base changes these logits by more than the tolerance."""
    diff = np.abs(got - base_logits) - (TOL["atol"] + TOL["rtol"] * np.abs(got))
    assert diff.max() > 0, "theta 1e6 and 1e4 give the same logits here"


def _rows():
    rows = np.full((B, CACHE // P), NPAGES, np.int32)
    for b in range(B):
        rows[b] = np.arange(CACHE // P) + b * (CACHE // P)
    return rows


def _states(m, tcfg):
    """Fresh, admitted serving states: JAX's and the port's at ``tcfg``."""
    jnp = m.jnp
    js = m.JM.init_paged_state(m.jp, m.cfg, B, CACHE, page_size=P,
                               n_pages=NPAGES, window_extra=C)
    ts = bridge.state_from_numpy(m.jax.tree.map(np.asarray, js), tcfg, "cpu")
    mask, rows, plen = np.ones(B, bool), _rows(), np.zeros(B, np.int32)
    js = m.JM.reset_paged_slots(m.cfg, js, js, jnp.asarray(mask),
                                jnp.asarray(rows), jnp.asarray(plen))
    TM.reset_paged_slots(tcfg, ts, TM.reset_template(ts), torch.from_numpy(mask),
                         torch.from_numpy(rows), torch.from_numpy(plen))
    return js, ts


def _pack(cursor, chunks, T, vocab, rng):
    tokens = rng.randint(0, vocab, T).astype(np.int32)
    slot, q_pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    seq, valid = np.full(T, C + 1, np.int32), np.zeros(T, bool)
    logit_idx = np.full(B, T, np.int32)
    n = 0
    for b, c in chunks:
        slot[n:n + c], q_pos[n:n + c] = b, cursor[b] + np.arange(c)
        seq[n:n + c], valid[n:n + c] = np.arange(c), True
        logit_idx[b] = n + c - 1
        cursor[b] += c
        n += c
    return tokens, slot, q_pos, seq, valid, logit_idx


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
def test_ragged_step_at_two_bases_matches_jax(gm, flash):
    """Three packs: 24-token chunks past the window beside decode tokens,
    positions up to 50.  Logits and every state leaf after each; the
    port at theta 1e4 on the same packs gives other logits."""
    m = gm
    js, ts = _states(m, m.tcfg)
    _, tb = _states(m, m.tbase)
    rng, cursor = np.random.RandomState(2), [0] * B
    for chunks in ([(0, 24), (1, 10), (2, 3)], [(0, 24), (1, 24), (2, 1)],
                   [(0, 1), (1, 1), (2, 24)]):
        vecs = _pack(cursor, chunks, 64, m.cfg.vocab_size, rng)
        jl, js = m.JM.ragged_step(m.jp, m.cfg, js,
                                  *(m.jnp.asarray(a) for a in vecs),
                                  width=C + 1, flash_decode=flash)
        tv = [torch.from_numpy(a) for a in vecs]
        tl, ts = TM.ragged_step(m.tp, m.tcfg, ts, *tv, width=C + 1,
                                flash_decode=flash)
        bl, tb = TM.ragged_step(m.tp, m.tbase, tb, *tv, width=C + 1,
                                flash_decode=flash)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
    _theta_matters(tl.numpy(), bl.numpy())


def test_paged_step_at_two_bases_matches_jax(gm):
    """Two (B, 24) prefill chunks, then three decode ticks (slot 2 idle):
    logits and every state leaf after each step."""
    m = gm
    jnp = m.jnp
    js, ts = _states(m, m.tcfg)
    _, tb = _states(m, m.tbase)
    rng = np.random.RandomState(3)
    steps, fill = [], 0
    for _ in range(2):
        tok = rng.randint(0, m.cfg.vocab_size, (B, C)).astype(np.int32)
        q_pos = np.tile(fill + np.arange(C, dtype=np.int32), (B, 1))
        valid = np.zeros((B, C), bool)
        valid[:2] = True
        steps.append((tok, q_pos, valid, False))
        fill += C
    for _ in range(3):
        tok = rng.randint(0, m.cfg.vocab_size, (B, 1)).astype(np.int32)
        valid = np.asarray([[True], [True], [False]])
        steps.append((tok, np.full((B, 1), fill, np.int32), valid, True))
        fill += 1
    for tok, qp, va, with_logits in steps:
        arrays = (tok, qp, va)
        jl, js = m.JM.paged_step(m.jp, m.cfg, js,
                                 *(jnp.asarray(a) for a in arrays),
                                 with_logits=with_logits)
        tv = [torch.from_numpy(a) for a in arrays]
        tl, ts = TM.paged_step(m.tp, m.tcfg, ts, *tv, with_logits=with_logits)
        bl, tb = TM.paged_step(m.tp, m.tbase, tb, *tv, with_logits=with_logits)
        if with_logits:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
    _theta_matters(tl.numpy()[:2], bl.numpy()[:2])


def test_lockstep_at_two_bases_matches_jax(gm):
    """``prefill`` of 2 x 40 tokens (past the window), then four decode
    steps: logits and every state leaf after each."""
    m = gm
    jnp = m.jnp
    tok = np.random.RandomState(4).randint(0, m.cfg.vocab_size,
                                           (2, 40)).astype(np.int32)
    js = m.JM.prefill(m.jp, m.cfg, m.JM.init_decode_state(m.jp, m.cfg, 2,
                                                          CACHE),
                      jnp.asarray(tok))
    ts = TM.init_decode_state(m.tp, m.tcfg, 2, CACHE)
    TM.prefill(m.tp, m.tcfg, ts, torch.from_numpy(tok))
    tb = TM.init_decode_state(m.tp, m.tbase, 2, CACHE)
    TM.prefill(m.tp, m.tbase, tb, torch.from_numpy(tok))
    _compare_states(m, js, ts)
    nxt = tok[:, -1:]
    for _ in range(4):
        jl, js = m.JM.decode_step(m.jp, m.cfg, js, jnp.asarray(nxt))
        tl, ts = TM.decode_step(m.tp, m.tcfg, ts, torch.from_numpy(nxt))
        bl, tb = TM.decode_step(m.tp, m.tbase, tb, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    _theta_matters(tl.numpy(), bl.numpy())


@pytest.mark.parametrize("engine", ["ragged", "two-phase", "reference"])
def test_transcripts_at_two_bases_match_jax(gm, engine):
    """Prompts of 33, 7 and 21 tokens (the first past the window) over 2
    slots through each engine: JAX's transcripts, token for token (the
    lock-step engine on an equal-length wave, all it serves)."""
    m = gm
    rng = np.random.RandomState(5)
    lens = [24, 24] if engine == "reference" else [33, 7, 21]
    prompts = [rng.randint(0, m.cfg.vocab_size, n) for n in lens]
    out = []
    for params, cfg, jax_side in ((m.jp, m.cfg, True), (m.tp, m.tcfg, False)):
        kw = {} if jax_side else {"device": "cpu"}
        if engine == "reference":
            Eng = m.Reference if jax_side else ReferenceEngine
            eng = Eng(params, cfg, batch_size=2, cache_len=CACHE, **kw)
        else:
            Eng = m.Engine if jax_side else ServeEngine
            eng = Eng(params, cfg, batch_size=2, cache_len=CACHE, page_size=8,
                      prefill_chunk=C, ragged=engine == "ragged", **kw)
        uids = [eng.submit(p, max_tokens=5) for p in prompts]
        res = eng.run()
        out.append([res[u] for u in uids])
    assert out[1] == out[0]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_use_flash_training_at_two_bases_matches_jax(gm, remat, monkeypatch):
    """Training with ``use_flash`` (the global layer through the flash
    kernel's route, the windowed ones on the chunked softmax in both
    packages), 64 positions: loss and every gradient leaf against
    JAX's (its Pallas kernel in interpret mode), rtol 1e-4, gradients atol
    1e-5 x the leaf's max |g|; the flash route runs once per global layer
    in the forward pass and once more when remat recomputes the block."""
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLMData

    from repro_torch.kernels import ops as tops

    m = gm
    jax, jnp = m.jax, m.jnp
    cfg = m.cfg.replace(use_flash=True)
    tcfg = m.tcfg.replace(use_flash=True, remat=remat)
    batch = SyntheticLMData(cfg, ShapeCfg("t", 64, 2, "train"),
                            seed=1).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: m.JM.loss_fn(p, cfg, jb), has_aux=True)(m.jp)
    params = bridge.params_from_numpy(m.jax.tree.map(np.asarray, m.jp), tcfg,
                                      "cpu", for_training=True)
    calls = []
    local = tops._flash_grouped_local
    monkeypatch.setattr(tops, "_flash_grouped_local",
                        lambda *a: calls.append(1) or local(*a))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = TM.loss_fn(params, tcfg, tb)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert len(calls) == (1 if remat == "none" else 2)  # one global layer
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = _flat(bridge.grads_to_numpy(params, grads, tcfg))
    want = _flat(jax.tree.map(np.asarray, want_grads))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-4,
            atol=1e-5 * float(np.abs(want[name]).max()), err_msg=name)

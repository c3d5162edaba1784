"""Sinusoidal absolute positions on a decoder against the JAX package, on
the CPU.

Only hubert-xlarge (an encoder) sets ``abs_pos="sinusoidal"`` in the
registry; JAX adds the encodings on every path, serving ones included.
Here the qwen2-1.5b smoke config is given ``abs_pos="sinusoidal"`` on both
sides, in this file only, so that every path that adds them meets the
reference: ``forward`` and ``loss_fn``, the ragged step (gather and kernel
routes), the two-phase step (prefill chunks and decode ticks, per-slot
positions) and the lock-step ``prefill``/``decode_step`` (the encoding at
the shared "pos").  Float32, the same seed-0 weights through
``repro_torch.bridge``; logits and float state leaves at rtol = atol =
1e-4, integer leaves equal.  Each check first shows that the encodings
matter here: the port's logits without them differ by more than the
tolerance.  JAX is imported lazily (a fixture).
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import embeddings as temb  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE = 64
B, P, NPAGES, C = 3, 8, 30, 24


@pytest.fixture(scope="module")
def sm():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM

    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32",
                                                      abs_pos="sinusoidal")
    tbase = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tbase.replace(abs_pos="sinusoidal")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, JM=JM, cfg=cfg,
                                 tcfg=tcfg, tbase=tbase, jp=jp, tp=tp)


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


def _positions_matter(got, base_logits):
    diff = np.abs(got - base_logits) - (TOL["atol"] + TOL["rtol"] * np.abs(got))
    assert diff.max() > 0, "the encodings do not change these logits"


@pytest.mark.parametrize("d,shape", [(64, (40,)), (100, (3, 17)), (1280, (9,))])
def test_sinusoidal_at_matches_jax(d, shape):
    """Positions up to 2048.  The frequencies are the same float32
    formula, but XLA's and PyTorch's float32 ``exp`` differ by one ulp on
    some of them (2^-24 relative), which a position of up to 2048 turns
    into up to 1.2e-4 of angle: hence atol 2e-4 here, and the frequencies
    themselves within one ulp."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.layers import embeddings as jemb

    pos = np.random.RandomState(d).randint(0, 2048, shape).astype(np.int32)
    want = np.asarray(jemb.sinusoidal_at(jnp.asarray(pos), d, jnp.float32))
    got = temb.sinusoidal_at(torch.from_numpy(pos), d, torch.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    one = np.ones((1,), np.int32)  # angle = frequency at position 1
    wf = np.arcsin(np.asarray(jemb.sinusoidal_at(jnp.asarray(one), d, jnp.float32))[0, :d // 2])
    gf = np.arcsin(temb.sinusoidal_at(torch.from_numpy(one), d, torch.float32)[0, :d // 2].numpy())
    np.testing.assert_allclose(gf, wf, rtol=2.5e-7, atol=1e-12)
    off = np.asarray(jemb.sinusoidal_pos(5, d, jnp.bfloat16, offset=7).astype(jnp.float32))
    got = temb.sinusoidal_pos(5, d, torch.bfloat16, offset=torch.tensor(7))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), off, rtol=1e-2, atol=1e-2)


def test_forward_and_loss_match_jax(sm):
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLMData

    m = sm
    b = SyntheticLMData(m.cfg, ShapeCfg("t", 40, 2, "train"), seed=1).batch_at(0)
    jb = {k: m.jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want, _ = m.JM.forward(m.jp, m.cfg, jb)
    wloss, _ = m.JM.loss_fn(m.jp, m.cfg, jb)
    got, _ = TM.forward(m.tp, m.tcfg, tb)
    loss, _ = TM.loss_fn(m.tp, m.tcfg, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(loss.item(), float(wloss), **TOL)
    _positions_matter(got.numpy(), TM.forward(m.tp, m.tbase, tb)[0].numpy())


def _states(m, tcfg):
    jnp = m.jnp
    js = m.JM.init_paged_state(m.jp, m.cfg, B, CACHE, page_size=P,
                               n_pages=NPAGES)
    ts = bridge.state_from_numpy(m.jax.tree.map(np.asarray, js), tcfg, "cpu")
    rows = np.stack([np.arange(CACHE // P) + b * (CACHE // P) for b in range(B)]
                    ).astype(np.int32)
    mask, plen = np.ones(B, bool), np.zeros(B, np.int32)
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
def test_ragged_step_matches_jax(sm, flash):
    """Three packs of prefill chunks beside decode tokens (positions to
    50): logits and every state leaf after each."""
    m = sm
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
    _positions_matter(tl.numpy(), bl.numpy())


def test_paged_step_matches_jax(sm):
    """Two (B, 24) prefill chunks, then three decode ticks with slot 2
    idle and slot 1 at other positions than slot 0: logits and every state
    leaf after each step."""
    m = sm
    jnp = m.jnp
    js, ts = _states(m, m.tcfg)
    _, tb = _states(m, m.tbase)
    rng = np.random.RandomState(3)
    steps = []
    for fill in (0, C):
        tok = rng.randint(0, m.cfg.vocab_size, (B, C)).astype(np.int32)
        q_pos = np.tile(fill + np.arange(C, dtype=np.int32), (B, 1))
        valid = np.zeros((B, C), bool)
        valid[0] = True
        valid[1, :C - 5 if fill else C] = True
        steps.append((tok, q_pos, valid, False))
    for t in range(3):
        tok = rng.randint(0, m.cfg.vocab_size, (B, 1)).astype(np.int32)
        q_pos = np.asarray([[2 * C + t], [2 * C - 5 + t], [0]], np.int32)
        valid = np.asarray([[True], [True], [False]])
        steps.append((tok, q_pos, valid, True))
    for tok, qp, va, with_logits in steps:
        arrays = (tok, qp, va)
        jl, js = m.JM.paged_step(m.jp, m.cfg, js, *(jnp.asarray(a) for a in arrays),
                                 with_logits=with_logits)
        tv = [torch.from_numpy(a) for a in arrays]
        tl, ts = TM.paged_step(m.tp, m.tcfg, ts, *tv, with_logits=with_logits)
        bl, tb = TM.paged_step(m.tp, m.tbase, tb, *tv, with_logits=with_logits)
        if with_logits:
            np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        _compare_states(m, js, ts)
    _positions_matter(tl.numpy()[:2], bl.numpy()[:2])


def test_lockstep_matches_jax(sm):
    """``prefill`` of 2 x 30 tokens, then four decode steps (each at the
    shared position "pos"): logits and every state leaf after each."""
    m = sm
    jnp = m.jnp
    tok = np.random.RandomState(4).randint(0, m.cfg.vocab_size,
                                           (2, 30)).astype(np.int32)
    js = m.JM.prefill(m.jp, m.cfg, m.JM.init_decode_state(m.jp, m.cfg, 2, CACHE),
                      jnp.asarray(tok))
    ts = TM.prefill(m.tp, m.tcfg, TM.init_decode_state(m.tp, m.tcfg, 2, CACHE),
                    torch.from_numpy(tok))
    tb = TM.prefill(m.tp, m.tbase, TM.init_decode_state(m.tp, m.tbase, 2, CACHE),
                    torch.from_numpy(tok))
    _compare_states(m, js, ts)
    nxt = tok[:, -1:]
    for _ in range(4):
        jl, js = m.JM.decode_step(m.jp, m.cfg, js, jnp.asarray(nxt))
        tl, ts = TM.decode_step(m.tp, m.tcfg, ts, torch.from_numpy(nxt))
        bl, tb = TM.decode_step(m.tp, m.tbase, tb, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    _positions_matter(tl.numpy(), bl.numpy())

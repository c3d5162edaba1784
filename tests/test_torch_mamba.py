"""The port's Mamba mixer, and jamba (Mamba and attention mixers, dense and
MoE FFNs), against the JAX package on the CPU, and on the card.

CPU, float32, the same inputs on both sides (seed-made numpy, JAX's own
initial weights through numpy):

- The layer (``repro_torch.models.layers.mamba``): ``mamba_fwd`` (chunks
  of 32, and an S that is no multiple of the chunk, which falls back to
  one chunk) and ``mamba_decode`` (output and both state leaves) against
  JAX at rtol = atol = 1e-5; ``mamba_decode`` rolled step by step against
  ``mamba_fwd`` at 1e-5; the gradients of every weight and the input
  through the chunked scan (rtol 1e-4, atol 1e-5 x the leaf's max |g|);
  ``init_mamba``'s constants as JAX's.
- jamba-smoke (two repeats of mamba+MLP, mamba+MoE, attention+MLP), seed-0
  weights bridged through ``repro_torch.bridge``: the layout and leaf
  dtypes, ``forward``, ``loss_fn`` with the real aux losses (rtol = atol =
  1e-4) and every gradient leaf (rtol 1e-4, atol 1e-5 x the leaf's max
  |g|), remat "none" and "full".
- Serving, the port's engine against JAX's engine on the same traffic: the
  ragged and two-phase steps' logits and every state leaf (f32 and int8
  pools, a slot re-admitted mid-run, 1e-4); the lock-step prefill, decode
  and ``ReferenceEngine``; ragged, two-phase and lock-step transcripts
  token-identical with merged stats equal; the engine's recurrent gates
  (prefix cache, speculation, preemption and the host tier off, as JAX
  reports them); a reset slot's Mamba state from the template; rollback
  and an all-invalid pack leave the state bit-identical; the steps
  dispatch no host-synchronising op; the launchers serve and train jamba.

``gpu`` tests (skipped where there is no card): ``mamba_fwd`` and
``mamba_decode`` on CUDA against the CPU, and three training steps of
jamba-smoke on the card against the CPU.  JAX is imported lazily
(fixtures), so that ``pytest -m gpu`` runs where there is no JAX.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import assert_stats_equal  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.analysis.contracts import HostSyncRecorder  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import MambaCfg  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import mamba as TMa  # noqa: E402
from repro_torch.serve import serve_step as SS  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402
from test_torch_moe import _card, _train_losses  # noqa: E402

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba-1.5-large-398b"
CACHE = 64
B, P, NPAGES, C = 3, 8, 24, 8  # slots, page, pool pages, prefill chunk
KW = dict(batch_size=2, cache_len=CACHE, page_size=8, prefill_chunk=C,
          token_budget=24)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs.base import MambaCfg as JCfg
    from repro.models.layers import mamba as JMa

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, JMa=JMa, JCfg=JCfg, key=jax.random.PRNGKey(0),
        fwd=jax.jit(JMa.mamba_fwd, static_argnums=1, static_argnames="chunk"),
        decode=jax.jit(JMa.mamba_decode, static_argnums=1))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=LAYER_TOL, err=""):
    if isinstance(want, dict):
        assert set(got) == set(want), err
        for k in want:
            _close(got[k], want[k], tol, f"{err}.{k}")
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=err, **tol)


def _mixer(jx, d=32, d_state=4):
    """(port cfg, JAX cfg, numpy weights from JAX's ``init_mamba``)."""
    cfg = MambaCfg(d_state=d_state, d_conv=4, expand=2)
    jcfg = jx.JCfg(d_state=d_state, d_conv=4, expand=2)
    return cfg, jcfg, jx.jax.tree.map(np.asarray, jx.JMa.init_mamba(jx.key, d,
                                                                    jcfg))


# ---------------------------------------------------------------------------
# The layer against JAX


def test_init_mamba_matches_jax_scheme(jx):
    """The port's own init: JAX's leaves and shapes, a step bias of -4.6,
    ``A_log = log(1..N)`` per channel, a unit skip and a zero conv bias;
    each leaf drawn when called."""
    cfg, _, p = _mixer(jx)
    tp = TMa.init_mamba(torch.Generator().manual_seed(0), 32, cfg, 2)
    assert set(tp) == set(p)
    got = {k: f() for k, f in tp.items()}
    for k in p:
        assert tuple(got[k].shape) == (2,) + p[k].shape, k
        if k in ("dt_b", "A_log", "ssm_D", "conv_b"):
            np.testing.assert_array_equal(got[k][1].numpy(), p[k], err_msg=k)


@pytest.mark.parametrize("S,chunk", [(96, 32), (70, 64)],
                         ids=["chunk32", "single-chunk-fallback"])
def test_mamba_fwd_matches_jax(jx, S, chunk):
    """Three chunks of 32, and at S 70 (no multiple of 64) the single
    chunk both packages fall back to."""
    cfg, jcfg, p = _mixer(jx)
    x = _x((2, S, 32))
    want = jx.fwd(p, jcfg, jx.jnp.asarray(x), chunk=chunk)
    got = TMa.mamba_fwd(_t(p), cfg, torch.from_numpy(x), chunk=chunk)
    _close(got, want)


def test_mamba_decode_matches_jax(jx):
    """Three decode steps from a nonzero state: output and both state
    leaves after each."""
    cfg, jcfg, p = _mixer(jx)
    state = {"h": _x((2, 64, 4), 2), "conv": _x((2, 3, 64), 3)}
    js, ts = dict(state), _t(state)
    for t in range(3):
        x_t = _x((2, 1, 32), 10 + t)
        jy, js = jx.decode(p, jcfg, jx.jnp.asarray(x_t), js)
        ty, ts = TMa.mamba_decode(_t(p), cfg, torch.from_numpy(x_t), ts)
        _close(ty, jy)
        _close(ts, {k: np.asarray(v) for k, v in js.items()})


def test_mamba_decode_rolled_equals_fwd(jx):
    """tests/test_layers.py's invariant in the port: the single-step
    decode rolled over a sequence from the fresh state equals the training
    forward, and its final state equals JAX's."""
    cfg, jcfg, p = _mixer(jx)
    x = _x((2, 20, 32))
    tp = _t(p)
    want = TMa.mamba_fwd(tp, cfg, torch.from_numpy(x))
    state = {k: v[0] for k, v in TMa.init_mamba_state(cfg, 32, 2,
                                                      torch.float32).items()}
    ys = []
    for t in range(20):
        y, state = TMa.mamba_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]),
                                    state)
        ys.append(y)
    _close(torch.cat(ys, dim=1), want.numpy())
    js = {k: jx.jnp.asarray(v.numpy()) for k, v in TMa.init_mamba_state(
        cfg, 32, 2, torch.float32).items()}
    js = {k: v[0] for k, v in js.items()}
    for t in range(20):
        _, js = jx.decode(p, jcfg, jx.jnp.asarray(x[:, t:t + 1]), js)
    _close(state, {k: np.asarray(v) for k, v in js.items()})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def test_mamba_fwd_chunked_gradients_match_jax(jx):
    """Gradients through the chunked scan (three chunks of 32, each
    checkpointed on both sides), of every weight and the input."""
    jax, jnp = jx.jax, jx.jnp
    cfg, jcfg, p = _mixer(jx)
    x, w = _x((2, 96, 32)), _x((2, 96, 32), 5)

    def jloss(p, x):
        return jnp.sum(jx.JMa.mamba_fwd(p, jcfg, x, chunk=32) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(TMa.mamba_fwd(tp, cfg, tx, chunk=32) * torch.from_numpy(w))
    loss.backward()
    pairs = [(tp[k].grad.numpy(), np.asarray(v), k) for k, v in want[0].items()]
    pairs.append((tx.grad.numpy(), np.asarray(want[1]), "x"))
    for got, ref, name in pairs:
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The model


@pytest.fixture(scope="module")
def jamba():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro.serve.reference import ReferenceEngine as JaxReference

    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    tcfg = tget(ARCH, smoke=True).replace(dtype="float32")
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    jit = lambda f, *names: jax.jit(f, static_argnums=1,  # noqa: E731
                                    static_argnames=names)
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, JM=JM, Engine=JaxEngine,
        Reference=JaxReference, cfg=cfg, tcfg=tcfg, jp=jp,
        tp=bridge.params_from_numpy(np_params, tcfg, "cpu"),
        np_params=np_params,
        ragged_step=jit(JM.ragged_step, "width", "flash_decode"),
        paged_step=jit(JM.paged_step, "with_logits", "flash_decode"),
        prefill=jit(JM.prefill), decode_step=jit(JM.decode_step))


def test_jamba_passes_the_slice_check_and_lays_out_like_jax(jamba):
    """``init_params`` builds jamba-smoke with JAX's leaves and shapes;
    the serving layout keeps Mamba's ``A_log``, ``dt_b``, ``ssm_D`` and
    the MoE router float32 beside bf16 matrices."""
    want = {k: v.shape for k, v in _flat(jamba.np_params).items()}
    cfg = tget(ARCH, smoke=True).replace(dtype="bfloat16")
    TM.check_supported(cfg)
    serving = TM.init_params(cfg, device="cpu")
    got = {k: v.shape for k, v in
           _flat(bridge.params_to_numpy(serving, cfg)).items()}
    assert got == want
    f32 = set(TT.FLOAT32_LEAVES) | {"scale"}
    assert {"A_log", "dt_b", "ssm_D", "router"} <= f32
    for name, p in serving.named_parameters():
        want_dt = torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16
        assert p.dtype == want_dt, name


@pytest.fixture(scope="module")
def jax_grads(jamba):
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLMData

    m = jamba
    batch = SyntheticLMData(m.cfg, ShapeCfg("t", 48, 2, "train"),
                            seed=1).batch_at(0)
    jb = {k: m.jnp.asarray(v) for k, v in batch.items()}
    logits, _ = m.jax.jit(m.JM.forward, static_argnums=1)(m.jp, m.cfg, jb)
    (loss, mets), grads = m.jax.jit(m.jax.value_and_grad(
        lambda p: m.JM.loss_fn(p, m.cfg, jb), has_aux=True))(m.jp)
    return (batch, np.asarray(logits), float(loss),
            {k: float(v) for k, v in mets.items()},
            m.jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_loss_and_grads_match_jax(jamba, jax_grads, remat):
    """Training at 48 positions (Mamba's chunks of 64 fall back to one):
    logits, loss with the MoE layers' aux losses, and every gradient leaf
    against ``jax.value_and_grad``."""
    m = jamba
    batch, want_logits, want_loss, want_mets, want_grads = jax_grads
    tcfg = m.tcfg.replace(remat=remat)
    params = bridge.params_from_numpy(m.np_params, tcfg, "cpu",
                                      for_training=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = TM.forward(params, tcfg, tb)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    loss, mets = TM.loss_fn(params, tcfg, tb)
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(mets[k].item(), want_mets[k], rtol=1e-5,
                                   err_msg=k)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    got = _flat(bridge.grads_to_numpy(params, grads, tcfg))
    want = _flat(want_grads)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-4,
            atol=1e-5 * float(np.abs(want[name]).max()), err_msg=name)


# ---------------------------------------------------------------------------
# The serving steps


def _compare_states(m, jstate, tstate):
    want = _flat(m.jax.tree.map(np.asarray, jstate))
    got = _flat(bridge.state_to_numpy(tstate, m.tcfg))
    assert got.keys() == want.keys()
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _rows():
    rows = np.arange(B * (CACHE // P), dtype=np.int32).reshape(B, CACHE // P)
    return np.where(rows < NPAGES, rows, NPAGES).astype(np.int32)


def _fresh(m, kv_dtype=None):
    """JAX's and the port's fresh serving states and the port's reset
    template, every slot admitted."""
    js = m.JM.init_paged_state(m.jp, m.cfg, B, CACHE, page_size=P,
                               n_pages=NPAGES, kv_dtype=kv_dtype)
    ts = bridge.state_from_numpy(m.jax.tree.map(np.asarray, js), m.tcfg, "cpu")
    tmpl = TM.reset_template(ts)
    js = _reset(m, js, js, ts, tmpl, np.ones(B, bool))
    return js, ts, tmpl


def _reset(m, js, j0, ts, tmpl, mask):
    plen = np.zeros(B, np.int32)
    js = m.JM.reset_paged_slots(m.cfg, js, j0, *(m.jnp.asarray(a) for a in
                                                 (mask, _rows(), plen)))
    TM.reset_paged_slots(m.tcfg, ts, tmpl, *(torch.from_numpy(a) for a in
                                              (mask, _rows(), plen)))
    return js


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
def test_ragged_step_matches_jax(jamba, kv_dtype):
    """Packs of prefill runs (up to the roll's width, C + 1) beside decode
    tokens; after the second pack slot 1 is re-admitted and its Mamba
    state comes back from the template.  Logits and every state leaf after
    each pack."""
    m = jamba
    js, ts, tmpl = _fresh(m, kv_dtype)
    j0 = m.JM.init_paged_state(m.jp, m.cfg, B, CACHE, page_size=P,
                               n_pages=NPAGES, kv_dtype=kv_dtype)
    rng = np.random.RandomState(7)
    cursor = [0] * B
    plan = [[(0, 9), (1, 5)], [(0, 1), (1, 9), (2, 7)], None,
            [(2, 1), (0, 1), (1, 9)], [(0, 1), (1, 1), (2, 1)]]
    for chunks in plan:
        if chunks is None:
            js = _reset(m, js, j0, ts, tmpl, np.asarray([False, True, False]))
            cursor[1] = 0
            _compare_states(m, js, ts)
            assert float(ts["layers"][0][0]["h"][:, 1].abs().max()) == 0.0
            continue
        vecs = _pack(rng, cursor, chunks, 32, m.cfg.vocab_size)
        jl, js = m.ragged_step(m.jp, m.cfg, js,
                               *(m.jnp.asarray(a) for a in vecs), width=C + 1)
        tl, ts = TM.ragged_step(m.tp, m.tcfg, ts,
                                *(torch.from_numpy(a) for a in vecs),
                                width=C + 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)


def test_paged_step_matches_jax(jamba):
    """The two-phase path: a (B, C) prefill chunk (slot 1 an invalid tail,
    slot 2 idle: their Mamba states advance only where valid), then decode
    ticks.  Logits and every state leaf."""
    m = jamba
    js, ts, _ = _fresh(m)
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


def _leaves(state):
    return {k: v.clone() for k, v in _flat(state).items()}


def test_reset_template_and_rollback(jamba):
    """The reset template holds a Mamba layer's fresh values (h and conv
    0), exactly the fresh state's; ``rollback_paged_slots`` leaves every
    Mamba leaf bit-identical, as JAX's passes them through."""
    m = jamba
    _, ts, tmpl = _fresh(m)
    assert tmpl["layers"][0][0] == {"h": 0.0, "conv": 0.0}
    assert tmpl["layers"][0][2] == {}
    vecs = _pack(np.random.RandomState(3), [0] * B, [(0, 6), (2, 4)], 32,
                 m.cfg.vocab_size)
    TM.ragged_step(m.tp, m.tcfg, ts, *(torch.from_numpy(a) for a in vecs),
                   width=C + 1)
    before = _leaves(ts)
    TM.rollback_paged_slots(m.tcfg, ts, torch.tensor([True, False, True]),
                            torch.tensor([2, 0, 1], dtype=torch.int32))
    after = _leaves(ts)
    for k in before:
        if k.rsplit(".", 1)[-1] in ("h", "conv"):
            assert torch.equal(before[k], after[k]), k


@pytest.mark.parametrize("kind", ["ragged", "chunk", "decode"])
def test_steps_dispatch_no_host_sync_and_idle_packs_keep_the_state(jamba,
                                                                   kind):
    """Each serving step of jamba (Mamba rolls, the MoE dispatch, paged
    attention) makes the host wait for nothing, and the capture's
    all-invalid warm-up pack leaves every state leaf bit-identical."""
    m = jamba
    _, ts, _ = _fresh(m)
    steps = {"ragged": SS.capture_ragged_step(m.tcfg, m.tp, ts, T=24, B=B,
                                              width=C + 1),
             "chunk": SS.capture_paged_step(m.tcfg, m.tp, ts, B=B, C=C,
                                            with_logits=False),
             "decode": SS.capture_paged_step(m.tcfg, m.tp, ts, B=B, C=1,
                                             with_logits=True)}
    steps["ragged"].run(*_pack(np.random.RandomState(2), [0] * B,
                               [(0, 5), (1, 3)], 24, m.cfg.vocab_size))
    width = {"chunk": C, "decode": 1}.get(kind)
    args = (_pack(np.random.RandomState(4), [5, 3, 0], [(0, 1), (2, 4)], 24,
                  m.cfg.vocab_size) if kind == "ragged" else
            (np.zeros((B, width), np.int32),
             np.tile(np.arange(width, dtype=np.int32) + 5, (B, 1)),
             np.ones((B, width), bool)))
    with HostSyncRecorder() as rec:
        steps[kind].run(*args)
    assert rec.bad == []
    before = _leaves(ts)
    idle = (SS.idle_ragged_pack(24, B, C + 1) if kind == "ragged"
            else SS.idle_paged_pack(B, width))
    steps[kind].run(*idle)
    after = _leaves(ts)
    for k in before:
        assert torch.equal(before[k], after[k]), k


def test_lockstep_prefill_and_decode_match_jax(jamba):
    """``prefill`` of a 2 x 13 prompt batch (Mamba's outputs from the
    training forward, its state from the decode rolled over the prompt),
    then four ``decode_step``s: logits and every state leaf after each."""
    m = jamba
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


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n) for n in lens]


def test_reference_engine_matches_jax(jamba):
    """The lock-step ``ReferenceEngine`` on an equal-length wave over 2
    slots, then a third request in a reused slot: every tick's logits and
    the transcripts equal JAX's."""
    m = jamba
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
# Served transcripts and the engine's gates


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two-phase"])
def test_transcripts_match_jax(jamba, ragged, kv_dtype):
    """Mixed lengths over 2 slots (a slot reused, its Mamba state reset
    from the template) through a budget of 24 and chunks of 8: the JAX
    engine's transcripts, merged stats equal, one trace on the ragged
    path."""
    m = jamba
    prompts = _prompts(m.cfg.vocab_size, [5, 19, 11, 26], seed=21)
    kw = {**KW, "ragged": ragged, "kv_dtype": kv_dtype}
    out = []
    for eng in (m.Engine(m.jp, m.cfg, **kw),
                ServeEngine(m.tp, m.tcfg, device="cpu", **kw)):
        uids = [eng.submit(p, max_tokens=4) for p in prompts]
        res = eng.run()
        out.append(([res[u] for u in uids], eng))
    (want, je), (got, te) = out
    assert got == want
    assert_stats_equal(te, je.stats)
    assert te.stats["traces"] == (1 if ragged else 0)
    assert te.stats["admissions"] == 4


GATE_KW = [dict(), dict(spec_k=2), dict(host_pages=16),
           dict(ragged=False, preempt=True)]


@pytest.mark.parametrize("kw", GATE_KW, ids=lambda kw: ",".join(kw) or "default")
def test_engine_gates_match_jax(jamba, kw):
    """A hybrid: prefix cache, speculation, preemption and the host tier
    are off, silently, as in JAX; every gate attribute equals JAX's."""
    m = jamba
    kw = {**KW, **kw}
    je = m.Engine(m.jp, m.cfg, **kw)
    te = ServeEngine(m.tp, m.tcfg, device="cpu", **kw)
    for name in ("prefix_cache", "_spec_k", "preempt", "host_pages", "n_pages",
                 "_has_paged"):
        assert getattr(te, name) == getattr(je, name), name
    assert te._has_paged and not te.prefix_cache and te._spec_k == 0
    assert not te.preempt and te.host_pages == 0
    assert_stats_equal(te, je.stats)


def test_launchers_serve_and_train_jamba(capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    assert tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                        "--batch-size", "2", "--prompt-len", "10",
                        "--max-tokens", "3"]) == 0
    assert capsys.readouterr().out.count("req ") == 3
    assert ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "2"]) == 0
    assert "jamba-smoke: loss" in capsys.readouterr().out


def test_mamba_state_leaves_are_per_slot():
    """Admission restores Mamba's state from the template; neither leaf is
    a shared pool leaf that survives slot churn."""
    assert "mamba" in TT.RECURRENT_MIXERS
    for name in ("h", "conv"):
        assert TT.FRESH_VALUES[name] == 0.0 and name not in TT.POOL_LEAVES


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.gpu
def test_cuda_mamba_matches_cpu():
    """``mamba_fwd`` (two chunks) and three ``mamba_decode`` steps on CUDA
    against the same functions on the CPU, float32 (TF32 off)."""
    _card()
    cfg = MambaCfg(d_state=4, d_conv=4, expand=2)
    p = {k: f()[0] for k, f in TMa.init_mamba(
        torch.Generator().manual_seed(0), 64, cfg, 1).items()}
    pc = {k: v.cuda() for k, v in p.items()}
    x = torch.randn(2, 128, 64, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(TMa.mamba_fwd(pc, cfg, x.cuda()).cpu(),
                               TMa.mamba_fwd(p, cfg, x), rtol=1e-4, atol=1e-5)
    s = {k: v[0] for k, v in TMa.init_mamba_state(cfg, 64, 2,
                                                  torch.float32).items()}
    sc = {k: v.cuda() for k, v in s.items()}
    for t in range(3):
        y, s = TMa.mamba_decode(p, cfg, x[:, t:t + 1], s)
        yc, sc = TMa.mamba_decode(pc, cfg, x[:, t:t + 1].cuda(), sc)
        torch.testing.assert_close(yc.cpu(), y, rtol=1e-4, atol=1e-5)
        for k in s:
            torch.testing.assert_close(sc[k].cpu(), s[k], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_cuda_jamba_training_matches_cpu():
    """Three training steps of jamba-smoke (float32) on the card: finite
    losses equal to the CPU's at 1e-4."""
    _card()
    cfg = tget(ARCH, smoke=True).replace(dtype="float32")
    want = _train_losses(cfg, "cpu")
    got = _train_losses(cfg, "cuda")
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

"""The port's xLSTM mixers against the JAX package, on the CPU.

- Layers (``repro_torch.models.layers.conv`` and ``.xlstm``) on seed-made
  numpy inputs and JAX's own initial weights, float32, rtol 1e-4, atol
  1e-5: ``causal_depthwise_conv``, ``conv_step``, ``mlstm_fwd`` (chunk 16,
  and an S that is no multiple of the chunk, which falls back to one
  chunk), ``mlstm_fwd_seq``, ``mlstm_decode``, ``slstm_fwd`` (chunk 8) and
  ``slstm_decode``, outputs and every state leaf; and the ports of
  tests/test_layers.py's recurrent-mixer invariants (chunkwise against
  sequential, decode against forward, the conv step against the conv).
- The model: xlstm-350m's smoke config (two stacked repeats of an mLSTM
  and an sLSTM block with a gated-gelu FFN), the same seed-0 weights on
  both sides through ``repro_torch.bridge``: ``init_params`` lays it out
  like JAX's pytree, the serving layout keeps what JAX computes in float32
  in float32, and ``forward``, ``loss_fn`` and every gradient leaf match
  JAX (logits and loss rtol = atol = 1e-4; gradients rtol 1e-4, atol 1e-4
  x the leaf's max |g|), with remat "none" and "full".  The gradients'
  atol is 1e-4 of the leaf's scale, not the attention models' 1e-5: the
  gate biases' gradients sum terms that cancel through the stabilizer m,
  and JAX's own float32 gradient of ``bi`` moves by 1.3e-5 of its max |g|
  between remat "none" and "full".

JAX is imported lazily (fixtures), so that ``pytest -m gpu`` collects
this file where there is no JAX.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import XLSTMCfg  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import conv as TC  # noqa: E402
from repro_torch.models.layers import xlstm as TX  # noqa: E402

LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs.base import XLSTMCfg as JCfg
    from repro.models.layers import conv as JC
    from repro.models.layers import xlstm as JX

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, JX=JX, JC=JC,
                                 JCfg=JCfg, key=jax.random.PRNGKey(0))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(tree):
    """A numpy (nested) dict as torch tensors."""
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


def _mixer(jx, kind, d, nh):
    """(port cfg, JAX cfg, numpy weights) of one mixer, JAX's init."""
    proj = 2.0 if kind == "mlstm" else 1.0
    cfg = XLSTMCfg(kind=kind, num_heads=nh, proj_factor=proj)
    jcfg = jx.JCfg(kind=kind, num_heads=nh, proj_factor=proj)
    init = jx.JX.init_mlstm if kind == "mlstm" else jx.JX.init_slstm
    return cfg, jcfg, _np(init(jx.key, d, jcfg))


# ---------------------------------------------------------------------------
# Layers against JAX


def test_causal_depthwise_conv_matches_jax(jx):
    w, b, x = _x((4, 8), 0), _x((8,), 1), _x((2, 12, 8), 2)
    want = jx.JC.causal_depthwise_conv(*(jx.jnp.asarray(a) for a in (x, w, b)))
    got = TC.causal_depthwise_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got, want)


def test_conv_step_matches_jax(jx):
    w, b = _x((4, 8), 0), _x((8,), 1)
    state, x_t = _x((2, 3, 8), 2), _x((2, 8), 3)
    want_out, want_state = jx.JC.conv_step(
        *(jx.jnp.asarray(a) for a in (x_t, state, w, b)))
    got_out, got_state = TC.conv_step(
        *(torch.from_numpy(a) for a in (x_t, state, w, b)))
    _close(got_out, want_out)
    _close(got_state, want_state)


@pytest.mark.parametrize("S,chunk", [(96, 16), (50, 16)],
                         ids=["chunk16", "single-chunk-fallback"])
def test_mlstm_fwd_matches_jax(jx, S, chunk):
    """The chunkwise form, 6 chunks of 16, and at S 50 (no multiple of 16)
    the single chunk both packages fall back to."""
    cfg, jcfg, p = _mixer(jx, "mlstm", 64, 4)
    x = _x((2, S, 64))
    want = jx.JX.mlstm_fwd(jx.jax.tree.map(jx.jnp.asarray, p), jcfg,
                           jx.jnp.asarray(x), chunk=chunk)
    got = TX.mlstm_fwd(_t(p), cfg, torch.from_numpy(x), chunk=chunk)
    _close(got, want)


def test_mlstm_fwd_seq_matches_jax(jx):
    cfg, jcfg, p = _mixer(jx, "mlstm", 32, 2)
    x = _x((2, 20, 32))
    want = jx.JX.mlstm_fwd_seq(jx.jax.tree.map(jx.jnp.asarray, p), jcfg,
                               jx.jnp.asarray(x))
    got = TX.mlstm_fwd_seq(_t(p), cfg, torch.from_numpy(x))
    _close(got, want)


def _decode_both(jx, kind, d, nh, steps):
    """``steps`` decode steps of one mixer on both sides from the fresh
    state: each step's outputs and the final state."""
    cfg, jcfg, p = _mixer(jx, kind, d, nh)
    jdec = jx.JX.mlstm_decode if kind == "mlstm" else jx.JX.slstm_decode
    jinit = (jx.JX.init_mlstm_state if kind == "mlstm"
             else jx.JX.init_slstm_state)
    tdec = TX.mlstm_decode if kind == "mlstm" else TX.slstm_decode
    tinit = TX.init_mlstm_state if kind == "mlstm" else TX.init_slstm_state
    jp = jx.jax.tree.map(jx.jnp.asarray, p)
    js = jinit(jcfg, d, 2, jx.jnp.float32)
    ts = {k: v[0] for k, v in tinit(cfg, d, 2, torch.float32).items()}
    x = _x((2, steps, d))
    for t in range(steps):
        jy, js = jdec(jp, jcfg, jx.jnp.asarray(x[:, t:t + 1]), js)
        ty, ts = tdec(_t(p), cfg, torch.from_numpy(x[:, t:t + 1]), ts)
        _close(ty, jy, err=f"step {t}")
    return ts, js


def test_mlstm_decode_matches_jax(jx):
    """Twelve decode steps: every step's output and the final C, n, m and
    conv state."""
    ts, js = _decode_both(jx, "mlstm", 32, 2, 12)
    _close(ts, _np(js))


def test_slstm_fwd_matches_jax(jx):
    cfg, jcfg, p = _mixer(jx, "slstm", 32, 2)
    x = _x((2, 24, 32))
    want = jx.JX.slstm_fwd(jx.jax.tree.map(jx.jnp.asarray, p), jcfg,
                           jx.jnp.asarray(x), chunk=8)
    got = TX.slstm_fwd(_t(p), cfg, torch.from_numpy(x), chunk=8)
    _close(got, want)


def test_slstm_decode_matches_jax(jx):
    """Twelve decode steps from the fresh state (whose stabilizer starts
    at -1e30): every step's output and the final h, c, n, m."""
    ts, js = _decode_both(jx, "slstm", 32, 2, 12)
    _close(ts, _np(js))


def test_fresh_states_match_jax(jx):
    """Leaf names, shapes, dtypes and values of the fresh states (the
    port's with its leading layer axis of 1)."""
    for kind in ("mlstm", "slstm"):
        cfg, jcfg, _ = _mixer(jx, kind, 32, 2)
        jinit = (jx.JX.init_mlstm_state if kind == "mlstm"
                 else jx.JX.init_slstm_state)
        tinit = TX.init_mlstm_state if kind == "mlstm" else TX.init_slstm_state
        want = _np(jinit(jcfg, 32, 3, jx.jnp.bfloat16))
        got = tinit(cfg, 32, 3, torch.bfloat16)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k][0]
            assert tuple(g.shape) == w.shape, k
            assert str(g.dtype).split(".")[-1] == w.dtype.name, k
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32), err_msg=k)


# ---------------------------------------------------------------------------
# Ports of tests/test_layers.py's recurrent-mixer invariants


def _port_weights(kind, d, nh):
    cfg = XLSTMCfg(kind=kind, num_heads=nh,
                   proj_factor=2.0 if kind == "mlstm" else 1.0)
    init = TX.init_mlstm if kind == "mlstm" else TX.init_slstm
    p = init(torch.Generator().manual_seed(0), d, cfg, 1)
    view = lambda t: ({k: view(v) for k, v in t.items()}  # noqa: E731
                      if isinstance(t, dict) else t[0])
    return cfg, view(p)


def test_mlstm_chunkwise_matches_sequential():
    cfg, p = _port_weights("mlstm", 64, 4)
    x = torch.from_numpy(_x((2, 96, 64)))
    _close(TX.mlstm_fwd(p, cfg, x, chunk=16), TX.mlstm_fwd_seq(p, cfg, x))


def _decode_last(cfg, p, x, kind):
    dec = TX.mlstm_decode if kind == "mlstm" else TX.slstm_decode
    init = TX.init_mlstm_state if kind == "mlstm" else TX.init_slstm_state
    st = {k: v[0] for k, v in init(cfg, x.shape[-1], x.shape[0],
                                   torch.float32).items()}
    for t in range(x.shape[1]):
        y_t, st = dec(p, cfg, x[:, t:t + 1], st)
    return y_t[:, 0]


def test_mlstm_decode_matches_fwd():
    cfg, p = _port_weights("mlstm", 32, 2)
    x = torch.from_numpy(_x((2, 20, 32)))
    _close(_decode_last(cfg, p, x, "mlstm"), TX.mlstm_fwd_seq(p, cfg, x)[:, -1])


def test_slstm_decode_matches_fwd():
    cfg, p = _port_weights("slstm", 32, 2)
    x = torch.from_numpy(_x((2, 24, 32)))
    _close(_decode_last(cfg, p, x, "slstm"),
           TX.slstm_fwd(p, cfg, x, chunk=8)[:, -1])


def test_causal_conv_step_consistency():
    w, b = torch.from_numpy(_x((4, 8), 0)), torch.from_numpy(_x((8,), 1))
    x = torch.from_numpy(_x((2, 12, 8), 2))
    y = TC.causal_depthwise_conv(x, w, b)
    state = torch.zeros(2, 3, 8)
    for t in range(12):
        y_t, state = TC.conv_step(x[:, t], state, w, b)
        _close(y_t, y[:, t].numpy(), err=f"step {t}")


# ---------------------------------------------------------------------------
# The model


@pytest.fixture(scope="module")
def xl():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM

    cfg = get_config("xlstm-350m", smoke=True).replace(dtype="float32")
    tcfg = tget("xlstm-350m", smoke=True).replace(dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    tp = bridge.params_from_numpy(np_params, tcfg, "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, JM=JM, cfg=cfg,
                                 tcfg=tcfg, jp=jp, tp=tp, np_params=np_params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def test_init_params_builds_xlstm_like_jax(xl):
    """The config that raised before this slice: random weights on the
    CPU, laid out like JAX's pytree (``mixer.out_norm.scale`` nested), and
    the bridged weights back out unchanged."""
    want = {k: v.shape for k, v in _flat(xl.np_params).items()}
    cfg = tget("xlstm-350m", smoke=True)
    for params in (TM.init_params(cfg, device="cpu"), xl.tp):
        got = {k: v.shape for k, v in
               _flat(bridge.params_to_numpy(params, cfg)).items()}
        assert got == want
    back = _flat(bridge.params_to_numpy(xl.tp, xl.tcfg))
    for k, v in _flat(xl.np_params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_serving_layout_keeps_jax_float32_leaves():
    """bf16 activations: the serving layout stores matrices in bf16 but the
    leaves JAX computes in float32 — norm scales, the head norm's scale and
    the gates' weights and biases — in float32; the training layout keeps
    every leaf float32."""
    cfg = tget("xlstm-350m", smoke=True)
    assert cfg.dtype == "bfloat16"
    serving = TM.init_params(cfg, device="cpu")
    training = TM.init_params(cfg, device="cpu", for_training=True)
    f32 = set(TX.FLOAT32_LEAVES) | {"scale"}
    for name, p in serving.named_parameters():
        leaf = name.split(".")[-1]
        want = torch.float32 if leaf in f32 else torch.bfloat16
        assert p.dtype == want, name
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in training.parameters())
    blk = serving.stages[0][1].mixer  # sLSTM: forget-gate bias 3.0
    d = cfg.d_model
    assert bool((blk["b_ifzo"][:, d:2 * d] == 3.0).all())
    assert bool((blk["b_ifzo"][:, :d] == 0).all())


def test_check_block_admits_only_the_xlstm_mixers():
    """xlstm-350m passes the slice check, and since the MoE FFN and the
    Mamba mixer were ported so do jamba (mamba mixers, MoE), llama4 and
    arctic (MoE); the recurrent mixers are the xLSTM pair and Mamba."""
    for arch in ("xlstm-350m", "jamba-1.5-large-398b",
                 "llama4-maverick-400b-a17b", "arctic-480b"):
        TM.check_supported(tget(arch, smoke=True))
        TM.check_supported(tget(arch))
    assert TT.RECURRENT_MIXERS == ("mlstm", "slstm", "mamba")


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_loss_and_grads_match_jax(xl, remat):
    """Training at 48 positions (chunks of 128 fall back to one): logits,
    loss and every gradient leaf against ``jax.value_and_grad``."""
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLMData

    jax, jnp = xl.jax, xl.jnp
    batch = SyntheticLMData(xl.cfg, ShapeCfg("t", 48, 2, "train"),
                            seed=1).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits, _ = xl.JM.forward(xl.jp, xl.cfg, jb)
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: xl.JM.loss_fn(p, xl.cfg, jb), has_aux=True)(xl.jp)
    tcfg = xl.tcfg.replace(remat=remat)
    params = bridge.params_from_numpy(xl.np_params, tcfg, "cpu",
                                      for_training=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, _ = TM.forward(params, tcfg, tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    loss, _ = TM.loss_fn(params, tcfg, tb)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    got, want = (_flat(bridge.grads_to_numpy(params, grads, tcfg)),
                 _flat(jax.tree.map(np.asarray, want_grads)))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-4,
            atol=1e-4 * float(np.abs(want[name]).max()), err_msg=name)


def test_mlstm_fwd_chunked_gradients_match_jax(jx):
    """Gradients through the chunkwise form proper (6 chunks of 16, the
    state carried across chunks), of every weight and the input, at the
    model test's gradient tolerance (rtol 1e-4, atol 1e-4 x max |g|)."""
    jax, jnp = jx.jax, jx.jnp
    cfg, jcfg, p = _mixer(jx, "mlstm", 32, 2)
    x = _x((2, 96, 32))
    w = _x((2, 96, 32), 5)

    def jloss(p, x):
        return jnp.sum(jx.JX.mlstm_fwd(p, jcfg, x, chunk=16) * w)

    want = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                           jnp.asarray(x))
    tp = _t(p)
    leaves = [v for v in _flat(tp).values()]
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(TX.mlstm_fwd(tp, cfg, tx, chunk=16) * torch.from_numpy(w))
    loss.backward()
    got = _flat({k: v.grad.numpy() for k, v in _flat(tp).items()})
    for k, v in _flat(_np(want[0])).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(v).max()), err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[1]), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want[1]).max()))

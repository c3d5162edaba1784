"""The audio and vision frontends against the JAX package, on the CPU.

hubert-xlarge (audio frames through ``frontend_proj``, bidirectional
attention at head_dim 16 in the smoke config, sinusoidal positions, an
untied head and no embedding) and llama-3.2-vision-11b (image features
through ``frontend_proj`` into cross-attention layers, a scanned stage of
2 repeats of (self, cross)) smoke configs in float32, the same seed-0
weights on both sides through ``repro_torch.bridge``, the same batches:

- ``forward`` logits and ``loss_fn`` at rtol = atol = 1e-4; every gradient
  leaf, ``frontend.frontend_proj`` included, at rtol 1e-4 and atol 1e-5 x
  the leaf's max |g|, with remat "none" and "full";
- three ``TrainLoop`` steps with one and two microbatches: JAX's loop from
  its seed-0 state, and the port's loop resuming from that state, written
  by JAX's ``save_checkpoint`` at step 0: losses at 1e-4;
- ``SyntheticLMData.batch_at`` equal to JAX's arrays;
- bidirectional attention at hubert's head_dim 80 and cross-attention,
  each on the full and the chunked softmax, at rtol = atol = 1e-5;
- the vision lock-step path (``init_decode_state`` over image features,
  ``prefill``, ``decode_step``) against JAX's: logits and every state leaf
  at 1e-4, with the stage scanned (per-repeat cross caches) and unscanned;
  other image features change the logits by more than the tolerance;
- the paged serving state and the engines raise for frontend configs, as
  JAX's ``init_paged_state`` does.

JAX is imported lazily (a fixture).
"""
import dataclasses
import shutil
import tempfile
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeCfg as TShape  # noqa: E402
from repro_torch.configs import Stage as TStage  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData as TData  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import attention as TA  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402
from repro_torch.train.loop import TrainLoop  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["hubert-xlarge", "llama-3.2-vision-11b"]
SEQ, BATCH = 48, 2


def _load(arch, stage_repeats=None):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.configs.base import ShapeCfg, Stage
    from repro.data.pipeline import SyntheticLMData
    from repro.models import model as JM

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    tcfg = tget(arch, smoke=True).replace(dtype="float32")
    if stage_repeats is not None:
        cfg = cfg.replace(stages=(Stage(cfg.stages[0].pattern, stage_repeats),))
        tcfg = tcfg.replace(stages=(TStage(tcfg.stages[0].pattern,
                                           stage_repeats),))
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, JM=JM, JShape=ShapeCfg, JData=SyntheticLMData,
        cfg=cfg, tcfg=tcfg, jp=jp, np_params=np_params,
        tp=bridge.params_from_numpy(np_params, tcfg, "cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def fm(request):
    return _load(request.param)


def _batch(m, step=0, seq=SEQ, batch=BATCH):
    return m.JData(m.cfg, m.JShape("t", seq, batch, "train"),
                   seed=1).batch_at(step)


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


# ---------------------------------------------------------------------------
# parameters, data


def test_init_params_follow_jax_layout(fm):
    """The port's random init has JAX's leaves: no embedding for audio, a
    (d/2, d) frontend projection for both, a head for both (untied)."""
    m = fm
    tp = TM.init_params(m.tcfg, device="cpu", for_training=True)
    got = {k: v.shape for k, v in _flat(bridge.params_to_numpy(tp, m.tcfg)).items()}
    want = {k: v.shape for k, v in _flat(m.np_params).items()}
    assert got == want
    assert ("embed.tok_embed" in got) == (m.cfg.frontend == "vision")
    assert got["frontend.frontend_proj"] == (m.cfg.d_model // 2, m.cfg.d_model)
    assert "head.out_head" in got


def test_batch_at_matches_jax(fm):
    m = fm
    jd = m.JData(m.cfg, m.JShape("t", 40, 3, "train"), seed=4)
    td = TData(m.tcfg, TShape("t", 40, 3, "train"), seed=4)
    for step in (0, 1, 17):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = set(td.batch_at(0))
    assert keys == ({"feats", "labels"} if m.cfg.frontend == "audio"
                    else {"tokens", "labels", "img_feats"})


# ---------------------------------------------------------------------------
# forward, loss, gradients, train loop


def test_forward_and_loss_match_jax(fm):
    m = fm
    b = _batch(m)
    want, _ = m.JM.forward(m.jp, m.cfg, {k: m.jnp.asarray(v) for k, v in b.items()})
    wloss, _ = m.JM.loss_fn(m.jp, m.cfg, {k: m.jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got, _ = TM.forward(m.tp, m.tcfg, tb)
    loss, _ = TM.loss_fn(m.tp, m.tcfg, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(loss.item(), float(wloss), **TOL)


@pytest.fixture(scope="module")
def jax_grads(fm):
    m = fm
    jb = {k: m.jnp.asarray(v) for k, v in _batch(m).items()}
    (loss, _), grads = m.jax.jit(m.jax.value_and_grad(
        lambda p: m.JM.loss_fn(p, m.cfg, jb), has_aux=True))(m.jp)
    return float(loss), _flat(m.jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_grads_match_jax(fm, jax_grads, remat):
    m = fm
    tcfg = m.tcfg.replace(remat=remat)
    params = bridge.params_from_numpy(m.np_params, tcfg, "cpu", for_training=True)
    tb = {k: torch.from_numpy(v) for k, v in _batch(m).items()}
    loss, _ = TM.loss_fn(params, tcfg, tb)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    want_loss, want = jax_grads
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    got = _flat(bridge.grads_to_numpy(params, grads, tcfg))
    assert got.keys() == want.keys() and "frontend.frontend_proj" in got
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-4,
            atol=1e-5 * float(np.abs(want[name]).max()), err_msg=name)
        assert np.abs(want[name]).max() > 0 or name.endswith("scale"), name


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_trainloop_steps_match_jax(fm, microbatches):
    """JAX's ``TrainLoop`` from its seed-0 state against the port's
    ``TrainLoop`` resuming from that state (JAX's checkpoint of step 0),
    the same batches and schedule: three losses at 1e-4."""
    from repro.train import checkpoint as jckpt
    from repro.train.loop import TrainLoop as JLoop

    m = fm
    shape_kw = dict(total_steps=10, lr=1e-3, microbatches=microbatches, seed=0)
    d = tempfile.mkdtemp()
    try:
        jloop = JLoop(m.cfg, m.JShape("t", 32, 4, "train"), **shape_kw)
        state, _ = jloop.init_or_restore()
        jckpt.save_checkpoint(d, state, 0)
        want = [r["loss"] for r in jloop.run(3)]
        got = [r["loss"] for r in TrainLoop(
            m.tcfg, TShape("t", 32, 4, "train"), ckpt_dir=d, device="cpu",
            **shape_kw).run(3)]
    finally:
        shutil.rmtree(d)
    np.testing.assert_allclose(got, want, **TOL)


def test_launcher_trains_frontends_on_cpu(fm, capsys, tmp_path):
    m = fm
    arch = "hubert-xlarge" if m.cfg.frontend == "audio" else "llama-3.2-vision-11b"
    assert tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--steps", "2", "--microbatches", "2",
                         "--ckpt-dir", str(tmp_path), "--int8-opt"]) == 0
    assert f"{m.cfg.name}: loss" in capsys.readouterr().out
    assert (tmp_path / "step_00000002" / "tensors.npz").exists()


# ---------------------------------------------------------------------------
# attention routes


@pytest.mark.parametrize("route,q_chunk", [("full", 128), ("chunked", 16)])
@pytest.mark.parametrize("kind", ["bidirectional_hd80", "cross"])
def test_attention_fwd_matches_jax(kind, route, q_chunk):
    """Bidirectional self-attention at hubert's head layout (16 heads at
    head_dim 80, no RoPE) and cross-attention (GQA 4 over 2, K/V from 24
    encoder states), on the full and the chunked softmax."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import AttnCfg
    from repro.models.layers import attention as JA

    from repro_torch.configs.base import AttnCfg as TAttnCfg

    if kind == "cross":
        kw, d = dict(num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=None,
                     cross=True), 64
    else:
        kw, d = dict(num_heads=16, num_kv_heads=16, head_dim=80, rope_theta=None,
                     causal=False), 1280
    acfg, tacfg = AttnCfg(**kw), TAttnCfg(**kw)
    p = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(3), d, acfg))
    rng = np.random.RandomState(7)
    x = rng.standard_normal((2, 64, d)).astype(np.float32)
    enc = rng.standard_normal((2, 24, d)).astype(np.float32) if kind == "cross" else None
    assert (64 > 2 * q_chunk) == (route == "chunked")
    want = JA.attention_fwd({k: jax.numpy.asarray(v) for k, v in p.items()}, acfg,
                            jax.numpy.asarray(x), q_chunk=q_chunk,
                            enc=None if enc is None else jax.numpy.asarray(enc))
    got = TA.attention_fwd({k: torch.from_numpy(np.array(v)) for k, v in p.items()}, tacfg,
                           torch.from_numpy(x), q_chunk=q_chunk,
                           enc=None if enc is None else torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_route_is_taken_by_causal_self_attention_only(monkeypatch):
    """``use_flash`` reaches the flash route only for causal self-attention
    (JAX ``attention.py:152``): hubert's bidirectional layers and the
    vision model's cross layers stay on the softmax routes."""
    from repro_torch.kernels import ops as tops

    calls = []
    monkeypatch.setattr(tops, "flash_attention_grouped",
                        lambda *a, **k: calls.append(1) or a[0])
    for arch, n_flash in (("hubert-xlarge", 0), ("llama-3.2-vision-11b", 2)):
        tcfg = tget(arch, smoke=True).replace(dtype="float32", use_flash=True,
                                              remat="none")
        params = TM.init_params(tcfg, device="cpu")
        b = TData(tcfg, TShape("t", 16, 1, "train"), seed=0).batch_at(0)
        calls.clear()
        TM.forward(params, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
        assert len(calls) == n_flash, arch


@pytest.mark.parametrize("remat,forwards", [("none", 1), ("full", 3), ("dots", 3)])
def test_flash_forwards_per_step_follow_nested_remat(monkeypatch, remat, forwards):
    """The vision smoke stage is (self, cross) x 2: each self layer's flash
    route runs in the forward pass, and with remat once in the group's
    recomputation (which stops at the group's last block, here the cross
    layer) and once in its own block's, JAX's nested remat (chip_smoke.py
    asserts this count on the card)."""
    from repro_torch.kernels import ops as tops

    tcfg = tget("llama-3.2-vision-11b", smoke=True).replace(
        dtype="float32", use_flash=True, remat=remat)
    calls = []
    local = tops._flash_grouped_local
    monkeypatch.setattr(tops, "_flash_grouped_local",
                        lambda *a: calls.append(1) or local(*a))
    params = TM.init_params(tcfg, device="cpu", for_training=True)
    b = TData(tcfg, TShape("t", 16, 1, "train"), seed=0).batch_at(0)
    loss, _ = TM.loss_fn(params, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    torch.autograd.grad(loss, list(params.parameters()))
    assert len(calls) == tcfg.stages[0].repeats * forwards


# ---------------------------------------------------------------------------
# the vision lock-step path


@pytest.fixture(scope="module", params=[2, 1], ids=["scanned", "unscanned"])
def vision(request):
    return _load("llama-3.2-vision-11b", stage_repeats=request.param)


def _img(m, seed, B=2):
    return np.random.RandomState(seed).standard_normal(
        (B, m.cfg.n_img_tokens, m.cfg.d_model // 2)).astype(np.float32)


def test_vision_lockstep_matches_jax(vision):
    """``init_decode_state`` over image features (each cross layer's K/V
    projected by its own repeat's weights), ``prefill`` of 2 x 20 tokens,
    four decode steps: logits and every state leaf after each."""
    m = vision
    jnp = m.jnp
    tok = np.random.RandomState(4).randint(0, m.cfg.vocab_size,
                                           (2, 20)).astype(np.int32)
    img = _img(m, 5)
    js = m.JM.init_decode_state(m.jp, m.cfg, 2, 32, enc_feats=jnp.asarray(img))
    ts = TM.init_decode_state(m.tp, m.tcfg, 2, 32, enc_feats=torch.from_numpy(img))
    _compare_states(m, js, ts)
    crosses = [c for c in ts["layers"][0] if set(c) == {"k", "v"}]
    assert len(crosses) == 1 and crosses[0]["k"].shape[0] == m.cfg.stages[0].repeats
    if m.cfg.stages[0].repeats > 1:  # per-repeat projections differ
        assert not torch.allclose(crosses[0]["k"][0], crosses[0]["k"][1])
    js = m.JM.prefill(m.jp, m.cfg, js, jnp.asarray(tok), enc_feats=jnp.asarray(img))
    TM.prefill(m.tp, m.tcfg, ts, torch.from_numpy(tok),
               enc_feats=torch.from_numpy(img))
    _compare_states(m, js, ts)
    nxt = tok[:, -1:]
    for _ in range(4):
        jl, js = m.JM.decode_step(m.jp, m.cfg, js, jnp.asarray(nxt))
        tl, ts = TM.decode_step(m.tp, m.tcfg, ts, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _compare_states(m, js, ts)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]


def test_vision_decode_agrees_with_forward_and_sees_the_image(vision):
    """The first decode step's logits equal ``forward``'s over prompt +
    token at its last position, and other image features change them by
    more than the tolerance."""
    m = vision
    tok = np.random.RandomState(6).randint(0, m.cfg.vocab_size,
                                           (2, 13)).astype(np.int32)
    out = []
    for seed in (5, 9):
        img = torch.from_numpy(_img(m, seed))
        ts = TM.init_decode_state(m.tp, m.tcfg, 2, 32, enc_feats=img)
        TM.prefill(m.tp, m.tcfg, ts, torch.from_numpy(tok[:, :-1]), enc_feats=img)
        logits, _ = TM.decode_step(m.tp, m.tcfg, ts, torch.from_numpy(tok[:, -1:]))
        full, _ = TM.forward(m.tp, m.tcfg, {"tokens": torch.from_numpy(tok),
                                             "img_feats": img})
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(), **TOL)
        out.append(logits.numpy())
    diff = np.abs(out[0] - out[1]) - (TOL["atol"] + TOL["rtol"] * np.abs(out[0]))
    assert diff.max() > 0, "the image features do not reach the logits"


# ---------------------------------------------------------------------------
# serving stays closed to frontends, as in JAX


def test_serving_raises_for_frontends(fm):
    m = fm
    with pytest.raises(NotImplementedError):
        m.JM.init_paged_state(m.jp, m.cfg, 2, 32, page_size=8, n_pages=8)
    with pytest.raises(NotImplementedError):
        TM.init_paged_state(m.tp, m.tcfg, 2, 32, page_size=8, n_pages=8)
    with pytest.raises(NotImplementedError):
        ServeEngine(m.tp, m.tcfg, batch_size=2, cache_len=32, page_size=8,
                    device="cpu")
    with pytest.raises(NotImplementedError):
        ReferenceEngine(m.tp, m.tcfg, batch_size=2, cache_len=32, device="cpu")


def test_cross_layers_have_no_serving_cache():
    tcfg = tget("llama-3.2-vision-11b", smoke=True)
    cross = tcfg.stages[0].pattern[1].attn
    assert cross.cross
    with pytest.raises(NotImplementedError):
        TA.init_paged_cache(cross, 2, 32, torch.float32, page_size=8, n_pages=8)
    TA.init_paged_cache(dataclasses.replace(cross, cross=False), 2, 32,
                        torch.float32, page_size=8, n_pages=8)

"""The port's training path against the JAX package's, on the qwen2-1.5b
smoke config in float32 with the same weights (through
``repro_torch.bridge``) and the same batches:

- ``attention_fwd`` on its three routes (flash kernel, full softmax,
  chunked softmax): rtol = atol = 1e-5.
- ``forward`` logits and ``loss_fn`` with ``use_flash`` on and off and remat
  "none" / "full" / "dots": rtol = atol = 1e-4; every gradient leaf against
  ``jax.value_and_grad``: rtol 1e-4, atol 1e-5 x the leaf's max |g|.
- ``apply_updates`` (parameters and moments, rtol = atol = 1e-6),
  ``warmup_cosine`` (rtol 1e-6) and ``batch_at`` (exactly equal).
- Three ``make_train_step`` steps from one bridged state against JAX's
  jitted step, with one and two microbatches: losses and final parameters
  and moments at rtol = atol = 1e-4.
- The port's ``TrainLoop`` lowers the loss on learnable data
  (tests/test_train.py's check), and the launcher runs on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeCfg  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import attention as JA  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeCfg as TShape  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData as TData  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import attention as TA  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train.loop import TrainLoop  # noqa: E402
from repro_torch.train.train_step import make_train_step as tmake_step  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, BATCH = 64, 2


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def _batch(cfg, step=0, seq=SEQ, batch=BATCH):
    return JData(cfg, ShapeCfg("t", seq, batch, "train"), seed=1).batch_at(step)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _compare_trees(got, want, rtol, atol_frac=None, atol=None):
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for name in want:
        a = atol if atol_frac is None else atol_frac * float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=a,
                                   err_msg=name)


@pytest.mark.parametrize("route,q_chunk,use_flash", [
    ("flash", 128, True), ("full", 128, False), ("chunked", 16, False)])
def test_attention_fwd_routes_match_jax(qwen, route, q_chunk, use_flash):
    cfg, tcfg, _, np_params = qwen
    acfg, tacfg = cfg.stages[0].pattern[0].attn, tcfg.stages[0].pattern[0].attn
    mixer = {k: np.array(v[0]) for k, v in np_params["stages"][0][0]["mixer"].items()}
    x = np.random.RandomState(7).standard_normal((BATCH, SEQ, cfg.d_model)
                                                 ).astype(np.float32)
    assert (SEQ > 2 * q_chunk) == (route == "chunked")
    want = JA.attention_fwd({k: jnp.asarray(v) for k, v in mixer.items()}, acfg,
                            jnp.asarray(x), q_chunk=q_chunk, use_flash=use_flash)
    got = TA.attention_fwd({k: torch.from_numpy(v) for k, v in mixer.items()},
                           tacfg, torch.from_numpy(x), q_chunk=q_chunk,
                           use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attention_fwd_keeps_raising_for_windowed_and_cross(qwen):
    """The name is historical: neither a window nor cross-attention raises
    any more (windowed attention is held against JAX in
    tests/test_torch_window.py, cross-attention in
    tests/test_torch_frontends.py).  Both calls run on the qwen weights and
    give finite outputs, the cross call over 6 encoder states."""
    tacfg = qwen[1].stages[0].pattern[0].attn
    mixer = {k: torch.from_numpy(np.array(v[0]))
             for k, v in qwen[3]["stages"][0][0]["mixer"].items()}
    d = qwen[1].d_model
    out = TA.attention_fwd(mixer, dataclasses.replace(tacfg, window=2),
                           torch.randn(1, 4, d))
    assert out.shape == (1, 4, d) and bool(out.isfinite().all())
    out = TA.attention_fwd(mixer, dataclasses.replace(tacfg, cross=True),
                           torch.randn(1, 4, d), enc=torch.randn(1, 6, d))
    assert out.shape == (1, 4, d) and bool(out.isfinite().all())


@pytest.fixture(scope="module")
def jax_grads(qwen):
    """JAX's (logits, loss, grads) per ``use_flash``, computed once."""
    cfg, _, jp, _ = qwen
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    out = {}
    for flash in (False, True):
        c = cfg.replace(use_flash=flash)
        logits, _ = JM.forward(jp, c, batch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(p, c, batch), has_aux=True))(jp)
        out[flash] = (np.asarray(logits), float(loss), grads)
    return out


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_loss_and_grads_match_jax(qwen, jax_grads, use_flash, remat):
    cfg, tcfg, _, np_params = qwen
    tcfg = tcfg.replace(use_flash=use_flash, remat=remat)
    params = bridge.params_from_numpy(np_params, tcfg, "cpu", for_training=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    want_logits, want_loss, want_grads = jax_grads[use_flash]
    with torch.no_grad():
        logits, aux = TM.forward(params, tcfg, batch)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert set(aux) == {"moe_lb_loss", "moe_z_loss"}
    loss, mets = TM.loss_fn(params, tcfg, batch)
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    assert mets["ce_loss"].item() == loss.item()
    grads = torch.autograd.grad(loss, list(params.parameters()))
    _compare_trees(bridge.grads_to_numpy(params, grads, tcfg), want_grads,
                   rtol=1e-4, atol_frac=1e-5)


@pytest.mark.parametrize("remat,forwards", [("none", 1), ("full", 2), ("dots", 2)])
def test_flash_forwards_per_step_follow_remat(qwen, monkeypatch, remat, forwards):
    """One flash forward per layer, plus one per layer when remat recomputes
    the block in the backward pass (nested remat recomputes it once):
    chip_smoke.py asserts n_layers x this count of kernel launches a step."""
    from repro_torch.kernels import ops as tops

    calls = []
    local = tops._flash_grouped_local
    monkeypatch.setattr(tops, "_flash_grouped_local",
                        lambda *a: calls.append(1) or local(*a))
    tcfg = qwen[1].replace(use_flash=True, remat=remat)
    params = bridge.params_from_numpy(qwen[3], tcfg, "cpu", for_training=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(qwen[0]).items()}
    loss, _ = TM.loss_fn(params, tcfg, batch)
    torch.autograd.grad(loss, list(params.parameters()))
    assert len(calls) == tcfg.n_layers * forwards


def test_loss_mask_matches_jax(qwen):
    cfg, tcfg, jp, np_params = qwen
    b = _batch(cfg)
    b["loss_mask"] = (np.random.RandomState(8).rand(BATCH, SEQ) < 0.5).astype(np.float32)
    want, _ = JM.loss_fn(jp, cfg, {k: jnp.asarray(v) for k, v in b.items()})
    params = bridge.params_from_numpy(np_params, tcfg, "cpu", for_training=True)
    with torch.no_grad():
        got, _ = TM.loss_fn(params, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_training_layout_is_float32_with_grads_and_serving_is_unchanged(qwen):
    tcfg = tget("qwen2-1.5b", smoke=True)  # bf16 activations, f32 params
    for fn in (lambda: TM.init_params(tcfg, device="cpu", for_training=True),
               lambda: bridge.params_from_numpy(qwen[3], tcfg, "cpu",
                                                for_training=True)):
        p = fn()
        assert all(t.dtype == torch.float32 and t.requires_grad
                   for t in p.parameters())
    p = bridge.params_from_numpy(qwen[3], tcfg, "cpu")
    assert p.stages[0][0].mixer["wq"].dtype == torch.bfloat16
    assert not any(t.requires_grad for t in p.parameters())
    back = bridge.params_to_numpy(
        bridge.params_from_numpy(qwen[3], qwen[1], "cpu", for_training=True), qwen[1])
    _compare_trees(back, qwen[2], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# optimizer, schedule, data


def test_apply_updates_matches_jax():
    rng = np.random.RandomState(9)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 2 for s in shapes]
             for _ in range(2)]
    cfg = jadamw.AdamWCfg()
    jp = list(map(jnp.asarray, params))
    jst = jadamw.init_opt_state(jp, cfg)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tst = tadamw.init_opt_state(tp, tadamw.AdamWCfg())
    for g in grads:
        jp, jst, jm = jadamw.apply_updates(jp, list(map(jnp.asarray, g)), jst,
                                           cfg, 1e-2)
        _, tst, tm = tadamw.apply_updates(tp, [torch.from_numpy(x.copy()) for x in g],
                                          tst, tadamw.AdamWCfg(), 1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
    for got, want in zip(tp + tst["m"] + tst["v"], jp + jst["m"] + jst["v"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 2


def test_warmup_cosine_matches_jax():
    steps = np.arange(0, 25)
    for args in ((3e-4, 5, 20), (1e-3, 1, 4)):
        want = np.asarray([jsched.warmup_cosine(*args)(s) for s in steps])
        got = np.asarray([float(tsched.warmup_cosine(*args)(int(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got[0] == 0.0
    assert float(tsched.constant(2e-3)(7)) == float(jsched.constant(2e-3)(7))


def test_batch_at_is_identical_and_iter_from_places_batches(qwen):
    cfg, tcfg = qwen[0], qwen[1]
    jd = JData(cfg, ShapeCfg("t", 48, 3, "train"), seed=4)
    td = TData(tcfg, TShape("t", 48, 3, "train"), seed=4)
    for step in (0, 1, 17):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    it = td.iter_from(5, device="cpu")
    try:
        for step in (5, 6):
            b = next(it)
            np.testing.assert_array_equal(b["tokens"].numpy(), jd.batch_at(step)["tokens"])
    finally:
        it.close()


# ---------------------------------------------------------------------------
# train step, loop, launcher


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_jax(qwen, microbatches):
    cfg, tcfg, jp, np_params = qwen
    cfg, tcfg = cfg.replace(use_flash=True), tcfg.replace(use_flash=True)
    opt = jadamw.AdamWCfg()
    jstep = jax.jit(jmake_step(cfg, opt, jsched.constant(1e-3), microbatches))
    jstate = {"params": jp, "opt": jadamw.init_opt_state(jp, opt)}
    params = bridge.params_from_numpy(np_params, tcfg, "cpu", for_training=True)
    tstate = {"params": params,
              "opt": tadamw.init_opt_state(params, tadamw.AdamWCfg())}
    tstep = tmake_step(tcfg, tadamw.AdamWCfg(), tsched.constant(1e-3), microbatches)
    for step in range(3):
        b = _batch(cfg, step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert tstate["params"] is params
    _compare_trees(bridge.params_to_numpy(params, tcfg), jstate["params"], **TOL)
    _compare_trees(bridge.grads_to_numpy(params, tstate["opt"]["m"], tcfg),
                   jstate["opt"]["m"], **TOL)


def test_trainloop_loss_decreases_on_learnable_data():
    cfg = tget("qwen2-1.5b", smoke=True)
    h = TrainLoop(cfg, TShape("tiny", 32, 8, "train"), total_steps=60, lr=3e-3,
                  device="cpu").run(45)
    assert [r["step"] for r in h] == list(range(45))
    assert all(r["time_s"] > 0 for r in h)
    first = np.mean([r["loss"] for r in h[:5]])
    last = np.mean([r["loss"] for r in h[-5:]])
    assert last < 0.8 * first, (first, last)


def test_trainloop_failures_propagate_and_checkpoints_raise():
    """Without a checkpoint directory a failing step re-raises, as in JAX.
    The name is historical: checkpoints no longer raise (save, resume and
    restore-and-replay are held in tests/test_torch_checkpoint.py)."""
    cfg = tget("qwen2-1.5b", smoke=True)
    shape = TShape("tiny", 16, 2, "train")

    def chaos(step):
        if step == 1:
            raise RuntimeError("injected failure")

    with pytest.raises(RuntimeError, match="injected"):
        TrainLoop(cfg, shape, device="cpu", failure_hook=chaos).run(3)


def test_launcher_trains_on_cpu(capsys):
    assert tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                         "--steps", "3", "--use-flash"]) == 0
    assert "qwen2-1.5b-smoke: loss" in capsys.readouterr().out


def test_launcher_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1"])

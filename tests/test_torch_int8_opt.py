"""int8 AdamW moments in the port against the JAX package, on the CPU.

- ``quantize`` / ``dequantize`` bit-equal to JAX's (rowwise absmax over the
  last axis, round half to even, clip at +-127, zero rows at scale 1), on
  random rows, zero rows and exact halves;
- ``init_opt_state`` with ``state_dtype="int8"``: JAX's layout (``q`` int8
  zeros, ``qscale`` ones, one per last-axis row);
- ``apply_updates`` over the same parameters and gradients for five steps:
  parameters at rtol = atol = 1e-4; the moments within one quantization
  level of JAX's, and a level apart on at most 0.1 % of entries (the rule
  of the int8 KV tests), the scales at rtol 1e-6;
- three ``make_train_step`` steps on the qwen2-1.5b smoke config with int8
  moments from one bridged state: losses at 1e-4; after the first, the
  moments under the same one-level rule, their scales at the gradients' tolerance (rtol
  1e-4, atol 1e-5 x the leaf's largest; twice that for the second moment,
  which squares them); the launcher's ``--int8-opt`` on the CPU;
- int8-moment AdamW tracks float32 AdamW on a quadratic (the JAX
  package's own test, here for the port).

JAX is imported lazily.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.optim.quantized_state import dequantize, is_quantized, quantize  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train.train_step import make_train_step as tmake_step  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(3, 4), (5,), (2, 3, 7), (4, 64)]


def _rows(seed):
    rng = np.random.RandomState(seed)
    out = [(rng.standard_normal(s) * 10.0 ** rng.randint(-4, 4)).astype(np.float32)
           for s in SHAPES]
    out[0][1] = 0.0  # an all-zero row: scale 1
    out[3][0, :5] = [127.0, 0.5, 1.5, 2.5, -2.5]  # exact halves after scaling
    return out


def _one_level(got, want, scale_tol, share=1e-3):
    """The moments within one quantization level of JAX's: their int8
    values at most 1 apart, and apart on at most ``share`` of the entries;
    their row scales at rtol ``scale_tol`` and atol ``scale_tol`` x 0.1 x
    the leaf's largest scale."""
    diff = np.abs(got["q"].numpy().astype(np.int32)
                  - np.asarray(want["q"]).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()
    ws = np.asarray(want["qscale"])
    np.testing.assert_allclose(got["qscale"].numpy(), ws, rtol=scale_tol,
                               atol=0.1 * scale_tol * float(ws.max()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_is_bit_equal_to_jax(seed):
    jnp = pytest.importorskip("jax.numpy")
    from repro.optim import quantized_state as J

    for x in _rows(seed):
        want = J.quantize(jnp.asarray(x))
        got = quantize(torch.from_numpy(x))
        assert got["q"].dtype == torch.int8 and got["qscale"].dtype == torch.float32
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["qscale"].numpy(), np.asarray(want["qscale"]))
        np.testing.assert_array_equal(dequantize(got).numpy(),
                                      np.asarray(J.dequantize(want)))
        assert is_quantized(got) and not is_quantized(got["q"])


def test_init_opt_state_int8_has_jax_layout():
    jnp = pytest.importorskip("jax.numpy")
    from repro.optim import adamw as jadamw

    params = [np.ones(s, np.float32) for s in SHAPES]
    want = jadamw.init_opt_state([jnp.asarray(p) for p in params],
                                 jadamw.AdamWCfg(state_dtype="int8"))
    got = tadamw.init_opt_state([torch.from_numpy(p) for p in params],
                                tadamw.AdamWCfg(state_dtype="int8"))
    for g, w in zip(got["m"] + got["v"], want["m"] + want["v"]):
        for k in ("q", "qscale"):
            assert g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert int(got["step"]) == 0


def test_apply_updates_int8_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    from repro.optim import adamw as jadamw

    rng = np.random.RandomState(9)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jcfg, tcfg = jadamw.AdamWCfg(state_dtype="int8"), tadamw.AdamWCfg(state_dtype="int8")
    jp = [jnp.asarray(p) for p in params]
    jst = jadamw.init_opt_state(jp, jcfg)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tst = tadamw.init_opt_state(tp, tcfg)
    qptrs = [m["q"].data_ptr() for m in tst["m"]]
    for _ in range(5):
        g = [rng.standard_normal(s).astype(np.float32) * 2 for s in SHAPES]
        jp, jst, jm = jadamw.apply_updates(jp, [jnp.asarray(x) for x in g], jst,
                                           jcfg, 1e-2)
        _, tst, tm = tadamw.apply_updates(tp, [torch.from_numpy(x.copy()) for x in g],
                                          tst, tcfg, 1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in zip(tst["m"] + tst["v"], jst["m"] + jst["v"]):
        _one_level(got, want, scale_tol=1e-6)
    assert [m["q"].data_ptr() for m in tst["m"]] == qptrs  # updated in place
    assert int(tst["step"]) == int(jst["step"]) == 5


def test_three_int8_train_steps_match_jax():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLMData
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    from repro.optim import schedules as jsched
    from repro.train.train_step import make_train_step as jmake_step

    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    jcfg, ocfg = jadamw.AdamWCfg(state_dtype="int8"), tadamw.AdamWCfg(state_dtype="int8")
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    jstate = {"params": jp, "opt": jadamw.init_opt_state(jp, jcfg)}
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                                      for_training=True)
    tstate = {"params": params, "opt": tadamw.init_opt_state(params, ocfg)}
    jstep = jax.jit(jmake_step(cfg, jcfg, jsched.constant(1e-4)))
    tstep = tmake_step(tcfg, ocfg, tsched.constant(1e-4))
    data = SyntheticLMData(cfg, ShapeCfg("t", 32, 4, "train"), seed=1)
    for step in range(3):
        b = data.batch_at(step)
        jstate, jm = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
        if step == 0:
            _compare_moments(jax, jstate, tstate, len(list(params.parameters())))


def _compare_moments(jax, jstate, tstate, n_params):
    """Every moment of ``tstate`` against ``jstate``'s under the one-level
    rule.  The scales follow the gradients, which agree at rtol 1e-4 and
    atol 1e-5 x the leaf's largest; the second moment holds their squares,
    which doubles both.  (After the first step the packages' parameters
    differ by those one-level moment differences, and a later step's
    gradients carry that past 1e-4, so the moments are held after one.)"""
    want = {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    got = C.flatten_state(tstate)
    assert got.keys() == want.keys()
    moments = [k[:-len("['q']")] for k in want if k.endswith("['q']")]
    assert len(moments) == 2 * n_params
    for base in moments:
        pair = {}
        for part in ("q", "qscale"):
            t, unstack = got[f"{base}['{part}']"]
            pair[part] = t[0] if unstack else t
        _one_level(pair, {part: want[f"{base}['{part}']"]
                          for part in ("q", "qscale")},
                   scale_tol=1e-4 if base.startswith("['opt']['m']") else 2e-4)


def test_int8_training_tracks_float32_on_a_quadratic():
    runs = {}
    for sdt in ("float32", "int8"):
        cfg = tadamw.AdamWCfg(state_dtype=sdt, weight_decay=0.0, grad_clip=None)
        w = [torch.zeros(16)]
        st = tadamw.init_opt_state(w, cfg)
        for _ in range(100):
            g = [2.0 * (w[0] - 3.0)]
            _, st, _ = tadamw.apply_updates(w, g, st, cfg, lr=0.05)
        runs[sdt] = w[0].clone()
    assert float((runs["int8"] - runs["float32"]).abs().max()) < 0.15


def test_launcher_int8_opt_on_cpu(capsys):
    assert tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                         "--steps", "2", "--int8-opt"]) == 0
    assert "qwen2-1.5b-smoke: loss" in capsys.readouterr().out

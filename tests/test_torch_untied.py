"""The untied output head (``head.out_head``) against the JAX package, on
the two dense decoders that have one: glm4-9b (GQA, G = 2 at the smoke size)
and qwen1.5-4b (multi-head, G = 1), smoke configs in float32 on the same
weights (through ``repro_torch.bridge``):

- the parameter layout and the bridge round trip, ``head.out_head``
  included (exactly equal);
- the ragged step's and the two-phase step's logits and state over random
  packs, float32 and int8 pools, gather and kernel routes: rtol = atol =
  1e-4, integer leaves equal.  With int8 pools one exception: the two
  sides' K/V projections differ in the last float32 bit (different
  summation orders), so a value that lies on a rounding boundary can
  quantize one level apart (qwen1.5-4b's smoke weights put one V entry of
  layer 0 there).  int8 entries may then differ by one level on at most
  0.1 % of the pool, and the logits are held to atol ``INT8_LOGIT_ATOL``;
  the engines' transcripts stay token-identical;
- greedy transcripts of the ragged and the two-phase engine, float32 and
  int8 pools, both attention routes: token-identical;
- ``forward``/``loss_fn`` and every gradient leaf, the head's included
  (rtol 1e-4, atol 1e-5 x the leaf's max |g|), and three AdamW steps'
  losses and parameters (rtol = atol = 1e-4);
- the launchers serve and train the untied configs on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeCfg  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.train_step import make_train_step as tmake_step  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# int8 pools: the logit error one quantization level of one V entry makes
# at the smoke size (7.0e-4 measured on qwen1.5-4b's smoke weights)
INT8_LOGIT_ATOL = 2e-3
ARCHS = ["glm4-9b", "qwen1.5-4b"]


def _configs(arch):
    # float32 throughout: qwen1.5-4b stores bf16 parameters by default
    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               param_dtype="float32")
    tcfg = tget(arch, smoke=True).replace(dtype="float32",
                                          param_dtype="float32")
    return cfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def untied(request):
    cfg, tcfg = _configs(request.param)
    assert not cfg.tie_embeddings and not tcfg.tie_embeddings
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    tp = bridge.params_from_numpy(np_params, tcfg, "cpu")
    return cfg, tcfg, jp, np_params, tp


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


# ---------------------------------------------------------------------------
# layout and bridge


def test_head_leaf_layout_and_bridge_round_trip(untied):
    cfg, tcfg, jp, np_params, tp = untied
    assert "head" in np_params and set(np_params["head"]) == {"out_head"}
    want = {k: tuple(v.shape) for k, v in _flat(np_params).items()}
    for params in (tp, TM.init_params(tcfg, device="cpu")):
        got = {k: tuple(v.shape) for k, v in params.named_parameters()}
        assert got == want
        assert params.head["out_head"].shape == (cfg.d_model, cfg.vocab_size)
    back = bridge.params_from_numpy(np_params, tcfg, "cpu", for_training=True)
    _compare_trees(bridge.params_to_numpy(back, tcfg), jp, rtol=0, atol=0)


def test_init_params_draws_the_head_in_each_layout(untied):
    tcfg = untied[1].replace(dtype="bfloat16")
    serve = TM.init_params(tcfg, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    w = serve.head["out_head"]
    assert w.dtype == torch.bfloat16 and not w.requires_grad
    # truncated normal on [-2, 2] scaled by fan_in^-1/2, fan_in = d
    assert float(w.float().abs().max()) <= 2.0 / np.sqrt(tcfg.d_model) + 1e-2
    train = TM.init_params(tcfg, device="cpu", for_training=True)
    assert train.head["out_head"].dtype == torch.float32
    assert train.head["out_head"].requires_grad
    assert TM.init_params(tget("qwen2-1.5b", smoke=True), device="cpu").head is None


# ---------------------------------------------------------------------------
# the serving steps


def _compare_states(jstate, tstate, tcfg):
    want = _flat(jax.tree.map(np.asarray, jstate))
    got = _flat(bridge.state_to_numpy(tstate, tcfg))
    assert got.keys() == want.keys()
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        elif want[k].dtype == np.int8:  # at most one level, rarely
            d = np.abs(got[k].astype(np.int32) - want[k].astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (k, d.max())
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _logit_tol(kv_dtype):
    return TOL if kv_dtype != "int8" else dict(rtol=1e-4, atol=INT8_LOGIT_ATOL)


def _fresh_states(cfg, tcfg, jp, B, cache_len, P, n_pages, kv_dtype):
    """JAX and port states with slot b mapped on pages b*pps.. (all live)."""
    pps = cache_len // P
    js = JM.init_paged_state(jp, cfg, B, cache_len, page_size=P,
                             n_pages=n_pages, kv_dtype=kv_dtype)
    ts = bridge.state_from_numpy(jax.tree.map(np.asarray, js), tcfg, "cpu")
    rows = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
    mask, plen = np.ones(B, bool), np.zeros(B, np.int32)
    js = JM.reset_paged_slots(cfg, js, js, jnp.asarray(mask), jnp.asarray(rows),
                              jnp.asarray(plen))
    tmpl = {"layers": [[{k: v.clone() for k, v in c.items()
                         if k in ("ptab", "kpos", "slen")} for c in ss]
                       for ss in ts["layers"]]}
    TM.reset_paged_slots(tcfg, ts, tmpl, torch.from_numpy(mask),
                         torch.from_numpy(rows), torch.from_numpy(plen))
    return js, ts


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ragged_step_logits_and_state_match_jax(untied, kv_dtype, flash):
    cfg, tcfg, jp, _, tp = untied
    B, T = 3, 24
    js, ts = _fresh_states(cfg, tcfg, jp, B, 64, 8, 24, kv_dtype)
    rng = np.random.RandomState(5)
    cursor = [0] * B
    for _ in range(4):
        tokens = rng.randint(0, cfg.vocab_size, T).astype(np.int32)
        slot, q_pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
        seq, valid = np.zeros(T, np.int32), np.zeros(T, bool)
        logit_idx = np.full(B, T, np.int32)
        n = 0
        for b in range(B):
            c = 1 if rng.rand() < 0.4 else rng.randint(2, 6)
            slot[n:n + c], q_pos[n:n + c] = b, cursor[b] + np.arange(c)
            seq[n:n + c], valid[n:n + c] = np.arange(c), True
            n += c
            cursor[b] += c
            logit_idx[b] = n - 1
        vecs = (tokens, slot, q_pos, seq, valid, logit_idx)
        jl, js = JM.ragged_step(jp, cfg, js, *(jnp.asarray(a) for a in vecs),
                                width=8, flash_decode=flash)
        tl, ts = TM.ragged_step(tp, tcfg, ts, *(torch.from_numpy(a) for a in vecs),
                                width=8, flash_decode=flash)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **_logit_tol(kv_dtype))
        _compare_states(js, ts, tcfg)


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_step_logits_and_state_match_jax(untied, kv_dtype, flash):
    """A (B, 8) prefill chunk of a different length per slot, then two
    decode ticks with the last slot riding along invalid."""
    cfg, tcfg, jp, _, tp = untied
    B, C = 3, 8
    js, ts = _fresh_states(cfg, tcfg, jp, B, 64, 8, 24, kv_dtype)
    rng = np.random.RandomState(6)
    fill = np.asarray([8, 5, 3], np.int32)
    tokens = rng.randint(0, cfg.vocab_size, (B, C)).astype(np.int32)
    q_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    valid = np.arange(C)[None, :] < fill[:, None]
    packs = [(tokens, q_pos, valid, False)]
    for t in range(2):
        packs.append((rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32),
                      (fill + t)[:, None], (np.arange(B) < B - 1)[:, None], True))
    for tok, pos, live, logits in packs:
        jl, js = JM.paged_step(jp, cfg, js, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(live), with_logits=logits,
                               flash_decode=flash)
        tl, ts = TM.paged_step(tp, tcfg, ts, torch.from_numpy(tok),
                               torch.from_numpy(pos), torch.from_numpy(live),
                               with_logits=logits, flash_decode=flash)
        if logits:
            np.testing.assert_allclose(tl[:B - 1].numpy(),
                                       np.asarray(jl)[:B - 1],
                                       **_logit_tol(kv_dtype))
        else:
            assert tl is None and jl is None
        _compare_states(js, ts, tcfg)


# ---------------------------------------------------------------------------
# the engines

KW = dict(batch_size=2, cache_len=64, page_size=8, prefill_chunk=16,
          token_budget=32)


def _serve(engine, prompts, max_tokens=6):
    uids = [engine.submit(p, max_tokens=max_tokens) for p in prompts]
    res = engine.run()
    return [res[u] for u in uids]


@pytest.mark.parametrize("flash", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "two_phase"])
def test_engine_transcripts_token_identical_to_jax(untied, ragged, kv_dtype,
                                                   flash):
    """Mixed prompt lengths, more requests than slots, and a shared
    20-token prefix that a later request hits mid-page (copy-on-write)."""
    cfg, tcfg, jp, _, tp = untied
    rng = np.random.RandomState(3)
    shared = rng.randint(0, cfg.vocab_size, 20)
    prompts = [rng.randint(0, cfg.vocab_size, L) for L in (5, 17, 30)]
    prompts += [np.concatenate([shared, rng.randint(0, cfg.vocab_size, 3)]),
                np.concatenate([shared[:13], rng.randint(0, cfg.vocab_size, 6)])]
    kw = dict(KW, ragged=ragged, flash_decode=flash, kv_dtype=kv_dtype)
    je = JaxEngine(jp, cfg, **kw)
    te = ServeEngine(tp, tcfg, device="cpu", **kw)
    assert _serve(te, prompts) == _serve(je, prompts)
    ts, js = te.stats, je.stats
    for key in ("ragged_ticks", "chunk_ticks", "decode_ticks", "packed_tokens",
                "prefix_hits", "cow_copies", "traces"):
        assert ts[key] == js[key], key
    assert ts["prefix_hits"] >= 1


# ---------------------------------------------------------------------------
# training

SEQ, BATCH = 32, 2


def _batch(cfg, step=0):
    return JData(cfg, ShapeCfg("t", SEQ, BATCH, "train"), seed=1).batch_at(step)


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_loss_and_grads_match_jax(untied, use_flash):
    cfg, tcfg, jp, np_params, _ = untied
    cfg, tcfg = cfg.replace(use_flash=use_flash), tcfg.replace(use_flash=use_flash)
    b = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    want_logits, _ = JM.forward(jp, cfg, jbatch)
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jbatch), has_aux=True)(jp)
    params = bridge.params_from_numpy(np_params, tcfg, "cpu", for_training=True)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        logits, _ = TM.forward(params, tcfg, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    loss, _ = TM.loss_fn(params, tcfg, batch)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    got = bridge.grads_to_numpy(params, grads, tcfg)
    assert float(np.abs(got["head"]["out_head"]).max()) > 0
    _compare_trees(got, want_grads, rtol=1e-4, atol_frac=1e-5)


def test_three_train_steps_match_jax(untied):
    cfg, tcfg, jp, np_params, _ = untied
    cfg, tcfg = cfg.replace(use_flash=True), tcfg.replace(use_flash=True)
    opt = jadamw.AdamWCfg()
    jstep = jax.jit(jmake_step(cfg, opt, jsched.constant(1e-3)))
    jstate = {"params": jp, "opt": jadamw.init_opt_state(jp, opt)}
    params = bridge.params_from_numpy(np_params, tcfg, "cpu", for_training=True)
    tstate = {"params": params,
              "opt": tadamw.init_opt_state(params, tadamw.AdamWCfg())}
    tstep = tmake_step(tcfg, tadamw.AdamWCfg(), tsched.constant(1e-3))
    for step in range(3):
        b = _batch(cfg, step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    _compare_trees(bridge.params_to_numpy(params, tcfg), jstate["params"], **TOL)
    _compare_trees(bridge.grads_to_numpy(params, tstate["opt"]["m"], tcfg),
                   jstate["opt"]["m"], **TOL)


# ---------------------------------------------------------------------------
# launchers


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_untied_configs(arch, capsys):
    assert tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                        "--batch-size", "2", "--max-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "'traces': 1" in out
    assert tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--steps", "2"]) == 0
    assert f"{arch}-smoke: loss" in capsys.readouterr().out

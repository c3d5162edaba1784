"""The port's MoE FFN against the JAX package, on the CPU, and on the card.

CPU, float32, the same inputs on both sides (seed-made numpy, JAX's own
initial weights through numpy):

- The layer (``repro_torch.models.layers.moe``), both impls: the ports of
  tests/test_layers.py's four cases (dispatch equals dropless at high
  capacity, capacity drops, the dense residual, the gates' convexity with
  identical experts), against JAX at rtol 1e-4, atol 1e-5 and the aux
  losses at rtol 1e-5; a pack whose capacity overflows, with the dropped
  slots the same on both sides; the two forms of the dropless path (the
  eager per-expert products and the captured dispatch at capacity T)
  against each other at 1e-5; JAX's ``top_k`` tie order.
- The models: llama4-maverick-smoke (a dense then an MoE block, top-1 with
  a shared expert) and arctic-480b-smoke (top-2 with a dense residual in
  every block), seed-0 weights bridged through ``repro_torch.bridge``: the
  layout and leaf dtypes (the router float32 in the serving layout), each
  leaf cast as it is drawn; ``forward``, the aux losses and ``loss_fn``
  (rtol = atol = 1e-4; the aux losses 1e-5), every gradient leaf (rtol
  1e-4, atol 1e-5 x the leaf's max |g|, as the attention models'), remat
  "none" and "full".  Serving: tests/test_torch_moe_serve.py.

``gpu`` tests (skipped where there is no card): ``moe_fwd`` on CUDA
against the CPU (both impls; the ragged impl captured in a CUDA graph
against eager), three training steps of llama4-smoke on the card against
the CPU, and kernel 1 at llama4's (kvH 8, G 5) and jamba's (kvH 8, G 8)
head layouts.  JAX is imported lazily (fixtures), so that ``pytest -m
gpu`` runs where there is no JAX.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import MLPCfg, MoECfg  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import moe as TMoE  # noqa: E402
from repro_torch.models.layers.mlp import mlp_fwd  # noqa: E402

LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["llama4-maverick-400b-a17b", "arctic-480b"]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs.base import MLPCfg as JMLP
    from repro.configs.base import MoECfg as JCfg
    from repro.models.layers import moe as JMoE

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, JMoE=JMoE, JCfg=JCfg, JMLP=JMLP,
        key=jax.random.PRNGKey(0),
        moe_fwd=jax.jit(JMoE.moe_fwd, static_argnums=1))


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _x(shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _layer(jx, d, dense_ff=None, **kw):
    """(port cfg, JAX cfg, numpy weights from JAX's ``init_moe``)."""
    cfg = MoECfg(dense_residual=dense_ff and MLPCfg(d_ff=dense_ff), **kw)
    jcfg = jx.JCfg(dense_residual=dense_ff and jx.JMLP(d_ff=dense_ff), **kw)
    p = jx.jax.tree.map(np.asarray, jx.JMoE.init_moe(jx.key, d, jcfg))
    return cfg, jcfg, p


def _both(jx, cfg, jcfg, p, x):
    """(JAX's (y, aux) as numpy, the port's (y, aux) as numpy)."""
    jy, jaux = jx.moe_fwd(jx.jax.tree.map(jx.jnp.asarray, p), jcfg,
                          jx.jnp.asarray(x))
    ty, taux = TMoE.moe_fwd(_t(p), cfg, torch.from_numpy(x))
    return ((np.asarray(jy), {k: float(v) for k, v in jaux.items()}),
            (ty.numpy(), {k: float(v) for k, v in taux.items()}))


LAYER_CASES = {
    # tests/test_layers.py:209-260, and a top-2 pack that overflows
    "high-capacity": (dict(num_experts=4, top_k=2, d_ff=32,
                           capacity_factor=64.0), (2, 24, 16)),
    "capacity-drops": (dict(num_experts=4, top_k=1, d_ff=32,
                            capacity_factor=0.25), (1, 32, 16)),
    "dense-residual": (dict(num_experts=4, top_k=1, d_ff=32, dense_ff=32),
                       (2, 8, 16)),
    "top2-overflow": (dict(num_experts=4, top_k=2, d_ff=32,
                           capacity_factor=0.5), (2, 40, 16)),
}


@pytest.mark.parametrize("impl", ["dispatch", "ragged"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax(jx, case, impl):
    kw, shape = LAYER_CASES[case]
    cfg, jcfg, p = _layer(jx, shape[-1], impl=impl, **kw)
    (jy, jaux), (ty, taux) = _both(jx, cfg, jcfg, p, _x(shape))
    np.testing.assert_allclose(ty, jy, **LAYER_TOL)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-5, err_msg=k)


def test_dispatch_equals_dropless_at_high_capacity(jx):
    kw, shape = LAYER_CASES["high-capacity"]
    cfg, _, p = _layer(jx, 16, **kw)
    x = torch.from_numpy(_x(shape))
    y_d, aux_d = TMoE.moe_fwd(_t(p), cfg, x)
    y_r, aux_r = TMoE.moe_fwd(_t(p), dataclasses.replace(
        cfg, impl="ragged", capacity_factor=1.25), x)
    torch.testing.assert_close(y_d, y_r, **LAYER_TOL)
    torch.testing.assert_close(aux_d["moe_lb_loss"], aux_r["moe_lb_loss"],
                               rtol=1e-5, atol=0.0)


def test_capacity_drops_tokens(jx):
    """At cf 0.25 some tokens are dropped: the output differs from the
    dropless one."""
    kw, shape = LAYER_CASES["capacity-drops"]
    cfg, _, p = _layer(jx, 16, **kw)
    x = torch.from_numpy(_x(shape))
    y_low, _ = TMoE.moe_fwd(_t(p), cfg, x)
    y_free, _ = TMoE.moe_fwd(_t(p), dataclasses.replace(cfg, impl="ragged"), x)
    assert float((y_low - y_free).abs().max()) > 1e-4


def test_dense_residual_is_built_and_finite(jx):
    kw, shape = LAYER_CASES["dense-residual"]
    cfg, _, p = _layer(jx, 16, **kw)
    assert "dense" in p
    y, _ = TMoE.moe_fwd(_t(p), cfg, torch.from_numpy(_x(shape)))
    assert y.shape == shape and bool(torch.isfinite(y).all())
    tp = TMoE.init_moe(torch.Generator().manual_seed(0), 16, cfg, 2)
    assert set(tp["dense"]) == {"w_up", "w_down", "w_gate"}
    assert tuple(tp["we_down"]().shape) == (2, 4, 32, 16)


@pytest.mark.parametrize("e", [2, 4, 8])
def test_moe_gates_convexity(jx, e):
    """With identical experts and k = 2 (renormalised gates sum to 1) the
    dropless MoE equals the single expert's MLP (tests/test_layers.py's
    invariant, which holds JAX's side)."""
    cfg, _, p = _layer(jx, 8, num_experts=e, top_k=2, d_ff=16, impl="ragged")
    for nm in ("we_gate", "we_up", "we_down"):
        p[nm] = np.broadcast_to(p[nm][:1], p[nm].shape).copy()
    x = torch.from_numpy(_x((1, 8, 8)))
    y, _ = TMoE.moe_fwd(_t(p), cfg, x)
    ref = mlp_fwd({"w_gate": _t(p["we_gate"][0]), "w_up": _t(p["we_up"][0]),
                   "w_down": _t(p["we_down"][0])}, MLPCfg(d_ff=16), x)
    torch.testing.assert_close(y, ref, **LAYER_TOL)


def _dropped(idx, num_experts, C):
    """Which routing slots (B, S*k) land past capacity C."""
    onehot, pos = TMoE.slot_positions(idx, num_experts)
    return ((onehot == 1) & (pos >= C)).any(-1)


def test_overflowing_pack_drops_the_same_slots(jx):
    """The top-2 pack at cf 0.5 (capacity 10 for 40 tokens over 4
    experts): the slots past capacity, found from each side's routing
    (JAX's ``_route`` and the port's), are the same, and at least one is
    dropped; a token with both slots dropped gets no expert output."""
    kw, shape = LAYER_CASES["top2-overflow"]
    cfg, jcfg, p = _layer(jx, 16, **kw)
    x = _x(shape)
    Cap = TMoE.capacity(cfg, shape[1])
    assert Cap == 10
    _, jidx, _, _ = jx.JMoE._route(jx.jax.tree.map(jx.jnp.asarray, p), jcfg,
                                   jx.jnp.asarray(x))
    _, tidx, _, _ = TMoE._route(_t(p), cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    drop = _dropped(tidx, cfg.num_experts, Cap)
    want = _dropped(torch.from_numpy(np.array(jidx)), cfg.num_experts, Cap)
    assert torch.equal(drop, want) and int(drop.sum()) > 0
    y, _ = TMoE.moe_fwd(_t(p), cfg, torch.from_numpy(x))
    both = drop.reshape(shape[0], shape[1], 2).all(-1)
    if bool(both.any()):
        assert float(y[both].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["high-capacity", "top2-overflow",
                                  "dense-residual"])
def test_dropless_captured_form_equals_eager(jx, case, monkeypatch):
    """The dropless path's two forms: the per-expert products (eager, the
    group sizes read on the host) and the dispatch at capacity T that a
    CUDA graph captures, forced here on the CPU: outputs at 1e-5, aux
    losses equal."""
    kw, shape = LAYER_CASES[case]
    cfg, _, p = _layer(jx, shape[-1], **{**kw, "impl": "ragged"})
    x = torch.from_numpy(_x(shape))
    eager, aux_e = TMoE.moe_fwd(_t(p), cfg, x)
    monkeypatch.setattr(TMoE, "_capturing", lambda: True)
    cap, aux_c = TMoE.moe_fwd(_t(p), cfg, x)
    torch.testing.assert_close(cap, eager, rtol=1e-5, atol=1e-5)
    for k in aux_e:
        assert torch.equal(aux_c[k], aux_e[k]), k


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_breaks_ties_as_jax_top_k(jx, k):
    """A zero router gives every expert the same probability: JAX's
    ``top_k`` picks the lowest indices, and so does the port."""
    cfg, jcfg, p = _layer(jx, 8, num_experts=6, top_k=k, d_ff=8)
    p["router"] = np.zeros_like(p["router"])
    x = _x((2, 5, 8))
    _, jidx, _, _ = jx.JMoE._route(p, jcfg, jx.jnp.asarray(x))
    gates, tidx, _, _ = TMoE._route(_t(p), cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert bool((tidx == torch.arange(k)).all())
    torch.testing.assert_close(gates.sum(-1), torch.full((2, 5), 1.0 if k > 1
                                                         else 1 / 6))


# ---------------------------------------------------------------------------
# The models


def _load(arch, **replace):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro.serve.reference import ReferenceEngine as JaxReference

    cfg = get_config(arch, smoke=True).replace(dtype="float32", **replace)
    tcfg = tget(arch, smoke=True).replace(dtype="float32", **replace)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(np.asarray, jp)
    tp = bridge.params_from_numpy(np_params, tcfg, "cpu")
    # JAX's step functions jitted (cfg static): a compile per shape costs
    # less than running their ops one by one
    jit = lambda f, *names: jax.jit(f, static_argnums=1,  # noqa: E731
                                    static_argnames=names)
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, JM=JM, Engine=JaxEngine,
        Reference=JaxReference, arch=arch, cfg=cfg, tcfg=tcfg, jp=jp, tp=tp,
        np_params=np_params,
        ragged_step=jit(JM.ragged_step, "width", "flash_decode"),
        paged_step=jit(JM.paged_step, "with_logits", "flash_decode"),
        prefill=jit(JM.prefill), decode_step=jit(JM.decode_step))


@pytest.fixture(scope="module", params=ARCHS)
def moe_model(request):
    return _load(request.param)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def test_init_params_lays_out_like_jax(moe_model):
    """The port's own init has JAX's leaves and shapes (``ffn.router``,
    ``ffn.we_*``, ``ffn.dense.*``); the serving layout keeps the router
    float32 beside bf16 experts, the training layout every leaf in the
    parameter dtype."""
    m = moe_model
    want = {k: v.shape for k, v in _flat(m.np_params).items()}
    cfg = tget(m.arch, smoke=True)
    serving = TM.init_params(cfg.replace(dtype="bfloat16"), device="cpu")
    got = {k: v.shape for k, v in
           _flat(bridge.params_to_numpy(serving, cfg)).items()}
    assert got == want
    for name, p in serving.named_parameters():
        leaf = name.split(".")[-1]
        f32 = leaf in ("router", "scale")
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    training = TM.init_params(cfg, device="cpu", for_training=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in training.parameters())


def test_init_casts_each_leaf_as_it_is_drawn():
    """``cast_leaves`` draws a callable leaf only when it reaches it and
    casts it at once: the float32 draw of one leaf is gone before the next
    leaf is drawn (the init's peak is one float32 leaf)."""
    import weakref

    live = []

    def draw(i):
        def make():
            assert all(r() is None for r in live), "a float32 draw is alive"
            t = torch.full((4,), float(i))
            live.append(weakref.ref(t))
            return t
        return make

    out = TT.cast_leaves({"w_up": draw(1), "dense": {"w_down": draw(2)},
                          "router": draw(3)}, torch.bfloat16, False, ("ffn",))
    assert out["w_up"].dtype == out["dense"]["w_down"].dtype == torch.bfloat16
    assert out["router"].dtype == torch.float32 and len(live) == 3


def _compare_trees(got, want, rtol, atol_frac):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        a = atol_frac * float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=a,
                                   err_msg=name)


@pytest.fixture(scope="module")
def jax_grads(moe_model):
    """JAX's logits, loss, metrics and gradients at 48 positions."""
    from repro.configs.base import ShapeCfg
    from repro.data.pipeline import SyntheticLMData

    m = moe_model
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
def test_forward_loss_and_grads_match_jax(moe_model, jax_grads, remat):
    """Logits, loss (the cross entropy plus the real aux losses under their
    weights) and every gradient leaf — the router's through the aux losses
    and the gates — against ``jax.value_and_grad``."""
    m = moe_model
    batch, want_logits, want_loss, want_mets, want_grads = jax_grads
    tcfg = m.tcfg.replace(remat=remat)
    params = bridge.params_from_numpy(m.np_params, tcfg, "cpu",
                                      for_training=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = TM.forward(params, tcfg, tb)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    loss, mets = TM.loss_fn(params, tcfg, tb)
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    assert set(mets) == set(want_mets)
    for k in ("moe_lb_loss", "moe_z_loss", "ce_loss"):
        np.testing.assert_allclose(mets[k].item(), want_mets[k], rtol=1e-5,
                                   err_msg=k)
        assert want_mets[k] > 0
    np.testing.assert_allclose(aux["moe_lb_loss"].item(),
                               want_mets["moe_lb_loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    _compare_trees(bridge.grads_to_numpy(params, grads, tcfg), want_grads,
                   rtol=1e-4, atol_frac=1e-5)


# ---------------------------------------------------------------------------
# On the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["dispatch", "ragged"])
def test_cuda_moe_fwd_matches_cpu(impl):
    """``moe_fwd`` on CUDA against the same function on the CPU, float32
    (TF32 off), arctic-smoke's layer with a dense residual; for the
    dropless impl also captured in a CUDA graph (the dispatch at capacity
    T) against eager (the per-expert products)."""
    _card()
    cfg = MoECfg(num_experts=8, top_k=2, d_ff=96, dense_residual=MLPCfg(d_ff=96),
                 impl=impl)
    p = TMoE.init_moe(torch.Generator().manual_seed(0), 64, cfg, 1)
    p = {k: ({n: f()[0] for n, f in v.items()} if isinstance(v, dict)
             else v()[0]) for k, v in p.items()}
    x = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(1))
    want, aux_w = TMoE.moe_fwd(p, cfg, x)
    pc = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
              else v.cuda()) for k, v in p.items()}
    xc = x.cuda()
    got, aux_g = TMoE.moe_fwd(pc, cfg, xc)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for k in aux_w:
        torch.testing.assert_close(aux_g[k].cpu(), aux_w[k], rtol=1e-5, atol=0.0)
    if impl == "ragged":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            TMoE.moe_fwd(pc, cfg, xc)  # warm-up off the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = TMoE.moe_fwd(pc, cfg, xc)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, got, rtol=1e-5, atol=1e-5)


def _train_losses(cfg, device, steps=3):
    """Losses of ``steps`` training steps on ``device`` from the same
    CPU-drawn seed-0 weights and the same batches."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.adamw import AdamWCfg, init_opt_state
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.train_step import make_train_step

    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu", for_training=True).to(device)
    opt = AdamWCfg()
    state = {"params": params, "opt": init_opt_state(params, opt)}
    step = make_train_step(cfg, opt, warmup_cosine(3e-4, 1, 10))
    data = SyntheticLMData(cfg, ShapeCfg("t", 32, 2, "train"), 0)
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(i).items()}
        state, mets = step(state, batch)
        losses.append(float(mets["loss"]))
    return losses


@pytest.mark.gpu
def test_cuda_llama4_training_matches_cpu():
    """Three training steps of llama4-smoke (float32) on the card: finite
    losses equal to the CPU's at 1e-4."""
    _card()
    cfg = tget(ARCHS[0], smoke=True).replace(dtype="float32")
    want = _train_losses(cfg, "cpu")
    got = _train_losses(cfg, "cuda")
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _card_pack(kvH, G, kv_dtype, seed=0):
    """A mixed pack at (kvH, G, hd 128): decode tokens of slots 0-3 at
    lengths up to 1024, a 40-token chunk of slot 4, an invalid tail; bf16
    q; pools mapped in shuffled page order, the rest the sentinel."""
    from repro_torch.kernels import ops as tops

    rng = np.random.RandomState(seed)
    hd, page, pps, nslots, T = 128, 16, 64, 5, 64
    n_pages = nslots * pps
    fills = [1023, 700, 300, 17]
    lens = [f + 1 for f in fills] + list(range(501, 541))
    slot = list(range(4)) + [4] * 40
    lens += [0] * (T - len(lens))
    slot += [0] * (T - len(slot))
    perm = rng.permutation(n_pages)
    ptab = np.full((nslots, pps), n_pages, np.int32)
    for b, n in enumerate([f + 1 for f in fills] + [540]):
        used = -(-n // page)
        ptab[b, :used] = perm[b * pps:b * pps + used]
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, page, kvH, hd)).astype(np.float32)).cuda() for _ in range(2))
    ks = vs = None
    if kv_dtype == "int8":
        kp, ks = tops.quantize_kv(kp)
        vp, vs = tops.quantize_kv(vp)
    dt = getattr(torch, kv_dtype)
    q = torch.from_numpy(rng.standard_normal((T, kvH, G, hd)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    cuda = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")  # noqa: E731
    return (q, kp.to(dt), vp.to(dt), torch.from_numpy(ptab).cuda(), cuda(slot),
            cuda(lens), ks, vs)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("heads", [(8, 5), (8, 8)], ids=["llama4", "jamba"])
def test_cuda_ragged_kernel_at_moe_head_layouts(heads, kv_dtype):
    """Kernel 1 at llama4's (40 query heads over 8 KV heads: G 5) and
    jamba's (64 over 8: G 8) layouts at hd 128, bf16 q over bf16 and int8
    pools, through ``mma``: atol 2e-2 (compared in float32), each output
    row within 1e-2 of its norm, ``lens == 0`` rows zero."""
    _card()
    from repro_torch.kernels import ragged_paged_flash as rpf

    q, kp, vp, ptab, slot, lens, ks, vs = _card_pack(*heads, kv_dtype)
    assert rpf.ragged_variant(q.dtype, kp.dtype, 128) == "mma"
    rpf.reset_launches()
    got = rpf.ragged_paged_flash(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    torch.cuda.synchronize()
    assert rpf.launches == rpf.launches_by_variant["mma"] == 1
    want = rpf.ragged_paged_flash_ref(q, kp, vp, ptab, slot, lens, ks=ks, vs=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0, atol=2e-2)
    live = lens > 0
    d = (got[live].float() - want[live].float()).norm(dim=-1)
    assert float((d / want[live].float().norm(dim=-1)).max()) <= 1e-2
    assert bool((got[~live] == 0).all())

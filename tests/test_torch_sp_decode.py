"""Sequence-parallel decode of the PyTorch port against the JAX package,
on gloo rank processes.

- ``serve.decode_attention.sp_flash_decode`` at 4 ranks on a (2, 2)
  ("data", "model") mesh: under ``make_rules(decode=True)`` (batch over
  'data', the KV sequence over 'model') and ``make_rules(long_ctx=True)``
  (batch 1, the sequence over both axes), with and without a window, each
  rank holding its shard of q, k, v and k_pos; the ranks' outputs equal
  JAX's local ``_partial_terms`` result on the inputs of
  tests/test_multidevice.py::test_sp_flash_decode_matches_local, at
  rtol = atol = 1e-5.
- ``attention_decode(sp_decode=True)`` without a mesh equals JAX's and the
  port's ``sp_decode=False`` (1e-5).
- Under a 2-rank ("model",) sequence mesh, four lock-step decode tokens of
  qwen2-1.5b smoke (``model.decode_step(sp_decode=True)``, each rank
  holding half of every 4-entry cache) equal the run without a mesh at
  1e-5.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _torch_tp_ranks as R  # noqa: E402
from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.launch.ranks import run_ranks  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.models.layers import attention as JA
    from repro.serve.decode_attention import _partial_terms

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config,
                                 M=JM, A=JA, partial=_partial_terms)


def _case(jx, window):
    """tests/test_multidevice.py's inputs and JAX's local result."""
    jax, jnp = jx.jax, jx.jnp
    B, T, kvH, G, hd = 4, 64, 2, 3, 16
    q = jax.random.normal(jax.random.PRNGKey(0), (B, 1, kvH, G, hd), jnp.float32)
    k = jax.random.normal(jax.random.PRNGKey(1), (B, T, kvH, hd), jnp.float32)
    v = jax.random.normal(jax.random.PRNGKey(2), (B, T, kvH, hd), jnp.float32)
    k_pos = jnp.arange(T)
    pos = jnp.asarray(40)
    m, l, o = jx.partial(q, k, v, k_pos, pos, window)
    want = (o / jnp.maximum(l, 1e-30)[..., None])[:, None]
    case = {"q": np.asarray(q), "k": np.asarray(k), "v": np.asarray(v),
            "k_pos": np.asarray(k_pos, np.int32), "pos": 40, "window": window}
    return case, np.asarray(want)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("rules", [{"decode": True}, {"long_ctx": True}],
                         ids=["decode", "long_ctx"])
def test_sp_flash_decode_matches_jax_local(jx, rules, window):
    case, want = _case(jx, window)
    if "long_ctx" in rules:  # batch 1: the sequence takes every axis
        case = {**case, **{n: case[n][:1] for n in ("q", "k", "v")}}
        want = want[:1]
    got = run_ranks("_torch_tp_ranks:sp_decode_rank", 4,
                    (case, rules, (2, 2), ("data", "model")), device="cpu")
    for out, (b0, b1) in got:
        np.testing.assert_allclose(out, want[b0:b1], **TOL)
    # every batch row was computed by some rank
    assert sorted({b for _, (b0, b1) in got for b in range(b0, b1)}) == \
        list(range(want.shape[0]))


@pytest.mark.parametrize("window", [None, 24])
def test_attention_decode_sp_without_a_mesh(jx, window):
    """The layer's ``sp_decode=True`` without a mesh: JAX's result (its
    local ``sp_flash_decode``) and the port's ``sp_decode=False``."""
    from repro_torch import bridge
    from repro_torch.configs import get_config as tget
    from repro_torch.models.layers import attention as TA
    from repro_torch.models.transformer import layer_view

    cfg = jx.get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    attn = dataclasses.replace(cfg.stages[0].pattern[0].attn, window=window)
    tattn = dataclasses.replace(tcfg.stages[0].pattern[0].attn, window=window)
    jp = jx.M.init_params(jx.jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jmix = jx.jax.tree.map(lambda a: a[0], jp["stages"][0][0]["mixer"])
    tmix = layer_view(tp.stages[0][0], 0)["mixer"]
    rng = np.random.RandomState(0)
    B, cap, D = 2, 32, cfg.d_model
    jcache = jx.A.init_cache(attn, B, cap, jx.jnp.float32)
    tcaches = [{k: v[0] for k, v in TA.init_cache(tattn, B, cap,
                                                  torch.float32).items()}
               for _ in range(2)]
    for step in range(cap + 4):  # past one wrap of the buffer
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        jo, jcache = jx.A.attention_decode(jmix, attn, jx.jnp.asarray(x),
                                           jcache, sp_decode=True)
        sp, _ = TA.attention_decode(tmix, tattn, torch.from_numpy(x),
                                    tcaches[0], sp_decode=True)
        plain, _ = TA.attention_decode(tmix, tattn, torch.from_numpy(x),
                                       tcaches[1])
        np.testing.assert_allclose(sp.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(sp.numpy(), plain.numpy(), **TOL)


def test_lockstep_decode_on_a_sequence_mesh(jx):
    """Four ``decode_step(sp_decode=True)`` tokens on 2 ranks, each holding
    2 of every cache's 4 entries (positions 0-1 land on rank 0, 2-3 on
    rank 1), equal the run without a mesh."""
    cfg = jx.get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tree = jx.jax.tree.map(np.asarray,
                           jx.M.init_params(jx.jax.random.PRNGKey(0), cfg))
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 4))
    want = R.lockstep_rank("qwen2-1.5b", tree, 0, tokens, 4)
    for got in run_ranks("_torch_tp_ranks:lockstep_rank", 2,
                         ("qwen2-1.5b", tree, 2, tokens, 4), device="cpu"):
        np.testing.assert_allclose(got, want, **TOL)

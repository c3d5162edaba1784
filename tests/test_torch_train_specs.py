"""The port's training layout rules against the JAX package's, in one
process (no ranks), at FULL size:

- ``PARAM_AXES`` equals JAX's, entry for entry;
- ``param_specs`` equals JAX's ``param_specs`` leaf by leaf for every arch
  of the registry, with the default rules and with ``heads_tp=True``, on
  a (4, 2) ("data", "model") stand-in mesh (JAX's rule functions read only
  ``axis_names`` and ``shape``).  The port builds its shapes on the
  ``meta`` device, JAX with ``jax.eval_shape``.  A port stage leaf always
  carries the stacked layer axis: where JAX's leaf has none (a one-repeat
  stage), the port's spec is JAX's with None in front;
- ``train_state_specs`` equals JAX's with float32 and with int8 moments
  (qwen2-1.5b and llama4-maverick FULL);
- ``param_shardings`` gives each leaf its spec and a ``MeshView`` rank's
  slices; ``batch_specs`` splits the leading dim over the batch axes (a
  rank's rows, through ``shard_tensor``) and leaves a batch that does not
  divide whole.
"""
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_NAMES, get_config as tget  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.train.checkpoint import _param_keys  # noqa: E402


class StandIn(types.SimpleNamespace):
    """A (4, 2) mesh's names and sizes; JAX's ``use_mesh`` also enters it."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


MESH = StandIn(axis_names=("data", "model"), shape={"data": 4, "model": 2})


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.optim import adamw as JA
    from repro.parallel import sharding as JS
    from repro.train import train_step as JT

    return types.SimpleNamespace(jax=jax, get_config=get_config, M=JM, S=JS,
                                 A=JA, T=JT)


def meta_params(arch: str):
    with torch.device("meta"):
        return TM.init_params(tget(arch), generator=torch.Generator(),
                              device="meta", for_training=True)


def jax_specs(jx, tree):
    """{keystr path: spec tuple} of a JAX spec tree."""
    P = jx.jax.sharding.PartitionSpec
    flat = jx.jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jx.jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def port_vs_jax(port: dict, jax: dict, params):
    """Each port spec against JAX's at the same key: equal, or JAX's with
    None in front where JAX's leaf is unstacked."""
    assert len(port) == len(jax)
    for (key, unstack), (name, spec) in zip(_param_keys(params), port.items()):
        want = jax[key]
        assert spec == ((None,) + want if unstack else want), (name, spec, want)


def test_param_axes_equal_jax(jx):
    assert TS.PARAM_AXES == jx.S.PARAM_AXES


@pytest.mark.parametrize("heads_tp", [False, True], ids=["rules", "heads_tp"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_jax_full_size(jx, arch, heads_tp):
    cfg = jx.get_config(arch)
    shapes = jx.jax.eval_shape(
        lambda: jx.M.init_params(jx.jax.random.PRNGKey(0), cfg))
    want = jax_specs(jx, jx.S.param_specs(
        shapes, MESH, jx.S.make_rules(MESH, heads_tp=heads_tp)))
    params = meta_params(arch)
    got = TS.param_specs(params, MESH, TS.make_rules(MESH, heads_tp=heads_tp))
    port_vs_jax(got, {k[len("['params']"):] if k.startswith("['params']")
                      else k: v for k, v in want.items()}, params)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama4-maverick-400b-a17b"])
def test_train_state_specs_equal_jax(jx, arch, state_dtype):
    cfg = jx.get_config(arch)
    jopt = jx.A.AdamWCfg(state_dtype=state_dtype)
    shapes = jx.jax.eval_shape(
        lambda: jx.T.init_train_state(jx.jax.random.PRNGKey(0), cfg, jopt))
    with jx.S.use_mesh(MESH, jx.S.make_rules(MESH)):
        want = jax_specs(jx, jx.T.train_state_specs(shapes))
    params = meta_params(arch)
    with torch.device("meta"):
        opt = tadamw.init_opt_state(
            params, tadamw.AdamWCfg(state_dtype=state_dtype))
    state = {"params": params, "opt": opt}
    with TS.use_mesh(MESH):
        got = TT.train_state_specs(state)
    assert got["opt"]["step"] == () and want["['opt']['step']"] == ()
    keys = list(_param_keys(params))
    port_vs_jax(got["params"], {k[len("['params']"):]: v for k, v in
                                want.items() if k.startswith("['params']")},
                params)
    for kind in ("m", "v"):
        base = f"['opt']['{kind}']"
        for (key, unstack), spec in zip(keys, got["opt"][kind], strict=True):
            parts = ({"q": spec["q"], "qscale": spec["qscale"]}
                     if state_dtype == "int8" else {"": spec})
            for sub, s in parts.items():
                w = want[base + key + (f"['{sub}']" if sub else "")]
                assert s == ((None,) + w if unstack else w), (key, sub, s, w)


def test_param_shardings_and_batch_specs():
    params = meta_params("qwen2-1.5b")
    view = TS.MeshView((4, 2), ("data", "model"), (3, 1))
    place = TS.param_shardings(params, view, TS.make_rules(view))
    specs = TS.param_specs(params, view, TS.make_rules(view))
    for (name, p), (_, pl) in zip(params.named_parameters(), place.items()):
        assert pl.spec == specs[name]
        assert pl.slices == TS.local_slices(pl.spec, p.shape, view)
    emb = place["embed.tok_embed"]
    assert emb.spec == ("model", "data")
    V, D = params.embed["tok_embed"].shape
    assert emb.slices == (slice(V // 2, V), slice(3 * D // 4, D))
    rows = torch.arange(8)[:, None].expand(8, 4)
    b = {"tokens": rows, "labels": rows[:6]}
    with TS.use_mesh(view):
        got = TT.batch_specs(b)
        assert got == {"tokens": ("data", None),
                       "labels": (None, None)}  # 6 rows do not split 4 ways
        assert torch.equal(TS.shard_tensor(b["tokens"], got["tokens"]),
                           rows[6:8])
        assert TS.shard_tensor(b["labels"], got["labels"]) is b["labels"]
    assert TT.batch_specs(b)["tokens"] == (None, None)  # no mesh: whole

"""The port's layout rules, state specs, mesh and rank launcher against the
JAX package, on the CPU.

- ``parallel.sharding``: ``make_rules`` (each flag), ``make_serve_rules``,
  ``logical_spec`` and ``sanitize_spec`` equal JAX's on meshes (1,), (2,),
  (4,) ("model",), (4, 2) ("data", "model") and (2, 16, 16) ("pod",
  "data", "model").  JAX's functions read only a mesh's ``axis_names`` and
  ``shape``, so both packages get the same stand-in mesh.
- ``serve_step.decode_state_specs``: leaf for leaf against JAX's
  ``_state_leaf_spec`` over every smoke config's paged state (serve rules)
  and lock-step state (decode rules); a port leaf with the stacked layer
  axis JAX leaves out (a one-repeat stage) carries None there.  It also
  resolves, from shapes alone (meta tensors), for every FULL config.
- ``pool.kv_page_bytes(kv_shards=)`` equals JAX's.
- ``launch.mesh.make_mesh`` and ``launch.ranks.run_ranks``: a gloo mesh
  from an ``init_method`` in this process (a world of one) and over the
  launcher's group on 4 ranks; a world size that is not the mesh's raises; a
  ``cuda`` mesh raises where there is no card, and so does ``run_ranks``
  with no device named (it defaults to the card); a failing rank raises
  with its output.  The engine refuses a mesh of another device type.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import ARCH_NAMES, get_config as tget  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.ranks import RankFailure, run_ranks  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.serve import pool as TP  # noqa: E402
from repro_torch.serve import serve_step as TSS  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

MESHES = [((1,), ("model",)), ((2,), ("model",)), ((4,), ("model",)),
          ((4, 2), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
IDS = ["x".join(map(str, s)) for s, _ in MESHES]
RULE_FLAGS = [{}, {"heads_tp": True}, {"kv_seq_axis": ("model",)},
              {"decode": True}, {"long_ctx": True},
              {"decode": True, "kv_seq_axis": ("data",)}]


def stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 shape=dict(zip(axes, shape)))


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM
    from repro.parallel import sharding as JS
    from repro.serve import pool as JP
    from repro.serve import serve_step as JSS

    return types.SimpleNamespace(jax=jax, get_config=get_config, M=JM, S=JS,
                                 P=JP, SS=JSS)


@pytest.mark.parametrize("shape,axes", MESHES, ids=IDS)
def test_rules_equal_jax(jx, shape, axes):
    mesh = stand_in(shape, axes)
    for flags in RULE_FLAGS:
        assert TS.make_rules(mesh, **flags) == jx.S.make_rules(mesh, **flags), \
            flags
    assert TS.make_serve_rules(mesh) == jx.S.make_serve_rules(mesh)


@pytest.mark.parametrize("shape,axes", MESHES, ids=IDS)
def test_specs_equal_jax(jx, shape, axes):
    """``logical_spec`` of every state leaf's axes and ``sanitize_spec`` on
    shapes that divide, do not divide and divide in part."""
    mesh = stand_in(shape, axes)
    rule_sets = [TS.make_serve_rules(mesh)] + [TS.make_rules(mesh, **f)
                                               for f in RULE_FLAGS]
    names = list(TSS.STATE_AXES.values()) + [
        ("act_batch", "act_seq", "act_heads", "attn_hd"),
        ("fsdp", "tensor"), ("layer", "act_kv_seq", "act_kv_heads")]
    dims = [1, 2, 3, 4, 6, 8, 16, 20, 32, 64, 512]
    rng = np.random.RandomState(0)
    for rules in rule_sets:
        for axes_ in names:
            want = tuple(jx.S.logical_spec(axes_, rules))
            got = TS.logical_spec(axes_, rules)
            assert got == want, (axes_, got, want)
            used = {a for e in got if e for a in ((e,) if isinstance(e, str)
                                                  else e)}
            if not used <= set(axes):
                continue  # a rule naming an axis the mesh lacks (long_ctx)
            for _ in range(4):
                shp = tuple(int(d) for d in rng.choice(dims, len(axes_)))
                assert TS.sanitize_spec(got, shp, mesh) == tuple(
                    jx.S.sanitize_spec(jx.S.logical_spec(axes_, rules), shp,
                                       mesh)), (axes_, shp)


def _jax_specs(jx, state, rules, mesh):
    """{path: spec} of JAX's ``_state_leaf_spec`` over a JAX state."""
    leaves = jx.jax.tree_util.tree_flatten_with_path(state)[0]
    out = {}
    for path, leaf in leaves:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        out[key] = (tuple(jx.SS._state_leaf_spec(path, leaf, rules, mesh)),
                    leaf.ndim)
    return out


def _port_specs(specs, state, prefix=()):
    """{path: (spec, ndim)} over the port's spec tree and state."""
    if isinstance(state, dict):
        out = {}
        for k in state:
            out.update(_port_specs(specs[k], state[k], prefix + (k,)))
        return out
    if isinstance(state, list):
        out = {}
        for i, s in enumerate(state):
            out.update(_port_specs(specs[i], s, prefix + (i,)))
        return out
    return {prefix: (specs, state.ndim)}


def _assert_leafwise(port, want):
    assert port.keys() == want.keys()
    for key, (spec, ndim) in port.items():
        jspec, jndim = want[key]
        if ndim == jndim + 1:  # the port's stacked layer axis
            assert spec[0] is None, (key, spec)
            spec = spec[1:]
        assert spec == jspec, (key, spec, jspec)


@pytest.mark.parametrize("shape,axes", MESHES[1:], ids=IDS[1:])
def test_decode_state_specs_match_jax(jx, shape, axes):
    mesh = stand_in(shape, axes)
    serve, decode = TS.make_serve_rules(mesh), TS.make_rules(mesh, decode=True)
    checked = 0
    for arch in ARCH_NAMES:
        cfg = jx.get_config(arch, smoke=True)
        tcfg = tget(arch, smoke=True)
        jp = jx.jax.eval_shape(
            lambda: jx.M.init_params(jx.jax.random.PRNGKey(0), cfg))
        tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
        kinds = []
        try:
            TM.check_servable(tcfg)
            kinds.append(("paged", serve))
        except NotImplementedError:
            pass
        if not tcfg.is_encoder and tcfg.frontend != "vision":
            kinds.append(("lockstep", decode))
        for kind, rules in kinds:
            if kind == "paged":
                kw = dict(page_size=8, n_pages=12, window_extra=8,
                          kv_dtype="int8")
                js = jx.jax.eval_shape(lambda p: jx.M.init_paged_state(
                    p, cfg, 4, 64, **kw), jp)
                ts = TM.init_paged_state(tp, tcfg, 4, 64, **kw)
            else:
                js = jx.jax.eval_shape(
                    lambda p: jx.M.init_decode_state(p, cfg, 4, 64), jp)
                ts = TM.init_decode_state(tp, tcfg, 4, 64)
            with TS.use_mesh(mesh, rules):
                specs = TSS.decode_state_specs(ts)
            _assert_leafwise(_port_specs(specs, ts),
                             _jax_specs(jx, js, rules, mesh))
            checked += 1
    assert checked >= 15


def test_decode_state_specs_resolve_for_full_configs():
    """Every FULL config's paged state (serve rules) and lock-step state
    (decode rules) resolves from shapes alone on a (4, 2) mesh; paged
    pools split their heads where 'model' divides them."""
    mesh = stand_in((4, 2), ("data", "model"))
    for arch in ARCH_NAMES:
        cfg = tget(arch)
        dt = getattr(torch, cfg.dtype)
        try:
            TM.check_servable(cfg)
            state = {"layers": [tfm.init_stage_state_paged(
                cfg, st, 8, 256, dt, page_size=16, n_pages=128,
                window_extra=32, kv_dtype="int8", device="meta")
                for st in cfg.stages]}
            with TS.use_mesh(mesh, TS.make_serve_rules(mesh)):
                specs = TSS.decode_state_specs(state)
            for st, ss, sp in zip(cfg.stages, state["layers"],
                                  specs["layers"]):
                for blk, c, s in zip(st.pattern, ss, sp):
                    if "kp" in c:
                        split = blk.attn.num_kv_heads % 2 == 0
                        assert s["kp"][3] == ("model" if split else None)
        except NotImplementedError:
            pass
        if cfg.is_encoder or cfg.frontend == "vision":
            continue
        state = {"layers": [tfm.init_stage_state(
            None, cfg, st, 8, 256, dt, device="meta") for st in cfg.stages],
            "pos": torch.zeros((), dtype=torch.int32, device="meta")}
        with TS.use_mesh(mesh, TS.make_rules(mesh, decode=True)):
            TSS.decode_state_specs(state)


def test_kv_page_bytes_per_shard_match_jax(jx):
    for arch in ARCH_NAMES:
        cfg, tcfg = jx.get_config(arch, smoke=True), tget(arch, smoke=True)
        for kvd in ("float32", "bfloat16", "int8"):
            for n in (1, 2, 4):
                assert TP.kv_page_bytes(tcfg, 8, kvd, n) == \
                    jx.P.kv_page_bytes(cfg, 8, kvd, n), (arch, kvd, n)


def test_local_state_slices_each_leaf():
    """A rank's ``local_state`` is its block of every leaf, by the leaf's
    sanitized spec (the lock-step cache's sequence under decode rules)."""
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    state = TM.init_decode_state(tp, tcfg, 2, 64)
    for leaf in ("k", "v"):
        state["layers"][0][0][leaf].normal_()
    for r in range(4):
        view = TS.MeshView((2, 2), ("data", "model"), (r // 2, r % 2))
        rules = TS.make_rules(view, decode=True)
        local = TSS.local_state(state, view, rules)
        c, lc = state["layers"][0][0], local["layers"][0][0]
        b, s = slice(r // 2, r // 2 + 1), slice(32 * (r % 2), 32 * (r % 2 + 1))
        assert torch.equal(lc["k"], c["k"][:, b, s])
        spec = TSS.decode_state_specs(state, rules)["layers"][0][0]["k"]
        assert TS.local_shape(spec, c["k"].shape, view) == tuple(lc["k"].shape)
        assert torch.equal(lc["k_pos"], c["k_pos"][:, s])
        assert torch.equal(local["pos"], state["pos"])


def test_mesh_from_an_init_method(tmp_path, monkeypatch):
    """``make_mesh`` starts gloo from ``init_method`` when no group runs
    (here in this process, a world of one over a ``file://`` store) and
    reads the mesh as JAX's rules do."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    try:
        mesh = make_mesh((1,), ("model",), device="cpu",
                         init_method=f"file://{tmp_path / 'store'}")
        assert dist.get_backend() == "gloo"
        assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
        assert TS.axis_sizes(mesh) == {"model": 1}
        assert TS.axis_coordinate(mesh, "model") == 0
        t = torch.tensor([3.0])
        dist.all_reduce(t, group=TS.axis_group(mesh, "model"))
        assert float(t) == 3.0
    finally:
        dist.destroy_process_group()


def test_mesh_over_the_launchers_group():
    """On 4 launched ranks ``make_mesh`` builds a (2, 2) mesh over the
    running group: coordinates, sizes, a gather over 'model' and a sum
    over both axes (a built group)."""
    got = run_ranks("_torch_tp_ranks:mesh_rank", 4, ((2, 2), ("data", "model")),
                    device="cpu")
    assert [g["rank"] for g in got] == [0, 1, 2, 3]
    assert [g["coord"] for g in got] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert all(g["sizes"] == {"data": 2, "model": 2} for g in got)
    assert all(g["backend"] == "gloo" for g in got)
    assert [g["model_gather"] for g in got] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert all(g["both_sum"] == 6 for g in got)


def test_mesh_size_must_be_the_world():
    with pytest.raises(RankFailure, match="needs 3 ranks, the job has 2"):
        run_ranks("_torch_tp_ranks:mesh_rank", 2, ((3,), ("model",)),
                  device="cpu")


def test_cuda_mesh_needs_a_card_per_rank(monkeypatch):
    """No card (or fewer than ranks) raises before any group starts: NCCL
    refuses two ranks on one card and nothing drops to the CPU."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks, 1 devices"):
        make_mesh((2,), ("model",), device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="one CUDA device per rank"):
        make_mesh((2,), ("model",))


def test_run_ranks_defaults_to_the_card(monkeypatch):
    """With no device named, ``run_ranks`` asks for the card (NCCL, one
    card a rank) and raises before any rank starts where there are fewer
    cards than ranks, naming the device; nothing drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"device 'cuda' needs one CUDA "
                       r"device per rank: 2 ranks, 0 devices"):
        run_ranks("_torch_tp_ranks:mesh_rank", 2, ((2,), ("model",)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks, 1 devices"):
        run_ranks("_torch_tp_ranks:mesh_rank", 2, ((2,), ("model",)))


def test_a_failing_rank_raises_with_its_output():
    """Rank 1 raises; rank 0, waiting for it at the exit barrier, is stopped
    or fails on the lost peer, whichever comes first."""
    with pytest.raises(RankFailure, match=r"ranks \[(0, )?1\] failed(.|\n)*"
                       r"rank 1 says no"):
        run_ranks("_torch_tp_ranks:fail_on_rank", 2, (1,), device="cpu")


def test_engine_refuses_a_mesh_of_another_device():
    tcfg = tget("qwen2-1.5b", smoke=True).replace(dtype="float32")
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    mesh = types.SimpleNamespace(axis_names=("model",), shape={"model": 2},
                                 device_type="cuda")
    with pytest.raises(ValueError, match="cuda mesh cannot serve on cpu"):
        ServeEngine(tp, tcfg, device="cpu", mesh=mesh)


def test_axis_rules_override_inside_a_mesh():
    mesh = stand_in((2, 2), ("data", "model"))
    assert TS.current_mesh() is None and TS.current_rules() == {}
    with TS.use_mesh(mesh):
        assert TS.current_rules() == TS.make_rules(mesh)
        with TS.axis_rules({"act_kv_seq": ("data", "model")}):
            assert TS.current_mesh() is mesh
            assert TS.current_rules()["act_kv_seq"] == ("data", "model")
            assert TS.current_rules()["act_batch"] == ("data",)
        assert TS.current_rules()["act_kv_seq"] is None
    assert TS.current_mesh() is None

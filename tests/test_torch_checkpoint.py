"""Checkpoint/resume and failure recovery in the port, and checkpoints
shared with the JAX package, on the CPU.

The qwen2-1.5b smoke config (one stacked stage) in float32, and the
llama-3.2-vision smoke config (frontend, cross layers) for the key layout:

- a save/restore round trip is exact, with float32 and int8 moments and
  with bf16 parameters (stored as 16-bit patterns);
- the keys are JAX's ``keystr`` paths of its train state, leaf for leaf;
- 12 straight steps equal 6 steps + restart + 6 (losses at rtol 1e-5, the
  bound of tests/test_train.py);
- a failing step restores the last checkpoint and replays (the failures
  of tests/test_train.py's ``test_failure_recovery``), and the replayed
  losses equal the straight run's at rtol 1e-5; without a checkpoint
  directory, past ``max_retries`` and on ``FloatingPointError`` the
  failure propagates;
- a checkpoint written by JAX's ``TrainLoop`` restores in the port's, and
  one written by the port's in JAX's: the continued losses match JAX's
  straight run at rtol = atol = 1e-4, with float32 and int8 moments;
- the background writer saves the state as it was when
  ``save_checkpoint`` returned, not as the next in-place step left it;
- a restore onto a mesh (``mesh=``, ``specs=``) gives a ``MeshView``
  rank's sharded state exactly its slice of each logical array.

JAX is imported lazily.
"""
import json
import shutil
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import ShapeCfg as TShape  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.optim.adamw import AdamWCfg  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train.loop import TrainLoop  # noqa: E402

TINY = TShape("tiny", 32, 8, "train")
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(**kw):
    return tget("qwen2-1.5b", smoke=True).replace(dtype="float32", **kw)


def _leaves(state):
    return {k: t.detach().clone() for k, (t, _) in C.flatten_state(state).items()}


def _loop(d=None, **kw):
    kw.setdefault("total_steps", 50)
    kw.setdefault("lr", 1e-3)
    return TrainLoop(kw.pop("cfg", _cfg()), TINY, ckpt_dir=d, device="cpu", **kw)


@pytest.mark.parametrize("state_dtype,param_dtype", [
    ("float32", "float32"), ("int8", "float32"), ("float32", "bfloat16"),
    ("int8", "bfloat16")])
def test_roundtrip_is_exact(tmp_path, state_dtype, param_dtype):
    loop = _loop(cfg=_cfg(param_dtype=param_dtype),
                 opt_cfg=AdamWCfg(state_dtype=state_dtype))
    loop.run(2)  # moments and parameters away from their init
    state = loop.final_state
    C.save_checkpoint(tmp_path, state, 7)
    assert C.latest_step(tmp_path) == 7
    fresh, _ = _loop(cfg=_cfg(param_dtype=param_dtype),
                     opt_cfg=AdamWCfg(state_dtype=state_dtype)).init_or_restore()
    before = _leaves(state)
    C.restore_checkpoint(tmp_path, fresh)
    after = _leaves(fresh)
    assert before.keys() == after.keys()
    for k in before:
        assert after[k].dtype == before[k].dtype, k
        assert torch.equal(after[k], before[k]), k
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    bf16 = {k for k, v in manifest["keys"].items() if v["dtype"] == "bfloat16"}
    assert bool(bf16) == (param_dtype == "bfloat16")
    assert all(k.startswith("['params']") for k in bf16)


def test_keys_are_jax_keystr_paths(tmp_path):
    """The port's keys for the vision config with int8 moments are JAX's
    ``keystr`` paths of its own train state, and the shapes agree."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.optim.adamw import AdamWCfg as JOpt
    from repro.train.train_step import init_train_state

    cfg = get_config("llama-3.2-vision-11b", smoke=True)
    jstate = init_train_state(jax.random.PRNGKey(0), cfg, JOpt(state_dtype="int8"))
    want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    loop = TrainLoop(tget("llama-3.2-vision-11b", smoke=True), TINY, device="cpu",
                     opt_cfg=AdamWCfg(state_dtype="int8"))
    state, _ = loop.init_or_restore()
    C.save_checkpoint(tmp_path, state, 0)
    manifest = json.loads((tmp_path / "step_00000000" / "manifest.json").read_text())
    got = {k: tuple(v["shape"]) for k, v in manifest["keys"].items()}
    assert got == want
    assert "['params']['stages'][0][1]['mixer']['wq']" in got
    assert "['opt']['m']['frontend']['frontend_proj']['qscale']" in got


def test_gc_keeps_the_newest_three_and_mesh_restore_is_not_ported(tmp_path):
    state, _ = _loop().init_or_restore()
    for step in (1, 2, 3, 4, 5):
        C.save_checkpoint(tmp_path, state, step)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004", "step_00000005"]
    assert C.latest_step(tmp_path) == 5
    assert C.latest_step(tmp_path / "none") is None
    # restoring onto a mesh (ported with multi-GPU training) keeps the
    # rank's slice of each logical array: rank (1, 0) of a (2, 1) mesh
    from repro_torch.parallel import sharding as TS
    from repro_torch.train import train_step as TT

    view = TS.MeshView((2, 1), ("data", "model"), (1, 0))
    with TS.use_mesh(view):
        shard = TT.shard_state(_loop().init_or_restore()[0])
    for t in C.flatten_state(shard).values():
        t[0].data.zero_()
    C.restore_checkpoint(tmp_path, shard, mesh=view, specs=shard["specs"])
    whole = C.flatten_state(state)
    split = 0
    for key, t, _, spec in C.walk_state(shard, shard["specs"]):
        want = whole[key][0]
        want = want[TS.local_slices(spec, want.shape, view)]
        split += t.shape != whole[key][0].shape
        assert t.shape == want.shape and torch.equal(t, want), key
    assert split > 0
    with pytest.raises(FileNotFoundError):
        C.restore_checkpoint(tmp_path / "none", state)


def test_sharded_save_outside_its_mesh_raises(tmp_path):
    """A sharded state saved with no ambient mesh would have every rank
    write its own shards as the logical arrays into one directory: it
    raises, as ``reshard_state`` does, and writes nothing."""
    from repro_torch.parallel import sharding as TS
    from repro_torch.train import train_step as TT

    view = TS.MeshView((2, 1), ("data", "model"), (1, 0))
    with TS.use_mesh(view):
        shard = TT.shard_state(_loop().init_or_restore()[0])
    with pytest.raises(ValueError, match="its own mesh"):
        C.save_checkpoint(tmp_path, shard, 1)
    assert not tmp_path.exists() or not any(tmp_path.iterdir())


def test_resume_is_deterministic(tmp_path):
    """12 straight steps == 6 steps + restart + 6 steps."""
    straight = _loop(tmp_path / "a", save_every=100).run(12)
    _loop(tmp_path / "b", save_every=6).run(6)
    resumed = _loop(tmp_path / "b", save_every=6).run(12)
    assert [r["step"] for r in resumed] == list(range(6, 12))
    np.testing.assert_allclose([r["loss"] for r in resumed],
                               [r["loss"] for r in straight[6:]], rtol=1e-5)


def test_failure_recovery_restores_and_replays(tmp_path):
    calls = {"n": 0}

    def chaos(step):
        if step in (7, 9) and calls["n"] < 2:
            calls["n"] += 1
            raise RuntimeError("injected failure")

    h = _loop(tmp_path / "f", save_every=5, failure_hook=chaos).run(12)
    assert h[-1]["step"] == 11 and calls["n"] == 2
    # step 7 fails twice (both failures are spent there): each time the
    # loop restores step 5 and replays 5, 6
    assert [r["step"] for r in h] == (list(range(7)) + [5, 6]
                                      + list(range(5, 12)))
    straight = {r["step"]: r["loss"] for r in _loop(tmp_path / "s").run(12)}
    np.testing.assert_allclose([r["loss"] for r in h],
                               [straight[r["step"]] for r in h], rtol=1e-5)


def test_failures_propagate_without_checkpoints_or_retries(tmp_path):
    def always(step):
        if step == 2:
            raise RuntimeError("injected failure")

    with pytest.raises(RuntimeError, match="injected"):
        _loop(failure_hook=always).run(4)
    with pytest.raises(RuntimeError, match="injected"):
        _loop(tmp_path / "r", save_every=1, max_retries=2,
              failure_hook=always).run(4)

    def nan(step):
        raise FloatingPointError("injected NaN")

    with pytest.raises(FloatingPointError):
        _loop(tmp_path / "n", failure_hook=nan).run(2)


def _jax_loop(cfg, d, opt, **kw):
    from repro.configs.base import ShapeCfg
    from repro.optim.adamw import AdamWCfg as JOpt
    from repro.train.loop import TrainLoop as JLoop

    return JLoop(cfg, ShapeCfg("tiny", 32, 8, "train"), ckpt_dir=d,
                 opt_cfg=JOpt(state_dtype=opt), total_steps=50, lr=1e-3, **kw)


@pytest.mark.parametrize("opt", ["float32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer, opt):
    """3 steps by ``writer``'s loop from JAX's seed-0 state (the port's
    loop restores it from JAX's checkpoint of step 0), then 3 more by the
    other package's loop resuming from ``writer``'s checkpoint of step 3,
    against ``writer``'s straight 6 steps: every loss at rtol = atol =
    1e-4, and with float32 moments also against JAX's straight run.  The
    reader's restored state equals what the writer saved, bit for bit.
    (With int8 moments the port's and JAX's own 3 steps part by more than
    1e-4 in this run's rising loss: requantization turns float-order
    differences in the gradients into one-level moment differences, 253
    of 214,144 entries after 3 steps; so the int8 arms hold each
    continuation against its writer's straight run.)"""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.train import checkpoint as JC

    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32")
    d = tmp_path / "ck"
    JC.save_checkpoint(d / "init", _jax_loop(cfg, None, opt).init_or_restore()[0], 0)

    def port_loop(path, **kw):
        return _loop(path, opt_cfg=AdamWCfg(state_dtype=opt), **kw)

    def run(package, path, steps, **kw):
        if package == "jax":
            loop = _jax_loop(cfg, str(path), opt, **kw)
        else:
            if not path.exists():  # start from JAX's seed-0 state
                shutil.copytree(d / "init", path)
            loop = port_loop(path, **kw)
        return loop, [r["loss"] for r in loop.run(steps)]

    reader = "port" if writer == "jax" else "jax"
    _, straight = run(writer, tmp_path / "straight", 6, save_every=100)
    first, head = run(writer, d / "run", 3, save_every=3)
    assert C.latest_step(d / "run") == 3
    if reader == "port":  # the port reads JAX's file exactly
        fresh, _ = port_loop(None).init_or_restore()
        C.restore_checkpoint(d / "run", fresh)
        saved = {k: np.asarray(v) for k, v in
                 np.load(d / "run" / "step_00000003" / "tensors.npz").items()}
        for k, (t, unstack) in C.flatten_state(fresh).items():
            got = t.detach().numpy()
            np.testing.assert_array_equal(got[0] if unstack else got, saved[k],
                                          err_msg=k)
    else:  # JAX reads the port's file exactly
        like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            _jax_loop(cfg, None, opt).init_or_restore()[0])
        restored = JC.restore_checkpoint(d / "run", like)
        want = {k: t for k, t in C.flatten_state(first.final_state).items()}
        for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
            t, unstack = want[jax.tree_util.keystr(path)]
            t = t.detach().numpy()
            np.testing.assert_array_equal(np.asarray(leaf), t[0] if unstack else t)
    _, tail = run(reader, d / "run", 6, save_every=3)
    np.testing.assert_allclose(head + tail, straight, **TOL)
    if opt == "float32" and writer == "port":
        _, jax_straight = run("jax", tmp_path / "jax_straight", 6, save_every=100)
        np.testing.assert_allclose(head + tail, jax_straight, **TOL)


def test_background_snapshot_is_taken_before_save_returns(tmp_path, monkeypatch):
    """The writer thread is held until the next in-place step has run; the
    checkpoint still holds the state as it was at ``save_checkpoint``."""
    go = threading.Event()
    savez = C.np.savez

    def held_savez(*a, **k):
        assert go.wait(60)
        return savez(*a, **k)

    loop = _loop()
    loop.run(1)
    state = loop.final_state
    monkeypatch.setattr(C.np, "savez", held_savez)
    before = _leaves(state)
    writer = C.save_checkpoint(tmp_path, state, 1, background=True)
    batch = {k: torch.from_numpy(v) for k, v in loop.data.batch_at(1).items()}
    loop.step_fn(state, batch)  # parameters and moments change in place
    changed = _leaves(state)
    assert not torch.equal(changed["['params']['final_norm']['scale']"],
                           before["['params']['final_norm']['scale']"])
    go.set()
    writer.join()
    fresh, _ = _loop().init_or_restore()
    C.restore_checkpoint(tmp_path, fresh, step=1)
    for k, t in _leaves(fresh).items():
        assert torch.equal(t, before[k]), k


@pytest.mark.gpu
def test_resume_and_replay_on_the_card(tmp_path):
    """Phase 6f's check at smoke width on the card: a replayed failure and
    a resume reproduce the straight run's losses at rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tget("hubert-xlarge", smoke=True)

    def run(d, **kw):
        return TrainLoop(cfg, TINY, ckpt_dir=d, total_steps=50, lr=1e-3,
                         device="cuda", **kw)

    straight = [r["loss"] for r in run(None).run(8)]
    fails = {"n": 0}

    def once(step):
        if step == 5 and not fails["n"]:
            fails["n"] += 1
            raise RuntimeError("injected failure")

    replayed = run(tmp_path, save_every=3, failure_hook=once).run(6)
    resumed = run(tmp_path, save_every=3).run(8)
    assert fails["n"] == 1 and [r["step"] for r in resumed] == [6, 7]
    assert [r["step"] for r in replayed] == [0, 1, 2, 3, 4, 3, 4, 5]
    got = {r["step"]: r["loss"] for r in replayed + resumed}
    np.testing.assert_allclose([got[s] for s in range(8)], straight, rtol=1e-5)

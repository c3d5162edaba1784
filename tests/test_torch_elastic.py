"""Elastic rescale and sharded checkpoints in the port against the JAX
package, on gloo ranks on the CPU:

- ``rescale_plan`` equals JAX's for 1 to 512 healthy nodes at
  ``prefer_model`` 16, 8 and 4, and the JAX test's three cases;
- the mirror of tests/test_multidevice.py::test_elastic_reshard_roundtrip
  on 8 ranks: the qwen2-1.5b smoke state sharded at (4, 2) and stepped once
  (non-zero moments), resharded live onto (2, 4) and then (8, 1) —
  gathered, each equals the original bitwise, and each rank's leaves are
  its slices (asserted in the ranks);
- a checkpoint saved from those 8 ranks restores in a 4-rank job at (2, 2)
  (``restore_checkpoint(mesh=, specs=)``) and gathers to the original
  bitwise: the JAX test's (4, 2) -> (2, 2) round trip, across a restart;
- the same sharded save restores in JAX's ``restore_checkpoint``, and a
  checkpoint JAX wrote restores onto a 2-rank (1, 2) mesh, both bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.train.elastic import rescale_plan  # noqa: E402
from test_torch_train_sharded import make_batch  # noqa: E402


def test_rescale_plan_equals_jax():
    pytest.importorskip("jax")
    from repro.train.elastic import rescale_plan as jplan

    assert rescale_plan(256) == (16, 16)
    assert rescale_plan(192, prefer_model=16) == (12, 16)
    assert rescale_plan(3) == (3, 1)
    for prefer in (16, 8, 4):
        for n in range(1, 513):
            assert rescale_plan(n, prefer) == jplan(n, prefer), (n, prefer)


def _tree_equal(got, want, label):
    import jax

    flat_w, tdef = jax.tree_util.tree_flatten_with_path(want)
    for (path, w), g in zip(flat_w, tdef.flatten_up_to(got), strict=True):
        np.testing.assert_array_equal(
            np.asarray(g), np.asarray(w),
            err_msg=f"{label}{jax.tree_util.keystr(path)}")


def test_reshard_and_sharded_checkpoints_round_trip(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.optim.adamw import AdamWCfg
    from repro.train import checkpoint as JC
    from repro.train.train_step import init_train_state

    cfg = get_config("qwen2-1.5b", smoke=True).replace(dtype="float32",
                                                       param_dtype="float32")
    state0 = init_train_state(jax.random.PRNGKey(0), cfg, AdamWCfg())
    tree = jax.tree.map(np.asarray, state0["params"])
    batch = make_batch(cfg.vocab_size)

    # live reshard (4, 2) -> (2, 4) -> (8, 1) on 8 ranks; save at (4, 2)
    ckpt = tmp_path / "port"
    got = run_ranks("_torch_train_ranks:elastic_rank", 8,
                    (tree, batch, str(ckpt)), device="cpu")
    want = got[0]
    for r, g in enumerate(got[1:], 1):
        for kind in ("params", "m", "v"):
            _tree_equal(g[kind], want[kind], f"rank {r} {kind}")

    # a restart: 4 ranks at (2, 2) restore the 8-rank checkpoint
    for r, g in enumerate(run_ranks("_torch_train_ranks:restore_rank", 4,
                                    (tree, str(ckpt), (2, 2)), device="cpu")):
        for kind in ("params", "m", "v"):
            _tree_equal(g[kind], want[kind], f"(2, 2) rank {r} {kind}")
        assert g["step"] == want["step"] == 1

    # the sharded save restores in JAX
    restored = JC.restore_checkpoint(ckpt, state0)
    _tree_equal(restored["params"], want["params"], "jax params")
    _tree_equal(restored["opt"]["m"], want["m"], "jax m")
    _tree_equal(restored["opt"]["v"], want["v"], "jax v")
    assert int(restored["opt"]["step"]) == 1

    # a JAX checkpoint restores onto a 2-rank mesh
    jstate = {"params": state0["params"],
              "opt": {"m": jax.tree.map(lambda p: 0.5 * p, state0["params"]),
                      "v": jax.tree.map(lambda p: p * p, state0["params"]),
                      "step": state0["opt"]["step"] + 7}}
    JC.save_checkpoint(tmp_path / "jax", jstate, 7)
    for r, g in enumerate(run_ranks("_torch_train_ranks:restore_rank", 2,
                                    (tree, str(tmp_path / "jax"), (1, 2)),
                                    device="cpu")):
        _tree_equal(g["params"], jstate["params"], f"(1, 2) rank {r} params")
        _tree_equal(g["m"], jstate["opt"]["m"], f"(1, 2) rank {r} m")
        _tree_equal(g["v"], jstate["opt"]["v"], f"(1, 2) rank {r} v")
        assert g["step"] == 7

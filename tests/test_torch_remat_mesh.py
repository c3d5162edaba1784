"""The ambient mesh inside remat's recomputation, on gloo ranks on the
CPU.

On a card autograd runs the backward pass, and with it the recomputation
of every remat'd block (``torch.utils.checkpoint``), on its device
thread, where the thread-local ambient mesh of ``parallel.sharding`` is
not installed.  The MoE balance terms read that mesh
(``sharding.batch_sum``, ``batch_shards``) to sum ``load`` and
``importance`` over the ranks that split the batch; recomputed without
it they are one rank's own sums, and the router gradients differ from
rank to rank.

Here arctic smoke (float32, 8 experts, top-2) takes one sharded step on
a (2, 1) ("data", "model") mesh of gloo ranks with ``remat`` "full" and
"dots", its forward under ``use_mesh`` and its backward on a
``threading.Thread`` with no mesh (``_torch_train_ranks.remat_mesh_rank``).
Held against JAX's single-device step on the same weights and batch:

- the router gradients summed over the ranks against JAX's ``jax.grad``
  of the loss, at rtol 2e-3 and atol 2e-6 (``ROUTER_TOL``: the balance
  term enters the loss at weight 0.01, so its share of a router gradient
  of ~1e-2 is ~1e-4, and a recomputation without the mesh moved it by
  1.7e-4, under the state's atol of 2e-4; the port is within 1e-8 of
  JAX);
- the loss and the gathered state after the step, at
  tests/test_torch_train_sharded_cases.py's tolerances (rtol 2e-3, atol
  2e-4; ``test_torch_train_sharded.assert_like_jax``).

The ``gpu`` test runs chip_smoke.py's phase 14(c) on a card: arctic smoke
on a 1-rank NCCL mesh, every recomputed call of the balance terms on
autograd's device thread under the forward's mesh and rules (JAX is not
needed there: this module imports it lazily).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from test_torch_train_sharded import (STATE_TOL, assert_like_jax,  # noqa: E402
                                      jax_case, make_batch)

ARCH = "arctic-480b"
MESH = (2, 1)
REMATS = ("full", "dots")
ROUTER_TOL = dict(rtol=STATE_TOL["rtol"], atol=STATE_TOL["atol"] / 100)


def _routers(tree, path=()):
    """{path: leaf} of every "router" leaf of a JAX-layout numpy tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_routers(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_routers(v, path + (i,)))
        return out
    return {path: tree} if path and path[-1] == "router" else {}


@pytest.fixture(scope="module")
def runs():
    """{remat: (JAX's (loss, state), JAX's router gradients, every rank's
    (loss, state, gradients))}: one rank run for both cases."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import model as JM

    batch = make_batch(get_config(ARCH, smoke=True).vocab_size, seed=3)
    want, trees = {}, {}
    for remat in REMATS:
        case = {"arch": ARCH, "cfg": {"remat": remat}}
        tree, loss, state = jax_case(case, batch)
        cfg = get_config(ARCH, smoke=True).replace(
            dtype="float32", param_dtype="float32", remat=remat)
        jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        grads = jax.grad(lambda p: JM.loss_fn(p, cfg, jb)[0])(
            jax.tree.map(jax.numpy.asarray, tree))
        want[remat] = ((loss, state), _routers(jax.tree.map(np.asarray, grads)))
        trees[remat] = tree
    assert all(np.array_equal(a, b) for a, b in zip(
        *(jax.tree.leaves(trees[r]) for r in REMATS)))
    results = run_ranks("_torch_train_ranks:remat_mesh_rank", MESH[0] * MESH[1],
                        (MESH, [{"cfg": {"remat": r}} for r in REMATS],
                         trees[REMATS[0]], batch), device="cpu")
    return {r: (want[r][0], want[r][1], [res[i] for res in results])
            for i, r in enumerate(REMATS)}


@pytest.mark.parametrize("remat", REMATS)
def test_recomputation_without_a_mesh_matches_jax(runs, remat):
    (want_loss, want_state), want_routers, ranks = runs[remat]
    assert len(want_routers) > 0
    summed = {}
    for _, _, grads in ranks:
        for path, g in _routers(grads).items():
            summed[path] = summed.get(path, 0.0) + g
    assert set(summed) == set(want_routers)
    for path, w in want_routers.items():
        print(f"{remat} {path}: max |port - JAX| "
              f"{np.abs(summed[path] - w).max():.3e}, max |JAX| "
              f"{np.abs(w).max():.3e}")
        np.testing.assert_allclose(summed[path], w, **ROUTER_TOL,
                                   err_msg=f"{remat} router grad {path}")
    for r, (loss, state, _) in enumerate(ranks):
        assert_like_jax(loss, state, want_loss, want_state,
                        f"remat {remat} rank {r}")


@pytest.mark.gpu
def test_recomputation_on_the_device_thread_sees_the_forward_mesh():
    """chip_smoke.py phase 14(c) on the card: the recomputation runs on
    autograd's device thread, under the forward's mesh and rules."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    out = chip_smoke.remat_mesh_probe(chip_smoke.card_line())
    assert out["recomputed"] > 0 and out["forward"] > 0

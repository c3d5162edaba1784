"""The port's sharded train step against JAX's single-device step, on gloo
ranks on the CPU (``launch.ranks.run_ranks(..., device="cpu")``).

The mirror of tests/test_multidevice.py::
test_sharded_train_step_matches_single_device: qwen2-1.5b smoke in
float32, batch 8 x 32, ``AdamWCfg()``, ``constant(1e-3)``, JAX's weights
carried across by ``bridge``, one step on ("data", "model") meshes (1, 1),
(2, 1), (1, 2), (2, 2) and (4, 2) against JAX's jitted step without a
mesh:

- the loss within 1e-4 of JAX's;
- the parameters and both moments after the step, gathered, within rtol
  2e-3 and atol 2e-4 (the JAX test's tolerances for sharded against
  single-device);
- on every rank, every leaf exactly its slice of the gathered state
  (asserted in the ranks, ``_torch_train_ranks.assert_shards_are_slices``);
- at (1, 1), the state and loss equal to the port's step without a mesh,
  bitwise (asserted in the rank).

tests/test_torch_train_sharded_cases.py holds the (2, 2) variants (int8
moments, microbatches with a loss mask, MoE, ``use_flash``) and the
'model' split's cases (``heads_tp``, an untied head, experts, Mamba).

On a machine with four cards, the ``gpu`` test ``test_train_across_cards``
runs the step on NCCL ranks at full width (JAX is not needed there: this
module imports it lazily).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.launch.ranks import run_ranks  # noqa: E402

LOSS_TOL = 1e-4
STATE_TOL = dict(rtol=2e-3, atol=2e-4)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]
BATCH, SEQ = 8, 32


def make_batch(vocab: int, seed: int = 0, mask: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    out = {k: rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
           for k in ("tokens", "labels")}
    if mask:
        out["loss_mask"] = (rng.rand(BATCH, SEQ) < 0.6).astype(np.float32)
    return out


def jax_case(case: dict, batch: dict):
    """JAX's jitted single-device step for ``case`` from seed-0 weights:
    (numpy parameter tree, loss, {"params", "m", "v"} numpy trees, moments
    dequantized)."""
    import jax

    from repro.configs import get_config
    from repro.optim.adamw import AdamWCfg
    from repro.optim.quantized_state import dequantize, is_quantized
    from repro.optim.schedules import constant
    from repro.train.train_step import init_train_state, make_train_step

    cfg = get_config(case["arch"], smoke=True).replace(
        dtype="float32", param_dtype="float32", **case.get("cfg", {}))
    if "moe_impl" in case:
        from _torch_train_ranks import with_moe_impl

        cfg = with_moe_impl(cfg, case["moe_impl"])
    opt = AdamWCfg(**case.get("opt", {}))
    state0 = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    tree = jax.tree.map(np.asarray, state0["params"])
    step = jax.jit(make_train_step(cfg, opt, constant(1e-3),
                                   case.get("microbatches", 1)))
    state, metrics = step(state0, {k: jax.numpy.asarray(v)
                                   for k, v in batch.items()})

    def moments(tree):
        return jax.tree.map(lambda m: np.asarray(dequantize(m) if is_quantized(m)
                                                 else m), tree, is_leaf=is_quantized)

    want = {"params": jax.tree.map(np.asarray, state["params"]),
            "m": moments(state["opt"]["m"]), "v": moments(state["opt"]["v"])}
    return tree, float(metrics["loss"]), want


def assert_like_jax(got_loss, got, want_loss, want, label):
    import jax

    assert abs(got_loss - want_loss) < LOSS_TOL, (label, got_loss, want_loss)
    for kind in ("params", "m", "v"):
        flat_w, tdef = jax.tree_util.tree_flatten_with_path(want[kind])
        flat_g = tdef.flatten_up_to(got[kind])
        for (path, w), g in zip(flat_w, flat_g, strict=True):
            np.testing.assert_allclose(
                g, w, **STATE_TOL,
                err_msg=f"{label} {kind}{jax.tree_util.keystr(path)}")
    assert got["step"] == 1


@pytest.fixture(scope="module")
def qwen_case():
    pytest.importorskip("jax")
    case = {"arch": "qwen2-1.5b"}
    from repro.configs import get_config

    batch = make_batch(get_config("qwen2-1.5b", smoke=True).vocab_size)
    tree, loss, want = jax_case(case, batch)
    return case, batch, tree, loss, want


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax_single_device(qwen_case, shape):
    case, batch, tree, want_loss, want = qwen_case
    n = shape[0] * shape[1]
    results = run_ranks("_torch_train_ranks:train_rank", n,
                        (shape, [case], {case["arch"]: tree}, [batch]),
                        device="cpu")
    for r, [(loss, got)] in enumerate(results):
        assert_like_jax(loss, got, want_loss, want, f"{shape} rank {r}")


# ---------------------------------------------------------------------------
# on the card: NCCL ranks, one card each

# (mesh, heads_tp)
CARD_MESHES = [((2, 1), False), ((1, 2), False), ((1, 2), True),
               ((2, 2), False), ((4, 1), False), ((1, 4), False)]


@pytest.mark.gpu
def test_train_across_cards():
    """qwen2-1.5b at full width cut to 4 layers, float32, sequence 1024,
    batch 8: 2 sharded steps on each mesh of ``CARD_MESHES`` on NCCL
    ranks, one card each, against the step without a mesh on the rank's
    own card, at the CPU test's tolerances (asserted in the ranks; the
    second step's loss, ~1e3 at full width, at 1e-6 of its value).
    Prints ms per step and peak memory per card beside one card's.
    'model' ranks split the FFN, the vocabulary and, with ``heads_tp``,
    the query heads (G 6 -> 3 at 'model' 2; at 'model' 4, which does not
    divide 6, the heads stay whole)."""
    need = max(d * m for (d, m), _ in CARD_MESHES)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        pytest.skip(f"needs {need} CUDA devices, has {have}")
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    for shape, heads_tp in CARD_MESHES:
        n = shape[0] * shape[1]
        for r, res in enumerate(run_ranks("_torch_train_ranks:cards_train_rank",
                                          n, (shape, 4, 1024, 8, 2, heads_tp),
                                          device="cuda", timeout=900)):
            print(f"train across cards, mesh {shape}"
                  f"{' heads_tp' if heads_tp else ''} rank {r}, qwen2-1.5b "
                  f"FULL width 4 layers f32, seq 1024, batch 8, on {card}: "
                  f"losses {res['losses']} (one card without a mesh "
                  f"{res['ref_losses']}); max |diff| {res['max_diff']}; "
                  f"{res['ms'][0]:.1f} ms a step after the first (one card "
                  f"{res['ref_ms'][0]:.1f}); peak memory "
                  f"{res['peak_gib']:.2f} GiB (one card "
                  f"{res['ref_peak_gib']:.2f})", flush=True)

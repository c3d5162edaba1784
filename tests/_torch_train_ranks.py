"""Rank-side functions of the sharded-training tests of the PyTorch port
(tests/test_torch_train_sharded*.py, test_torch_elastic.py,
test_torch_compress.py, test_torch_pipeline.py, and the four-card
``test_train_across_cards``).

``launch.ranks.run_ranks`` runs these functions in fresh rank processes,
which must not import JAX: this module imports torch, numpy and the port
only.  The parents compute the JAX references and pass numpy in.
"""
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.train.checkpoint import walk_state

AXES = ("data", "model")


def with_moe_impl(cfg, impl: str):
    """``cfg`` (either package's config) with every MoE block's ``impl``
    set to ``impl``."""
    def block(b):
        return dataclasses.replace(b, moe=dataclasses.replace(b.moe, impl=impl)) \
            if b.moe is not None else b
    return cfg.replace(stages=tuple(
        dataclasses.replace(st, pattern=tuple(block(b) for b in st.pattern))
        for st in cfg.stages))


def _cfg(arch: str, moe_impl=None, **kw):
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               param_dtype="float32", **kw)
    return cfg if moe_impl is None else with_moe_impl(cfg, moe_impl)


def _state(tree, cfg, opt, device="cpu"):
    """A whole port train state from a numpy JAX parameter tree."""
    from repro_torch import bridge
    from repro_torch.optim.adamw import init_opt_state

    params = bridge.params_from_numpy(tree, cfg, device, for_training=True)
    return {"params": params, "opt": init_opt_state(params, opt)}


def _moment_numpy(params, moments, cfg):
    """Moments laid out like JAX's tree, int8 ones dequantized."""
    from repro_torch import bridge
    from repro_torch.optim.quantized_state import dequantize, is_quantized

    return bridge.grads_to_numpy(
        params, [dequantize(m) if is_quantized(m) else m for m in moments], cfg)


def state_numpy(state, cfg) -> dict:
    from repro_torch import bridge

    p = state["params"]
    return {"params": bridge.params_to_numpy(p, cfg),
            "m": _moment_numpy(p, state["opt"]["m"], cfg),
            "v": _moment_numpy(p, state["opt"]["v"], cfg),
            "step": int(state["opt"]["step"])}


def _leaves(state):
    return [t for _, t, _, _ in walk_state(state)]


def assert_shards_are_slices(state, whole, mesh):
    """Every leaf of the sharded ``state`` is exactly this rank's slice of
    the gathered ``whole`` state."""
    from repro_torch.parallel.sharding import local_slices

    for (key, shard, _, spec), full in zip(walk_state(state, state["specs"]),
                                           _leaves(whole), strict=True):
        want = full[local_slices(spec, full.shape, mesh)]
        assert shard.shape == want.shape, (key, shard.shape, want.shape)
        assert torch.equal(shard, want), key


def assert_states_equal(a, b):
    for (key, x, _, _), y in zip(walk_state(a), _leaves(b), strict=True):
        assert x.shape == y.shape and torch.equal(x, y), key


def assert_working_copies(state, whole, mesh, want):
    """The train step's working copies of the sharded ``state``: a leaf
    whose last name is in ``want`` (and only those) is split over
    'model', and its working copy is exactly this rank's 'model' slice of
    the ``whole`` leaf (of a Mamba ``in_proj``, its columns of each half),
    marked for the layers (``model_part``); every other leaf's is the
    whole leaf."""
    from repro_torch.parallel.sharding import (axis_coordinate, axes_size,
                                               model_part)
    from repro_torch.train.train_step import _working_copies

    n, r = axes_size(mesh, "model"), axis_coordinate(mesh, "model")
    params = state["params"]
    specs = list(state["specs"]["params"].values())
    split = set()
    with _working_copies(params, specs, mesh):
        for (name, p), full in zip(params.named_parameters(),
                                   whole["params"].parameters(), strict=True):
            part = model_part(p.data)
            if part is None:
                assert torch.equal(p.data, full), name
                continue
            split.add(name.rpartition(".")[2])
            assert part.coord == r and part.size == n, (name, part)
            dim = next(d for d in range(-1, -p.ndim - 1, -1)
                       if p.shape[d] != full.shape[d])
            assert p.shape[dim] * n == full.shape[dim], (name, p.shape)
            if name.endswith("in_proj"):
                full = full.reshape(full.shape[:-1] + (2, n, -1))[..., r, :]
                want_copy = full.flatten(-2)
            else:
                want_copy = full.narrow(dim, r * p.shape[dim], p.shape[dim])
            assert torch.equal(p.data, want_copy), name
    assert split == set(want), (sorted(split), sorted(want))


@contextlib.contextmanager
def rows_kept():
    """Records the size of every split the saved residuals' boundary
    (``sharding.keep_rows``) is called with, the stage's inputs and every
    block's output."""
    from repro_torch.parallel import sharding

    kept, real = [], sharding.keep_rows

    def keep(x, split):
        kept.append(split.size)
        return real(x, split)

    sharding.keep_rows = keep
    try:
        yield kept
    finally:
        sharding.keep_rows = real


def assert_res_seq(kept, cfg, mesh, seq_len: int) -> None:
    """The step kept the saved residuals as the rank's rows over 'model'
    exactly where JAX's ``act_res_seq`` splits them: remat on, the flag
    set, and 'model' > 1 dividing the sequence."""
    from repro_torch.parallel.sharding import axis_sizes

    n = axis_sizes(mesh)["model"]
    want = (n > 1 and cfg.remat != "none" and cfg.seq_shard_residuals
            and seq_len % n == 0)
    assert bool(kept) == want and set(kept) <= {n}, (kept, want)


def _step_case(case: dict, tree, batch, mesh):
    """One sharded step of ``case`` (arch, opt kwargs, microbatches,
    config kwargs, ``moe_impl``, ``heads_tp``; ``split``, the leaves the
    'model' split must cut, checked where given) on ``mesh``; returns
    (whole state after it, its loss)."""
    from repro_torch.optim.adamw import AdamWCfg
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel.sharding import make_rules, use_mesh
    from repro_torch.train.train_step import (gather_state, make_train_step,
                                              shard_state)

    cfg = _cfg(case["arch"], case.get("moe_impl"), **case.get("cfg", {}))
    opt = AdamWCfg(**case.get("opt", {}))
    step = make_train_step(cfg, opt, constant(1e-3),
                           case.get("microbatches", 1))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with use_mesh(mesh, make_rules(mesh, heads_tp=case.get("heads_tp", False))):
        state = shard_state(_state(tree, cfg, opt))
        if "split" in case:
            assert_working_copies(state, _state(tree, cfg, opt), mesh,
                                  case["split"])
        with rows_kept() as kept:
            state, metrics = step(state, b)
        assert_res_seq(kept, cfg, mesh, b["tokens"].shape[1])
        whole = gather_state(state)
        assert_shards_are_slices(state, whole, mesh)
    if mesh.size() == 1:  # a mesh of one rank: the step without a mesh, bitwise
        plain = _state(tree, cfg, opt)
        plain, pm = step(plain, b)
        assert torch.equal(pm["loss"], metrics["loss"])
        assert_states_equal(plain, whole)
    return whole, cfg, float(metrics["loss"])


def train_rank(shape, cases, trees, batches):
    """The sharded train step on a ("data", "model") mesh of ``shape``, one
    step per case from the JAX parameters ``trees[case["arch"]]`` on
    ``batches[i]``; returns per case (loss, the gathered state as numpy).
    Asserts every rank's leaves are exactly its slices of the gathered
    state, and at one rank, the step without a mesh bitwise."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, AXES, device="cpu")
    out = []
    for case, batch in zip(cases, batches):
        whole, cfg, loss = _step_case(case, trees[case["arch"]], batch, mesh)
        out.append((loss, state_numpy(whole, cfg)))
    return out


# ---------------------------------------------------------------------------
# elastic reshard and sharded checkpoints


def elastic_rank(tree, batch, ckpt_dir: str):
    """On 8 ranks: the qwen2-1.5b smoke state sharded at (4, 2) and stepped
    once (so its moments are not zero), then resharded live onto (2, 4)
    and (8, 1); each gathered state equals the first bitwise.  Saves the
    (4, 2) state's checkpoint into ``ckpt_dir`` (step 1) and returns the
    gathered state as numpy."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWCfg
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.train_step import (gather_state, make_train_step,
                                              shard_state)

    cfg, opt = _cfg("qwen2-1.5b"), AdamWCfg()
    m1 = make_mesh((4, 2), AXES, device="cpu")
    m2 = make_mesh((2, 4), AXES, device="cpu")
    m3 = make_mesh((8, 1), AXES, device="cpu")
    step = make_train_step(cfg, opt, constant(1e-3))
    with use_mesh(m1):
        s1 = shard_state(_state(tree, cfg, opt))
        s1, _ = step(s1, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = gather_state(s1)
        save_checkpoint(ckpt_dir, s1, 1)
        s2 = reshard_state(s1, m2)
    with use_mesh(m2):
        assert_shards_are_slices(s2, want, m2)
        assert_states_equal(gather_state(s2), want)
        s3 = reshard_state(s2, m3)
    with use_mesh(m3):
        assert_shards_are_slices(s3, want, m3)
        assert_states_equal(gather_state(s3), want)
    return state_numpy(want, cfg)


def restore_rank(tree, ckpt_dir: str, shape, int8: bool = False):
    """A fresh qwen2-1.5b smoke state sharded on a ("data", "model") mesh
    of ``shape``, the checkpoint in ``ckpt_dir`` restored into it
    (``mesh=``, ``specs=``); returns the gathered state as numpy."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWCfg
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.train_step import gather_state, shard_state

    cfg = _cfg("qwen2-1.5b")
    opt = AdamWCfg(state_dtype="int8" if int8 else "float32")
    mesh = make_mesh(shape, AXES, device="cpu")
    with use_mesh(mesh):
        state = shard_state(_state(tree, cfg, opt))
        restore_checkpoint(ckpt_dir, state, mesh=mesh, specs=state["specs"])
        whole = gather_state(state)
        assert_shards_are_slices(state, whole, mesh)
    return state_numpy(whole, cfg)


# ---------------------------------------------------------------------------
# compressed DDP and the pipeline


def ddp_rank(X, y, steps: int, record: int):
    """``make_ddp_value_and_grad`` on the regression problem of JAX's test
    over a 4-rank ('data',) mesh: ``steps`` steps of w -= 0.1 g; returns
    (final loss, the first ``record`` steps' (this rank's own gradient, its
    residual before, the compressed mean, its residual after))."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compress import ef_init_tree, make_ddp_value_and_grad

    mesh = make_mesh((4,), ("data",), device="cpu")

    def loss_fn(w, b):
        return torch.mean((b[0] @ w - b[1]) ** 2)

    fn = make_ddp_value_and_grad(loss_fn, mesh)
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    r, n = dist.get_rank(), X.shape[0] // 4
    w = torch.zeros(X.shape[1])
    ef = ef_init_tree(w, 4)
    seen = []
    for i in range(steps):
        before = ef[0].numpy().copy()
        loss, g, ef = fn(w, ef, (X, y))
        if i < record:  # the rank's own gradient, as fn computes it
            wg = w.clone().requires_grad_()
            (own,) = torch.autograd.grad(
                loss_fn(wg, (X[r * n:(r + 1) * n], y[r * n:(r + 1) * n])), wg)
            seen.append((own.numpy(), before, g.numpy().copy(),
                         ef[0].numpy().copy()))
        w = w - 0.1 * g
    return float(loss), seen


def pipeline_rank(Ws, xs):
    """``pipeline_apply`` of tanh(x @ w) stages over a ('pipe',) mesh of
    every rank, this rank holding stage ``rank``; returns (the output, the
    gradient of sum(out ** 2) with respect to this rank's stage)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply

    n = dist.get_world_size()
    mesh = make_mesh((n,), ("pipe",), device="cpu")
    r = dist.get_rank()
    W = torch.from_numpy(Ws[r:r + 1]).requires_grad_()
    out = pipeline_apply(lambda w, x: torch.tanh(x @ w), W,
                         torch.from_numpy(xs), mesh, "pipe")
    (g,) = torch.autograd.grad(torch.sum(out ** 2), W)
    return out.detach().numpy(), g[0].numpy()


# ---------------------------------------------------------------------------
# four cards


def cards_train_rank(shape, layers: int, seq: int, batch: int, steps: int,
                     heads_tp: bool = False):
    """qwen2-1.5b at full width cut to ``layers`` layers, float32, on NCCL
    ranks, one card each: ``steps`` steps without a mesh on the rank's own
    card (the one-card reference), then ``steps`` sharded steps at
    ("data", "model") ``shape`` (rules ``make_rules(mesh, heads_tp=)``)
    from the same weights and batches.  Asserts
    the first loss within 1e-4 and the gathered parameters and moments
    within rtol 2e-3, atol 2e-4 of the reference (the CPU test's
    tolerances), and each later loss within 1e-6 of its value;
    returns {losses, max |diff| of each kind, ms per step after the first
    and peak memory in GiB of each arm}."""
    import gc

    from repro_torch.configs import Stage, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWCfg, init_opt_state
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel.sharding import make_rules, use_mesh
    from repro_torch.train.train_step import (gather_state, make_train_step,
                                              shard_state)

    device = "cuda"
    full = get_config("qwen2-1.5b")
    cfg = full.replace(dtype="float32", param_dtype="float32",
                       stages=(Stage(full.stages[0].pattern, layers),))
    opt = AdamWCfg()
    mesh = make_mesh(shape, AXES, device=device)
    rng = np.random.RandomState(0)
    batches = [{k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))
                                    .astype(np.int32)).to(device)
                for k in ("tokens", "labels")} for _ in range(steps)]
    step = make_train_step(cfg, opt, constant(1e-3))

    def run(sharded: bool):
        params = M.init_params(
            cfg, generator=torch.Generator(device).manual_seed(0),
            device=device, for_training=True)
        state = {"params": params, "opt": init_opt_state(params, opt)}
        if sharded:
            state = shard_state(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 2**30
        return state, losses, times[1:], peak

    ref, ref_losses, ref_ms, ref_peak = run(False)
    ref = {"params": [p.detach().cpu() for p in ref["params"].parameters()],
           "m": [m.cpu() for m in ref["opt"]["m"]],
           "v": [v.cpu() for v in ref["opt"]["v"]]}
    gc.collect()
    torch.cuda.empty_cache()
    with use_mesh(mesh, make_rules(mesh, heads_tp=heads_tp)):
        state, losses, ms, peak = run(True)
        whole = gather_state(state)
        del state
    # the first step's loss (same weights) at the CPU test's 1e-4; a later
    # step's, which reads the updated parameters, at 1e-6 of the loss: at
    # full width the loss is ~1e3, where float32's spacing is ~6e-5, and
    # the CPU test's 1e-4 was set at a loss of ~6 (1.6e-5 of it)
    assert abs(losses[0] - ref_losses[0]) < 1e-4, (losses, ref_losses)
    for a, b in zip(losses[1:], ref_losses[1:]):
        assert abs(a - b) <= 1e-6 * abs(b), (losses, ref_losses)
    diffs = {}
    got = {"params": list(whole["params"].parameters()),
           "m": whole["opt"]["m"], "v": whole["opt"]["v"]}
    for kind in ("params", "m", "v"):
        worst = 0.0
        for g, r in zip(got[kind], ref[kind], strict=True):
            r = r.to(device)
            torch.testing.assert_close(g.detach(), r, rtol=2e-3, atol=2e-4)
            worst = max(worst, float((g.detach() - r).abs().max()))
        diffs[kind] = worst
    return {"losses": losses, "ref_losses": ref_losses, "max_diff": diffs,
            "ms": ms, "ref_ms": ref_ms, "peak_gib": peak,
            "ref_peak_gib": ref_peak}


# ---------------------------------------------------------------------------
# the ambient mesh inside remat's recomputation


def remat_mesh_rank(shape, cases, tree, batch):
    """arctic smoke (float32, MoE; another arch where a case names one) on
    a ("data", "model") mesh of ``shape``: one sharded step per case
    (``{"cfg": {"remat": ...}}``)
    whose backward pass runs on a ``threading.Thread`` with no mesh
    installed, as autograd's device thread runs it on a card (the
    step's ``torch.autograd.grad`` is swapped for one that runs on such a
    thread and asserts it sees no mesh).  Returns per case (loss, the
    gathered state as numpy, this rank's raw gradients as a JAX-layout
    numpy tree: its rows' share of the global loss's, summed over the
    ranks by the caller)."""
    import threading

    from repro_torch import bridge
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import current_mesh

    mesh = make_mesh(shape, AXES, device="cpu")
    real_grad = torch.autograd.grad
    seen = {}

    def grad_on_a_thread(outputs, inputs, *args, **kwargs):
        box = {}

        def run():
            try:
                box["mesh"] = current_mesh()
                box["grads"] = real_grad(outputs, inputs, *args, **kwargs)
            except BaseException as e:  # re-raised on the caller's thread
                box["error"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "error" in box:
            raise box["error"]
        assert box["mesh"] is None, "the backward thread saw a mesh"
        # copies: the step all-reduces its gradients in place
        seen["grads"] = [g.clone() for g in box["grads"]]
        return box["grads"]

    out = []
    torch.autograd.grad = grad_on_a_thread
    try:
        for case in cases:
            case = {"arch": "arctic-480b", **case}
            whole, cfg, loss = _step_case(case, tree, batch, mesh)
            grads = bridge.grads_to_numpy(whole["params"], seen.pop("grads"),
                                          cfg)
            out.append((loss, state_numpy(whole, cfg), grads))
    finally:
        torch.autograd.grad = real_grad
    return out

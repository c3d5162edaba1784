"""The training step: loss -> grads -> AdamW update — ``repro.train.train_step``.

The state is {"params": Model (training layout), "opt": {m, v, step}}; the
step updates it IN PLACE and returns it.  Gradients come from
``torch.autograd.grad`` over every parameter, which raises if one is not
reached.

Sharded training (the step called under ``use_mesh(mesh)`` on a state
placed by ``shard_state``): every leaf of the state — each parameter, its
moments (an int8 moment's ``q`` and ``qscale``) and the step — is exactly
this rank's ``local_slices`` of the leaf laid out by ``train_state_specs``,
and the state carries those specs under "specs".  A step

1. all-gathers each parameter over its spec's axes into a working copy,
   in the parameter dtype, freed at the end of the step (between steps a
   rank holds only its shards).  A leaf whose layer splits over 'model'
   (``parallel.sharding.model_split_dims``: the FFN, the vocabulary, the
   experts, the query heads under ``heads_tp``, Mamba's inner channels)
   is gathered over its batch axes only: its working copy is the rank's
   'model' slice, marked for the layers (``model_slices``), which run
   only that slice's products and join them over 'model';
2. runs forward and backward on the rank's rows of the global batch
   (``batch_specs``: the leading dim over the "act_batch" axes, replicated
   over 'model'; with ``microbatches``, microbatch i is the global rows
   [i n, (i + 1) n), each then split); the loss and the MoE balance terms
   are normalized over the global batch (``parallel.sharding.batch_sum``);
3. sums each gradient over the batch axes and keeps the rank's slice
   (``constrain_like_params``): of a split leaf, the gradient of its
   'model' slice, whose slice over the batch axes is its stored shard;
4. updates the shards with AdamW, its clipping norm and int8 row scales
   taken over the mesh.

What stays whole on every 'model' rank: the norms, the k/v projections
(and attention itself without ``heads_tp``), the router, the frontends and
xLSTM's leaves.  The saved residuals between remat'd blocks are the
rank's rows of the sequence over 'model' (JAX's ``act_res_seq``,
``cfg.seq_shard_residuals``; ``models.transformer.stage_fwd``).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWCfg, apply_updates, init_opt_state
from repro_torch.optim.quantized_state import is_quantized
from repro_torch.parallel.sharding import (axis_coordinate, axis_rules,
                                           axes_size, constrain_like_params,
                                           current_mesh, gather_tensor,
                                           logical_spec, model_slices,
                                           model_split_dims, param_specs,
                                           sanitize_spec, shard_tensor)
from repro_torch.train.checkpoint import walk_state


def init_train_state(generator: torch.Generator, cfg: ModelCfg,
                     opt_cfg: AdamWCfg, *, device=None):
    params = M.init_params(cfg, generator=generator, device=device,
                           for_training=True)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


# ---------------------------------------------------------------------------
# Sharding specs for the train state


def train_state_specs(state, rules=None) -> Dict:
    """The spec tree of a {"params", "opt"} state of whole (logical)
    shapes under the ambient mesh: {"params": {name: spec}, "opt": {"m":
    [...], "v": [...], "step": ()}}.  Moments mirror their parameter's
    spec; an int8 moment is {"q": the parameter's spec, "qscale": the same
    with its last (size-1) axis unsharded}."""
    pspecs = param_specs(state["params"], rules=rules)

    def moment_spec(ps, leaf):
        if is_quantized(leaf):
            return {"q": ps, "qscale": ps[:-1] + (None,) if ps else ()}
        return ps

    flat = list(pspecs.values())
    return {"params": pspecs,
            "opt": {k: [moment_spec(p, leaf) for p, leaf in
                        zip(flat, state["opt"][k])] for k in ("m", "v")}
            | {"step": ()}}


def batch_specs(batch) -> Dict[str, tuple]:
    """{key: spec} of a global batch under the ambient mesh: the leading
    dim over the "act_batch" axes (dropped where they do not divide it),
    the rest replicated; a 0-dim leaf is replicated."""
    mesh = current_mesh()

    def spec(x):
        if x.ndim == 0:
            return ()
        s = logical_spec(("act_batch",) + (None,) * (x.ndim - 1))
        return sanitize_spec(s, x.shape, mesh) if mesh is not None else s
    return {k: spec(v) for k, v in batch.items()}


@torch.no_grad()
def shard_state(state):
    """Place a whole train state onto the ambient mesh, IN PLACE: every
    leaf becomes this rank's shard of it under ``train_state_specs``, and
    the state keeps its specs under "specs".  Returns the state."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("shard_state places a state on the ambient mesh: "
                         "call it under use_mesh(mesh)")
    specs = train_state_specs(state)
    for _, t, _, spec in walk_state(state, specs):
        t.data = shard_tensor(t.data, spec, mesh)
    state["specs"] = specs
    return state


@torch.no_grad()
def gather_state(state):
    """The whole state from a sharded one (every rank of the ambient mesh
    calls it): a new {"params", "opt"} state of logical shapes; the
    sharded state is left as it is."""
    mesh = current_mesh()
    whole = copy.deepcopy({"params": state["params"], "opt": state["opt"]})
    for _, t, _, spec in walk_state(whole, state["specs"]):
        t.data = gather_tensor(t.data, spec, mesh)
    return whole


@contextlib.contextmanager
def _working_copies(params, specs, mesh):
    """The parameters' data swapped for working copies gathered from their
    shards, and back to the shards on exit (the copies are then freed).
    Yields ``keep_shards(grads)``: the working copies' gradients -> this
    rank's shards of their sums over the batch axes
    (``constrain_like_params``).

    A leaf of ``model_split_dims`` is gathered over its spec without
    'model': its working copy and gradient are its 'model' slice, and its
    spec without 'model' cuts the stored shard from it.  Mamba's
    ``in_proj`` (d, 2 d_in) is the exception: its stored 'model' shard is
    a block of the x and z halves side by side (at 'model' 2, all of x on
    rank 0 and all of z on rank 1), where the rank needs its columns of
    each half.  Its working copy is gathered whole and cut to those
    columns, and its gradient gathered back over 'model' into the whole
    leaf's.  The stored layout stays JAX's."""
    names = [n for n, _ in params.named_parameters()]
    leaves = [p for _, p in params.named_parameters()]
    split = model_split_dims(dict(zip(names, specs)), mesh)
    shards = [p.data for p in leaves]
    n = axes_size(mesh, "model") if split else 1
    r = axis_coordinate(mesh, "model") if split else 0
    gspecs, cut = [], []
    try:
        for name, p, spec in zip(names, leaves, specs):
            dim = split.get(name)
            halves = dim is not None and name.endswith(".in_proj")
            if dim is not None and not halves:
                spec = tuple(None if i == len(spec) + dim else e
                             for i, e in enumerate(spec))
            p.data = gather_tensor(p.data, spec, mesh)
            if halves:  # (.., 2 d_in) -> the rank's (.., [x_r z_r])
                w = p.data
                p.data = w.reshape(w.shape[:-1] + (2, n, -1))[..., r, :] \
                    .flatten(-2).contiguous()
                cut.append(len(gspecs))
            gspecs.append(spec)

        def keep_shards(grads):
            grads = list(grads)
            for i in cut:  # every rank's (.., [x_r z_r]) -> (.., [x z])
                g = gather_tensor(grads[i], (None,) * (grads[i].ndim - 1)
                                  + ("model",), mesh)
                grads[i] = g.reshape(g.shape[:-1] + (n, 2, -1)).transpose(
                    -3, -2).flatten(-3)
            return constrain_like_params(grads, gspecs, mesh)

        with model_slices([p.data for name, p in zip(names, leaves)
                           if name in split], mesh):
            yield keep_shards
    finally:
        for p, s in zip(leaves, shards):
            p.data = s


def _rows(batch, lo: int, hi: int):
    """Global rows [lo, hi) of every key, then this rank's rows of them
    (``batch_specs``), and the effective "act_batch" entry: the axes that
    split them, None where the batch stays whole on every rank."""
    mb = {k: v[lo:hi] for k, v in batch.items()}
    specs = batch_specs(mb)
    mesh = current_mesh()
    if mesh is None:
        return mb, None
    entry = next(iter(specs.values()))[0]
    return {k: shard_tensor(v, specs[k], mesh) for k, v in mb.items()}, entry


def make_train_step(cfg: ModelCfg, opt_cfg: AdamWCfg, lr_fn: Callable,
                    microbatches: int = 1):
    """-> train_step(state, batch) -> (state, metrics).  With
    ``microbatches > 1`` every key of the batch (tokens or audio
    features, labels, image features) splits along its leading axis and
    the gradients accumulate in the parameter dtype, as in JAX.  Under
    ``use_mesh(mesh)`` the state is a sharded one (``shard_state``) and
    ``batch`` the global batch, the same on every rank (module
    docstring)."""

    def grads_of(params, leaves, batch, mesh):
        n = next(iter(batch.values())).shape[0] // microbatches
        grads, ls, ms = None, [], []
        for i in range(microbatches):
            mb, entry = _rows(batch, i * n, (i + 1) * n)
            with (axis_rules({"act_batch": entry}) if mesh is not None
                  else contextlib.nullcontext()):
                l, m = M.loss_fn(params, cfg, mb)
                g = list(torch.autograd.grad(l, leaves))
            if microbatches == 1:
                return g, l, m, entry
            if grads is None:
                grads = [torch.zeros_like(p) for p in leaves]
            for a, gi in zip(grads, g):
                a.add_(gi.to(a.dtype) / microbatches)
            ls.append(l.detach())
            ms.append(m)
        loss = torch.stack(ls).mean()
        mets = {k: torch.stack([m[k].detach().to(loss.device) for m in ms]).mean()
                for k in ms[0]}
        return grads, loss, mets, entry

    def train_step(state, batch):
        params = state["params"]
        leaves = list(params.parameters())
        mesh = current_mesh()
        specs = None
        if mesh is None:
            grads, loss, mets, _ = grads_of(params, leaves, batch, mesh)
        else:
            specs = list(state["specs"]["params"].values())
            with _working_copies(params, specs, mesh) as keep_shards:
                grads, loss, mets, entry = grads_of(params, leaves, batch,
                                                    mesh)
                with axis_rules({"act_batch": entry}):
                    grads = keep_shards(grads)
        lr = lr_fn(state["opt"]["step"])
        _, state["opt"], om = apply_updates(leaves, grads, state["opt"],
                                            opt_cfg, lr, specs=specs,
                                            mesh=mesh)
        metrics = {"loss": loss.detach(), "lr": lr,
                   **{k: v.detach() for k, v in mets.items()}, **om}
        return state, metrics

    return train_step

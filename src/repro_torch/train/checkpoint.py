"""Fault-tolerant checkpointing: tensor-chunked npz + JSON manifest —
``repro.train.checkpoint``, in the JAX package's on-disk format.

A checkpoint is ``<ckpt_dir>/step_%08d/`` holding ``tensors.npz`` and
``manifest.json`` ({"step", "keys": {key: {"shape", "dtype"}}}), written
under ``.tmp_step_%08d`` and renamed, so a preemption mid-write never
corrupts the latest checkpoint; the newest ``keep`` survive.

Keys are the JAX package's ``jax.tree_util.keystr`` paths of its train
state ({"params": ..., "opt": {"m", "v", "step"}}), built here from the
port's parameter names by string formatting: ``stages.0.0.mixer.wq``
becomes ``['params']['stages'][0][0]['mixer']['wq']``, its first moment
``['opt']['m']['stages'][0][0]['mixer']['wq']`` (and ``...['q']`` /
``...['qscale']`` for int8 moments), the step ``['opt']['step']``.  An
unscanned stage's leaves (a leading layer axis of 1 in the port, none in
JAX) are stored without that axis.  So the arrays are JAX's, and a
checkpoint written by either package restores in the other.

Which leaves interoperate: float32, int8 and int32 leaves both ways.
numpy has no bfloat16, so a bf16 leaf (``param_dtype="bfloat16"``
configs) is stored as its 16-bit patterns (uint16) under the manifest
dtype "bfloat16", and read back bit-exact; the port also reads JAX's bf16
leaves (``np.savez`` writes ml_dtypes' bfloat16 as 2-byte voids, under the
same manifest dtype), but JAX's restore reads bf16 leaves from neither
package's files.

Sharded states (``train_step.shard_state``): under the state's mesh,
``save_checkpoint`` gathers every leaf and the mesh's first rank writes
the logical arrays, so a checkpoint written from N ranks restores at any
M, on one device, and in JAX; ``restore_checkpoint(mesh=, specs=)``
reads each logical array and keeps the rank's slice of it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import (axis_group, axis_names,
                                           current_mesh, gather_tensor,
                                           local_slices)

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


def _keystr(names) -> str:
    """JAX's ``keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{n}]" if n.isdigit() else f"['{n}']" for n in names)


def _param_keys(params) -> Iterator[Tuple[str, bool]]:
    """(key below ['params'], whether the leaf carries the port's extra
    leading layer axis) for each parameter, in ``parameters()`` order.
    A stage leaf's leading axis is its stage's repeats; JAX stacks only
    stages of more than one repeat."""
    for name, p in params.named_parameters():
        path = name.split(".")
        yield _keystr(path), path[0] == "stages" and p.shape[0] == 1


def flatten_state(state) -> Dict[str, Tuple[torch.Tensor, bool]]:
    """{key: (tensor, unstack)} over a port train state
    ({"params": Model, "opt": {"m": [...], "v": [...], "step"}}): the
    parameters, each moment (an int8 moment's ``q`` and ``qscale``) and
    the step, keyed as JAX's ``keystr`` paths (module docstring)."""
    return {k: (t, unstack) for k, t, unstack, _ in walk_state(state)}


def walk_state(state, specs=None):
    """(key, tensor, unstack, spec) for every leaf of a train state, in
    ``flatten_state``'s order, with its spec from the ``train_state_specs``
    tree ``specs`` (None without)."""
    leaves = list(state["params"].parameters())
    opt = state["opt"]
    n = len(leaves)
    sp = ({"p": list(specs["params"].values()), **specs["opt"]} if specs
          else {"p": [None] * n, "m": [None] * n, "v": [None] * n})
    for i, ((key, unstack), p) in enumerate(zip(_param_keys(state["params"]),
                                                leaves)):
        yield "['params']" + key, p, unstack, sp["p"][i]
        for name in ("m", "v"):
            moment, spec = opt[name][i], sp[name][i]
            base = f"['opt']['{name}']" + key
            if isinstance(moment, dict):
                for k, t in moment.items():
                    yield (base + f"['{k}']", t, unstack,
                           spec[k] if spec is not None else None)
            else:
                yield base, moment, unstack, spec
    yield "['opt']['step']", opt["step"], False, () if specs else None


def _to_host(t: torch.Tensor, unstack: bool) -> np.ndarray:
    """A host copy of ``t`` as numpy, never a view of ``t``'s storage: on a
    CPU tensor ``.cpu()`` is the same storage, which the next in-place
    step would change under a background writer.  bf16 as uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if unstack:
        t = t[0]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(ckpt_dir, state, step: int, *, background: bool = False,
                    keep: int = 3) -> Optional[threading.Thread]:
    """Write ``<ckpt_dir>/step_<N>/``.  The state is copied to host memory
    before this returns; with ``background=True`` a writer thread does the
    file IO and is returned (join it before the next save).

    A sharded state (one with "specs") is saved under its mesh (it raises
    outside one), by every rank of it: each leaf is gathered whole, and the mesh's first rank
    writes.  Without ``background`` every rank returns once the checkpoint
    is on disk; with it, the writer's thread is the first rank's (None on
    the others), and the caller joins it and synchronizes the ranks."""
    ckpt_dir = Path(ckpt_dir)
    mesh = current_mesh() if "specs" in state else None
    if "specs" in state and mesh is None:
        raise ValueError("a sharded state is gathered on its own mesh: "
                         "call save_checkpoint under use_mesh(its mesh)")
    writes = True
    if mesh is not None:
        import torch.distributed as dist

        group = axis_group(mesh, axis_names(mesh))
        writes = dist.get_rank() == int(mesh.mesh.flatten()[0])
    host, dtypes = {}, {}
    for key, t, unstack, spec in walk_state(state, state.get("specs")):
        if mesh is not None:
            t = gather_tensor(t, spec, mesh)
        if writes:
            host[key] = _to_host(t, unstack)
            dtypes[key] = (_BF16 if t.dtype == torch.bfloat16
                           else str(host[key].dtype))
    if not writes:
        if not background:
            dist.barrier(group=group)  # the first rank has written
        return None

    def _write():
        final = ckpt_dir / f"step_{step:08d}"
        tmp = ckpt_dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "tensors.npz", **host)
        manifest = {"step": step,
                    "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                             for k, v in host.items()}}
        (tmp / _MANIFEST).write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if background:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if mesh is not None:
        dist.barrier(group=group)
    return None


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for p in ckpt_dir.glob("step_*")
             if (m := re.match(r"step_(\d+)$", p.name))
             and (p / _MANIFEST).exists()]
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir, state, *, step: Optional[int] = None,
                       mesh=None, specs=None):
    """Copy checkpoint ``step`` (default: the latest) into ``state``, a
    port train state of the same structure (the loop's fresh state), in
    place on its tensors' devices, and return it.  Every leaf of
    ``state`` must be in the file with its shape.  With ``mesh`` and
    ``specs`` (a ``train_state_specs`` tree of the logical shapes),
    ``state`` is a sharded state on ``mesh`` and each leaf receives this
    rank's slice of the logical array; the state keeps ``specs``."""
    sharded = mesh is not None and specs is not None
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    dtypes = {k: v["dtype"] for k, v in
              json.loads((d / _MANIFEST).read_text())["keys"].items()}
    with np.load(d / "tensors.npz") as data:
        for key, t, unstack, spec in walk_state(state, specs if sharded else None):
            arr = data[key]
            if dtypes[key] == _BF16:
                src = torch.from_numpy(arr.view(np.uint16).view(np.int16)
                                       .copy()).view(torch.bfloat16)
            else:
                src = torch.from_numpy(np.array(arr))
            if unstack:
                src = src[None]
            if sharded:
                src = src[local_slices(spec, src.shape, mesh)]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)}, "
                                 f"state shape {tuple(t.shape)}")
            t.copy_(src)
    if sharded:
        state["specs"] = specs
    return state

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

Restoring onto a mesh (``mesh=``, ``specs=``) comes with multi-GPU
training.
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
    out = {}
    leaves = list(state["params"].parameters())
    opt = state["opt"]
    for (key, unstack), p, m, v in zip(_param_keys(state["params"]), leaves,
                                       opt["m"], opt["v"]):
        out["['params']" + key] = (p, unstack)
        for name, moment in (("m", m), ("v", v)):
            base = f"['opt']['{name}']" + key
            if isinstance(moment, dict):
                for k, t in moment.items():
                    out[base + f"['{k}']"] = (t, unstack)
            else:
                out[base] = (moment, unstack)
    out["['opt']['step']"] = (opt["step"], False)
    return out


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
    file IO and is returned (join it before the next save)."""
    ckpt_dir = Path(ckpt_dir)
    host, dtypes = {}, {}
    for key, (t, unstack) in flatten_state(state).items():
        host[key] = _to_host(t, unstack)
        dtypes[key] = _BF16 if t.dtype == torch.bfloat16 else str(host[key].dtype)

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
    ``state`` must be in the file with its shape."""
    if mesh is not None or specs is not None:
        raise NotImplementedError(
            "restoring onto a mesh is not ported yet: it comes with "
            "multi-GPU training")
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    dtypes = {k: v["dtype"] for k, v in
              json.loads((d / _MANIFEST).read_text())["keys"].items()}
    with np.load(d / "tensors.npz") as data:
        for key, (t, unstack) in flatten_state(state).items():
            arr = data[key]
            if dtypes[key] == _BF16:
                src = torch.from_numpy(arr.view(np.uint16).view(np.int16)
                                       .copy()).view(torch.bfloat16)
            else:
                src = torch.from_numpy(np.array(arr))
            if unstack:
                src = src[None]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)}, "
                                 f"state shape {tuple(t.shape)}")
            t.copy_(src)
    return state

"""Mesh construction for the port: a ``torch.distributed`` ``DeviceMesh``
over the ranks of one job.

Counterpart of ``repro.launch.mesh.make_mesh``.  JAX builds its mesh from
the devices one process sees; the port runs one process per rank, so the
mesh is a ``DeviceMesh`` over the default process group (NCCL on ``cuda``,
gloo on ``cpu``).  ``make_mesh`` starts that group when it is not running
yet, from ``init_method`` or from the environment (``RANK``, ``WORLD_SIZE``
and ``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` sets them); under
the rank launcher ``launch.ranks`` the group is already running, over a
``file://`` store.

JAX's ``make_production_mesh`` waits for the port of ``core/affinity.py``:
its ``pinned`` ordering is that module's topology model (ROADMAP.md,
Queue 1 item 4).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: Optional[str] = None,
              init_method: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over every
    rank of the job (e.g. ``(4,), ("model",)`` or ``(2, 2), ("data",
    "model")``).  ``device`` is ``cuda`` (the default; NCCL, one card per
    rank on the host, bound to this rank's ``LOCAL_RANK``) or ``cpu``
    (gloo).  Raises when the world size is not the product of ``shape``,
    and, on ``cuda``, when there is no card or fewer cards than ranks on
    the host: NCCL refuses two ranks on one card, and nothing drops to the
    CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE",
                                        os.environ.get("WORLD_SIZE", "1")))
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < ranks_here or have == 0:
            raise RuntimeError(
                f"a cuda mesh needs one CUDA device per rank on the host: "
                f"{ranks_here} ranks, {have} devices")
        # this rank's card: LOCAL_RANK, else RANK
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", os.environ.get("RANK", "0"))))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if init_method is None:
            dist.init_process_group(backend)  # env:// (torchrun's variables)
        else:
            dist.init_process_group(
                backend, init_method=init_method,
                rank=int(os.environ.get("RANK", "0")),
                world_size=int(os.environ.get("WORLD_SIZE", "1")))
    n = dist.get_world_size()
    if n != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"job has {n}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)

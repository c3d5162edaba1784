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

``make_production_mesh`` is JAX's (16, 16) or (2, 16, 16) production
mesh over a job of 256 or 512 ranks.  Its ``pinned`` order is
``core/affinity.py``'s, which keeps each 'model' group inside NVLink
domains as far as they reach; JAX discovers a TPU's topology and falls
back to enumeration order where it cannot, while here the order is
computed and nothing falls back.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import affinity


def make_production_mesh(*, multi_pod: bool = False, pinned: bool = True,
                         device: Optional[str] = None,
                         init_method: Optional[str] = None):
    """JAX's production mesh: (16, 16) over ('data', 'model'), or with
    ``multi_pod`` (2, 16, 16) over ('pod', 'data', 'model'), as a
    ``DeviceMesh`` built from an explicit rank array over the job's ranks
    (the group is started as ``make_mesh`` starts it).  With ``pinned``
    each pod's ranks follow ``affinity.pinned_placement``'s order (the
    second pod's offset by 256), else enumeration order.  Raises where the
    job does not have exactly 256 (512 with ``multi_pod``) ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    dev = _start_group(device, init_method)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks, "
                         f"the job has {world}")
    if pinned:
        order = affinity.pinned_placement(16, 16).device_order
        ranks = np.stack([order + 256 * p for p in range(n // 256)])
    else:
        ranks = np.arange(n)
    return DeviceMesh(dev.type, torch.as_tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)


def _start_group(device: Optional[str], init_method: Optional[str]):
    """The mesh's device (``cuda`` unless asked otherwise): binds this
    rank's card on ``cuda`` and starts the default group (NCCL on
    ``cuda``, gloo on ``cpu``) unless one is running."""
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
    return dev


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
    dev = _start_group(device, init_method)
    n = dist.get_world_size()
    if n != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"job has {n}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)

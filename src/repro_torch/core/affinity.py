"""Topology-aware rank ordering: the GPU analogue of the paper's ``taskset``
pinning (Fig. 3).

Counterpart of ``repro.core.affinity``.  The paper pins each Matlab/Octave
process to a physically contiguous block of cores so its OpenMP threads stay
near their data.  On a GPU cluster the analogous decision is which GPU each
(data, model) mesh coordinate maps to: the 'model' axis carries the
per-layer tensor-parallel collectives, so its members should share a fast
link.

JAX models a TPU pod's 2-D torus.  Here the topology is NVLink domains: a
domain is one HGX/DGX H100 node, ``GPUS_PER_DOMAIN`` GPUs behind NVSwitch,
where any two GPUs are one hop apart at NVLink's rate; GPUs of two domains
talk over the nodes' network.  A ring step costs 1 inside a domain and
``CROSS_DOMAIN_COST`` (the ratio of the two rates) across domains.

``pinned_placement`` keeps each 'model' group node-contiguous (ranks are
enumerated node by node, so this is row-major order); ``naive_placement``
is an arbitrary permutation, an unpinned scheduler's placement.

One point differs from JAX on purpose.  A ring collective moves at the rate
of its slowest link, so ``collective_slowdown`` is the cost of the ring's
slowest step, where JAX's torus model uses the mean hop count.
``axis_ring_cost`` keeps JAX's meaning, the mean cost of a step, and
``placement_table`` carries both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

# NVIDIA DGX H100 datasheet: 8 H100 GPUs a node behind NVSwitch, NVLink 4 at
# 900 GB/s bidirectional a GPU (450 GB/s each way, ``roofline.H100.ici_bw``);
# one 400 Gb/s ConnectX-7 port a GPU for the cluster network, 50 GB/s each
# way
GPUS_PER_DOMAIN = 8
NVLINK_BW = 450e9
NETWORK_BW = 50e9
CROSS_DOMAIN_COST = NVLINK_BW / NETWORK_BW  # 9.0


def domain_of(rank: int, gpus_per_domain: int = GPUS_PER_DOMAIN) -> int:
    """The NVLink domain (node) of a rank, ranks enumerated node by node."""
    return int(rank) // gpus_per_domain


def step_cost(a: int, b: int, gpus_per_domain: int = GPUS_PER_DOMAIN) -> float:
    """Cost of one ring step from rank a to rank b: 0 to itself, 1 inside
    a domain, ``CROSS_DOMAIN_COST`` across domains."""
    if a == b:
        return 0.0
    if domain_of(a, gpus_per_domain) == domain_of(b, gpus_per_domain):
        return 1.0
    return CROSS_DOMAIN_COST


def ring_steps(order: Sequence[int],
               gpus_per_domain: int = GPUS_PER_DOMAIN) -> List[float]:
    """The cost of each step of one ring pass over ``order`` (wrap
    included)."""
    n = len(order)
    return [step_cost(order[i], order[(i + 1) % n], gpus_per_domain)
            for i in range(n)]


def ring_cost(order: Sequence[int],
              gpus_per_domain: int = GPUS_PER_DOMAIN) -> float:
    """Total cost of one ring pass over ranks in ``order`` (wrap
    included), as JAX's ``ring_cost`` totals hops."""
    return float(sum(ring_steps(order, gpus_per_domain)))


@dataclass
class MeshPlacement:
    name: str
    device_order: np.ndarray  # (data, model) -> rank
    axis_ring_cost: Dict[str, float]  # mean cost of a ring step, per axis


def _rings(order: np.ndarray, axis: str) -> List[np.ndarray]:
    """The rings of one axis of a (data, model) order."""
    if axis == "model":
        return [order[i, :] for i in range(order.shape[0])]
    if axis == "data":
        return [order[:, j] for j in range(order.shape[1])]
    raise ValueError(f"axis must be 'data' or 'model', got {axis!r}")


def pinned_placement(data: int = 16, model: int = 16) -> MeshPlacement:
    """'model' groups node-contiguous (row-major ranks); 'data' across."""
    return _score("pinned", np.arange(data * model).reshape(data, model))


def naive_placement(data: int = 16, model: int = 16,
                    seed: int = 0) -> MeshPlacement:
    """Arbitrary (shuffled) enumeration: an unpinned scheduler's placement."""
    rng = np.random.RandomState(seed)
    return _score("naive", rng.permutation(data * model).reshape(data, model))


def _score(name: str, order: np.ndarray) -> MeshPlacement:
    cost = {axis: float(np.mean([ring_cost(r) / len(r)
                                 for r in _rings(order, axis)]))
            for axis in ("model", "data")}
    return MeshPlacement(name, order, cost)


def collective_slowdown(placement: MeshPlacement, axis: str) -> float:
    """Wire-time multiplier against a ring of NVLink hops for collectives
    on ``axis``: the cost of the slowest step of its slowest ring."""
    return float(max(max(ring_steps(r))
                     for r in _rings(placement.device_order, axis)))


def placement_table() -> List[Dict]:
    """JAX's rows: per placement, each axis's mean ring-step cost (in
    NVLink hops, JAX's ``*_ring_hops_per_step``) and its collective
    slowdown (here the slowest step)."""
    rows = []
    for p in (pinned_placement(), naive_placement()):
        rows.append({
            "placement": p.name,
            "model_ring_hops_per_step": p.axis_ring_cost["model"],
            "data_ring_hops_per_step": p.axis_ring_cost["data"],
            "model_collective_slowdown": collective_slowdown(p, "model"),
            "data_collective_slowdown": collective_slowdown(p, "data"),
        })
    return rows

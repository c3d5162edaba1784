"""Elastic rescale: move a training state onto a different mesh —
``repro.train.elastic``.

On a node failure the launcher picks the largest healthy factorization
(``rescale_plan``), and a job of that many ranks restores the latest
checkpoint, stored in logical layout (``train.checkpoint``), onto the new
mesh.  ``reshard_state`` is the live-state path: a sharded state moved to
another mesh of the same job (the same ranks, another factorization),
each leaf gathered over its old spec and cut to its new one.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.parallel.sharding import current_mesh, make_rules, use_mesh
from repro_torch.train.train_step import gather_state, shard_state


def rescale_plan(n_healthy: int, prefer_model: int = 16) -> Tuple[int, int]:
    """Largest (data, model) mesh <= n_healthy, keeping TP width if we can.

    Preference order keeps the TP width, but never at the cost of idling
    >10% of the healthy nodes (a 3-node remainder should run 3x1, not 1x2).
    """
    candidates = []
    for model in (prefer_model, prefer_model // 2, prefer_model * 2,
                  8, 4, 2, 1):
        if model and model <= n_healthy:
            data = n_healthy // model
            used = data * model
            if used >= 0.9 * n_healthy:
                return (data, model)
            candidates.append((used, data, model))
    used, data, model = max(candidates)
    return (data, model)


def reshard_state(state, new_mesh, rules=None):
    """A train state on ``new_mesh`` under ``rules`` (default:
    ``make_rules(new_mesh)``), returned.  A sharded state (one with
    "specs") is gathered on the ambient mesh, its old one, into a new state
    first, and left as it is; a whole state is placed in place.  Every
    rank of the job calls this."""
    if "specs" in state:
        if current_mesh() is None:
            raise ValueError("a sharded state is gathered on its own mesh: "
                             "call reshard_state under use_mesh(old_mesh)")
        state = gather_state(state)
    with use_mesh(new_mesh, rules or make_rules(new_mesh)):
        return shard_state(state)

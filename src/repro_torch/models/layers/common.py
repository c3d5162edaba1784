"""Shared initializers — ``repro.models.layers.common`` with a
``torch.Generator`` in place of a JAX key.  Same scheme (truncated normal
on [-2, 2], scaled by fan_in^-1/2 for dense weights), not the same bits."""
from __future__ import annotations

import torch


def dense_init(generator, shape, in_axis_size=None, *, device=None):
    """Truncated-normal fan-in init (LeCun-style), float32."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = (1.0 / max(1, fan_in)) ** 0.5
    return embed_init(generator, shape, device=device).mul_(std)


def embed_init(generator, shape, *, device=None):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)

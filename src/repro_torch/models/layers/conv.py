"""Causal depthwise 1-D convolution (the mLSTM block's; Mamba's later) —
``repro.models.layers.conv``.

The weights are cast to x's dtype at use, as in JAX; the sum of shifted
slices runs in that dtype, in JAX's order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_depthwise_conv(x, conv_w, conv_b):
    """x: (B, S, C); conv_w: (K, C); conv_b: (C,).  Causal: x is padded
    with K - 1 zeros on the left."""
    K = conv_w.shape[0]
    dt = x.dtype
    xp = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S, :] * conv_w[i].to(dt)
    return out + conv_b.to(dt)


def conv_step(x_t, state, conv_w, conv_b):
    """One decode step.  x_t: (B, C); state: (B, K - 1, C), the last K - 1
    inputs.  Returns (out (B, C), the new state)."""
    dt = x_t.dtype
    window = torch.cat([state, x_t[:, None, :]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,kc->bc", window, conv_w.to(dt)) + conv_b.to(dt)
    return out, window[:, 1:, :]

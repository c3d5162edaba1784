"""Int8 block-quantized optimizer-state storage — ``repro.optim.quantized_state``.

Moments are stored as int8 with a float32 scale per last-axis row (absmax
scaling), dequantized to float32 inside the update and requantized: a
standard 8-bit-Adam construction.  The port's stage leaves carry a leading
layer axis (of 1 for an unscanned stage, where JAX has none); the rows are
last-axis rows either way, so the scales are JAX's.
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor):
    """x: float32 -> {"q": int8, "qscale": float32 rowwise (last axis kept
    as 1)}: ``round`` half to even, clipped to [-127, 127]; an all-zero row
    gets scale 1."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "qscale": scale.float()}


def dequantize(qs) -> torch.Tensor:
    return qs["q"].float() * qs["qscale"]


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "qscale"}

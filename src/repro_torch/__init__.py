"""PyTorch/CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs/``, ``models/``, ``models/layers/``, ``kernels/``, ``serve/``,
``launch/``) and keeps its file and function names, but imports nothing of
it.  ``bridge`` turns the JAX package's numpy-converted parameter and state
pytrees into this package's tensors, which is how the tests hold the two
together.

Every entry point runs on the card unless the caller asks for the CPU with
``device="cpu"``: ``resolve_device`` is the one place that decides.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when a CUDA device is asked for (or implied) and none
    is present — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev

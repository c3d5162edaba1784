"""Architecture registry: ``--arch <id>`` lookup, input specs, skip table.

``input_specs`` gives a dry-run cell's inputs as (shape, dtype) pairs, the
counterpart of the JAX registry's ``ShapeDtypeStruct``s: ``launch.dryrun``
makes them as tensors without data.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME, ModelCfg,
                                      ShapeCfg)

_MODULES = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3_2_vision_11b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

ARCH_NAMES = tuple(_MODULES)

# archs with a sub-quadratic long-context path (run long_500k)
_SUBQUADRATIC = {"gemma3-4b", "jamba-1.5-large-398b", "xlstm-350m"}


def get_config(name: str, smoke: bool = False) -> ModelCfg:
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.FULL


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the documented skip reason."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only: no autoregressive decode step"
    if shape_name == "long_500k" and arch not in _SUBQUADRATIC:
        return "pure full-attention arch: no sub-quadratic path for 512k decode"
    return None


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape_name[, skip_reason])."""
    for arch in ARCH_NAMES:
        for shape in ALL_SHAPES:
            r = skip_reason(arch, shape.name)
            if r is None:
                yield (arch, shape.name)
            elif include_skipped:
                yield (arch, shape.name, r)


# ---------------------------------------------------------------------------
# Input specs ((shape, dtype) pairs: never allocate)


def input_specs(cfg: ModelCfg,
                shape: ShapeCfg) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Model inputs for a (cfg, shape) cell as {key: (shape, dtype)}.

    train    -> {tokens, labels [, feats/img_feats]}
    prefill  -> same minus labels (counted as a forward pass)
    decode   -> {tokens_t}; the KV cache is derived separately (it is state,
                not input — see launch/dryrun.py).
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)
    if shape.kind == "decode":
        return {"tokens_t": ((B, 1), i32)}
    specs: Dict = {}
    if cfg.frontend == "audio":
        specs["feats"] = ((B, S, cfg.d_model // 2), act)
    else:
        specs["tokens"] = ((B, S), i32)
    if cfg.frontend == "vision":
        specs["img_feats"] = ((B, cfg.n_img_tokens, cfg.d_model // 2), act)
    if shape.kind == "train":
        specs["labels"] = ((B, S), i32)
    return specs

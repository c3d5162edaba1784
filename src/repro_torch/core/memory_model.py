"""Analytic per-device HBM model for each (arch x shape x mesh) cell.

A copy of the JAX package's ``core/memory_model.py`` (the port imports
nothing of that package), on ``repro_torch.configs``.  It computes what a
device has to hold for one step:

  params + optimizer state + gradient/accum buffer
  + saved remat boundaries (seq-sharded)
  + logits block + one block's transient working set
  (decode: params + KV cache/recurrent state + small step buffers)

and (``analytic_traffic``) the HBM bytes one step moves, the memory term of
``core.roofline.roofline_terms``.  ``fits_hbm`` defaults to one H100's
80 GiB.  It is a model: ``chip_smoke.py`` prints ``estimate`` beside a
training step's measured peak, without gating on it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs import param_count
from repro_torch.configs.base import ModelCfg, ShapeCfg


def _dtype_size(name: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[name]


def estimate(cfg: ModelCfg, shape: ShapeCfg, mesh_shape: Dict[str, int],
             microbatches: int = 1, opt_int8: bool = None) -> Dict[str, float]:
    n_dev = int(np.prod(list(mesh_shape.values())))
    data = int(np.prod([v for k, v in mesh_shape.items() if k in ("pod", "data")]))
    model = mesh_shape.get("model", 1)
    P = param_count(cfg)
    psz = _dtype_size(cfg.param_dtype)
    if opt_int8 is None:
        opt_int8 = P > 50e9

    params_b = P * psz / n_dev
    opt_b = (2 * P / n_dev) if opt_int8 else (8 * P / n_dev)
    grads_b = P * psz / n_dev  # accum buffer (microbatched) or transient

    d = cfg.d_model
    out: Dict[str, float] = {"params": params_b, "opt_state": opt_b}

    if shape.kind == "decode":
        kv = 0.0
        state = 0.0
        for st in cfg.stages:
            for blk in st.pattern:
                if blk.mixer == "attn":
                    a = blk.attn
                    cap = min(shape.seq_len, a.window or shape.seq_len)
                    kv += (st.repeats * 2 * shape.global_batch * cap
                           * a.num_kv_heads * a.head_dim * 2)
                elif blk.mixer == "mamba":
                    d_in = blk.mamba.expand * d
                    state += st.repeats * shape.global_batch * d_in * (
                        blk.mamba.d_state * 4 + (blk.mamba.d_conv - 1) * 2)
                elif blk.mixer == "mlstm":
                    d_in = int(blk.xlstm.proj_factor * d)
                    hd = d_in // blk.xlstm.num_heads
                    state += st.repeats * shape.global_batch * (
                        blk.xlstm.num_heads * hd * hd * 4 + 3 * d_in * 2)
                elif blk.mixer == "slstm":
                    state += st.repeats * shape.global_batch * 4 * d * 4
        out["kv_cache"] = kv / n_dev  # sharded over batch(+seq for long ctx)
        out["recurrent_state"] = state / max(data, 1)
        out["step_buffers"] = shape.global_batch * d * 2 * 8 / max(data, 1)
        out.pop("opt_state")
        out["total"] = sum(out.values())
        return out

    # train / prefill
    B_mb = shape.global_batch // microbatches
    tok_local = B_mb * shape.seq_len / data
    n_groups = sum(st.repeats for st in cfg.stages)
    max_pattern = max(len(st.pattern) for st in cfg.stages)
    boundary = tok_local * d * 2 / model  # seq-sharded saved carry
    boundaries_b = boundary * (n_groups + max_pattern)

    # largest single-block live set during backward (bf16 activations)
    per_tok = 0
    for st in cfg.stages:
        for blk in st.pattern:
            t = 0
            if blk.mixer in ("attn", "cross_attn"):
                a = blk.attn
                t += 3 * a.num_heads * a.head_dim * 2  # q,k,v (gathered)
                t += a.num_heads * a.head_dim * 2  # out
            elif blk.mixer == "mamba":
                d_in = blk.mamba.expand * d
                t += 2 * 2 * d_in * 2 + 2 * d_in * 2  # xz, x_c, dt (bf16)
                t += d_in * 4  # f32 recurrence slice amortized
            elif blk.mixer in ("mlstm", "slstm"):
                d_in = int(blk.xlstm.proj_factor * d)
                t += (2 * d_in + 3 * d_in) * 2 + d_in * 4
            if blk.ffn == "mlp":
                t += 3 * blk.mlp.d_ff * 2 / model
            elif blk.ffn == "moe":
                mo = blk.moe
                cf = mo.capacity_factor * mo.top_k
                t += cf * (2 * d + 2 * mo.d_ff) * 2 / model  # dispatched acts
                t += 2 * cf * 2 * 2  # dispatch/combine one-hots (E·C ≈ cf·S)
            per_tok = max(per_tok, t)
    transient_b = tok_local * per_tok * 2.5  # fwd+bwd live-set factor

    logits_b = 3 * tok_local * cfg.vocab_size * 2 / model  # bf16+f32 slices

    out.update({"grads": grads_b, "remat_boundaries": boundaries_b,
                "block_transient": transient_b, "logits": logits_b})
    out["total"] = sum(out.values())
    return out


def fits_hbm(total_bytes: float, hbm_bytes: float = 80 * 2**30,
             headroom: float = 0.9) -> bool:
    return total_bytes <= hbm_bytes * headroom


# ---------------------------------------------------------------------------
# Analytic HBM traffic (the roofline memory term): weights read plus
# activation flow, per device and step.


def _block_act_bytes_per_token(cfg: ModelCfg, blk, model: int) -> float:
    """bf16 bytes of activations materialized per token in one block
    (inputs/outputs of the matmuls; model-sharded dims divided by `model`)."""
    d = cfg.d_model
    t = 2 * d * 2  # residual in/out
    if blk.mixer in ("attn", "cross_attn"):
        a = blk.attn
        t += (a.num_heads + 2 * a.num_kv_heads) * a.head_dim * 2  # q,k,v
        t += a.num_heads * a.head_dim * 2  # attn out
    elif blk.mixer == "mamba":
        d_in = blk.mamba.expand * d
        t += (2 * d_in + 3 * d_in) * 2 / model + d_in * 4 / model
    elif blk.mixer in ("mlstm", "slstm"):
        d_in = int(blk.xlstm.proj_factor * d)
        t += 6 * d_in * 2 / model
    if blk.ffn == "mlp":
        t += 3 * blk.mlp.d_ff * 2 / model
    elif blk.ffn == "moe":
        mo = blk.moe
        t += mo.top_k * mo.capacity_factor * (2 * d + 3 * mo.d_ff / model) * 2
    return t


def analytic_traffic(cfg: ModelCfg, shape: ShapeCfg,
                     mesh_shape: Dict[str, int], microbatches: int = 1) -> float:
    """Per-device HBM bytes per step (weights + activations + logits)."""
    n_dev = int(np.prod(list(mesh_shape.values())))
    data = int(np.prod([v for k, v in mesh_shape.items() if k in ("pod", "data")]))
    model = mesh_shape.get("model", 1)
    P = param_count(cfg)
    psz = _dtype_size(cfg.param_dtype)

    if shape.kind == "decode":
        # weight-stationary: each device reads its own param shard once per
        # token; KV cache read once; states rewritten
        kv = estimate(cfg, shape, mesh_shape)
        return P * psz / n_dev + kv.get("kv_cache", 0.0) + kv.get(
            "recurrent_state", 0.0)

    tok_local = shape.global_batch * shape.seq_len / data
    passes = {"none": 2.0, "dots": 2.5, "full": 3.0}[cfg.remat]
    # ZeRO-3: the full model-shard of weights is (re)gathered and read per
    # microbatch for forward, recompute, and backward-transpose
    weights = passes * microbatches * P * psz / model
    acts = 0.0
    for st in cfg.stages:
        for blk in st.pattern:
            acts += st.repeats * _block_act_bytes_per_token(cfg, blk, model)
    acts *= tok_local * passes
    logits = tok_local * cfg.vocab_size / model * (2 + 4 + 4)  # bf16+f32+grad
    if shape.kind == "prefill":
        weights = P * psz / model
        acts /= passes
        logits = tok_local * cfg.vocab_size / model * 2
    return weights + acts + logits

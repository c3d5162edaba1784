"""Shared builders for architecture configs."""
from __future__ import annotations

from repro_torch.configs.base import (AttnCfg, BlockCfg, MLPCfg, ModelCfg, MoECfg, Stage)


def attn_block(num_heads, num_kv_heads, head_dim, d_ff, *, qkv_bias=False,
               rope_theta=1e6, window=None, causal=True, gated=True,
               act="silu", ffn="mlp", moe=None, cross=False):
    a = AttnCfg(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
                qkv_bias=qkv_bias, rope_theta=rope_theta, window=window,
                causal=causal, cross=cross)
    kw = dict(mixer="cross_attn" if cross else "attn", attn=a, ffn=ffn)
    if ffn == "mlp":
        kw["mlp"] = MLPCfg(d_ff=d_ff, gated=gated, act=act)
    elif ffn == "moe":
        kw["moe"] = moe
    return BlockCfg(**kw)


def dense_lm(name, *, n_layers, d_model, n_heads, n_kv, d_ff, vocab,
             head_dim=None, qkv_bias=False, rope_theta=1e6, tie=True,
             max_seq_len=32768, **model_kw):
    blk = attn_block(n_heads, n_kv, head_dim or d_model // n_heads, d_ff,
                     qkv_bias=qkv_bias, rope_theta=rope_theta)
    return ModelCfg(name=name, d_model=d_model, vocab_size=vocab,
                    stages=(Stage((blk,), n_layers),), tie_embeddings=tie,
                    max_seq_len=max_seq_len, **model_kw)

"""jamba-1.5-large-398b [hybrid] — 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2 [arXiv:2403.19887].

Mamba:attention 7:1 interleave; MoE every other layer.  Pattern (period 8):
positions 0..7 are Mamba except position 4 (attention); odd positions carry
MoE FFNs, even positions dense FFNs.  9 repeats → 72 layers, 9 attention,
36 MoE.  Runs long_500k: only the 9 attention layers hold full-length KV.
~398B total params.
"""
from repro_torch.configs.base import BlockCfg, MambaCfg, MLPCfg, ModelCfg, MoECfg, Stage
from repro_torch.configs.util import attn_block

_MOE = MoECfg(num_experts=16, top_k=2, d_ff=24576, capacity_factor=1.25)
_MAMBA = MambaCfg(d_state=16, d_conv=4, expand=2)


def _mamba_blk(ffn, moe=None, d_ff=24576):
    kw = dict(mixer="mamba", mamba=_MAMBA, ffn=ffn)
    if ffn == "mlp":
        kw["mlp"] = MLPCfg(d_ff=d_ff)
    else:
        kw["moe"] = moe
    return BlockCfg(**kw)


_PATTERN = (
    _mamba_blk("mlp"),
    _mamba_blk("moe", _MOE),
    _mamba_blk("mlp"),
    _mamba_blk("moe", _MOE),
    attn_block(64, 8, 128, 24576),
    _mamba_blk("moe", _MOE),
    _mamba_blk("mlp"),
    _mamba_blk("moe", _MOE),
)

FULL = ModelCfg(
    name="jamba-1.5-large-398b", d_model=8192, vocab_size=65536,
    stages=(Stage(_PATTERN, 9),), tie_embeddings=False,
    max_seq_len=524288, param_dtype="bfloat16",
)

_SMOE = MoECfg(num_experts=4, top_k=2, d_ff=128)
_SMAMBA = MambaCfg(d_state=4, d_conv=4, expand=2)
SMOKE = ModelCfg(
    name="jamba-smoke", d_model=64, vocab_size=512,
    stages=(Stage((
        BlockCfg(mixer="mamba", mamba=_SMAMBA, ffn="mlp", mlp=MLPCfg(d_ff=128)),
        BlockCfg(mixer="mamba", mamba=_SMAMBA, ffn="moe", moe=_SMOE),
        attn_block(4, 2, 16, 128, rope_theta=1e4),
    ), 2),),
    tie_embeddings=False, max_seq_len=128,
)

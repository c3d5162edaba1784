"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 + shared expert, alternating dense/MoE
layers [hf:meta-llama/Llama-4-*].  ~400B total / ~17B active params.

"Early fusion" multimodality is out of the backbone scope (text tokens only;
the assignment marks this entry [moe], not [vlm]).
"""
from repro_torch.configs.base import MLPCfg, ModelCfg, MoECfg, Stage
from repro_torch.configs.util import attn_block

_MOE = MoECfg(num_experts=128, top_k=1, d_ff=8192, capacity_factor=1.25,
              dense_residual=MLPCfg(d_ff=8192))  # shared expert
_DENSE = attn_block(40, 8, 128, 8192, rope_theta=5e5)
_MOE_BLK = attn_block(40, 8, 128, 8192, rope_theta=5e5, ffn="moe", moe=_MOE)

FULL = ModelCfg(
    name="llama4-maverick-400b-a17b", d_model=5120, vocab_size=202048,
    stages=(Stage((_DENSE, _MOE_BLK), 24),), tie_embeddings=False,
    max_seq_len=32768, param_dtype="bfloat16",
)

_SM = MoECfg(num_experts=8, top_k=1, d_ff=128, dense_residual=MLPCfg(d_ff=128))
SMOKE = ModelCfg(
    name="llama4-maverick-smoke", d_model=64, vocab_size=512,
    stages=(Stage((attn_block(4, 2, 16, 128, rope_theta=1e4),
                   attn_block(4, 2, 16, 128, rope_theta=1e4, ffn="moe", moe=_SM)), 1),),
    tie_embeddings=False, max_seq_len=128,
)

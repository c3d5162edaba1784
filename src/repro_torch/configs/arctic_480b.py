"""arctic-480b [moe] — 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual FFN in every layer
[hf:Snowflake/snowflake-arctic-base].  ~480B total / ~17B active.
"""
from repro_torch.configs.base import MLPCfg, ModelCfg, MoECfg, Stage
from repro_torch.configs.util import attn_block

_MOE = MoECfg(num_experts=128, top_k=2, d_ff=4864, capacity_factor=1.25,
              dense_residual=MLPCfg(d_ff=4864))

FULL = ModelCfg(
    name="arctic-480b", d_model=7168, vocab_size=32000,
    stages=(Stage((attn_block(56, 8, 128, 4864, ffn="moe", moe=_MOE),), 35),),
    tie_embeddings=False, max_seq_len=32768, param_dtype="bfloat16",
)

_SM = MoECfg(num_experts=8, top_k=2, d_ff=96, dense_residual=MLPCfg(d_ff=96))
SMOKE = ModelCfg(
    name="arctic-480b-smoke", d_model=64, vocab_size=512,
    stages=(Stage((attn_block(4, 2, 16, 96, rope_theta=1e4, ffn="moe", moe=_SM),), 2),),
    tie_embeddings=False, max_seq_len=128,
)

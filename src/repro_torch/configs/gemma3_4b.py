"""gemma3-4b [dense] — 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention interleave, 128k context [hf:google/gemma-3-*].
Local layers: sliding window 1024, rope theta 10k; global layers: full
attention, rope theta 1M.  34 layers = 5×(5 local + 1 global) + 4 local.
Runs long_500k: local layers keep only window-sized KV; the 1-in-6 global
layers hold full 512k KV (linear per decode step).
"""
from repro_torch.configs.base import ModelCfg, Stage
from repro_torch.configs.util import attn_block

_LOCAL = attn_block(8, 4, 256, 10240, window=1024, rope_theta=1e4)
_GLOBAL = attn_block(8, 4, 256, 10240, rope_theta=1e6)

FULL = ModelCfg(
    name="gemma3-4b", d_model=2560, vocab_size=262144,
    stages=(Stage((_LOCAL,) * 5 + (_GLOBAL,), 5), Stage((_LOCAL,) * 4, 1)),
    tie_embeddings=True, max_seq_len=524288,
)

_L = attn_block(4, 2, 16, 128, window=16, rope_theta=1e4)
_G = attn_block(4, 2, 16, 128, rope_theta=1e4)
SMOKE = ModelCfg(
    name="gemma3-4b-smoke", d_model=64, vocab_size=512,
    stages=(Stage((_L, _L, _G), 1),), tie_embeddings=True, max_seq_len=128,
)

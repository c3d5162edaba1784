"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 [hf:meta-llama/Llama-3.2-11B-Vision].

Cross-attention image layers every 5th layer (8 of 40).  The vision tower is
a STUB: ``img_feats`` arrive as precomputed patch embeddings
(B, n_img_tokens, d_model/2); a linear projects them to d_model and the
cross-attn layers attend over them.  long_500k skipped (pure full attention).
"""
from repro_torch.configs.base import ModelCfg, Stage
from repro_torch.configs.util import attn_block

_SELF = attn_block(32, 8, 128, 14336, rope_theta=5e5)
_CROSS = attn_block(32, 8, 128, 14336, rope_theta=None, cross=True)

FULL = ModelCfg(
    name="llama-3.2-vision-11b", d_model=4096, vocab_size=128256,
    stages=(Stage((_SELF, _SELF, _SELF, _SELF, _CROSS), 8),),
    tie_embeddings=False, frontend="vision", n_img_tokens=1024,
    max_seq_len=32768,
)

SMOKE = ModelCfg(
    name="llama-vision-smoke", d_model=64, vocab_size=512,
    stages=(Stage((attn_block(4, 2, 16, 128, rope_theta=1e4),
                   attn_block(4, 2, 16, 128, rope_theta=None, cross=True)), 2),),
    tie_embeddings=False, frontend="vision", n_img_tokens=16, max_seq_len=128,
)

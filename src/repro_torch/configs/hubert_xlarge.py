"""hubert-xlarge [audio] — 48L d=1280 16H (MHA) d_ff=5120 vocab=504→512.

Encoder-only (same backbone as wav2vec2-XL) [arXiv:2106.07447].  The conv
waveform frontend is a STUB: inputs are precomputed frame embeddings
(B, frames, d_model/2) projected by a linear layer.  Output head predicts
504 cluster targets; vocab is padded to 512 so the vocab axis shards over
the 16-way 'model' axis (8 padding classes, noted).
No decode shapes (encoder has no autoregressive step); prefill_32k lowers
the encoder forward.
"""
from repro_torch.configs.base import ModelCfg, Stage
from repro_torch.configs.util import attn_block

_BLK = attn_block(16, 16, 80, 5120, rope_theta=None, causal=False,
                  gated=False, act="gelu")

FULL = ModelCfg(
    name="hubert-xlarge", d_model=1280, vocab_size=512,
    stages=(Stage((_BLK,), 48),), tie_embeddings=False, is_encoder=True,
    frontend="audio", abs_pos="sinusoidal", max_seq_len=32768,
)

SMOKE = ModelCfg(
    name="hubert-smoke", d_model=64, vocab_size=64,
    stages=(Stage((attn_block(4, 4, 16, 128, rope_theta=None, causal=False,
                              gated=False, act="gelu"),), 2),),
    tie_embeddings=False, is_encoder=True, frontend="audio",
    abs_pos="sinusoidal", max_seq_len=128,
)

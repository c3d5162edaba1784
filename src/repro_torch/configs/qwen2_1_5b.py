"""qwen2-1.5b [dense] — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

GQA + QKV bias [arXiv:2407.10671]. ~1.5B params.
"""
from repro_torch.configs.util import dense_lm

FULL = dense_lm("qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12, n_kv=2,
                head_dim=128, d_ff=8960, vocab=151936, qkv_bias=True,
                rope_theta=1e6, tie=True)

SMOKE = dense_lm("qwen2-1.5b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                 head_dim=16, d_ff=128, vocab=512, qkv_bias=True,
                 rope_theta=1e4, tie=True, max_seq_len=128)

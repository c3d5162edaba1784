"""qwen1.5-4b [dense] — 40L d=2560 20H (kv=20, i.e. MHA) d_ff=6912 vocab=151936.

QKV bias [hf:Qwen/Qwen1.5-*]. ~4B params.
"""
from repro_torch.configs.util import dense_lm

FULL = dense_lm("qwen1.5-4b", n_layers=40, d_model=2560, n_heads=20, n_kv=20,
                head_dim=128, d_ff=6912, vocab=151936, qkv_bias=True,
                rope_theta=1e6, tie=False, param_dtype="bfloat16")

SMOKE = dense_lm("qwen1.5-4b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
                 head_dim=16, d_ff=128, vocab=512, qkv_bias=True,
                 rope_theta=1e4, tie=False, max_seq_len=128)

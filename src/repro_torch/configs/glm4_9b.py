"""glm4-9b [dense] — 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE + GQA + QKV bias [hf:THUDM/glm-4-9b].  (GLM's partial-rotary is
approximated with full RoPE — systems-equivalent; noted in DESIGN.md.)
"""
from repro_torch.configs.util import dense_lm

FULL = dense_lm("glm4-9b", n_layers=40, d_model=4096, n_heads=32, n_kv=2,
                head_dim=128, d_ff=13696, vocab=151552, qkv_bias=True,
                rope_theta=1e6, tie=False)

SMOKE = dense_lm("glm4-9b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                 head_dim=16, d_ff=160, vocab=512, qkv_bias=True,
                 rope_theta=1e4, tie=False, max_seq_len=128)

"""xlstm-350m [ssm] — 24L d=1024 4H vocab=50304 [arXiv:2405.04517].

7:1 mLSTM:sLSTM interleave (xLSTM[7:1]); d_ff=0 in the assignment means no
separate FFN — the mLSTM block carries a 2× pre-up-projection and the sLSTM
block a 4/3 post-up-projection MLP, per the paper.  At the assigned
d_model=1024/24L this counts ~0.49B params (the paper's 350M uses a narrower
block; the assignment shapes are authoritative — noted in DESIGN.md).
Runs long_500k (recurrent state is O(1) per token).  sLSTM's block-diagonal
recurrence is implemented dense (systems-equivalent FLOP shape).
"""
from repro_torch.configs.base import BlockCfg, MLPCfg, ModelCfg, Stage, XLSTMCfg

_M = BlockCfg(mixer="mlstm", xlstm=XLSTMCfg(kind="mlstm", num_heads=4, proj_factor=2.0))
_S = BlockCfg(mixer="slstm", xlstm=XLSTMCfg(kind="slstm", num_heads=4, proj_factor=1.0),
              ffn="mlp", mlp=MLPCfg(d_ff=1368, gated=True, act="gelu"))

FULL = ModelCfg(
    name="xlstm-350m", d_model=1024, vocab_size=50304,
    stages=(Stage((_M,) * 7 + (_S,), 3),), tie_embeddings=True,
    max_seq_len=524288,
)

_MS = BlockCfg(mixer="mlstm", xlstm=XLSTMCfg(kind="mlstm", num_heads=2, proj_factor=2.0))
_SS = BlockCfg(mixer="slstm", xlstm=XLSTMCfg(kind="slstm", num_heads=2, proj_factor=1.0),
               ffn="mlp", mlp=MLPCfg(d_ff=96, gated=True, act="gelu"))
SMOKE = ModelCfg(
    name="xlstm-smoke", d_model=64, vocab_size=512,
    stages=(Stage((_MS, _SS), 2),), tie_embeddings=True, max_seq_len=128,
)

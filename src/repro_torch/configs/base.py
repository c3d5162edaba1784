"""Config dataclasses for the composable model substrate.

Every assigned architecture is expressed as a ``ModelCfg``: a sequence of
``Stage``s, each a repeated ``pattern`` of ``BlockCfg``s.  A copy of the JAX
package's dataclasses (the port imports nothing of that package); the port
stacks a stage's repeats on a leading layer axis and loops over it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Mixers


@dataclass(frozen=True)
class AttnCfg:
    """Self- or cross-attention mixer (GQA with optional RoPE / window)."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0  # None = no RoPE (abs-pos upstream)
    window: Optional[int] = None  # sliding-window size; None = full attention
    causal: bool = True
    cross: bool = False  # kv comes from encoder states (vision frontend)


@dataclass(frozen=True)
class MambaCfg:
    """Mamba-1 selective SSM mixer."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default: ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMCfg:
    """sLSTM / mLSTM mixer (xLSTM, arXiv:2405.04517)."""

    kind: str = "mlstm"  # "mlstm" | "slstm"
    num_heads: int = 4
    proj_factor: float = 2.0  # pre-up-projection factor (mLSTM)


# ---------------------------------------------------------------------------
# FFNs


@dataclass(frozen=True)
class MLPCfg:
    d_ff: int
    gated: bool = True  # SwiGLU-style gate
    act: str = "silu"  # "silu" | "gelu"


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    dense_residual: Optional[MLPCfg] = None  # arctic-style parallel dense FFN
    impl: str = "dispatch"  # "dispatch" (capacity einsum) | "ragged" (dropless)


# ---------------------------------------------------------------------------
# Blocks / stages / model


@dataclass(frozen=True)
class BlockCfg:
    """One residual block = mixer (+ optional FFN sub-block)."""

    mixer: str  # "attn" | "cross_attn" | "mamba" | "mlstm" | "slstm"
    attn: Optional[AttnCfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    ffn: Optional[str] = None  # "mlp" | "moe" | None
    mlp: Optional[MLPCfg] = None
    moe: Optional[MoECfg] = None


@dataclass(frozen=True)
class Stage:
    pattern: Tuple[BlockCfg, ...]
    repeats: int = 1


@dataclass(frozen=True)
class ModelCfg:
    name: str
    d_model: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    max_seq_len: int = 131072
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    is_encoder: bool = False  # bidirectional, no decode step (hubert)
    frontend: Optional[str] = None  # None | "audio" | "vision"
    n_img_tokens: int = 1024  # vision cross-attn stub: patch-embedding count
    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # big archs use bf16 storage (see configs)
    remat: str = "full"  # memory-mode knob: "none" | "dots" | "full"
    seq_shard_residuals: bool = True  # Megatron-SP-style saved boundaries
    attn_q_chunk: int = 128  # q-chunk for the online-softmax attention path
    use_flash: bool = False  # route attention through the Pallas kernel
    abs_pos: str = "none"  # "none" | "sinusoidal" (encoders without RoPE)

    # ---- derived -----------------------------------------------------
    @property
    def n_layers(self) -> int:
        return sum(len(s.pattern) * s.repeats for s in self.stages)

    def replace(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (seq_len × global_batch)


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCfg("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCfg("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCfg("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCfg("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def param_count(cfg: ModelCfg) -> int:
    """Analytic parameter count (for MODEL_FLOPS = 6·N·D and sanity checks)."""
    d = cfg.d_model
    n = cfg.vocab_size * d  # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d
    if cfg.abs_pos == "learned":
        n += cfg.max_seq_len * d
    for st in cfg.stages:
        for blk in st.pattern:
            n += st.repeats * _block_params(cfg, blk)
    n += d  # final norm
    return n


def active_param_count(cfg: ModelCfg) -> int:
    """Params touched per token (MoE: only top_k experts + shared)."""
    d = cfg.d_model
    n = cfg.vocab_size * d
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d
    for st in cfg.stages:
        for blk in st.pattern:
            n += st.repeats * _block_params(cfg, blk, active_only=True)
    n += d
    return n


def _mlp_params(d: int, m: MLPCfg) -> int:
    return d * m.d_ff * (3 if m.gated else 2)


def _block_params(cfg: ModelCfg, blk: BlockCfg, active_only: bool = False) -> int:
    d = cfg.d_model
    n = 0
    if blk.mixer in ("attn", "cross_attn"):
        a = blk.attn
        q = d * a.num_heads * a.head_dim
        kv = 2 * d * a.num_kv_heads * a.head_dim
        o = a.num_heads * a.head_dim * d
        n += q + kv + o + d  # + pre-norm scale
        if a.qkv_bias:
            n += (a.num_heads + 2 * a.num_kv_heads) * a.head_dim
        if blk.mixer == "cross_attn":
            n += d  # kv-norm scale
    elif blk.mixer == "mamba":
        mc = blk.mamba
        d_in = mc.expand * d
        dt_rank = mc.dt_rank or -(-d // 16)
        n += d * 2 * d_in  # in_proj
        n += d_in * mc.d_conv + d_in  # depthwise conv + bias
        n += d_in * (dt_rank + 2 * mc.d_state)  # x_proj
        n += dt_rank * d_in + d_in  # dt_proj
        n += d_in * mc.d_state + d_in  # A_log, D
        n += d_in * d  # out_proj
        n += d  # pre-norm
    elif blk.mixer in ("mlstm", "slstm"):
        xc = blk.xlstm
        if xc.kind == "mlstm":
            d_in = int(xc.proj_factor * d)
            n += d * 2 * d_in  # up proj (x, gate)
            n += 3 * d_in * d_in  # q,k,v
            n += 2 * d_in  # i,f gate biases-as-projections (per-head scalars)
            n += 2 * d_in * xc.num_heads  # igate/fgate projections (low rank)
            n += d_in * d  # down proj
            n += d
        else:  # slstm
            n += 4 * d * d + 4 * d  # i,f,z,o recurrent-free projections
            n += 4 * d * d  # recurrent (block-diagonal approximated dense)
            n += d
            n += _mlp_params(d, MLPCfg(d_ff=int(4 * d * xc.proj_factor / 3), gated=True))
    if blk.ffn == "mlp":
        n += _mlp_params(d, blk.mlp) + d
    elif blk.ffn == "moe":
        mo = blk.moe
        e = mo.top_k if active_only else mo.num_experts
        n += e * d * mo.d_ff * 3 + d * mo.num_experts + d  # experts + router + norm
        if mo.dense_residual is not None:
            n += _mlp_params(d, mo.dense_residual)
    return n

"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory with a
recurrence), after arXiv:2405.04517 — ``repro.models.layers.xlstm``.

Same arithmetic as the JAX package, step for step: training's mLSTM runs
the chunkwise-parallel form (``_mlstm_chunk``, a masked (L x L) quadratic
form within a chunk, the (B, nh, hd, hd) state carried from chunk to
chunk), with the sequential scan (``mlstm_fwd_seq``) kept as its oracle;
serving and the lock-step decode run the single-step cells.  JAX's
``jax.lax.scan`` over chunks or steps becomes a Python loop, and its
``jax.checkpoint`` on the chunk bodies has no counterpart here: the
stage's remat (``transformer.stage_fwd``) recomputes each block in the
backward pass already, and a block's chunk intermediates at the training
shape are a few MiB.  ``lshard`` (sharding only) is dropped.

Parameters keep JAX's leaf names (``up_proj, conv_w, conv_b, xq, xk, xv,
wi, wf, bi, bf, out_norm.scale, down_proj``; ``w_ifzo, r_ifzo, b_ifzo``)
and are cast to the activation dtype at use, as in JAX; the gate weights
and biases JAX uses in float32 (``FLOAT32_LEAVES``) and the head norm's
scale stay float32 in the serving layout too.  State dicts hold one layer
(the views ``transformer.layer_view`` gives); ``init_*_state`` stacks
``layers`` of them on a leading axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMCfg
from repro_torch.models.layers.common import dense_init
from repro_torch.models.layers.conv import causal_depthwise_conv, conv_step

_CONV_K = 4
NEG = -1e30

# leaves JAX reads in float32 (never cast to the activation dtype)
FLOAT32_LEAVES = ("wi", "wf", "bi", "bf", "w_ifzo", "r_ifzo", "b_ifzo")


def _mlstm_dims(d: int, cfg: XLSTMCfg):
    d_in = int(cfg.proj_factor * d)
    hd = d_in // cfg.num_heads
    return d_in, hd


# ---------------------------------------------------------------------------
# mLSTM


def init_mlstm(generator, d: int, cfg: XLSTMCfg, layers: int, *, device=None):
    """Random float32 mLSTM weights stacked over ``layers``: fan-in
    truncated normals, zero input-gate and conv biases, forget biases at
    3.0 (open gates), unit head-norm scales, as in JAX."""
    d_in, hd = _mlstm_dims(d, cfg)
    nh = cfg.num_heads
    L = (layers,)

    def dense(shape, fan_in=None):
        return dense_init(generator, L + shape, fan_in or shape[0], device=device)

    def full(shape, value):
        return torch.full(L + shape, value, dtype=torch.float32, device=device)

    return {
        "up_proj": dense((d, 2 * d_in)),
        "conv_w": dense((_CONV_K, d_in), _CONV_K),
        "conv_b": full((d_in,), 0.0),
        "xq": dense((d_in, d_in)),
        "xk": dense((d_in, d_in)),
        "xv": dense((d_in, d_in)),
        "wi": dense((d_in, nh)),
        "wf": dense((d_in, nh)),
        "bi": full((nh,), 0.0),
        "bf": full((nh,), 3.0),
        "out_norm": {"scale": full((hd,), 1.0)},
        "down_proj": dense((d_in, d), d_in),
    }


def _mlstm_qkv_gates(params, cfg: XLSTMCfg, x_c, x_m):
    """x_c, x_m: (B, S, d_in) -> q, k, v (B, S, nh, hd); log input and
    log forget gates (B, S, nh) in float32."""
    B, S, d_in = x_c.shape
    nh = cfg.num_heads
    hd = d_in // nh
    dt = x_c.dtype
    q = (x_c @ params["xq"].to(dt)).reshape(B, S, nh, hd)
    k = (x_c @ params["xk"].to(dt)).reshape(B, S, nh, hd)
    v = (x_m @ params["xv"].to(dt)).reshape(B, S, nh, hd)
    k = k * (hd ** -0.5)
    xf = x_c.float()
    i_pre = xf @ params["wi"].float() + params["bi"].float()
    f_pre = xf @ params["wf"].float() + params["bf"].float()
    return q, k, v, i_pre, F.logsigmoid(f_pre)


def _mlstm_cell(C, n, m, q_t, k_t, v_t, i_pre, f_pre):
    """One stabilized step (decode and the oracle); C is the scaled memory
    C / exp(m).  C (B, nh, hd, hd); n (B, nh, hd); m, i_pre, f_pre (B, nh);
    q_t, k_t, v_t (B, nh, hd)."""
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)[..., None]  # (B, nh, 1)
    f_g = torch.exp(f_pre + m - m_new)[..., None]
    kf, vf, qf = k_t.float(), v_t.float(), q_t.float()
    C = f_g[..., None] * C + i_g[..., None] * vf[..., :, None] * kf[..., None, :]
    n = f_g * n + i_g * kf
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qf)),
                        torch.exp(-m_new))[..., None]
    return C, n, m_new, num / den


def _mlstm_chunk(C, n, m, q, k, v, a, g):
    """One chunk of the chunkwise-parallel form.  State C (B, nh, hd, hd),
    n (B, nh, hd), m (B, nh); q, k, v (B, nh, L, hd); log input gates a and
    log forget gates g (B, nh, L).  Returns ((C, n, m) at the chunk's end,
    h (B, nh, L, hd) float32)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    L = q.shape[2]
    b = torch.cumsum(g, dim=-1)  # inclusive decay
    bL = b[..., -1:]

    # intra-chunk log weights D_tj = b_t - b_j + a_j (j <= t)
    D = b[..., :, None] - b[..., None, :] + a[..., None, :]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    D = torch.where(causal, D, NEG)

    scale = b + m[..., None]  # log weight of the incoming state per position
    m_t = torch.maximum(torch.amax(D, dim=-1), scale)  # (B, nh, L)

    w_intra = torch.exp(D - m_t[..., None])  # (B, nh, L, L)
    w_inter = torch.exp(scale - m_t)  # (B, nh, L)

    qk = torch.einsum("bhld,bhjd->bhlj", qf, kf)
    num = (torch.einsum("bhlj,bhjd->bhld", w_intra * qk, vf)
           + torch.einsum("bhvk,bhlk->bhlv", C, qf) * w_inter[..., None])
    den_dot = (torch.einsum("bhlj,bhlj->bhl", w_intra, qk)
               + torch.einsum("bhk,bhlk->bhl", n, qf) * w_inter)
    h = num / torch.maximum(torch.abs(den_dot), torch.exp(-m_t))[..., None]

    # the state at the chunk's end
    a_rev = a + bL - b  # log weight of j's contribution at the end
    m_out = torch.maximum((bL + m[..., None])[..., 0], torch.amax(a_rev, dim=-1))
    w_end = torch.exp(a_rev - m_out[..., None])  # (B, nh, L)
    decay = torch.exp(bL[..., 0] + m - m_out)  # (B, nh)
    C = (decay[..., None, None] * C
         + torch.einsum("bhjv,bhjk,bhj->bhvk", vf, kf, w_end))
    n = decay[..., None] * n + torch.einsum("bhjk,bhj->bhk", kf, w_end)
    return (C, n, m_out), h


def _mlstm_inputs(params, cfg: XLSTMCfg, x):
    """The up-projection, causal conv and gates of a (B, S, D) input:
    (z, q, k, v, a, g)."""
    d_in, _ = _mlstm_dims(x.shape[-1], cfg)
    up = x @ params["up_proj"].to(x.dtype)
    x_m, z = up[..., :d_in], up[..., d_in:]
    x_c = F.silu(causal_depthwise_conv(x_m, params["conv_w"], params["conv_b"]))
    return (z,) + _mlstm_qkv_gates(params, cfg, x_c, x_m)


def _mlstm_out(params, h, z, dt):
    """Head norm, output gate and down-projection of h (B, S, nh, hd)."""
    B, S, nh, hd = h.shape
    h = _head_norm(params, h).reshape(B, S, nh * hd).to(dt)
    h = h * F.silu(z)
    return h @ params["down_proj"].to(dt)


def _zero_state(B, nh, hd, device):
    return (torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((B, nh, hd), dtype=torch.float32, device=device),
            torch.zeros((B, nh), dtype=torch.float32, device=device))


def mlstm_fwd(params, cfg: XLSTMCfg, x, chunk: int = 128):
    """The training forward, chunkwise: x (B, S, D) -> (B, S, D).  Chunks
    of ``chunk`` positions; one chunk of S when S is not a multiple."""
    B, S, D = x.shape
    _, hd = _mlstm_dims(D, cfg)
    nh = cfg.num_heads
    z, q, k, v, a, g = _mlstm_inputs(params, cfg, x)
    L = min(chunk, S)
    if S % L:
        L = S  # one chunk for odd test lengths, as in JAX
    nc = S // L

    def to_chunks(t):  # (B, S, nh, ...) -> (nc, B, nh, L, ...)
        t = t.reshape(B, nc, L, nh, *t.shape[3:])
        return torch.movedim(t.transpose(2, 3), 1, 0)

    qs, ks, vs = to_chunks(q), to_chunks(k), to_chunks(v)
    as_, gs = to_chunks(a[..., None])[..., 0], to_chunks(g[..., None])[..., 0]
    C, n, m = _zero_state(B, nh, hd, x.device)
    hs = []
    for c in range(nc):
        (C, n, m), h = _mlstm_chunk(C, n, m, qs[c], ks[c], vs[c], as_[c], gs[c])
        hs.append(h)
    # (nc, B, nh, L, hd) -> (B, S, nh, hd)
    h = torch.movedim(torch.stack(hs), 0, 1).transpose(2, 3).reshape(B, S, nh, hd)
    return _mlstm_out(params, h, z, x.dtype)


def mlstm_fwd_seq(params, cfg: XLSTMCfg, x):
    """The sequential scan over positions: the test oracle of
    ``mlstm_fwd``."""
    B, S, D = x.shape
    _, hd = _mlstm_dims(D, cfg)
    z, q, k, v, a, g = _mlstm_inputs(params, cfg, x)
    C, n, m = _zero_state(B, cfg.num_heads, hd, x.device)
    hs = []
    for t in range(S):
        C, n, m, h = _mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t], a[:, t],
                                 g[:, t])
        hs.append(h)
    return _mlstm_out(params, torch.stack(hs, dim=1), z, x.dtype)


def _head_norm(params, h):
    """RMS norm over hd, per head; h (..., nh, hd) float32."""
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return h * torch.rsqrt(var + 1e-6) * params["out_norm"]["scale"]


def init_mlstm_state(cfg: XLSTMCfg, d: int, batch: int, dtype, *,
                     layers: int = 1, device=None):
    """Fresh mLSTM state, stacked over ``layers``: the scaled memory C,
    normalizer n and stabilizer m in float32 (all 0), the conv's last
    inputs in the activation dtype."""
    d_in, hd = _mlstm_dims(d, cfg)
    nh = cfg.num_heads
    lead = (layers, batch)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(lead + (nh, hd, hd), **f32),
            "n": torch.zeros(lead + (nh, hd), **f32),
            "m": torch.zeros(lead + (nh,), **f32),
            "conv": torch.zeros(lead + (_CONV_K - 1, d_in), dtype=dtype,
                                device=device)}


def mlstm_decode(params, cfg: XLSTMCfg, x_t, state):
    """One decode step: x_t (B, 1, D), ``state`` one layer's leaves ->
    (out (B, 1, D), the new state), functional."""
    B, _, D = x_t.shape
    dt = x_t.dtype
    d_in, hd = _mlstm_dims(D, cfg)
    up = x_t[:, 0] @ params["up_proj"].to(dt)
    x_m, z = up[:, :d_in], up[:, d_in:]
    xc, conv_state = conv_step(x_m, state["conv"], params["conv_w"],
                               params["conv_b"])
    xc = F.silu(xc)
    q, k, v, i_pre, f_pre = _mlstm_qkv_gates(params, cfg, xc[:, None],
                                             x_m[:, None])
    C, n, m, h = _mlstm_cell(state["C"], state["n"], state["m"], q[:, 0],
                             k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0])
    h = _head_norm(params, h).reshape(B, d_in).to(dt) * F.silu(z)
    out = (h @ params["down_proj"].to(dt))[:, None]
    return out, {"C": C, "n": n, "m": m, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM


def init_slstm(generator, d: int, cfg: XLSTMCfg, layers: int, *, device=None):
    """Random float32 sLSTM weights stacked over ``layers``: the input and
    (dense) recurrent matrices of the four gates, the bias 0 but for the
    forget gate's 3.0."""
    L = (layers,)
    b = torch.zeros(L + (4 * d,), dtype=torch.float32, device=device)
    b[:, d:2 * d] = 3.0  # forget-gate bias
    return {"w_ifzo": dense_init(generator, L + (d, 4 * d), d, device=device),
            "r_ifzo": dense_init(generator, L + (d, 4 * d), d, device=device),
            "b_ifzo": b}


def _slstm_cell(r_ifzo, b_ifzo, carry, wx_t):
    """carry: (h, c, n, m), each (B, D) float32; wx_t (B, 4D) float32, the
    precomputed x @ W; r_ifzo, b_ifzo float32."""
    h, c, n, m = carry
    raw = wx_t + h @ r_ifzo + b_ifzo
    i_pre, f_pre, z_pre, o_pre = torch.chunk(raw, 4, dim=-1)
    f_pre = F.logsigmoid(f_pre)
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_pre)
    n = f_g * n + i_g
    # torch.maximum, not clamp_min: n is exactly 1 on the first step, and
    # JAX's maximum splits that tie's gradient in half, as torch's does
    h = torch.sigmoid(o_pre) * c / torch.maximum(n, torch.ones_like(n))
    return h, c, n, m_new


def slstm_fwd(params, cfg: XLSTMCfg, x, chunk: int = 64):
    """The training forward: x (B, S, D) -> (B, S, D), one step at a time
    (the recurrence has no parallel form).  ``chunk`` is JAX's remat
    granularity and changes no value; it stays for the signature."""
    B, S, D = x.shape
    wx = x.float() @ params["w_ifzo"].float()
    r, b = params["r_ifzo"].float(), params["b_ifzo"].float()
    z0 = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    carry = (z0, z0, z0, torch.full((B, D), NEG, dtype=torch.float32,
                                    device=x.device))
    hs = []
    for t in range(S):
        carry = _slstm_cell(r, b, carry, wx[:, t])
        hs.append(carry[0])
    return torch.stack(hs, dim=1).to(x.dtype)


def init_slstm_state(cfg: XLSTMCfg, d: int, batch: int, dtype, *,
                     layers: int = 1, device=None):
    """Fresh sLSTM state, stacked over ``layers``, float32: h, c, n at 0
    and the stabilizer m at -1e30."""
    shape = (layers, batch, d)
    f32 = dict(dtype=torch.float32, device=device)
    return {"sh": torch.zeros(shape, **f32), "sc": torch.zeros(shape, **f32),
            "sn": torch.zeros(shape, **f32), "sm": torch.full(shape, NEG, **f32)}


def slstm_decode(params, cfg: XLSTMCfg, x_t, state):
    """One decode step: x_t (B, 1, D) -> (out (B, 1, D), the new state)."""
    wx = x_t[:, 0].float() @ params["w_ifzo"].float()
    carry = (state["sh"], state["sc"], state["sn"], state["sm"])
    h, c, n, m = _slstm_cell(params["r_ifzo"].float(),
                             params["b_ifzo"].float(), carry, wx)
    return h.to(x_t.dtype)[:, None], {"sh": h, "sc": c, "sn": n, "sm": m}

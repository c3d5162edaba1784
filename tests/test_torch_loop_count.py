"""The loop-aware count (``core/op_cost.py``: ``repeated``, ``time_loop``)
against the plain count, which dispatches every step of the time loops.

- One Mamba layer (jamba-1.5-large-398b's first block, with its dense FFN),
  one mLSTM block and one sLSTM block (xlstm-350m's first and last), each
  alone in a one-layer model at full width, counted on ``meta`` by
  ``launch.dryrun.lower_cell`` on a (1, 1) mesh of a fake group: the train
  step (forward, backward and update) at remat "none" and "full", and the
  prefill forward.  The loop-aware count's FLOPs, traffic bytes,
  collective bytes and kernel launches equal the plain count's at rel
  1e-9, its peak within 1 %.  Two lengths a block, the three programs at
  the first and the remat'd train step and the prefill at the second (a
  plain count dispatches about 300 us an op on ``meta``, so the plain
  train steps at the longer lengths would take most of the file's
  time): Mamba at S 64 and 256 (its chunks are 64 steps, so its chunk
  loop is loop-aware at 256 only), the sLSTM at S 64 and 128, the mLSTM at
  S 512 and 1024 (its chunks are 128 positions, and a loop of fewer than
  four trips runs every one).
- A loop-aware count dispatches the middle step once: ``repeated`` runs
  in every loop-aware count and in no plain one.
- Tensors with data never take the loop-aware branch: under a counter, on
  real CPU tensors, the three layers' outputs and gradients are bitwise
  those of the loops written out step by step (the code before
  ``time_loop``), and ``repeated`` is never entered.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import SHAPES_BY_NAME, get_config  # noqa: E402
from repro_torch.configs.base import ShapeCfg, Stage  # noqa: E402
from repro_torch.core import op_cost  # noqa: E402
from repro_torch.models.layers import mamba, xlstm  # noqa: E402

# block -> (arch, pattern position, lengths)
BLOCKS = {"mamba": ("jamba-1.5-large-398b", 0, (64, 256)),
          "mlstm": ("xlstm-350m", 0, (512, 1024)),
          "slstm": ("xlstm-350m", -1, (64, 128))}
PROGRAMS = [("train", "none"), ("train", "full"), ("prefill", "full")]
CASES = [(b, s, kind, remat) for b, (_, _, lens) in BLOCKS.items()
         for s in lens for kind, remat in PROGRAMS
         if s == lens[0] or remat == "full"]
EXACT = ("flops_per_device", "bytes_per_device",
         "collective_bytes_per_device")


def _row(block, seq, kind, remat, loops):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.dryrun import lower_cell

    arch, pos, _ = BLOCKS[block]
    blk = get_config(arch).stages[0].pattern[pos]
    name = f"loop_{kind}_{seq}"
    SHAPES_BY_NAME[name] = ShapeCfg(name, seq, 1, kind)
    try:
        with op_cost.fake_group(1):
            mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                              mesh_dim_names=("data", "model"))
            return lower_cell(arch, name, mesh, loops=loops, overrides={
                "stages": (Stage((blk,), 1),), "remat": remat})
    finally:
        SHAPES_BY_NAME.pop(name)


@pytest.mark.parametrize("block,seq,kind,remat", CASES,
                         ids=[f"{b}-S{s}-{k}-{r}" for b, s, k, r in CASES])
def test_loop_aware_count_equals_plain(monkeypatch, block, seq, kind, remat):
    entered = []
    real = op_cost.repeated
    monkeypatch.setattr(op_cost, "repeated",
                        lambda n: entered.append(n) or real(n))
    plain = _row(block, seq, kind, remat, "plain")
    assert not entered
    aware = _row(block, seq, kind, remat, "aware")
    assert entered, "the loop-aware count ran every step"
    for key in EXACT:
        assert aware[key] == pytest.approx(plain[key], rel=1e-9), key
    assert aware["collective_breakdown"] == pytest.approx(
        plain["collective_breakdown"], rel=1e-9)
    assert aware["kernels"] == plain["kernels"]
    assert aware["peak_bytes"] == pytest.approx(plain["peak_bytes"], rel=1e-2)
    print(block, seq, kind, remat, "peak aware/plain",
          aware["peak_bytes"] / plain["peak_bytes"])


# the loops as they were written before ``time_loop``: the yardstick of
# the real tensors' path


def _scan_unrolled(h, A, x_c, dt, Bm, Cm, out_dtype):
    ys = []
    for t in range(x_c.shape[1]):
        x_t, dt_t = x_c[:, t].float(), dt[:, t].float()
        B_t, C_t = Bm[:, t].float(), Cm[:, t].float()
        dA = torch.exp(dt_t[:, :, None] * A[None])
        dBx = (dt_t * x_t)[:, :, None] * B_t[:, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("ben,bn->be", h, C_t).to(out_dtype))
    return h, torch.stack(ys, dim=1)


def _mamba_unrolled(params, cfg, x, chunk=64):
    from torch.utils import checkpoint as ckpt

    import torch.nn.functional as F

    B, S, D = x.shape
    dt_ = x.dtype
    _, dt_rank = mamba._dims(D, cfg)
    x_in, z = mamba._preprocess(params, cfg, x)
    x_c = F.silu(mamba.causal_depthwise_conv(x_in, params["conv_w"],
                                             params["conv_b"]))
    dt, Bmat, Cmat = mamba._ssm_inputs(params, cfg, x_c, dt_rank)
    A = -torch.exp(params["A_log"].float())
    dt, Bmat, Cmat = dt.to(dt_), Bmat.to(dt_), Cmat.to(dt_)
    L = min(chunk, S)
    h = torch.zeros((B, x_in.shape[-1], cfg.d_state), dtype=torch.float32)
    scan = functools.partial(_scan_unrolled, out_dtype=dt_)
    ys = []
    for c in range(0, S, L):
        xs = (x_c[:, c:c + L], dt[:, c:c + L], Bmat[:, c:c + L],
              Cmat[:, c:c + L])
        h, y = ckpt.checkpoint(scan, h, A, *xs, use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = (y + (x_c * params["ssm_D"].to(dt_)).to(dt_)) * F.silu(z)
    return y @ params["out_proj"].to(dt_)


def _slstm_unrolled(params, cfg, x, chunk=64):
    B, S, D = x.shape
    wx = x.float() @ params["w_ifzo"].float()
    r, b = params["r_ifzo"].float(), params["b_ifzo"].float()
    z0 = torch.zeros((B, D), dtype=torch.float32)
    carry = (z0, z0, z0, torch.full((B, D), xlstm.NEG, dtype=torch.float32))
    hs = []
    for t in range(S):
        carry = xlstm._slstm_cell(r, b, carry, wx[:, t])
        hs.append(carry[0])
    return torch.stack(hs, dim=1).to(x.dtype)


def _mlstm_unrolled(params, cfg, x, chunk=128):
    B, S, D = x.shape
    _, hd = xlstm._mlstm_dims(D, cfg)
    nh = cfg.num_heads
    z, q, k, v, a, g = xlstm._mlstm_inputs(params, cfg, x)
    L = min(chunk, S)
    nc = S // L

    def to_chunks(t):
        t = t.reshape(B, nc, L, nh, *t.shape[3:])
        return torch.movedim(t.transpose(2, 3), 1, 0)

    qs, ks, vs = to_chunks(q), to_chunks(k), to_chunks(v)
    as_, gs = to_chunks(a[..., None])[..., 0], to_chunks(g[..., None])[..., 0]
    C, n, m = xlstm._zero_state(B, nh, hd, x.device)
    hs = []
    for c in range(nc):
        (C, n, m), h = xlstm._mlstm_chunk(C, n, m, qs[c], ks[c], vs[c],
                                          as_[c], gs[c])
        hs.append(h)
    h = torch.movedim(torch.stack(hs), 0, 1).transpose(2, 3).reshape(
        B, S, nh, hd)
    return xlstm._mlstm_out(params, h, z, x.dtype)


def _smoke_layer(arch, mixer):
    from repro_torch.models import transformer

    cfg = get_config(arch, smoke=True)
    blk = next(b for b in cfg.stages[0].pattern if b.mixer == mixer)
    block = transformer.init_block(torch.Generator().manual_seed(0), cfg, blk,
                                   1, dtype=torch.float32, device="cpu",
                                   trainable=True)
    return cfg, transformer.mixer_cfg(blk), transformer.layer_view(block, 0)


def _leaves(tree):
    return [t for v in tree.values()
            for t in (_leaves(v) if isinstance(v, dict) else [v])]


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_real_tensors_run_every_step(monkeypatch, mixer):
    arch = "jamba-1.5-large-398b" if mixer == "mamba" else "xlstm-350m"
    cfg, mcfg, layer = _smoke_layer(arch, mixer)
    params = layer["mixer"]
    # 8 chunks of the mLSTM, 4 of Mamba; 40 sLSTM steps
    S = {"mamba": 256, "mlstm": 64, "slstm": 40}[mixer]
    chunk = {"mamba": 64, "mlstm": 8, "slstm": 64}[mixer]
    x = torch.randn((2, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1), requires_grad=True)
    new = {"mamba": mamba.mamba_fwd, "mlstm": xlstm.mlstm_fwd,
           "slstm": xlstm.slstm_fwd}[mixer]
    old = {"mamba": _mamba_unrolled, "mlstm": _mlstm_unrolled,
           "slstm": _slstm_unrolled}[mixer]
    wrt = [x, *_leaves(params)]
    want = old(params, mcfg, x, chunk=chunk)
    want_g = torch.autograd.grad(want.square().sum(), wrt, allow_unused=True)

    def refuse(n):
        raise AssertionError("a tensor with data took the loop-aware branch")

    monkeypatch.setattr(op_cost, "repeated", refuse)
    with op_cost.OpCounter():
        got = new(params, mcfg, x, chunk=chunk)
        got_g = torch.autograd.grad(got.square().sum(), wrt, allow_unused=True)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g, strict=True):
        assert (a is None and b is None) or torch.equal(a, b)

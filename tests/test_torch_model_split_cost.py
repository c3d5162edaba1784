"""The per-rank cost of the 'model' split of training, counted with the
port's operation counter (``core/op_cost.py``) under a fake process group
(``op_cost.fake_group``), as ``core.sweep.lower_cell`` counts a sweep
cell: rank 0's program on one process, no card and no gloo ranks.

- Rank 0's train step (qwen2-1.5b smoke, float32, batch 8 x 32) at
  ("data", "model") meshes (1, 1), (1, 2), (1, 2) with ``heads_tp`` and
  (1, 4): its FLOPs against the port's own (1, 1) count, at most 0.70,
  0.56 and 0.52.  At (1, 4) the G = 2 query heads a KV group stay whole.
  The counts are printed beside JAX's per-device counts of the same step
  (``repro.core.hlo_cost.analyze`` of ``dryrun._lower_train`` under
  ``make_rules``, 8 fake CPU devices), cited in ``JAX_FLOPS``; JAX's
  further cut comes from its sequence split of the saved residuals
  (``act_res_seq``), which the port does not have yet (PERF.md §7).
- The split layers' products alone, forward and backward: the FFN
  (``mlp_fwd``), the head (``logits_from_hidden``) and the experts'
  dispatch, products and combine (``moe._dispatch``) count exactly 1/N of
  their whole FLOPs on a rank at 'model' N = 2 and 4.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.core import op_cost  # noqa: E402

BATCH, SEQ = 8, 32
# (data, model) mesh, heads_tp -> JAX's FLOPs a device of the same step
JAX_FLOPS = {((1, 1), False): 209_715_200, ((1, 2), False): 121_634_816,
             ((1, 2), True): 104_857_600, ((1, 4), False): 77_594_624}
# the port's share of its (1, 1) count, at most
MAX_SHARE = {((1, 2), False): 0.70, ((1, 2), True): 0.56,
             ((1, 4), False): 0.52}


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _cfg():
    from repro_torch.configs import get_config

    return get_config("qwen2-1.5b", smoke=True).replace(
        dtype="float32", param_dtype="float32")


def step_flops(shape, heads_tp: bool) -> float:
    """Rank 0's counted FLOPs of one train step on ``shape``."""
    from repro_torch.optim.adamw import AdamWCfg
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel.sharding import make_rules, use_mesh
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, shard_state)

    cfg, opt = _cfg(), AdamWCfg()
    step = make_train_step(cfg, opt, constant(1e-3))
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    with op_cost.fake_group(shape[0] * shape[1]):
        mesh = _mesh(shape)
        with use_mesh(mesh, make_rules(mesh, heads_tp=heads_tp)):
            state = shard_state(init_train_state(
                torch.Generator().manual_seed(0), cfg, opt, device="cpu"))
            _, cost = op_cost.count(step, state, batch)
    return cost["flops"]


def test_rank_step_flops_shrink_with_the_model_split():
    flops = {key: step_flops(*key) for key in JAX_FLOPS}
    whole = flops[((1, 1), False)]
    rows = [f"{shape}{' heads_tp' if tp else ''}: port {got:,.0f} = "
            f"{got / whole:.4f} of (1, 1) (JAX {JAX_FLOPS[(shape, tp)]:,} = "
            f"{JAX_FLOPS[(shape, tp)] / JAX_FLOPS[((1, 1), False)]:.4f})"
            for (shape, tp), got in flops.items()]
    print("rank 0's train-step FLOPs, qwen2-1.5b smoke f32, batch 8 x 32:\n  "
          + "\n  ".join(rows))
    for key, limit in MAX_SHARE.items():
        assert flops[key] / whole <= limit, (key, flops[key] / whole, limit)
    # without heads_tp, (1, 2) and (1, 4) differ from (1, 1) only in the
    # split products S (the FFN and the head): C_N = C_1 - S (1 - 1/N), so
    # 2 C_4 = 3 C_2 - C_1 exactly where each counts S/N
    c2, c4 = flops[((1, 2), False)], flops[((1, 4), False)]
    assert 2 * c4 == 3 * c2 - whole, (whole, c2, c4)


def _grad_flops(fn, *tensors) -> float:
    """FLOPs of ``fn(*tensors)`` and its backward into every tensor."""
    def run():
        leaves = [t.detach().requires_grad_() for t in tensors]
        out = fn(*leaves)
        torch.autograd.grad(out, leaves, torch.ones_like(out))
    return op_cost.count(run)[1]["flops"]


def _rank0(n, whole, dim):
    """Rank 0's 'model' slice of ``whole`` along ``dim``."""
    return whole.narrow(dim, 0, whole.shape[dim] // n).contiguous()


def _split_flops(n, fn, tensors, split):
    """``_grad_flops`` on 'model' rank 0 of n, the tensors at the indices
    of ``split`` ({index: dim}) cut to rank 0's slice and marked as
    working copies (``model_slices``)."""
    from repro_torch.parallel.sharding import model_slices, use_mesh

    local = [(_rank0(n, t, split[i]) if i in split else t)
             for i, t in enumerate(tensors)]

    def marked(*leaves):
        with model_slices([leaves[i] for i in split]):
            return fn(*leaves)

    with op_cost.fake_group(n):
        with use_mesh(_mesh((1, n))):
            return _grad_flops(marked, *local)


def _layers():
    """(name, fn, whole tensors, {index: split dim}) of each split layer at
    qwen2-1.5b smoke's FFN and head widths and an arctic-like MoE (8
    experts, top 2)."""
    from repro_torch.configs.base import MLPCfg, MoECfg
    from repro_torch.models.layers import embeddings as emb
    from repro_torch.models.layers import mlp, moe

    g = torch.Generator().manual_seed(0)
    d, ff, V = 64, 128, 512
    x = torch.randn(BATCH, SEQ, d, generator=g)

    def ffn(x, w_up, w_gate, w_down):
        return mlp.mlp_fwd({"w_up": w_up, "w_gate": w_gate, "w_down": w_down},
                           MLPCfg(d_ff=ff), x)

    def head(x, w):
        return emb.logits_from_hidden({"out_head": w}, x)

    cfg = MoECfg(num_experts=8, top_k=2, d_ff=96)
    gates, idx, _, _ = moe._route({"router": torch.randn(d, 8, generator=g)},
                                  cfg, x)

    def experts(x, gates, we_gate, we_up, we_down):
        return moe._dispatch({"we_gate": we_gate, "we_up": we_up,
                              "we_down": we_down}, cfg, x, gates, idx,
                             moe.capacity(cfg, SEQ),
                             moe.model_part(we_gate))

    w = lambda *s: torch.randn(*s, generator=g) * 0.1  # noqa: E731
    return [("ffn", ffn, [x, w(d, ff), w(d, ff), w(ff, d)], {1: 1, 2: 1, 3: 0}),
            ("head", head, [x, w(d, V)], {1: 1}),
            ("experts", experts, [x, gates, w(8, d, 96), w(8, d, 96),
                                  w(8, 96, d)], {2: 0, 3: 0, 4: 0})]


@pytest.mark.parametrize("n", [2, 4])
def test_split_products_count_one_nth(n):
    for name, fn, tensors, split in _layers():
        whole = _grad_flops(fn, *tensors)
        got = _split_flops(n, fn, tensors, split)
        print(f"{name}: whole {whole:,.0f} FLOPs, 'model' rank 0 of {n} "
              f"{got:,.0f}")
        assert whole > 0 and got * n == whole, (name, n, got, whole)

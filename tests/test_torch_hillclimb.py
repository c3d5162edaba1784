"""The port's hill climb (``launch/hillclimb.py``) on the CPU.

- ``PLANS`` equals JAX's ``repro.launch.hillclimb.PLANS``: the same cells,
  labels and overrides.  Importing the JAX module prepends a 512-device
  ``XLA_FLAGS`` for its CLI; the test restores the variable, as
  tests/test_hillclimb.py does.
- A tiny ``run_plan`` (JAX's own tiny plan, xlstm-350m ``decode_32k`` at
  baseline and ``remat="dots"``, with a candidate between them whose
  override no config has) on a (1, 2) mesh of a fake group writes its
  JSON: the candidates that count have no ``error``, carry JAX's row keys
  and a dominant term among the three; the one that raises is an
  ``error`` row, and the climb went on past it.
- arctic's H3 row counts the dropless MoE on ``meta``, where there are no
  group sizes to read: the count takes the balanced routing, and arctic
  smoke's MoE layer (forward and backward) counts the FLOPs of a real CPU
  run with its own routing, the traffic less only the real run's group
  sizes (E int64), the same peak.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.core import op_cost  # noqa: E402
from repro_torch.launch import hillclimb  # noqa: E402

# the keys of a row of JAX's run_plan
JAX_ROW_KEYS = {"cell", "label", "overrides", "compute_s", "memory_s",
                "collective_s", "dominant", "step_bound_s",
                "roofline_fraction", "useful_flop_ratio", "peak_bytes",
                "analytic_hbm_bytes"}


def test_plans_equal_jax():
    pytest.importorskip("jax")
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hillclimb as jax_hillclimb
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    assert hillclimb.PLANS == jax_hillclimb.PLANS


def test_tiny_run_plan_writes_rows(tmp_path):
    from torch.distributed.device_mesh import DeviceMesh

    plan = {"arch": "xlstm-350m", "shape": "decode_32k",
            "candidates": [("baseline", {}),
                           ("H0 an override no config has",
                            {"no_such_knob": True}),
                           ("H1 remat=dots: less recompute", {"remat": "dots"})]}
    with op_cost.fake_group(2):
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                          mesh_dim_names=("data", "model"))
        rows = hillclimb.run_plan("tiny", plan, mesh, tmp_path)
    assert rows == json.loads((tmp_path / "tiny.json").read_text())
    assert [r["label"] for r in rows] == [c[0] for c in plan["candidates"]]
    ok = [rows[0], rows[2]]
    for r in ok:
        assert "error" not in r, r
        assert JAX_ROW_KEYS <= set(r)
        assert r["cell"] == "tiny" and r["step_bound_s"] > 0
        assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert ok[1]["overrides"] == {"remat": "dots"}
    assert set(rows[1]) == {"cell", "label", "error"}
    assert "no_such_knob" in rows[1]["error"]


def test_dropless_moe_counts_without_data():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.layers import moe

    cfg = get_config("arctic-480b", smoke=True)
    blk = next(b for b in cfg.stages[0].pattern if b.ffn == "moe")
    mcfg = dataclasses.replace(blk.moe, impl="ragged")
    block = transformer.init_block(torch.Generator().manual_seed(0), cfg, blk,
                                   1, dtype=torch.float32, device="cpu",
                                   trainable=True)
    real = transformer.layer_view(block, 0)["ffn"]

    def on(dev, tree):
        return {k: on(dev, v) if isinstance(v, dict)
                else (v if dev == "cpu" else
                      torch.empty_like(v, device=dev).requires_grad_())
                for k, v in tree.items()}

    def cost(dev):
        p = on(dev, real)
        x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                        .manual_seed(1)).to(dev).requires_grad_()

        def step():
            y, aux = moe.moe_fwd(p, mcfg, x)
            return torch.autograd.grad(y.square().sum() + aux["moe_lb_loss"],
                                       [x])

        return op_cost.count(step)[1]

    cpu, meta = cost("cpu"), cost("meta")
    assert meta["flops"] == cpu["flops"] > 0
    assert cpu["traffic_bytes"] - meta["traffic_bytes"] == 8 * mcfg.num_experts
    assert meta["peak_bytes"] == cpu["peak_bytes"]

"""Hill climbing on the three chosen training cells: each candidate is a
hypothesis about the dominant roofline term, and every row is counted and
scored.

Counterpart of ``repro.launch.hillclimb``, with its plans, labels and
overrides.  JAX lowers and compiles each candidate for the production
mesh; the port counts rank 0's program of it (``launch.dryrun.lower_cell``
on ``meta`` tensors under a fake group of 256 ranks) and prices the count
on the data-sheet H100 (``core.roofline.roofline_terms`` with
``core.roofline.H100``).  So every row is derived, not measured: the log
records hypothesis -> change -> the three terms -> confirmed or refuted.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell glm4] [--out runs/hillclimb_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import get_config, param_count
from repro_torch.core import op_cost
from repro_torch.core.roofline import H100, roofline_terms
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_production_mesh

# hypothesis -> overrides, per target cell
PLANS = {
    "glm4": {
        "arch": "glm4-9b", "shape": "train_4k",
        "candidates": [
            ("baseline (paper-faithful defaults)", {}),
            ("H1 flash-attn kernel: causal block-skip halves attention flops "
             "and removes S×S score traffic (compute+memory ↓)",
             {"use_flash": True}),
            ("H2 remat=dots: save matmul outputs, ~2x less recompute "
             "(compute ↓, HBM footprint ↑)", {"remat": "dots"}),
            ("H3 heads-TP (32 heads % 16 == 0): attention sharded over "
             "'model' removes the QKV all-gather (collective ↓, compute/16 "
             "on attention)", {"heads_tp": True}),
            ("H4 flash + dots + heads-TP combined",
             {"use_flash": True, "remat": "dots", "heads_tp": True}),
            ("H5 larger q-chunk (512): fewer scan steps, bigger score tiles "
             "(memory ↑ slightly, scan overhead ↓)", {"attn_q_chunk": 512}),
            ("H6 dots + drop seq-sharded residuals: the per-block boundary "
             "reshard costs an all-gather each way; dots-remat doesn't need "
             "the memory (collective ↓)",
             {"remat": "dots", "seq_shard_residuals": False}),
            ("H7 H6 + heads-TP: with boundaries unsharded, heads-TP's "
             "reshard overhead is gone too — attention compute /16",
             {"remat": "dots", "seq_shard_residuals": False, "heads_tp": True}),
        ],
    },
    "arctic": {
        "arch": "arctic-480b", "shape": "train_4k",
        "candidates": [
            ("baseline (mb=8, dispatch MoE)", {}),
            ("H1 microbatches 8→2: FSDP param regathers scale with mb count "
             "(collective ↓ ~4x, activation memory ↑ ~4x)",
             {"microbatches": 2}),
            ("H2 microbatches 8→4 (middle point)", {"microbatches": 4}),
            ("H3 ragged (dropless) MoE: no dispatch one-hots "
             "(memory/compute ↓, same collectives)", {"moe_impl": "ragged"}),
            ("H4 remat=dots (less recompute, more HBM)", {"remat": "dots"}),
            ("H5 mb=2 + flash attention", {"microbatches": 2, "use_flash": True}),
            ("H6 mb=2 + dots + no seq-res constraint (combine confirmed "
             "wins)", {"microbatches": 2, "remat": "dots",
                       "seq_shard_residuals": False}),
            ("H7 mb=1: regathers minimized; analytic HBM check decides "
             "feasibility", {"microbatches": 1, "remat": "dots",
                             "seq_shard_residuals": False}),
            ("H8 mb=4 + dots + no seq-res: the largest mb whose analytic "
             "HBM stays under 14.4 GiB", {"microbatches": 4, "remat": "dots",
                                          "seq_shard_residuals": False}),
        ],
    },
    "qwen15": {
        "arch": "qwen1.5-4b", "shape": "train_4k",
        "candidates": [
            ("baseline", {}),
            ("H1 flash-attn (MHA 20 heads, S=4k: attention is the biggest "
             "non-matmul term)", {"use_flash": True}),
            ("H2 remat=dots", {"remat": "dots"}),
            ("H3 flash + dots", {"use_flash": True, "remat": "dots"}),
            ("H4 dots + no seq-res constraint", {"remat": "dots",
                                                 "seq_shard_residuals": False}),
        ],
    },
}

# ``lower_cell``'s keys that are not ModelCfg fields
RULE_KEYS = ("heads_tp", "microbatches", "moe_impl")


def score(name: str, plan, label: str, ov, mesh) -> dict:
    """One candidate's row: rank 0's count of ``plan``'s cell under the
    overrides ``ov``, priced on the data-sheet H100 with JAX's microbatch
    rule (8 above 50e9 parameters unless ``ov`` says)."""
    res = lower_cell(plan["arch"], plan["shape"], mesh, overrides=ov)
    cfg_ov = {k: v for k, v in ov.items() if k not in RULE_KEYS}
    cfg = get_config(plan["arch"]).replace(**cfg_ov)
    mb = ov.get("microbatches", 8 if param_count(cfg) > 50e9 else 1)
    t = roofline_terms(res, H100, cfg=cfg, microbatches=mb)
    return {"cell": name, "label": label, "overrides": ov,
            "compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "collective_s": t["collective_s"], "dominant": t["dominant"],
            "step_bound_s": t["step_time_lower_bound_s"],
            "roofline_fraction": t["roofline_fraction"],
            "useful_flop_ratio": t["useful_flop_ratio"],
            "peak_bytes": res["peak_bytes"],
            "analytic_hbm_bytes": res["analytic_hbm_bytes"],
            "collective_bytes": res["collective_bytes_per_device"],
            "lower_s": res["lower_s"]}


def run_plan(name: str, plan, mesh, out_dir: Path):
    """Score every candidate of ``plan`` on ``mesh`` and write the rows to
    ``out_dir/<name>.json``; a candidate that raises becomes a row with
    its ``error`` and the climb goes on."""
    rows = []
    print(f"\n=== {plan['arch']} × {plan['shape']} ===")
    for label, ov in plan["candidates"]:
        try:
            row = score(name, plan, label, ov, mesh)
            rows.append(row)
            print(f"  {label[:60]:62s} comp={row['compute_s']:8.2f}s "
                  f"mem={row['memory_s']:8.2f}s coll={row['collective_s']:8.2f}s "
                  f"dom={row['dominant'][:4]} bound={row['step_bound_s']:8.2f}s "
                  f"(count {row['lower_s']}s)", flush=True)
        except Exception as e:  # servelint: ignore[broad-except] — hill-climb cell loop: a failed candidate is a data point; the error lands in the row and the climb continues
            rows.append({"cell": name, "label": label, "error": repr(e)[:300]})
            print(f"  {label[:60]:62s} FAILED: {e}", flush=True)
    with open(out_dir / f"{name}.json", "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count and score the hill climb's candidates on the "
                    "production mesh (fake process group of 256 ranks, "
                    "tensors without data; no GPU needed).")
    ap.add_argument("--cell", choices=list(PLANS) + ["all"], default="all")
    ap.add_argument("--out", default="runs/hillclimb_torch")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    names = list(PLANS) if args.cell == "all" else [args.cell]
    with op_cost.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        for n in names:
            run_plan(n, PLANS[n], mesh, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Multi-pod dry run of the port: count rank 0's program of every
(arch × shape × mesh) cell.

Counterpart of ``repro.launch.dryrun``.  JAX lowers and compiles each cell
for the whole mesh and walks one device's HLO; the port runs one process
per rank, so ``lower_cell`` writes rank 0's program out and counts what it
dispatches (``core/op_cost.OpCounter``) on tensors without data, under a
fake process group of the mesh's size (``op_cost.fake_group``): no card,
no data, no collective that moves anything.  For each cell this shows (a)
that the rank's program runs at the published sizes on the production
mesh, and (b) its FLOP, byte and collective counts, which the roofline
(``core/roofline.roofline_terms``, ``launch/report.py``) and the training
autotuner (``core/autotune.evaluate``) read.

Rank 0's program, by kind:

- train: ``make_train_step``'s step under ``use_mesh`` on a state placed
  by ``shard_state`` (rank 0's shards), on the global batch (the step
  keeps the rank's rows);
- prefill: ``model.forward`` on the rank's rows of the batch (the
  "act_batch" split) with the parameters whole, as the port serves them
  (weight-stationary; JAX's program gathers FSDP shards instead);
- decode: ``serve.serve_step.make_serve_step(cfg, sp_decode=True)``, one
  lock-step token, on the rank's part of a decode state
  (``serve_step.local_state``: its "act_kv_batch" rows and its
  "act_kv_seq" entries; recurrent carries whole over 'model') and its rows
  of the tokens, the parameters whole.

``device`` names whose program is counted (``op_cost.counting``): "cuda",
the card's, on ``meta`` tensors, where the kernel wrappers report their
registered cost instead of launching (``chip_smoke.py`` phase 14(a) holds
that count to the count of ``FakeTensor``s on ``cuda`` and of a real step
on the card); "cpu", the CPU's, on ``FakeTensor``s on ``cpu``.

A row keeps JAX's keys where the port has the quantity: ``arch``,
``shape``, ``mesh``, ``n_devices``, ``params``, ``active_params``,
``flops_per_device``, ``bytes_per_device`` (the counter's traffic bytes),
``collective_bytes_per_device``, ``collective_breakdown``,
``analytic_hbm_bytes`` (``core/memory_model.estimate``), ``peak_bytes`` (the
counter's high-water mark of live storages) and ``lower_s`` (the counting
seconds), and adds ``kernels`` (launches by kernel).  JAX's ``xla_*``
counts, its argument, output, temp and alias bytes and ``compile_s`` come
from XLA's compiled program, which the port does not have; ``hlo_path``
names its HLO text; and ``collective_bytes``/``_shape_bytes`` parse that
text, where the counter gives the bytes directly: none has a counterpart.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both [--out runs/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (SHAPES_BY_NAME, active_param_count,
                                 all_cells, get_config, input_specs,
                                 param_count, skip_reason)
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import memory_model, op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWCfg
from repro_torch.optim.schedules import constant
from repro_torch.parallel.sharding import (axis_sizes, current_mesh,
                                           current_rules, logical_spec,
                                           make_rules, sanitize_spec,
                                           shard_tensor, use_mesh)
from repro_torch.serve.serve_step import local_state, make_serve_step
from repro_torch.train.train_step import (batch_specs, init_train_state,
                                          make_train_step, shard_state)

def _opt_cfg(cfg):
    big = param_count(cfg) > 50e9 or cfg.param_dtype == "bfloat16"
    return AdamWCfg(state_dtype="int8" if big else "float32")


def _set_moe_impl(cfg, impl: str):
    def fix(blk):
        if blk.moe is not None:
            return dataclasses.replace(blk, moe=dataclasses.replace(
                blk.moe, impl=impl))
        return blk

    stages = tuple(dataclasses.replace(st, pattern=tuple(fix(b) for b in st.pattern))
                   for st in cfg.stages)
    return cfg.replace(stages=stages)


def cell_rules(cfg, shape: ShapeCfg, mesh, heads_tp=None):
    """JAX's rules of a cell: ``make_rules`` with decode for decode
    shapes, long_ctx for decode at a global batch under 8, and
    ``heads_tp`` by JAX's automatic rule where not given (every attention
    block's query-group count divides the 'model' width: glm4 on a
    16-wide mesh)."""
    if heads_tp is None:
        model_size = axis_sizes(mesh).get("model", 1)
        gs = [b.attn.num_heads // b.attn.num_kv_heads
              for st in cfg.stages for b in st.pattern if b.attn is not None]
        heads_tp = bool(gs) and all(g % model_size == 0 for g in gs)
    long_ctx = shape.kind == "decode" and shape.global_batch < 8
    return make_rules(mesh, decode=shape.kind == "decode", long_ctx=long_ctx,
                      heads_tp=heads_tp)


def lower_cell(arch: str, shape_name: str, mesh, *, overrides=None,
               device: str = "cuda", loops: str = "aware"):
    """Count rank 0's program of one cell on ``mesh`` (a ``DeviceMesh``
    over a running, usually fake, process group).  Returns the row (module
    docstring).  ``loops="plain"`` dispatches every step of the time loops
    (``op_cost.OpCounter``), the count that the loop-aware one equals.

    ``overrides``: ModelCfg.replace kwargs, plus the special keys
      heads_tp     — shard attention heads over 'model' (rules-level)
      microbatches — grad-accumulation count for train cells
      moe_impl     — "dispatch" | "ragged" for every MoE block
    """
    overrides = dict(overrides or {})
    heads_tp = overrides.pop("heads_tp", None)
    microbatches = overrides.pop("microbatches", None)
    moe_impl = overrides.pop("moe_impl", None)
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    if moe_impl is not None:
        cfg = _set_moe_impl(cfg, moe_impl)
    shape = SHAPES_BY_NAME[shape_name]
    rules = cell_rules(cfg, shape, mesh, heads_tp)
    if microbatches is None and shape.kind == "train":
        microbatches = 8 if param_count(cfg) > 50e9 else 1
    t0 = time.time()
    with use_mesh(mesh, rules), op_cost.counting(device) as dev:
        cost = count_program(cfg, shape, dev, microbatches=microbatches or 1,
                             loops=loops)
    t_lower = time.time() - t0
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in axis_sizes(mesh).values()),
        "n_devices": mesh.size(),
        "params": param_count(cfg), "active_params": active_param_count(cfg),
        "flops_per_device": cost["flops"],
        "bytes_per_device": cost["traffic_bytes"],
        "collective_bytes_per_device": cost["collective_bytes"],
        "collective_breakdown": {k[5:]: v for k, v in cost.items()
                                 if k.startswith("coll_")},
        "analytic_hbm_bytes": memory_model.estimate(
            cfg, shape, axis_sizes(mesh),
            microbatches=microbatches or 1)["total"],
        "peak_bytes": cost["peak_bytes"],
        "kernels": cost["kernels"],
        "lower_s": round(t_lower, 1),
    }


def count_program(cfg, shape: ShapeCfg, dev, microbatches: int = 1,
                  loops: str = "aware"):
    """Rank 0's program of a (cfg, shape) cell under the ambient mesh and
    rules, on tensors made on ``dev``, counted (``op_cost.OpCounter(loops)``):
    the counter's ``analyze()``."""
    if shape.kind == "train":
        return _lower_train(cfg, shape, dev, microbatches, loops)
    if shape.kind == "prefill":
        return _lower_prefill(cfg, shape, dev, loops)
    return _lower_decode(cfg, shape, dev, loops)


# ---------------------------------------------------------------------------
# Per-kind programs (rank 0's), counted


def _inputs(cfg, shape: ShapeCfg, dev):
    """The cell's global batch (``input_specs``) on ``dev``: zeros."""
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, (s, dt) in input_specs(cfg, shape).items()}


def _rank_rows(batch):
    """This rank's rows of a global batch: the leading dim over the
    "act_batch" axes (``train_step.batch_specs``)."""
    specs = batch_specs(batch)
    return {k: shard_tensor(v, specs[k]) for k, v in batch.items()}


def _remade(tree, dev):
    """``tree`` (a ``Model``, or dicts and lists of tensors) made on
    ``meta``, remade with tensors of the same shapes and dtypes on ``dev``
    (``FakeTensor``s under the count's mode): the weights' random init
    samples by rejection, which tensors without data cannot run, and a
    ``meta`` tensor skips it."""
    if dev.type == "meta":
        return tree
    if isinstance(tree, torch.nn.Module):
        for mod in tree.modules():
            for name, p in list(mod._parameters.items()):
                mod._parameters[name] = torch.nn.Parameter(
                    torch.empty_like(p, device=dev),
                    requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, dict):
        return {k: _remade(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_remade(v, dev) for v in tree]
    return torch.zeros_like(tree, device=dev)


def _params(cfg, dev):
    return _remade(M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                 device="meta"), dev)


def _lower_train(cfg, shape: ShapeCfg, dev, microbatches, loops):
    opt_cfg = _opt_cfg(cfg)
    state = shard_state(_remade(init_train_state(
        torch.Generator().manual_seed(0), cfg, opt_cfg, device="meta"), dev))
    step = make_train_step(cfg, opt_cfg, constant(1e-4),
                           microbatches=microbatches)
    return op_cost.count(step, state, _inputs(cfg, shape, dev),
                         loops=loops)[1]


def _lower_prefill(cfg, shape: ShapeCfg, dev, loops):
    params = _params(cfg, dev)
    batch = _rank_rows(_inputs(cfg, shape, dev))

    @torch.no_grad()
    def fwd(params, batch):
        return M.forward(params, cfg, batch)[0]

    return op_cost.count(fwd, params, batch, loops=loops)[1]


def _lower_decode(cfg, shape: ShapeCfg, dev, loops):
    params = _params(cfg, dev)
    B = shape.global_batch
    enc = None
    if cfg.frontend == "vision":
        enc = torch.zeros((B, cfg.n_img_tokens, cfg.d_model // 2),
                          dtype=getattr(torch, cfg.dtype), device=dev)
    mesh, rules = current_mesh(), current_rules()
    # the recurrent mixers' carries stay whole over 'model' ("tensor"), as
    # the port's serving rules keep them (``make_serve_rules``): its
    # recurrent layers run on whole weights
    state = local_state(M.init_decode_state(params, cfg, B, shape.seq_len,
                                            enc_feats=enc), mesh,
                        {**rules, "tensor": None})
    # the rank's rows of the tokens: the state's "act_kv_batch" rows
    (tok_shape, tok_dtype), = input_specs(cfg, shape).values()
    tok = torch.zeros(tok_shape, dtype=tok_dtype, device=dev)
    spec = sanitize_spec(logical_spec(("act_kv_batch", None), rules),
                         tok_shape, mesh)
    step = make_serve_step(cfg, sp_decode=True)
    return op_cost.count(step, params, state, shard_tensor(tok, spec, mesh),
                         loops=loops)[1]


# ---------------------------------------------------------------------------
# CLI


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count rank 0's program of every cell on the production "
                    "mesh (fake process group, tensors without data).  Needs "
                    "no GPU and makes no CUDA call.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--device", choices=op_cost.COUNT_DEVICES, default="cuda",
                    help="whose program is counted (module docstring)")
    args = ap.parse_args(argv)

    # --all walks the skipped cells too, so each prints its SKIP line
    cells = ([c[:2] for c in all_cells(include_skipped=True)] if args.all
             else [(args.arch, args.shape)])
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    results, failures = [], []
    t0 = time.time()
    for arch, shape_name in cells:
        r = skip_reason(arch, shape_name)
        if r:
            print(f"SKIP {arch} × {shape_name}: {r}")
            continue
        for multi in meshes:
            tag = "multi" if multi else "single"
            try:
                with op_cost.fake_group(512 if multi else 256):
                    mesh = make_production_mesh(multi_pod=multi, device="cpu")
                    res = lower_cell(arch, shape_name, mesh,
                                     device=args.device)
                results.append(res)
                # one cell per JSON line so partial runs are usable
                with open(out_dir / "results.jsonl", "a") as f:
                    f.write(json.dumps(res) + "\n")
                print(f"OK   {arch} × {shape_name} × {tag}: "
                      f"peak={res['peak_bytes']/2**30:.2f}GiB/dev "
                      f"flops={res['flops_per_device']:.3g} "
                      f"coll={res['collective_bytes_per_device']/2**30:.3f}GiB "
                      f"(lower {res['lower_s']}s)", flush=True)
            except Exception as e:  # servelint: ignore[broad-except] — dry-run cell loop: one cell's failure must not kill the sweep; recorded in `failures` and printed with traceback
                failures.append((arch, shape_name, tag, repr(e)))
                print(f"FAIL {arch} × {shape_name} × {tag}: {e}", flush=True)
                traceback.print_exc()

    print(f"\n{len(results)} cells OK, {len(failures)} failed "
          f"({time.time() - t0:.1f} s)")
    for f_ in failures:
        print("  FAIL", *f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

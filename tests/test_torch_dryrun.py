"""The port's dry run (``launch/dryrun.py``) and what reads it
(``launch/report.py``, ``core/autotune``'s training half), on the CPU.

- Rank 0's counted FLOPs against JAX's per-device FLOPs
  (``repro.launch.dryrun.lower_cell``, one ``run_multidevice`` subprocess
  of 8 fake devices) on cells of qwen2-1.5b, arctic-480b and xlstm-350m
  at full width, the depth cut through ``overrides`` (one layer; xLSTM's
  pattern cut to one mLSTM and one sLSTM block), at small shapes
  registered in both packages' ``SHAPES_BY_NAME`` in this process and in
  the subprocess only (``SHAPES``), over ("data", "model") meshes (1, 1),
  (2, 1), (1, 2) and (2, 2); and their collective bytes, which the
  roofline's collective term reads.  Equal wherever the two programs
  agree; ``DISAGREE`` (FLOPs) and ``COLL_DIFFER`` (collective bytes) pin
  every other cell's ratio at rel 1e-9 with its reason, so a fix and a
  regression both show.
- ``--device cpu`` (the CPU's program, ``FakeTensor``s on ``cpu``) counts
  what ``meta`` counts but for the kernel wrappers, which take their
  plain versions there.
- ``select_defaults`` picks JAX's candidate (JAX's ``HwSpec`` built from
  the port's ``asdict(H100)``, 80 GiB) on a qwen2-1.5b prefill cell,
  every candidate's row free of errors and ranked.  At these shapes every
  candidate's bound is the analytic memory term of the full-depth model
  (``roofline_terms`` prices the arch's published config), so the two
  rank by the candidate-name tie-break, as JAX's own does.
- ``report``'s three tables from rows the port counted; ``main`` writes
  rows with the documented keys at the production mesh.
- The saved residuals' sequence split (``seq_shard_residuals``, JAX's
  ``act_res_seq``): rank 0's counted peak of qwen2-1.5b's train step (two
  layers, S 512, batch 8) is lower with the flag on than off at (1, 2),
  where the boundaries keep the rank's half of the rows, and the same at
  (2, 1), where 'model' has one rank; at the one-layer S 64 cells above
  the peak falls in the update, after the residuals are freed, and does
  not move.
- ``input_specs`` against JAX's shapes for every cell.
- Each kernel wrapper's count branch (``op_cost.counted_only``: ``meta``
  tensors and ``FakeTensor``s on ``cuda``) reports its registered cost and
  launches nothing; real CPU tensors still take the plain version.
"""
import dataclasses
import json
import threading

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import SHAPES_BY_NAME, get_config  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.core import op_cost  # noqa: E402
from repro_torch.core.roofline import H100  # noqa: E402

# name -> (seq_len, global_batch, kind): train at S <= 256 takes the full
# softmax, prefill at 384 the chunked one (3 query chunks of 128)
SHAPES = {"dry_train": (64, 8, "train"), "dry_prefill": (384, 8, "prefill"),
          "dry_decode": (512, 8, "decode")}
KIND_SHAPE = {v[2]: k for k, v in SHAPES.items()}
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
# qwen2's train cell at (1, 4) is the one where heads_tp is off at
# 'model' > 1 (G 6 is no multiple of 4): the attention leaves stay whole
# there, and a count that took them for split ones would show
CELLS = ([("qwen2-1.5b", kind, m) for kind in KIND_SHAPE for m in MESHES
          if kind == "train" or m != (2, 2)]
         + [("qwen2-1.5b", "train", (1, 4)),
            ("arctic-480b", "train", (1, 1)), ("arctic-480b", "prefill", (2, 1)),
            ("arctic-480b", "prefill", (1, 2)),
            ("arctic-480b", "decode", (2, 2)),
            ("xlstm-350m", "train", (1, 1)), ("xlstm-350m", "prefill", (2, 1)),
            ("xlstm-350m", "prefill", (2, 2)), ("xlstm-350m", "decode", (1, 1)),
            ("xlstm-350m", "decode", (1, 2))])

_TRAIN_MODEL = ("rank 0 keeps whole what JAX's program splits over 'model': "
                "the k/v projections (ROADMAP Queue 1); the saved "
                "residuals' sequence split (act_res_seq, "
                "transformer.stage_fwd) adds a copy and all-gathers, no "
                "product, so the FLOPs are those before it")
_PREFILL_MODEL = ("the port's prefill runs on whole weights on every 'model' "
                  "rank (weight-stationary serving: no 'model' split outside "
                  "the train step); JAX splits the FFN, the vocabulary, the "
                  "experts and the heads")
_DECODE_DATA = ("the port's rank decodes only its own rows (the state's "
                "act_kv_batch rows); JAX's step activations replicate over "
                "'data' and GSPMD keeps part of the whole batch's work on "
                "every device")
_DECODE_MODEL = ("the port's decode runs q/k/v, the FFN and the head on "
                 "whole weights on every 'model' rank, only the KV sequence "
                 "splits; JAX splits the FFN and the vocabulary")
# cell -> (rank 0's FLOPs over JAX's per-device FLOPs, why they differ);
# held at rel 1e-9, so a fix and a regression both show
DISAGREE = {
    ("qwen2-1.5b", "train", (1, 2)): (1.0074492099322798, _TRAIN_MODEL),
    ("qwen2-1.5b", "train", (2, 2)): (1.0026960233655358, _TRAIN_MODEL),
    ("qwen2-1.5b", "train", (1, 4)): (1.0247916221414832, _TRAIN_MODEL),
    ("qwen2-1.5b", "prefill", (1, 2)): (1.994425087108014, _PREFILL_MODEL),
    ("qwen2-1.5b", "decode", (2, 1)): (0.9458745874587459, _DECODE_DATA),
    ("qwen2-1.5b", "decode", (1, 2)): (1.988865692414753, _DECODE_MODEL),
    ("arctic-480b", "train", (1, 1)): (1.0005675368898979, (
        "full remat: torch.utils.checkpoint recomputes a block's forward up "
        "to its last saved tensor, the dense residual FFN's, so it runs the "
        "experts' combine product (2 B S E C D FLOPs) that XLA drops as dead "
        "code; at remat 'none' and 'dots' the counts are equal")),
    ("arctic-480b", "prefill", (1, 2)): (1.7187827911857292, _PREFILL_MODEL),
    ("arctic-480b", "decode", (2, 2)): (1.980979711692472,
                                        _DECODE_DATA + "; " + _DECODE_MODEL),
    ("xlstm-350m", "train", (1, 1)): (1.0591290981599135, (
        "full remat over a group of two blocks: the group's recomputation "
        "runs the mLSTM block's forward to make the sLSTM block's input "
        "(19.617e9 FLOPs, and its down projection once more, 2^31), then "
        "the block's own checkpoint recomputes it again for its backward; "
        "XLA merges the two recomputations into one.  At remat 'none' the "
        "port counts less: JAX's scan transposes redo the sLSTM's h @ R "
        "product each step (4.362e9) and 1.073e9 in the mLSTM chunks")),
    ("xlstm-350m", "prefill", (2, 2)): (2.0, _PREFILL_MODEL),
    ("xlstm-350m", "decode", (1, 2)): (2.0, _DECODE_MODEL),
}

_COLL_TRAIN_DATA = ("the port's step gathers every parameter once at its "
                    "start (train_step._working_copies, ROADMAP Queue 1) and "
                    "all-reduces the gradients; JAX gathers each layer's "
                    "FSDP shards again for the backward's recomputation and "
                    "reshards the batch (all-to-all)")
_COLL_TRAIN_MODEL = ("the 'model' split differs (the FLOPs' reason): rank 0 "
                     "all-reduces its split layers' partial products and "
                     "all-gathers the saved residuals' rows (act_res_seq: "
                     "each block's input, again in its recomputation, the "
                     "stage's output, and the kept rows' gradients); JAX's "
                     "program all-reduces and all-gathers more")
_COLL_SERVE = ("the port serves on whole weights on every rank "
               "(weight-stationary, no collective but the sequence-parallel "
               "decode's all-reduce of its partial attention, and a prefill "
               "MoE's balance sums); JAX's program gathers its FSDP and "
               "'model' shards")
# cell -> (rank 0's collective bytes over JAX's per device, why); every
# other cell's bytes equal JAX's
COLL_DIFFER = {
    ("qwen2-1.5b", "train", (2, 1)): (0.9217335760917259, _COLL_TRAIN_DATA),
    ("qwen2-1.5b", "train", (1, 2)): (0.5441021312868194, _COLL_TRAIN_MODEL),
    ("qwen2-1.5b", "train", (2, 2)): (0.6395997325034201,
                                      _COLL_TRAIN_DATA + "; "
                                      + _COLL_TRAIN_MODEL),
    ("qwen2-1.5b", "train", (1, 4)): (0.5624692987500898, _COLL_TRAIN_MODEL),
    ("qwen2-1.5b", "prefill", (2, 1)): (0.0, _COLL_SERVE),
    ("qwen2-1.5b", "prefill", (1, 2)): (0.0, _COLL_SERVE),
    ("qwen2-1.5b", "decode", (2, 1)): (0.0003560032880098549, _COLL_SERVE),
    ("qwen2-1.5b", "decode", (1, 2)): (0.20249221183800623, _COLL_SERVE),
    ("arctic-480b", "prefill", (2, 1)): (2.717155508020742e-08, _COLL_SERVE),
    ("arctic-480b", "prefill", (1, 2)): (0.0, _COLL_SERVE),
    ("arctic-480b", "decode", (2, 2)): (0.0003358688664601073, _COLL_SERVE),
    ("xlstm-350m", "prefill", (2, 1)): (0.0, _COLL_SERVE),
    ("xlstm-350m", "prefill", (2, 2)): (0.0, _COLL_SERVE),
    ("xlstm-350m", "decode", (1, 2)): (0.0, _COLL_SERVE),
}
SELECT_CELL = ("qwen2-1.5b", "prefill", (2, 1))


def _cell_id(cell):
    arch, kind, (d, m) = cell
    return f"{arch}-{kind}-{d}x{m}"


def _depth_cut(cfg):
    """(stage,): one layer of the first stage; xLSTM's pattern cut to its
    first (mLSTM) and last (sLSTM) block, one period of each kind."""
    st = cfg.stages[0]
    if cfg.name.startswith("xlstm"):
        st = dataclasses.replace(st, pattern=st.pattern[:1] + st.pattern[-1:])
    return (dataclasses.replace(st, repeats=1),)


_JAX = """
import dataclasses, json
import jax
jax.devices()  # 8 fake devices, before repro.launch.dryrun sets its flags
from repro.configs import SHAPES_BY_NAME, get_config
from repro.configs.base import ShapeCfg
from repro.core.autotune import DEFAULT_CANDIDATES, Candidate, select_defaults
from repro.core.roofline import HwSpec
from repro.launch import dryrun
from repro.launch.mesh import make_mesh

spec = json.loads(%r)
for name, (s, b, kind) in spec["shapes"].items():
    SHAPES_BY_NAME[name] = ShapeCfg(name, s, b, kind)

def cut(arch):
    st = get_config(arch).stages[0]
    if arch.startswith("xlstm"):
        st = dataclasses.replace(st, pattern=st.pattern[:1] + st.pattern[-1:])
    return (dataclasses.replace(st, repeats=1),)

meshes = {}
def mesh(shape):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"))
    return meshes[shape]

rows = []
for arch, shape_name, m in spec["cells"]:
    r = dryrun.lower_cell(arch, shape_name, mesh(m),
                          overrides={"stages": cut(arch)})
    rows.append({k: r[k] for k in ("flops_per_device",
                                   "collective_bytes_per_device")})
arch, shape_name, m = spec["select"]
cands = tuple(Candidate(c.name, {**c.overrides, "stages": cut(arch)})
              for c in DEFAULT_CANDIDATES)
sel = select_defaults(arch, shape_name, mesh(m), candidates=cands,
                      hw=HwSpec(**spec["hw"]), hbm_limit=80 * 2**30)
print(json.dumps({"rows": rows, "best": sel["best"], "table": sel["table"]}))
"""


@pytest.fixture(scope="module")
def shapes():
    """The small shapes, registered in both packages for this module."""
    pytest.importorskip("jax")
    from repro.configs import SHAPES_BY_NAME as JAX_SHAPES
    from repro.configs.base import ShapeCfg as JaxShape

    for name, (s, b, kind) in SHAPES.items():
        SHAPES_BY_NAME[name] = ShapeCfg(name, s, b, kind)
        JAX_SHAPES[name] = JaxShape(name, s, b, kind)
    yield
    for name in SHAPES:
        SHAPES_BY_NAME.pop(name)
        JAX_SHAPES.pop(name)


def _port_row(arch, kind, shape, overrides=None, device="cuda"):
    """The port's ``lower_cell`` row of a cell: rank 0 of a fake group."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.dryrun import lower_cell

    n = shape[0] * shape[1]
    with op_cost.fake_group(n):
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                          mesh_dim_names=("data", "model"))
        return lower_cell(arch, KIND_SHAPE[kind], mesh, overrides={
            "stages": _depth_cut(get_config(arch)), **(overrides or {})},
            device=device)


@pytest.fixture(scope="module")
def counted(shapes, multidevice):
    """(JAX's output, {cell: the port's row}, the port's select_defaults):
    JAX's subprocess runs on a thread while this process counts."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.autotune import (DEFAULT_CANDIDATES, Candidate,
                                           select_defaults)

    spec = {"shapes": SHAPES, "hw": dataclasses.asdict(H100),
            "cells": [(a, KIND_SHAPE[k], m) for a, k, m in CELLS],
            "select": (SELECT_CELL[0], KIND_SHAPE[SELECT_CELL[1]],
                       SELECT_CELL[2])}
    box = {}

    def jax_side():
        try:
            out = multidevice(_JAX % json.dumps(spec), n_devices=8)
            box["jax"] = json.loads(out.strip().splitlines()[-1])
        except BaseException as e:  # re-raised on the test's thread
            box["error"] = e

    t = threading.Thread(target=jax_side)
    t.start()
    try:
        port = {cell: _port_row(*cell) for cell in CELLS}
        arch, kind, shape = SELECT_CELL
        cut = _depth_cut(get_config(arch))
        cands = tuple(Candidate(c.name, {**c.overrides, "stages": cut})
                      for c in DEFAULT_CANDIDATES)
        n = shape[0] * shape[1]
        with op_cost.fake_group(n):
            mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                              mesh_dim_names=("data", "model"))
            sel = select_defaults(arch, KIND_SHAPE[kind], mesh,
                                  candidates=cands)
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    jax_rows = dict(zip(CELLS, box["jax"]["rows"], strict=True))
    return jax_rows, port, box["jax"], sel


def _held(got, want, pinned, what, cell):
    """got == want, or got / want == the pinned ratio (rel 1e-9)."""
    ratio = got / want if want else (1.0 if got == want else float("inf"))
    print(f"{_cell_id(cell)} {what}: port {got!r} JAX {want!r} ({ratio!r})")
    if pinned is None:
        assert got == pytest.approx(want, rel=1e-9)
    else:
        assert ratio == pytest.approx(pinned[0], rel=1e-9), (
            f"{_cell_id(cell)}'s {what} moved off the pinned ratio "
            f"{pinned[0]!r} ({pinned[1]}): now {ratio!r}")


@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_rank0_flops_against_jax(counted, cell):
    jax_rows, port, _, _ = counted
    _held(port[cell]["flops_per_device"], jax_rows[cell]["flops_per_device"],
          DISAGREE.get(cell), "FLOPs", cell)


@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_rank0_collectives_against_jax(counted, cell):
    """The collective bytes, which the roofline's collective term and
    ``select_defaults`` read: equal in the cells where the two programs
    move the same, the ratio pinned where they differ by design."""
    jax_rows, port, _, _ = counted
    got, want = (r[cell]["collective_bytes_per_device"]
                 for r in (port, jax_rows))
    _held(got, want, COLL_DIFFER.get(cell), "collective bytes", cell)
    # a cell that moves nothing moves nothing on either side
    assert (got == 0) == (want == 0) or cell in COLL_DIFFER


def test_select_defaults_picks_jax_candidate(counted):
    _, _, jax_out, sel = counted
    names = [c["candidate"] for c in sel["table"]]
    assert names == [c["candidate"] for c in jax_out["table"]]
    assert all("error" not in r for r in sel["table"]), sel["table"]
    print("port", [(r["candidate"], r["step_bound_s"], r["dominant"])
                   for r in sel["table"]])
    print("JAX ", [(r["candidate"], r["step_bound_s"], r["dominant"])
                   for r in jax_out["table"]])
    assert sel["best"]["candidate"] == jax_out["best"]["candidate"]
    # rank 0 is rank 1 of the ranked rows: every row carries a rank
    assert sorted(r["rank"] for r in sel["table"]) == list(range(len(names)))


ROW_KEYS = {"arch", "shape", "mesh", "n_devices", "params", "active_params",
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collective_breakdown",
            "analytic_hbm_bytes", "peak_bytes", "kernels", "lower_s"}


def test_report_renders_the_tables(counted):
    from repro_torch.launch import report

    _, port, _, _ = counted
    rows = {}
    for (arch, kind, _), r in port.items():
        assert set(r) == ROW_KEYS
        # roofline_terms reads the row's arch and shape at their full depth
        rows[(arch, r["shape"], r["mesh"])] = r
    table = report.dryrun_table(rows)
    assert table.count("\n") == len(rows) + 1
    assert "fits H100" in table.splitlines()[0]
    for mesh in ("1x1", "2x2"):
        roof = report.roofline_table(rows, mesh)
        body = roof.splitlines()[2:]
        assert len(body) == sum(1 for k in rows if k[2] == mesh) > 0
        assert all(any(d in line for d in ("| compute |", "| memory |",
                                           "| collective |"))
                   for line in body)
        assert "Pallas" not in roof and "MXU" not in roof
    skips = report.skip_table().splitlines()[2:]
    assert len(skips) == 8


def test_main_writes_rows_at_the_production_mesh(tmp_path, capsys):
    from repro_torch.launch import dryrun, report

    rc = dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                      "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "OK   qwen2-1.5b × decode_32k × single" in out
    rows = report.load(tmp_path / "results.jsonl")
    (key, row), = rows.items()
    assert key == ("qwen2-1.5b", "decode_32k", "16x16")
    assert set(row) == ROW_KEYS and row["n_devices"] == 256
    assert row["flops_per_device"] > 0 and row["peak_bytes"] > 0


@pytest.mark.parametrize("use_flash", [False, True])
def test_cpu_device_counts_the_plain_versions(shapes, use_flash):
    """``device="cpu"`` against the default (the card's program on
    ``meta``) on qwen2-1.5b's train cell at (2, 1): without a kernel on
    the path every count is equal; with ``use_flash`` the card's program
    reports the flash kernel's launches at their registered cost and the
    CPU's counts the plain attention's products instead."""
    rows = {dev: _port_row("qwen2-1.5b", "train", (2, 1),
                           {"use_flash": use_flash}, device=dev)
            for dev in ("cuda", "cpu")}
    meta, cpu = rows["cuda"], rows["cpu"]
    assert cpu["kernels"] == {}
    same = ("collective_bytes_per_device", "collective_breakdown",
            "peak_bytes", "analytic_hbm_bytes")
    assert all(cpu[k] == meta[k] for k in same)
    if use_flash:
        assert meta["kernels"] == {"flash_attention": 2}
        assert cpu["flops_per_device"] > meta["flops_per_device"]
    else:
        assert meta["kernels"] == {}
        assert cpu["flops_per_device"] == meta["flops_per_device"]
        assert cpu["bytes_per_device"] == meta["bytes_per_device"]


def test_main_all_reports_every_cell(tmp_path, capsys, monkeypatch):
    """``--all --mesh both``: an OK line for each of the 32 cells at each
    mesh (64) and a SKIP line for each of the 8 skipped cells, with
    ``lower_cell`` stubbed (the real grid takes ~35 min on a CPU host)."""
    from repro_torch.launch import dryrun

    def row(arch, shape_name, mesh, **kw):
        return {"arch": arch, "shape": shape_name, "mesh": "x", "lower_s": 0,
                "peak_bytes": 0, "flops_per_device": 0,
                "collective_bytes_per_device": 0}

    monkeypatch.setattr(dryrun, "lower_cell", row)
    assert dryrun.main(["--all", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(x.startswith("OK ") for x in lines) == 64
    assert sum(x.startswith("SKIP ") for x in lines) == 8
    assert "64 cells OK, 0 failed" in "\n".join(lines)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_res_seq_peak(mesh):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.dryrun import lower_cell

    SHAPES_BY_NAME["res_train"] = ShapeCfg("res_train", 512, 8, "train")
    st = dataclasses.replace(get_config("qwen2-1.5b").stages[0], repeats=2)
    n = mesh[0] * mesh[1]
    peak = {}
    try:
        for flag in (True, False):
            with op_cost.fake_group(n):
                dm = DeviceMesh("cpu", torch.arange(n).reshape(mesh),
                                mesh_dim_names=("data", "model"))
                peak[flag] = lower_cell("qwen2-1.5b", "res_train", dm, overrides={
                    "stages": (st,), "seq_shard_residuals": flag})["peak_bytes"]
    finally:
        SHAPES_BY_NAME.pop("res_train")
    print(mesh, "peak on / off", peak[True], peak[False])
    if mesh[1] > 1:
        assert peak[True] < peak[False]
    else:
        assert peak[True] == peak[False]


def test_input_specs_match_jax():
    pytest.importorskip("jax")
    from repro.configs import all_cells as jax_cells
    from repro.configs import get_config as jax_config
    from repro.configs import input_specs as jax_specs
    from repro.configs.base import SHAPES_BY_NAME as JAX_SHAPES

    from repro_torch.configs import all_cells, input_specs

    cells = list(all_cells())
    assert cells == list(jax_cells())
    for arch, shape in cells:
        got = input_specs(get_config(arch), SHAPES_BY_NAME[shape])
        want = jax_specs(jax_config(arch), JAX_SHAPES[shape])
        assert list(got) == list(want), (arch, shape)
        for k, (s, dt) in got.items():
            assert s == want[k].shape, (arch, shape, k)
            assert str(dt).replace("torch.", "") == str(want[k].dtype), (
                arch, shape, k)


def test_model_part_tells_storages_without_data_apart():
    """A count at 'model' > 1 marks the split leaves' working copies;
    on ``meta`` every storage's address is 0, so the marks go by storage
    identity: an unmarked leaf, or a view of one, stays whole."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel.sharding import model_part, model_slices

    split, whole = (torch.empty(4, 8, device="meta") for _ in range(2))
    assert split.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
    with op_cost.fake_group(2):
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                          mesh_dim_names=("data", "model"))
        with model_slices([split], mesh):
            assert model_part(split[1:]).size == 2
            assert model_part(whole) is None and model_part(whole[0]) is None
        assert model_part(split) is None


# ---------------------------------------------------------------------------
# the kernel wrappers' count branch


def _kernel_calls(device):
    """(name, module, args, kwargs) of one small call of each wrapper on
    ``device``."""
    from repro_torch.kernels import (flash_attention, matmul,
                                     paged_flash_decode, ragged_paged_flash,
                                     rmsnorm)

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    pools = (t(6, 16, 2, 64), t(6, 16, 2, 64))
    return [
        ("flash_attention", flash_attention,
         (t(8, 128, 64), t(4, 128, 64), t(4, 128, 64)), {"window": 32}),
        ("rmsnorm", rmsnorm, (t(4, 256), t(256)), {"eps": 1e-6}),
        ("matmul", matmul, (t(64, 128), t(128, 32)), {"accum": "hbm"}),
        ("paged_flash_decode", paged_flash_decode,
         (t(3, 2, 4, 64),) + pools + (t(3, 2, dtype=i32), t(3, dtype=i32)),
         {}),
        ("ragged_paged_flash", ragged_paged_flash,
         (t(5, 2, 4, 64),) + pools + (t(3, 2, dtype=i32), t(5, dtype=i32),
                                      t(5, dtype=i32)), {}),
    ]


def _fake_cuda():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


@pytest.mark.parametrize("where", ["meta", "fake_cuda"])
@pytest.mark.parametrize("kernel", ["flash_attention", "rmsnorm", "matmul",
                                    "paged_flash_decode",
                                    "ragged_paged_flash"])
def test_count_branch_reports_the_registered_cost(kernel, where):
    import contextlib

    ctx = _fake_cuda() if where == "fake_cuda" else contextlib.nullcontext()
    with ctx:
        dev = "cuda" if where == "fake_cuda" else "meta"
        name, mod, args, kw = next(c for c in _kernel_calls(dev)
                                   if c[0] == kernel)
        before = mod.launches
        with op_cost.OpCounter() as c:
            out = getattr(mod, name)(*args, **kw)
        flops, nbytes = op_cost.KERNEL_COSTS[name](*args, **kw)
    assert op_cost.counted_only(args[0]) and out.device.type == dev
    assert c.kernels == {name: 1}
    assert c.flops == flops > 0 and c.traffic_bytes == nbytes > 0
    assert mod.launches == before  # nothing launched
    if name == "matmul":
        assert tuple(out.shape) == (64, 32)
    else:
        assert out.shape == args[0].shape and out.dtype == args[0].dtype


@pytest.mark.parametrize("kernel", ["flash_attention", "rmsnorm", "matmul",
                                    "paged_flash_decode",
                                    "ragged_paged_flash"])
def test_cpu_tensors_take_the_plain_version(kernel):
    name, mod, args, kw = next(c for c in _kernel_calls("cpu")
                               if c[0] == kernel)
    args = tuple(a + 1 if a.dtype == torch.float32 else a for a in args)
    assert not op_cost.counted_only(args[0])
    before = mod.launches
    with op_cost.OpCounter() as c:
        out = getattr(mod, name)(*args, **kw)
    assert c.kernels == {} and mod.launches == before
    ref = {"flash_attention": "flash_attention_ref", "rmsnorm": "rmsnorm_ref",
           "matmul": "matmul_ref", "paged_flash_decode":
           "paged_flash_decode_ref", "ragged_paged_flash":
           "ragged_paged_flash_ref"}[name]
    if name == "matmul":
        want = getattr(mod, ref)(*args, torch.float32)
    elif name == "rmsnorm":
        want = getattr(mod, ref)(*args, kw["eps"])
    elif name == "flash_attention":
        want = getattr(mod, ref)(*args, kw["window"])
    else:
        want = getattr(mod, ref)(*args)
    assert torch.equal(out, want)

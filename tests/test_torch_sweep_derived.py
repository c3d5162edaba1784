"""The derived half of the port's sweep (``core/sweep.py``: ``lower_cell``,
``run_sweep``, ``rank_program``) and its launcher (``launch/sweep.py``).

- Against JAX's ``lower_cell`` at n_units 8, n0 4096 (one subprocess of 8
  fake devices), every placement x {cache, flat}: ``flops_per_device``,
  ``model_flops``, ``n_devices`` and ``N`` equal.  ``collective_bytes``:
  the port's program all-reduces each pass's float32 partial product over
  'model', as XLA does, and equals JAX's ``coll_all-reduce`` in every
  cell; JAX adds collective-permutes in ``inner`` cells with several
  passes at nthread > 1 (GSPMD moves the chunks of a K axis split over
  'model' between devices; the port splits each rank's own K), and those
  are the whole difference.  ``dominant`` on JAX's ``HwSpec`` equals
  JAX's when the port counts its CPU program (``device="cpu"``: the passes
  cast bf16 to float32, as XLA's CPU program does); the card's program
  moves fewer bytes.
- The card's program (``device="cuda"``, fake tensors) against the port's
  own analytic count per cell: traffic and peak bytes.
- ``cache`` scores no lower than ``flat`` in every cell (JAX's golden,
  tests/test_core.py).
- ``rank_program`` on 4 gloo ranks at n0 512, every 4-unit cell: the
  gathered C equals the float32 product of the whole A and B within
  ``SHARE_TOL``, and each rank's counted FLOPs and collective bytes equal
  ``lower_cell``'s.
- ``python -m repro_torch.launch.sweep --n-units 8 --quick`` writes rows
  with JAX's keys.
- ``gpu``: every cell of 1, 2 and 4 cards on NCCL ranks.
"""
import dataclasses
import json
import math
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_parity import one_torch_thread  # noqa: E402,F401
from _torch_sweep_ranks import share_tol  # noqa: E402
from repro_torch.core import sweep as TS  # noqa: E402
from repro_torch.core.roofline import HwSpec  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.parallel.sharding import MeshView, local_slices  # noqa: E402

N0 = 4096
CELLS = [(p, t, pl, mem) for p, t in TS.factorizations(8)
         for pl in TS.PLACEMENTS if not (pl == "2d" and t < 4)
         for mem in ("cache", "flat")]
ROW_KEYS = {"nproc", "nthread", "placement", "memory", "N",
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "peak_bytes", "model_flops",
            "n_devices"}

_JAX_CELLS = """
import dataclasses, json
import jax, jax.numpy as jnp
from repro.core import hlo_cost
from repro.core import sweep as S
from repro.core.roofline import V5E

cells = json.loads(%r)
out = []
for p, t, pl, mem in cells:
    cell = S.SweepCell(p, t, pl, mem, n0=%d)
    row = S.lower_cell(cell)
    mesh = S._mesh_for(cell)
    shape = jax.ShapeDtypeStruct((p, cell.n, cell.n), jnp.bfloat16)
    sa, sb, sc = S._shardings(cell, mesh)
    with mesh:
        txt = jax.jit(S._matmul_fn(cell, S.MEMORIES[mem]), in_shardings=(sa, sb),
                      out_shardings=sc).lower(shape, shape).compile().as_text()
    walked = hlo_cost.analyze(txt)
    row.update({k: v for k, v in walked.items() if k.startswith("coll_")})
    row["dominant"] = S.score(row, V5E)["dominant"]
    out.append(row)
print(json.dumps({"rows": out, "hw": dataclasses.asdict(V5E)}))
"""


@pytest.fixture(scope="module")
def jax_cells(multidevice):
    pytest.importorskip("jax")
    out = multidevice(_JAX_CELLS % (json.dumps(CELLS), N0), n_devices=8)
    got = json.loads(out.strip().splitlines()[-1])
    return {tuple(c): r for c, r in zip(CELLS, got["rows"])}, got["hw"]


def _id(cell):
    return "-".join(str(x) for x in cell)


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_lower_cell_equals_jax(cell, jax_cells):
    rows, jax_hw = jax_cells
    want = rows[cell]
    got = TS.lower_cell(TS.SweepCell(*cell, n0=N0), device="cpu")
    assert set(got) == ROW_KEYS
    for k in ("flops_per_device", "model_flops", "n_devices", "N", "nproc",
              "nthread", "placement", "memory"):
        assert got[k] == want[k], (k, got[k], want[k])
    p, t, placement, memory = cell
    coll = got["collective_bytes_per_device"]
    assert coll == want.get("coll_all-reduce", 0.0)
    permute = want.get("coll_collective-permute", 0.0)
    assert want["collective_bytes_per_device"] - coll == permute
    if placement == "inner" and memory != "cache" and t > 1:
        assert permute > 0  # GSPMD's reshard of the K chunks, named above
    else:
        assert permute == 0 and coll == want["collective_bytes_per_device"]
    assert TS.score(got, HwSpec(**jax_hw))["dominant"] == want["dominant"]


def _analytic(cell) -> tuple:
    """(traffic, peak) bytes of rank 0's card program, by hand: A, B and C
    of the rank (bf16 A and B; C is the partial N x N for inner), k passes
    each writing a float32 product, inner's all-reduce of each, k - 1
    accumulations in place, the cast to bf16; the peak holds A, B, the
    accumulator and one more pass's product (k > 1), or the float32 product
    and the bf16 C (k = 1)."""
    p, t, placement, memory = cell
    N = TS.SweepCell(p, t, n0=N0).n
    k = TS.MEMORIES[memory]
    if placement == "colsplit":
        a, b, c = N * N, N * N // t, N * N // t
    elif placement == "inner":
        a, b, c = N * N // t, N * N // t, N * N
    else:
        m1 = 2 ** (int(math.log2(t)) // 2)
        a, b, c = N * N // m1, N * N // (t // m1), N * N // t
    reduce = placement == "inner" and t > 1
    traffic = k * 4 * c + reduce * k * 4 * c + (k - 1) * 4 * c + 2 * c
    peak = 2 * (a + b) + (6 * c if k == 1 else 8 * c)
    return traffic, peak


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_card_program_bytes_equal_the_analytic_count(cell, jax_cells):
    rows, _ = jax_cells
    got = TS.lower_cell(TS.SweepCell(*cell, n0=N0))
    traffic, peak = _analytic(cell)
    assert got["bytes_per_device"] == traffic
    assert got["peak_bytes"] == peak
    # XLA's fused CPU program, for the record (not held: its operands are
    # cast to float32 and its buffers live by XLA's schedule)
    print(cell, "port", traffic, peak, "jax", rows[cell]["bytes_per_device"],
          rows[cell]["peak_bytes"])


def test_cache_never_scores_below_flat():
    rows = TS.run_sweep(n_units=8, placements=("colsplit", "inner", "2d"),
                        memories=("cache", "flat"), n0=N0)
    cells = {}
    for r in rows:
        cells.setdefault((r["nproc"], r["nthread"], r["placement"]),
                         {})[r["memory"]] = r["peak_fraction"]
    assert len(cells) == 10
    for cell, scores in cells.items():
        assert scores["cache"] >= scores["flat"], (cell, scores)


CELLS_4 = [(p, t, pl, mem) for p, t in TS.factorizations(4)
           for pl in TS.PLACEMENTS if not (pl == "2d" and t < 4)
           for mem in TS.MEMORIES]


def test_rank_program_on_four_gloo_ranks():
    n0 = 512
    ranks = run_ranks("_torch_sweep_ranks:sweep_cells", 4, (CELLS_4, n0),
                      device="cpu", timeout=300)
    assert len(CELLS_4) == 21
    for i, cell in enumerate(CELLS_4):
        c = TS.SweepCell(*cell, n0=n0)
        shape = (c.nproc, c.n, c.n)
        g = torch.Generator("cpu").manual_seed(0)
        a = torch.randn(shape, generator=g).to(torch.bfloat16)
        b = torch.randn(shape, generator=g).to(torch.bfloat16)
        want = torch.matmul(a.float(), b.float())
        got = torch.full(shape, float("nan"))
        counted = TS.lower_cell(c, device="cpu")
        names = (("data", "mrow", "mcol") if cell[2] == "2d"
                 else ("data", "model"))
        mesh_shape = ((c.nproc,) + ((2, 2) if cell[2] == "2d" else (c.nthread,)))
        for r in ranks:
            row = r[i]
            assert row["cell"] == cell
            view = MeshView(mesh_shape, names, row["coord"])
            got[local_slices(TS._shardings(c)[2], shape, view)] = \
                torch.from_numpy(row["c"])
            assert row["cost"]["flops"] == counted["flops_per_device"]
            assert row["cost"]["collective_bytes"] == \
                counted["collective_bytes_per_device"]
        torch.testing.assert_close(got, want, **share_tol(cell[3], c.n))


def test_launcher_writes_rows_with_jax_keys(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--n-units", "8",
         "--quick", "--out", str(tmp_path)],
        capture_output=True, text=True, check=True, timeout=300)
    rows = json.loads((tmp_path / "results.json").read_text())
    assert [(r["nproc"], r["nthread"]) for r in rows if r["placement"] ==
            "colsplit" and r["memory"] == "cache"] == [(1, 8), (4, 2)]
    assert len(rows) == 3 * 3 + 2 * 3  # (1, 8) with 2d, (4, 2) without
    score_keys = {"compute_s", "memory_s", "collective_s", "dominant",
                  "peak_fraction", "gflops_per_chip"}
    assert all(set(r) == ROW_KEYS | score_keys for r in rows)
    assert "best:" in out.stdout and "Xeon Phi" in out.stdout
    assert "no CUDA call" in subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--help"],
        capture_output=True, text=True, check=True).stdout


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 4])
def test_cells_across_cards(n):
    """Every cell of ``factorizations(n)`` on n NCCL ranks, one card each,
    at n0 8192: each rank's C equals the one-card float32 product of the
    whole A and B within ``SHARE_TOL`` (checked on the rank); the counted
    FLOPs and collective bytes equal the fake-tensor count; device ms per
    cell printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    n0 = 8192
    cells = [(p, t, pl, mem) for p, t in TS.factorizations(n)
             for pl in TS.PLACEMENTS if not (pl == "2d" and t < 4)
             for mem in TS.MEMORIES]
    ranks = run_ranks("_torch_sweep_ranks:sweep_cells", n,
                      (cells, n0, "cuda", False), device="cuda", timeout=600)
    card = torch.cuda.get_device_name(0)
    for i, cell in enumerate(cells):
        counted = TS.lower_cell(TS.SweepCell(*cell, n0=n0))
        for r in ranks:
            assert r[i]["cost"]["flops"] == counted["flops_per_device"]
            assert r[i]["cost"]["collective_bytes"] == \
                counted["collective_bytes_per_device"]
        print(f"{n} cards, cell {cell}, N {TS.SweepCell(*cell, n0=n0).n}, on "
              f"{card}: rank ms " + ", ".join(f"{r[i]['ms']:.3f}" for r in ranks)
              + "; max |err| " + ", ".join(f"{r[i]['max_abs_err']:.3g}"
                                          for r in ranks)
              + f"; derived (H100) {TS.score(counted)['compute_s'] * 1e3:.3f}"
              f" ms compute, {TS.score(counted)['collective_s'] * 1e3:.3f} ms"
              f" collective")

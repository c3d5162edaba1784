"""The paper's experiment on GPUs: matrix-multiply throughput swept over
every factorization of the GPU count into (Nproc x Nthread) at constant
total memory, in two modes.

Measured (one GPU): the paper runs Nproc independent Matlab (Fig. 4) or
Octave (Fig. 5) processes, each multiplying its own N x N matrices with
N = N0 / sqrt(Nproc), so the memory all processes hold together stays
constant, and reads GFLOP/s against Nproc.  Here the processes are
``nproc`` independent products on one card and the two engines are two
implementations of the product (``ENGINES``); ``measured_gflops``.

Derived (a mesh; ``lower_cell``/``run_sweep``, the counterpart of JAX's):
  Nproc   -> data-parallel replicas (independent matmul instances)
  Nthread -> model-parallel width inside one instance (how many GPUs one
             ``C = A*B`` spreads over: OpenMP threads inside one BLAS call)
  memory modes -> placement (how A, B and C split over the TP group:
             colsplit / inner / 2d) x near-memory policy (cache = one pass,
             hybrid = 2 K-passes, flat = 8 K-passes).
JAX states each placement as shardings and lets GSPMD derive a device's
program; the port writes rank r's program out (``rank_program``), over its
local shards and a ``DeviceMesh``:

  placement  rank's A        rank's B        rank's C            collective
  colsplit   [1, N, N]       [1, N, N/t]     [1, N, N/t]         none
  inner      [1, N, N/t]     [1, N/t, N]     partial [1, N, N]   all-reduce
                                                                 over 'model'
  2d         [1, N/m1, N]    [1, N, N/m2]    [1, N/m1, N/m2]     none

(t = nthread; for 2d the mesh is (nproc, m1, m2) over ('data', 'mrow',
'mcol'), m1 = 2^(floor(log2 t) / 2)).  ``lower_cell`` counts rank 0's
program with ``core/op_cost.py`` on fake tensors under a fake process
group (no card, no data), and ``score`` prices the row on
``core/roofline.py``'s ``H100``.  ``SweepCell``, ``factorizations``,
``PLACEMENTS``, ``MEMORIES`` and ``score`` are copies of the JAX package's.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import op_cost
from repro_torch.core.roofline import H100, HwSpec
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import axis_group, local_shape

PLACEMENTS = ("colsplit", "inner", "2d")
MEMORIES = {"cache": 1, "hybrid": 2, "flat": 8}


@dataclass(frozen=True)
class SweepCell:
    nproc: int  # data-parallel replicas
    nthread: int  # model-parallel width per replica
    placement: str = "colsplit"
    memory: str = "cache"
    n0: int = 98304  # N = n0/sqrt(nproc) (constant total bytes, paper protocol)
    dtype: str = "bfloat16"

    @property
    def n(self) -> int:
        return max(256, int(round(self.n0 / math.sqrt(self.nproc) / 256)) * 256)


def factorizations(n_units: int) -> List:
    """All power-of-two (Nproc, Nthread) splits of n_units (1 x n ... n x 1)."""
    out = []
    p = 1
    while p <= n_units:
        out.append((p, n_units // p))
        p *= 2
    return out


def _mesh_for(cell: SweepCell, device_type: str = "cpu"):
    """The cell's ``DeviceMesh`` over ranks 0 .. nproc * nthread - 1 of the
    running (real or fake) process group: (nproc, nthread) over ('data',
    'model'), or (nproc, m1, m2) over ('data', 'mrow', 'mcol') for 2d."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(cell.nproc * cell.nthread)
    if cell.placement == "2d" and cell.nthread > 1:
        m1 = 2 ** (int(math.log2(cell.nthread)) // 2)
        m2 = cell.nthread // m1
        return DeviceMesh(device_type, ranks.reshape(cell.nproc, m1, m2),
                          mesh_dim_names=("data", "mrow", "mcol"))
    return DeviceMesh(device_type, ranks.reshape(cell.nproc, cell.nthread),
                      mesh_dim_names=("data", "model"))


def _shardings(cell: SweepCell):
    """JAX's specs of A, B and C (one entry per dim of the (nproc, N, N)
    arrays), which ``parallel.sharding.local_slices`` turns into a rank's
    shares."""
    if cell.placement == "colsplit":
        return (("data", None, None), ("data", None, "model"),
                ("data", None, "model"))
    if cell.placement == "inner":
        return (("data", None, "model"), ("data", "model", None),
                ("data", None, None))
    return (("data", "mrow", None), ("data", None, "mcol"),
            ("data", "mrow", "mcol"))


def _pass_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One pass's product, kept in float32 (JAX's
    ``preferred_element_type``): on a card ``bmm`` with a float32 output
    from the inputs' type; on the CPU, which has no kernel for that form,
    the inputs cast to float32 first.  Both count the same FLOPs."""
    if a.device.type == "cpu":
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


def rank_program(cell: SweepCell, mesh=None) -> Callable:
    """Rank r's program of the cell (``_matmul_fn`` with GSPMD's partition
    written out): ``f(a, b) -> c`` over the rank's shares (the module's
    table).  K passes (``MEMORIES``), each one's product in float32 added
    into a float32 accumulator, then cast to the inputs' type.  ``inner``
    all-reduces each pass's partial product over 'model', as XLA does.

    ``mesh`` is the cell's ``DeviceMesh`` (``_mesh_for``) in rank
    processes.  Without one (one card computing every rank's share in
    turn) no collective runs, and ``inner`` at nthread > 1 returns the
    rank's float32 partial C: the caller sums the ranks' partials and
    casts."""
    k = MEMORIES[cell.memory]
    reduce = cell.placement == "inner" and cell.nthread > 1
    group = axis_group(mesh, "model") if reduce and mesh is not None else None

    def program(a, b):
        acc = None
        for ac, bc in zip(a.tensor_split(k, dim=2), b.tensor_split(k, dim=1)):
            part = _pass_product(ac, bc)
            if group is not None:
                dist.all_reduce(part, group=group)
            if acc is None:
                acc = part
            else:
                acc.add_(part)
            del part  # the next pass's product reuses the memory
        if reduce and mesh is None:
            return acc
        return acc.to(a.dtype)

    return program


def lower_cell(cell: SweepCell, mesh=None, device: str = "cuda") -> Dict:
    """Count rank 0's program of one sweep cell; return its cost row
    (JAX's keys: per-device FLOPs, traffic bytes, collective bytes and
    peak bytes, the model's FLOPs and the device count).

    The count runs on tensors without data (``op_cost.counting``:
    ``cuda``, the card's program, on ``meta``; ``cpu``, the CPU's, whose
    passes cast their inputs to float32, on ``FakeTensor``s) and needs
    neither a card nor data.  Without ``mesh`` it runs under a fake
    process group of nproc * nthread ranks (``op_cost.fake_group``); with
    one, under the group that mesh lives in."""
    if mesh is None:
        with op_cost.fake_group(cell.nproc * cell.nthread):
            return lower_cell(cell, _mesh_for(cell), device)
    dt = getattr(torch, cell.dtype)
    shape = (cell.nproc, cell.n, cell.n)
    a_shape, b_shape, _ = (local_shape(spec, shape, mesh)
                           for spec in _shardings(cell))
    with op_cost.counting(device) as dev:
        a = torch.empty(a_shape, dtype=dt, device=dev)
        b = torch.empty(b_shape, dtype=dt, device=dev)
        _, cost = op_cost.count(rank_program(cell, mesh), a, b)
    N = cell.n
    return {
        "nproc": cell.nproc, "nthread": cell.nthread,
        "placement": cell.placement, "memory": cell.memory, "N": N,
        "flops_per_device": cost["flops"],
        "bytes_per_device": cost["traffic_bytes"],
        "collective_bytes_per_device": cost["collective_bytes"],
        "peak_bytes": cost["peak_bytes"],
        "model_flops": 2.0 * cell.nproc * N ** 3,
        "n_devices": cell.nproc * cell.nthread,
    }


def score(row: Dict, hw: HwSpec = H100) -> Dict:
    """Paper-style efficiency: useful GF/s/chip vs practical peak."""
    t_comp = row["flops_per_device"] / hw.peak_flops
    t_mem = row["bytes_per_device"] / hw.hbm_bw
    t_coll = row["collective_bytes_per_device"] / hw.ici_bw
    t = max(t_comp, t_mem, t_coll, 1e-30)
    useful = row["model_flops"] / row["n_devices"]
    eff = useful / (t * hw.peak_flops)
    return {**row, "compute_s": t_comp, "memory_s": t_mem,
            "collective_s": t_coll,
            "dominant": max([("compute", t_comp), ("memory", t_mem),
                             ("collective", t_coll)], key=lambda kv: kv[1])[0],
            "peak_fraction": min(eff, 1.0),
            "gflops_per_chip": useful / t / 1e9}


def run_sweep(n_units: int = 256, placements=PLACEMENTS,
              memories=tuple(MEMORIES), n0: int = 98304,
              splits: Optional[List] = None, hw: HwSpec = H100,
              device: str = "cuda") -> List[Dict]:
    """JAX's loop: every (nproc, nthread) split x placement (2d only at
    nthread >= 4) x memory mode, counted by ``lower_cell`` and priced by
    ``score`` on ``hw``.  Derived, not measured: no card is used."""
    rows = []
    for nproc, nthread in (splits or factorizations(n_units)):
        for pl_ in placements:
            if pl_ == "2d" and nthread < 4:
                continue
            for mem in memories:
                cell = SweepCell(nproc, nthread, pl_, mem, n0=n0)
                rows.append(score(lower_cell(cell, device=device), hw))
    return rows


def sweep_n(n0: int, nproc: int) -> int:
    """The per-process matrix size of the measured sweep: n0 / sqrt(nproc),
    rounded to a multiple of 64, at least 64 (the JAX package's rule)."""
    return max(64, int(round(n0 / math.sqrt(nproc) / 64)) * 64)


def _cublas(a, b):
    return torch.matmul(a, b)


def _kernel(a, b):
    return torch.stack([ops.matmul(a[i], b[i], block=(256, 256, 256))
                        for i in range(a.shape[0])])


# engine name -> f(a, b) over (nproc, N, N) batches.  "cublas" stands for
# the JAX package's "xla" engine (its product is XLA's, outside any Pallas
# kernel; here PyTorch's batched matmul); "kernel" for its "pallas" engine
# (one hand-written kernel call per instance, block (256, 256, 256), vmem
# accumulation, then stacked).
ENGINES: Dict[str, Callable] = {"cublas": _cublas, "kernel": _kernel}


def sweep_operands(nproc: int, n0: int, dtype=torch.float32, device=None):
    """The (nproc, N, N) operands A and B of one sweep point, standard
    normals from seeds 0 and 1, made on the device."""
    dev = resolve_device(device)
    N = sweep_n(n0, nproc)
    out = []
    for seed in (0, 1):
        g = torch.Generator(device=dev).manual_seed(seed)
        out.append(torch.randn((nproc, N, N), generator=g, device=dev).to(dtype))
    return out[0], out[1]


def seconds_per_call(fn, reps: int, device) -> float:
    """Mean seconds of ``fn()`` over ``reps`` calls after one warm-up call:
    CUDA events around the calls on a card (launches are asynchronous), the
    host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measured_gflops(engine: str, nproc: int, n0: int = 2048, reps: int = 3,
                    dtype=torch.float32, device=None) -> Dict:
    """One point of the measured analogue of Figs. 4/5: ``nproc``
    independent N x N products, N = ``sweep_n(n0, nproc)``, through
    ``ENGINES[engine]``; 2 nproc N^3 FLOPs over the measured time per call.
    Runs on the card unless ``device`` says otherwise."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {sorted(ENGINES)}, got {engine!r}")
    dev = resolve_device(device)
    a, b = sweep_operands(nproc, n0, dtype, dev)
    N = a.shape[-1]
    f = ENGINES[engine]
    dt_s = seconds_per_call(lambda: f(a, b), reps, dev)
    return {"engine": engine, "nproc": nproc, "N": N,
            "us_per_call": dt_s * 1e6,
            "gflops": 2.0 * nproc * N ** 3 / dt_s / 1e9,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}

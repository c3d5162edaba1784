"""The paper's experiment, measured on one GPU: matrix-multiply throughput
swept over the number of independent "processes" at constant total memory
(the measured mode of ``repro.core.sweep``).

The paper runs Nproc independent Matlab (Fig. 4) or Octave (Fig. 5)
processes, each multiplying its own N x N matrices with N = N0 / sqrt(Nproc),
so the memory all processes hold together stays constant, and reads
GFLOP/s against Nproc.  Here the processes are ``nproc`` independent
products on one card and the two engines are two implementations of the
product (``ENGINES``).  ``SweepCell``, ``factorizations``, ``PLACEMENTS``,
``MEMORIES`` and ``score`` are copied from the JAX package for the derived
sweep; ``score`` prices a cell's per-device cost row with
``core/roofline.py`` (``H100``).  The rest of the derived sweep waits for
the mesh: ``lower_cell``/``run_sweep`` compile each cell on a device mesh
and count its operations (ROADMAP.md, Queue 1, multi-GPU).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch

from repro_torch import resolve_device
from repro_torch.core.roofline import H100, HwSpec
from repro_torch.kernels import ops

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

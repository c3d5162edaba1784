"""Rank-side functions of the port's cost-counter and derived-sweep tests
(tests/test_torch_op_cost.py, tests/test_torch_sweep_derived.py).

``launch.ranks.run_ranks`` runs these functions in fresh rank processes,
which must not import JAX: this module imports torch, numpy and the port
only.
"""
import math
import time

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc

from repro_torch.core import op_cost
from repro_torch.core import sweep as S
from repro_torch.parallel.sharding import local_slices

# each memory mode's tolerance for a cell's C (bf16) against the float32
# product of the same bf16 inputs: rtol 2^-8 is the largest relative error
# of rounding a float32 sum to bf16 (7 stored mantissa bits); atol
# 2^-12 sqrt(K) (inputs of unit variance) covers float32 sums taken in
# another order, which can round to the neighbouring bf16 value.  The
# passes add a float32 rounding each (k 2^-24 |C|), far inside that: the
# three modes get the same numbers.
SHARE_TOL = {mem: (2 ** -8, 2 ** -12) for mem in S.MEMORIES}


def share_tol(memory: str, K: int) -> dict:
    rtol, atol = SHARE_TOL[memory]
    return dict(rtol=rtol, atol=atol * math.sqrt(K))


def collectives(device: str = "cpu") -> dict:
    """Each collective once under an ``OpCounter``: {name: analyze()}.
    Shapes: all-reduce of (3, 5) float32; all-gather of a (2, 4) float32
    shard into (2n, 4); reduce-scatter of (2n, 4) into (2, 4); all-to-all
    of (2n, 3) float32; the functional all-reduce of (6,) bfloat16."""
    n = dist.get_world_size()
    dev = torch.device(device)
    out = {}
    x = torch.ones(3, 5, device=dev)
    with op_cost.OpCounter() as c:
        dist.all_reduce(x)
    out["all_reduce"] = c.analyze()
    shard = torch.ones(2, 4, device=dev)
    full = torch.empty(2 * n, 4, device=dev)
    with op_cost.OpCounter() as c:
        dist.all_gather_into_tensor(full, shard)
    out["all_gather"] = c.analyze()
    with op_cost.OpCounter() as c:
        dist.reduce_scatter_tensor(shard, full)
    out["reduce_scatter"] = c.analyze()
    src = torch.ones(2 * n, 3, device=dev)
    dst = torch.empty(2 * n, 3, device=dev)
    with op_cost.OpCounter() as c:
        dist.all_to_all_single(dst, src)
    out["all_to_all"] = c.analyze()
    with op_cost.OpCounter() as c:
        y = fc.all_reduce(torch.ones(6, dtype=torch.bfloat16, device=dev),
                          "sum", dist.group.WORLD)
        y = fc.wait_tensor(y) + 0
    out["functional_all_reduce"] = c.analyze()
    return out


def sweep_cells(cells, n0: int, device: str = "cpu", return_c: bool = True,
                seed: int = 0) -> list:
    """Every cell (nproc, nthread, placement, memory) whose rank count is
    the world's, through ``core.sweep.rank_program`` on this rank's shares
    of seeded bf16 A and B (the same on every rank).  Returns per cell the
    rank's mesh coordinate, its counted cost and, with ``return_c``, its C
    as float32 numpy; without, the rank holds its C against the float32
    product of the whole A and B itself (``share_tol``) and returns the
    largest error, and on ``cuda`` the device ms of its program (CUDA
    events over 3 calls after one, a barrier before)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for p, t, placement, memory in cells:
        cell = S.SweepCell(p, t, placement, memory, n0=n0)
        mesh = S._mesh_for(cell, dev.type)
        shape = (p, cell.n, cell.n)
        g = torch.Generator(dev).manual_seed(seed)
        a = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        b = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        sa, sb, sc = S._shardings(cell)
        a_l = a[local_slices(sa, shape, mesh)].clone()
        b_l = b[local_slices(sb, shape, mesh)].clone()
        program = S.rank_program(cell, mesh)
        c, cost = op_cost.count(program, a_l, b_l)
        row = {"cell": (p, t, placement, memory),
               "coord": tuple(mesh.get_coordinate()), "cost": cost}
        if return_c:
            row["c"] = c.float().cpu().numpy()
        else:
            want = torch.matmul(a.float(), b.float())[
                local_slices(sc, shape, mesh)]
            torch.testing.assert_close(c.float(), want,
                                       **share_tol(memory, cell.n))
            row["max_abs_err"] = float((c.float() - want).abs().max())
            del want
        if dev.type == "cuda":
            program(a_l, b_l)
            dist.barrier()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            for _ in range(3):
                program(a_l, b_l)
            end.record()
            torch.cuda.synchronize()
            row["ms"] = start.elapsed_time(end) / 3
            row["wall_ms"] = (time.perf_counter() - t0) * 1e3 / 3
        out.append(row)
        del a, b, a_l, b_l, c
    return out

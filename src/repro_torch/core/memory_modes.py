"""Memory-mode policies — the analogue of the paper's MCDRAM/NUMA
configurations, copied from ``repro.core.memory_modes``.

The paper's boot-time memory modes decide how the fast near memory (16 GB
MCDRAM) mediates access to far memory.  The JAX package maps them onto a
TPU's VMEM/HBM pair; on an H100 the near memory is the SM's registers and
shared memory and the far memory is HBM, and the mapping is the same:

  near-memory policy ({cache, flat, hybrid}) -> what stays resident in
    training: cache = remat "dots", flat = remat "none", hybrid = remat
    "full";
  NUMA hash -> how the matmul iteration space tiles and where C
    accumulates: ``tiling_grid``'s (bm, bk, bn) blocks x accumulation
    policy, swept by ``repro_torch.benchmarks.memory_modes`` through
    ``kernels.matmul`` (accum "vmem" for a single pass, "hbm" otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ModelCfg


@dataclass(frozen=True)
class MemoryMode:
    name: str
    remat: str  # "none" | "dots" | "full"
    # matmul tiling (the NUMA-hash analogue)
    block: Tuple[int, int, int] = (512, 512, 512)  # (bm, bk, bn)
    k_splits: int = 1  # 1 = single-pass accumulate ("cache"); >1 revisits C
    moe_impl: str = "dispatch"  # "dispatch" | "ragged"

    def vmem_bytes(self, dtype_bytes: int = 2) -> int:
        """Working set of one TPU grid step (A, B tiles + f32 C) — the
        JAX package's fit criterion, kept so the grid is the same."""
        bm, bk, bn = self.block
        return bm * bk * dtype_bytes + bk * bn * dtype_bytes + bm * bn * 4


# the three near-memory policies (x default tiling)
CACHE = MemoryMode("cache", remat="dots")
FLAT = MemoryMode("flat", remat="none")
HYBRID = MemoryMode("hybrid", remat="full")

MODES = {m.name: m for m in (CACHE, FLAT, HYBRID)}


def apply(cfg: ModelCfg, mode: MemoryMode) -> ModelCfg:
    return cfg.replace(remat=mode.remat)


def tiling_grid(vmem_budget: int = 100 * 2**20):
    """The '15 configurations' analogue: tilings x accumulation policies
    that fit the budget.  Returns [MemoryMode] for the sweep."""
    out = []
    for bm, bk, bn in [(256, 256, 256), (512, 512, 512), (512, 1024, 512),
                       (1024, 512, 1024), (128, 2048, 128)]:
        for k_splits, tag in [(1, "cache"), (2, "hybrid"), (8, "flat")]:
            m = MemoryMode(f"b{bm}x{bk}x{bn}-{tag}", remat="dots",
                           block=(bm, bk, bn), k_splits=k_splits)
            if m.vmem_bytes() <= vmem_budget:
                out.append(m)
    return out

"""Memory-mode table on the card — the paper's 15 MCDRAM/NUMA
configurations as ``core.memory_modes.tiling_grid``'s matmul tilings x
accumulation policies (accum "vmem" for a single pass, "hbm" otherwise, as
in the JAX module), through the hand-written CUDA matmul kernel at
M = K = N = 8192, float32.

CSV: name,us_per_call,derived  (derived = measured GFLOP/s, the number of
C passes, and the bytes the policy must move, ``kernels.matmul.policy_bytes``)
"""
import torch

from repro_torch import resolve_device
from repro_torch.core.memory_modes import tiling_grid
from repro_torch.core.sweep import seconds_per_call
from repro_torch.kernels import matmul as mm

M = K = N = 8192
SMALL = 256  # the CPU rehearsal (--small)
REPS = 3  # timed calls per row, after one warm-up call


def rows(device="cuda", small=False):
    dev = resolve_device(device)
    n = SMALL if small else M
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=dev)
    b = torch.randn((n, n), generator=g, device=dev)
    out = []
    for mode in tiling_grid():
        accum = "vmem" if mode.k_splits == 1 else "hbm"
        s = seconds_per_call(
            lambda: mm.matmul(a, b, block=mode.block, accum=accum), REPS, dev)
        passes = mm.k_passes(n, mode.block, accum)
        moved = mm.policy_bytes(n, n, n, a.dtype, mode.block, accum)
        out.append((f"memmode/{mode.name}", s * 1e6,
                    f"{2.0 * n ** 3 / s / 1e9:.1f}GF/s;passes={passes};"
                    f"moved={moved / 1e9:.3f}GB"))
    return out


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

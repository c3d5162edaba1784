"""Fig. 5 analogue on the card — the second engine (the hand-written CUDA
matmul kernel, one call per process; it stands for the JAX package's
Pallas engine and the paper's Octave) over the same constant-memory Nproc
sweep as ``fig4_engine_sweep``.

CSV: name,us_per_call,derived   (derived = measured GFLOP/s)
"""
from repro_torch.benchmarks.fig4_engine_sweep import sweep_rows

ENGINE = "kernel"


def rows(device="cuda", small=False):
    return sweep_rows("fig5", ENGINE, device, small)


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

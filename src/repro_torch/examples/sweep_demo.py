"""The paper's experiment in miniature: measured matmul GFLOP/s across the
Nproc sweep at constant total memory (N = N0/sqrt(Nproc)), both engines:
cuBLAS (PyTorch's batched matmul) and the hand-written CUDA matmul kernel.

  PYTHONPATH=src python -m repro_torch.examples.sweep_demo [--device cpu]

On the CPU the kernel's engine runs its plain version: the numbers say
nothing of the card.  The full measured sweep is
``python -m repro_torch.benchmarks.run``.
"""
import argparse

from repro_torch.core.sweep import measured_gflops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    rows = []
    print(f"{'engine':>7} {'Nproc':>6} {'N':>6} {'ms/call':>9} {'GF/s':>8}")
    for engine, nprocs, n0 in (("cublas", (1, 2, 4, 8), 1024),
                               ("kernel", (1, 2), 384)):
        for p in nprocs:
            r = measured_gflops(engine, p, n0=n0, reps=2, device=args.device)
            rows.append(r)
            print(f"{engine:>7} {p:6d} {r['N']:6d} "
                  f"{r['us_per_call']/1e3:9.1f} {r['gflops']:8.1f}")
    print("\n(the paper's finding: with affinity+memory-mode set correctly, "
          "throughput is flat across the whole Nproc x Nthread range)")
    return rows


if __name__ == "__main__":
    main()

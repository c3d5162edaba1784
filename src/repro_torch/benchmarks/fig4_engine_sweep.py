"""Fig. 4 analogue on the card — the first engine (cuBLAS through
``torch.matmul``, standing for the JAX package's XLA engine and the paper's
Matlab) over the Nproc sweep at constant total memory: N = N0/sqrt(Nproc),
float32, so A, B and C take 1 GiB each at every Nproc (N0 = 16384).

CSV: name,us_per_call,derived   (derived = measured GFLOP/s)

The JAX module's derived TPU-pod rows (the HLO-walked sweep) wait with
``core/roofline.py`` (ROADMAP.md, Queue 1).
"""
from repro_torch.core.sweep import measured_gflops

ENGINE = "cublas"
N0 = 16384
NPROCS = (1, 2, 4, 8, 16, 32, 64)  # the paper's 1 to 64 processes
SMALL_N0, SMALL_NPROCS = 256, (1, 2, 4)  # the CPU rehearsal (--small)
REPS = 3  # timed calls per point, after one warm-up call


def sweep_rows(fig: str, engine: str, device="cuda", small=False):
    n0, nprocs = (SMALL_N0, SMALL_NPROCS) if small else (N0, NPROCS)
    out = []
    for nproc in nprocs:
        r = measured_gflops(engine, nproc, n0=n0, reps=REPS, device=device)
        out.append((f"{fig}/{engine}/measured/nproc={nproc}/N={r['N']}",
                    r["us_per_call"], f"{r['gflops']:.1f}GF/s"))
    return out


def rows(device="cuda", small=False):
    return sweep_rows("fig4", ENGINE, device, small)


def main():
    for name, us, derived in rows():
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()

"""Benchmark harness of the port — one module per paper figure or table,
the counterparts of the root ``benchmarks/`` modules of the same names:

  fig4_engine_sweep  — Matlab sweep  = cuBLAS engine, Nproc sweep at const mem
  fig5_engine_sweep  — Octave sweep  = the CUDA matmul kernel, same protocol
  memory_modes       — 15 MCDRAM/NUMA configs = tiling x accumulation grid

Prints ``name,us_per_call,derived`` CSV, measured on the card:

  PYTHONPATH=src python -m repro_torch.benchmarks.run
  PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu --small

``--device cpu --small`` is the CPU rehearsal at tiny sizes (the kernels'
plain versions; its times say nothing of the card).  There is no fallback:
without a card and without ``--device cpu`` the harness raises.  The
``pinning`` module (Fig. 3's taskset) waits with ``core/affinity.py``
(ROADMAP.md, Queue 1).
"""
import argparse

from repro_torch.benchmarks import (fig4_engine_sweep, fig5_engine_sweep,
                                    memory_modes)

MODULES = (fig4_engine_sweep, fig5_engine_sweep, memory_modes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure on (default: cuda)")
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes, for a rehearsal on the CPU")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for mod in MODULES:
        for name, us, derived in mod.rows(device=args.device, small=args.small):
            print(f"{name},{us:.1f},{derived}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

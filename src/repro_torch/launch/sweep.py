"""Run the paper's Nproc x Nthread x memory-mode sweep, derived: each cell's
per-rank program counted on fake tensors under a fake process group
(``core.sweep.run_sweep``) and priced on an H100; writes
``<out>/results.json``.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--n-units 256] [--quick]

Counterpart of ``repro.launch.sweep``.  The count needs no card and makes
no CUDA call: it runs the same on a machine with a GPU and on one without.
"""
import argparse
import json
from pathlib import Path

from repro_torch.core.roofline import H100
from repro_torch.core.sweep import factorizations, run_sweep


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The derived sweep: per-rank programs counted on fake "
                    "tensors and priced on an H100.  Needs no GPU and makes "
                    "no CUDA call.")
    ap.add_argument("--n-units", type=int, default=256)
    ap.add_argument("--out", default="runs/sweep")
    ap.add_argument("--quick", action="store_true",
                    help="power-of-4 splits only (5 instead of 9)")
    args = ap.parse_args(argv)

    splits = factorizations(args.n_units)
    if args.quick:
        splits = [s for i, s in enumerate(splits) if i % 2 == 0]
    rows = run_sweep(args.n_units, splits=splits)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps(rows, indent=1))

    print(f"{'Nproc':>6} {'Nthr':>5} {'placement':>9} {'memory':>7} "
          f"{'N':>7} {'GF/chip':>9} {'peak%':>7} dominant")
    for r in rows:
        print(f"{r['nproc']:6d} {r['nthread']:5d} {r['placement']:>9} "
              f"{r['memory']:>7} {r['N']:7d} {r['gflops_per_chip']:9.0f} "
              f"{r['peak_fraction']:7.1%} {r['dominant']}")
    best = max(rows, key=lambda r: r["peak_fraction"])
    print(f"\nbest: {best['placement']}-{best['memory']} @ "
          f"{best['nproc']}x{best['nthread']} -> {best['peak_fraction']:.1%} "
          f"of an {H100.name}'s practical peak, derived (paper: "
          f"all2all-cache @ 66% on a Xeon Phi, measured; two different "
          f"machines)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""CLI: ``python -m repro_torch.analysis [--fail-on-findings] [--json PATH]
[--passes lint,contracts,...] [--no-compile] [--device cpu|cuda]``.

Prints a per-pass report, lists actionable findings (unsuppressed and not
in the baseline), and with ``--fail-on-findings`` exits 1 when any exist —
the CI gate.  ``--json`` writes the full findings list (suppressed ones
included, marked) for the CI artifact.  The program proof runs on the card
(``cuda``), where the steps are captured into CUDA graphs and replayed,
unless ``--device cpu`` asks for the host, as the CPU gate does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from repro_torch.analysis import PASSES, load_baseline, run_all, split_new


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant analyzer for the port's serving stack")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 if any actionable finding remains")
    ap.add_argument("--json", metavar="PATH",
                    help="write all findings (incl. suppressed) as JSON")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {','.join(PASSES)}")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip the capture contract's program proof (fast)")
    ap.add_argument("--device", default=None,
                    help="where the program proof runs (default cuda: "
                    "captured and replayed; cpu for a host without a card)")
    args = ap.parse_args(argv)

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    findings, stats = run_all(passes, compile_programs=not args.no_compile,
                              device=args.device)
    actionable, tolerated = split_new(findings, load_baseline())

    for name in passes:
        s = dict(stats.get(name, {}))
        n = s.pop("findings", 0)
        extra = f"  {s}" if s else ""
        print(f"[{name:>9}] {n} finding(s){extra}")
    for f in sorted(actionable, key=lambda f: (f.path, f.line, f.rule)):
        print(f"  ACTIONABLE {f}")
    for f in sorted(tolerated, key=lambda f: (f.path, f.line, f.rule)):
        print(f"  tolerated  {f}")
    print(f"{len(actionable)} actionable, {len(tolerated)} tolerated "
          f"finding(s) across {len(passes)} pass(es)")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump([dataclasses.asdict(f) for f in findings], fh,
                      indent=2)
        print(f"findings written to {args.json}")

    return 1 if (args.fail_on_findings and actionable) else 0


if __name__ == "__main__":
    sys.exit(main())

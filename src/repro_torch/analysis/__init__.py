"""repro_torch.analysis — static invariant analyzer for the port's serving
stack (the port of ``repro.analysis``).

Four passes, one findings model, one CLI (``python -m
repro_torch.analysis``):

- ``servelint``  — repo-specific AST lint (capture factory discipline,
  hot-path nondeterminism incl. torch's global RNG, broad except, mutable
  defaults, Python scalars fed to a captured step);
- ``contracts``  — capture contract checker: runs every serving program
  the engine builds, through its own builders, and proves it dispatches no
  host-synchronising op, keeps every pool at its ``data_ptr()`` with its
  writes in that storage, and leaves the state bit-identical on an idle
  pack (captured and replayed on a CUDA device); AST layers pin the
  engine to those builders;
- ``lifecycle``  — page-lifecycle model checker: exhaustive BFS over a
  small-pool transition system proving no leak / double-free /
  parked-page eviction is reachable;
- ``protocols``  — scheduler registry conformance (orderings are
  permutations/subsequences; wrappers delegate verbatim).

Findings are typed ``file:line`` records; ``# servelint: ignore[rule] —
reason`` suppresses inline; ``baseline.json`` is checked in EMPTY and must
stay empty.  See README.md in this directory for the rule reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import (BASELINE_PATH, Finding,
                                           Suppressions, load_baseline,
                                           split_new)

__all__ = ["Finding", "Suppressions", "load_baseline", "split_new",
           "BASELINE_PATH", "run_all", "PASSES"]

PASSES = ("lint", "contracts", "lifecycle", "protocols")


def run_all(passes: Optional[Sequence[str]] = None, *,
            compile_programs: bool = True, device=None
            ) -> Tuple[List[Finding], Dict[str, Dict]]:
    """Run the selected passes (default: all) and aggregate findings.

    ``compile_programs=False`` skips the program proof inside the contracts
    pass (its AST layers still run) — used by fast test paths.  ``device``
    is where the program proof runs: ``cuda`` unless the caller passes
    another (on a CUDA device the programs are captured and replayed).
    """
    selected = tuple(passes) if passes else PASSES
    unknown = sorted(set(selected) - set(PASSES))
    if unknown:
        raise ValueError(f"unknown passes {unknown} (pick from {PASSES})")
    findings: List[Finding] = []
    stats: Dict[str, Dict] = {}
    if "lint" in selected:
        from repro_torch.analysis.servelint import lint_tree
        lint = lint_tree()
        findings.extend(lint)
        stats["lint"] = {"findings": len(lint)}
    if "contracts" in selected:
        from repro_torch.analysis.contracts import check_contracts
        got, s = check_contracts(compile_programs=compile_programs,
                                 device=device)
        findings.extend(got)
        stats["contracts"] = {**s, "findings": len(got)}
    if "lifecycle" in selected:
        from repro_torch.analysis.lifecycle import check_lifecycle_findings
        got, s = check_lifecycle_findings()
        findings.extend(got)
        stats["lifecycle"] = {**s, "findings": len(got)}
    if "protocols" in selected:
        from repro_torch.analysis.protocols import check_protocols
        got, s = check_protocols()
        findings.extend(got)
        stats["protocols"] = {**s, "findings": len(got)}
    return findings, stats

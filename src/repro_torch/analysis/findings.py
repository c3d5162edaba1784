"""Typed findings, the suppression model, and the checked-in baseline.

A copy of ``repro.analysis.findings`` (the port imports nothing of the JAX
package).  Every analysis pass (servelint / contracts / lifecycle /
protocols) reports ``Finding`` records — (rule, file, line, message) —
never free-form text, so the CLI can diff them against the baseline and CI
can gate on the count.  Paths are repo-relative and lie under
``src/repro_torch`` (e.g. ``src/repro_torch/serve/engine.py``).

Suppression syntax, checked at the flagged line or the line directly above:

    x = risky()  # servelint: ignore[rule-id] — reason the rule is wrong here
    # servelint: ignore[rule-a,rule-b] — reason
    y = also_risky()

A suppression must name the rule(s) it silences (no blanket ignores) and
SHOULD carry a reason after the bracket — the CLI report prints it.  The
baseline (``baseline.json`` next to this module) is the list of finding
keys tolerated at head; it is checked in EMPTY and must stay empty — new
findings either get fixed or get an inline, reasoned suppression.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Sequence, Set, Tuple

__all__ = ["Finding", "Suppressions", "load_baseline", "split_new",
           "BASELINE_PATH"]

BASELINE_PATH = Path(__file__).with_name("baseline.json")

_SUPPRESS_RE = re.compile(
    r"#\s*servelint:\s*ignore\[([a-z0-9_,\s-]+)\]\s*(?:[—–:-]\s*(.*))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer verdict, anchored to a file:line."""

    rule: str
    path: str  # repo-relative, e.g. "src/repro_torch/serve/engine.py"
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""  # the suppression's reason text, when suppressed

    @property
    def key(self) -> str:
        """Stable identity for baseline diffing (message-free on purpose:
        rewording a message must not un-baseline a finding)."""
        return f"{self.path}:{self.line}:{self.rule}"

    def __str__(self) -> str:
        tag = f" [suppressed: {self.reason or 'no reason given'}]" \
            if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


class Suppressions:
    """Per-file `# servelint: ignore[rule]` index, built from source text."""

    def __init__(self, source: str):
        # line (1-based) -> {rule: reason}; a comment on its own line also
        # covers the next line, so multi-line statements can hoist the
        # suppression above the flagged expression
        self._by_line: Dict[int, Dict[str, str]] = {}
        for i, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = (m.group(2) or "").strip()
            entry = {r: reason for r in rules}
            self._by_line.setdefault(i, {}).update(entry)
            if text.lstrip().startswith("#"):  # own-line comment: covers
                self._by_line.setdefault(i + 1, {}).update(entry)  # next line

    def lookup(self, line: int, rule: str) -> Tuple[bool, str]:
        """Is ``rule`` suppressed at ``line`` (same line or line above)?"""
        for ln in (line, line - 1):
            entry = self._by_line.get(ln)
            if entry and rule in entry:
                return True, entry[rule]
        return False, ""

    def apply(self, finding: Finding) -> Finding:
        hit, reason = self.lookup(finding.line, finding.rule)
        if not hit:
            return finding
        return dataclasses.replace(finding, suppressed=True, reason=reason)


def load_baseline(path: Path = BASELINE_PATH) -> Set[str]:
    """Finding keys tolerated at head.  Checked in empty; stays empty."""
    if not path.exists():
        return set()
    return set(json.loads(path.read_text()))


def split_new(findings: Sequence[Finding],
              baseline: Set[str]) -> Tuple[List[Finding], List[Finding]]:
    """(actionable, tolerated): unsuppressed findings not in the baseline
    are actionable; suppressed or baselined ones are tolerated."""
    actionable, tolerated = [], []
    for f in findings:
        (tolerated if f.suppressed or f.key in baseline
         else actionable).append(f)
    return actionable, tolerated

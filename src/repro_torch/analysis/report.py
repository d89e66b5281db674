"""Structured findings for the static analyzer (counterpart of
``repro.analysis.report``; standard library only).

Severity ladder:

``error``  a declared contract is provably violated — the build fails;
``warn``   suspicious but not provably wrong (e.g. a stale conservative
           flag, a block whose shared memory leaves a multiprocessor no
           room for a second one) — fails under ``--strict``;
``info``   observations with no action required (a pass not run, and
           why);
``ok``     a contract that was checked and held (kept in the report so
           "pass" is distinguishable from "never ran").
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List

LEVELS = ("error", "warn", "info", "ok")


@dataclass
class Finding:
    level: str           # one of LEVELS
    pass_name: str       # "contract" | "launch" | "selftest" | ...
    subject: str         # what was checked ("strategy:scarlet", "era/B10-N10")
    message: str

    def __post_init__(self):
        if self.level not in LEVELS:
            raise ValueError(f"unknown level {self.level!r}")

    def __str__(self):
        return f"[{self.level.upper():5s}] {self.pass_name}: {self.subject}: {self.message}"


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)

    def add(self, level: str, pass_name: str, subject: str, message: str):
        self.findings.append(Finding(level, pass_name, subject, message))

    def extend(self, findings):
        self.findings.extend(findings)

    def counts(self) -> Dict[str, int]:
        c = {lv: 0 for lv in LEVELS}
        for f in self.findings:
            c[f.level] += 1
        return c

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.level == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.level == "warn"]

    def exit_code(self, strict: bool = False) -> int:
        """Nonzero on any error; under ``--strict`` warnings fail too."""
        if self.errors:
            return 1
        if strict and self.warnings:
            return 1
        return 0

    def render(self, verbose: bool = False) -> str:
        """Human-readable report; ``verbose`` includes ok/info lines."""
        shown = [f for f in self.findings
                 if verbose or f.level in ("error", "warn")]
        lines = [str(f) for f in shown]
        c = self.counts()
        lines.append("analysis: {error} error(s), {warn} warning(s), "
                     "{info} info, {ok} ok".format(**c))
        return "\n".join(lines)

    def to_dict(self) -> Dict:
        return {"findings": [asdict(f) for f in self.findings],
                "counts": self.counts()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

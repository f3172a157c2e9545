"""Declarative contract engine: ``Rule(name, applies_when, check)``, ported
from :mod:`crosscoder_tpu.analysis.contracts.engine`.

The port's load-bearing guarantees (every knob zero-cost when off, the
fused encoder never building the ``[B, dict]`` pre-activations, donation,
dtype hygiene, no host transfer inside the step, kernel launch safety,
stdout and metric-key hygiene, compile-cache key completeness) each live
here as a named, documented predicate over a prebuilt context. The runner
executes every applicable rule, and ``python -m
crosscoder_tpu_torch.analysis.contracts`` turns the findings into a human
report, one JSON document, and an exit code.

Every rule ships a mutation self-test (``mutations.py``): a seeded
violation proving the rule actually fires.

The findings, the report and both renderings are the JAX package's byte
for byte: the same rules and findings give the same ``to_json()`` and
``format_human()``.

Suppression syntax
------------------
- engine level: ``run_rules(..., allow={"rule-name"})`` (the ``--allow``
  flag of the CLI) drops a rule's findings but still records it as
  suppressed;
- source level (AST lints only): a ``# contracts: allow(rule-name)``
  comment on the flagged line suppresses that one finding.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable

SUPPRESS_RE = re.compile(r"#\s*contracts:\s*allow\(([\w, -]+)\)")


def line_suppresses(source_line: str, rule_name: str) -> bool:
    """True when the line carries ``# contracts: allow(<rule>)`` naming
    this rule (comma-separated rule names allowed)."""
    m = SUPPRESS_RE.search(source_line)
    if not m:
        return False
    return rule_name in {s.strip() for s in m.group(1).split(",")}


@dataclass
class Finding:
    """One contract violation: which rule, where, and what went wrong."""

    rule: str
    message: str
    location: str = ""          # "path:line" or a variant/kernel label
    severity: str = "error"     # error | warning (warnings never fail the run)

    def to_dict(self) -> dict[str, str]:
        return {"rule": self.rule, "message": self.message,
                "location": self.location, "severity": self.severity}

    def __str__(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        return f"{self.rule}{loc}: {self.message}"


@dataclass
class Rule:
    """One declarative contract.

    ``applies_when(ctx)`` gates the rule on context capability (the step
    rules need recorded step variants, the kernel rules captured
    launches); ``check(ctx)`` returns findings. A crashing ``check`` is
    itself a finding (``severity=error``, ``rule=<name>``): the analyzer
    never passes vacuously because a rule's harness broke.
    """

    name: str
    description: str
    applies_when: Callable[[Any], bool]
    check: Callable[[Any], list[Finding]]


@dataclass
class Report:
    """Aggregate of one engine run: findings + audit trail of what ran."""

    findings: list[Finding] = field(default_factory=list)
    checked: list[str] = field(default_factory=list)
    skipped: list[str] = field(default_factory=list)
    suppressed: list[str] = field(default_factory=list)
    info: dict[str, Any] = field(default_factory=dict)   # e.g. shared-memory use

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)

    def merge(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.checked.extend(other.checked)
        self.skipped.extend(other.skipped)
        self.suppressed.extend(other.suppressed)
        self.info.update(other.info)
        return self

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "checked": self.checked,
            "skipped": self.skipped,
            "suppressed": self.suppressed,
            "info": self.info,
        }, indent=2, sort_keys=True)

    def format_human(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(f"  {'ERROR' if f.severity == 'error' else 'warn '} "
                         f"{f}")
        lines.append(f"analyze: {len(self.checked)} rules checked, "
                     f"{len(self.findings)} findings "
                     f"({len(self.skipped)} skipped, "
                     f"{len(self.suppressed)} suppressed)")
        for k in sorted(self.info):
            lines.append(f"  info {k}: {self.info[k]}")
        return "\n".join(lines)


def run_rules(rules: list[Rule], ctx: Any,
              allow: set[str] | frozenset[str] = frozenset()) -> Report:
    """Run every applicable rule; a rule crash becomes a finding."""
    report = Report()
    for rule in rules:
        if rule.name in allow:
            report.suppressed.append(rule.name)
            continue
        try:
            if not rule.applies_when(ctx):
                report.skipped.append(rule.name)
                continue
            report.findings.extend(rule.check(ctx))
        except Exception as e:  # noqa: BLE001 — harness faults are findings
            report.findings.append(Finding(
                rule=rule.name, severity="error",
                message=f"rule harness crashed: {type(e).__name__}: {e}",
            ))
        report.checked.append(rule.name)
    return report

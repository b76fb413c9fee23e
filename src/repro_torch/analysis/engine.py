"""Dependency-free AST lint engine — the port's own copy of
``repro.analysis.engine`` (the port imports nothing of ``repro``).

The engine is deliberately boring: it parses each file once, hands the
module to every rule, and collects :class:`Finding` objects.  All the
repo-specific intelligence lives in :mod:`repro_torch.analysis.rules`.
What the engine owns is the workflow plumbing:

* **suppressions** — a ``# analysis: ignore`` comment (optionally scoped,
  ``# analysis: ignore[SYN001,DTY001]``) on the flagged line or the line
  directly above silences the finding.  Scoped suppressions are preferred;
  a bare ``ignore`` silences every rule on that line.
* **baseline** — pre-existing findings can be checked into a JSON baseline
  so the CLI only fails on NEW findings; fingerprints are
  ``(path, rule, stripped source line)`` so ordinary line drift does not
  invalidate the baseline, while editing the flagged code does.
* **reporters** — ``to_text`` for humans, ``to_json`` for CI artifacts.

Stdlib-only by design: the lint runs without torch installed.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Iterable, Sequence

__all__ = [
    "Finding", "ModuleInfo", "Rule", "parse_module", "run_rules",
    "load_baseline", "write_baseline", "new_findings", "to_text", "to_json",
]

_SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*ignore(?:\[(?P<rules>[A-Z0-9,\s]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    path: str
    line: int        # 1-based
    col: int         # 0-based
    message: str
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        """Baseline identity: stable under line drift, invalidated when
        the flagged source line itself changes."""
        return f"{self.path}::{self.rule}::{self.snippet.strip()}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} {self.message}")


@dataclasses.dataclass
class ModuleInfo:
    """A parsed source file as rules see it."""
    path: str          # repo-relative posix path, e.g. src/repro_torch/x.py
    source: str
    tree: ast.Module
    lines: list[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.source.splitlines()

    def snippet(self, node: ast.AST) -> str:
        ln = getattr(node, "lineno", 0)
        if 1 <= ln <= len(self.lines):
            return self.lines[ln - 1]
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       message=message, snippet=self.snippet(node))


# A rule is anything with .name and .check(module) -> iterable of findings.
class Rule:
    name = "RULE000"

    def check(self, module: ModuleInfo) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


# -- suppression ------------------------------------------------------------

def _suppressed_rules(line: str) -> set[str] | None:
    """None = no suppression on this line; empty set = bare ``ignore``
    (suppresses everything); otherwise the named rules."""
    m = _SUPPRESS_RE.search(line)
    if m is None:
        return None
    rules = m.group("rules")
    if rules is None:
        return set()
    return {r.strip() for r in rules.split(",") if r.strip()}

def is_suppressed(finding: Finding, lines: Sequence[str]) -> bool:
    """A finding is suppressed by a marker on its own line or the line
    directly above (for when the flagged line has no room)."""
    for ln in (finding.line, finding.line - 1):
        if 1 <= ln <= len(lines):
            rules = _suppressed_rules(lines[ln - 1])
            if rules is not None and (not rules or finding.rule in rules):
                return True
    return False


# -- running the rules ------------------------------------------------------

def parse_module(path: Path, root: Path | None = None) -> ModuleInfo | None:
    """Parse one file; None when it is not valid Python (reported by the
    caller as a hard error, not a finding)."""
    source = path.read_text()
    rel = path.as_posix()
    if root is not None:
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            pass

    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError:
        return None
    return ModuleInfo(path=rel, source=source, tree=tree)


def iter_py_files(paths: Sequence[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def run_rules(paths: Sequence[Path], rules: Sequence[Rule], *,
              root: Path | None = None,
              on_error: Callable[[Path], None] | None = None
              ) -> list[Finding]:
    """Run every rule over every ``*.py`` under ``paths``; suppressed
    findings are dropped here so callers only ever see actionable ones."""
    findings: list[Finding] = []
    for path in iter_py_files(paths):
        mod = parse_module(path, root)
        if mod is None:
            if on_error is not None:
                on_error(path)
            continue
        for rule in rules:
            for f in rule.check(mod):
                if not is_suppressed(f, mod.lines):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -- baseline ---------------------------------------------------------------

def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return set(data.get("findings", []))


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    data = {
        "comment": "Known findings burned down deliberately; regenerate "
                   "with `python -m repro_torch.analysis --write-baseline`.",
        "findings": sorted({f.fingerprint for f in findings}),
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def new_findings(findings: Sequence[Finding],
                 baseline: set[str]) -> list[Finding]:
    return [f for f in findings if f.fingerprint not in baseline]


# -- reporters --------------------------------------------------------------

def to_text(findings: Sequence[Finding]) -> str:
    if not findings:
        return "analysis: clean (0 findings)"
    out = [f.format() + "\n    " + f.snippet.strip() for f in findings]
    out.append(f"analysis: {len(findings)} finding(s)")
    return "\n".join(out)


def to_json(findings: Sequence[Finding]) -> str:
    return json.dumps(
        {"n_findings": len(findings),
         "findings": [dataclasses.asdict(f) for f in findings]},
        indent=2)

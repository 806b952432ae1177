"""The lint engine: file walking, pragma suppression, baseline diffing.

The reference's ``repro/analysis/lint.py`` over the port's rules
(``repro_torch.analysis.rules``): the same :class:`Finding` records, the
same pragma grammar and the same baseline format, so one tree of pragmas
and baselines reads alike in both packages. Three suppression layers, in
order:

1. **pragma** — ``# lint:allow(<rule-id>) <reason>`` on the finding's
   line or the line directly above suppresses that rule *for that line*.
   The reason string is mandatory: a pragma without one does not
   suppress (an invariant escape hatch must say why it is safe). Spaces
   around the colon are optional (the reference's docs write one).
2. **baseline** — a checked-in JSON list of ``{rule, path, line}``
   entries (``repro_torch/analysis/baseline.json``; empty on the merged
   tree). Baselined findings are reported as such and do not fail the
   CLI — the ratchet for landing a rule on a tree with pre-existing debt.
3. rule-internal path scoping (see ``rules/__init__.py``).

Entry points: :func:`lint_file`, :func:`lint_paths`,
:func:`load_baseline` / :func:`save_baseline`, :func:`partition` (split
findings into new vs baselined).
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

from .rules import RULES, RULE_IDS

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

_PRAGMA = re.compile(
    r"#\s*lint:\s*allow\(\s*([a-z0-9_\-,\s]+?)\s*\)\s*(\S.*)?$")


@dataclass(frozen=True)
class Finding:
    path: str          # posix path as reported (relative to the
                       # working directory when under it)
    line: int
    rule: str
    message: str
    hint: str = ""

    def key(self) -> Tuple[str, str, int]:
        return (self.rule, self.path, self.line)

    def render(self) -> str:
        s = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            s += f"\n    fix: {self.hint}"
        return s


def comment_lines(src: str) -> Dict[int, str]:
    """{line: comment text} for every real ``#`` comment token — pragmas
    are matched against comments only, so a docstring *describing* the
    pragma syntax can never suppress (or trip) anything."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenizeError, IndentationError, SyntaxError):
        pass  # unparseable files surface as syntax-error findings
    return out


def pragma_allows(comments: Dict[int, str], line: int,
                  rule_id: str) -> bool:
    """True when line (1-indexed) or the line above carries a well-formed
    ``# lint:allow(rule-id) <reason>`` pragma covering ``rule_id``."""
    for ln in (line, line - 1):
        m = _PRAGMA.search(comments.get(ln, ""))
        if not m:
            continue
        ids = {p.strip() for p in m.group(1).split(",")}
        reason = (m.group(2) or "").strip()
        if rule_id in ids and reason:
            return True
    return False


def scan_pragmas(comments: Dict[int, str], path: str) -> List[Finding]:
    """A pragma naming an unknown rule id, or carrying no reason, is itself
    a finding — silent typos must not disable enforcement."""
    out = []
    for i, text in sorted(comments.items()):
        m = _PRAGMA.search(text)
        if not m:
            continue
        ids = {p.strip() for p in m.group(1).split(",")}
        reason = (m.group(2) or "").strip()
        unknown = ids - set(RULE_IDS)
        if unknown:
            out.append(Finding(path, i, "bad-pragma",
                               f"pragma names unknown rule id(s) "
                               f"{sorted(unknown)} (known: {list(RULE_IDS)})",
                               "fix the rule id"))
        if not reason:
            out.append(Finding(path, i, "bad-pragma",
                               "pragma has no reason string — an invariant "
                               "escape hatch must say why it is safe "
                               "(it does NOT suppress until it does)",
                               "append a reason after the closing paren"))
    return out


def lint_file(path: str) -> List[Finding]:
    """Lint one Python file; returns pragma-filtered findings (including
    ``bad-pragma`` self-checks). Syntax errors are findings, not crashes —
    the linter must never take the test runner down with it."""
    p = Path(path)
    src = p.read_text(encoding="utf-8")
    rel = os.path.relpath(p).replace("\\", "/")
    if rel.startswith(".."):
        rel = p.as_posix()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, "syntax-error",
                        f"file does not parse: {e.msg}", "fix the syntax")]
    comments = comment_lines(src)
    findings = scan_pragmas(comments, rel)
    for rule in RULES:
        for line, message in rule.check(tree, src, rel):
            if pragma_allows(comments, line, rule.rule_id):
                continue
            findings.append(Finding(rel, line, rule.rule_id, message,
                                    rule.hint))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(str(f) for f in path.rglob("*.py")
                              if "__pycache__" not in f.parts))
        elif path.suffix == ".py":
            out.append(str(path))
    return out


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f))
    return findings


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def load_baseline(path=DEFAULT_BASELINE) -> List[dict]:
    p = Path(path)
    if not p.exists():
        return []
    entries = json.loads(p.read_text())
    assert isinstance(entries, list), f"baseline {p} must be a JSON list"
    return entries


def save_baseline(findings: Sequence[Finding], path=DEFAULT_BASELINE):
    entries = [{"rule": f.rule, "path": f.path, "line": f.line,
                "message": f.message} for f in findings]
    Path(path).write_text(json.dumps(entries, indent=2) + "\n")


def partition(findings: Sequence[Finding], baseline: Sequence[dict]):
    """Split findings into (new, baselined). A baseline entry matches on
    (rule, path) + line, tolerating small line drift (±2) so a comment
    edit above a baselined site does not spuriously re-fire it."""
    keys = [(b["rule"], b["path"], int(b["line"])) for b in baseline]
    new, old = [], []
    for f in findings:
        if any(r == f.rule and p == f.path and abs(l - f.line) <= 2
               for r, p, l in keys):
            old.append(f)
        else:
            new.append(f)
    return new, old


__all__ = ["Finding", "lint_file", "lint_paths", "iter_py_files",
           "load_baseline", "save_baseline", "partition", "pragma_allows",
           "DEFAULT_BASELINE", "asdict"]

"""ctlint runner: file collection, AST parsing, suppressions, output.

A *rule* is a callable ``rule(module: LintModule) -> Iterable[Finding]``
registered in :data:`cluster_tools_tpu_torch.lint.rules.RULES`.  The runner
parses each file once, hands the shared :class:`LintModule` to every
selected rule, filters findings through the inline suppression map, and
renders text or machine-readable JSON (schema below).

Suppressions::

    risky_call()  # ctlint: disable=CT002
    # ctlint: disable=CT001,CT005   <- applies to the NEXT code line
    # ctlint: disable-file=CT004    <- whole file, any line

Suppressed findings are counted (``n_suppressed``) but not reported, so
opt-outs stay visible as debt instead of vanishing.

JSON schema (``--json``)::

    {"version": 1, "n_files": N, "n_suppressed": N,
     "counts": {"CT001": n, ...},
     "findings": [{"rule", "file", "line", "col", "message"}, ...]}
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: directories never linted (fixtures are linted only when named explicitly)
EXCLUDE_DIR_NAMES = ("__pycache__", "lint_fixtures", "lint_fixtures_torch", ".git")

_SUPPRESS_RE = re.compile(r"#\s*ctlint:\s*disable=([A-Z0-9,\s]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*ctlint:\s*disable-file=([A-Z0-9,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at file:line."""

    rule: str
    file: str
    line: int
    col: int
    message: str

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: {self.rule} {self.message}"


class LintModule:
    """One parsed source file shared by every rule.

    ``tree`` is the parsed AST (None for files with syntax errors — rules
    skip those; the runner reports them as CT000).  ``lines`` is the raw
    source split for suppression lookup; ``parents`` maps each AST node to
    its parent so rules can walk enclosing scopes.
    """

    def __init__(self, path: str, source: str):
        self.path = path
        self.name = os.path.basename(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(source)
        except SyntaxError as e:
            self.parse_error = f"syntax error: {e.msg} (line {e.lineno})"
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None
        self._suppressed_lines: Optional[Dict[int, set]] = None
        self._suppressed_file: Optional[set] = None

    # -- structure helpers -------------------------------------------------
    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    for child in ast.iter_child_nodes(node):
                        self._parents[child] = node
        return self._parents

    def enclosing(self, node: ast.AST, *types) -> Optional[ast.AST]:
        """Nearest ancestor of ``node`` matching ``types`` (or None)."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, types):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        return self.enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        return self.enclosing(node, ast.ClassDef)

    # -- suppressions ------------------------------------------------------
    def _scan_suppressions(self) -> None:
        per_line: Dict[int, set] = {}
        whole_file: set = set()
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_FILE_RE.search(line)
            if m:
                whole_file.update(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                continue
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            target = i
            if line.split("#", 1)[0].strip() == "":
                # comment-only line: applies to the next code line
                j = i + 1
                while j <= len(self.lines) and (
                    self.lines[j - 1].strip() == ""
                    or self.lines[j - 1].lstrip().startswith("#")
                ):
                    j += 1
                target = j
            per_line.setdefault(target, set()).update(rules)
        self._suppressed_lines = per_line
        self._suppressed_file = whole_file

    def is_suppressed(self, rule: str, line: int) -> bool:
        if self._suppressed_lines is None:
            self._scan_suppressions()
        if rule in self._suppressed_file:
            return True
        return rule in self._suppressed_lines.get(line, set())


def collect_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted list of ``.py`` files,
    skipping :data:`EXCLUDE_DIR_NAMES` (fixtures lint only when a fixture
    file is named explicitly)."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs if d not in EXCLUDE_DIR_NAMES
            )
            for fname in sorted(files):
                if fname.endswith(".py"):
                    out.append(os.path.join(root, fname))
    seen, uniq = set(), []
    for f in out:
        key = os.path.abspath(f)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


def run_lint(
    paths: Sequence[str],
    rules: Optional[Dict[str, object]] = None,
    select: Optional[Iterable[str]] = None,
) -> Tuple[List[Finding], Dict[str, int]]:
    """Lint ``paths`` with ``rules`` (default: the full registry).

    Returns ``(findings, stats)`` where ``stats`` has ``n_files`` and
    ``n_suppressed``.  Unparseable files yield a CT000 finding (a syntax
    error in production code is never a clean run).
    """
    if rules is None:
        from .rules import RULES as rules  # noqa: N811 - registry import
    selected = dict(rules)
    if select:
        want = set(select)
        unknown = want - set(selected)
        if unknown:
            raise ValueError(
                f"unknown rule id(s) {sorted(unknown)}; "
                f"known: {sorted(selected)}"
            )
        selected = {k: v for k, v in selected.items() if k in want}
    findings: List[Finding] = []
    n_suppressed = 0
    files = collect_files(paths)
    for path in files:
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                source = f.read()
        except OSError as e:
            findings.append(Finding("CT000", path, 1, 0, f"unreadable: {e}"))
            continue
        module = LintModule(path, source)
        if module.tree is None:
            findings.append(
                Finding("CT000", path, 1, 0, module.parse_error or "parse error")
            )
            continue
        for rule_id, rule in selected.items():
            for finding in rule(module):
                if module.is_suppressed(finding.rule, finding.line):
                    n_suppressed += 1
                else:
                    findings.append(finding)
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings, {"n_files": len(files), "n_suppressed": n_suppressed}


def findings_to_json(
    findings: Sequence[Finding], stats: Dict[str, int]
) -> Dict[str, object]:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "version": 1,
        "n_files": int(stats.get("n_files", 0)),
        "n_suppressed": int(stats.get("n_suppressed", 0)),
        "counts": counts,
        "findings": [f.to_dict() for f in findings],
    }

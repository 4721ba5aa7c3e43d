"""Rule-runner core for graftlint (the AST half of graftcheck).

A rule is a class with an ``id``, a ``doc`` line, and a ``check(ctx)``
method yielding :class:`Finding`.  The runner parses each file once,
hands every rule the same :class:`FileContext` (tree + source lines),
and merges three suppression layers:

- **pragma**: a ``# graftlint: ignore[rule-id]`` comment on the flagged
  line (or the line above it) silences that one finding — for the rare
  site where the pattern is deliberate (e.g. ``since()`` is wall-clock
  *by definition*: it compares against user-visible stored timestamps);
- **baseline file**: a JSON list of finding fingerprints accepted as
  pre-existing debt (``--write-baseline`` emits it).  Fingerprints hash
  the rule id, the relative path, and the *normalized source line* —
  NOT the line number — so unrelated edits above a baselined finding
  don't resurrect it;
- the shipped tree carries an **empty** baseline: new findings fail CI.
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence

_PRAGMA_RE = re.compile(r"#\s*graftlint:\s*ignore\[([a-z0-9_,\- ]+)\]")


@dataclass
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    message: str
    snippet: str = ""  # the offending source line, stripped

    @property
    def fingerprint(self) -> str:
        # line CONTENT, not line number: stable across edits elsewhere
        norm = re.sub(r"\s+", " ", self.snippet.strip())
        h = hashlib.sha1(
            f"{self.rule}::{self.path}::{norm}".encode()
        ).hexdigest()
        return h[:16]

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.rule}] {self.message}\n"
            f"    {self.snippet.strip()}"
        )


@dataclass
class FileContext:
    """Everything a rule needs about one file, parsed once."""

    path: str                 # repo-relative
    source: str
    tree: ast.AST
    lines: Sequence[str] = field(default_factory=list)

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        lineno = getattr(node, "lineno", 1)
        return Finding(
            rule=rule_id,
            path=self.path,
            line=lineno,
            message=message,
            snippet=self.line(lineno),
        )

    def suppressed(self, f: Finding) -> bool:
        for lineno in (f.line, f.line - 1):
            m = _PRAGMA_RE.search(self.line(lineno))
            if m:
                ids = {s.strip() for s in m.group(1).split(",")}
                if f.rule in ids or "all" in ids:
                    return True
        return False


class Rule:
    """Base class; subclasses set ``id``/``doc`` and implement check()."""

    id: str = ""
    doc: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


def iter_py_files(
    roots: Iterable[str], exclude: Sequence[str] = ()
) -> Iterator[Path]:
    for root in roots:
        p = Path(root)
        if p.is_file() and p.suffix == ".py":
            yield p
            continue
        for f in sorted(p.rglob("*.py")):
            rel = f.as_posix()
            if any(pat in rel for pat in exclude):
                continue
            yield f


def run_rules(
    roots: Iterable[str],
    rules: Sequence[Rule],
    repo_root: Optional[str] = None,
    exclude: Sequence[str] = (),
) -> List[Finding]:
    """Parse every file once, run every rule, apply pragma suppression.
    Baseline suppression is the caller's job (it is a policy, not a
    property of the file)."""
    base = Path(repo_root) if repo_root else None
    out: List[Finding] = []
    for f in iter_py_files(roots, exclude=exclude):
        src = f.read_text(encoding="utf-8")
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            rel = _rel(f, base)
            out.append(Finding(
                rule="syntax-error", path=rel, line=e.lineno or 1,
                message=str(e.msg), snippet="",
            ))
            continue
        ctx = FileContext(
            path=_rel(f, base), source=src, tree=tree,
            lines=src.splitlines(),
        )
        for rule in rules:
            for finding in rule.check(ctx):
                if not ctx.suppressed(finding):
                    out.append(finding)
    out.sort(key=lambda x: (x.path, x.line, x.rule))
    return out


def check_source(
    source: str, rules: Sequence[Rule], path: str = "<snippet>"
) -> List[Finding]:
    """Run rules over an in-memory snippet (tests' golden fixtures)."""
    tree = ast.parse(source)
    ctx = FileContext(
        path=path, source=source, tree=tree, lines=source.splitlines()
    )
    out: List[Finding] = []
    for rule in rules:
        for f in rule.check(ctx):
            if not ctx.suppressed(f):
                out.append(f)
    return out


def _rel(f: Path, base: Optional[Path]) -> str:
    if base is not None:
        try:
            return f.resolve().relative_to(base.resolve()).as_posix()
        except ValueError:
            pass
    return f.as_posix()


# -- baseline ---------------------------------------------------------------

def load_baseline(path: Optional[str]) -> List[str]:
    """Fingerprint MULTISET (duplicates meaningful — one entry per
    accepted occurrence)."""
    if not path:
        return []
    p = Path(path)
    if not p.exists():
        return []
    data = json.loads(p.read_text())
    return list(data.get("fingerprints", []))


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    payload = {
        "comment": (
            "accepted pre-existing graftlint findings; regenerate with "
            "`python -m dgraph_tpu_torch.analysis --write-baseline`"
        ),
        # duplicates KEPT: two identical offending lines in one file
        # share a fingerprint, and the baseline must record how many
        # were accepted — see apply_baseline
        "fingerprints": sorted(f.fingerprint for f in findings),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def apply_baseline(
    findings: Sequence[Finding], baseline
) -> List[Finding]:
    """Multiset subtraction, not set membership: a baseline with ONE
    accepted `except Exception: pass` in a file suppresses exactly one
    such finding — adding a second identical line still fails."""
    from collections import Counter

    budget = Counter(baseline)
    out: List[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
        else:
            out.append(f)
    return out

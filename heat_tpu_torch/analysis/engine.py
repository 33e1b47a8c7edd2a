"""heatlint engine: file walking, suppressions, baseline, reporting
(counterpart of ``heat_tpu/analysis/engine.py``, the same behaviour).

The analyzer is AST-based and dependency-light (stdlib only): one parse
per file, one token pass for suppression comments, then every registered
rule (:mod:`heat_tpu_torch.analysis.rules`) scans the shared
:class:`FileContext`. Three escape hatches, in increasing scope:

* **inline suppression** — ``# heatlint: disable=HL002 -- reason`` on the
  flagged line (or alone on the line above it) silences named rules for
  that line; a reason string after ``--`` is the convention for keeping
  the justification next to the exemption;
* **rule allowlist** — each rule names the repo-relative files where its
  pattern is sanctioned by design (e.g. the program registry is allowed
  to capture CUDA graphs); these are part of the rule definition,
  reviewed like code;
* **baseline** — the port's own baseline file
  (``heat_tpu_torch/analysis/heatlint-baseline.json``, absent while the
  tree scans clean) grandfathers pre-existing
  findings by ``(rule, path, source-line)`` fingerprint so the gate
  fails only on NEW findings while the debt is paid down. Fingerprints
  deliberately exclude line numbers: unrelated edits above a grandfathered
  site must not resurrect it.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "FileContext",
    "Report",
    "analyze",
    "iter_python_files",
    "load_baseline",
    "load_baseline_entries",
    "write_baseline",
    "scan_source",
]

_SUPPRESS_RE = re.compile(
    r"#\s*heatlint:\s*disable(?:=(?P<rules>[A-Za-z0-9_, ]+))?"
    r"(?:\s*--\s*(?P<reason>.*))?"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-root-relative, posix separators
    line: int
    col: int
    message: str
    code: str  # stripped source line — the baseline fingerprint

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.code)

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "code": self.code,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class FileContext:
    """Everything the rules need about one parsed file, computed once."""

    def __init__(self, relpath: str, source: str, tree: ast.Module):
        self.relpath = relpath
        self.source = source
        self.lines = source.split("\n")
        self.tree = tree
        # child -> parent node map (rules walk enclosing-scope chains)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # names bound at module level (imports, defs, classes, assigns) -
        # module-level bindings are process-global, so closing over them
        # is not the per-call retrace hazard HL006 hunts
        self.module_names: Set[str] = set()
        for node in tree.body:
            self.module_names.update(_bound_names(node))

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Function/lambda nodes containing ``node``, innermost first."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


def _bound_names(node: ast.AST) -> Iterator[str]:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        yield node.name
    elif isinstance(node, (ast.Import, ast.ImportFrom)):
        for a in node.names:
            yield (a.asname or a.name).split(".")[0]
    elif isinstance(node, ast.Assign):
        for t in node.targets:
            yield from _target_names(t)
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        yield from _target_names(node.target)
    elif isinstance(node, (ast.If, ast.Try)):
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.stmt):
                yield from _bound_names(sub)


def _target_names(t: ast.AST) -> Iterator[str]:
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _target_names(e)


# -- suppressions -------------------------------------------------------------


def collect_suppressions(
    source: str,
) -> Dict[int, Tuple[Optional[Set[str]], str]]:
    """Map line number -> ``(suppressed rule ids, reason)``; a rule set of
    None means every rule is suppressed on that line.

    A ``# heatlint: disable=...`` comment applies to its own line; when
    the comment stands alone it governs the next CODE line, skipping the
    rest of its own comment block (the conventional shape when the
    justification runs long). The free text after ``--`` is the reason.
    """
    out: Dict[int, Tuple[Optional[Set[str]], str]] = {}

    def merge(lineno: int, rules: Optional[Set[str]], reason: str) -> None:
        cur, cur_reason = out.get(lineno, (set(), ""))
        if rules is None or cur is None:
            merged: Optional[Set[str]] = None  # blanket suppression
        else:
            merged = cur | rules
        out[lineno] = (merged, cur_reason or reason)

    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except tokenize.TokenError:
        return out
    lines = source.split("\n")
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        raw_rules = m.group("rules")
        rules = (
            {r.strip().upper() for r in raw_rules.split(",") if r.strip()}
            if raw_rules
            else None
        )
        reason = (m.group("reason") or "").strip()
        row, col = tok.start
        if reason and row < len(lines):
            # a reason may wrap onto following plain comment lines
            nxt = row
            while nxt < len(lines):
                cont = lines[nxt].strip()
                if not cont.startswith("#") or _SUPPRESS_RE.search(cont):
                    break
                reason += " " + cont.lstrip("# ").rstrip()
                nxt += 1
        merge(row, rules, reason)
        line_prefix = tok.line[:col]
        if not line_prefix.strip():
            # standalone comment: the directive governs the next CODE
            # line, skipping the rest of its own comment block and any
            # blank lines before the code
            nxt = row  # tok rows are 1-based; lines[row] is the next line
            while nxt < len(lines):
                s = lines[nxt].strip()
                if s and not s.startswith("#"):
                    break
                nxt += 1
            if nxt < len(lines):
                merge(nxt + 1, rules, reason)
    return out


# -- scanning -----------------------------------------------------------------


def iter_python_files(paths: Sequence[str], root: str) -> Iterator[Tuple[str, str]]:
    """Yield ``(abspath, relpath)`` for every ``.py`` under ``paths``."""
    seen = set()
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        ap = os.path.abspath(ap)
        if os.path.isfile(ap):
            files = [ap]
        elif os.path.isdir(ap):
            files = []
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith(".")
                )
                files.extend(
                    os.path.join(dirpath, f)
                    for f in sorted(filenames)
                    if f.endswith(".py")
                )
        else:
            raise FileNotFoundError(f"heatlint: no such path: {p}")
        for f in files:
            if f in seen:
                continue
            seen.add(f)
            rel = os.path.relpath(f, root).replace(os.sep, "/")
            yield f, rel


@dataclass
class Report:
    """The outcome of one analyzer run (pre- and post-baseline)."""

    findings: List[Finding] = field(default_factory=list)  # new (gate these)
    baselined: List[Finding] = field(default_factory=list)
    suppressed: List[Tuple[Finding, str]] = field(default_factory=list)
    files_scanned: int = 0
    scanned_paths: List[str] = field(default_factory=list)

    def counts(self) -> dict:
        per_rule: Counter = Counter(f.rule for f in self.findings)
        return {
            "files": self.files_scanned,
            "new": len(self.findings),
            "baselined": len(self.baselined),
            "suppressed": len(self.suppressed),
            "total": len(self.findings) + len(self.baselined),
            "per_rule": dict(sorted(per_rule.items())),
        }


def scan_source(
    relpath: str,
    source: str,
    rules: Sequence,
) -> Tuple[List[Finding], List[Tuple[Finding, str]]]:
    """Run ``rules`` over one in-memory file. Returns
    ``(findings, suppressed)`` where suppressed entries carry the reason
    string from the disable comment (empty when none was given)."""
    tree = ast.parse(source, filename=relpath)
    ctx = FileContext(relpath, source, tree)
    suppressions = collect_suppressions(source)
    findings: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    for rule in rules:
        if relpath in rule.allowed:
            continue
        for line, col, message in rule.scan(ctx):
            f = Finding(
                rule=rule.id,
                path=relpath,
                line=line,
                col=col,
                message=message,
                code=ctx.line_text(line),
            )
            sup, reason = suppressions.get(line, (set(), ""))
            if sup is None or (sup and rule.id in sup):
                suppressed.append((f, reason))
            else:
                findings.append(f)
    return findings, suppressed


def analyze(
    paths: Sequence[str],
    root: str,
    rules: Optional[Sequence] = None,
    select: Optional[Iterable[str]] = None,
) -> Report:
    """Scan ``paths`` (files or directories, relative to ``root``) with
    every registered rule (or the ``select`` subset)."""
    from . import rules as rules_mod

    active = list(rules if rules is not None else rules_mod.RULES)
    if select:
        wanted = {s.strip().upper() for s in select}
        unknown = wanted - {r.id for r in active}
        if unknown:
            raise ValueError(f"heatlint: unknown rule id(s): {sorted(unknown)}")
        active = [r for r in active if r.id in wanted]
    report = Report()
    for abspath, relpath in iter_python_files(paths, root):
        report.files_scanned += 1
        report.scanned_paths.append(relpath)
        with open(abspath, "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            findings, suppressed = scan_source(relpath, source, active)
        except SyntaxError as e:
            findings, suppressed = [
                Finding(
                    rule="HL000",
                    path=relpath,
                    line=e.lineno or 1,
                    col=e.offset or 0,
                    message=f"file does not parse: {e.msg}",
                    code="",
                )
            ], []
        report.findings.extend(findings)
        report.suppressed.extend(suppressed)
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report


# -- baseline -----------------------------------------------------------------

# repo-relative: the port's own baseline, beside this package (the root
# .heatlint-baseline.json belongs to the JAX package's scan)
BASELINE_NAME = "heat_tpu_torch/analysis/heatlint-baseline.json"


def load_baseline_entries(path: str) -> List[dict]:
    """Baseline file -> its raw finding entries, validated."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or data.get("version") != 1:
        raise ValueError(f"heatlint: unrecognized baseline format in {path}")
    return list(data.get("findings", []))


def load_baseline(path: str) -> Counter:
    """Baseline file -> multiset of ``(rule, path, code)`` fingerprints."""
    out: Counter = Counter()
    for entry in load_baseline_entries(path):
        out[(entry["rule"], entry["path"], entry["code"])] += 1
    return out


def apply_baseline(report: Report, baseline: Counter) -> Report:
    """Split ``report.findings`` into still-new vs grandfathered."""
    budget = Counter(baseline)
    new: List[Finding] = []
    for f in report.findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            report.baselined.append(f)
        else:
            new.append(f)
    report.findings = new
    return report


def write_baseline(
    report: Report, path: str, preserved: Sequence[dict] = (),
) -> None:
    """Persist every current finding (new + already-baselined) as the new
    baseline. Suppressed findings stay suppressed inline — they never
    enter the baseline. ``preserved`` carries prior-baseline entries that
    were OUTSIDE this run's scan scope (unscanned files, unselected
    rules) so a subset re-grandfather cannot drop them."""
    entries = sorted(
        [
            {"rule": f.rule, "path": f.path, "line": f.line, "code": f.code}
            for f in report.findings + report.baselined
        ] + [dict(e) for e in preserved],
        key=lambda e: (e["path"], e["line"], e["rule"]),
    )
    payload = {
        "version": 1,
        "comment": (
            "heatlint grandfathered findings — matched by (rule, path, "
            "source line), so line drift cannot resurrect them. Shrink "
            "this file; never grow it (the gate fails on NEW findings "
            "only). Regenerate: python -m heat_tpu_torch.analysis --write-baseline"
        ),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=False)
        fh.write("\n")

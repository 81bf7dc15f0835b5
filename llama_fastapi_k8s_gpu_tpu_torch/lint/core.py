"""lfkt-lint core: sources, suppressions, the checker registry and runner.

Design constraints:

- stdlib only (``ast`` + ``re``): the lint must run in the tier-1 CPU gate
  with zero new dependencies and without importing torch, jax or the
  package under analysis (everything is derived from parsed source, so a
  broken module still lints).
- suppressions are *audited*: ``# lfkt: noqa[<RULE>] -- reason`` requires a
  reason string (LINT000) and a known rule ID (LINT001).  A noqa on a
  ``def`` line covers the whole function body — the idiom for "this
  function is exempt for a structural reason" — otherwise it covers its
  own line only.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Iterable

#: ``# lfkt: noqa[<RULE1>,<RULE2>] -- reason`` (reason mandatory, see LINT000)
_NOQA_RE = re.compile(
    r"#\s*lfkt:\s*noqa\[([A-Za-z0-9_,\s]*)\]\s*(?:--\s*(\S.*))?")

#: core's own rules — violations of the suppression grammar itself
CORE_RULES = {
    "LINT000": "a `# lfkt: noqa[...]` comment is missing its `-- reason`",
    "LINT001": "a `# lfkt: noqa[...]` comment names an unknown rule ID",
}


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-root-relative (or absolute when outside it)
    line: int
    message: str
    suppressed: bool = False
    reason: str | None = None   # the noqa reason when suppressed

    def render(self) -> str:
        sup = f"  [suppressed: {self.reason}]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{sup}"


class Source:
    """One parsed python file plus its suppression map."""

    def __init__(self, path: str, rel: str):
        self.path = path
        self.rel = rel                       # package-relative posix path
        with open(path, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=path)
        #: line -> (set of rule ids ('' set means malformed), reason | None)
        self.noqa: dict[int, tuple[set[str], str | None]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _NOQA_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.noqa[i] = (rules, m.group(2))
        #: line ranges of function defs carrying a def-line noqa:
        #: (first body line, last line) -> noqa entry.  "def line" means
        #: any line of the (possibly multi-line) signature.
        self._def_spans: list[tuple[int, int, set[str], str | None]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                body_start = node.body[0].lineno if node.body else node.lineno
                for line in range(node.lineno, body_start + 1):
                    entry = self.noqa.get(line)
                    if entry is not None and node.end_lineno is not None:
                        self._def_spans.append(
                            (node.lineno, node.end_lineno,
                             entry[0], entry[1]))
                        break

    def suppression(self, line: int, rule: str) -> str | None:
        """The noqa reason covering (line, rule), or None.  A def-line
        noqa covers the whole function body for its rules."""
        entry = self.noqa.get(line)
        if entry is not None and rule in entry[0]:
            return entry[1] or ""
        for lo, hi, rules, reason in self._def_spans:
            if lo <= line <= hi and rule in rules:
                return reason or ""
        return None


class Context:
    """Everything a checker may look at.

    ``sources`` are the package's own files (findings are reported here);
    ``ref_sources`` are reference-only roots (the package's consumers:
    tests, tools, entry scripts) consulted for cross-references
    (dead-code).
    ``repo_root`` may be None when the package is analyzed outside a repo
    checkout — repo-level cross-checks (helm, docs) then skip themselves.
    """

    def __init__(self, package_dir: str, repo_root: str | None,
                 ref_roots: Iterable[str] = ()):
        self.package_dir = os.path.abspath(package_dir)
        self.package_name = os.path.basename(self.package_dir)
        self.repo_root = os.path.abspath(repo_root) if repo_root else None
        self.sources: list[Source] = []
        self.ref_sources: list[Source] = []
        for path in _py_files(self.package_dir):
            rel = os.path.relpath(path, self.package_dir).replace(os.sep, "/")
            self.sources.append(Source(path, rel))
        for path in ref_roots:
            rel = os.path.relpath(path, self.repo_root or os.path.dirname(path))
            self.ref_sources.append(Source(path, rel.replace(os.sep, "/")))

    def display_path(self, src: Source) -> str:
        if self.repo_root:
            try:
                return os.path.relpath(src.path, self.repo_root)
            except ValueError:
                pass
        return src.path

    def module_name(self, src: Source) -> str:
        """Dotted module path of a package source, e.g. 'engine.engine'."""
        mod = src.rel[:-3] if src.rel.endswith(".py") else src.rel
        mod = mod.replace("/", ".")
        if mod == "__init__":
            return ""
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        return mod


#: this package's consumers, repo-relative globs: only what uses the port
#: counts (the JAX package's tests would hide a dead port function behind
#: a same-named reference one)
PORT_CONSUMERS = ("tests/test_torch_*.py", "tools/port_*.py",
                  "tools/pod_ready.py", "tools/timed_lines.py",
                  "chip_smoke.py")
#: any other package's consumers (fixture packages, the reference): its
#: repo's whole test and tool trees and entry scripts
OTHER_CONSUMERS = ("tests/**/*.py", "tools/**/*.py", "bench.py",
                   "bench_server.py", "__graft_entry__.py")


def consumers(package_dir: str, repo_root: str) -> list[str]:
    """The consumer files of ``package_dir`` in ``repo_root``:
    :data:`PORT_CONSUMERS` for this package, :data:`OTHER_CONSUMERS` for
    any other."""
    import glob

    this = __name__.split(".")[0]
    pats = PORT_CONSUMERS if os.path.basename(os.path.abspath(package_dir)) == this \
        else OTHER_CONSUMERS
    out: set[str] = set()
    for pat in pats:
        for p in glob.glob(os.path.join(repo_root, pat), recursive=True):
            if os.path.isfile(p) and "__pycache__" not in p:
                out.add(os.path.abspath(p))
    return sorted(out)


def _sha256(text: str) -> str:
    import hashlib

    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def _py_files(root: str) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git", "_build")]
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


# ---------------------------------------------------------------------------
# checker registry
# ---------------------------------------------------------------------------

def _checkers() -> list[tuple[dict, Callable[[Context], list[Finding]]]]:
    # imported lazily so a syntax error in one checker names itself cleanly
    from . import (concurrency, configreg, deadcode, graph, kernels, locks,
                   obsreg, perf, pin, resources, taint, wire)

    # taint rides concurrency's --changed cache doc (it augments
    # inc["out"] with its own per-file summaries), so it must run after
    return [(mod.RULES, mod.check)
            for mod in (locks, concurrency, taint, graph, configreg, obsreg,
                        wire, kernels, perf, resources, pin, deadcode)]


def all_rules() -> dict[str, str]:
    """rule id -> one-line description, across every checker."""
    rules = dict(CORE_RULES)
    for mod_rules, _ in _checkers():
        rules.update(mod_rules)
    return rules


def _core_findings(ctx: Context, known: set[str]) -> list[Finding]:
    """LINT000/LINT001: audit the suppression comments themselves."""
    out = []
    for src in ctx.sources:
        path = ctx.display_path(src)
        for line, (rules, reason) in sorted(src.noqa.items()):
            if not reason:
                out.append(Finding(
                    "LINT000", path, line,
                    "suppression without a reason: write "
                    "`# lfkt: noqa[<RULE>] -- why`"))
            if not rules:
                out.append(Finding(
                    "LINT001", path, line, "suppression names no rule ID"))
            for r in rules:
                if r not in known:
                    out.append(Finding(
                        "LINT001", path, line,
                        f"unknown rule ID {r!r} in suppression"))
    return out


def run_lint(package_dir: str | None = None, repo_root: str | None = None,
             rules: Iterable[str] | None = None,
             incremental: dict | None = None) -> list[Finding]:
    """Run every checker; returns ALL findings with ``suppressed`` applied
    (callers filter).  Defaults analyze this installed package and, when it
    lives in a repo checkout, the repo's consumers of it (:func:`consumers`)
    and its helm-gpu/, README and docs.

    ``incremental`` is the ``--changed`` plumbing (lint/__main__.py): a
    mutable dict with the loaded summary ``cache`` and current content
    ``shas``; lint/concurrency.py reuses cached per-file summaries whose
    sha still matches and writes the refreshed cache doc back under
    ``incremental["out"]``."""
    if package_dir is None:
        package_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo_root is None:
        cand = os.path.dirname(os.path.abspath(package_dir))
        # a checkout is recognized by its test tree; site-packages is not
        if os.path.isdir(os.path.join(cand, "tests")):
            repo_root = cand
    ref_roots = consumers(package_dir, repo_root) if repo_root else []
    ctx = Context(package_dir, repo_root, ref_roots)
    if incremental is not None:
        incremental.setdefault(
            "shas", {src.rel: _sha256(src.text) for src in ctx.sources})
        ctx.lint_incremental = incremental

    wanted = set(rules) if rules is not None else None
    known = set(all_rules())
    findings = _core_findings(ctx, known)
    for mod_rules, check in _checkers():
        if wanted is not None and not (set(mod_rules) & wanted):
            continue
        findings.extend(check(ctx))
    if wanted is not None:
        findings = [f for f in findings if f.rule in wanted]

    # apply suppressions (path -> Source lookup by display path)
    by_path = {ctx.display_path(s): s for s in ctx.sources}
    for f in findings:
        src = by_path.get(f.path)
        if src is None or f.rule in ("LINT000", "LINT001"):
            continue   # the suppression audit rules cannot be suppressed
        reason = src.suppression(f.line, f.rule)
        if reason is not None:
            f.suppressed = True
            f.reason = reason
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------------------
# shared AST helpers (used by several checkers)
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def self_attr(node: ast.AST) -> str | None:
    """'X' when node is ``self.X`` (possibly through subscripts:
    ``self.X[k]`` / ``self.X[k][j]``), else None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_seq(node: ast.AST) -> list[str] | None:
    """['a', 'b'] for a literal tuple/list/set of strings, else None."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for elt in node.elts:
            s = const_str(elt)
            if s is None:
                return None
            out.append(s)
        return out
    return None

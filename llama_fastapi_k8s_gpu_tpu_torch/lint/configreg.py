"""CFG001-005: the LFKT_* env-knob registry is the single source of truth.

The port's serving stack is parameterized by ``LFKT_*`` env vars.  A knob
could exist in code but not in the GPU Helm chart, in the docs but not in
code, or be typo'd in a values file and silently ignored.  The contract:

- every knob is declared once in ``utils/config.py``: a field ``<f>`` of
  the ``Settings`` dataclass is knob ``LFKT_<F>`` (what
  ``get_settings()`` reads), and every other knob is a :class:`Knob`
  entry of its ``KNOBS`` table (name, cast, default, help,
  serving-relevance);
- package code reads knobs ONLY through that module's accessors
  (``get_settings``/``knob``/``env_bool``) — never ``os.environ`` raw;
- every registered knob is documented (the README, whose port sections
  cover the port's own knobs, or any page under docs/);
- every LFKT_* name mentioned in the GPU Helm chart (``helm-gpu/``) exists
  in the registry, and every serving-relevant knob is plumbed (or
  documented) there;
- every k8s probe path in ``helm-gpu/templates`` is a real registered
  route in server/app.py.

Rules:

- CFG001 — raw ``os.environ``/``os.getenv`` read of an ``LFKT_*`` name
  outside utils/config.py.
- CFG002 — registered knob missing from the docs (README.md + docs/).
- CFG003 — helm-gpu ↔ registry mismatch: an LFKT_* name in helm-gpu/ that
  is not registered, or a ``serving=True`` knob absent from helm-gpu/.
- CFG004 — a probe path in helm-gpu/templates is not a registered route in
  server/app.py.
- CFG005 — ``knob()``/``env_bool()``/``_env_variant()`` called with an
  unregistered literal name (the static twin of the accessors' runtime
  KeyError).

Repo-level cross-checks (CFG002-004) skip themselves when the package is
analyzed outside a checkout (no helm-gpu/, README or docs/ present).
The chart read is :data:`HELM_DIR`; the JAX package's lint reads the TPU
chart, ``helm/``, instead.
"""

from __future__ import annotations

import ast
import os
import re

from .core import Context, Finding, const_str, dotted

RULES = {
    "CFG001": "raw os.environ read of an LFKT_* name outside utils/config.py",
    "CFG002": "registered knob not documented in README/docs",
    "CFG003": "helm-gpu chart references an unregistered LFKT_* name (or "
              "a serving knob is absent from helm-gpu)",
    "CFG004": "helm-gpu probe path is not a registered route in "
              "server/app.py",
    "CFG005": "registered-accessor call with an unregistered knob name",
}

CONFIG_REL = "utils/config.py"
#: the port's chart, repo-relative
HELM_DIR = "helm-gpu"
_LFKT_RE = re.compile(r"LFKT_[A-Z0-9_]+")
_ACCESSORS = ("knob", "env_bool", "_env_variant", "_env")

#: bench/test-harness-only knob prefixes: read exclusively by the repo's
#: out-of-package entrypoints (bench.py, bench_server.py, tools/), so they
#: are deliberately NOT in the serving registry; docs and helm comments
#: may still mention them (the test-only knobs allowlist)
TEST_ONLY_PREFIXES = ("LFKT_BENCH_", "LFKT_COLDSTART_")


def _registry(ctx: Context) -> tuple[dict[str, dict], bool]:
    """(name -> {"serving": bool}, found): parsed statically from
    utils/config.py — the ``Settings`` dataclass fields (``LFKT_<FIELD>``)
    and the ``Knob(...)`` literals."""
    knobs: dict[str, dict] = {}
    for src in ctx.sources:
        if src.rel != CONFIG_REL:
            continue
        for node in src.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == "Settings":
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and isinstance(stmt.target, ast.Name):
                        knobs[f"LFKT_{stmt.target.id.upper()}"] = {
                            "serving": False}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                f = dotted(node.func)
                if f and f.split(".")[-1] == "Knob" and node.args:
                    name = const_str(node.args[0])
                    if name:
                        serving = any(
                            kw.arg == "serving"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True
                            for kw in node.keywords)
                        knobs[name] = {"serving": serving}
        return knobs, True
    return knobs, False


def _env_read_name(node: ast.Call) -> str | None:
    """The literal env-var name of an os.environ.get()/os.getenv() call."""
    d = dotted(node.func)
    if d in ("os.environ.get", "os.getenv") and node.args:
        return const_str(node.args[0])
    return None


def _read_text(path: str) -> str:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


def _tree_text(root: str, exts: tuple) -> dict[str, str]:
    out = {}
    if not os.path.isdir(root):
        return out
    for dirpath, _, filenames in os.walk(root):
        for f in sorted(filenames):
            if f.endswith(exts):
                p = os.path.join(dirpath, f)
                out[p] = _read_text(p)
    return out


def check(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    knobs, have_registry = _registry(ctx)

    # -- CFG001 + CFG005: in-package read discipline ------------------------
    for src in ctx.sources:
        if src.rel == CONFIG_REL:
            continue
        path = ctx.display_path(src)
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                name = _env_read_name(node)
                if name and name.startswith("LFKT_"):
                    out.append(Finding(
                        "CFG001", path, node.lineno,
                        f"raw env read of {name!r}: route it through "
                        "utils/config.py (get_settings/knob/env_bool)"))
                f = dotted(node.func)
                if f and f.split(".")[-1] in _ACCESSORS and node.args:
                    arg = const_str(node.args[0])
                    if arg and arg.startswith("LFKT_") and arg not in knobs:
                        out.append(Finding(
                            "CFG005", path, node.lineno,
                            f"{f.split('.')[-1]}({arg!r}) reads a knob "
                            "missing from the utils/config.py registry"))
            elif isinstance(node, ast.Subscript) \
                    and dotted(node.value) == "os.environ":
                name = const_str(node.slice)
                if name and name.startswith("LFKT_"):
                    out.append(Finding(
                        "CFG001", path, node.lineno,
                        f"raw env read of {name!r}: route it through "
                        "utils/config.py (get_settings/knob/env_bool)"))

    # -- repo-level cross-checks -------------------------------------------
    if not (have_registry and ctx.repo_root):
        return out
    cfg_src = next(s for s in ctx.sources if s.rel == CONFIG_REL)
    cfg_path = ctx.display_path(cfg_src)

    # CFG002: knob -> docs coverage
    docs_text = _read_text(os.path.join(ctx.repo_root, "README.md"))
    for _, text in sorted(
            _tree_text(os.path.join(ctx.repo_root, "docs"), (".md",)).items()):
        docs_text += text
    if docs_text:
        documented = set(_LFKT_RE.findall(docs_text))
        for name in sorted(knobs):
            if name not in documented:
                out.append(Finding(
                    "CFG002", cfg_path, 1,
                    f"registered knob {name} is documented nowhere under "
                    "README.md/docs/ (document it in the README's port "
                    "section)"))

    # CFG003 + CFG004: helm-gpu cross-checks
    helm_files = _tree_text(os.path.join(ctx.repo_root, HELM_DIR),
                            (".yaml", ".yml", ".tpl"))
    if helm_files:
        helm_text = "".join(helm_files.values())
        helm_names = set(_LFKT_RE.findall(helm_text))
        unknown = {n for n in helm_names - set(knobs)
                   if not n.startswith(TEST_ONLY_PREFIXES)}
        for name in sorted(unknown):
            # attribute to the first helm file mentioning it
            fpath, line = cfg_path, 1
            for p, text in sorted(helm_files.items()):
                for i, ln in enumerate(text.splitlines(), start=1):
                    if name in ln:
                        fpath = os.path.relpath(p, ctx.repo_root)
                        line = i
                        break
                if line != 1 or fpath != cfg_path:
                    break
            out.append(Finding(
                "CFG003", fpath, line,
                f"helm references {name}, which is not in the "
                "utils/config.py registry (typo'd knobs are silently "
                "ignored by the app)"))
        for name in sorted(k for k, meta in knobs.items()
                           if meta["serving"] and k not in helm_names):
            out.append(Finding(
                "CFG003", cfg_path, 1,
                f"serving-relevant knob {name} is not plumbed or "
                f"documented anywhere in {HELM_DIR}/"))

        # CFG004: probe paths must be registered app routes
        routes: set[str] = set()
        for src in ctx.sources:
            if not src.rel.endswith("server/app.py"):
                continue
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        if isinstance(dec, ast.Call) and dec.args:
                            f = dotted(dec.func)
                            if f and f.split(".")[-1] in (
                                    "get", "post", "put", "delete", "route"):
                                r = const_str(dec.args[0])
                                if r:
                                    routes.add(r)
        probe_re = re.compile(r"^\s*path:\s*(/[^\s{]+)\s*$", re.M)
        for p, text in sorted(helm_files.items()):
            for m in probe_re.finditer(text):
                probe = m.group(1)
                if routes and probe not in routes:
                    line = text[: m.start()].count("\n") + 1
                    out.append(Finding(
                        "CFG004", os.path.relpath(p, ctx.repo_root), line,
                        f"helm probe path {probe} is not a registered "
                        "route in server/app.py"))
    return out

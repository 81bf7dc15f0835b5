"""OBS001-003: the metric catalog is the single source of truth.

The /metrics surface has dozens of families; without this checker a
typo'd metric name (``m.inc("request_rejected_total")``) would silently
mint a new, never-alerted series — or, with the strict runtime registry,
crash the first request that hit the site.  The contract (the CFG knob
registry's pattern, applied to metrics):

- every metric is declared once, as a :class:`Metric` entry in
  ``obs/catalog.py`` (name, type, help, buckets, labels, prefix
  families);
- every *literal* metric name passed to a ``Metrics`` recording call
  (``inc``/``observe``/``set_gauge``) resolves against that catalog —
  exactly, or via a declared ``prefix=True`` family (OBS001; f-string
  names are covered by the runtime ``KeyError`` in utils/metrics.py);
- the catalog is the source for the generated metrics table in the docs:
  every cataloged metric is documented somewhere under README.md/docs/
  (OBS002; tests/test_obs.py additionally pins the docs table to the
  generator's output byte-for-byte).

Repo-level docs coverage (OBS002) skips itself outside a checkout.
"""

from __future__ import annotations

import ast
import os

from .core import Context, Finding, const_str, dotted

RULES = {
    "OBS001": "metric name recorded via inc/observe/set_gauge is missing "
              "from the obs/catalog.py metric catalog",
    "OBS002": "cataloged metric is documented nowhere under README/docs",
    "OBS003": "memory-ledger register_component name is missing from the "
              "obs/catalog.py MEM_COMPONENTS catalog",
}

CATALOG_REL = "obs/catalog.py"
_RECORDERS = ("inc", "observe", "set_gauge")
_LEDGER_REGISTRAR = "register_component"


def _catalog(ctx: Context) -> tuple[dict[str, dict], bool]:
    """(name -> {"prefix": bool}, found): parsed statically from the
    ``Metric(...)`` literals in obs/catalog.py."""
    metrics: dict[str, dict] = {}
    for src in ctx.sources:
        if src.rel != CATALOG_REL:
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                f = dotted(node.func)
                if f and f.split(".")[-1] == "Metric" and node.args:
                    name = const_str(node.args[0])
                    if name:
                        prefix = any(
                            kw.arg == "prefix"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True
                            for kw in node.keywords)
                        metrics[name] = {"prefix": prefix}
        return metrics, True
    return metrics, False


def _components(ctx: Context) -> tuple[set, bool]:
    """(component names, found): parsed statically from the
    ``MemComponent(...)`` literals in obs/catalog.py — the OBS003 twin of
    :func:`_catalog` (memory ledger, obs/memledger.py)."""
    names: set = set()
    for src in ctx.sources:
        if src.rel != CATALOG_REL:
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                f = dotted(node.func)
                if f and f.split(".")[-1] == "MemComponent" and node.args:
                    name = const_str(node.args[0])
                    if name:
                        names.add(name)
        return names, True
    return names, False


def _covered(name: str, metrics: dict[str, dict]) -> bool:
    if name in metrics:
        return True
    return any(meta["prefix"] and name.startswith(prefix)
               for prefix, meta in metrics.items())


def _read_text(path: str) -> str:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


def check(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    metrics, have_catalog = _catalog(ctx)
    if not have_catalog:
        return out

    # -- OBS001: literal recorder calls resolve against the catalog --------
    for src in ctx.sources:
        if src.rel == CATALOG_REL:
            continue
        path = ctx.display_path(src)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = dotted(node.func)
            if f is None or f.split(".")[-1] not in _RECORDERS:
                continue
            # only Metrics-shaped receivers: a bare inc()/observe() name or
            # a counter-ish helper on another class must not be dragged in
            recv = f.rsplit(".", 1)[0] if "." in f else ""
            if not recv:
                continue
            name = const_str(node.args[0])
            if name is None:                # dynamic name: runtime KeyError
                continue
            if not _covered(name, metrics):
                out.append(Finding(
                    "OBS001", path, node.lineno,
                    f"metric {name!r} is not in the obs/catalog.py metric "
                    "catalog; register it (typo'd names mint silent "
                    "series)"))

    # -- OBS003: ledger registrations resolve against MEM_COMPONENTS -------
    components, have_components = _components(ctx)
    if have_components:
        for src in ctx.sources:
            if src.rel == CATALOG_REL:
                continue
            path = ctx.display_path(src)
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                f = dotted(node.func)
                if f is None or f.split(".")[-1] != _LEDGER_REGISTRAR:
                    continue
                name = const_str(node.args[0])
                if name is None:        # dynamic name: runtime KeyError
                    continue
                if name not in components:
                    out.append(Finding(
                        "OBS003", path, node.lineno,
                        f"memory component {name!r} is not in the "
                        "obs/catalog.py MEM_COMPONENTS catalog; register "
                        "it (unknown components KeyError at runtime)"))

    # -- OBS002: catalog -> docs coverage ----------------------------------
    if not ctx.repo_root:
        return out
    cat_src = next(s for s in ctx.sources if s.rel == CATALOG_REL)
    cat_path = ctx.display_path(cat_src)
    docs_text = _read_text(os.path.join(ctx.repo_root, "README.md"))
    docs_dir = os.path.join(ctx.repo_root, "docs")
    if os.path.isdir(docs_dir):
        for dirpath, _, filenames in os.walk(docs_dir):
            for fn in sorted(filenames):
                if fn.endswith(".md"):
                    docs_text += _read_text(os.path.join(dirpath, fn))
    if not docs_text:
        return out
    for name in sorted(metrics):
        if name not in docs_text:
            out.append(Finding(
                "OBS002", cat_path, 1,
                f"cataloged metric {name} is documented nowhere under "
                "README.md/docs/ (document it in the README's port "
                "section)"))
    return out

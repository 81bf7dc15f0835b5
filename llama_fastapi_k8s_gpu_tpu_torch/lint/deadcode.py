"""DEAD001-002: module-level functions and exports nobody references.

Dead code in a serving repo is not free: it keeps compiling, keeps
importing, shows up in grep results as if load-bearing, and silently
drifts out of date with the invariants the live code maintains.  This
checker indexes every ``Name``/``Attribute`` reference across the package
AND its consumers (core.py :func:`~.core.consumers`: for the port, only
what uses it — ``tests/test_torch_*.py``, ``tools/port_*.py``,
``tools/pod_ready.py``, ``tools/timed_lines.py`` and ``chip_smoke.py``;
the JAX package's tests would hide a dead port function behind a
same-named reference one) and flags:

- DEAD001 — a module-level function (public or private) with no reference
  anywhere beyond its own definition.  Import statements and ``__all__``
  strings do NOT count as uses — re-exporting a function nobody calls is
  still dead.  Decorated functions are exempt (decorators register them:
  route handlers, ``torch.inference_mode`` entry points, ...), as are
  ``main`` and dunder names.
- DEAD002 — an ``__all__`` entry naming something the module never
  defines or imports (an export lie: ``from m import *`` raises).

Functions used only via ``getattr``/strings need a
``# lfkt: noqa[DEAD001] -- reason`` on their def line.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, Source, str_seq

RULES = {
    "DEAD001": "module-level function never referenced in the package or "
               "its consumers (tests, tools, entry scripts)",
    "DEAD002": "__all__ entry that the module never defines or imports",
}

_EXEMPT = {"main"}   # script entrypoints; checker check() functions are
#                      kept alive by core.py's `mod.check` references


def _module_defs(src: Source):
    """(module-level FunctionDefs, names defined/imported at module level,
    __all__ entries with their node)."""
    fns: list[ast.FunctionDef] = []
    defined: set[str] = set()
    all_entries: list[tuple[str, ast.AST]] = []
    for stmt in src.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns.append(stmt)
            defined.add(stmt.name)
        elif isinstance(stmt, ast.ClassDef):
            defined.add(stmt.name)
        elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
            for alias in stmt.names:
                defined.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    defined.add(t.id)
                    if t.id == "__all__":
                        vals = str_seq(stmt.value)
                        if vals is not None:
                            all_entries.extend((v, stmt) for v in vals)
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                            ast.Name):
            defined.add(stmt.target.id)
    return fns, defined, all_entries


def _references(sources) -> dict[str, int]:
    """name -> count of Name/Attribute references (imports and __all__
    strings excluded; a function's own def line excluded by the caller)."""
    refs: dict[str, int] = {}
    for src in sources:
        for node in ast.walk(src.tree):
            # import aliases are not expression nodes, so imports naturally
            # contribute no references — exactly the intended semantics
            if isinstance(node, ast.Name):
                refs[node.id] = refs.get(node.id, 0) + 1
            elif isinstance(node, ast.Attribute):
                refs[node.attr] = refs.get(node.attr, 0) + 1
    return refs


def check(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    everything = list(ctx.sources) + list(ctx.ref_sources)
    refs = _references(everything)

    for src in ctx.sources:
        path = ctx.display_path(src)
        fns, defined, all_entries = _module_defs(src)

        for name, node in all_entries:
            if name not in defined:
                out.append(Finding(
                    "DEAD002", path, node.lineno,
                    f"__all__ exports {name!r}, which this module never "
                    "defines or imports (star-imports would raise)"))

        for fn in fns:
            name = fn.name
            if fn.decorator_list or name in _EXEMPT \
                    or (name.startswith("__") and name.endswith("__")):
                continue
            # own definition contributes 0 Name refs (a def is not a Name
            # node); any genuine call/reference anywhere counts
            if refs.get(name, 0) == 0:
                out.append(Finding(
                    "DEAD001", path, fn.lineno,
                    f"module-level function {name}() is never referenced "
                    "in the package or its consumers (tests, tools, entry "
                    "scripts) — delete it or wire it up"))
    return out

"""PERF001-002: the devtime registry and the SLO catalog stay total.

The port's program registry (obs/devtime.py) has no ``jit``: its compiles
are CUDA-graph captures and its inner programs are the kernel wrappers.
So the reference's PERF001 (every ``jax.jit``/``pallas_call`` entry point
registered) takes this form:

- PERF001 — every graph capture site and every ``ops.KERNELS`` entry is
  registered with the devtime registry, so ``/debug/compiles`` can never
  silently lose a program.  A capture site is a function holding a
  ``with torch.cuda.graph(...)`` block or a ``capture_step(...)`` call.
  It counts as registered when it calls ``record_compile(...)`` or
  ``register_program(...)`` itself, or — for a capture helper such as
  ``capture_step`` — when every function that calls it in the package
  does.  A ``KERNELS`` entry counts as registered when ops/__init__.py
  loops over ``KERNELS`` calling ``register_program`` with the loop's
  name, or names it in a ``register_program(...)`` call.
- PERF002 — every :class:`~..obs.slo.SLO` entry in ``obs/slo.py``
  references a metric family declared in the obs/catalog.py catalog
  (exactly, or via a ``prefix=True`` family): an SLO over a phantom
  family would evaluate forever-green burn rates against series that can
  never exist.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, const_str, dotted
from .graph import capture_blocks, capture_calls
from .obsreg import _catalog, _covered

RULES = {
    "PERF001": "CUDA-graph capture site or ops.KERNELS entry not registered "
               "with the devtime registry (obs/devtime.py)",
    "PERF002": "SLO references a metric family missing from the "
               "obs/catalog.py catalog",
}

SLO_REL = "obs/slo.py"
OPS_INIT_REL = "ops/__init__.py"
_REG_FNS = ("record_compile", "register_program")


def _calls_registry(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d and d.split(".")[-1] in _REG_FNS:
                return True
    return False


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _innermost(tree: ast.AST, node: ast.AST):
    best = None
    for fn in _functions(tree):
        if fn.lineno <= node.lineno <= (fn.end_lineno or fn.lineno):
            if best is None or fn.lineno >= best.lineno:
                best = fn
    return best


def _check_captures(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    sites = []            # (src, fn, line)
    for src in ctx.sources:
        for node in list(capture_blocks(src.tree)) + list(capture_calls(src.tree)):
            fn = _innermost(src.tree, node)
            if fn is not None:
                sites.append((src, fn, node.lineno))
    names = {fn.name for _, fn, _ in sites}
    callers: dict[str, list] = {}      # site name -> enclosing defs of its calls
    for src in ctx.sources:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d and d.split(".")[-1] in names:
                    callers.setdefault(d.split(".")[-1], []).append(
                        _innermost(src.tree, node))
    seen = set()
    for src, fn, line in sites:
        if (src.rel, fn.name) in seen:
            continue
        seen.add((src.rel, fn.name))
        if _calls_registry(fn):
            continue
        outer = callers.get(fn.name, [])
        if outer and all(c is not None and _calls_registry(c) for c in outer):
            continue
        out.append(Finding(
            "PERF001", ctx.display_path(src), line,
            f"graph capture in {fn.name} is not registered with the devtime "
            "registry: record_compile(...) the capture (or have every "
            "caller of this capture helper do so) so /debug/compiles "
            "cannot lose it (obs/devtime.py)"))
    return out


def _check_kernels(ctx: Context) -> list[Finding]:
    src = next((s for s in ctx.sources if s.rel == OPS_INIT_REL), None)
    if src is None:
        return []
    kernels = None
    for stmt in src.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == "KERNELS" \
                and isinstance(stmt.value, ast.Dict):
            kernels = stmt
    if kernels is None:
        return []
    registered: set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.For) and "KERNELS" in {
                n.id for n in ast.walk(node.iter) if isinstance(n, ast.Name)}:
            loop_names = {n.id for n in ast.walk(node.target)
                          if isinstance(n, ast.Name)}
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and (dotted(sub.func) or "") \
                        .split(".")[-1] == "register_program" and sub.args \
                        and isinstance(sub.args[0], ast.Name) \
                        and sub.args[0].id in loop_names:
                    registered.add("*")
        elif isinstance(node, ast.Call) and (dotted(node.func) or "") \
                .split(".")[-1] == "register_program" and node.args:
            name = const_str(node.args[0])
            if name:
                registered.add(name)
    out: list[Finding] = []
    for k in kernels.value.keys:
        name = const_str(k) if k is not None else None
        if name is None or "*" in registered or name in registered:
            continue
        out.append(Finding(
            "PERF001", ctx.display_path(src), k.lineno,
            f"kernel {name!r} of ops.KERNELS is not registered with the "
            "devtime registry (register_program), so its launches are "
            "missing from /debug/compiles"))
    return out


def check(ctx: Context) -> list[Finding]:
    out: list[Finding] = []

    # -- PERF001: every capture site and kernel is devtime-registered ------
    out.extend(_check_captures(ctx))
    out.extend(_check_kernels(ctx))

    # -- PERF002: SLO -> catalog coverage ----------------------------------
    metrics, have_catalog = _catalog(ctx)
    if not have_catalog:
        return out
    for src in ctx.sources:
        if src.rel != SLO_REL:
            continue
        path = ctx.display_path(src)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            f = dotted(node.func)
            if f is None or f.split(".")[-1] != "SLO":
                continue
            metric = None
            for kw in node.keywords:
                if kw.arg == "metric":
                    metric = const_str(kw.value)
            if metric is None and len(node.args) > 1:
                metric = const_str(node.args[1])
            if metric is None:
                continue                    # dynamic: runtime lookup guards
            if not _covered(metric, metrics):
                out.append(Finding(
                    "PERF002", path, node.lineno,
                    f"SLO references metric {metric!r}, which is not in "
                    "the obs/catalog.py catalog — its burn rate would "
                    "evaluate forever-green against series that cannot "
                    "exist"))
    return out

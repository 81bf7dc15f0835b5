"""GRAPH001-003: purity of everything a captured CUDA graph runs.

The port replaces the reference's ``jax.jit`` traces (lint/jit.py in the
JAX package, JIT001-003) with captured CUDA graphs: the decode and verify
steps are captured once (``models/generate.py`` ``capture_step``) and
replayed.  A capture records device work only.  A Python side effect in
the captured callable runs once, at capture, and its value is baked into
every replay (an env or knob read, a clock read, a host RNG draw); a
mutation of closed-over state runs once instead of per step; and a host
sync (``.item()``, ``.cpu()``, ``.synchronize()``) either fails the
capture outright or, in the eager warm-up step that ``capture_step`` runs
first with the same callable, stalls it.  None of these fail loudly in a
test that only checks outputs.

The roots are the callables handed to ``capture_step`` (a lambda's body
is scanned and its references resolved, a function or bound method is
resolved) and the bodies of ``with torch.cuda.graph(...)`` blocks; the
warm-up step is the same callable, so it counts as captured code.  From
the roots, every resolvable function reference is followed (the index
below: simple names, ``self.method``, package imports; functions passed
as arguments count).  Resolution by name over-approximates — a false edge
costs a suppression with a written reason, a missing edge costs silence.

Within the reachable set it flags:

- GRAPH001 — impure calls: ``time.*``, ``os.environ`` / ``os.getenv`` and
  the knob accessors of utils/config.py, ``random.*`` / ``np.random.*``,
  ``print``.
- GRAPH002 — closed-over or global Python state mutated: ``global`` /
  ``nonlocal`` declarations.
- GRAPH003 — host syncs: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``torch.cuda.synchronize`` and any ``.synchronize()``
  (``Event``, ``Stream``).

The function index (``_Fn``, ``_Index``) is the shared resolver the
interprocedural call graph (lint/callgraph.py) builds on.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, Source, dotted

RULES = {
    "GRAPH001": "impure call (time/os.environ/knob/random/print) inside "
                "code a CUDA graph captures",
    "GRAPH002": "closed-over Python state mutated (global/nonlocal) inside "
                "code a CUDA graph captures",
    "GRAPH003": "host synchronization (.item()/.cpu()/.tolist()/.numpy()/"
                ".synchronize()) inside code a CUDA graph captures",
}

#: the capture helper whose first argument is the captured callable
CAPTURE_TAILS = ("capture_step",)
#: the knob accessors of utils/config.py (lint/configreg.py's set)
_KNOB_READS = ("knob", "env_bool", "_env_variant", "_env", "get_settings")
#: host-sync method tails (attribute calls)
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy", "synchronize")


class _Fn:
    __slots__ = ("key", "src", "node", "module", "cls", "nested_in")

    def __init__(self, key, src, node, module, cls, nested_in):
        self.key = key              # (module, qualname)
        self.src = src
        self.node = node
        self.module = module
        self.cls = cls              # enclosing class name or None
        self.nested_in = nested_in  # enclosing function key or None


class _Index:
    """All functions + package-internal import aliases, per module."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.fns: dict[tuple, _Fn] = {}
        #: module -> simple name -> [keys]
        self.by_name: dict[str, dict[str, list[tuple]]] = {}
        #: module -> class -> method name -> key
        self.methods: dict[str, dict[str, dict[str, tuple]]] = {}
        #: module -> alias -> [("mod", module) | ("name", module, name)]
        #: (multi-valued: the same local alias may bind different targets
        #: in different function scopes — ``from .pallas import X as m``)
        self.imports: dict[str, dict[str, list[tuple]]] = {}
        #: children keyed by enclosing function
        self.nested: dict[tuple, list[tuple]] = {}
        self.modules = {ctx.module_name(s) for s in ctx.sources}
        for src in ctx.sources:
            self._scan(src)

    def _resolve_from(self, node: ast.ImportFrom, module: str,
                      is_pkg: bool) -> str | None:
        """Package-relative dotted path of an import's source module,
        '' for the package root, None for out-of-package imports."""
        if node.level == 0:
            pkg = self.ctx.package_name
            m = node.module or ""
            if m == pkg:
                return ""
            if m.startswith(pkg + "."):
                return m[len(pkg) + 1:]
            return None
        parts = [p for p in module.split(".") if p]
        pkg_parts = parts if is_pkg else parts[:-1]
        up = node.level - 1
        if up > len(pkg_parts):
            return None
        base = pkg_parts[: len(pkg_parts) - up]
        tail = [p for p in (node.module or "").split(".") if p]
        return ".".join(base + tail)

    def _scan(self, src: Source):
        module = self.ctx.module_name(src)
        is_pkg = src.rel.endswith("__init__.py")
        names = self.by_name.setdefault(module, {})
        methods = self.methods.setdefault(module, {})
        imports = self.imports.setdefault(module, {})

        def walk(node, cls, nested_in):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if nested_in:
                        qual = f"{nested_in[1]}.<locals>.{child.name}"
                    elif cls:
                        qual = f"{cls}.{child.name}"
                    else:
                        qual = child.name
                    key = (module, qual)
                    fn = _Fn(key, src, child, module, cls, nested_in)
                    self.fns[key] = fn
                    names.setdefault(child.name, []).append(key)
                    if nested_in:
                        self.nested.setdefault(nested_in, []).append(key)
                    if cls and not nested_in:
                        methods.setdefault(cls, {})[child.name] = key
                    walk(child, None, key)
                elif isinstance(child, ast.ClassDef):
                    walk(child, child.name, nested_in)
                else:
                    if isinstance(child, ast.ImportFrom):
                        target = self._resolve_from(child, module, is_pkg)
                        if target is not None:
                            for alias in child.names:
                                local = alias.asname or alias.name
                                sub = ".".join(
                                    p for p in (target, alias.name) if p)
                                if sub in self.modules:
                                    imports.setdefault(local, []).append(
                                        ("mod", sub))
                                elif target in self.modules:
                                    imports.setdefault(local, []).append(
                                        ("name", target, alias.name))
                    walk(child, cls, nested_in)

        walk(src.tree, None, None)

    def resolve(self, module: str, node: ast.AST,
                scope: "_Fn | None") -> list[tuple]:
        """Function keys a Name/Attribute expression may refer to."""
        names = self.by_name.get(module, {})
        imports = self.imports.get(module, {})
        if isinstance(node, ast.Name):
            cands = names.get(node.id, [])
            if scope is not None:
                local = [k for k in cands
                         if self.fns[k].nested_in == scope.key]
                if local:
                    return local
                if scope.cls:
                    m = self.methods.get(module, {}).get(scope.cls, {})
                    if node.id in m:
                        return [m[node.id]]
            if cands:
                return cands
            out = []
            for imp in imports.get(node.id, []):
                if imp[0] == "name":
                    out.extend(self.by_name.get(imp[1], {}).get(imp[2], []))
            return out
        elif isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            base, attr = node.value.id, node.attr
            if base == "self" and scope is not None and scope.cls is not None:
                k = self.methods.get(module, {}).get(scope.cls, {}).get(attr)
                if k is not None:
                    return [k]
            out = []
            for imp in imports.get(base, []):
                if imp[0] == "mod":
                    out.extend(self.by_name.get(imp[1], {}).get(attr, []))
            return out
        return []


def is_graph_capture(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(...)`` (any alias ending ``cuda.graph``)."""
    ctx = item.context_expr
    if not isinstance(ctx, ast.Call):
        return False
    d = dotted(ctx.func)
    return bool(d) and (d == "graph" or d.endswith("cuda.graph"))


def capture_blocks(tree: ast.AST):
    """Yield every ``with torch.cuda.graph(...)`` statement in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) \
                and any(is_graph_capture(i) for i in node.items):
            yield node


def capture_calls(tree: ast.AST):
    """Yield every ``capture_step(...)`` call in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            d = dotted(node.func)
            if d and d.split(".")[-1] in CAPTURE_TAILS:
                yield node


def _enclosing(index: _Index, src: Source, node: ast.AST) -> "_Fn | None":
    """The innermost indexed function whose body holds ``node``."""
    best = None
    for fn in index.fns.values():
        if fn.src is not src:
            continue
        f = fn.node
        if f.lineno <= node.lineno <= (f.end_lineno or f.lineno):
            if best is None or f.lineno >= best.node.lineno:
                best = fn
    return best


def _refs(index: _Index, module: str, node: ast.AST, scope) -> set[tuple]:
    out: set[tuple] = set()
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            out.update(index.resolve(module, sub, scope=scope))
    return out


def _roots(index: _Index) -> tuple[set[tuple], list[tuple]]:
    """(function keys a capture runs, captured inline code): the second is
    ``(fn, stmts)`` for a ``torch.cuda.graph`` body or a lambda handed to
    ``capture_step``, scanned where it stands."""
    roots: set[tuple] = set()
    inline: list[tuple] = []
    for src in index.ctx.sources:
        module = index.ctx.module_name(src)
        for call in capture_calls(src.tree):
            scope = _enclosing(index, src, call)
            arg = call.args[0]
            if isinstance(arg, ast.Lambda):
                inline.append((scope, src, [arg.body]))
                roots.update(_refs(index, module, arg.body, scope))
            else:
                roots.update(index.resolve(module, arg, scope=scope))
        for block in capture_blocks(src.tree):
            scope = _enclosing(index, src, block)
            inline.append((scope, src, block.body))
            for stmt in block.body:
                roots.update(_refs(index, module, stmt, scope))
    return roots, inline


def _reachable(index: _Index, roots: set[tuple]) -> set[tuple]:
    seen: set[tuple] = set()
    todo = list(roots)
    while todo:
        key = todo.pop()
        if key in seen or key not in index.fns:
            continue
        seen.add(key)
        fn = index.fns[key]
        # everything lexically nested in a captured function runs in it
        todo.extend(index.nested.get(key, []))
        for node in ast.walk(fn.node):
            # any resolvable function REFERENCE, not just direct calls:
            # dispatch tables and higher-order helpers pass functions on
            if isinstance(node, (ast.Name, ast.Attribute)):
                todo.extend(index.resolve(fn.module, node, scope=fn))
    return seen


def _scan(nodes, qual: str, path: str) -> list[Finding]:
    out = []
    for node in nodes:
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            kind = "global" if isinstance(node, ast.Global) else "nonlocal"
            out.append(Finding(
                "GRAPH002", path, node.lineno,
                f"{qual} mutates closed-over state ({kind} "
                f"{', '.join(node.names)}) in captured code (runs once, "
                "at capture, not per replay)"))
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            parts = d.split(".") if d else []
            head = parts[0] if parts else None
            tail = node.func.attr if isinstance(node.func, ast.Attribute) \
                else (parts[-1] if parts else None)
            if head == "time" and len(parts) > 1:
                out.append(Finding(
                    "GRAPH001", path, node.lineno,
                    f"{qual} calls {d}() in captured code (a capture-time "
                    "constant, not a per-replay clock)"))
            elif d in ("os.getenv", "os.environ.get") \
                    or (tail in _KNOB_READS and d is not None):
                out.append(Finding(
                    "GRAPH001", path, node.lineno,
                    f"{qual} reads a knob or the environment ({d}) in "
                    "captured code (baked in at capture)"))
            elif d and ((head in ("np", "numpy") and len(parts) > 2
                         and parts[1] == "random")
                        or (head == "random" and len(parts) > 1)):
                out.append(Finding(
                    "GRAPH001", path, node.lineno,
                    f"{qual} calls {d}() in captured code (a host RNG draw "
                    "freezes at capture; use a registered torch.Generator)"))
            elif d == "print":
                out.append(Finding(
                    "GRAPH001", path, node.lineno,
                    f"{qual} calls print() in captured code (runs once, at "
                    "capture)"))
            elif isinstance(node.func, ast.Attribute) and tail in _SYNC_METHODS \
                    and (tail == "synchronize" or not node.args):
                out.append(Finding(
                    "GRAPH003", path, node.lineno,
                    f"{qual} calls .{tail}() in captured code (a host sync "
                    "fails the capture and stalls the warm-up step)"))
        if isinstance(node, ast.Subscript) \
                and dotted(node.value) == "os.environ":
            out.append(Finding(
                "GRAPH001", path, node.lineno,
                f"{qual} reads os.environ in captured code (baked in at "
                "capture)"))
    return out


def _owned(root: ast.AST) -> list[ast.AST]:
    """Nodes of ``root`` outside its nested defs and lambdas (those are
    separate reachable nodes; don't double-report)."""
    out = []
    todo = list(ast.iter_child_nodes(root))
    while todo:
        node = todo.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        todo.extend(ast.iter_child_nodes(node))
    return out


def check(ctx: Context) -> list[Finding]:
    index = _Index(ctx)
    roots, inline = _roots(index)
    out: list[Finding] = []
    for key in sorted(_reachable(index, roots)):
        fn = index.fns[key]
        out.extend(_scan(_owned(fn.node), key[1], ctx.display_path(fn.src)))
    for scope, src, stmts in inline:
        qual = (scope.key[1] if scope is not None else "<module>") \
            + " (captured block)"
        nodes = []
        for stmt in stmts:
            nodes.append(stmt)
            nodes.extend(_owned(stmt))
        out.extend(_scan(nodes, qual, ctx.display_path(src)))
    return out

"""LOCK001-004: declarative lock discipline for concurrency-heavy classes.

A class opts in by declaring (class-body literal assignments):

``_GUARDED_BY = {"_cache": "_lock", ...}``
    attribute -> the ``self.<lock>`` that must be held to WRITE it (writes
    are assignments, augmented assignments, deletes, subscript stores, and
    calls of mutating methods — append/put/clear/...).  ``__init__`` is
    exempt (construction precedes publication).  Inherited and mergeable:
    a subclass entry overrides the base's; mapping an attribute to
    ``None`` removes it (the subclass replaces the lock protocol with a
    different discipline — declare which below).

``_THREAD_ENTRIES = ("_loop",)``
    methods that run as their own thread (scheduler/watchdog loops).
    Methods reachable from an entry (same-class call graph over
    ``self.m()``) may write only declared attributes — anything else is an
    undeclared cross-thread share (LOCK002).

``_THREAD_CONFINED = ("_bstate", ...)``
    attributes written ONLY by the owning thread (reads elsewhere are
    racy-by-design snapshots).  A write from a non-entry-reachable method
    is a confinement break (LOCK002) unless suppressed with a reason
    (e.g. ``recover()`` runs strictly after the thread died).

``_SHARED_ATOMIC = ("_items", "_stop", ...)``
    attributes shared across threads whose individual operations are
    atomic by design (GIL dict/list ops, threading.Event) — exempt from
    write checks, but the declaration keeps the inventory honest.

A method whose ``def`` line carries ``# lfkt: holds[_lock]`` asserts it is
only ever called with that lock held; LOCK001 then accepts its writes, and
LOCK003 verifies every same-class call site actually holds the lock (a
``with self._lock:`` block, an ``acquire()``/``release()`` region, another
``holds`` method, or ``__init__``).

The convention is documented for engine authors in the README's port
lint section.
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, Source, const_str, dotted, self_attr, str_seq

RULES = {
    "LOCK001": "write to a _GUARDED_BY attribute without holding its lock",
    "LOCK002": "thread-entry method writes an undeclared shared attribute "
               "(or a thread-confined attribute is written off-thread)",
    "LOCK003": "call to a `# lfkt: holds[lock]` method without the lock",
    "LOCK004": "lock-discipline declaration names an unknown lock/method",
}

#: method calls that mutate their receiver — a call on a guarded attr is a
#: write for LOCK001 purposes
MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft", "clear",
    "update", "add", "remove", "discard", "setdefault", "put", "put_nowait",
    "sort", "reverse",
})

_HOLDS_RE = re.compile(r"#\s*lfkt:\s*holds\[(\w+)\]")


class _ClassInfo:
    def __init__(self, src: Source, node: ast.ClassDef):
        self.src = src
        self.node = node
        self.name = node.name
        self.bases = [b.split(".")[-1] for b in
                      (dotted(base) for base in node.bases) if b]
        self.guarded: dict[str, str | None] = {}
        self.entries: list[str] = []
        self.confined: list[str] = []
        self.atomic: list[str] = []
        self.declared = False
        self.methods: dict[str, ast.FunctionDef] = {}
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                if name == "_GUARDED_BY" and isinstance(stmt.value, ast.Dict):
                    self.declared = True
                    for k, v in zip(stmt.value.keys, stmt.value.values):
                        ks = const_str(k) if k is not None else None
                        if ks is None:
                            continue
                        if isinstance(v, ast.Constant) and v.value is None:
                            self.guarded[ks] = None
                        else:
                            self.guarded[ks] = const_str(v)
                elif name in ("_THREAD_ENTRIES", "_THREAD_CONFINED",
                              "_SHARED_ATOMIC"):
                    vals = str_seq(stmt.value)
                    if vals is not None:
                        self.declared = True
                        if name == "_THREAD_ENTRIES":
                            self.entries = vals
                        elif name == "_THREAD_CONFINED":
                            self.confined = vals
                        else:
                            self.atomic = vals

    def holds_marker(self, fn: ast.FunctionDef) -> set[str]:
        """Locks asserted held by a ``# lfkt: holds[..]`` comment on any
        line of the (possibly multi-line) def signature."""
        body_start = fn.body[0].lineno if fn.body else fn.lineno
        out: set[str] = set()
        for line in self.src.lines[fn.lineno - 1: body_start]:
            out.update(_HOLDS_RE.findall(line))
        return out


def _collect_classes(ctx: Context) -> dict[str, _ClassInfo]:
    out: dict[str, _ClassInfo] = {}
    for src in ctx.sources:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                # last definition wins; class names are unique in practice
                out[node.name] = _ClassInfo(src, node)
    return out


def _mro(info: _ClassInfo, classes: dict[str, _ClassInfo],
         seen: set[str] | None = None) -> list[_ClassInfo]:
    """Base-first linearization over in-package single inheritance."""
    seen = seen or set()
    chain: list[_ClassInfo] = []
    for base in info.bases:
        b = classes.get(base)
        if b is not None and b.name not in seen:
            seen.add(b.name)
            chain.extend(_mro(b, classes, seen))
    chain.append(info)
    return chain


def _effective_guarded(info: _ClassInfo,
                       classes: dict[str, _ClassInfo]) -> dict[str, str]:
    merged: dict[str, str | None] = {}
    for c in _mro(info, classes):
        merged.update(c.guarded)
    return {k: v for k, v in merged.items() if v is not None}


def _held_regions(fn: ast.FunctionDef, locks: set[str]):
    """(with_map, acquire_spans): for each lock, the set of nodes inside a
    ``with self.<lock>`` body, plus (first, last) line spans between an
    ``self.<lock>.acquire()`` call and the matching ``release()``."""
    with_nodes: dict[int, set[str]] = {}     # id(node) -> locks held there

    def visit(node: ast.AST, held: frozenset):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            add = set()
            for item in node.items:
                d = self_attr(item.context_expr)
                if d in locks:
                    add.add(d)
            held = held | frozenset(add)
        with_nodes[id(node)] = set(held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    visit(fn, frozenset())

    spans: dict[str, tuple[int, int]] = {}
    acq: dict[str, int] = {}
    rel: dict[str, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            lock = self_attr(node.func.value)
            if lock in locks:
                if node.func.attr == "acquire":
                    acq.setdefault(lock, node.lineno)
                elif node.func.attr == "release":
                    rel[lock] = max(rel.get(lock, 0), node.lineno)
    for lock, start in acq.items():
        if lock in rel:
            spans[lock] = (start, rel[lock])
    return with_nodes, spans


def _holds_at(node: ast.AST, lock: str, with_nodes, spans,
              asserted: set[str]) -> bool:
    if lock in asserted:
        return True
    if lock in with_nodes.get(id(node), ()):
        return True
    span = spans.get(lock)
    return span is not None and span[0] <= getattr(node, "lineno", 0) <= span[1]


def _writes(fn: ast.FunctionDef):
    """Yield (node, attr) for every write to a ``self.<attr>`` in fn."""
    for node in ast.walk(fn):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if getattr(node, "value", True) is not None:
                targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATORS:
            attr = self_attr(node.func.value)
            if attr is not None:
                yield node, attr
            continue
        for t in targets:
            for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                attr = self_attr(el)
                if attr is not None:
                    yield node, attr


def _entry_reachable(info: _ClassInfo) -> set[str]:
    """Methods reachable from _THREAD_ENTRIES via same-class self.m() calls."""
    edges: dict[str, set[str]] = {}
    for name, fn in info.methods.items():
        calls = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if (isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"
                        and node.func.attr in info.methods):
                    calls.add(node.func.attr)
        edges[name] = calls
    seen = set()
    todo = [e for e in info.entries if e in info.methods]
    while todo:
        m = todo.pop()
        if m in seen:
            continue
        seen.add(m)
        todo.extend(edges.get(m, ()))
    return seen


def check(ctx: Context) -> list[Finding]:
    classes = _collect_classes(ctx)
    out: list[Finding] = []
    for info in classes.values():
        chain = _mro(info, classes)
        if not any(c.declared for c in chain):
            continue
        guarded = _effective_guarded(info, classes)
        path = ctx.display_path(info.src)
        confined = set(info.confined)
        atomic = set(info.atomic)
        declared_attrs = set(guarded) | confined | atomic
        entry_set = _entry_reachable(info)

        # holds-markers across the MRO (call sites may target base methods)
        holds_by_method: dict[str, set[str]] = {}
        for c in chain:
            for name, fn in c.methods.items():
                marks = c.holds_marker(fn)
                if marks:
                    holds_by_method[name] = marks

        # locks to track in held-region analysis: everything the guarded
        # map names PLUS locks holds-marked callees require (a subclass may
        # drop an attr from _GUARDED_BY yet still call base holds-methods)
        locks = {v for v in guarded.values()} | {
            lk for marks in holds_by_method.values() for lk in marks}

        # LOCK004: declaration sanity (only for the declaring class itself)
        if info.declared:
            init_assigns: set[str] = set()
            for c in chain:
                init = c.methods.get("__init__")
                if init is not None:
                    for _, attr in _writes(init):
                        init_assigns.add(attr)
            for attr, lock in sorted(info.guarded.items()):
                if lock is not None and lock not in init_assigns:
                    out.append(Finding(
                        "LOCK004", path, info.node.lineno,
                        f"{info.name}._GUARDED_BY maps {attr!r} to "
                        f"{lock!r}, which no __init__ in its MRO assigns"))
            for entry in info.entries:
                if not any(entry in c.methods for c in chain):
                    out.append(Finding(
                        "LOCK004", path, info.node.lineno,
                        f"{info.name}._THREAD_ENTRIES names unknown "
                        f"method {entry!r}"))

        for name, fn in info.methods.items():
            if name == "__init__":
                continue
            asserted = holds_by_method.get(name, set())
            with_nodes, spans = _held_regions(fn, locks)

            for node, attr in _writes(fn):
                if attr in guarded:
                    lock = guarded[attr]
                    if not _holds_at(node, lock, with_nodes, spans, asserted):
                        out.append(Finding(
                            "LOCK001", path, node.lineno,
                            f"{info.name}.{name} writes self.{attr} "
                            f"without holding self.{lock}"))
                elif attr in confined and info.entries \
                        and name not in entry_set:
                    out.append(Finding(
                        "LOCK002", path, node.lineno,
                        f"{info.name}.{name} writes thread-confined "
                        f"self.{attr} outside the owning thread's methods"))
                elif attr not in declared_attrs and name in entry_set:
                    out.append(Finding(
                        "LOCK002", path, node.lineno,
                        f"thread-entry path {info.name}.{name} writes "
                        f"undeclared self.{attr} (declare it in _GUARDED_BY, "
                        f"_THREAD_CONFINED or _SHARED_ATOMIC)"))

            # LOCK003: calls into holds-marked methods must hold the lock
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"):
                    continue
                callee = node.func.attr
                needs = holds_by_method.get(callee, set())
                for lock in needs:
                    if not _holds_at(node, lock, with_nodes, spans, asserted):
                        out.append(Finding(
                            "LOCK003", path, node.lineno,
                            f"{info.name}.{name} calls self.{callee}() "
                            f"(# lfkt: holds[{lock}]) without holding "
                            f"self.{lock}"))
    return out

"""PIN001-002: buffers a captured CUDA graph holds by address.

The JAX package's DON001-002 guard donated buffers: a jit that donates its
argument reuses the buffer, so the caller's reference is dead after the
dispatch.  The port has no donation; its counterpart hazard is the
opposite one.  A captured graph holds the addresses of every buffer it
reads and writes — the decode state, the sampling knobs, the KV ring, the
verify step's static draft and output — and a replay reads and writes
those very addresses.  So the buffers must be refilled in place
(``copy_``, ``zero_``, ``fill_``) and never rebound: after
``self._ring = new_ring()`` the next replay serves the old buffer, and the
new one is never written (the reason the engine zeroes its ring in place
on recovery).  And a graph's static output is overwritten by every
replay, so a view of it read after a later replay reads the later step.

A class declares the attributes its graphs hold, in the ``_GUARDED_BY``
style (class-body literal, inherited over the in-package MRO)::

    _GRAPH_PINNED = ("_state", "_st", "_vout")

- **PIN001** — an assignment (or ``del``) rebinding ``self.<pinned>``
  outside ``__init__`` and the capture methods (those that call
  ``capture_step`` or open ``torch.cuda.graph``).  In-place writes are
  calls, never assignments, so they pass.  A declaration naming an
  attribute that no ``__init__`` in the MRO assigns is PIN001 too.
- **PIN002** — a local alias of a view of a pinned buffer (a slice or
  index of ``self.<pinned>``, not a ``.clone()``/``.tolist()`` copy) read
  after a later replay: a ``.replay()``, ``replay_step(...)``, or a call
  of a pinned class's method that replays.  Intraprocedural over the CFG
  (lint/cfg.py), may-analysis: a read on any path after a replay fires.
"""

from __future__ import annotations

import ast

from .cfg import build_cfg, eval_roots, solve_forward
from .core import Context, Finding, Source, dotted, str_seq
from .graph import capture_blocks, capture_calls

RULES = {
    "PIN001": "an attribute a CUDA graph holds (_GRAPH_PINNED) is rebound "
              "outside __init__ and the capture methods",
    "PIN002": "a local view of a graph's static buffer is read after a "
              "later replay",
}

_REPLAY_TAILS = ("replay", "replay_step")


class _Pinned:
    def __init__(self, src: Source, node: ast.ClassDef):
        self.src = src
        self.node = node
        self.bases = [b.split(".")[-1] for b in
                      (dotted(base) for base in node.bases) if b]
        self.pinned: list[str] = []
        self.line = node.lineno
        self.methods = {s.name: s for s in node.body
                        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "_GRAPH_PINNED":
                self.pinned = str_seq(stmt.value) or []
                self.line = stmt.lineno


def _classes(ctx: Context) -> dict[str, _Pinned]:
    out = {}
    for src in ctx.sources:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                out[node.name] = _Pinned(src, node)
    return out


def _mro(info: _Pinned, classes: dict, seen=None) -> list[_Pinned]:
    seen = seen or set()
    chain = []
    for base in info.bases:
        b = classes.get(base)
        if b is not None and b.node.name not in seen:
            seen.add(b.node.name)
            chain.extend(_mro(b, classes, seen))
    chain.append(info)
    return chain


def _rebinds(fn: ast.AST):
    """(node, attr) for every statement rebinding ``self.<attr>``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = node.targets
        else:
            continue
        for t in targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                if isinstance(el, ast.Attribute) and isinstance(el.value, ast.Name) \
                        and el.value.id == "self":
                    yield node, el.attr


def _captures(fn: ast.AST) -> bool:
    return any(capture_calls(fn)) or any(capture_blocks(fn))


def _replays_directly(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            tail = node.func.attr if isinstance(node.func, ast.Attribute) else d
            if tail in _REPLAY_TAILS:
                return True
    return False


def _view_of(expr: ast.AST, pinned: set[str]) -> str | None:
    """The pinned attribute ``expr`` is a view of: a subscript chain down
    to ``self.<pinned>`` with at least one slice or index that is not a
    dict key."""
    sliced = False
    node = expr
    while isinstance(node, ast.Subscript):
        sl = node.slice
        if not (isinstance(sl, ast.Constant) and isinstance(sl.value, str)):
            sliced = True
        node = node.value
    if sliced and isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) and node.value.id == "self" \
            and node.attr in pinned:
        return node.attr
    return None


def _check_aliases(ctx: Context, src: Source, fn, pinned: set[str],
                   replayers: set[str]) -> list[Finding]:
    cfg = build_cfg(fn)

    def replays(stmt) -> bool:
        for root in eval_roots(stmt):
            for sub in ast.walk(root):
                if isinstance(sub, ast.Call):
                    f = sub.func
                    tail = f.attr if isinstance(f, ast.Attribute) else \
                        (f.id if isinstance(f, ast.Name) else None)
                    if tail in _REPLAY_TAILS or tail in replayers:
                        return True
        return False

    def binds(stmt):
        """(names rebound, {alias: pinned attr} for new views)."""
        names, views = set(), {}
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for t in targets:
                for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                    if isinstance(el, ast.Name):
                        names.add(el.id)
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) and stmt.value is not None:
                attr = _view_of(stmt.value, pinned)
                if attr is not None:
                    views[stmt.targets[0].id] = attr
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            names |= {n.id for n in ast.walk(stmt.target) if isinstance(n, ast.Name)}
        return names, views

    def flow(node, state):
        if node.stmt is None:
            return {"*": state}
        if replays(node.stmt):
            state = frozenset((n, a, True) for n, a, _ in state)
        names, views = binds(node.stmt)
        if names:
            state = frozenset(t for t in state if t[0] not in names)
            state |= frozenset((n, a, False) for n, a in views.items())
        return {"*": state}

    states = solve_forward(cfg, frozenset(), flow, lambda a, b: a | b)
    out = []
    seen = set()
    for node in cfg.stmt_nodes():
        state = states.get(node)
        if not state:
            continue
        stale = {n: a for n, a, s in state if s}
        if not stale:
            continue
        for root in eval_roots(node.stmt):
            for sub in ast.walk(root):
                if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                        and sub.id in stale and (sub.id, sub.lineno) not in seen:
                    seen.add((sub.id, sub.lineno))
                    out.append(Finding(
                        "PIN002", ctx.display_path(src), sub.lineno,
                        f"{fn.name} reads {sub.id}, a view of the graph buffer "
                        f"self.{stale[sub.id]}, after a later replay "
                        "overwrote it: copy it (.clone()/.tolist()) before "
                        "the next replay"))
    return out


def check(ctx: Context) -> list[Finding]:
    classes = _classes(ctx)
    out: list[Finding] = []
    declaring = {name: info for name, info in classes.items()
                 if any(c.pinned for c in _mro(info, classes))}
    replayers = {m for info in declaring.values()
                 for m, fn in info.methods.items() if _replays_directly(fn)}
    for name, info in sorted(declaring.items()):
        chain = _mro(info, classes)
        pinned = {a for c in chain for a in c.pinned}
        path = ctx.display_path(info.src)
        if info.pinned:
            init_assigns = set()
            for c in chain:
                init = c.methods.get("__init__")
                if init is not None:
                    init_assigns |= {a for _, a in _rebinds(init)}
            for attr in info.pinned:
                if attr not in init_assigns:
                    out.append(Finding(
                        "PIN001", path, info.line,
                        f"{name}._GRAPH_PINNED names {attr!r}, which no "
                        "__init__ in its MRO assigns"))
        for mname, fn in info.methods.items():
            if mname != "__init__" and not _captures(fn):
                for node, attr in _rebinds(fn):
                    if attr in pinned:
                        out.append(Finding(
                            "PIN001", path, node.lineno,
                            f"{name}.{mname} rebinds self.{attr}, a buffer "
                            "a captured graph holds by address: the next "
                            "replay serves the old one — refill it in place "
                            "(copy_/zero_/fill_)"))
            out.extend(_check_aliases(ctx, info.src, fn, pinned, replayers))
    return out

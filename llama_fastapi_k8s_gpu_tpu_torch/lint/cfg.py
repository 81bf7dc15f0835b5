"""Intraprocedural control-flow graphs + a forward dataflow solver.

The AST pattern rules (LOCK/GRAPH/CFG/OBS/PERF/DEAD) check *where things
are written*; the bug class of pool pages leaked on exception paths,
leases dropped before release and stale buffers served — is about
*which paths exist*.  This module gives the lint suite the missing
substrate: a statement-level CFG over stdlib ``ast`` with explicit
exception edges, and a generic worklist solver the rule families
(resources.py RES*, wire.py WIRE002, kernels.py KER002) run may/must
analyses on.

Graph model
-----------

One :class:`Node` per statement plus pseudo nodes (``entry``, ``exit``,
``raise``, dispatch/join points).  Edges carry a kind:

- ``norm`` — ordinary fall-through / completion;
- ``exc``  — the statement raised (its effect did NOT happen: transfer
  functions apply gen/kill on normal out-edges only);
- ``true``/``false`` — the two branches of an ``if``/``while``/``for``
  header (rules use these for conditional-acquire and ``is None`` guard
  patterns).

``try/finally`` duplicates the ``finally`` body per continuation kind
(normal / exception / return / break / continue) — the CPython-compiler
model — so a may-analysis cannot launder an exceptional path through the
normal continuation.  ``except``-handler dispatch is conservative: an
exception inside a ``try`` reaches every handler, and also propagates
outward unless some handler is a catch-all (bare, ``Exception``, or
``BaseException``).  ``with contextlib.suppress(...)`` bodies get an
extra edge from their exception paths to the normal continuation (the
suppression is real control flow).

Raise model: a statement can raise iff it contains a ``Call``, ``Raise``,
``Assert``, or ``Await`` (compound headers: only their test/iter/items
count).  Attribute/subscript access without a call is assumed
non-raising — the pragmatic lint trade: modelling every attribute load as
throwing would mark the very statement that *hands off* a resource as a
leak path.

Nothing here imports torch or jax or executes analyzed code (core.py
contract).
"""

from __future__ import annotations

import ast
from typing import Callable

from .core import dotted

__all__ = ["Node", "CFG", "build_cfg", "can_raise", "eval_roots",
           "solve_forward"]

#: context-manager call tails whose body exceptions may resume normally
SUPPRESS_TAILS = ("suppress",)

#: handler annotations that catch everything (conservatively: anything we
#: cannot resolve also counts as a catch-all, so no false "propagates")
_CATCH_ALL = ("Exception", "BaseException")


class Node:
    """One CFG node: a statement (``stmt`` set) or a pseudo point."""

    __slots__ = ("stmt", "label", "succ")

    def __init__(self, stmt: ast.stmt | None, label: str):
        self.stmt = stmt
        self.label = label          # entry|exit|raise|stmt|join|dispatch
        self.succ: list[tuple["Node", str]] = []

    def add(self, target: "Node", kind: str = "norm") -> None:
        edge = (target, kind)
        if edge not in self.succ:
            self.succ.append(edge)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        at = getattr(self.stmt, "lineno", "?")
        return f"<Node {self.label}@{at}>"


class CFG:
    """entry → ... → exit (normal completion / return) and raise_exit
    (uncaught exception).  ``nodes`` holds every node, duplicated
    ``finally`` copies included."""

    def __init__(self) -> None:
        self.nodes: list[Node] = []
        self.entry = self.new(None, "entry")
        self.exit = self.new(None, "exit")
        self.raise_exit = self.new(None, "raise")

    def new(self, stmt: ast.stmt | None, label: str) -> Node:
        n = Node(stmt, label)
        self.nodes.append(n)
        return n

    def stmt_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.stmt is not None]


def _header_exprs(stmt: ast.stmt) -> list[ast.AST]:
    """The expressions evaluated by a compound statement's header (its
    body executes in its own nodes)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter, stmt.target]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [it.context_expr for it in stmt.items]
    if isinstance(stmt, (ast.Try,)):
        return []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return list(stmt.decorator_list)
    return [stmt]


def eval_roots(stmt: ast.stmt) -> list[ast.AST]:
    """What a CFG node for ``stmt`` actually EVALUATES: the header
    expressions for compound statements (their bodies live in their own
    nodes), the whole statement otherwise.  Transfer functions must scan
    these — walking a compound statement would attribute its body's
    effects to the header node.  Nested function/lambda bodies are the
    caller's concern (they do not execute here)."""
    return _header_exprs(stmt)


def can_raise(stmt: ast.stmt) -> bool:
    """Whether executing this statement (its header, for compounds) may
    raise — see the raise model in the module docstring."""
    for root in _header_exprs(stmt):
        for sub in ast.walk(root):
            if isinstance(sub, (ast.Call, ast.Raise, ast.Assert, ast.Await)):
                return True
    return False


class _Ctx:
    """Where abnormal exits go from the current position (all targets are
    already routed through any enclosing ``finally`` copies)."""

    __slots__ = ("ret", "exc", "brk", "cont")

    def __init__(self, ret: Node, exc: Node,
                 brk: Node | None = None, cont: Node | None = None):
        self.ret = ret
        self.exc = exc
        self.brk = brk
        self.cont = cont

    def replace(self, **kw) -> "_Ctx":
        out = _Ctx(self.ret, self.exc, self.brk, self.cont)
        for k, v in kw.items():
            setattr(out, k, v)
        return out


def _is_catch_all(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    names: list[ast.AST] = (list(handler.type.elts)
                            if isinstance(handler.type, ast.Tuple)
                            else [handler.type])
    for t in names:
        d = dotted(t)
        if d is not None and d.split(".")[-1] in _CATCH_ALL:
            return True
        if d is None:
            return True         # unresolvable: assume it catches
    return False


def _with_suppresses(stmt: ast.With | ast.AsyncWith) -> bool:
    for item in stmt.items:
        if isinstance(item.context_expr, ast.Call):
            d = dotted(item.context_expr.func)
            if d is not None and d.split(".")[-1] in SUPPRESS_TAILS:
                return True
    return False


class _Builder:
    def __init__(self, cfg: CFG):
        self.cfg = cfg

    # -- public ---------------------------------------------------------
    def build(self, body: list[ast.stmt]) -> None:
        ctx = _Ctx(ret=self.cfg.exit, exc=self.cfg.raise_exit)
        out = self.stmts(body, [(self.cfg.entry, "norm")], ctx)
        self.connect(out, self.cfg.exit)

    # -- plumbing -------------------------------------------------------
    def connect(self, preds: list[tuple[Node, str]], target: Node) -> None:
        for node, kind in preds:
            node.add(target, kind)

    def stmts(self, body: list[ast.stmt], preds, ctx: _Ctx):
        for stmt in body:
            preds = self.one(stmt, preds, ctx)
        return preds

    def one(self, stmt: ast.stmt, preds, ctx: _Ctx):
        n = self.cfg.new(stmt, "stmt")
        self.connect(preds, n)
        raising = can_raise(stmt)
        if raising:
            n.add(ctx.exc, "exc")

        if isinstance(stmt, ast.Return):
            n.add(ctx.ret, "norm")
            return []
        if isinstance(stmt, ast.Raise):
            # already has the exc edge (Raise always "can raise")
            return []
        if isinstance(stmt, ast.Break):
            if ctx.brk is not None:
                n.add(ctx.brk, "norm")
            return []
        if isinstance(stmt, ast.Continue):
            if ctx.cont is not None:
                n.add(ctx.cont, "norm")
            return []
        if isinstance(stmt, ast.Assert):
            # a failing assert raises; the exc edge above covers it
            return [(n, "norm")]

        if isinstance(stmt, ast.If):
            body_out = self.stmts(stmt.body, [(n, "true")], ctx)
            else_out = (self.stmts(stmt.orelse, [(n, "false")], ctx)
                        if stmt.orelse else [(n, "false")])
            return body_out + else_out

        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            join = self.cfg.new(None, "join")
            inner = ctx.replace(brk=join, cont=n)
            body_out = self.stmts(stmt.body, [(n, "true")], inner)
            self.connect(body_out, n)                     # loop back edge
            else_out = (self.stmts(stmt.orelse, [(n, "false")], ctx)
                        if stmt.orelse else [(n, "false")])
            self.connect(else_out, join)
            return [(join, "norm")]

        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            after = self.cfg.new(None, "join")
            inner = ctx
            if _with_suppresses(stmt):
                sup = self.cfg.new(None, "dispatch")
                sup.add(after, "norm")     # suppressed: resume after body
                sup.add(ctx.exc, "exc")    # conservatively: may not match
                inner = ctx.replace(exc=sup)
            body_out = self.stmts(stmt.body, [(n, "norm")], inner)
            self.connect(body_out, after)
            return [(after, "norm")]

        if isinstance(stmt, ast.Try):
            return self.try_stmt(stmt, n, ctx)

        return [(n, "norm")]

    # -- try/except/else/finally ---------------------------------------
    def try_stmt(self, stmt: ast.Try, n: Node, ctx: _Ctx):
        if stmt.finalbody:
            # route every continuation through its own copy of finally
            memo: dict[int, Node] = {}

            def via_final(target: Node) -> Node:
                got = memo.get(id(target))
                if got is not None:
                    return got
                head = self.cfg.new(None, "join")
                memo[id(target)] = head
                out = self.stmts(stmt.finalbody, [(head, "norm")], ctx)
                self.connect(out, target)
                return head

            inner = _Ctx(
                ret=via_final(ctx.ret),
                exc=via_final(ctx.exc),
                brk=via_final(ctx.brk) if ctx.brk is not None else None,
                cont=via_final(ctx.cont) if ctx.cont is not None else None,
            )
            body_out = self.try_core(stmt, n, inner)
            after = self.cfg.new(None, "join")
            self.connect(body_out, via_final(after))
            return [(after, "norm")]
        return self.try_core(stmt, n, ctx)

    def try_core(self, stmt: ast.Try, n: Node, ctx: _Ctx):
        """try body + handlers + orelse (``ctx`` already finally-wrapped)."""
        if not stmt.handlers:
            body_out = self.stmts(stmt.body, [(n, "norm")], ctx)
            if stmt.orelse:
                body_out = self.stmts(stmt.orelse, body_out, ctx)
            return body_out
        hdisp = self.cfg.new(None, "dispatch")
        inner = ctx.replace(exc=hdisp)
        body_out = self.stmts(stmt.body, [(n, "norm")], inner)
        if stmt.orelse:
            # orelse exceptions are NOT caught by this try's handlers
            body_out = self.stmts(stmt.orelse, body_out, ctx)
        out = list(body_out)
        for handler in stmt.handlers:
            out += self.stmts(handler.body, [(hdisp, "norm")], ctx)
        if not any(_is_catch_all(h) for h in stmt.handlers):
            hdisp.add(ctx.exc, "exc")       # unmatched: propagates
        return out


def build_cfg(body: list[ast.stmt] | ast.FunctionDef | ast.AsyncFunctionDef
              ) -> CFG:
    """CFG for a function body (pass the def node or its ``body`` list)."""
    if isinstance(body, (ast.FunctionDef, ast.AsyncFunctionDef)):
        body = body.body
    cfg = CFG()
    _Builder(cfg).build(list(body))
    return cfg


# ---------------------------------------------------------------------------
# the forward worklist solver
# ---------------------------------------------------------------------------

def solve_forward(cfg: CFG, init,
                  flow: Callable[[Node, object], dict],
                  join: Callable[[object, object], object]) -> dict[Node, object]:
    """Forward dataflow to fixpoint.

    ``flow(node, in_state)`` returns ``{edge_kind: out_state}`` with ``"*"``
    as the default for unlisted kinds (return ``{"*": state}`` for
    kind-insensitive transfers).  ``join`` merges states at confluence
    points (set-union for a *may* analysis, intersection for *must*).
    Returns ``IN``: the state at each node's entry; unreachable nodes are
    absent (callers treat a missing exit as "no such path").

    Transfer functions MUST be monotone over a finite state space
    (frozensets of tokens are the intended currency) — the worklist then
    terminates.
    """
    IN: dict[Node, object] = {cfg.entry: init}
    work = [cfg.entry]
    while work:
        node = work.pop()
        outs = flow(node, IN[node])
        default = outs.get("*")
        for target, kind in node.succ:
            state = outs.get(kind, default)
            if state is None:
                continue
            cur = IN.get(target)
            new = state if cur is None else join(cur, state)
            if cur is None or new != cur:
                IN[target] = new
                work.append(target)
    return IN


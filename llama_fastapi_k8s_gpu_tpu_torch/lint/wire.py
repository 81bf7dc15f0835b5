"""WIRE — the wire-surface registry cross-checks (lfkt-lint v4).

serving/wiresurface.py declares every ``x-lfkt-*`` HTTP header and every
page-wire / migration frame-header field with a direction and a TRUST
class, plus the ingress points that accept client bytes.  This checker
enforces the registry three ways (the OBS-catalog / CFG-knob pattern —
declare once, cross-check everywhere):

- **WIRE001** — an undeclared surface: an ``x-lfkt-*`` string literal
  anywhere in the package, a frame-header dict key handed to
  ``send_frame``/``put``/``encode_frame``, or a ``hdr.get(...)`` /
  ``hello.get(...)`` field read whose name the registry does not know.
  A new header or frame field must land in the registry (and pick a
  trust class) in the same commit that introduces it.
- **WIRE002** — a declared ingress that can forward client bytes
  upstream without first stripping every ``internal-stamped-must-strip``
  header.  Proved over the ingress function's CFG with a MUST dataflow
  (forward solve, intersection join): a strip event (a membership test
  against the header name, a ``.pop(HEADER)``, a ``del d[HEADER]``)
  GENerates the header; every node whose statement calls the declared
  forward tail must have all internal-stamped headers in its in-state.
  Strips inside a loop are attributed to the loop header node — an
  empty iteration means there was nothing to strip, so the loop
  vacuously covers them.  Deleting the fleet router's strip loop fires
  this (the regression pin of the forged-stamp hole).
- **WIRE003** — drift between the registry and the generated table in
  docs/WIRESURFACE.md (pinned byte-for-byte between the
  ``wire-surface:begin``/``end`` markers; print the table with ``python -m
  llama_fastapi_k8s_gpu_tpu_torch.serving.wiresurface``).  The port's
  page wire is the JAX package's, so the one table documents both.
  Skips itself outside a repo checkout, like every docs rule.

The registry file is parsed statically (``ast`` over the declaration
literals) — the lint never imports the package under analysis.  When
the package has no ``serving/wiresurface.py`` at all, every WIRE rule
skips itself: the registry is the opt-in.
"""

from __future__ import annotations

import ast
import os
import re

from .callgraph import build_graph
from .cfg import build_cfg, eval_roots, solve_forward
from .core import Context, Finding, Source, const_str, dotted

RULES = {
    "WIRE001": "x-lfkt-* header or wire frame-header field used but not "
               "declared in serving/wiresurface.py",
    "WIRE002": "declared ingress point can forward client bytes without "
               "stripping every internal-stamped header (CFG must-"
               "analysis)",
    "WIRE003": "wire-surface registry and the generated docs table have "
               "drifted (regenerate docs/WIRESURFACE.md)",
}

#: the registry module, package-relative
REGISTRY_REL = "serving/wiresurface.py"

#: a header-shaped token (WIRE001 only fires on literals that could BE a
#: header — prose mentioning the prefix, like rule descriptions or error
#: messages with globs, is not a wire surface)
_HEADER_TOKEN_RE = re.compile(r"^x-lfkt-[a-z0-9-]*[a-z0-9]$")

_DOCS_BEGIN = "<!-- wire-surface:begin (generated - do not hand-edit) -->"
_DOCS_END = "<!-- wire-surface:end -->"

#: call tails whose 2nd positional argument is a frame-header dict
_FRAME_CTORS = ("send_frame", "put", "encode_frame")

#: receiver names conventionally bound to a decoded frame header /
#: HELLO geometry doc (the package-wide consumption idiom)
_FRAME_RECEIVERS = ("hdr", "hello", "theirs", "mine", "geometry")

_TRUST_STRIP = "internal-stamped-must-strip"


# ---------------------------------------------------------------------------
# static registry parse
# ---------------------------------------------------------------------------

class _Registry:
    """The declarations, read off the registry file's AST."""

    def __init__(self, src: Source):
        self.src = src
        self.headers: dict[str, dict] = {}      # name -> row
        self.fields: dict[str, dict] = {}
        self.ingresses: list[dict] = []
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            args = [const_str(a) for a in node.args]
            if node.func.id == "WireHeader" and len(args) >= 4 \
                    and all(a is not None for a in args[:4]):
                self.headers[args[0]] = {
                    "name": args[0], "direction": args[1],
                    "trust": args[2], "summary": args[3],
                    "line": node.lineno}
            elif node.func.id == "WireField" and len(args) >= 4 \
                    and all(a is not None for a in args[:4]):
                self.fields[args[0]] = {
                    "name": args[0], "frames": args[1],
                    "trust": args[2], "summary": args[3],
                    "line": node.lineno}
            elif node.func.id == "WireIngress" and len(args) >= 3 \
                    and all(a is not None for a in args[:3]):
                self.ingresses.append({
                    "function": args[0], "forward": args[1],
                    "summary": args[2], "line": node.lineno})

    def internal_stamped(self) -> list[str]:
        return sorted(name for name, row in self.headers.items()
                      if row["trust"] == _TRUST_STRIP)

    def markdown_table(self) -> str:
        """Byte-identical re-render of serving.wiresurface.markdown_table
        from the static declarations (WIRE003's comparison side; the
        tier-1 test pins runtime output to the docs, closing the
        static == runtime loop)."""
        rows = ["### HTTP headers", "",
                "| header | direction | trust | summary |",
                "|---|---|---|---|"]
        for h in self.headers.values():
            rows.append(f"| `{h['name']}` | {h['direction']} | "
                        f"{h['trust']} | {h['summary']} |")
        rows += ["", "### Frame-header fields", "",
                 "| field | frames | trust | summary |",
                 "|---|---|---|---|"]
        for f in self.fields.values():
            rows.append(f"| `{f['name']}` | {f['frames']} | {f['trust']} | "
                        f"{f['summary']} |")
        rows += ["", "### Ingress points", "",
                 "| function | forwards via | summary |",
                 "|---|---|---|"]
        for i in self.ingresses:
            rows.append(f"| `{i['function']}` | `{i['forward']}` | "
                        f"{i['summary']} |")
        return "\n".join(rows)


def _is_docstring_slot(parents: dict, node: ast.Constant) -> bool:
    expr = parents.get(id(node))
    if not isinstance(expr, ast.Expr):
        return False
    holder = parents.get(id(expr))
    if isinstance(holder, (ast.Module, ast.ClassDef, ast.FunctionDef,
                           ast.AsyncFunctionDef)):
        return holder.body and holder.body[0] is expr
    return False


def _parent_map(tree: ast.AST) -> dict:
    parents: dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


# ---------------------------------------------------------------------------
# WIRE002: the ingress strip proof
# ---------------------------------------------------------------------------

def _header_refs(node: ast.AST, aliases: dict[str, str],
                 declared: set[str]) -> set[str]:
    """Declared header names referenced anywhere inside ``node`` — as a
    string/bytes literal or through a module-level NAME alias (possibly
    ``.encode()``-wrapped; the AST walk sees through that for free)."""
    out: set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in aliases:
            out.add(aliases[sub.id])
        elif isinstance(sub, ast.Constant):
            v = sub.value
            if isinstance(v, bytes):
                try:
                    v = v.decode("ascii")
                except UnicodeDecodeError:
                    continue
            if isinstance(v, str) and v.lower() in declared:
                out.add(v.lower())
    return out


def _strip_events(fn_node, aliases: dict[str, str],
                  declared: set[str]) -> dict[int, set[str]]:
    """id(statement) -> header names that statement strips.  A strip is
    a membership Compare naming the header, a ``.pop(HEADER)``, or a
    ``del d[HEADER]``.  Events inside a loop attach to the OUTERMOST
    enclosing loop statement (the loop node dominates the post-loop
    path even on zero iterations)."""
    events: dict[int, set[str]] = {}

    def found(stmt, loop, names):
        if not names:
            return
        anchor = loop if loop is not None else stmt
        events.setdefault(id(anchor), set()).update(names)

    def scan_stmt(stmt, loop):
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Compare) \
                    and any(isinstance(op, (ast.In, ast.NotIn))
                            for op in sub.ops):
                found(stmt, loop, _header_refs(sub, aliases, declared))
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "pop" and sub.args:
                found(stmt, loop,
                      _header_refs(sub.args[0], aliases, declared))
            elif isinstance(sub, ast.Delete):
                found(stmt, loop, _header_refs(sub, aliases, declared))

    def walk(stmts, loop):
        for stmt in stmts:
            is_loop = isinstance(stmt, (ast.For, ast.AsyncFor, ast.While))
            inner_loop = loop if loop is not None else (
                stmt if is_loop else None)
            if _has_body(stmt):
                # only the header executes at this statement's CFG node
                # (a membership test in an If header covers BOTH branches
                # — the false edge means the header was absent, which is
                # vacuously stripped)
                for root in eval_roots(stmt):
                    _scan_expr(root, stmt, loop)
            else:
                scan_stmt(stmt, loop)
            for field in ("body", "orelse", "finalbody"):
                walk(getattr(stmt, field, []) or [], inner_loop)
            for h in getattr(stmt, "handlers", []) or []:
                walk(h.body, inner_loop)

    def _scan_expr(root, stmt, loop):
        for sub in ast.walk(root):
            if isinstance(sub, ast.Compare) \
                    and any(isinstance(op, (ast.In, ast.NotIn))
                            for op in sub.ops):
                found(stmt, loop, _header_refs(sub, aliases, declared))
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "pop" and sub.args:
                found(stmt, loop,
                      _header_refs(sub.args[0], aliases, declared))

    def _has_body(stmt):
        return isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While,
                                 ast.With, ast.AsyncWith, ast.Try,
                                 ast.FunctionDef, ast.AsyncFunctionDef))

    walk(fn_node.body, None)
    return events


def _forward_nodes(cfg, forward_tail: str):
    """CFG nodes whose statement calls the declared forward tail."""
    out = []
    for node in cfg.stmt_nodes():
        for root in eval_roots(node.stmt):
            for sub in ast.walk(root):
                if isinstance(sub, ast.Call):
                    d = dotted(sub.func)
                    tail = (sub.func.attr
                            if isinstance(sub.func, ast.Attribute)
                            else d)
                    if tail == forward_tail:
                        out.append(node)
                        break
    return out


def _check_ingress(ctx: Context, graph, reg: _Registry, ingress: dict,
                   aliases: dict[str, str], dpath) -> list[Finding]:
    must_strip = set(reg.internal_stamped())
    if not must_strip:
        return []
    try:
        module, qual = ingress["function"].split(":", 1)
    except ValueError:
        return [Finding(
            "WIRE002", dpath(reg.src.rel), ingress["line"],
            f"ingress declaration {ingress['function']!r} is not "
            "module:qualname")]
    fn = graph.index.fns.get((module, qual))
    if fn is None:
        return [Finding(
            "WIRE002", dpath(reg.src.rel), ingress["line"],
            f"declared ingress {ingress['function']!r} does not resolve "
            "to a package function (stale registry entry?)")]

    cfg = build_cfg(fn.node)
    events = _strip_events(fn.node, aliases, set(reg.headers))
    gen = {}
    for node in cfg.nodes:
        if node.stmt is not None and id(node.stmt) in events:
            gen[node] = frozenset(events[id(node.stmt)])

    def flow(node, state):
        add = gen.get(node)
        return {"*": state | add if add else state}

    states = solve_forward(cfg, frozenset(), flow,
                           lambda a, b: a & b)
    out: list[Finding] = []
    reported: set[str] = set()
    for node in _forward_nodes(cfg, ingress["forward"]):
        state = states.get(node)
        if state is None:
            continue        # unreachable forward: no such path
        missing = sorted(h for h in must_strip if h not in state)
        for h in missing:
            if h in reported:
                continue
            reported.add(h)
            out.append(Finding(
                "WIRE002", dpath(fn.src.rel), node.stmt.lineno,
                f"ingress {qual} reaches {ingress['forward']}() on a "
                f"path that never strips inbound {h!r} "
                f"(trust class {_TRUST_STRIP}) — a client could forge "
                "the internal stamp; filter it out of the forwarded "
                "headers first (serving/wiresurface.py declares the "
                "must-strip set)"))
    if not _forward_nodes(cfg, ingress["forward"]):
        out.append(Finding(
            "WIRE002", dpath(reg.src.rel), ingress["line"],
            f"declared ingress {qual} never calls its declared forward "
            f"tail {ingress['forward']!r} (stale registry entry?)"))
    return out


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

def check(ctx: Context) -> list[Finding]:
    reg_src = next((s for s in ctx.sources if s.rel == REGISTRY_REL), None)
    if reg_src is None:
        return []            # no registry: the package has not opted in
    reg = _Registry(reg_src)
    out: list[Finding] = []

    def dpath(rel: str) -> str:
        src = next((s for s in ctx.sources if s.rel == rel), None)
        return ctx.display_path(src) if src is not None else rel

    # module-level NAME = "x-lfkt-..." aliases, package-wide
    aliases: dict[str, str] = {}
    for src in ctx.sources:
        for stmt in src.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                v = const_str(stmt.value)
                if v is not None and v.lower().startswith("x-lfkt-"):
                    aliases[stmt.targets[0].id] = v.lower()

    # -- WIRE001: every use is declared -----------------------------------
    for src in ctx.sources:
        if src.rel == REGISTRY_REL:
            continue
        # built only when the file actually holds an x-lfkt-* literal —
        # a full parent map per file would dominate this checker's cost
        parents: dict | None = None
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Constant):
                v = node.value
                if isinstance(v, bytes):
                    try:
                        v = v.decode("ascii")
                    except UnicodeDecodeError:
                        continue
                if not (isinstance(v, str)
                        and _HEADER_TOKEN_RE.match(v.lower())):
                    continue
                if parents is None:
                    parents = _parent_map(src.tree)
                if _is_docstring_slot(parents, node):
                    continue
                if v.lower() not in reg.headers:
                    out.append(Finding(
                        "WIRE001", dpath(src.rel), node.lineno,
                        f"header {v!r} is not declared in "
                        "serving/wiresurface.py — every x-lfkt-* header "
                        "needs a registry row with a trust class"))
            elif isinstance(node, ast.Call):
                func = node.func
                tail = func.attr if isinstance(func, ast.Attribute) \
                    else (func.id if isinstance(func, ast.Name) else None)
                if tail in _FRAME_CTORS and len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.Dict):
                    for k in node.args[1].keys:
                        name = const_str(k)
                        if name is not None and name not in reg.fields:
                            out.append(Finding(
                                "WIRE001", dpath(src.rel), k.lineno,
                                f"frame-header field {name!r} is not "
                                "declared in serving/wiresurface.py — "
                                "every wire field needs a registry row "
                                "with a trust class"))
                elif tail == "get" and isinstance(func, ast.Attribute) \
                        and isinstance(func.value, ast.Name) \
                        and func.value.id in _FRAME_RECEIVERS \
                        and node.args:
                    name = const_str(node.args[0])
                    if name is not None and name not in reg.fields:
                        out.append(Finding(
                            "WIRE001", dpath(src.rel), node.lineno,
                            f"frame-header field {name!r} read off "
                            f"`{func.value.id}` is not declared in "
                            "serving/wiresurface.py"))

    # -- WIRE002: the ingress strip proof ----------------------------------
    graph = build_graph(ctx)
    for ingress in reg.ingresses:
        out.extend(_check_ingress(ctx, graph, reg, ingress, aliases,
                                  dpath))

    # -- WIRE003: registry <-> generated docs table ------------------------
    if ctx.repo_root:
        docs_path = os.path.join(ctx.repo_root, "docs", "WIRESURFACE.md")
        expected = reg.markdown_table()
        block = None
        try:
            with open(docs_path, encoding="utf-8") as f:
                text = f.read()
            lo = text.index(_DOCS_BEGIN) + len(_DOCS_BEGIN)
            hi = text.index(_DOCS_END)
            block = text[lo:hi].strip("\n")
        except (OSError, ValueError):
            block = None
        if block != expected:
            out.append(Finding(
                "WIRE003", dpath(reg_src.rel), 1,
                "the generated wire-surface table in docs/WIRESURFACE.md "
                "does not match the registry — print the table with python "
                "-m llama_fastapi_k8s_gpu_tpu_torch.serving.wiresurface"))
    return out

"""RES001-003: resource lifecycle over the CFG (lint/cfg.py).

The serving tier's hardening inventory was one bug class found by
review, not tooling: pool pages, radix pins, leases and capture locks leaked — or
served dead — on exception paths.  These rules make that class static.
A *registered acquire-like call* creates an obligation; dataflow over the
CFG (exception edges included) proves every path discharges it:

- **RES001** — a value-producing acquire (``KVPool.acquire`` leases,
  ``open()`` file handles, ``executor.submit()`` futures) must reach a
  registered release or an ownership handoff on EVERY path to function
  exit, exceptional paths included.  The canonical fix is ``finally:``
  (or ``with``); the canonical handoff is storing the value somewhere
  that outlives the frame.
- **RES002** — a bare ``<lock>.acquire()`` outside ``with`` must reach
  ``<lock>.release()`` on every path.  The conditional idiom
  ``if not lock.acquire(blocking=False): return`` is understood: the
  obligation starts only on the acquired branch.
- **RES003** — a tracked resource read after it was released on every
  path reaching the read (use-after-release / double-release): the
  release revoked what the name points at.

Ownership handoffs that discharge RES001 (intraprocedural humility —
once a value escapes the frame, its lifecycle belongs to someone else):

- returned (or yielded), directly or inside a literal container;
- stored to an attribute or subscript (``self._paged_lease = lease``);
- placed in a dict/list/tuple/set literal (``{"lease": lease}``);
- captured by a lambda / nested def (callback closures);
- futures only: passed as a call argument (``asyncio.wrap_future(fut)``
  takes the handle over);
- an explicit ``# lfkt: transfers[name] -- reason`` on the statement
  line — the annotation grammar for handoffs the dataflow cannot see
  (a semaphore permit released by a spawned task, a lease a callee
  stores).  The reason is part of the audit trail, like noqa's.

Scope limits (documented, deliberate): only simple ``name = <acquire>()``
bindings are tracked (comprehension/chained forms are not), attributes
written by callees are invisible, and rebinding a tracked name drops the
obligation.  A false negative costs silence; a false positive here would
cost a written ``transfers``/noqa — the same trade every lfkt-lint family
makes.
"""

from __future__ import annotations

import ast
import re

from .cfg import build_cfg, eval_roots, solve_forward
from .core import Context, Finding, dotted

RULES = {
    "RES001": "acquired resource (lease/file/future) may leak: a path "
              "reaches function exit without release or handoff",
    "RES002": "lock.acquire() outside `with` is not released on every "
              "path (use try/finally or with)",
    "RES003": "use of a resource after it was released on every path "
              "(use-after-release / double-release)",
}

#: value-producing acquires: call tail -> resource kind
VALUE_ACQUIRE_TAILS = {"acquire": "lease", "submit": "future"}
#: method tails that release a value resource passed as an ARGUMENT
RELEASE_ARG_TAILS = ("release", "closing")
#: method tails that release a value resource as the RECEIVER
RELEASE_RECV_TAILS = ("release", "close", "cancel", "result", "shutdown",
                      "add_done_callback")
#: the subset that actually REVOKES the handle (RES003's gen set):
#: futures stay fully usable after result()/cancel()/add_done_callback(),
#: so those discharge the leak obligation but are not use-after-release
REVOKE_RECV_TAILS = ("release", "close", "shutdown")
LOCK_TAIL = "acquire"

#: names are simple identifiers (the bound local, or a lock's terminal
#: attribute) — dots excluded so prose mentions of `transfers[...]` in
#: docstrings never parse as annotations
_TRANSFERS_RE = re.compile(
    r"#\s*lfkt:\s*transfers\[([\w,\s]*)\]\s*(?:--\s*(\S.*))?")


class _Site:
    __slots__ = ("line", "kind", "key", "what")

    def __init__(self, line: int, kind: str, key: str, what: str):
        self.line = line
        self.kind = kind            # lease | file | future | lock
        self.key = key              # bound name, or lock's dotted chain
        self.what = what            # human description for the finding


def _tail(call: ast.Call) -> str | None:
    d = dotted(call.func)
    return d.split(".")[-1] if d else None


def _recv(call: ast.Call) -> str | None:
    """Dotted receiver of a method call (``a.b.acquire()`` -> 'a.b')."""
    if isinstance(call.func, ast.Attribute):
        return dotted(call.func.value)
    return None


def _find_call(node: ast.AST, tail: str) -> ast.Call | None:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _tail(sub) == tail:
            return sub
    return None


def _names_loaded(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _transfer_names(src, stmt: ast.stmt) -> set[str]:
    """Names given in ``# lfkt: transfers[...]`` on any line of ``stmt``
    (compound statements: header lines only — their bodies have their own
    statements)."""
    out: set[str] = set()
    end = getattr(stmt, "end_lineno", None) or stmt.lineno
    body = getattr(stmt, "body", None)
    if isinstance(body, list) and body and isinstance(body[0], ast.stmt):
        # exclusive of the first body line (an annotation there belongs to
        # that statement, not to every branch of the compound), except for
        # one-line compounds where header and body share the line
        end = min(end, max(body[0].lineno - 1, stmt.lineno))
    for line in src.lines[stmt.lineno - 1: end]:
        m = _TRANSFERS_RE.search(line)
        if m:
            out.update(x.strip() for x in m.group(1).split(",") if x.strip())
    return out


def _with_item_calls(fn: ast.AST) -> set[int]:
    """ids of calls inside ``with`` items — the context manager owns the
    release, so they are not tracked acquires."""
    out: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    out.add(id(sub))
    return out


def _collect_sites(src, fn, in_with: set[int]) -> dict[int, _Site]:
    """Acquire sites keyed by id(stmt) of the owning statement.  An
    acquire whose own line carries a ``transfers`` annotation naming the
    resource is a declared immediate handoff and is not tracked at all."""
    sites: dict[int, _Site] = {}
    for stmt in ast.walk(fn):
        if not isinstance(stmt, ast.stmt):
            continue
        # value form: name = [await] <acquire-like>(...)
        value = stmt.value if isinstance(stmt, ast.Assign) else None
        if isinstance(value, ast.Await):
            value = value.value
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(value, ast.Call) \
                and id(value) not in in_with:
            call = value
            tail = _tail(call)
            kind = None
            if tail in VALUE_ACQUIRE_TAILS:
                kind = VALUE_ACQUIRE_TAILS[tail]
            elif isinstance(call.func, ast.Name) and call.func.id == "open":
                kind = "file"
            if kind is not None:
                name = stmt.targets[0].id
                if name in _transfer_names(src, stmt):
                    continue
                sites[id(stmt)] = _Site(
                    stmt.lineno, kind, name,
                    f"{kind} {name!r} from {dotted(call.func) or 'open'}()")
            continue
        # lock form: bare/awaited/tested <recv>.acquire()
        call = None
        if isinstance(stmt, ast.Expr):
            v = stmt.value
            if isinstance(v, ast.Await):
                v = v.value
            if isinstance(v, ast.Call) and _tail(v) == LOCK_TAIL:
                call = v
        elif isinstance(stmt, ast.If):
            call = _find_call(stmt.test, LOCK_TAIL)
        if call is not None and id(call) not in in_with:
            recv = _recv(call)
            if recv is not None:
                declared = _transfer_names(src, stmt)
                if recv in declared or recv.split(".")[-1] in declared:
                    continue
                sites[id(stmt)] = _Site(
                    call.lineno, "lock", recv, f"lock {recv}.acquire()")
    return sites


def _gen_edges(stmt: ast.stmt, site: _Site) -> tuple[str, ...]:
    """Edge kinds on which the acquire SUCCEEDED (the obligation starts).
    ``if not lock.acquire(): ...`` acquires on the false edge."""
    if not isinstance(stmt, ast.If):
        return ("norm", "true", "false")
    test = stmt.test
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and _find_call(test.operand, LOCK_TAIL) is not None:
        return ("false",)
    if isinstance(test, ast.Call):
        return ("true",)
    return ("true", "false")


def _none_test(stmt: ast.stmt) -> tuple[str, str] | None:
    """('name', edge-kind-where-None) for ``if name is None`` /
    ``if name is not None`` tests — the failed-acquire guard pattern."""
    if not isinstance(stmt, ast.If):
        return None
    t = stmt.test
    if isinstance(t, ast.Compare) and len(t.ops) == 1 \
            and isinstance(t.comparators[0], ast.Constant) \
            and t.comparators[0].value is None \
            and isinstance(t.left, ast.Name):
        if isinstance(t.ops[0], ast.Is):
            return t.left.id, "true"
        if isinstance(t.ops[0], ast.IsNot):
            return t.left.id, "false"
    return None


def _escapes(src, stmt: ast.stmt, key: str, kind: str) -> bool:
    """Does ``stmt`` hand ownership of value-resource ``key`` off?"""
    if key in _transfer_names(src, stmt):
        return True
    if isinstance(stmt, ast.Return) and stmt.value is not None \
            and key in _names_loaded(stmt.value):
        return True
    # assignment of the value into an attribute / subscript slot
    targets: list[ast.AST] = []
    value = None
    if isinstance(stmt, ast.Assign):
        targets, value = list(stmt.targets), stmt.value
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets, value = [stmt.target], getattr(stmt, "value", None)
    if value is not None and key in _names_loaded(value) and any(
            isinstance(t, (ast.Attribute, ast.Subscript)) for t in targets):
        return True
    for root in eval_roots(stmt):
        for sub in ast.walk(root):
            # placed in a literal container (incl. `return a, b` tuples,
            # machine dicts, argument lists built as literals)
            if isinstance(sub, (ast.Dict, ast.List, ast.Tuple, ast.Set)) \
                    and not isinstance(getattr(sub, "ctx", ast.Load()),
                                       ast.Store) \
                    and key in _names_loaded(sub):
                return True
            if isinstance(sub, ast.Lambda) and key in _names_loaded(sub.body):
                return True
            if isinstance(sub, ast.Yield) and sub.value is not None \
                    and key in _names_loaded(sub.value):
                return True
            if kind == "future" and isinstance(sub, ast.Call):
                # futures: passing the handle to any call shares/transfers
                for a in list(sub.args) + [kw.value for kw in sub.keywords]:
                    if isinstance(a, ast.Name) and a.id == key:
                        return True
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
            and any(key in _names_loaded(s) for s in stmt.body):
        return True
    return False


def _released_here(src, stmt: ast.stmt, site: _Site, keys: set[str],
                   revoking_only: bool = False) -> bool:
    """Does ``stmt`` perform a registered release of ``site`` (known under
    any name in ``keys``)?  ``revoking_only`` restricts to calls that
    actually revoke the handle (RES003's gen set): ``fut.result()``
    discharges the leak obligation but the future stays readable."""
    if site.kind == "lock":
        if site.key.split(".")[-1] in _transfer_names(src, stmt) \
                or site.key in _transfer_names(src, stmt):
            return True
        for root in eval_roots(stmt):
            for sub in ast.walk(root):
                if isinstance(sub, ast.Call) and _tail(sub) == "release" \
                        and _recv(sub) == site.key:
                    return True
        return False
    # `with f:` over an already-bound tracked resource: the context
    # manager guarantees the close on every path — a release
    if isinstance(stmt, (ast.With, ast.AsyncWith)) and any(
            isinstance(it.context_expr, ast.Name)
            and it.context_expr.id in keys for it in stmt.items):
        return True
    recv_tails = REVOKE_RECV_TAILS if revoking_only else RELEASE_RECV_TAILS
    arg_tails = ("release",) if revoking_only else RELEASE_ARG_TAILS
    for root in eval_roots(stmt):
        for sub in ast.walk(root):
            if not isinstance(sub, ast.Call):
                continue
            tail = _tail(sub)
            if tail in arg_tails:
                for a in list(sub.args) + [kw.value for kw in sub.keywords]:
                    if isinstance(a, ast.Name) and a.id in keys:
                        return True
            if tail in recv_tails \
                    and isinstance(sub.func, ast.Attribute) \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id in keys:
                return True
    return False


def _rebound_names(stmt: ast.stmt) -> set[str]:
    out: set[str] = set()
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    for t in targets:
        for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
            if isinstance(el, ast.Name):
                out.add(el.id)
    return out


def _alias_pair(stmt: ast.stmt) -> tuple[str, str] | None:
    """('new', 'old') for a simple ``new = old`` aliasing assignment."""
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name) \
            and isinstance(stmt.value, ast.Name):
        return stmt.targets[0].id, stmt.value.id
    return None


def _check_function(ctx: Context, src, fn) -> list[Finding]:
    in_with = _with_item_calls(fn)
    sites = _collect_sites(src, fn, in_with)
    if not sites:
        return []
    cfg = build_cfg(fn)
    path = ctx.display_path(src)
    by_stmt = sites                      # id(stmt) -> _Site
    site_ids = {id(s): s for s in sites.values()}

    # ---- RES001/RES002: may-analysis of outstanding obligations --------
    # state: frozenset of (site_token, bound_name)
    def flow(node, state):
        stmt = node.stmt
        if stmt is None:
            return {"*": state}
        # escape kills apply on NORMAL completion only (an exception means
        # the handoff did not happen); RELEASE kills apply on the exc edge
        # too — a release() that itself raises leaves the resource state
        # murky, and flagging it would demand try/finally around finally
        out = set(state)
        exc_out = set(state)
        keys_by_site: dict[int, set[str]] = {}
        for tok, key in state:
            keys_by_site.setdefault(tok, set()).add(key)
        for tok, keys in keys_by_site.items():
            site = site_ids[tok]
            released = _released_here(src, stmt, site, keys)
            if released:
                exc_out = {(t, k) for t, k in exc_out if t != tok}
            if released or any(
                    _escapes(src, stmt, k, site.kind) for k in keys
                    if site.kind != "lock"):
                out = {(t, k) for t, k in out if t != tok}
        rebound = _rebound_names(stmt)
        alias = _alias_pair(stmt)
        if rebound:
            out = {(t, k) for t, k in out if k not in rebound}
        if alias is not None:
            new, old = alias
            for t, k in list(out):
                if k == old:
                    out.add((t, new))
        got = by_stmt.get(id(stmt))
        none_guard = _none_test(stmt)
        outs: dict[str, object] = {"*": frozenset(out),
                                   "exc": frozenset(exc_out)}
        if got is not None:
            for kind in _gen_edges(stmt, got):
                base = outs.get(kind, outs["*"])
                outs[kind] = frozenset(set(base) | {(id(got), got.key)})
        if none_guard is not None:
            name, none_edge = none_guard
            # `if x is None:` — on the None edge the acquire failed and
            # there is nothing to release
            dead = {t for t, k in out if k == name}
            outs[none_edge] = frozenset(
                {(t, k) for t, k in out if t not in dead})
        return outs

    IN = solve_forward(cfg, frozenset(), flow, lambda a, b: a | b)
    out: list[Finding] = []
    norm = IN.get(cfg.exit, frozenset())
    exc = IN.get(cfg.raise_exit, frozenset())
    for site in sites.values():
        tok = id(site)
        on_norm = any(t == tok for t, _ in norm)
        on_exc = any(t == tok for t, _ in exc)
        if not (on_norm or on_exc):
            continue
        rule = "RES002" if site.kind == "lock" else "RES001"
        how = ("on an exception path — release it in a finally: "
               "(or switch to `with`)") if not on_norm else \
            "on a normal path (no release or ownership handoff reaches exit)"
        fix = ("annotate the handoff with `# lfkt: transfers[...] -- why` "
               "if ownership genuinely moves elsewhere")
        out.append(Finding(
            rule, path, site.line,
            f"{site.what} may leak {how}; {fix}"))

    # ---- RES003: must-analysis of definitely-released values -----------
    # findings are derived from the FINAL fixpoint states, never inside
    # the transfer: on a must-analysis the first visit of a node sees one
    # predecessor's over-approximate state, and a finding emitted there
    # would be order-dependent and unretractable
    def flow_rel(node, state):
        stmt = node.stmt
        if stmt is None:
            return {"*": state}
        new = set(state)
        rebound = _rebound_names(stmt)
        if rebound:
            new = {(t, k) for t, k in new if k not in rebound}
        got = by_stmt.get(id(stmt))
        if got is not None and got.kind != "lock":
            new = {(t, k) for t, k in new if t != id(got)}
        # a `with f:` / `with closing(f):` header DISCHARGES the leak
        # obligation (RES001) but the close only happens at with-EXIT —
        # body reads are fine, so it must not gen "released" here
        if not isinstance(stmt, (ast.With, ast.AsyncWith)):
            for tok, site in site_ids.items():
                if site.kind == "lock":
                    continue
                if _released_here(src, stmt, site, {site.key},
                                  revoking_only=True):
                    new.add((tok, site.key))
        return {"*": frozenset(new), "exc": state}

    IN_rel = solve_forward(cfg, frozenset(), flow_rel, lambda a, b: a & b)
    reported: set[tuple] = set()
    for node, state in IN_rel.items():
        stmt = node.stmt
        if stmt is None or not state:
            continue
        for tok, key in state:
            hit = any(
                isinstance(sub, ast.Name) and sub.id == key
                and isinstance(sub.ctx, ast.Load)
                for root in eval_roots(stmt) for sub in ast.walk(root))
            if hit:
                mark = ("RES003", path, stmt.lineno, tok)
                if mark not in reported:
                    reported.add(mark)
                    out.append(Finding(
                        "RES003", path, stmt.lineno,
                        f"{site_ids[tok].what} (released before this "
                        f"point on every path) is used here — "
                        f"use-after-release"))
    return out


def check(ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    for src in ctx.sources:
        path = ctx.display_path(src)
        # the transfers grammar is audited output exactly like noqa's:
        # a reason-less annotation still discharges (parallel to a
        # reason-less noqa still suppressing) but is itself a LINT000
        # finding — ownership-handoff claims must carry justification
        for lineno, line in enumerate(src.lines, start=1):
            m = _TRANSFERS_RE.search(line)
            if m is not None and not m.group(2):
                out.append(Finding(
                    "LINT000", path, lineno,
                    "transfers annotation without a reason: write "
                    "`# lfkt: transfers[<name>] -- why`"))
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(_check_function(ctx, src, node))
    return out

"""TAINT — interprocedural trust-boundary taint analysis (lfkt-lint v4).

The fleet's ingress surface is adversarial: the router proxies raw
client bytes, the page wire and the migration service parse peer JSON,
``POST /admin/models/reload`` accepts a manifest over the network.  One
provenance bug was fixed by hand (clients commanding KV pulls via forged
``x-lfkt-prior-owner`` copies); this checker makes the whole class
static.  It rides the package call graph (lint/callgraph.py) the
same way the concurrency rules do: per-function summaries with SYMBOLIC
taint (params, call results), then a whole-package fixpoint that binds
call sites to callee summaries — so a header read three frames up the
stack still reaches the ``connect()`` four calls down.

**Sources** (where attacker-reachable bytes enter)::

    http-request   raw request reads: asyncio reader tails
                   (readline/readexactly/readuntil), ``.headers``
                   reads, ``.json()``/``.body()`` call tails
    wire-frame     decoded page-wire frame headers (``recv_frame()``)
    peer-http      a peer's HTTP response (``getresponse()`` and
                   everything read off it) — /health docs above all
    manifest       ``ModelSpec.path``: the network-suppliable model
                   manifest (POST /admin/models/reload)

**Sinks** (where tainted bytes become authority):

- **TAINT001** network addresses (``connect``/``create_connection``/
  ``HTTPConnection``/``getaddrinfo``) and outbound header construction
  (an f-string containing a literal CR/LF with a tainted interpolation);
- **TAINT002** filesystem paths (``open``, ``os.path.join``, the
  ``os.*`` mutators) and subprocess argv;
- **TAINT003** log-record interpolation without the CR/LF-stripping
  sanitizer (``obs.logctx.sanitize_text`` — line-framed logs make an
  embedded newline a forged record).

**Declassification** is explicit: ``sanitize_text`` is the registered
sanitizer for the ``log``/``header`` sink classes; a containment guard
(``realpath`` + ``startswith``/``commonpath`` + raise) discharges the
``path`` class; a membership guard against an allowlist (``if addr not
in peers: return``) discharges ``addr``.  Everything else needs an
audited comment::

    # lfkt: sanitizes[<source>] -- reason

On a ``def`` line the function is declared a validator for that source:
findings inside it are discharged AND the source is dropped from its
return taint (callers trust its output).  On any other line it covers
that line only — a source read there, or a sink there, is audited.
A reasonless audit is LINT000; an unknown source name is LINT001 (the
suppression-grammar audit rules, which cannot themselves be
suppressed).

Deliberate limits (documented, not accidental): the per-function walk
is a single forward pass (no loop fixpoint), so the rebinding idiom
``msg = sanitize_text(msg)`` cleans everything after it; lambda bodies
are skipped (they run elsewhere); attribute STORES are not tracked
(``self.x = tainted`` does not taint later ``self.x`` reads) — the
registered TAINTED_ATTRS table covers the attrs that matter.
"""

from __future__ import annotations

import ast
import re

from .callgraph import build_graph
from .core import Context, Finding, Source, dotted

RULES = {
    "TAINT001": "attacker-tainted value reaches a network-address or "
                "outbound-header sink",
    "TAINT002": "attacker-tainted value reaches a filesystem-path or "
                "subprocess-argv sink",
    "TAINT003": "attacker-tainted value interpolated into a log record "
                "without the CR/LF-stripping sanitizer",
}

#: the declared source vocabulary — `sanitizes[...]` audits must name one
SOURCE_TAGS = ("http-request", "wire-frame", "peer-http", "manifest")

#: sink classes -> rule (header folds into TAINT001, argv into TAINT002)
SINK_RULES = {"addr": "TAINT001", "header": "TAINT001",
              "path": "TAINT002", "argv": "TAINT002", "log": "TAINT003"}
_ALL_CLASSES = frozenset(SINK_RULES)

#: call tails that MINT taint
SOURCE_TAILS = {
    "recv_frame": "wire-frame",
    "getresponse": "peer-http",
    "readline": "http-request",
    "readexactly": "http-request",
    "readuntil": "http-request",
    "json": "http-request",
    "body": "http-request",
}

#: (class name, attribute) -> source tag, for `self.attr` / typed-param
#: attribute reads
TAINTED_ATTRS = {("ModelSpec", "path"): "manifest"}

#: registered sanitizers: call tail -> sink classes it declassifies
SANITIZER_TAILS = {"sanitize_text": frozenset({"log", "header"})}

#: call tails whose result is clean regardless of argument taint (casts
#: that cannot carry bytes through, and digests — a hash of attacker
#: bytes is not attacker bytes)
_CLEAN_TAILS = frozenset({
    "int", "float", "bool", "len", "abs", "round", "hash", "id", "ord",
    "isinstance", "hasattr", "callable", "time", "monotonic",
    "sha256", "sha1", "md5", "digest", "hexdigest", "_sha",
})

_LOG_TAILS = frozenset({"debug", "info", "warning", "error", "exception",
                        "critical", "log"})
_ADDR_TAILS = frozenset({"create_connection", "HTTPConnection",
                         "getaddrinfo", "connect", "connect_ex"})
_OS_PATH_TAILS = frozenset({"remove", "replace", "rename", "makedirs",
                            "mkdir", "rmdir", "unlink", "listdir"})
_SUBPROCESS_TAILS = frozenset({"run", "Popen", "call", "check_call",
                               "check_output"})

_SANITIZES_RE = re.compile(
    r"#\s*lfkt:\s*sanitizes\[([A-Za-z0-9_,\s-]*)\]\s*(?:--\s*(\S.*))?")

#: interprocedural fixpoint bound — the lattice is finite (tags grow,
#: cleaned-sets shrink) so this is a backstop, not a semantics
_MAX_ITER = 40


# ---------------------------------------------------------------------------
# the sanitizes[] audit grammar (mirrors concurrency._Discharges)
# ---------------------------------------------------------------------------

class _Sanitizes:
    """Parsed ``sanitizes[...]`` audits for one source file: line ->
    source-tag set, plus def-spans declaring whole-function validators."""

    def __init__(self, src: Source):
        self.by_line: dict[int, set[str]] = {}
        self.reasonless: list[int] = []
        for i, line in enumerate(src.lines, start=1):
            m = _SANITIZES_RE.search(line)
            if m is None:
                continue
            names = {x.strip() for x in m.group(1).split(",") if x.strip()}
            self.by_line[i] = names
            if not m.group(2):
                self.reasonless.append(i)
        #: (def line, end line, tags) — SIGNATURE lines only, same
        #: grammar as blocks-under[]: def line = whole function
        self.def_spans: list[tuple[int, int, set[str]]] = []
        if self.by_line:
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    body_start = (node.body[0].lineno if node.body
                                  else node.lineno + 1)
                    for line in range(node.lineno, body_start):
                        names = self.by_line.get(line)
                        if names and node.end_lineno is not None:
                            self.def_spans.append(
                                (node.lineno, node.end_lineno, names))
                            break

    def covers(self, line: int, tag: str) -> bool:
        if tag in self.by_line.get(line, ()):
            return True
        return any(lo <= line <= hi and tag in names
                   for lo, hi, names in self.def_spans)

    def fn_tags(self, node) -> set[str]:
        """Tags a def-line audit declares for this exact function."""
        body_start = (node.body[0].lineno if node.body
                      else node.lineno + 1)
        out: set[str] = set()
        for line in range(node.lineno, body_start):
            out |= self.by_line.get(line, set())
        return out


# ---------------------------------------------------------------------------
# taint values: {atom -> frozenset(cleaned sink classes)}
#   atom = ("s", tag) | ("p", param index) | ("c", call site id)
# ---------------------------------------------------------------------------

def _join(a: dict, b: dict) -> dict:
    """Merge two taint values: atoms union, cleaned-sets intersect on
    collision (a value cleaned on only one inflow is not cleaned)."""
    if not a:
        return dict(b)
    if not b:
        return dict(a)
    out = dict(a)
    for atom, cleaned in b.items():
        cur = out.get(atom)
        out[atom] = cleaned if cur is None else (cur & cleaned)
    return out


def _clean_more(val: dict, classes: frozenset) -> dict:
    return {atom: cleaned | classes for atom, cleaned in val.items()}


def _ser_val(val: dict) -> list:
    return [[list(atom), sorted(cleaned)]
            for atom, cleaned in sorted(val.items(), key=lambda kv: str(kv))]


def _de_val(doc: list) -> dict:
    return {(a[0], a[1] if a[0] == "s" else int(a[1])): frozenset(c)
            for a, c in doc}


# ---------------------------------------------------------------------------
# per-function analysis
# ---------------------------------------------------------------------------

class _FnTaint:
    """One function's taint summary (symbolic; JSON round-trippable)."""

    __slots__ = ("key", "rel", "params", "calls", "ret", "sinks", "audited")

    def __init__(self, key, rel, params):
        self.key = key
        self.rel = rel
        self.params = params            # positional param names, in order
        #: call id -> (line, [callee keys], [arg vals], {kw: val}, attr?)
        self.calls: dict[int, tuple] = {}
        self.ret: dict = {}
        #: (sink class, line, desc, val)
        self.sinks: list[tuple] = []
        self.audited: set[str] = set()  # def-line sanitizes[] tags

    def to_doc(self) -> dict:
        return {
            "params": list(self.params),
            "calls": {str(cid): [line, [list(k) for k in keys],
                                 [_ser_val(v) for v in args],
                                 {k: _ser_val(v) for k, v in kw.items()},
                                 attr]
                      for cid, (line, keys, args, kw, attr)
                      in self.calls.items()},
            "ret": _ser_val(self.ret),
            "sinks": [[cls, line, desc, _ser_val(val)]
                      for cls, line, desc, val in self.sinks],
            "audited": sorted(self.audited),
        }

    @classmethod
    def from_doc(cls, key, rel, doc) -> "_FnTaint":
        s = cls(key, rel, doc["params"])
        s.calls = {int(cid): (line, [tuple(k) for k in keys],
                              [_de_val(v) for v in args],
                              {k: _de_val(v) for k, v in kw.items()},
                              bool(attr))
                   for cid, (line, keys, args, kw, attr)
                   in doc["calls"].items()}
        s.ret = _de_val(doc["ret"])
        s.sinks = [(cls_, int(line), desc, _de_val(val))
                   for cls_, line, desc, val in doc["sinks"]]
        s.audited = set(doc.get("audited", ()))
        return s


class _Analyzer:
    """The forward walk over one function body.  ``env`` maps local
    names to taint values; branches fork it and join after; nested defs
    are walked inline with a copy (closure taint) and separately as
    their own functions (findings dedup on (path, line, rule, tag))."""

    def __init__(self, graph, fn, audits: _Sanitizes):
        self.graph = graph
        self.fn = fn
        self.cls = graph.fn_class(fn)
        self.audits = audits
        args = fn.node.args
        self.params = [a.arg for a in args.posonlyargs + args.args]
        self.out = _FnTaint(fn.key, fn.src.rel, self.params)
        self.out.audited = audits.fn_tags(fn.node)
        self._next_call = 0
        #: path-sink records pending a containment-guard discharge:
        #: [target var | None, index into out.sinks]
        self._path_sinks: list[list] = []
        #: realpath/abspath derivation edges: derived var -> origin vars
        self._derived: dict[str, set[str]] = {}
        # annotated params resolve typed-receiver calls and TAINTED_ATTRS
        self._ann: dict[str, str] = {}
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if a.annotation is not None:
                d = dotted(a.annotation)
                if d is not None:
                    self._ann[a.arg] = d.split(".")[-1]

    # -- entry points ----------------------------------------------------
    def run(self) -> _FnTaint:
        env: dict[str, dict] = {}
        kwonly = [a.arg for a in self.fn.node.args.kwonlyargs]
        for i, name in enumerate(self.params + kwonly):
            if name in ("self", "cls"):
                continue
            env[name] = {("p", i): frozenset()}
        self._walk(self.fn.node.body, env)
        # undischarged path sinks stay; discharged ones were cleaned
        return self.out

    # -- expression evaluation -------------------------------------------
    def _src_atom(self, tag: str, line: int) -> dict:
        """A fresh source atom — fully declassified when the read line
        carries a `sanitizes[tag]` audit."""
        if self.audits.covers(line, tag) or tag in self.out.audited:
            return {("s", tag): frozenset(_ALL_CLASSES)}
        return {("s", tag): frozenset()}

    def _attr_source(self, node: ast.Attribute, env) -> dict | None:
        """TAINTED_ATTRS reads (`self.path` inside ModelSpec, or
        `spec.path` off an annotated param) and `.headers` reads."""
        base = node.value
        cname = None
        if isinstance(base, ast.Name):
            if base.id == "self" and self.fn.cls is not None:
                cname = self.fn.cls
            else:
                cname = self._ann.get(base.id)
        tag = TAINTED_ATTRS.get((cname, node.attr)) if cname else None
        if tag is not None:
            return self._src_atom(tag, node.lineno)
        if node.attr == "headers":
            # request.headers / self.headers: the HTTP header map —
            # reads off it carry client bytes
            return self._src_atom("http-request", node.lineno)
        return None

    def _ev(self, node, env) -> dict:
        if node is None or isinstance(node, (ast.Constant, ast.Lambda)):
            return {}
        if isinstance(node, ast.Name):
            return env.get(node.id, {})
        if isinstance(node, ast.Attribute):
            src = self._attr_source(node, env)
            if src is not None:
                return src
            return self._ev(node.value, env)
        if isinstance(node, ast.Await):
            return self._ev(node.value, env)
        if isinstance(node, ast.Call):
            return self._ev_call(node, env)
        if isinstance(node, ast.JoinedStr):
            return self._ev_fstring(node, env)
        if isinstance(node, ast.Compare):
            for sub in ast.iter_child_nodes(node):
                self._ev(sub, env)
            return {}       # a boolean carries no attacker bytes
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return {}
        # default: union over child expressions (tuples, dicts, binops,
        # comprehensions, subscripts, ...)
        out: dict = {}
        for child in ast.iter_child_nodes(node):
            out = _join(out, self._ev(child, env))
        return out

    def _ev_fstring(self, node: ast.JoinedStr, env) -> dict:
        out: dict = {}
        # header joins are CR/LF-framed; a bare "\n" f-string is terminal
        # or file output, which the log sink (not this one) covers
        has_crlf = any(isinstance(v, ast.Constant)
                       and isinstance(v.value, str)
                       and "\r" in v.value
                       for v in node.values)
        for v in node.values:
            if isinstance(v, ast.FormattedValue):
                t = self._ev(v.value, env)
                if has_crlf and t:
                    self._sink("header", node.lineno,
                               "CR/LF-joined f-string", t)
                out = _join(out, t)
        return out

    def _ev_call(self, call: ast.Call, env) -> dict:
        func = call.func
        d = dotted(func)
        tail = (func.attr if isinstance(func, ast.Attribute)
                else (d or ""))
        argvals = [self._ev(a, env) for a in call.args]
        kwvals = {kw.arg: self._ev(kw.value, env)
                  for kw in call.keywords if kw.arg is not None}
        for kw in call.keywords:
            if kw.arg is None:       # **kwargs splat
                argvals.append(self._ev(kw.value, env))
        recv = (self._ev(func.value, env)
                if isinstance(func, ast.Attribute) else {})
        everything = recv
        for v in argvals:
            everything = _join(everything, v)
        for v in kwvals.values():
            everything = _join(everything, v)

        # sources first: the call result IS the tainted object
        if tail in SOURCE_TAILS:
            return _join(self._src_atom(SOURCE_TAILS[tail], call.lineno),
                         recv)

        # registered sanitizers: propagate inner taint, cleaned
        san = SANITIZER_TAILS.get(tail)
        if san is not None:
            inner: dict = {}
            for v in argvals:
                inner = _join(inner, v)
            return _clean_more(inner, san)

        if tail in _CLEAN_TAILS:
            return {}

        callees, _recv_type, _exact = self.graph.resolve_call(
            self.fn, self.cls, {}, call)
        pkg_callees = [k for k in callees if k in self.graph.index.fns]
        if pkg_callees:
            cid = self._next_call
            self._next_call += 1
            self.out.calls[cid] = (
                call.lineno, pkg_callees, argvals, kwvals,
                isinstance(func, ast.Attribute))
            # a resolved call's result is its callees' (symbolic) return
            # taint; the receiver's own taint rides along (a method on a
            # tainted object usually hands back its bytes).  Sinks are
            # NOT checked here: the analysis follows the args into the
            # callee and reports at the real sink inside it.
            return _join({("c", cid): frozenset()}, recv)
        # unresolved: check sinks here, and conservatively the result
        # carries everything that went in (str(x), json.loads(x),
        # x.decode(), dict lookups, ...)
        self._check_sinks(call, d, tail, argvals, kwvals, env)
        return everything

    # -- sinks ------------------------------------------------------------
    def _sink(self, cls: str, line: int, desc: str, val: dict) -> None:
        if not val:
            return
        self.out.sinks.append((cls, line, desc, val))

    def _check_sinks(self, call, d, tail, argvals, kwvals, env) -> None:
        head = (d or "").split(".")[0]
        everything: dict = {}
        for v in argvals:
            everything = _join(everything, v)
        for v in kwvals.values():
            everything = _join(everything, v)

        if tail in _ADDR_TAILS:
            self._sink("addr", call.lineno, f"{d or '.' + tail}()",
                       everything)
        if head == "subprocess" and tail in _SUBPROCESS_TAILS:
            self._sink("argv", call.lineno, f"{d}()", everything)
        if d == "open" or d == "os.path.join" or (
                head == "os" and tail in _OS_PATH_TAILS):
            # path sinks remember their assignment target so a later
            # containment guard (realpath + startswith + raise) can
            # discharge them retroactively
            if everything:
                self.out.sinks.append(
                    ("path", call.lineno, f"{d}()", everything))
                self._path_sinks.append([None, len(self.out.sinks) - 1])
        if tail in _LOG_TAILS and (
                "logger" in head.lower() or head == "logging"
                or (isinstance(call.func, ast.Attribute)
                    and "logger" in (dotted(call.func.value) or "").lower())):
            self._sink("log", call.lineno, f"{d or '.' + tail}()",
                       everything)

    # -- statements --------------------------------------------------------
    def _walk(self, stmts, env) -> None:
        for stmt in stmts:
            self._stmt(stmt, env)

    def _assign_target(self, target, val, env) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = dict(val)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._assign_target(el, val, env)
        elif isinstance(target, ast.Starred):
            self._assign_target(target.value, val, env)
        # attribute / subscript stores: untracked (see module docstring)

    def _stmt(self, stmt, env) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # inline closure walk: the nested body sees the parent's
            # locals (build_head reading the enclosing handler's key);
            # its params are unknown here, hence clean
            inner = dict(env)
            for a in (stmt.args.posonlyargs + stmt.args.args
                      + stmt.args.kwonlyargs):
                inner.pop(a.arg, None)
            self._walk(stmt.body, inner)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is None:
                return
            before = len(self.out.sinks)
            val = self._ev(value, env)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if isinstance(stmt, ast.AugAssign):
                tname = (stmt.target.id
                         if isinstance(stmt.target, ast.Name) else None)
                if tname is not None:
                    env[tname] = _join(env.get(tname, {}), val)
                return
            for t in targets:
                self._assign_target(t, val, env)
            # bookkeeping for the containment-guard discharge
            if len(targets) == 1 and isinstance(targets[0], ast.Name):
                tname = targets[0].id
                for rec in self._path_sinks:
                    if rec[0] is None and rec[1] >= before:
                        rec[0] = tname
                if isinstance(value, ast.Call):
                    vd = dotted(value.func)
                    if vd in ("os.path.realpath", "os.path.abspath",
                              "os.path.normpath"):
                        names = {n.id for n in ast.walk(value)
                                 if isinstance(n, ast.Name)}
                        self._derived.setdefault(tname, set()).update(names)
            return
        if isinstance(stmt, ast.Return):
            self.out.ret = _join(self.out.ret, self._ev(stmt.value, env))
            return
        if isinstance(stmt, ast.Expr):
            self._ev(stmt.value, env)
            return
        if isinstance(stmt, ast.If):
            self._ev(stmt.test, env)
            terminates = any(isinstance(s, (ast.Return, ast.Raise,
                                            ast.Continue, ast.Break))
                             for s in stmt.body)
            self._guards(stmt, env, terminates)
            body_env = dict(env)
            self._in_guard(stmt.test, body_env)
            self._walk(stmt.body, body_env)
            else_env = dict(env)
            self._walk(stmt.orelse, else_env)
            merged = else_env if terminates else self._merge(body_env,
                                                             else_env)
            env.clear()
            env.update(merged)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self._ev(stmt.iter, env)
            body_env = dict(env)
            self._assign_target(stmt.target, it, body_env)
            self._walk(stmt.body, body_env)
            self._walk(stmt.orelse, body_env)
            merged = self._merge(env, body_env)
            env.clear()
            env.update(merged)
            return
        if isinstance(stmt, ast.While):
            self._ev(stmt.test, env)
            body_env = dict(env)
            self._walk(stmt.body, body_env)
            self._walk(stmt.orelse, body_env)
            merged = self._merge(env, body_env)
            env.clear()
            env.update(merged)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                v = self._ev(item.context_expr, env)
                if item.optional_vars is not None:
                    self._assign_target(item.optional_vars, v, env)
            self._walk(stmt.body, env)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, env)
            for h in stmt.handlers:
                h_env = dict(env)
                self._walk(h.body, h_env)
                merged = self._merge(env, h_env)
                env.clear()
                env.update(merged)
            self._walk(stmt.orelse, env)
            self._walk(stmt.finalbody, env)
            return
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self._ev(stmt.exc, env)
            return
        if isinstance(stmt, ast.Delete):
            return
        # anything else: evaluate child expressions for sink effects
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._ev(child, env)
            elif isinstance(child, ast.stmt):
                self._stmt(child, env)

    @staticmethod
    def _merge(a: dict, b: dict) -> dict:
        out = {}
        for name in set(a) | set(b):
            out[name] = _join(a.get(name, {}), b.get(name, {}))
        return out

    # -- guard-based declassification --------------------------------------
    def _in_guard(self, test, body_env) -> None:
        """`if x in allowed:` — inside the body, x is allowlisted for
        the addr class."""
        if isinstance(test, ast.Compare) \
                and isinstance(test.left, ast.Name) \
                and len(test.ops) == 1 and isinstance(test.ops[0], ast.In):
            name = test.left.id
            if name in body_env:
                body_env[name] = _clean_more(body_env[name],
                                             frozenset({"addr"}))

    def _guards(self, stmt: ast.If, env, terminates: bool) -> None:
        """Terminating guards declassify for the code AFTER the If:

        - `if x not in allowed: return/raise`  -> x allowlisted (addr);
        - `if not real.startswith(base): raise` (or commonpath) with
          `real = os.path.realpath(joined)` -> the path sink that
          produced `joined` is discharged, and the contained value's
          path class is cleaned for everything downstream.
        """
        if not terminates:
            return
        test = stmt.test
        # membership: x (or `str(x)`) on the LEFT of NotIn only — a
        # right-operand membership like `":" not in str(addr)` is a
        # shape check, not an allowlist, and must NOT launder
        comparisons = [test]
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            comparisons = [test.operand]
        for comp in comparisons:
            if isinstance(comp, ast.Compare) \
                    and isinstance(comp.left, ast.Name) \
                    and len(comp.ops) == 1 \
                    and isinstance(comp.ops[0], ast.NotIn):
                name = comp.left.id
                if name in env:
                    env[name] = _clean_more(env[name],
                                            frozenset({"addr"}))
        # containment: any startswith/commonpath reference in the test
        has_contain = any(
            (isinstance(n, ast.Attribute)
             and n.attr in ("startswith", "commonpath"))
            for n in ast.walk(test))
        if not has_contain:
            return
        names = {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}
        covered = set(names)
        for derived, origins in self._derived.items():
            if derived in names:
                covered |= origins
        for rec in self._path_sinks:
            var = rec[0]
            if var is not None and var in covered:
                cls, line, desc, val = self.out.sinks[rec[1]]
                self.out.sinks[rec[1]] = (
                    cls, line, desc, _clean_more(val, frozenset({"path"})))
                if var in env:
                    env[var] = _clean_more(env[var], frozenset({"path"}))


# ---------------------------------------------------------------------------
# package-level phase: summaries -> fixpoint -> findings
# ---------------------------------------------------------------------------

def _analyze_file(graph, src: Source, audits: _Sanitizes) -> dict:
    """qual -> summary doc for every function defined in one file."""
    out: dict = {}
    for key, fn in graph.index.fns.items():
        if fn.src is not src:
            continue
        s = _Analyzer(graph, fn, audits).run()
        # a def-line audit declares the function a validator: its ret no
        # longer carries the audited sources
        if s.audited:
            s.ret = {atom: cleaned for atom, cleaned in s.ret.items()
                     if not (atom[0] == "s" and atom[1] in s.audited)}
        out[key[1]] = s.to_doc()
    return out


def _rehydrate(per_file: dict, rel_to_module) -> dict:
    summaries: dict[tuple, _FnTaint] = {}
    for rel, fns in per_file.items():
        module = rel_to_module(rel)
        if module is None:
            continue
        for qual, doc in fns.items():
            s = _FnTaint.from_doc((module, qual), rel, doc)
            summaries[s.key] = s
    return summaries


def _resolve_val(val: dict, key, summaries, rets, paramin,
                 depth: int = 0) -> dict:
    """Concrete taint (tag -> cleaned) for a symbolic value in ``key``'s
    frame, under the current fixpoint state."""
    out: dict[str, frozenset] = {}

    def add(tag, cleaned):
        cur = out.get(tag)
        out[tag] = cleaned if cur is None else (cur & cleaned)

    for atom, cleaned in val.items():
        kind = atom[0]
        if kind == "s":
            add(atom[1], cleaned)
        elif kind == "p":
            for tag, c2 in paramin.get(key, {}).get(atom[1], {}).items():
                add(tag, c2 | cleaned)
        elif kind == "c" and depth < 8:
            s = summaries.get(key)
            if s is None:
                continue
            entry = s.calls.get(atom[1])
            if entry is None:
                continue
            for callee in entry[1]:
                for tag, c2 in rets.get(callee, {}).items():
                    add(tag, c2 | cleaned)
    return out


def _concrete_join(a: dict, b: dict) -> dict:
    out = dict(a)
    for tag, cleaned in b.items():
        cur = out.get(tag)
        out[tag] = cleaned if cur is None else (cur & cleaned)
    return out


def _fixpoint(summaries: dict) -> tuple[dict, dict]:
    """(rets, paramin): concrete return taint per function and concrete
    inbound taint per (function, param index), to fixpoint."""
    rets: dict[tuple, dict] = {}
    paramin: dict[tuple, dict[int, dict]] = {}
    for _ in range(_MAX_ITER):
        changed = False
        for key, s in sorted(summaries.items()):
            for cid, (line, callees, args, kwargs, attr_call) in \
                    sorted(s.calls.items()):
                for callee in callees:
                    cs = summaries.get(callee)
                    if cs is None:
                        continue
                    offset = (1 if attr_call and cs.params
                              and cs.params[0] in ("self", "cls") else 0)
                    slots = paramin.setdefault(callee, {})
                    for j, av in enumerate(args):
                        if not av:
                            continue
                        concrete = _resolve_val(av, key, summaries,
                                                rets, paramin)
                        if not concrete:
                            continue
                        idx = j + offset
                        cur = slots.get(idx, {})
                        new = _concrete_join(cur, concrete)
                        if new != cur:
                            slots[idx] = new
                            changed = True
                    for name, av in kwargs.items():
                        if not av or name not in cs.params:
                            continue
                        concrete = _resolve_val(av, key, summaries,
                                                rets, paramin)
                        if not concrete:
                            continue
                        idx = cs.params.index(name)
                        cur = slots.get(idx, {})
                        new = _concrete_join(cur, concrete)
                        if new != cur:
                            slots[idx] = new
                            changed = True
            new_ret = _resolve_val(s.ret, key, summaries, rets, paramin)
            if s.audited:
                new_ret = {t: c for t, c in new_ret.items()
                           if t not in s.audited}
            if new_ret != rets.get(key, {}):
                rets[key] = new_ret
                changed = True
        if not changed:
            break
    return rets, paramin


_SINK_HINTS = {
    "addr": "validate it against the admitted peer table (an `if x not "
            "in peers: return` guard), or audit with "
            "`# lfkt: sanitizes[{tag}] -- why`",
    "header": "pass it through obs.logctx.sanitize_text before header "
              "construction, or audit with "
              "`# lfkt: sanitizes[{tag}] -- why`",
    "path": "contain it under the trusted root (realpath + startswith "
            "+ raise — serving/manifest.py is the model), or audit "
            "with `# lfkt: sanitizes[{tag}] -- why`",
    "argv": "never splice network bytes into argv; audit with "
            "`# lfkt: sanitizes[{tag}] -- why` if the value is provably "
            "operator-controlled",
    "log": "pass it through obs.logctx.sanitize_text first, or audit "
           "with `# lfkt: sanitizes[{tag}] -- why`",
}


def check(ctx: Context) -> list[Finding]:
    graph = build_graph(ctx)
    audits = {src.rel: _Sanitizes(src) for src in ctx.sources}
    by_rel = {src.rel: src for src in ctx.sources}

    def dpath(rel: str) -> str:
        src = by_rel.get(rel)
        return ctx.display_path(src) if src is not None else rel

    out: list[Finding] = []

    # -- the sanitizes[] grammar audits itself (LINT000/LINT001) ----------
    for rel, a in sorted(audits.items()):
        for line in a.reasonless:
            out.append(Finding(
                "LINT000", dpath(rel), line,
                "sanitizes annotation without a reason: write "
                "`# lfkt: sanitizes[<source>] -- why`"))
        for line, names in sorted(a.by_line.items()):
            if not names:
                out.append(Finding(
                    "LINT001", dpath(rel), line,
                    "sanitizes annotation names no source"))
            for name in sorted(names):
                if name not in SOURCE_TAGS:
                    out.append(Finding(
                        "LINT001", dpath(rel), line,
                        f"sanitizes names unknown source {name!r} "
                        f"(declared sources: {', '.join(SOURCE_TAGS)})"))

    # -- per-file summaries (with the --changed cache) ---------------------
    module_of = {src.rel: ctx.module_name(src) for src in ctx.sources}
    inc = getattr(ctx, "lint_incremental", None)
    per_file: dict[str, dict] = {}
    if inc is None or inc.get("out") is None:
        for src in ctx.sources:
            per_file[src.rel] = _analyze_file(graph, src, audits[src.rel])
    else:
        # piggyback on the concurrency checker's cache protocol: same
        # digest guard (call RESOLUTION is shared), per-file sha match,
        # and a "taint" side-table next to its "summaries"
        from .concurrency import resolution_digest

        digest = resolution_digest(graph)
        cache = inc.get("cache") or {}
        cached_files = (cache.get("files", {})
                        if cache.get("digest") == digest else {})
        shas = inc["shas"]
        for src in ctx.sources:
            entry = cached_files.get(src.rel)
            if entry is not None and shas.get(src.rel) == entry.get("sha") \
                    and entry.get("taint") is not None:
                per_file[src.rel] = entry["taint"]
            else:
                per_file[src.rel] = _analyze_file(graph, src,
                                                  audits[src.rel])
        for rel, fns in per_file.items():
            slot = inc["out"]["files"].get(rel)
            if slot is not None:
                slot["taint"] = fns

    summaries = _rehydrate(per_file, module_of.get)

    # -- the interprocedural fixpoint and the findings ---------------------
    rets, paramin = _fixpoint(summaries)
    seen: set[tuple] = set()
    for key, s in sorted(summaries.items()):
        a = audits.get(s.rel)
        for cls, line, desc, val in s.sinks:
            concrete = _resolve_val(val, key, summaries, rets, paramin)
            for tag in sorted(concrete):
                if cls in concrete[tag]:
                    continue            # declassified for this class
                if tag in s.audited:
                    continue            # the function is a validator
                if a is not None and a.covers(line, tag):
                    continue            # line-level audit at the sink
                rule = SINK_RULES[cls]
                mark = (s.rel, line, rule, tag)
                if mark in seen:
                    continue
                seen.add(mark)
                hint = _SINK_HINTS[cls].format(tag=tag)
                out.append(Finding(
                    rule, dpath(s.rel), line,
                    f"tainted value (source: {tag}) reaches "
                    f"{'log sink' if cls == 'log' else cls + ' sink'} "
                    f"{desc} in {key[1]} — {hint}"))
    return out

"""Whole-package interprocedural call graph — the lfkt-lint v3 substrate.

The capture checker's index (lint/graph.py ``_Index``) resolves calls by
simple name, ``self.method()`` and package imports — enough for "is this
reachable from a graph capture", not enough for concurrency questions like
"does the fleet router's proxy loop ever join a thread on the event
loop".  This module extends that edge builder with the three resolution
layers the concurrency rules (lint/concurrency.py LOCK005/006,
ASY001/002) need:

- **receiver types** — ``self._conn = FrameConn(sock)`` /
  ``sender = FrameSender(conn)`` / module-level ``FAULTS =
  FaultInjector()`` bind an attribute, local or module global to a
  package class; ``self._lock = threading.Lock()`` (and Queue /
  Condition / Event / Thread / Semaphore) binds it to a stdlib
  concurrency type, which both classifies blocking method calls
  (``q.get()``, ``thread.join()``) and feeds the lock inventory;
- **conservative method resolution** — ``x.m()`` with an untyped
  receiver resolves to EVERY package class defining ``m``, unless ``m``
  collides with a builtin container/str/bytes method name (``.get()``
  is almost always a dict; smearing every dict read into
  ``FlightRecorder.get`` would drown the rules).  Over-approximation is
  the family trade: a false edge costs a written audit, a missing edge
  costs silence — the builtin-name carve-out is the one deliberate
  under-approximation;
- **the lock inventory** — every ``threading.Lock/RLock/Condition``
  assigned to a ``self.<attr>`` (resolved base-first over the
  in-package MRO, so subclasses share the base's lock identity) or a
  module-level name.  Lock identities are ``module.Class.attr`` /
  ``module.NAME`` — two classes' ``_lock`` attrs are distinct locks.

Call EDGES (as opposed to the capture checker's reference reachability) are
actual invocations only: a function passed as an argument
(``Thread(target=f)``, ``asyncio.to_thread(f)``, ``executor.submit(f)``)
is NOT an edge — the first two are exactly the sanctioned "move the
blocking work off this thread" idioms, and conflating them with calls
would flag the fix as the bug.  An ``await f()`` of a package coroutine
is an ``await`` edge (it runs on the caller's task), and a bare ``f()``
of a coroutine from ASYNC code counts the same (it is almost always
handed straight to ``create_task``/``_spawn`` onto the same loop); a
bare ``f()`` of a coroutine from sync code is dropped (the coroutine
object is created, not run, and the lint cannot know which loop
eventually runs it).  A call site whose by-name fan-out mixes sync and
async candidates is split into one edge of each kind, so a blocking
sync candidate is never hidden behind an await edge.

Nothing here imports torch or jax or executes analyzed code (core.py
contract).
"""

from __future__ import annotations

import ast

from .core import Context, Source, dotted, self_attr
from .graph import _Fn, _Index
from .locks import _HOLDS_RE

__all__ = ["CallGraph", "CallSite", "FnFacts", "build_graph"]

#: threading-module constructor tails -> receiver type tag
_THREADING_TYPES = {
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
    "Event": "event", "Semaphore": "semaphore",
    "BoundedSemaphore": "semaphore", "Thread": "thread",
}
#: queue-module constructor tails (any alias of the queue module; the
#: asyncio twins are awaited and never classify as blocking)
_QUEUE_TYPES = ("Queue", "LifoQueue", "PriorityQueue", "SimpleQueue")

#: tracked lock kinds (held-region analysis + the LOCK005 graph).
#: Semaphores/events are deliberately NOT mutual exclusion — holding a
#: permit while blocking is the admission pattern, not a lock hazard.
LOCK_KINDS = ("lock", "rlock", "condition")

def _builtin_methods() -> frozenset:
    """Method names of builtin containers, str/bytes, files, loggers,
    threads/locks/queues and asyncio streams — never resolved by name
    (an untyped ``.get()`` is almost always a dict, an untyped
    ``.write()`` a file or asyncio writer; smearing those into package
    classes would mint phantom edges everywhere).  This is the one
    deliberate under-approximation in the resolution stack — typed
    receivers (``sender = FrameSender(conn)``) still resolve these
    names precisely."""
    import io
    import logging
    import queue
    import threading

    out = set()
    for t in (dict, list, tuple, set, frozenset, str, bytes, bytearray,
              io.IOBase, io.RawIOBase, io.BufferedIOBase, io.TextIOBase,
              logging.Logger, threading.Thread, threading.Event,
              queue.Queue):
        out.update(n for n in dir(t) if not n.startswith("__"))
    # asyncio StreamWriter/StreamReader surface (not imported: asyncio
    # pulls in a lot at import time for no extra coverage)
    out.update(("drain", "wait_closed", "is_closing", "get_extra_info",
                "read", "readline", "readexactly", "readuntil", "at_eof",
                "write", "writelines", "close", "abort", "can_write_eof",
                "write_eof", "transport"))
    return frozenset(out)


#: see :func:`_builtin_methods`
_BUILTIN_METHODS = _builtin_methods()

#: call tails that defer their function-valued arguments to another
#: thread/loop — arguments are never call edges anywhere, but these are
#: listed so concurrency.py can name the sanctioned hop in its messages
DEFER_TAILS = frozenset({"to_thread", "run_in_executor", "submit",
                         "call_soon_threadsafe", "start"})


class CallSite:
    """One resolved invocation inside a function body."""

    __slots__ = ("line", "callees", "held", "kind", "desc", "exact")

    def __init__(self, line: int, callees: list[tuple], held: frozenset,
                 kind: str, desc: str, exact: bool):
        self.line = line
        self.callees = callees      # [(module, qualname), ...]
        self.held = held            # frozenset of lock ids held here
        self.kind = kind            # "sync" | "await"
        self.desc = desc            # rendered call text for messages
        #: resolution was unique/typed.  Ambiguous by-name fan-outs
        #: still propagate MAY-BLOCK (a false edge costs an audit) but
        #: are excluded from the LOCK005 lock graph (a false edge there
        #: mints an unfixable phantom deadlock) — lint/concurrency.py
        self.exact = exact


class FnFacts:
    """Per-function raw facts the summaries are computed from."""

    __slots__ = ("key", "is_async", "direct_blocks", "acquires", "calls",
                 "asserted")

    def __init__(self, key: tuple, is_async: bool):
        self.key = key
        self.is_async = is_async
        #: [(line, reason, held frozenset)]
        self.direct_blocks: list[tuple] = []
        #: [(lock_id, line, held-before frozenset)]
        self.acquires: list[tuple] = []
        self.calls: list[CallSite] = []
        #: lock ids a `# lfkt: holds[..]` marker asserts held throughout
        self.asserted: frozenset = frozenset()


class _Class:
    """One class's resolution surface: methods, attr types, lock attrs."""

    __slots__ = ("key", "name", "module", "node", "src", "bases",
                 "methods", "attr_types", "declared")

    def __init__(self, src: Source, module: str, node: ast.ClassDef):
        self.key = (module, node.name)
        self.name = node.name
        self.module = module
        self.node = node
        self.src = src
        self.bases = [b.split(".")[-1] for b in
                      (dotted(base) for base in node.bases) if b]
        self.methods: dict[str, tuple] = {}      # name -> fn key
        self.attr_types: dict[str, object] = {}  # attr -> tag | _Class key
        self.declared = any(
            isinstance(s, ast.Assign) and len(s.targets) == 1
            and isinstance(s.targets[0], ast.Name)
            and s.targets[0].id in ("_GUARDED_BY", "_THREAD_ENTRIES")
            for s in node.body)


def _ctor_tag(call: ast.Call, graph: "CallGraph", module: str):
    """Type of ``<ctor>(...)``: a stdlib tag string, a package class key,
    or None."""
    d = dotted(call.func)
    if d is not None:
        parts = d.split(".")
        head, tail = parts[0], parts[-1]
        if tail in _THREADING_TYPES and head != "asyncio":
            return _THREADING_TYPES[tail]
        if tail in _QUEUE_TYPES and head != "asyncio":
            return "queue"
        if d in ("socket.socket", "socket.create_connection"):
            return "socket"
    # package class constructor (unique simple name across the package)
    if d is not None:
        simple = d.split(".")[-1]
        hits = graph.classes_by_name.get(simple, [])
        if len(hits) == 1:
            return hits[0].key
    return None


class CallGraph:
    """The package-wide resolution surface (see module docstring)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.index = _Index(ctx)
        self.classes: dict[tuple, _Class] = {}
        self.classes_by_name: dict[str, list[_Class]] = {}
        #: method name -> [fn keys] over ALL package classes (the
        #: conservative fallback domain)
        self.methods_by_name: dict[str, list[tuple]] = {}
        #: module -> {global var -> type (tag or class key)}
        self.module_types: dict[str, dict[str, object]] = {}
        #: lock id -> kind ("lock"|"rlock"|"condition")
        self.locks: dict[str, str] = {}
        self._collect_classes()
        self._infer_types()
        #: filled by :meth:`extract_facts` — kept separate from
        #: construction so the --changed cache can skip unchanged files'
        #: extraction (the expensive phase) while the resolution surface
        #: above is always current
        self.facts: dict[tuple, FnFacts] = {}

    def extract_facts(self, skip_rels: frozenset | set = frozenset()
                      ) -> None:
        for key, fn in self.index.fns.items():
            if fn.src.rel in skip_rels:
                continue
            self.facts[key] = self._extract(fn)

    # -- class + type collection ----------------------------------------
    def _collect_classes(self) -> None:
        for src in self.ctx.sources:
            module = self.ctx.module_name(src)
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                cls = _Class(src, module, node)
                self.classes[cls.key] = cls
                self.classes_by_name.setdefault(cls.name, []).append(cls)
        # method tables come from the capture index (it already walked defs)
        for module, by_cls in self.index.methods.items():
            for cname, methods in by_cls.items():
                cls = self.classes.get((module, cname))
                for mname, key in methods.items():
                    if cls is not None:
                        cls.methods[mname] = key
                    self.methods_by_name.setdefault(mname, []).append(key)

    def _mro(self, cls: _Class) -> list[_Class]:
        """Base-first chain over in-package single inheritance."""
        seen = {cls.key}
        chain: list[_Class] = []

        def add(c: _Class) -> None:
            for base in c.bases:
                hits = self.classes_by_name.get(base, [])
                if len(hits) == 1 and hits[0].key not in seen:
                    seen.add(hits[0].key)
                    add(hits[0])
                    chain.append(hits[0])

        add(cls)
        chain.append(cls)
        return chain

    def _infer_types(self) -> None:
        for src in self.ctx.sources:
            module = self.ctx.module_name(src)
            mt = self.module_types.setdefault(module, {})
            for stmt in src.tree.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and isinstance(stmt.value, ast.Call):
                    tag = _ctor_tag(stmt.value, self, module)
                    if tag is not None:
                        mt[stmt.targets[0].id] = tag
        for cls in self.classes.values():
            for node in ast.walk(cls.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.value, ast.Call):
                    attr = self_attr(node.targets[0])
                    if attr is not None:
                        tag = _ctor_tag(node.value, self, cls.module)
                        if tag is not None:
                            cls.attr_types.setdefault(attr, tag)
        # lock inventory: attr locks resolve base-first over the MRO so a
        # subclass's `with self._lock:` names the DEFINING class's lock
        for cls in self.classes.values():
            for attr, tag in cls.attr_types.items():
                if tag in LOCK_KINDS:
                    self.locks[f"{cls.module}.{cls.name}.{attr}"] = tag
        for module, mt in self.module_types.items():
            for var, tag in mt.items():
                if tag in LOCK_KINDS:
                    self.locks[f"{module}.{var}"] = tag

    # -- type / lock lookup ----------------------------------------------
    def attr_type(self, cls: _Class, attr: str):
        for c in reversed(self._mro(cls)):
            if attr in c.attr_types:
                return c.attr_types[attr]
        return None

    def lock_id(self, cls: _Class | None, module: str,
                expr: ast.AST) -> str | None:
        """Lock identity of ``self.<attr>`` / module-level ``<name>``
        when it is a tracked lock, else None."""
        attr = self_attr(expr)
        if attr is not None and cls is not None:
            for c in self._mro(cls):
                if c.attr_types.get(attr) in LOCK_KINDS:
                    return f"{c.module}.{c.name}.{attr}"
            return None
        if isinstance(expr, ast.Name):
            if self.module_types.get(module, {}).get(expr.id) in LOCK_KINDS:
                return f"{module}.{expr.id}"
        return None

    def lock_short(self, lock_id: str) -> str:
        """The attr/name part annotations use (``_lock``)."""
        return lock_id.rsplit(".", 1)[-1]

    def known_lock_names(self) -> set[str]:
        return {self.lock_short(lk) for lk in self.locks}

    def fn_class(self, fn: _Fn) -> _Class | None:
        if fn.cls is None:
            return None
        return self.classes.get((fn.module, fn.cls))

    # -- call resolution --------------------------------------------------
    def _recv_type(self, fn: _Fn, cls: _Class | None,
                   local_types: dict[str, object], recv: ast.AST):
        attr = self_attr(recv)
        if attr is not None and cls is not None:
            return self.attr_type(cls, attr)
        if isinstance(recv, ast.Name):
            if recv.id in local_types:
                return local_types[recv.id]
            mt = self.module_types.get(fn.module, {})
            if recv.id in mt:
                return mt[recv.id]
            # `from ..utils.faults import FAULTS` — imported instance
            for imp in self.index.imports.get(fn.module, {}) \
                    .get(recv.id, []):
                if imp[0] == "name":
                    t = self.module_types.get(imp[1], {}).get(imp[2])
                    if t is not None:
                        return t
        return None

    def resolve_call(self, fn: _Fn, cls: _Class | None,
                     local_types: dict[str, object],
                     call: ast.Call) -> tuple[list[tuple], object, bool]:
        """(callee keys, receiver type, exact) for one Call node —
        ``exact`` is False only for the conservative all-classes by-name
        fan-out (see :class:`CallSite`)."""
        func = call.func
        got = self.index.resolve(fn.module, func, scope=fn)
        if got:
            return list(dict.fromkeys(got)), None, True
        if isinstance(func, ast.Attribute):
            rt = self._recv_type(fn, cls, local_types, func.value)
            if isinstance(rt, tuple):            # package class instance
                target = self.classes.get(rt)
                if target is not None:
                    for c in reversed(self._mro(target)):
                        if func.attr in c.methods:
                            return [c.methods[func.attr]], rt, True
                return [], rt, True
            if isinstance(rt, str):              # stdlib concurrency type
                return [], rt, True
            # conservative fallback: every package class defining the
            # method, unless the name collides with builtin containers
            if func.attr not in _BUILTIN_METHODS:
                keys = list(dict.fromkeys(
                    self.methods_by_name.get(func.attr, [])))
                return keys, None, len(keys) <= 1
        return [], None, True

    # -- per-function fact extraction -------------------------------------
    def _extract(self, fn: _Fn) -> FnFacts:
        cls = self.fn_class(fn)
        facts = FnFacts(fn.key, isinstance(fn.node, ast.AsyncFunctionDef))
        facts.asserted = self._asserted(fn, cls)

        # local receiver types: annotated params (`sender: FrameSender`),
        # `x = Ctor(...)` constructions and `x = self.attr` aliases
        local_types: dict[str, object] = {}
        args = fn.node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + [x for x in (args.vararg, args.kwarg) if x]):
            if a.annotation is not None:
                d = dotted(a.annotation)
                if d is not None:
                    hits = self.classes_by_name.get(d.split(".")[-1], [])
                    if len(hits) == 1:
                        local_types[a.arg] = hits[0].key
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                if isinstance(node.value, ast.Call):
                    tag = _ctor_tag(node.value, self, fn.module)
                    if tag is not None:
                        local_types[node.targets[0].id] = tag
                else:
                    attr = self_attr(node.value)
                    if attr is not None and cls is not None:
                        t = self.attr_type(cls, attr)
                        if t is not None:
                            local_types[node.targets[0].id] = t

        # walk the fn's OWN body (nested defs are their own functions),
        # tracking the held-lock set through with-blocks
        def visit(node: ast.AST, held: frozenset, awaited: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn.node:
                return
            if isinstance(node, ast.Lambda):
                return      # a lambda body runs at CALL time, elsewhere
            if isinstance(node, (ast.With, ast.AsyncWith)):
                add = set()
                for item in node.items:
                    lk = self.lock_id(cls, fn.module, item.context_expr)
                    if lk is not None:
                        add.add(lk)
                        facts.acquires.append(
                            (lk, item.context_expr.lineno,
                             held | facts.asserted))
                    visit(item.context_expr, held, awaited)
                inner = held | frozenset(add)
                for item in node.items:
                    if item.optional_vars is not None:
                        visit(item.optional_vars, inner, awaited)
                for child in node.body:
                    visit(child, inner, awaited)
                return
            if isinstance(node, ast.Await):
                visit(node.value, held, True)
                return
            if isinstance(node, ast.Call):
                self._classify_call(fn, cls, local_types, facts, node,
                                    held | facts.asserted, awaited)
                awaited = False     # only the outermost call is awaited
            for child in ast.iter_child_nodes(node):
                visit(child, held, awaited)

        for stmt in fn.node.body:
            visit(stmt, frozenset(), False)
        return facts

    def _asserted(self, fn: _Fn, cls: _Class | None) -> frozenset:
        """Lock ids a def-line ``# lfkt: holds[..]`` marker asserts."""
        node = fn.node
        body_start = node.body[0].lineno if node.body else node.lineno
        out = set()
        for line in fn.src.lines[node.lineno - 1: body_start]:
            for name in _HOLDS_RE.findall(line):
                if cls is not None:
                    for c in self._mro(cls):
                        if c.attr_types.get(name) in LOCK_KINDS:
                            out.add(f"{c.module}.{c.name}.{name}")
                            break
        return frozenset(out)

    def _classify_call(self, fn: _Fn, cls, local_types, facts: FnFacts,
                       call: ast.Call, held: frozenset,
                       awaited: bool) -> None:
        d = dotted(call.func)
        desc = (d or ("." + call.func.attr
                      if isinstance(call.func, ast.Attribute) else "<call>"))
        callees, recv_type, exact = self.resolve_call(
            fn, cls, local_types, call)

        # bare lock.acquire() / release() regions: treat a direct
        # .acquire() on a tracked lock as an acquire event (the RES002
        # rule owns the release-on-every-path question)
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "acquire":
            lk = self.lock_id(cls, fn.module, call.func.value)
            if lk is not None:
                facts.acquires.append((lk, call.lineno, held))
                return

        if not awaited:
            reason = self._block_reason(call, d, recv_type)
            if reason is not None:
                facts.direct_blocks.append((call.lineno, reason, held))

        if callees:
            # an ambiguous by-name fan-out may mix sync and async
            # candidates — they get SEPARATE call sites so a blocking
            # sync candidate is never hidden behind an await edge (the
            # rule fixpoints follow sync and await edges differently)
            sync_keys, await_keys = [], []
            for key in callees:
                target = self.index.fns.get(key)
                if target is None:
                    continue
                if isinstance(target.node, ast.AsyncFunctionDef):
                    if facts.is_async:
                        # awaited, or created-in-async-context: a bare
                        # coroutine call inside an async def is almost
                        # always handed to create_task/_spawn onto the
                        # SAME loop, so it rides the await fixpoint too
                        await_keys.append(key)
                    # sync caller of an async def: coroutine created, not
                    # run — no edge (see module docstring)
                elif not awaited:
                    sync_keys.append(key)
            if sync_keys:
                facts.calls.append(CallSite(
                    call.lineno, sync_keys, held, "sync", desc, exact))
            if await_keys:
                facts.calls.append(CallSite(
                    call.lineno, await_keys, held, "await", desc, exact))

    @staticmethod
    def _block_reason(call: ast.Call, d: str | None,
                      recv_type) -> str | None:
        """Why this (non-awaited) call may block, or None."""
        if d is not None:
            parts = d.split(".")
            head, tail = parts[0], parts[-1]
            if d == "time.sleep":
                return "time.sleep"
            if head == "subprocess" and tail in (
                    "run", "Popen", "call", "check_call", "check_output"):
                return f"subprocess ({d})"
            if d in ("socket.create_connection", "socket.getaddrinfo"):
                return f"socket I/O ({d})"
            if d == "open":
                return "file I/O (open)"
            if d in ("os.fsync", "os.listdir", "os.remove", "os.replace",
                     "os.makedirs", "os.rename", "os.stat",
                     "os.path.getsize"):
                return f"file I/O ({d})"
            if len(parts) > 1 and tail in ("block_until_ready",
                                           "device_get", "synchronize"):
                return f"device sync ({tail})"
            if d == "sorted":
                # the fragmentation-scan lesson: an O(n log n) scan
                # is "blocking" exactly when something else is queued on
                # the lock it runs under — classified for LOCK006 only
                # (concurrency.py ignores it for the ASY family: sorting
                # on the event loop is ordinary CPU work)
                return "O(n log n) scan (sorted)"
        if isinstance(call.func, ast.Attribute):
            tail = call.func.attr
            if tail == "item" and not call.args:
                return "device sync (.item())"
            if tail == "synchronize":
                return "device sync (.synchronize())"
            if tail in ("recv", "recv_into", "sendall", "accept",
                        "getresponse", "makefile", "request"):
                return f"socket I/O (.{tail}())"
            if recv_type == "queue" and tail in ("get", "put", "join"):
                return f"blocking queue .{tail}()"
            if recv_type in ("condition", "event") \
                    and tail in ("wait", "wait_for"):
                return f"{recv_type} .{tail}()"
            if recv_type == "thread" and tail == "join":
                return "thread join"
            if recv_type == "socket" and tail in ("connect", "send",
                                                  "recv", "accept"):
                return f"socket I/O (.{tail}())"
        return None


def build_graph(ctx: Context) -> CallGraph:
    """One CallGraph per lint pass: concurrency and taint both ride the
    resolution surface, and building it twice would double the dominant
    cost of a whole-package run — so the graph memoizes on the Context.
    ``extract_facts`` stays idempotent-per-caller (facts accumulate per
    key), so sharing is safe across checkers."""
    graph = getattr(ctx, "_lint_callgraph", None)
    if graph is None:
        graph = CallGraph(ctx)
        ctx._lint_callgraph = graph
    return graph

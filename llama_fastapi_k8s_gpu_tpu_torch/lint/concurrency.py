"""LOCK005/LOCK006 + ASY001/ASY002: interprocedural concurrency rules.

The intraprocedural families (LOCK001-004, RES, PIN) check protocols one
function at a time; reviews kept hand-finding the same two
INTERprocedural shapes — blocking work reachable while a lock is held
(the KVPool fragmentation scan), and blocking calls stalling the asyncio
serving loop (the /debug/incidents disk reads).  This module
computes per-function summaries over the whole-package call graph
(lint/callgraph.py) and runs three rule families on them:

- **LOCK005** — lock-order cycles.  Every ``with self._a:`` that
  (transitively) reaches an acquire of ``_b`` contributes a held→acquired
  edge ``a → b``; a cycle in that graph is a potential deadlock, and the
  finding carries a witness call path for EVERY edge of the cycle.  A
  self-edge on a
  non-reentrant lock (re-acquire while held) is a one-lock cycle.
- **LOCK006** — a may-block call (socket/file I/O, ``time.sleep``,
  blocking queue/condition waits, subprocess, device syncs
  (``.item()``, ``.synchronize()``), the disagg ``FrameSender`` bounded
  put — and a ``sorted()`` scan) reachable while a tracked lock is held.  Deliberate
  hold-and-block sites are discharged by the audited grammar
  ``# lfkt: blocks-under[<lock>] -- reason`` (mirroring ``transfers[]``:
  reason-less → LINT000, unknown lock name → LINT001); on a ``def`` line
  it covers the function, elsewhere its own line.
- **ASY001/ASY002** — a may-block call reachable from an ``async def``
  body without an ``asyncio.to_thread``/executor hop (the hop is
  invisible to these rules by construction: deferred arguments are not
  call edges).  ASY001 follows sync call chains from the coroutine body;
  ASY002 flags an ``await`` of a package coroutine that itself
  transitively blocks.  ``sorted()`` is NOT in the ASY classification —
  CPU work on the loop is ordinary; it only matters under a lock.

Blocking propagates over sync call edges only: a function whose blocking
runs on its own thread (``Thread(target=...)``, ``executor.submit``,
``asyncio.to_thread``) never taints its spawner, because an argument
reference is not a call edge.  Resolution over-approximates (docstring
of lint/callgraph.py) — a false edge costs a written audit, a missing
edge costs silence.

Summaries are (de)serializable: ``python -m
llama_fastapi_k8s_gpu_tpu_torch.lint --changed`` reuses a cached
whole-package pass for files `git diff` doesn't name (lint/__main__.py),
re-deriving only changed files — the finding set is identical to a full
run by construction (pinned by tests/test_torch_lint.py).
"""

from __future__ import annotations

import re

from .callgraph import CallGraph, build_graph
from .core import Context, Finding, Source

RULES = {
    "LOCK005": "lock-order cycle across the package (potential deadlock)",
    "LOCK006": "may-block call reachable while a lock is held",
    "ASY001": "may-block call reachable from an async def without an "
              "asyncio.to_thread/executor hop",
    "ASY002": "await of a coroutine that transitively blocks",
}

#: ``# lfkt: blocks-under[<lock>, ...] -- reason`` — the audited
#: discharge for deliberate hold-and-block sites (LOCK006).  Angle
#: brackets here keep this very comment from parsing as an annotation.
_BLOCKS_UNDER_RE = re.compile(
    r"#\s*lfkt:\s*blocks-under\[([\w,\s]*)\]\s*(?:--\s*(\S.*))?")

#: cap on rendered witness-chain hops (the full chain exists; messages
#: stay readable)
_MAX_CHAIN = 4


# ---------------------------------------------------------------------------
# per-file summaries (the serializable unit of the --changed cache)
# ---------------------------------------------------------------------------

def summarize(graph: CallGraph) -> dict[str, dict]:
    """rel-path -> {qualname -> summary dict} over the whole package.
    Summary dicts are JSON-serializable (the --changed cache contract)."""
    out: dict[str, dict] = {}
    for key, facts in graph.facts.items():
        fn = graph.index.fns[key]
        rel = fn.src.rel
        out.setdefault(rel, {})[key[1]] = {
            "module": key[0],
            "qual": key[1],
            "is_async": facts.is_async,
            "direct_blocks": [
                [line, reason, sorted(held)]
                for line, reason, held in facts.direct_blocks],
            "acquires": [
                [lock, line, sorted(held)]
                for lock, line, held in facts.acquires],
            "calls": [
                [c.line, [list(k) for k in c.callees], sorted(c.held),
                 c.kind, c.desc, c.exact]
                for c in facts.calls],
            "asserted": sorted(facts.asserted),
        }
    return out


def resolution_digest(graph: CallGraph) -> str:
    """Fingerprint of everything call RESOLUTION depends on beyond a
    file's own text: the symbol tables, class methods, receiver types
    and the lock inventory.  A --changed pass may only reuse cached
    summaries while this digest matches — an added/renamed
    function/class anywhere can change how an UNCHANGED file's calls
    resolve."""
    import hashlib
    import json

    doc = {
        "fns": sorted(f"{m}:{q}" for m, q in graph.index.fns),
        "methods": {name: sorted(f"{m}:{q}" for m, q in keys)
                    for name, keys in sorted(graph.methods_by_name.items())},
        "locks": dict(sorted(graph.locks.items())),
        "types": {f"{c.module}.{c.name}": {
            a: (list(t) if isinstance(t, tuple) else t)
            for a, t in sorted(c.attr_types.items())}
            for c in graph.classes.values()},
        # module-level instance bindings (`FAULTS = FaultInjector()`):
        # cross-file receiver resolution reads these, so rebinding one
        # must invalidate every cached summary that resolved through it
        "module_types": {m: {k: (list(t) if isinstance(t, tuple) else t)
                             for k, t in sorted(mt.items())}
                         for m, mt in sorted(graph.module_types.items())
                         if mt},
        "imports": {m: {k: sorted(map(str, v)) for k, v in sorted(t.items())}
                    for m, t in sorted(graph.index.imports.items())},
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


class _Summary:
    """One function's summary, whichever side of the cache it came from."""

    __slots__ = ("key", "rel", "is_async", "direct_blocks", "acquires",
                 "calls", "asserted")

    def __init__(self, rel: str, doc: dict):
        self.key = (doc["module"], doc["qual"])
        self.rel = rel
        self.is_async = bool(doc["is_async"])
        self.direct_blocks = [
            (int(line), reason, frozenset(held))
            for line, reason, held in doc["direct_blocks"]]
        self.acquires = [
            (lock, int(line), frozenset(held))
            for lock, line, held in doc["acquires"]]
        self.calls = [
            (int(line), [tuple(k) for k in keys], frozenset(held),
             kind, desc, bool(exact))
            for line, keys, held, kind, desc, exact in doc["calls"]]
        self.asserted = frozenset(doc.get("asserted", ()))


# ---------------------------------------------------------------------------
# fixpoints over the summary set
# ---------------------------------------------------------------------------

def _is_cpu_scan(entry: tuple) -> bool:
    """The ``sorted()`` classification counts only under a lock: LOCK006
    consumes it, the ASY family filters it (CPU work on the event loop
    is ordinary)."""
    return entry[0].startswith("O(n log n)")


def _sync_blocks(summaries: dict[tuple, _Summary]) -> dict[tuple, tuple]:
    """key -> (reason, chain) for functions that may block through SYNC
    call edges (their own body or a sync callee's).  ``chain`` is a list
    of rendered hops ending at the blocking operation.  ``sorted()``
    scans PROPAGATE like every other reason — a fragmentation
    scan factored into a one-level helper must still fire LOCK006 at the
    locked call site — but a genuine blocking reason always wins over a
    scan-only one, so the ASY rules (which filter scans) never lose a
    real finding behind one."""
    blocks: dict[tuple, tuple] = {}
    for key, s in sorted(summaries.items()):
        best = None
        for line, reason, _held in s.direct_blocks:
            entry = (reason, [f"{reason} at {s.rel}:{line}"])
            if not _is_cpu_scan(entry):
                best = entry
                break
            if best is None:
                best = entry
        if best is not None:
            blocks[key] = best
    changed = True
    while changed:
        changed = False
        for key, s in sorted(summaries.items()):
            cur = blocks.get(key)
            if cur is not None and not _is_cpu_scan(cur):
                continue        # already carries a genuine reason
            for line, callees, _held, kind, desc, _exact in s.calls:
                if kind != "sync":
                    continue
                hits = [c for c in callees if c in blocks]
                hit = next((c for c in hits
                            if not _is_cpu_scan(blocks[c])),
                           hits[0] if hits else None)
                if hit is None:
                    continue
                entry = blocks[hit]
                if cur is None or (_is_cpu_scan(cur)
                                   and not _is_cpu_scan(entry)):
                    reason, chain = entry
                    cur = (reason, [f"{desc}() at {s.rel}:{line}"]
                           + chain[:_MAX_CHAIN])
                    blocks[key] = cur
                    changed = True
                if not _is_cpu_scan(cur):
                    break
    return blocks


def _trans_acquires(summaries: dict[tuple, _Summary]
                    ) -> dict[tuple, dict[str, list]]:
    """key -> {lock id -> witness chain} of locks a call to this function
    may (transitively) acquire — await edges included: an awaited
    coroutine runs on the caller's task."""
    acq: dict[tuple, dict[str, list]] = {}
    for key, s in sorted(summaries.items()):
        mine: dict[str, list] = {}
        for lock, line, _held in s.acquires:
            mine.setdefault(lock, [f"acquires {lock} at {s.rel}:{line}"])
        if mine:
            acq[key] = mine
    changed = True
    while changed:
        changed = False
        for key, s in sorted(summaries.items()):
            mine = acq.setdefault(key, {})
            for line, callees, _held, _kind, desc, exact in s.calls:
                if not exact:
                    continue
                for c in callees:
                    for lock, chain in acq.get(c, {}).items():
                        if lock not in mine:
                            mine[lock] = ([f"{desc}() at {s.rel}:{line}"]
                                          + chain[:_MAX_CHAIN])
                            changed = True
            if not mine:
                acq.pop(key, None)
    return acq


def _coro_blocks(summaries: dict[tuple, _Summary],
                 blocks: dict[tuple, tuple]) -> dict[tuple, tuple]:
    """Async functions that block on their own task: sync-blocking, or
    awaiting a coroutine that does (transitively)."""
    out = {k: v for k, v in blocks.items()
           if k in summaries and summaries[k].is_async
           and not _is_cpu_scan(v)}   # scans on the loop are ordinary CPU
    changed = True
    while changed:
        changed = False
        for key, s in sorted(summaries.items()):
            if not s.is_async or key in out:
                continue
            for line, callees, _held, kind, desc, _exact in s.calls:
                if kind != "await":
                    continue
                hit = next((c for c in callees if c in out), None)
                if hit is not None:
                    reason, chain = out[hit]
                    out[key] = (reason,
                                [f"await {desc}() at {s.rel}:{line}"]
                                + chain[:_MAX_CHAIN])
                    changed = True
                    break
    return out


# ---------------------------------------------------------------------------
# the blocks-under[] discharge grammar
# ---------------------------------------------------------------------------

class _Discharges:
    """Parsed ``blocks-under[...]`` annotations for one source file:
    line -> lock-name set, plus def-spans covering whole functions."""

    def __init__(self, src: Source):
        import ast as _ast

        self.by_line: dict[int, set[str]] = {}
        self.reasonless: list[int] = []
        for i, line in enumerate(src.lines, start=1):
            m = _BLOCKS_UNDER_RE.search(line)
            if m is None:
                continue
            names = {x.strip() for x in m.group(1).split(",") if x.strip()}
            self.by_line[i] = names
            if not m.group(2):
                self.reasonless.append(i)
        self.def_spans: list[tuple[int, int, set[str]]] = []
        if self.by_line:
            for node in _ast.walk(src.tree):
                if isinstance(node, (_ast.FunctionDef,
                                     _ast.AsyncFunctionDef)):
                    # SIGNATURE lines only (exclusive of the first
                    # body line): the documented grammar is def-line =
                    # whole function, anywhere else = that line only —
                    # an annotation on the first body statement must not
                    # silently discharge the rest of the function
                    body_start = (node.body[0].lineno if node.body
                                  else node.lineno + 1)
                    for line in range(node.lineno, body_start):
                        names = self.by_line.get(line)
                        if names and node.end_lineno is not None:
                            self.def_spans.append(
                                (node.lineno, node.end_lineno, names))
                            break

    def covers(self, line: int, lock_short: str) -> bool:
        if lock_short in self.by_line.get(line, ()):
            return True
        return any(lo <= line <= hi and lock_short in names
                   for lo, hi, names in self.def_spans)

    def all_names(self):
        for names in self.by_line.values():
            yield from names


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

def _shorten(chain: list[str]) -> str:
    if len(chain) > _MAX_CHAIN + 1:
        chain = chain[:_MAX_CHAIN] + ["..."] + chain[-1:]
    return " -> ".join(chain)


def _lock_cycles(edges: dict[tuple[str, str], tuple]) -> list[list[str]]:
    """Simple cycles in the held→acquired lock graph, canonicalized
    (rotated to the smallest lock id, deduplicated).  Self-edges are
    one-lock cycles."""
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: set[tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: list[str],
            on_path: set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                lo = path.index(min(path))
                cycles.add(tuple(path[lo:] + path[:lo]))
            elif nxt not in on_path and nxt > start and len(path) < 6:
                # only explore nodes > start: each cycle is found once,
                # from its smallest member
                on_path.add(nxt)
                dfs(start, nxt, path + [nxt], on_path)
                on_path.discard(nxt)

    for a, b in sorted(edges):
        if a == b:
            cycles.add((a,))
    for start in sorted(graph):
        dfs(start, start, [start], {start})
    return [list(c) for c in sorted(cycles)]


def check_summaries(ctx: Context, graph: CallGraph,
                    summaries: dict[tuple, _Summary]) -> list[Finding]:
    blocks = _sync_blocks(summaries)
    acq = _trans_acquires(summaries)
    coro = _coro_blocks(summaries, blocks)
    by_rel = {s.rel: s for s in ctx.sources}
    discharges = {rel: _Discharges(src) for rel, src in by_rel.items()}
    rlocks = {lk for lk, kind in graph.locks.items() if kind == "rlock"}
    known_lock_names = graph.known_lock_names()
    out: list[Finding] = []

    def dpath(rel: str) -> str:
        src = by_rel.get(rel)
        return ctx.display_path(src) if src is not None else rel

    # -- the blocks-under grammar audits itself (LINT000/LINT001) --------
    for rel, d in sorted(discharges.items()):
        for line in d.reasonless:
            out.append(Finding(
                "LINT000", dpath(rel), line,
                "blocks-under annotation without a reason: write "
                "`# lfkt: blocks-under[<lock>] -- why`"))
        for line, names in sorted(d.by_line.items()):
            if not names:
                out.append(Finding(
                    "LINT001", dpath(rel), line,
                    "blocks-under annotation names no lock"))
            for name in sorted(names):
                if name not in known_lock_names:
                    out.append(Finding(
                        "LINT001", dpath(rel), line,
                        f"blocks-under names unknown lock {name!r} "
                        "(no threading.Lock/RLock/Condition attribute by "
                        "that name exists in the package)"))

    # -- LOCK005: the held→acquired graph and its cycles ------------------
    # edge (held, acquired) -> (rel, line, witness chain)
    edges: dict[tuple[str, str], tuple] = {}
    for key, s in sorted(summaries.items()):
        for lock, line, held in s.acquires:
            for h in sorted(held):
                if h == lock and lock in rlocks:
                    continue        # re-entrant by construction
                edges.setdefault(
                    (h, lock),
                    (s.rel, line,
                     [f"{key[1]} holds {h} and acquires {lock} "
                      f"at {s.rel}:{line}"]))
        for line, callees, held, _kind, desc, exact in s.calls:
            if not held or not exact:
                continue
            for c in callees:
                for lock, chain in acq.get(c, {}).items():
                    for h in sorted(held):
                        if h == lock and lock in rlocks:
                            continue
                        edges.setdefault(
                            (h, lock),
                            (s.rel, line,
                             [f"{key[1]} holds {h}, calls "
                              f"{desc}() at {s.rel}:{line}"]
                             + chain[:_MAX_CHAIN]))
    for cycle in _lock_cycles(edges):
        ring = cycle + cycle[:1] if len(cycle) > 1 else cycle * 2
        legs = []
        anchor = None
        for a, b in zip(ring, ring[1:]):
            rel, line, chain = edges[(a, b)]
            if anchor is None:
                anchor = (rel, line)
            legs.append(f"{a} -> {b} [{_shorten(chain)}]")
        out.append(Finding(
            "LOCK005", dpath(anchor[0]), anchor[1],
            ("lock re-acquired while held (one-lock cycle): "
             if len(cycle) == 1 else
             f"lock-order cycle over {len(cycle)} locks: ")
            + "; ".join(legs)))

    # -- LOCK006: may-block while a lock is held --------------------------
    seen006: set[tuple] = set()
    for key, s in sorted(summaries.items()):
        d = discharges.get(s.rel)
        for line, reason, held in s.direct_blocks:
            for h in sorted(held):
                if h in s.asserted:
                    # the lock is a caller's (`# lfkt: holds[..]`): the
                    # finding lands at the call site that actually TOOK
                    # it, where the fix (or the audit) belongs
                    continue
                short = graph.lock_short(h)
                if d is not None and d.covers(line, short):
                    continue
                mark = (s.rel, line, h)
                if mark not in seen006:
                    seen006.add(mark)
                    out.append(Finding(
                        "LOCK006", dpath(s.rel), line,
                        f"{key[1]} does {reason} while holding {h} — "
                        "move the blocking work outside the lock "
                        "(copy-then-release), or audit with "
                        f"`# lfkt: blocks-under[{short}] -- why`"))
        for line, callees, held, kind, desc, _exact in s.calls:
            if not held or kind != "sync":
                continue
            hit = next((c for c in callees if c in blocks), None)
            if hit is None:
                continue
            reason, chain = blocks[hit]
            for h in sorted(held):
                if h in s.asserted:
                    continue    # reported at the lock-taking call site
                short = graph.lock_short(h)
                if d is not None and d.covers(line, short):
                    continue
                mark = (s.rel, line, h)
                if mark not in seen006:
                    seen006.add(mark)
                    out.append(Finding(
                        "LOCK006", dpath(s.rel), line,
                        f"{key[1]} holds {h} across a call that may "
                        f"block ({reason}): {_shorten([f'{desc}()'] + chain)}"
                        " — move it outside the lock, or audit with "
                        f"`# lfkt: blocks-under[{short}] -- why`"))

    # -- ASY001/ASY002: blocking on the event loop ------------------------
    seen_asy: set[tuple] = set()
    for key, s in sorted(summaries.items()):
        if not s.is_async:
            continue
        for line, reason, _held in s.direct_blocks:
            if reason.startswith("O(n log n)"):
                continue
            mark = ("ASY001", s.rel, line)
            if mark not in seen_asy:
                seen_asy.add(mark)
                out.append(Finding(
                    "ASY001", dpath(s.rel), line,
                    f"async {key[1]} does {reason} on the event loop — "
                    "hop it off with `await asyncio.to_thread(...)` (or "
                    "an executor)"))
        for line, callees, _held, kind, desc, _exact in s.calls:
            if kind == "sync":
                hit = next((c for c in callees if c in blocks
                            and not _is_cpu_scan(blocks[c])), None)
                if hit is None:
                    continue
                reason, chain = blocks[hit]
                mark = ("ASY001", s.rel, line)
                if mark not in seen_asy:
                    seen_asy.add(mark)
                    out.append(Finding(
                        "ASY001", dpath(s.rel), line,
                        f"async {key[1]} calls {desc}() which may block "
                        f"({reason}) on the event loop: "
                        f"{_shorten(chain)} — hop it off with "
                        "`await asyncio.to_thread(...)` (or an executor)"))
            else:   # await edge
                hit = next((c for c in callees if c in coro), None)
                if hit is None:
                    continue
                reason, chain = coro[hit]
                mark = ("ASY002", s.rel, line)
                if mark not in seen_asy:
                    seen_asy.add(mark)
                    out.append(Finding(
                        "ASY002", dpath(s.rel), line,
                        f"async {key[1]} awaits {desc}() which "
                        f"transitively blocks ({reason}): "
                        f"{_shorten(chain)} — the awaited coroutine "
                        "needs the to_thread/executor hop"))
    return out


def check(ctx: Context) -> list[Finding]:
    """Full pass, or — when lint/__main__.py armed ``ctx.lint_incremental``
    (the ``--changed`` mode) — a pass that re-derives summaries only for
    files whose content hash moved since the cached whole-package run.
    The rule families always run over the COMPLETE summary set, so the
    finding set equals a full run's by construction."""
    graph = build_graph(ctx)
    inc = getattr(ctx, "lint_incremental", None)
    if inc is None:
        graph.extract_facts()
        per_file = summarize(graph)
    else:
        digest = resolution_digest(graph)
        cache = inc.get("cache") or {}
        cached_files = (cache.get("files", {})
                        if cache.get("digest") == digest else {})
        shas = inc["shas"]          # rel -> current content sha
        reuse = {rel: entry for rel, entry in cached_files.items()
                 if shas.get(rel) == entry.get("sha")}
        graph.extract_facts(skip_rels=set(reuse))
        per_file = summarize(graph)
        for rel, entry in reuse.items():
            per_file.setdefault(rel, entry["summaries"])
        inc["reused"] = sorted(reuse)
        inc["out"] = {
            "digest": digest,
            "files": {rel: {"sha": shas[rel], "summaries": fns}
                      for rel, fns in per_file.items() if rel in shas},
        }
    summaries: dict[tuple, _Summary] = {}
    for rel, fns in per_file.items():
        for doc in fns.values():
            s = _Summary(rel, doc)
            summaries[s.key] = s
    return check_summaries(ctx, graph, summaries)

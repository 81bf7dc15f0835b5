"""Request-scoped span trees: the tracer behind ``/debug/traces``.

The JAX package's tracer (llama_fastapi_k8s_gpu_tpu/obs/trace.py): per
sampled request, a span tree over the serving path — httpd read, queue
wait, the engine's prefill and each decode chunk, the SSE write — with
watchdog trips, health transitions and fault injections attached as
events, kept in a bounded ring.  Stdlib only.

- **Zero cost when sampled out**: :meth:`Tracer.start` returns ``None``
  and every producer guards with ``if trace is not None``; the decode
  loop then pays one ``is None`` test per *chunk*.  Nothing here runs
  inside a captured CUDA graph: spans are opened and closed in the host
  loop around the replays.
- **Thread-safe for sampled requests**: a trace is written by the handler
  coroutine, the engine's worker thread and (for events) the watchdog
  thread; each trace carries its own small lock.
- **W3C trace-context interop**: a ``traceparent`` request header is
  ingested (its trace id becomes this trace's id) and a ``traceparent``
  for the request's root span is exported on the response.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from collections import OrderedDict, deque

#: hard ceiling on spans+events per trace: a runaway generation must not
#: grow one trace without bound (past it, drops are counted, not stored)
MAX_NODES_PER_TRACE = 512

_TRACEPARENT_VERSION = "00"


def _new_trace_id() -> str:
    return uuid.uuid4().hex                      # 32 lowercase hex chars


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]                 # 16 lowercase hex chars


def parse_traceparent(value: str | None) -> tuple[str, str] | None:
    """(trace_id, parent_span_id) from a W3C ``traceparent`` header, or
    None when absent/malformed (a bad header must never fail a request —
    it just starts a fresh trace)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4 or parts[0] != _TRACEPARENT_VERSION:
        return None
    trace_id, span_id = parts[1].lower(), parts[2].lower()
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
    except ValueError:
        return None
    return trace_id, span_id


def span_traceparent(span: "Span | Trace | None") -> str | None:
    """The W3C ``traceparent`` naming ``span`` (or a trace's root span) as
    the parent — the stamp an outbound hop carries so the far side's span
    tree links under this node.  None for a sampled-out ``None``."""
    if span is None:
        return None
    if isinstance(span, Trace):
        return span.traceparent()
    return (f"{_TRACEPARENT_VERSION}-{span._trace.trace_id}"
            f"-{span.span_id}-01")


class Span:
    """One timed phase of a request.  Built by :meth:`Trace.span` /
    :meth:`Span.child`; closed with :meth:`end` (idempotent)."""

    __slots__ = ("name", "span_id", "t0", "t1", "attrs", "events",
                 "children", "_trace")

    def __init__(self, name: str, trace: "Trace", t0: float | None = None):
        self.name = name
        self.span_id = _new_span_id()
        self.t0 = time.time() if t0 is None else t0
        self.t1: float | None = None
        self.attrs: dict = {}
        self.events: list[dict] = []
        self.children: list[Span] = []
        self._trace = trace

    # -- producer API -------------------------------------------------------
    def child(self, name: str, t0: float | None = None) -> "Span":
        sp = Span(name, self._trace, t0=t0)
        tr = self._trace
        with tr._lock:
            if tr._nodes < MAX_NODES_PER_TRACE:
                tr._nodes += 1
                self.children.append(sp)
            else:
                tr._dropped += 1
        return sp

    def set(self, **attrs) -> "Span":
        tr = self._trace
        with tr._lock:
            self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        tr = self._trace
        with tr._lock:
            if tr._nodes < MAX_NODES_PER_TRACE:
                tr._nodes += 1
                self.events.append(
                    {"name": name, "at": time.time(), **attrs})
            else:
                tr._dropped += 1

    def end(self, t1: float | None = None) -> None:
        if self.t1 is None:
            self.t1 = time.time() if t1 is None else t1

    # -- export -------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "start": self.t0,
            "end": self.t1,
            "duration_s": (self.t1 - self.t0) if self.t1 is not None else None,
            "attrs": dict(self.attrs),
            "events": list(self.events),
            "children": [c.to_dict() for c in self.children],
        }


class Trace:
    """One request's span tree plus the live metadata ``/debug/requests``
    snapshots (engine, lane, deadline, tokens so far)."""

    __slots__ = ("trace_id", "parent_span_id", "root", "meta",
                 "_lock", "_nodes", "_dropped", "finished")

    def __init__(self, name: str = "request",
                 traceparent: str | None = None,
                 t0: float | None = None):
        ingested = parse_traceparent(traceparent)
        if ingested is not None:
            self.trace_id, self.parent_span_id = ingested
        else:
            self.trace_id, self.parent_span_id = _new_trace_id(), None
        self._lock = threading.Lock()
        self._nodes = 1
        self._dropped = 0
        self.finished = False
        self.root = Span(name, self, t0=t0)
        #: live request metadata, overwritten in place (cheap single-key
        #: stores) — NOT part of the span tree
        self.meta: dict = {}

    # -- producer API -------------------------------------------------------
    def span(self, name: str, t0: float | None = None) -> Span:
        return self.root.child(name, t0=t0)

    def event(self, name: str, **attrs) -> None:
        self.root.event(name, **attrs)

    def note(self, **meta) -> None:
        """Update the live ``/debug/requests`` metadata (engine, lane,
        deadline, tokens...).  Single dict stores; no span allocation."""
        with self._lock:
            self.meta.update(meta)

    def traceparent(self) -> str:
        """A W3C traceparent naming this trace's root span (propagation)."""
        return (f"{_TRACEPARENT_VERSION}-{self.trace_id}"
                f"-{self.root.span_id}-01")

    # -- export -------------------------------------------------------------
    def to_dict(self) -> dict:
        with self._lock:
            d = {
                "trace_id": self.trace_id,
                "parent_span_id": self.parent_span_id,
                "finished": self.finished,
                "dropped_nodes": self._dropped,
                "meta": dict(self.meta),
                "root": self.root.to_dict(),
            }
        return d

    def summary(self) -> dict:
        r = self.root
        with self._lock:
            return {
                "trace_id": self.trace_id,
                "name": r.name,
                "start": r.t0,
                "duration_s": (r.t1 - r.t0) if r.t1 is not None else None,
                "finished": self.finished,
                "spans": self._nodes,
                "meta": dict(self.meta),
            }

    def _close_open_spans(self) -> None:
        """End every still-open span at the root's end time, stamped
        ``auto_closed`` — error paths (a prefill that raised, a scheduler
        that died mid-admission) must not export half-open spans that
        waterfall tools render as still-running phases."""
        t1 = self.root.t1
        with self._lock:
            stack = [self.root]
            while stack:
                s = stack.pop()
                if s.t1 is None:
                    s.t1 = t1
                    s.attrs.setdefault("auto_closed", True)
                stack.extend(s.children)


class Tracer:
    """Sampling decision + in-flight registry + bounded completed-trace ring.

    ``sample`` (LFKT_TRACE_SAMPLE): fraction of requests traced — 1.0
    traces everything, 0 disarms the tracer entirely (``start`` returns
    None before taking any lock).  Sampling is deterministic-by-counter so
    a 0.25 sample traces exactly every 4th request (testable, no RNG).
    ``ring`` (LFKT_TRACE_RING): completed traces kept for /debug/traces.
    """

    # start/finish run on the event loop; annotate_inflight on watchdog/
    # health threads; /debug reads on the loop — all table access is
    # lock-guarded.  _armed is a single bool read on the hot path.

    def __init__(self, sample: float | None = None, ring: int | None = None):
        if sample is None or ring is None:
            from ..utils.config import get_settings

            settings = get_settings()
            if sample is None:
                sample = settings.trace_sample
            if ring is None:
                ring = settings.trace_ring
        self.sample = max(0.0, min(1.0, float(sample)))
        self.ring = max(1, int(ring))
        self._lock = threading.Lock()
        self._ring: deque[Trace] = deque(maxlen=self.ring)
        self._inflight: OrderedDict[str, Trace] = OrderedDict()
        self._count = 0
        self.started_total = 0
        self.sampled_out_total = 0
        #: the hot-path guard: False means start() returns None without
        #: touching the lock and annotate_inflight is a no-op
        self._armed = self.sample > 0.0
        with _REGISTRY_LOCK:
            # process-wide event fan-in (annotate_all_inflight): watchdog/
            # health/fault events reach EVERY live tracer's in-flight
            # traces, including private instances tests hand to create_app
            _TRACERS.add(self)

    # -- lifecycle ----------------------------------------------------------
    def start(self, name: str = "request",
              traceparent: str | None = None,
              t0: float | None = None) -> Trace | None:
        """Begin a trace for one request, or None when sampled out."""
        if not self._armed:
            return None
        with self._lock:
            self._count += 1
            if self.sample < 1.0:
                # deterministic counter sampling: trace request i iff the
                # integral of the rate crosses an integer at i
                if int(self._count * self.sample) == int(
                        (self._count - 1) * self.sample):
                    self.sampled_out_total += 1
                    return None
            tr = Trace(name, traceparent=traceparent, t0=t0)
            self.started_total += 1
            self._inflight[tr.trace_id] = tr
        return tr

    def finish(self, trace: Trace | None) -> None:
        """Close a trace's root span and move it to the ring (idempotent;
        None-tolerant so callers never need their own sampled-out guard).
        Any span a producer's error path left open is swept closed at the
        root's end time (``auto_closed``)."""
        if trace is None:
            return
        trace.root.end()
        with self._lock:
            if trace.finished:
                return
            trace.finished = True
            self._inflight.pop(trace.trace_id, None)
            self._ring.append(trace)
        trace._close_open_spans()

    # -- global event fan-in (watchdog / health / faults) --------------------
    def annotate_inflight(self, name: str, **attrs) -> None:
        """Attach an event to every in-flight trace: watchdog trips,
        health transitions and fault injections are process-level facts
        that explain whatever requests they overlapped."""
        if not self._armed:
            return
        with self._lock:
            traces = list(self._inflight.values())
        for tr in traces:
            tr.event(name, **attrs)

    # -- /debug reads -------------------------------------------------------
    def get(self, trace_id: str) -> Trace | None:
        with self._lock:
            tr = self._inflight.get(trace_id)
            if tr is not None:
                return tr
            for t in self._ring:
                if t.trace_id == trace_id:
                    return t
        return None

    def traces(self) -> list[dict]:
        """Newest-first summaries of the completed ring."""
        with self._lock:
            ring = list(self._ring)
        return [t.summary() for t in reversed(ring)]

    def inflight(self) -> list[dict]:
        """Live-request snapshot for /debug/requests."""
        now = time.time()
        with self._lock:
            traces = list(self._inflight.values())
        out = []
        for t in traces:
            meta = dict(t.meta)
            deadline = meta.pop("deadline", None)
            out.append({
                "trace_id": t.trace_id,
                "name": t.root.name,
                "age_s": now - t.root.t0,
                "deadline_remaining_s":
                    (deadline - now) if deadline is not None else None,
                **meta,
            })
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "sample": self.sample,
                "ring": self.ring,
                "ring_used": len(self._ring),
                "inflight": len(self._inflight),
                "started_total": self.started_total,
                "sampled_out_total": self.sampled_out_total,
            }


#: every live Tracer, for the process-level event fan-in; weak so a
#: test's discarded private tracer does not outlive its test
_REGISTRY_LOCK = threading.Lock()
_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def annotate_all_inflight(name: str, **attrs) -> None:
    """Attach an event to every in-flight trace of EVERY live tracer —
    the watchdog/health/fault fan-in.  Process-level facts must reach
    private tracers too (create_app(tracer=...)), not just the module
    default; each tracer's own ``_armed`` guard keeps this free when
    tracing is off."""
    with _REGISTRY_LOCK:
        tracers = list(_TRACERS)
    for t in tracers:
        t.annotate_inflight(name, **attrs)


def all_inflight_trees(limit: int = 32) -> list[dict]:
    """The span trees of every in-flight trace of every live tracer, at
    most ``limit`` — the incident recorder's capture (obs/flightrec.py)."""
    with _REGISTRY_LOCK:
        tracers = list(_TRACERS)
    out: list[dict] = []
    for t in tracers:
        with t._lock:
            traces = list(t._inflight.values())
        for tr in traces:
            out.append(tr.to_dict())
            if len(out) >= limit:
                return out
    return out


#: process-wide default tracer the serving stack shares: the server starts
#: traces on it (unless create_app was handed a private instance), engines
#: attach spans to the handed-down Trace objects, and the watchdog/health/
#: fault layers annotate whatever is in flight across all live tracers.
#: Built from the env knobs at import.
TRACER = Tracer()

"""Capture and dispatch attribution: the program registry.

The JAX package's registry (llama_fastapi_k8s_gpu_tpu/obs/devtime.py):
what did this pod compile, when, how often, and is it recompiling.  The
port has no ``jit``, so its programs and compiles are these:

- **Host programs** (the reference's ``timed_jit`` entry points):
  ``prefill``, ``prefill_chunk``, ``first_sample`` and ``decode_chunk``,
  counted by the engine at each call (engine/engine.py).  A call is one
  dispatch; a decode chunk is one dispatch however many graph replays it
  runs, as the reference's chunk is one call of its jitted scan.
- **A compile is a CUDA-graph capture.**  ``DecodeGraphs.capture``
  (models/generate.py) records one compile of ``decode_chunk`` with the
  signature ``top_k=<k>`` (the graph's static shape) and its wall time; a
  re-capture after eviction counts again, under a signature already seen.
  Prompt passes run eagerly and compile nothing, so ``prefill``,
  ``prefill_chunk`` and ``first_sample`` have dispatches and no compiles,
  and on the CPU (no graphs) nothing compiles at all.
- **The kernel build** (utils/kernelcache.py ``_build``) is the program
  ``kernel_build``: one compile event a build, its signature the sources'
  digest, its wall the build's; a library found built records none.
- **Inner programs** (the reference's ``register_program`` sites): every
  kernel wrapper of ``ops.KERNELS``, registered by name; its dispatches
  are the wrapper's launch counter, read at snapshot time.

A program whose set of distinct signatures grows past
``LFKT_RECOMPILE_BUDGET`` is flagged on the spot: a counter, a warning, and
a ``recompile_storm`` event on every in-flight trace (obs/trace.py), so the
request a storm stalled carries the explanation.  ``record_degrade`` and
``degrades()`` keep the reference's API and stay empty: the port has no
degrade path (a kernel that fails raises).

Zero cost when disarmed (``LFKT_DEVTIME=0``): the module-level
:func:`record_dispatch` and :func:`record_compile` the producers call read
one attribute and return.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque

logger = logging.getLogger(__name__)

#: bounded compile-event ring: /metrics replays the events it has not seen
#: into ``xla_compile_seconds`` through a per-consumer cursor
MAX_EVENTS = 1024
#: full signature strings kept per program (oldest out); distinct counts
#: and storm detection stay exact through a set of their hashes
MAX_SIGNATURES_SHOWN = 64

ENTRY = "entry"    # a host program, counted at each call
INNER = "inner"    # a kernel launched inside host programs


class _Program:
    """One registered program's ledger."""

    __slots__ = ("name", "kind", "site", "signatures", "sig_seen",
                 "compiles", "dispatches", "compile_s", "storms", "launches")

    def __init__(self, name: str, kind: str, site: str | None):
        self.name = name
        self.kind = kind
        self.site = site
        #: signature -> {"wall_s": first-compile wall, "count": compiles}
        self.signatures: OrderedDict[str, dict] = OrderedDict()
        self.sig_seen: set[int] = set()
        self.compiles = 0
        self.dispatches = 0
        self.compile_s = 0.0
        self.storms = 0
        #: an inner program's launch counter, read at snapshot time
        self.launches = None


class DevtimeRegistry:
    """The process-wide ledger (module instance: :data:`DEVTIME`).
    Producers are the engine's threads and the kernel build; consumers are
    ``/metrics``, ``/debug/compiles``, ``/debug/slo`` and the incident
    recorder."""

    # every mutable table goes through one mutex (lfkt-lint LOCK001);
    # _armed is the single hot-path bool, read without the lock by design
    _GUARDED_BY = {"_programs": "_lock", "_events": "_lock",
                   "_seq": "_lock", "storms_total": "_lock",
                   "events_dropped": "_lock", "_floor": "_lock"}
    _SHARED_ATOMIC = ("_armed", "budget")

    def __init__(self, armed: bool | None = None, budget: int | None = None):
        if armed is None or budget is None:
            from ..utils.config import knob

            if armed is None:
                armed = bool(knob("LFKT_DEVTIME"))
            if budget is None:
                budget = int(knob("LFKT_RECOMPILE_BUDGET"))
        self._lock = threading.Lock()
        self._programs: dict[str, _Program] = {}
        self._events: deque[dict] = deque(maxlen=MAX_EVENTS)
        self._seq = 0                  # monotonic event id (survives reset)
        self.storms_total = 0
        #: events a consumer found evicted before it read them
        self.events_dropped = 0
        self._floor = 0        # events at or below this were reset, not dropped
        self.budget = max(1, int(budget))
        self._armed = bool(armed)

    # -- configuration (tests + ops) ---------------------------------------
    def configure(self, armed: bool | None = None,
                  budget: int | None = None) -> None:
        if armed is not None:
            self._armed = bool(armed)
        if budget is not None:
            self.budget = max(1, int(budget))

    @property
    def armed(self) -> bool:
        return self._armed

    def reset(self) -> None:
        """Zero every ledger (tests).  The event sequence stays monotonic
        so the /metrics cursors of live apps never replay old events."""
        with self._lock:
            for p in self._programs.values():
                p.signatures.clear()
                p.sig_seen.clear()
                p.compiles = p.dispatches = p.storms = 0
                p.compile_s = 0.0
            self._events.clear()
            self.storms_total = 0
            self.events_dropped = 0
            self._floor = self._seq

    # -- registration ------------------------------------------------------
    def _program(self, name: str, kind: str, site: str | None) -> _Program:  # lfkt: holds[_lock]
        p = self._programs.get(name)
        if p is None:
            p = self._programs[name] = _Program(name, kind, site)
        elif site is not None and p.site is None:
            p.site = site
        return p

    def register_program(self, name: str, kind: str = INNER,
                         site: str | None = None, launches=None) -> str:
        """Declare a program (idempotent); returns the name.  ``launches``
        (an inner program's) is a zero-argument callable whose value is
        reported as the program's dispatches."""
        with self._lock:
            p = self._program(name, kind, site)
            if launches is not None:
                p.launches = launches
        return name

    def record_degrade(self, program: str, reason: str) -> None:
        """The reference's degrade attribution; the port has no degrade
        path, so nothing calls it and :meth:`degrades` stays empty."""
        raise NotImplementedError(
            f"{program}: the port has no degrade path ({reason})")

    def degrades(self) -> list[dict]:
        return []

    # -- producer API ------------------------------------------------------
    def record_dispatch(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._program(name, ENTRY, None).dispatches += n

    def record_compile(self, name: str, signature: str, wall_s: float) -> None:  # lfkt: noqa[GRAPH001] -- reached from captured code only through the kernel build's compile event, i.e. the kernel library's first load: capture_step's eager warm-up step runs the captured callable first, so a capture finds the library cached (ops/_kernels.library) and never reaches this
        """Record one compile event.  A signature past the budget flags a
        storm; its log line and trace fan-in run outside the lock."""
        storm = None
        with self._lock:
            p = self._program(name, ENTRY, None)
            sig_h = hash(signature)
            known = sig_h in p.sig_seen
            if known:
                entry = p.signatures.get(signature)
                if entry is not None:     # the display entry may be evicted
                    entry["count"] += 1
            else:
                p.sig_seen.add(sig_h)
                p.signatures[signature] = {"wall_s": round(wall_s, 6), "count": 1}
                while len(p.signatures) > MAX_SIGNATURES_SHOWN:
                    p.signatures.popitem(last=False)
            p.compiles += 1
            p.compile_s += wall_s
            self._seq += 1
            self._events.append({"seq": self._seq, "program": name,
                                 "wall_s": wall_s, "signature": signature,
                                 "at": time.time()})
            if not known and len(p.sig_seen) > self.budget:
                p.storms += 1
                self.storms_total += 1
                storm = {"program": name, "signatures": len(p.sig_seen),
                         "budget": self.budget}
        if storm is not None:
            logger.warning(
                "recompile storm: program %s minted signature #%d (budget %d) "
                "— static shapes are churning", storm["program"],
                storm["signatures"], storm["budget"], extra=storm)
            from .trace import annotate_all_inflight

            annotate_all_inflight("recompile_storm", **storm)

    # -- consumers ---------------------------------------------------------
    def _dispatches(self, p: _Program) -> int:
        if p.launches is None:
            return p.dispatches
        try:
            return int(p.launches())
        except Exception:  # noqa: BLE001 — telemetry must never fail
            return 0

    def counters(self) -> dict[str, dict]:
        """{program: {"compiles", "dispatches", "signatures", "storms"}}."""
        with self._lock:
            programs = list(self._programs.values())
            rows = {p.name: {"compiles": p.compiles, "signatures": len(p.sig_seen),
                             "storms": p.storms} for p in programs}
        for p in programs:
            rows[p.name]["dispatches"] = self._dispatches(p)
        return {name: {k: row[k] for k in ("compiles", "dispatches", "signatures",
                                           "storms")}
                for name, row in rows.items()}

    def events_since(self, cursor: int) -> tuple[int, list[dict]]:
        """Compile events newer than ``cursor`` and the new cursor.  A gap
        (the ring overflowed between two reads) grows ``events_dropped``; a
        negative cursor marks a consumer that never read and is charged no
        gap."""
        fresh = cursor < 0
        lost = 0
        with self._lock:
            if cursor > self._seq:          # a stale cursor across a reset
                cursor = 0
            if self._events and not fresh:
                oldest = self._events[0]["seq"]
                lost = max(0, (oldest - 1) - max(cursor, self._floor))
                if lost:
                    self.events_dropped += lost
            events = [dict(e) for e in self._events if e["seq"] > cursor]
            new_cursor = self._seq
        if lost:
            logger.warning(
                "compile-event ring overflowed: %d event(s) evicted before "
                "replay — xla_compile_seconds undercounts this interval "
                "(xla_compiles_total stays exact)", lost,
                extra={"events_dropped": lost})
        return new_cursor, events

    def storms(self) -> list[dict]:
        """Programs past the signature budget (the SLO engine's input)."""
        with self._lock:
            return [{"program": p.name, "signatures": len(p.sig_seen),
                     "budget": self.budget, "storms": p.storms}
                    for p in self._programs.values()
                    if len(p.sig_seen) > self.budget]

    def snapshot(self) -> dict:
        """The ``/debug/compiles`` document: every program with its
        compiles, dispatches and signatures (the reference's schema)."""
        with self._lock:
            rows = [(p.name, p.kind, p.site, p.compiles, p, p.compile_s,
                     len(p.sig_seen), p.storms, dict(p.signatures))
                    for p in self._programs.values()]
            armed = self._armed
            storms_total = self.storms_total
            dropped = self.events_dropped
        programs = []
        for name, kind, site, compiles, p, compile_s, n_sigs, storms, signatures in \
                sorted(rows, key=lambda r: r[0]):
            programs.append({
                "name": name, "kind": kind, "site": site,
                "compiles": compiles, "dispatches": self._dispatches(p),
                "compile_seconds_total": round(compile_s, 6),
                "signatures": n_sigs,
                "storms": storms,
                "signature_list": [{"signature": s, **meta}
                                   for s, meta in signatures.items()],
            })
        return {"armed": armed, "budget": self.budget,
                "storms_total": storms_total,
                "events_dropped": dropped,
                "degrades": self.degrades(),
                "programs": programs}


#: THE process-wide registry
DEVTIME = DevtimeRegistry()


def register_program(name: str, kind: str = INNER, site: str | None = None,
                     launches=None) -> str:
    """Declare a program on the process registry."""
    return DEVTIME.register_program(name, kind=kind, site=site, launches=launches)


def record_dispatch(name: str) -> None:
    """Count one call of host program ``name``; disarmed, one attribute
    read."""
    if DEVTIME._armed:
        DEVTIME.record_dispatch(name)


def record_compile(name: str, signature: str, wall_s: float) -> None:
    """Record one compile of ``name``; disarmed, one attribute read."""
    if DEVTIME._armed:
        DEVTIME.record_compile(name, signature, wall_s)

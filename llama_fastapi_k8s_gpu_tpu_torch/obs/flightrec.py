"""Incident flight recorder: evidence that outlives the pod.

The JAX package's recorder (llama_fastapi_k8s_gpu_tpu/obs/flightrec.py).
A watchdog trip, a DEAD escalation, a CUDA out-of-memory error or an SLO
breach leaves nothing once the pod restarts: the traces, the memory
ledger and the log tail live in process memory.  The recorder snapshots
an **incident bundle** — the memory ledger (obs/memledger.py), every
in-flight trace tree (obs/trace.py), the health-transition history, the
recompile-storm state (obs/devtime.py) and the last structured log lines
— into a bounded ring on disk.

Arming: off until ``LFKT_INCIDENT_DIR`` names a writable directory (the
chart mounts a volume there).  Bundles are schema-versioned JSON
(``inc-<seq>-<kind>.json``), written to a temporary file and renamed, so
a crash mid-write never leaves a torn bundle; pruned oldest first past
``LFKT_INCIDENT_RING``; served at ``GET /debug/incidents`` and
``/debug/incidents/{id}`` (server/app.py).

Trigger points (each passes a kind of :data:`KINDS`, the reference's
tuple, so bundles validate alike):

- ``watchdog_trip`` / ``dead_escalation`` — engine/watchdog.py, captured
  BEFORE the in-flight requests are failed, so the tripping request's
  trace is in the bundle;
- ``resource_exhausted`` — utils/health.py ``Heartbeat.record_error`` when
  the error carries :data:`OOM_SIGNATURE`, the card's ``CUDA out of
  memory`` (the reference matches XLA's ``RESOURCE_EXHAUSTED``; the kind
  keeps its name);
- ``slo_breach`` — obs/slo.py when the multi-window verdict confirms one.

A per-kind debounce (``LFKT_INCIDENT_DEBOUNCE_S``) keeps a burst at one
bundle.  Zero cost when disarmed: ``record()`` returns on one attribute
read, and the log-tail handler is only installed while armed.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from collections import deque

logger = logging.getLogger(__name__)

#: bundle schema version (:func:`validate_bundle` checks it)
SCHEMA = 1

#: the reference's incident kinds (``disagg_peer_dead``: a decode
#: replica's prefill peer died mid-stream — serving/disagg/;
#: ``fleet_peer_ejected``: the router ejected a replica and pulled
#: correlated bundle summaries from the peers — obs/fleettrace.py)
KINDS = ("watchdog_trip", "dead_escalation", "resource_exhausted",
         "slo_breach", "disagg_peer_dead", "fleet_peer_ejected")

#: bundle ids are process-minted and filesystem-safe; /debug/incidents/{id}
#: refuses anything else (no path traversal through the id)
_ID_RE = re.compile(r"inc-\d{6}-[a-z_]+")

#: the card's out-of-memory message (``torch.OutOfMemoryError``; the
#: injected ``SimulatedOOM`` of utils/faults.py carries it too)
OOM_SIGNATURE = "CUDA out of memory"


class _LogRing(logging.Handler):
    """Bounded structured tail of the process log stream — the bundle's
    ``log_tail``.  Installed on the root logger only while the recorder
    is armed; a failing append must never break logging."""

    def __init__(self, ring: deque):
        super().__init__()
        self.ring = ring

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.ring.append({
                "at": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": record.getMessage(),
            })
        except Exception:  # noqa: BLE001 — logging must never fail serving
            pass


class FlightRecorder:
    """The process-wide incident recorder (module instance:
    :data:`FLIGHTREC`)."""

    # record() runs on watchdog, engine and event-loop threads; the seq,
    # the debounce table and the counters go through one mutex.  ``armed``
    # is the one hot-path read, by design.

    # record() runs on watchdog / engine / event-loop threads; the seq,
    # debounce table and counters go through one mutex.  ``armed`` is the
    # single hot-path read, by design.
    _GUARDED_BY = {"_seq": "_lock", "_last_at": "_lock",
                   "recorded_total": "_lock", "debounced_total": "_lock"}
    _SHARED_ATOMIC = ("armed", "_dir", "_ring_size", "_debounce_s",
                      "_swept")

    def __init__(self, directory: str | None = None, ring: int | None = None,
                 debounce_s: float | None = None,
                 log_lines: int | None = None):
        if directory is None or ring is None or debounce_s is None \
                or log_lines is None:
            from ..utils.config import knob

            if directory is None:
                directory = str(knob("LFKT_INCIDENT_DIR") or "")
            if ring is None:
                ring = int(knob("LFKT_INCIDENT_RING"))
            if debounce_s is None:
                debounce_s = float(knob("LFKT_INCIDENT_DEBOUNCE_S"))
            if log_lines is None:
                log_lines = int(knob("LFKT_INCIDENT_LOG_LINES"))
        self._lock = threading.Lock()
        self._seq = 0
        self._last_at: dict[str, float] = {}
        self.recorded_total = 0
        self.debounced_total = 0
        self._log_lines = max(1, int(log_lines))
        self._log_ring: deque | None = None
        self._log_handler: _LogRing | None = None
        self._health_ref = None      # weakref: utils/health.HealthMonitor
        self._engine_ref = None      # weakref: the serving engine
        self._fleet_fn = None        # zero-arg fleet-context provider
        self.armed = False
        self._dir = ""
        self._ring_size = 16
        self._debounce_s = 30.0
        self._swept = False
        self.configure(directory=directory, ring=ring,
                       debounce_s=debounce_s)

    # -- configuration (env at import; tests/ops reconfigure) ---------------
    def configure(self, directory: str | None = None, ring: int | None = None,
                  debounce_s: float | None = None) -> None:
        if ring is not None:
            self._ring_size = max(1, int(ring))
        if debounce_s is not None:
            self._debounce_s = max(0.0, float(debounce_s))
        if directory is not None:
            self._dir = str(directory)
            armed = bool(self._dir)
            if armed:
                # continue the on-disk sequence so a restarted process
                # never overwrites the previous crash's evidence; the
                # directory scan runs off the lock, and the result is
                # merged (the sequence only moves forward)
                names = self._list_files()
                with self._lock:
                    self._seq = max(
                        [self._seq] + [self._file_seq(n) for n in names])
                    self._last_at.clear()
                # temp files a crash left are swept at the first write,
                # never here: a reader arming on the same directory must
                # not delete a live recorder's in-progress temp file
                self._swept = False
                if self._log_ring is None:
                    self._log_ring = deque(maxlen=self._log_lines)
                    self._log_handler = _LogRing(self._log_ring)
                    logging.getLogger().addHandler(self._log_handler)
                logger.info("incident flight recorder ARMED: dir=%s ring=%d",
                            self._dir, self._ring_size)
            elif self._log_handler is not None:
                logging.getLogger().removeHandler(self._log_handler)
                self._log_handler = None
                self._log_ring = None
            # set LAST: record() keys off this single attribute
            self.armed = armed

    def install(self, health=None, engine=None, fleet=None) -> None:
        """Hand the recorder the health monitor and the serving engine,
        weakly held, so a discarded app never pins its engine.  The server,
        the watchdog and the fleet router call it.  ``fleet`` is a zero-arg
        callable returning this process's fleet context (role, identity,
        migration attribution); every bundle captures it under ``fleet``."""
        import weakref

        if health is not None:
            self._health_ref = weakref.ref(health)
        if fleet is not None:
            self._fleet_fn = fleet
        if engine is not None:
            try:
                self._engine_ref = weakref.ref(engine)
            except TypeError:
                self._engine_ref = None    # an un-weakref-able fake

    # -- the one producer entry point ---------------------------------------
    def record(self, kind: str, reason: str, extra: dict | None = None
               ) -> str | None:
        """Snapshot one incident bundle to disk; returns its id, or None
        when disarmed / debounced / the write failed.  Never raises — the
        recorder must not turn an incident into a second incident."""
        if not self.armed:            # disarmed: single attribute read
            return None
        if kind not in KINDS:
            logger.error("unknown incident kind %r dropped", kind)
            return None
        now = time.time()
        with self._lock:
            last = self._last_at.get(kind)
            if last is not None and now - last < self._debounce_s:
                self.debounced_total += 1
                return None
            self._last_at[kind] = now
            self._seq += 1
            seq = self._seq
        incident_id = f"inc-{seq:06d}-{kind}"
        try:
            bundle = self._capture(incident_id, kind, reason, extra, now)
            self._write(incident_id, bundle)
        except Exception:  # noqa: BLE001 — evidence is best-effort
            # roll back the debounce stamp (it was taken optimistically to
            # keep racing producers at one bundle): a failed write — disk
            # full during the very incident being recorded — must not
            # suppress the retry the next trigger would make
            with self._lock:
                if self._last_at.get(kind) == now:
                    del self._last_at[kind]
            logger.exception("incident bundle %s could not be written",
                             incident_id)
            return None
        with self._lock:
            self.recorded_total += 1
        logger.warning("incident bundle recorded: %s (%s) -> %s",
                       incident_id, reason,
                       os.path.join(self._dir, incident_id + ".json"))
        return incident_id

    # -- capture -------------------------------------------------------------
    def _capture(self, incident_id: str, kind: str, reason: str,
                 extra: dict | None, now: float) -> dict:
        from .devtime import DEVTIME
        from .memledger import MEMLEDGER
        from .trace import all_inflight_trees

        health = None
        if self._health_ref is not None:
            h = self._health_ref()
            if h is not None:
                try:
                    health = h.snapshot()
                except Exception:  # noqa: BLE001 — partial bundles beat none
                    pass
        fleet = None
        if self._fleet_fn is not None:
            try:
                fleet = self._fleet_fn()
            except Exception:  # noqa: BLE001 — partial bundles beat none
                pass
        scheduler = None
        eng = self._engine_ref() if self._engine_ref is not None else None
        stats = getattr(eng, "scheduler_stats", None)
        if callable(stats):
            try:
                scheduler = stats()
            except Exception:  # noqa: BLE001 — partial bundles beat none
                pass
        return {
            "schema": SCHEMA,
            "id": incident_id,
            "at": now,
            "kind": kind,
            "reason": str(reason),
            "memory": MEMLEDGER.snapshot(),
            "traces": all_inflight_trees(),
            "scheduler": scheduler,
            "health": health,
            "fleet": fleet,
            "recompile": {"storms": DEVTIME.storms(),
                          "storms_total": DEVTIME.storms_total},
            "log_tail": list(self._log_ring or ()),
            "extra": dict(extra or {}),
        }

    # -- disk ring -----------------------------------------------------------
    @staticmethod
    def _file_seq(name: str) -> int:
        try:
            return int(name.split("-")[1])
        except (IndexError, ValueError):
            return 0

    def _list_files(self) -> list[str]:
        try:
            names = [n for n in os.listdir(self._dir)
                     if _ID_RE.fullmatch(n[:-5]) and n.endswith(".json")]
        except OSError:
            return []
        return sorted(names, key=self._file_seq)

    def _write(self, incident_id: str, bundle: dict) -> None:
        os.makedirs(self._dir, exist_ok=True)
        if not self._swept:
            # first write of this arming: sweep temp files a previous
            # process's crash mid-write left behind (our own write path
            # cleans up after itself below)
            self._swept = True
            try:
                for n in os.listdir(self._dir):
                    if n.startswith(".tmp-"):
                        os.remove(os.path.join(self._dir, n))
            except OSError:
                pass
        final = os.path.join(self._dir, incident_id + ".json")
        tmp = os.path.join(self._dir, f".tmp-{incident_id}.json")
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)   # atomic: never a torn bundle
        except BaseException:
            # a failed write must not LEAVE its torn temp file: the
            # debounce rollback means disk-full retries, and each retry
            # mints a new id — leaked .tmp files would compound the very
            # disk pressure that failed the write
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        files = self._list_files()
        while len(files) > self._ring_size:
            victim = files.pop(0)
            try:
                os.remove(os.path.join(self._dir, victim))
            except OSError:
                pass

    # -- consumers (/debug/incidents) ---------------------------------------
    def list(self) -> list[dict]:
        """Newest-first bundle summaries read back from the ring."""
        out = []
        for name in reversed(self._list_files()):
            doc = self.get(name[:-5])
            if doc is None:
                continue
            out.append({k: doc.get(k)
                        for k in ("id", "at", "kind", "reason", "schema")})
        return out

    def get(self, incident_id: str) -> dict | None:
        """One full bundle by id (None for unknown/malformed ids — the id
        grammar is enforced so an id can never escape the ring dir)."""
        if not self._dir or not _ID_RE.fullmatch(incident_id or ""):
            return None
        path = os.path.join(self._dir, incident_id + ".json")
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


def validate_bundle(doc) -> list[str]:
    """Schema violations of one parsed bundle (empty: valid)."""
    bad: list[str] = []
    if not isinstance(doc, dict):
        return ["bundle is not a JSON object"]
    if doc.get("schema") != SCHEMA:
        bad.append(f"schema {doc.get('schema')!r} != {SCHEMA} (drift)")
    if not isinstance(doc.get("id"), str) \
            or not _ID_RE.fullmatch(doc.get("id") or ""):
        bad.append("missing/malformed 'id'")
    if doc.get("kind") not in KINDS:
        bad.append(f"unknown kind {doc.get('kind')!r}")
    if not isinstance(doc.get("at"), (int, float)):
        bad.append("missing numeric 'at'")
    if not isinstance(doc.get("reason"), str):
        bad.append("missing string 'reason'")
    for field, typ in (("memory", dict), ("traces", list),
                       ("recompile", dict), ("log_tail", list),
                       ("extra", dict)):
        if not isinstance(doc.get(field), typ):
            bad.append(f"missing {typ.__name__} '{field}'")
    for field in ("scheduler", "health", "fleet"):
        if doc.get(field) is not None and not isinstance(doc[field], dict):
            bad.append(f"'{field}' must be an object or null")
    return bad


#: THE process-wide recorder: armed from LFKT_INCIDENT_DIR at import,
#: written by the watchdog, health and SLO trigger points, read by
#: /debug/incidents.
FLIGHTREC = FlightRecorder()


def record_incident(kind: str, reason: str, extra: dict | None = None
                    ) -> str | None:
    """Record on the current process recorder (resolved at call time so
    tests can swap :data:`FLIGHTREC`)."""
    return FLIGHTREC.record(kind, reason, extra=extra)

"""Engine watchdog: stall/burst/death detection + bounded in-process recovery.

The JAX package's watchdog (llama_fastapi_k8s_gpu_tpu/engine/watchdog.py).
A thread watches one engine's :class:`~..utils.health.Heartbeat` and trips
on:

- **stalled decode** — the engine reports a generation in flight but its
  beat has not advanced for ``stall_seconds`` (a wedged decode loop and a
  hung device call look the same from the host);
- **exception burst** — ≥ ``error_burst`` engine-side errors inside
  ``error_window`` seconds;
- **engine failure** — the engine's ``failure()`` hook reports a fault it
  cannot serve through (the port's engine: a poisoned CUDA context).

On a trip the watchdog flips health to DEGRADED with the reason, fails the
engine's registered in-flight work with
:class:`~..utils.health.EngineUnavailable` (503), then recovers within a
budget: exponential backoff, ``engine.recover()``, escalation to DEAD after
``max_recoveries`` trips in one incident window (trips are forgotten after
``trip_forget_seconds`` of healthy serving).  DEAD fails the liveness
probe, and the pod restarts.  A trip and a DEAD escalation each record an
incident bundle (obs/flightrec.py, armed by ``LFKT_INCIDENT_DIR``), the
trip's before the in-flight requests are failed, so the traces of the
requests the trip interrupts are in it.

The contract is three optional attributes (``heartbeat``, ``recover()``,
``fail_inflight(exc)``) plus the optional ``failure()`` hook, so fakes
plug in freely.
"""

from __future__ import annotations

import logging
import threading
import time

from ..obs import flightrec as _flightrec
from ..obs.trace import annotate_all_inflight
from ..utils.health import DEAD, DEGRADED, READY, EngineUnavailable

logger = logging.getLogger(__name__)


class Watchdog:
    """Samples an engine heartbeat; degrades, recovers, or escalates.

    The trip and recovery bookkeeping belongs to the watchdog's thread
    (:meth:`check` and :meth:`handle_trip` are public for tests)."""

    def __init__(self, engine, health, metrics=None, *,
                 stall_seconds: float = 30.0,
                 poll_seconds: float = 1.0,
                 max_recoveries: int = 3,
                 error_burst: int = 5,
                 error_window: float = 30.0,
                 backoff_seconds: float = 1.0,
                 backoff_max: float = 60.0,
                 trip_forget_seconds: float = 600.0):
        self.engine = engine
        self.health = health
        self.metrics = metrics
        self.stall_seconds = stall_seconds
        self.poll_seconds = poll_seconds
        self.max_recoveries = max_recoveries
        self.error_burst = error_burst
        self.error_window = error_window
        self.backoff_seconds = backoff_seconds
        self.backoff_max = backoff_max
        self.trip_forget_seconds = trip_forget_seconds
        #: trip/recovery counters (also pushed to metrics when provided)
        self.trips = 0
        self.recoveries = 0
        #: trips inside the current incident window — the DEAD budget
        self.trips_window = 0
        self._last_trip_at: float | None = None
        self.last_trip_reason: str | None = None
        self._stop = threading.Event()
        # the incident bundles carry this engine's health trail (weakly
        # held); installed here too for drills that build no server app
        _flightrec.FLIGHTREC.install(health=health, engine=engine)
        self._thread = threading.Thread(
            target=self._loop, name="lfkt-watchdog", daemon=True)

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)

    # ------------------------------------------------------------------
    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def check(self) -> str | None:
        """One detection pass; the trip reason or None."""
        failure = getattr(self.engine, "failure", None)
        err = failure() if callable(failure) else None
        if err is not None:
            return f"engine_failed: {type(err).__name__}: {err}"
        hb = getattr(self.engine, "heartbeat", None)
        if hb is None:
            return None
        if hb.busy_count() > 0 and hb.idle_for() > self.stall_seconds:
            return (f"stalled_decode: no engine progress in "
                    f"{hb.idle_for():.1f}s with {hb.busy_count()} in flight")
        if hb.error_burst(self.error_burst, self.error_window):
            return (f"exception_burst: >={self.error_burst} engine errors "
                    f"in {self.error_window:.0f}s ({hb.last_error})")
        return None

    def _record_incident(self, kind: str, reason: str) -> None:
        """Bundle this incident; ``extra`` carries the watchdog's own
        counters (the health trail rides the bundle's top level)."""
        _flightrec.record_incident(kind, reason, extra={"watchdog": {
            "trips": self.trips, "trips_window": self.trips_window,
            "max_recoveries": self.max_recoveries,
        }})

    def handle_trip(self, reason: str) -> None:
        """DEGRADED → fail in-flight → backoff → recover (or escalate)."""
        self.trips += 1
        self.trips_window += 1
        self._last_trip_at = time.monotonic()
        self.last_trip_reason = reason
        self._inc("watchdog_trips_total")
        logger.error("watchdog trip #%d: %s", self.trips, reason)
        annotate_all_inflight("watchdog_trip", trip=self.trips, reason=reason)
        self.health.transition(DEGRADED, reason)
        # before the in-flight requests are failed: their traces go in
        self._record_incident("watchdog_trip", reason)
        hb = getattr(self.engine, "heartbeat", None)
        if hb is not None:
            # this trip consumes the burst evidence: a re-trip needs NEW
            # errors (stall and failure evidence live elsewhere and persist)
            hb.clear_errors()

        fail_inflight = getattr(self.engine, "fail_inflight", None)
        if callable(fail_inflight):
            try:
                fail_inflight(EngineUnavailable(f"watchdog trip: {reason}"))
            except Exception:  # noqa: BLE001 — failing futures is best-effort
                logger.exception("watchdog fail_inflight raised")

        if self.trips_window > self.max_recoveries:
            self._inc("watchdog_escalations_total")
            logger.error("watchdog recovery budget exhausted "
                         "(%d trips this incident > max_recoveries=%d): "
                         "escalating to DEAD",
                         self.trips_window, self.max_recoveries)
            self.health.transition(
                DEAD, f"max_recoveries_exceeded after: {reason}")
            # the pod is about to restart: this bundle is what survives it
            self._record_incident(
                "dead_escalation", f"max_recoveries_exceeded after: {reason}")
            self._stop.set()
            return

        # exponential backoff before touching the engine; interruptible so
        # stop() never blocks on it
        backoff = min(self.backoff_max,
                      self.backoff_seconds * (2 ** (self.trips_window - 1)))
        if self._stop.wait(backoff):
            return
        recover = getattr(self.engine, "recover", None)
        ok = False
        in_place = False
        if callable(recover):
            try:
                ok = bool(recover())
            except Exception:  # noqa: BLE001 — a recovery crash is a failure
                logger.exception("engine recover() raised")
                ok = False
        if not ok and self.check() is None:
            # recover() refused because the engine is busy serving and no
            # fault signature remains (the burst evidence was consumed):
            # the engine works, so re-ready in place.  A real wedge keeps
            # its stall or failure signature and escalates.
            ok = in_place = True
        if ok:
            hb = getattr(self.engine, "heartbeat", None)
            if hb is not None and not in_place:
                hb.reset()
            self.recoveries += 1
            self._inc("watchdog_recoveries_total")
            logger.warning("watchdog recovery #%d %s after: %s",
                           self.recoveries,
                           "in place (engine healthy)" if in_place
                           else "succeeded", reason)
            self.health.transition(READY, f"recovered_from: {reason}")
        else:
            # stay DEGRADED: the next poll re-detects and re-trips, walking
            # the backoff ladder until recovery works or the budget is spent
            logger.error("engine recover() failed; staying DEGRADED")

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_seconds):
            try:
                if (self.trips_window and self._last_trip_at is not None
                        and self.health.state == READY
                        and time.monotonic() - self._last_trip_at
                        > self.trip_forget_seconds):
                    logger.info("watchdog: %d trip(s) forgotten after %.0fs "
                                "of healthy serving", self.trips_window,
                                self.trip_forget_seconds)
                    self.trips_window = 0
                reason = self.check()
                if reason is not None:
                    self.handle_trip(reason)
            except Exception:  # noqa: BLE001 — the watchdog must not die
                logger.exception("watchdog pass raised")

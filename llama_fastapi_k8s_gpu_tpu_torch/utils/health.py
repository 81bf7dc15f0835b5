"""Health state machine + engine progress heartbeat (the resilience layer).

The same vocabulary as the JAX package's copy
(llama_fastapi_k8s_gpu_tpu/utils/health.py):

- :class:`HealthMonitor` — the pod-level state machine
  ``STARTING → READY ⇄ DEGRADED → DEAD`` (plus ``DRAINING`` on SIGTERM),
  with reason codes and a transition log.  Readiness (route traffic here?)
  is true only in READY; liveness (restart the pod?) is false only in
  DEAD, so a watchdog trip sheds traffic without inviting a restart.
- :class:`Heartbeat` — the progress pulse the engine publishes (one
  ``beat()`` per decode chunk, busy counts, an error ring) and the
  watchdog samples (engine/watchdog.py).  A recorded CUDA out-of-memory
  error is bundled at once as a ``resource_exhausted`` incident
  (obs/flightrec.py).  The engine never imports the
  watchdog; the heartbeat is the entire interface between them.
- :class:`EngineUnavailable` / :class:`DeadlineExceeded` — the error
  taxonomy the server maps to 503 / 408, distinct from the generic 500.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..obs import flightrec as _flightrec
from ..obs.trace import annotate_all_inflight

STARTING = "STARTING"    # model loading / warmup: not ready, alive
READY = "READY"          # serving: ready, alive
DEGRADED = "DEGRADED"    # watchdog tripped, recovery in flight: not ready, alive
DRAINING = "DRAINING"    # SIGTERM received, finishing in-flight: not ready, alive
DEAD = "DEAD"            # recovery budget exhausted: not ready, NOT alive

#: numeric codes for the /metrics gauge (dashboards alert on > 1)
STATE_CODES = {STARTING: 0, READY: 1, DEGRADED: 2, DRAINING: 3, DEAD: 4}

_TERMINAL = frozenset({DEAD})


class EngineUnavailable(RuntimeError):
    """The engine cannot serve right now (watchdog trip, recovery in
    progress, a poisoned CUDA context).  The server maps this to 503 —
    retryable against another replica — instead of the generic 500."""


class DeadlineExceeded(TimeoutError):
    """A request's propagated deadline expired inside the engine.  Maps to
    the reference's 408."""


class Heartbeat:
    """Engine progress pulse sampled by the watchdog (thread-safe).

    The engine calls :meth:`beat` once per decode chunk and prompt pass,
    brackets a generation with :meth:`enter`/:meth:`leave`, and calls
    :meth:`record_error` on engine-side exceptions.  The watchdog reads
    :meth:`idle_for`, :meth:`busy_count` and :meth:`error_burst`: "busy but
    no beat for N seconds" is the stall signal that catches a wedged decode
    loop and a hung device call alike."""

    # every field is written by engine threads and read by the watchdog
    # thread: all access goes through _lock (lfkt-lint LOCK001)
    _GUARDED_BY = {
        "_last_beat": "_lock", "_busy": "_lock", "_errors": "_lock",
        "beats_total": "_lock", "errors_total": "_lock",
        "last_error": "_lock",
    }

    def __init__(self, error_keep: int = 32):
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._busy = 0
        self._errors: deque[float] = deque(maxlen=error_keep)
        self.beats_total = 0
        self.errors_total = 0
        self.last_error: str | None = None

    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self.beats_total += 1

    def enter(self) -> None:
        with self._lock:
            self._busy += 1
            self._last_beat = time.monotonic()

    def leave(self) -> None:
        with self._lock:
            self._busy = max(0, self._busy - 1)
            self._last_beat = time.monotonic()

    def set_busy(self, n: int) -> None:
        """The in-flight count outright: the continuous scheduler sets it
        once a loop pass to its queued and occupied work."""
        with self._lock:
            self._busy = max(0, int(n))

    def record_error(self, exc: BaseException) -> None:
        msg = f"{type(exc).__name__}: {exc}"
        with self._lock:
            self._errors.append(time.monotonic())
            self.errors_total += 1
            self.last_error = msg
        # a device OOM is the incident the recorder exists for: by the time
        # a burst trips the watchdog, the allocation state that caused it
        # is gone, so bundle it at first sight (outside the lock; disarmed,
        # one attribute read; the debounce keeps a burst at one bundle)
        if _flightrec.OOM_SIGNATURE in msg:
            _flightrec.record_incident(
                "resource_exhausted", msg,
                extra={"errors_total": self.errors_total})

    def clear_errors(self) -> None:
        """Consume the burst evidence (a trip handled it): a re-trip must
        need NEW errors."""
        with self._lock:
            self._errors.clear()

    def reset(self) -> None:
        """After a recovery: clear the stall and burst evidence so the old
        incident cannot re-trip the watchdog at once."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._busy = 0
            self._errors.clear()

    # -- watchdog-side reads ------------------------------------------------
    def busy_count(self) -> int:
        with self._lock:
            return self._busy

    def idle_for(self) -> float:
        with self._lock:
            return time.monotonic() - self._last_beat

    def error_burst(self, n: int, window_seconds: float) -> bool:
        """True when ≥ ``n`` errors were recorded in the last ``window``."""
        cutoff = time.monotonic() - window_seconds
        with self._lock:
            return sum(1 for t in self._errors if t >= cutoff) >= n


class HealthMonitor:
    """Thread-safe pod health state machine with reason codes and a
    bounded transition log.  DEAD is terminal, and DRAINING yields only to
    DEAD: a draining pod never re-advertises readiness."""

    # probe handlers, the watchdog and SIGTERM handling all race on the
    # state: every read/write goes through _lock (lfkt-lint LOCK001)
    _GUARDED_BY = {
        "_state": "_lock", "_reason": "_lock", "_since": "_lock",
        "_log": "_lock",
    }

    def __init__(self):
        self._lock = threading.Lock()
        self._state = STARTING
        self._reason = "initializing"
        self._since = time.time()
        self._log: deque[dict] = deque(maxlen=16)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def transition(self, state: str, reason: str = "") -> bool:
        """Move to ``state``; False when refused."""
        if state not in STATE_CODES:
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            if self._state in _TERMINAL and state != self._state:
                return False
            if self._state == DRAINING and state not in (DRAINING, DEAD):
                return False
            if state == self._state and reason == self._reason:
                return True
            self._log.append({"at": time.time(), "from": self._state,
                              "to": state, "reason": reason})
            prev = self._state
            self._state = state
            self._reason = reason
            self._since = time.time()
        # outside the lock: every in-flight trace carries the change
        annotate_all_inflight("health_transition", from_state=prev,
                              to_state=state, reason=reason)
        return True

    # -- probe semantics ----------------------------------------------------
    def ready(self) -> bool:
        """Readiness: only READY takes traffic."""
        with self._lock:
            return self._state == READY

    def alive(self) -> bool:
        """Liveness: only DEAD asks for a restart."""
        with self._lock:
            return self._state != DEAD

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "reason": self._reason,
                    "since": self._since, "transitions": list(self._log)}

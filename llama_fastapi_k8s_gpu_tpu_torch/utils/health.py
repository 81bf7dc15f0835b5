"""Pod health state machine (the subset of the reference's
llama_fastapi_k8s_gpu_tpu/utils/health.py the serial server reads).

``STARTING → READY`` once the engine is loaded, ``DRAINING`` on SIGTERM.
Readiness (route traffic here?) is true only in READY.  The watchdog's
DEGRADED and DEAD states come with the watchdog.
"""

from __future__ import annotations

import threading
import time
from collections import deque

STARTING = "STARTING"    # model loading / warmup: not ready
READY = "READY"          # serving
DRAINING = "DRAINING"    # SIGTERM received, finishing in-flight: not ready

STATES = (STARTING, READY, DRAINING)


class HealthMonitor:
    """Thread-safe state machine with reason codes and a bounded
    transition log.  DRAINING is final: a draining pod never re-advertises
    readiness."""

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
        if state not in STATES:
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            if self._state == DRAINING and state != DRAINING:
                return False
            if state == self._state and reason == self._reason:
                return True
            self._log.append({"at": time.time(), "from": self._state,
                              "to": state, "reason": reason})
            self._state = state
            self._reason = reason
            self._since = time.time()
        return True

    def ready(self) -> bool:
        with self._lock:
            return self._state == READY

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "reason": self._reason,
                    "since": self._since, "transitions": list(self._log)}

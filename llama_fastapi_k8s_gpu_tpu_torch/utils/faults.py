"""Env-armed fault injection — inert by default, deterministic when armed.

The JAX package's injector (llama_fastapi_k8s_gpu_tpu/utils/faults.py) over
the points the serial engine runs: ``decode_step`` (once a decode chunk, in
the host loop), ``prefill``, ``load`` (engine construction) and
``recover``, the disagg page wire's (serving/disagg/): ``peer_dead``
(the prefill tier between PAGE groups), ``slow_wire`` and
``truncated_frame`` (a frame's send), and warm-page migration's
(serving/fleet/migrate.py): ``migrate_pull`` (inside the puller's hop),
``migrate_push`` (the page service between PAGE groups) and
``drain_push`` (the draining pod's push loop).  A disarmed point costs
one dict lookup.

Arming grammar (``LFKT_FAULTS`` or :meth:`FaultInjector.arm`): a
comma-separated list of specs, each ``point:mode[:key=value]*``::

    LFKT_FAULTS="decode_step:error:after=3:times=1"
    LFKT_FAULTS="decode_step:slow:delay=2.5,load:oom"

modes
    ``error``  raise :class:`FaultError` (a generic engine exception)
    ``oom``    raise :class:`SimulatedOOM` (a ``torch.OutOfMemoryError``)
    ``slow``   sleep ``delay`` seconds (default 1.0) — a slow or hung step

keys
    ``after=N``  pass through the first N hits before firing (default 0)
    ``times=N``  fire at most N times, then fall inert (default 1;
                 ``times=0`` means unlimited)
    ``delay=S``  sleep length for ``slow``
"""

from __future__ import annotations

import logging
import os
import threading
import time

import torch

logger = logging.getLogger(__name__)

#: the valid injection points (a typo fails at arm time, not silently)
POINTS = ("decode_step", "prefill", "load", "recover",
          "peer_dead", "slow_wire", "truncated_frame",
          "migrate_pull", "migrate_push", "drain_push")
_MODES = ("error", "oom", "slow")


class FaultError(RuntimeError):
    """An injected engine fault."""


class SimulatedOOM(FaultError, torch.OutOfMemoryError):
    """An injected device OOM: a ``torch.OutOfMemoryError``, so a drill
    takes the path a real allocation failure on the card takes."""


class _Fault:
    __slots__ = ("point", "mode", "after", "times", "delay", "seen", "fired")

    def __init__(self, point: str, mode: str, after: int = 0,
                 times: int = 1, delay: float = 1.0):
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r} (valid: {POINTS})")
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r} (valid: {_MODES})")
        self.point = point
        self.mode = mode
        self.after = int(after)
        self.times = int(times)
        self.delay = float(delay)
        self.seen = 0
        self.fired = 0


class FaultInjector:
    """Holds armed faults; the engine calls :meth:`fire` at its points."""

    # arm/disarm (test threads) race fire (engine threads): the table is
    # written under _lock; fire's first read is a deliberate lock-free
    # dict probe (disarmed is the hot path) — reads aren't write-checked
    _GUARDED_BY = {"_by_point": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._by_point: dict[str, _Fault] = {}

    @classmethod
    def from_env(cls, var: str = "LFKT_FAULTS") -> "FaultInjector":
        inj = cls()
        spec = os.environ.get(var, "").strip()
        if spec:
            inj.arm(spec)
            logger.warning("fault injection ARMED from %s=%r", var, spec)
        return inj

    def arm(self, spec: str) -> None:
        """Arm one or more ``point:mode[:key=value]*`` specs."""
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(
                    f"fault spec {part!r} needs at least point:mode")
            kw: dict = {}
            for f in fields[2:]:
                k, _, v = f.partition("=")
                if k not in ("after", "times", "delay") or not v:
                    raise ValueError(f"bad fault option {f!r} in {part!r}")
                kw[k] = float(v) if k == "delay" else int(v)
            fault = _Fault(fields[0], fields[1], **kw)
            with self._lock:
                self._by_point[fault.point] = fault

    def disarm(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._by_point.clear()
            else:
                self._by_point.pop(point, None)

    def armed(self) -> bool:
        with self._lock:
            return bool(self._by_point)

    def stats(self) -> dict:
        with self._lock:
            return {p: {"mode": f.mode, "seen": f.seen, "fired": f.fired}
                    for p, f in self._by_point.items()}

    def fire(self, point: str) -> None:
        """Run the injection point: a no-op unless a fault is armed there
        and its after/times script says this hit fires."""
        fault = self._by_point.get(point)   # no lock: disarmed is the hot path
        if fault is None:
            return
        with self._lock:
            fault.seen += 1
            if fault.seen <= fault.after:
                return
            if fault.times and fault.fired >= fault.times:
                return
            fault.fired += 1
            mode, delay = fault.mode, fault.delay
        logger.warning("fault injection FIRING %s at %r (hit %d)",
                       mode, point, fault.seen)
        from ..obs.trace import annotate_all_inflight

        annotate_all_inflight("fault_fired", point=point, mode=mode)
        if mode == "slow":
            time.sleep(delay)
        elif mode == "oom":
            raise SimulatedOOM(
                f"CUDA out of memory: simulated OOM injected at {point!r}")
        else:
            raise FaultError(f"injected fault at {point!r}")


#: process-wide singleton the engine consults; inert unless LFKT_FAULTS was
#: set at import (tests and drills arm and disarm it in code)
FAULTS = FaultInjector.from_env()

"""The router's health-aware replica table.

The port's copy of the JAX package's table
(llama_fastapi_k8s_gpu_tpu/serving/fleet/peers.py); stdlib only.

Replicas come from ``LFKT_FLEET_PEERS`` (a static ``host:port,...``
list) or, in k8s, from resolving a headless Service's DNS name every
probe cycle (``LFKT_FLEET_DNS=name:port`` — a headless Service answers
with one A record per ready pod, so scale-out/in shows up here without
router restarts).

Liveness is decided two ways, both landing in :meth:`eject`:

- a background prober GETs every peer's ``/health/ready`` each cycle
  (``LFKT_FLEET_PROBE_SECONDS``) — a replica that stops answering (or
  answers 503: DEGRADED/DRAINING pods shed traffic) is ejected;
- the router ejects a peer the moment a PROXIED request fails against
  it — the prober's cadence must never be the detection latency for a
  request already in hand.

Ejection backs off exponentially (``LFKT_FLEET_EJECT_BACKOFF_SECONDS``
doubling to ``.._MAX``): an ejected peer is only re-probed after its
backoff expires, and a probe success re-admits it with the backoff
reset.  While ejected, the peer stays in :meth:`addrs` (rendezvous
ranks the FULL set so ownership never migrates behind a flap) but not
in :meth:`healthy` — the router spills its keys to rendezvous-next
with attribution until re-admission.
"""

from __future__ import annotations

import http.client
import logging
import socket
import threading
import time

from ...obs.logctx import sanitize_text

logger = logging.getLogger(__name__)


class _Peer:
    """One replica's liveness record (mutated only under the table lock)."""

    __slots__ = ("addr", "healthy", "ejected_at", "next_probe", "backoff",
                 "last_error", "ejections", "static", "fresh_at")

    def __init__(self, addr: str, static: bool):
        self.addr = addr
        self.healthy = True          # optimistic: the first probe decides
        self.ejected_at = 0.0
        self.next_probe = 0.0
        self.backoff = 0.0
        self.last_error = None
        self.ejections = 0
        self.static = static         # from LFKT_FLEET_PEERS, never pruned
        # when this replica last (re)joined the serving set: DNS
        # scale-out discovery now, re-admission after an ejection later
        # (static boot peers start un-fresh — a cold fleet has no prior
        # owner to pull from).  Drives the router's pull-on-remap stamp
        # (migrate.py): a freshly (re)joined owner probably restarted
        # cold while its conversations' pages live on the spill target.
        self.fresh_at = 0.0 if static else time.time()


class PeerTable:
    """Thread-safe replica set + prober (see module docstring)."""

    # -- lock discipline (lfkt-lint LOCK001-004) ---------------------------
    _GUARDED_BY = {"_peers": "_lock"}
    _THREAD_ENTRIES = ("_probe_loop",)
    # on_eject is written once at router construction, read by the
    # prober thread and the event loop — a single reference swap
    _SHARED_ATOMIC = ("on_eject",)

    def __init__(self, peers: list[str] | None = None, dns: str = "",
                 probe_seconds: float = 2.0, backoff_seconds: float = 1.0,
                 backoff_max: float = 30.0, probe_timeout: float = 2.0,
                 probe_path: str = "/health/ready", metrics=None):
        self._lock = threading.Lock()
        self._peers: dict[str, _Peer] = {}
        self.dns = dns
        self.probe_seconds = probe_seconds
        self.backoff_seconds = backoff_seconds
        self.backoff_max = backoff_max
        self.probe_timeout = probe_timeout
        self.probe_path = probe_path
        self._metrics = metrics
        self._stop = threading.Event()
        self._thread = None
        #: optional rising-edge ejection hook ``(addr, reason)`` —
        #: invoked OFF the table lock (it fans out; the router wires the
        #: correlated incident pull here).  Must never raise-or-block by
        #: contract; guarded anyway.
        self.on_eject = None
        for addr in peers or []:
            addr = addr.strip()
            if addr:
                self._peers[addr] = _Peer(addr, static=True)
        if not self._peers and not dns:
            raise ValueError(
                "PeerTable needs at least one replica: set LFKT_FLEET_PEERS="
                "host:port[,host:port...] or LFKT_FLEET_DNS=name:port "
                "(docs/RUNBOOK.md 'Running a replica fleet')")

    # -- telemetry (never fails routing) -----------------------------------
    def _emit(self, kind: str, name: str, value: float = 1.0, **labels):
        m = self._metrics
        if m is None:
            return
        try:
            getattr(m, kind)(name, value, **labels)
        except Exception:  # noqa: BLE001 — telemetry must never fail routing
            pass

    # -- lifecycle ---------------------------------------------------------
    def start(self, probe_now: bool = True) -> "PeerTable":
        """Run one synchronous probe sweep (so the router never starts
        blind-optimistic), then the background prober."""
        if probe_now:
            self._probe_sweep()
        self._thread = threading.Thread(target=self._probe_loop,
                                        name="lfkt-fleet-prober",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.probe_timeout + self.probe_seconds)
            self._thread = None

    # -- the routing surface ----------------------------------------------
    def addrs(self) -> list[str]:
        """EVERY known replica, healthy or not — the rendezvous domain
        (ownership must not migrate while a peer merely flaps)."""
        with self._lock:
            return list(self._peers)

    def healthy(self) -> list[str]:
        with self._lock:
            return [p.addr for p in self._peers.values() if p.healthy]

    def is_healthy(self, addr: str) -> bool:
        with self._lock:
            p = self._peers.get(addr)
            return p is not None and p.healthy

    def is_fresh(self, addr: str, window: float) -> bool:
        """True iff ``addr`` (re)joined the serving set within
        ``window`` seconds — the router's cue that the rendezvous owner
        probably restarted cold and should be stamped with a prior
        owner to pull warm pages from (``LFKT_MIGRATE_FRESH_SECONDS``;
        0 disables)."""
        if window <= 0:
            return False
        with self._lock:
            p = self._peers.get(addr)
            return (p is not None and p.fresh_at > 0
                    and time.time() - p.fresh_at < window)

    def eject(self, addr: str, reason: str) -> None:
        """Mark a replica dead with attribution (prober or router-observed
        failure).  Repeated ejections before a successful probe double the
        backoff, so a hard-down pod costs one probe per backoff window,
        not one per cycle."""
        # reasons can embed peer-response fragments (a probe's error
        # body, an upstream exception message) — sanitize before they
        # reach the log line and the /health peers block
        reason = sanitize_text(reason)
        now = time.time()
        with self._lock:
            p = self._peers.get(addr)
            if p is None:
                return
            first = p.healthy
            p.healthy = False
            p.last_error = reason
            p.ejected_at = now
            p.backoff = (min(self.backoff_max,
                             p.backoff * 2 if p.backoff else
                             self.backoff_seconds))
            p.next_probe = now + p.backoff
            if first:
                p.ejections += 1
        if first:
            logger.warning("fleet: ejected replica %s (%s); re-probe in "
                           "%.1fs", addr, reason, p.backoff)
            self._emit("inc", "fleet_peer_ejections_total", peer=addr)
            hook = self.on_eject
            if hook is not None:
                try:
                    hook(addr, reason)
                except Exception:  # noqa: BLE001 — an observability hook
                    # must never turn an ejection into a router failure
                    logger.exception("fleet: on_eject hook failed")

    def _readmit(self, addr: str) -> None:
        with self._lock:
            p = self._peers.get(addr)
            if p is None:
                return
            was_dead = not p.healthy
            p.healthy = True
            p.backoff = 0.0
            p.last_error = None
            if was_dead:
                p.fresh_at = time.time()
        if was_dead:
            logger.info("fleet: re-admitted replica %s", addr)

    def snapshot(self) -> dict:
        """The router's /health ``peers`` block: per-replica state with
        the attributed ejection reason — a dead pod is named, never
        inferred from traffic shape."""
        with self._lock:
            rows = [{
                "addr": p.addr,
                "healthy": p.healthy,
                "ejections": p.ejections,
                "last_error": p.last_error,
                "backoff_seconds": round(p.backoff, 3) if not p.healthy
                else 0.0,
                "source": "static" if p.static else "dns",
            } for p in self._peers.values()]
        rows.sort(key=lambda r: r["addr"])
        return {
            "replicas": len(rows),
            "healthy": sum(r["healthy"] for r in rows),
            "peers": rows,
        }

    # -- probing -----------------------------------------------------------
    def probe(self, addr: str) -> tuple[bool, str | None]:
        """One GET ``probe_path`` against ``addr``: (ready, error)."""
        host, _, port = addr.rpartition(":")
        try:
            conn = http.client.HTTPConnection(host, int(port),
                                              timeout=self.probe_timeout)
            try:
                conn.request("GET", self.probe_path)
                resp = conn.getresponse()
                resp.read()
                if resp.status == 200:
                    return True, None
                return False, f"probe {self.probe_path} -> {resp.status}"
            finally:
                conn.close()
        except (OSError, http.client.HTTPException, ValueError) as e:
            # OSError = dead socket; HTTPException (BadStatusLine...) =
            # a port answering non-HTTP (half-dead process, wrong
            # service) — both are one peer's problem and must never
            # abort the sweep probing the REST of the fleet
            return False, f"probe failed: {type(e).__name__}: {e}"

    def _resolve_dns(self) -> None:
        """Refresh the peer set from the headless Service: one A record
        per ready pod.  Resolution failure keeps the last known set (a
        transient DNS blip must not empty the fleet)."""
        name, _, port = self.dns.rpartition(":")
        try:
            infos = socket.getaddrinfo(name, int(port),
                                       type=socket.SOCK_STREAM)
        except OSError as e:
            logger.warning("fleet: DNS resolution of %s failed (%s); "
                           "keeping the current peer set", self.dns, e)
            return
        live = {f"{info[4][0]}:{port}" for info in infos}
        with self._lock:
            for addr in live:
                if addr not in self._peers:
                    self._peers[addr] = _Peer(addr, static=False)
            for addr in [a for a, p in self._peers.items()
                         if not p.static and a not in live]:
                del self._peers[addr]

    def _probe_sweep(self) -> None:
        if self.dns:
            self._resolve_dns()
        now = time.time()
        with self._lock:
            due = [p.addr for p in self._peers.values()
                   if p.healthy or now >= p.next_probe]
        for addr in due:
            t0 = time.time()
            ok, err = self.probe(addr)
            # success AND failure both observe: a peer whose probes
            # crawl toward probe_timeout is about to be ejected, and the
            # tuning signal must include the timeouts it already hit
            self._emit("observe", "fleet_probe_seconds",
                       time.time() - t0, peer=addr)
            if ok:
                self._readmit(addr)
            else:
                self.eject(addr, err or "probe failed")
        self._emit("set_gauge", "fleet_peers_healthy", len(self.healthy()))

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_seconds):
            try:
                self._probe_sweep()
            except Exception as e:  # noqa: BLE001 — the prober must outlive
                # any single bad cycle; the next sweep re-evaluates
                logger.error("fleet prober sweep failed: %s", e)

"""Fleet-global KV survivability: warm-page migration between replicas.

The port's copy of the JAX package's module
(llama_fastapi_k8s_gpu_tpu/serving/fleet/migrate.py), over the port's page
wire (serving/disagg/wire.py, transport.py — byte-equal with the JAX
package's, so a port replica and a JAX replica exchange pages).  The radix
prefix cache (parallel/kvpool.py) is the fleet's most valuable soft state;
without this module it dies with its pod.  Committed pages outlive any
single pod three ways:

pull-on-remap
    When affinity remaps a conversation (owner died, was ejected, or the
    fleet scaled), the router stamps ``x-lfkt-prior-owner`` on the
    forwarded request and the newly assigned replica pulls that
    conversation's radix pages from the prior owner BEFORE prefilling
    (server/app.py admission).  ``KVPool.import_pages`` dedups against
    anything already cached; every wire failure degrades to local
    recompute with attribution (``kv_migration_failures_total{reason}``
    and the /health ``migration`` block), bounded by the request's
    remaining deadline — never a hang.

graceful drain
    A DRAINING pod (SIGTERM → server/httpd.py) pushes its hottest
    conversations to their rendezvous-successor peers before terminating:
    for each recorded affinity key the successor is ``rendezvous_rank(key,
    fleet - self)[0]``, and the push is a COMMANDED PULL — ``POST
    /admin/migrate/pull`` on the successor, which pulls the pages from this
    pod's still-running page service.  Bounded by
    ``LFKT_MIGRATE_DRAIN_SECONDS``.

scale-out warm-up
    A new replica pre-pulls the fleet's hottest prefixes (``GET
    /admin/migrate/hot`` on each peer → ``KVPool.hot_prefixes``) before
    going READY.

The page service (:class:`MigrationServer`) mirrors the disagg prefill
service but serves ALREADY-COMMITTED pages — ``match_len`` → ``acquire``
(pin) → ``export_pages`` → PAGE frames — so it never touches the engine,
and a cold miss answers a cheap ``DONE tokens=0``.  The ``migrate_push``
fault point fires between PAGE groups, ``migrate_pull`` inside the pull
hop, ``drain_push`` inside the drain loop.  PAGE payloads decode to host
tensors over the received bytes (``torch.frombuffer``); the pull
concatenates each leaf's groups and imports them into the arena.

Armed by ``LFKT_MIGRATE=1`` (requires ``LFKT_KV_PAGED=1``).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import socket
import threading
import time
from collections import OrderedDict

import torch

from ...obs.logctx import sanitize_text
from ...obs.trace import TRACER, span_traceparent
from ...utils.faults import FAULTS, FaultError
from ..disagg import wire
from ..disagg.transport import FrameConn, FrameSender, connect
from .affinity import rendezvous_rank

logger = logging.getLogger(__name__)

#: handshake must complete promptly; the REQ loop then waits unbounded
#: (a peer holding its connection open between pulls is normal)
_HANDSHAKE_TIMEOUT_S = 30.0

#: affinity keys remembered for drain (newest evicts oldest): bounds the
#: drain candidate set AND this map's host RAM — ids are token lists, so
#: 512 entries of a 32k conversation is ~130 MB worst case, fine for a
#: serving pod and irrelevant for tests
_RECORD_CAP = 512


class MigrationServer:
    """Serves this replica's committed KV pages to pulling peers.

    Same wire conversation as the disagg prefill service — HELLO
    geometry handshake (incompatible pools refuse with attribution,
    never exchange bytes), then REQ → PAGE* → DONE — but backed by the
    pool's radix index instead of the engine: a request for ids this
    pod never cached answers ``DONE tokens=0`` without touching a
    device.  Pages are pinned (``acquire``) for exactly the export
    copy, so eviction can never tear an in-flight transfer.
    """

    # accept loop + one handler thread per peer; the sender registry and
    # counters cross threads under one mutex.  The listener/stop flag are
    # written once at construction/stop (reference stores).

    # accept loop + one handler thread per peer; the sender registry and
    # counters cross threads under one mutex.  The listener/stop flag are
    # written once at construction/stop (reference stores).
    _GUARDED_BY = {"_senders": "_lock", "counters": "_lock"}
    _THREAD_ENTRIES = ("_accept_loop", "_serve_conn")
    _SHARED_ATOMIC = ("_stop", "_sock", "port", "metrics", "_tracer")

    def __init__(self, pool, host: str = "0.0.0.0", port: int = 0,
                 queue_frames: int = 32, metrics=None, tracer=None):
        self._pool = pool
        self._geometry = wire.pool_geometry(pool)
        self._queue_frames = max(1, int(queue_frames))
        self.metrics = metrics
        # the process tracer unless a test injects a private one; the
        # REQ's ``trace`` field (wire schema 2) links this pod's serve-
        # side span fragments under the pulling request's trace id
        self._tracer = tracer if tracer is not None else TRACER
        self._lock = threading.Lock()
        self._senders: dict[int, FrameSender] = {}
        self.counters = {"peers_total": 0, "pulls_served": 0,
                         "pulls_cold": 0, "pages_sent": 0, "bytes_sent": 0,
                         "handshake_refusals": 0, "request_errors": 0}
        self._stop = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(
            target=self._accept_loop, name="lfkt-migrate-accept",
            daemon=True)
        self._thread.start()
        logger.info("kv migration page service listening on %s:%d "
                    "(page_tokens=%d)", host, self.port, pool.page_tokens)

    # -- telemetry (never fails serving; the KVPool idiom) -----------------
    def _emit(self, kind: str, name: str, value: float = 1.0, **labels):
        m = self.metrics
        if m is None:
            return
        try:
            getattr(m, kind)(name, value, **labels)
        except Exception:  # noqa: BLE001 — telemetry must never fail serving
            pass

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def status(self) -> dict:
        """The /health ``migration.service`` block."""
        with self._lock:
            out = dict(self.counters)
            out["peers_connected"] = len(self._senders)
        out["port"] = self.port
        return out

    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                sock, peer = self._sock.accept()
            except OSError:
                return          # listener closed: stop()
            self._count("peers_total")
            threading.Thread(target=self._serve_conn, args=(sock, peer),
                             name="lfkt-migrate-peer", daemon=True).start()

    def _serve_conn(self, sock: socket.socket, peer) -> None:
        conn = FrameConn(sock)
        sender = None
        try:
            conn.settimeout(_HANDSHAKE_TIMEOUT_S)
            ftype, hello, _ = conn.recv_frame()
            if ftype != wire.FRAME_HELLO:
                conn.send_frame(wire.FRAME_ERR, {
                    "rid": None, "code": "protocol",
                    "error": f"expected HELLO, got "
                             f"{wire.FRAME_NAMES.get(ftype, ftype)}"})
                return
            mismatch = wire.geometry_mismatch(self._geometry, hello)
            if mismatch is not None:
                # the load-bearing refusal: two pools that cannot exchange
                # pages bit-exactly must never try — attribution instead
                # of corrupted KV
                self._count("handshake_refusals")
                logger.error("kv migration handshake refused for %s: %s",
                             peer, sanitize_text(mismatch))
                conn.send_frame(wire.FRAME_ERR, {
                    "rid": None, "code": "geometry", "error": mismatch})
                return
            conn.send_frame(wire.FRAME_HELLO_OK,
                            {"wire_schema": wire.WIRE_SCHEMA})
            conn.settimeout(None)
            sender = FrameSender(conn, self._queue_frames)
            with self._lock:
                self._senders[id(sender)] = sender
            while not self._stop:
                ftype, hdr, _ = conn.recv_frame()
                if ftype != wire.FRAME_REQ:
                    raise wire.WireError(
                        f"expected REQ, got "
                        f"{wire.FRAME_NAMES.get(ftype, ftype)}")
                self._serve_request(sender, hdr)
        except ConnectionError:
            logger.debug("kv migration peer left: %s", peer)
        except (wire.WireError, OSError, FaultError) as e:
            # includes the migrate_push drill (FaultError raised through
            # _serve_request's page loop): hard-close mid-stream — the
            # pulling side must degrade to local recompute, never hang
            logger.warning("kv migration peer %s dropped: %s", peer, e)
        except Exception:  # noqa: BLE001 — one peer must not kill the service
            logger.exception("kv migration peer handler failed for %s", peer)
        finally:
            if sender is not None:
                with self._lock:
                    self._senders.pop(id(sender), None)
                sender.close(join_timeout=0.5)
            conn.close()

    def _serve_request(self, sender: FrameSender, hdr: dict) -> None:
        # server-side fragment of the pulling request's trace: the REQ's
        # ``trace`` field (wire schema 2) carries the puller's span
        # context.  start_linked returns None unless this process samples
        # AND the field parsed — untraced pulls pay two cheap guards.
        trace = self._tracer.start_linked("kv.migrate.serve",
                                          hdr.get("trace"))
        try:
            self._serve_request_traced(sender, hdr, trace)
        finally:
            # None-tolerant; sweeps spans an error path left open
            # (auto_closed) so a torn transfer still exports a fragment
            self._tracer.finish(trace)

    def _serve_request_traced(self, sender: FrameSender, hdr: dict,
                              trace) -> None:
        rid = hdr.get("rid")
        ids = hdr.get("ids")
        ns = str(hdr.get("namespace") or "")
        deadline = hdr.get("deadline")
        if not isinstance(ids, list) or not ids \
                or not all(isinstance(t, int) for t in ids):
            if trace is not None:
                trace.root.set(error="request: bad ids")
            sender.put(wire.FRAME_ERR, {
                "rid": rid, "code": "request",
                "error": "REQ ids must be a non-empty list of ints"})
            return
        if trace is not None:
            # rid/namespace are peer-supplied — sanitize before they
            # ride the /debug/traces export and the waterfall renderer
            trace.root.set(rid=sanitize_text(rid, limit=64),
                           namespace=sanitize_text(ns, limit=64),
                           tokens=len(ids))

        def put_timeout() -> float:
            # backpressure bound: a send queue still full past the pull's
            # own deadline means the wire cannot carry this transfer in
            # time — tear it down rather than stall the pod
            if deadline is not None:
                return max(0.1, float(deadline) - time.time())
            return 30.0

        if deadline is not None and time.time() > float(deadline):
            sender.put(wire.FRAME_ERR, {
                "rid": rid, "code": "deadline",
                "error": "deadline expired before page export"})
            return
        pool = self._pool
        matched = pool.match_len(ids, namespace=ns)
        lease = (pool.acquire(ids[:matched], matched, namespace=ns)
                 if matched else None)
        if lease is None:
            # cold (or the pages were evicted between peek and pin): a
            # cheap honest miss — the puller recomputes locally
            self._count("pulls_cold")
            if trace is not None:
                trace.root.set(cold=True)
            sender.put(wire.FRAME_DONE, {"rid": rid, "tokens": 0,
                                         "n_pages": 0, "first_token": None},
                       timeout=put_timeout())
            return
        sp = trace.span("pool.export") if trace is not None else None
        try:
            try:
                leaves = pool.export_pages(lease)
            finally:
                # the export already holds host copies; unpin before the
                # (possibly slow) wire send so a stalled peer never holds
                # this pod's arena pages hostage
                pool.release(lease)
        except Exception as e:  # noqa: BLE001 — per-request isolation: the
            # pulling side degrades to local recompute with this attribution
            self._count("request_errors")
            logger.warning("kv migration export failed: %s", e)
            if sp is not None:
                sp.set(error=sanitize_text(
                    f"{type(e).__name__}: {e}", limit=256)).end()
            sender.put(wire.FRAME_ERR, {
                "rid": rid, "code": "export",
                "error": f"{type(e).__name__}: {e}"})
            return
        if sp is not None:
            sp.end()
        tokens = lease.tokens
        n_pages = tokens // pool.page_tokens
        # one span per wire transfer, one kv_pages event per PAGE group —
        # the waterfall's ▓ bar covers exactly the bytes-on-the-wire time
        sp_send = trace.span("wire.send") if trace is not None else None
        sent_bytes = 0
        off = seq = 0
        while off < n_pages:
            # drill point: the warm side dying MID-STREAM (FaultError
            # propagates to _serve_conn, which hard-closes the socket
            # between page groups — the puller sees a torn transfer)
            FAULTS.fire("migrate_push")
            g = min(wire.PAGE_GROUP, n_pages - off)
            payload = wire.encode_pages(
                [leaf[off:off + g] for leaf in leaves])
            sender.put(wire.FRAME_PAGE,
                       {"rid": rid, "seq": seq, "n_pages": g},
                       payload, timeout=put_timeout())
            self._count("pages_sent", g)
            self._count("bytes_sent", len(payload))
            if sp_send is not None:
                sent_bytes += len(payload)
                sp_send.event("kv_pages", seq=seq, pages=g,
                              bytes=len(payload))
            off += g
            seq += 1
        sender.put(wire.FRAME_DONE,
                   {"rid": rid, "tokens": tokens, "n_pages": n_pages,
                    "first_token": None}, timeout=put_timeout())
        if sp_send is not None:
            sp_send.set(pages=n_pages, bytes=sent_bytes).end()
        self._count("pulls_served")
        self._emit("inc", "kv_migration_pushes_total")
        self._emit("inc", "kv_migration_pages_total", n_pages,
                   reason="pushed")

    def stop_accepting(self) -> None:
        """Close the listener only: no NEW pullers, in-flight transfers
        keep streaming — a DRAINING pod's successors are still pulling
        from it (server/httpd.py drain window)."""
        try:
            self._sock.close()
        except OSError:
            pass

    def stop(self) -> None:
        self._stop = True
        self.stop_accepting()
        with self._lock:
            senders = list(self._senders.values())
            self._senders.clear()
        for s in senders:
            s.close(join_timeout=0.5)


class MigrationManager:
    """One replica's migration brain: the pull client, the affinity-key
    record used to find drain successors, warm-up and drain
    orchestration, and the /health ``migration`` block.

    Every public entry point is NEVER-RAISE and deadline-bounded: a
    migration that cannot complete degrades (to local recompute, or to
    plain termination) with an attributed reason — it must not take the
    serving path down with it.
    """

    # request-handler threads pull concurrently while the drain/warm-up
    # paths read the record map; one mutex guards the shared dicts and
    # counters.  Pull hops use a FRESH connection each (no shared conn
    # state).

    # request-handler threads pull concurrently while the drain/warm-up
    # paths read the record map; one mutex guards the shared dicts and
    # counters.  Pull hops use a FRESH connection each (no shared conn
    # state), so no hop lock exists to rank against.
    _GUARDED_BY = {"_records": "_lock", "_wire_cache": "_lock",
                   "counters": "_lock", "last_error": "_lock",
                   "_last_key_digest": "_lock"}
    _SHARED_ATOMIC = ("metrics", "_closed")

    def __init__(self, pool, settings, metrics=None, health=None,
                 server: MigrationServer | None = None):
        self._pool = pool
        self._geometry = wire.pool_geometry(pool)
        self.settings = settings
        self.metrics = metrics
        self.health = health
        self.server = server
        self.timeout = float(settings.migrate_timeout_seconds)
        self.top_k = int(settings.migrate_top_k)
        self.drain_budget = float(settings.migrate_drain_seconds)
        self._lock = threading.Lock()
        #: affinity key -> (namespace, ids tuple), newest last (LRU)
        self._records: OrderedDict[str, tuple[str, tuple]] = OrderedDict()
        #: peer HTTP addr -> wire "host:port" (dropped on pull failure)
        self._wire_cache: dict[str, str] = {}
        self.counters = {"pulls": 0, "pulled_pages": 0, "pulled_tokens": 0,
                         "skipped_warm": 0, "failures": 0,
                         "drain_pushes": 0, "drain_failures": 0,
                         "warmup_pulls": 0}
        self.last_error = None
        #: digest of the most recent router-stamped affinity key — the
        #: incident-bundle attribution linking a replica's capture to the
        #: conversation it was serving (never the raw client-settable key)
        self._last_key_digest = None
        self._closed = False

    # -- identity ----------------------------------------------------------
    @property
    def wire_addr(self) -> str:
        """This pod's page-service address as PEERS can reach it: the
        fleet-visible host (LFKT_MIGRATE_SELF) + the service's actual
        bound port (ephemeral ports work in tests)."""
        host = (self.settings.migrate_self.rpartition(":")[0]
                or (self.settings.migrate_bind
                    if self.settings.migrate_bind not in ("", "0.0.0.0")
                    else "127.0.0.1"))
        port = self.server.port if self.server is not None else 0
        return f"{host}:{port}"

    def _others(self) -> list[str]:
        """The OTHER replicas' HTTP addrs — warm-up sources and drain
        successors.  LFKT_FLEET_PEERS minus LFKT_MIGRATE_SELF; when the
        static list is empty, one headless-Service DNS resolution
        (LFKT_FLEET_DNS, the peers.py discovery idiom) so k8s replicas
        need no peer list baked into the pod spec."""
        me = self.settings.migrate_self.strip()
        out = [a.strip() for a in self.settings.fleet_peers.split(",")
               if a.strip() and a.strip() != me]
        if not out and self.settings.fleet_dns:
            name, _, port = self.settings.fleet_dns.rpartition(":")
            try:
                infos = socket.getaddrinfo(name, int(port),
                                           type=socket.SOCK_STREAM)
            except (OSError, ValueError) as e:
                self._fail("resolve",
                           f"fleet DNS {self.settings.fleet_dns}: {e}")
                return []
            out = sorted({f"{info[4][0]}:{port}" for info in infos}
                         - {me})
        return out

    # -- telemetry ---------------------------------------------------------
    def _emit(self, kind: str, name: str, value: float = 1.0, **labels):
        m = self.metrics
        if m is None:
            return
        try:
            getattr(m, kind)(name, value, **labels)
        except Exception:  # noqa: BLE001 — telemetry must never fail serving
            pass

    def _fail(self, reason: str, msg: str, *, drain: bool = False) -> int:
        """Attribute one degraded migration attempt; always returns 0 so
        callers can ``return self._fail(...)``."""
        # msg (and sometimes reason — callers pass the wire-frame "code"
        # field through) carries peer-supplied bytes — sanitize before
        # the log line and the /health last_error echo
        reason = sanitize_text(reason, limit=64)
        msg = sanitize_text(msg)
        with self._lock:
            self.counters["drain_failures" if drain else "failures"] += 1
            self.last_error = f"{reason}: {msg}"
        self._emit("inc", "kv_migration_failures_total", reason=reason)
        logger.warning("kv migration degraded (%s): %s", reason, msg)
        return 0

    def status(self) -> dict:
        """The /health ``migration`` block: the wire addr peers resolve
        through, every counter, and the last attributed failure."""
        with self._lock:
            out = {"addr": self.wire_addr, "counters": dict(self.counters),
                   "records": len(self._records),
                   "last_affinity_key": self._last_key_digest,
                   "last_error": self.last_error}
        if self.server is not None:
            out["service"] = self.server.status()
        return out

    # -- conversation recording (drain's candidate set) --------------------
    def record_prompt(self, key: str, namespace: str, ids) -> None:
        """Remember the latest prompt ids for an affinity key — the
        router stamps ``x-lfkt-affinity-key`` on every proxied request,
        and graceful drain replays this map to the keys'
        rendezvous-successor peers."""
        if not key or not ids:
            return
        # digest, never the raw key: affinity keys can carry raw
        # client-settable header bytes, and this value rides /health and
        # the incident bundle's fleet block
        digest = hashlib.sha256(str(key).encode(
            "utf-8", "replace")).hexdigest()[:16]
        with self._lock:
            self._records.pop(key, None)
            self._records[key] = (str(namespace), tuple(ids))
            self._last_key_digest = digest
            while len(self._records) > _RECORD_CAP:
                self._records.popitem(last=False)

    # -- peer resolution ---------------------------------------------------
    def _http_json(self, addr: str, method: str, path: str,
                   body: dict | None, timeout: float) -> dict:
        """One bounded JSON round-trip to a peer's HTTP port (raises on
        any failure — callers attribute)."""
        host, _, port = addr.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload,
                         headers={"content-type": "application/json"}
                         if payload else {})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise OSError(f"{method} {path} -> {resp.status}")
            return json.loads(data)
        finally:
            conn.close()

    def _resolve_wire(self, http_addr: str, budget: float) -> str | None:  # lfkt: sanitizes[peer-http] -- http_addr comes from the admitted PeerTable (or the router's commanded drain), so the /health doc it fetches is as trusted as the peer set itself; the addr:port shape check below bounds what a misbehaving peer can redirect a pull to
        """A peer's page-service wire addr, via its /health ``migration``
        block (cached; ephemeral ports make this discovery, not config).
        ``http_addr`` is a router stamp or a commanded drain, so the
        document is as trusted as the peer set; the addr:port shape check
        bounds where a misbehaving peer can redirect a pull."""
        with self._lock:
            cached = self._wire_cache.get(http_addr)
        if cached:
            return cached
        try:
            doc = self._http_json(http_addr, "GET", "/health", None,
                                  max(0.1, budget))
            addr = doc.get("migration", {}).get("addr")
        except (OSError, ValueError, http.client.HTTPException) as e:
            self._fail("resolve", f"{http_addr}: {type(e).__name__}: {e}")
            return None
        if not addr or ":" not in str(addr):
            self._fail("resolve", f"{http_addr} has no migration service "
                                  "(LFKT_MIGRATE off or mixed rollout)")
            return None
        with self._lock:
            self._wire_cache[http_addr] = str(addr)
        return str(addr)

    def _drop_wire(self, http_addr: str | None) -> None:
        if http_addr is None:
            return
        with self._lock:
            self._wire_cache.pop(http_addr, None)

    # -- the pull hop ------------------------------------------------------
    def pull(self, peer_wire: str, ids, *, namespace: str = "",
             reason: str = "remap", deadline: float | None = None,
             span=None) -> int:
        """Pull the whole-page prefix of ``ids`` from ``peer_wire``
        (``host:port`` of a peer's page service) into the local pool.
        Returns tokens now covered locally; NEVER raises — every failure
        path attributes a reason and returns 0 (the caller's local
        recompute is always correct, just colder).  Budget = the hop
        knob clipped to the request's remaining ``deadline``."""
        if self._closed:
            return 0
        pool = self._pool
        T = pool.page_tokens
        n = len(ids)
        # a remap pull feeds an imminent prefill, which needs >= 1
        # uncached token; warm-up/drain rows are whole cached runs
        target = (((n - 1) // T) * T) if reason == "remap" else ((n // T) * T)
        if target < T:
            return 0
        if pool.match_len(ids[:target], namespace=namespace) >= target:
            with self._lock:
                self.counters["skipped_warm"] += 1
            return target
        budget = self.timeout
        if deadline is not None:
            budget = min(budget, deadline - time.time())
        if budget <= 0:
            return self._fail("deadline", f"no time left to pull from "
                                          f"{peer_wire}")
        self._emit("inc", "kv_migration_pulls_total", reason=reason)
        with self._lock:
            self.counters["pulls"] += 1
            if reason == "warmup":
                self.counters["warmup_pulls"] += 1
        host, _, port = peer_wire.rpartition(":")
        t0 = time.time()
        conn = None
        rid = f"mig-{reason}-{t0:.6f}"
        try:
            # drill point: error mode degrades this hop with attribution,
            # slow mode eats the budget (the deadline math below must
            # still bound the hop — never a hang)
            FAULTS.fire("migrate_pull")
            # a hop whose budget ran out before the dial is the deadline's,
            # whatever the wire would have done in the time left
            if budget - (time.time() - t0) <= 0:
                return self._fail("deadline", f"pull from {peer_wire} overran its "
                                              f"{budget:.1f}s budget before the dial")
            conn = connect(host, int(port), max(0.1, budget - (time.time() - t0)))
            conn.send_frame(wire.FRAME_HELLO, self._geometry)
            ftype, hdr, _ = conn.recv_frame()
            if ftype == wire.FRAME_ERR:
                return self._fail(str(hdr.get("code") or "refused"),
                                  f"{peer_wire}: {hdr.get('error')}")
            if ftype != wire.FRAME_HELLO_OK:
                return self._fail("protocol",
                                  f"{peer_wire}: expected HELLO_OK, got "
                                  f"{wire.FRAME_NAMES.get(ftype, ftype)}")
            # wire schema 2: the REQ carries the caller's span context
            # (None when sampled out) so the warm side's span tree links
            # under the pulling request's trace id
            conn.send_frame(wire.FRAME_REQ, {
                "rid": rid, "namespace": namespace,
                "ids": [int(t) for t in ids[:target]],
                "deadline": time.time() + max(0.1,
                                              budget - (time.time() - t0)),
                "trace": span_traceparent(span)})
            groups: list[list] = []
            got_pages = 0
            wire_bytes = 0
            while True:
                remaining = budget - (time.time() - t0)
                if remaining <= 0:
                    return self._fail("deadline",
                                      f"pull from {peer_wire} overran its "
                                      f"{budget:.1f}s budget")
                conn.settimeout(remaining)
                ftype, hdr, payload = conn.recv_frame()
                if ftype == wire.FRAME_PAGE:
                    g = int(hdr.get("n_pages") or 0)
                    groups.append(wire.decode_pages(payload, g,
                                                    self._geometry))
                    got_pages += g
                    wire_bytes += len(payload)
                    continue
                if ftype == wire.FRAME_ERR:
                    return self._fail(str(hdr.get("code") or "refused"),
                                      f"{peer_wire}: {hdr.get('error')}")
                if ftype == wire.FRAME_DONE:
                    tokens = int(hdr.get("tokens") or 0)
                    if tokens != got_pages * T:
                        return self._fail(
                            "wire", f"{peer_wire}: DONE claims {tokens} "
                                    f"tokens but {got_pages} pages arrived")
                    break
                return self._fail("protocol",
                                  f"{peer_wire}: unexpected "
                                  f"{wire.FRAME_NAMES.get(ftype, ftype)}")
            if tokens <= 0:
                return 0        # honest cold miss on the far side
            leaves = [torch.cat([g[i] for g in groups], dim=0)
                      for i in range(len(groups[0]))]
            try:
                covered = pool.import_pages(ids[:tokens], leaves,
                                            namespace=namespace, span=span)
            except Exception as e:  # noqa: BLE001 — a rejected import is
                # one degraded pull, not a pod failure
                return self._fail("import", f"{type(e).__name__}: {e}")
            dt = time.time() - t0
            with self._lock:
                self.counters["pulled_pages"] += got_pages
                self.counters["pulled_tokens"] += covered
            self._emit("inc", "kv_migration_pages_total", got_pages,
                       reason="pulled")
            self._emit("observe", "kv_migration_seconds", dt)
            if span is not None:
                try:
                    span.event("kv_migrate_pull", peer=peer_wire,
                               reason=reason, pages=got_pages,
                               tokens=covered, bytes=wire_bytes,
                               host_s=round(dt, 6))
                except Exception:  # noqa: BLE001 — tracing never fails pulls
                    pass
            return covered
        except (wire.WireError, ConnectionError, OSError, FaultError) as e:
            return self._fail("wire", f"{peer_wire}: {type(e).__name__}: {e}")
        finally:
            if conn is not None:
                conn.close()

    # -- the three triggers ------------------------------------------------
    def pull_for_request(self, prior_http: str, namespace: str, ids,
                         deadline: float | None = None, span=None) -> int:
        """Pull-on-remap (server/app.py admission): ``prior_http`` is the
        router's ``x-lfkt-prior-owner`` stamp (an HTTP addr)."""
        budget = self.timeout
        if deadline is not None:
            budget = min(budget, deadline - time.time())
        peer = self._resolve_wire(prior_http, budget)
        if peer is None:
            return 0
        got = self.pull(peer, ids, namespace=namespace, reason="remap",
                        deadline=deadline, span=span)
        if got == 0:
            # a dead prior owner must not poison the cache for the next
            # remap (its replacement pod will answer /health afresh)
            self._drop_wire(prior_http)
        return got

    def warm_up(self) -> int:
        """Scale-out warm-up (server/app.py startup, BEFORE READY):
        pre-pull every peer's hottest prefixes.  Bounded by the drain
        budget — a slow fleet delays readiness by at most that, never
        indefinitely.  Returns tokens pulled."""
        t0 = time.time()
        total = 0
        for peer_http in self._others():
            remaining = self.drain_budget - (time.time() - t0)
            if remaining <= 0:
                self._fail("deadline", "warm-up budget exhausted with "
                                       "peers left unvisited")
                break
            try:
                doc = self._http_json(peer_http, "GET",
                                      f"/admin/migrate/hot?k={self.top_k}",
                                      None, max(0.1, min(remaining,
                                                         self.timeout)))
                rows = doc.get("prefixes") or []
            except (OSError, ValueError, http.client.HTTPException) as e:
                self._fail("resolve",
                           f"{peer_http}: {type(e).__name__}: {e}")
                continue
            peer_wire = self._resolve_wire(
                peer_http, max(0.1, min(remaining, self.timeout)))
            if peer_wire is None:
                continue
            for row in rows:
                remaining = self.drain_budget - (time.time() - t0)
                if remaining <= 0:
                    break
                total += self.pull(peer_wire, list(row.get("ids") or []),
                                   namespace=str(row.get("namespace") or ""),
                                   reason="warmup",
                                   deadline=time.time() + remaining)
        if total:
            logger.info("kv migration warm-up pulled %d tokens in %.2fs",
                        total, time.time() - t0)
        return total

    def drain_push(self) -> int:
        """Graceful drain (server/httpd.py SIGTERM window): command each
        recorded conversation's rendezvous successor to pull it from
        this pod's still-open page service.  Bounded by
        LFKT_MIGRATE_DRAIN_SECONDS; every failure degrades to normal
        termination with attribution.  Returns conversations handed
        off."""
        self._closed = True          # no new outbound pulls from this pod
        others = self._others()
        if not others:
            return 0
        with self._lock:
            newest_first = list(reversed(self._records.items()))
        rows = [(key, ns, list(ids))
                for key, (ns, ids) in newest_first[:self.top_k]]
        if not rows:
            # no router-stamped traffic seen (direct serving): hand the
            # pool's hottest runs to the first peer so they survive anyway
            rows = [(None, str(r["namespace"]), list(r["ids"]))
                    for r in self._pool.hot_prefixes(self.top_k)]
        t0 = time.time()
        pushed = 0
        for key, ns, ids in rows:
            remaining = self.drain_budget - (time.time() - t0)
            if remaining <= 0:
                self._fail("deadline", "drain budget exhausted with "
                                       f"{len(rows) - pushed} conversations "
                                       "left", drain=True)
                break
            successor = (rendezvous_rank(key, others)[0] if key
                         else others[0])
            try:
                # drill point: a failed handoff must degrade to normal
                # termination (attributed), never delay shutdown
                FAULTS.fire("drain_push")
                self._http_json(
                    successor, "POST", "/admin/migrate/pull",
                    {"namespace": ns, "ids": [int(t) for t in ids],
                     "peer": self.wire_addr,
                     "deadline": time.time() + max(0.1, min(remaining,
                                                            self.timeout))},
                    max(0.1, min(remaining, self.timeout)))
            except (OSError, ValueError, http.client.HTTPException,
                    FaultError) as e:
                self._fail("drain_push",
                           f"{successor}: {type(e).__name__}: {e}",
                           drain=True)
                continue
            pushed += 1
            with self._lock:
                self.counters["drain_pushes"] += 1
        logger.info("kv migration drain pushed %d/%d conversations in "
                    "%.2fs", pushed, len(rows), time.time() - t0)
        return pushed

    def close(self) -> None:
        self._closed = True
        if self.server is not None:
            self.server.stop()


def build_migration(engine, settings, metrics=None,
                    health=None) -> MigrationManager:
    """Arm warm-page migration for one replica (``LFKT_MIGRATE=1``):
    the page service + the manager, warm-up NOT yet run (the caller
    runs it before flipping READY).  Misconfiguration refuses loudly —
    a fleet silently serving cold is the failure mode this module
    exists to kill."""
    pool = getattr(engine, "_kvpool", None)
    if pool is None:
        raise ValueError(
            "LFKT_MIGRATE=1 requires LFKT_KV_PAGED=1: migration moves "
            "radix KV pages, and only the paged arena has them "
            "(docs/RUNBOOK.md 'Surviving pod churn')")
    server = MigrationServer(pool, host=settings.migrate_bind,
                             port=settings.migrate_port, metrics=metrics)
    return MigrationManager(pool, settings, metrics=metrics, health=health,
                            server=server)

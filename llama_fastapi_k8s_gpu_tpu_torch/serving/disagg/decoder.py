"""The decode replica's remote-prefill client (``LFKT_DISAGG_ROLE=decode``).

The port's copy of the JAX package's client
(llama_fastapi_k8s_gpu_tpu/serving/disagg/decoder.py); received page
stacks are host tensors, concatenated with ``torch.cat``.  One
lazily-dialed connection to the prefill tier; per admitted prompt
one bounded **hop**: send the token ids, receive PAGE frames, import
the page stacks into the local :class:`~...parallel.kvpool.KVPool`
under the request's radix namespace (multi-model streams stay isolated
by construction), so the engine's existing paged-reuse machinery —
lease, restore into the front of the ring, local suffix prefill —
serves the request exactly as if the pages had been committed locally.
A restored prefix therefore ALSO warms the local radix: the next turn
of the same conversation skips the hop entirely (the warm-local check
is the first thing :meth:`DisaggClient.prefetch` does).

Degrade paths — the whole point.  :meth:`prefetch` NEVER raises and
never hangs: every hop is bounded by ``min(LFKT_DISAGG_TIMEOUT_SECONDS,
the request's remaining deadline)``, and every failure — peer dead
mid-stream, truncated frame, handshake refusal, timeout — falls back to
LOCAL prefill with attribution: a ``disagg_local_fallbacks_total``
counter labeled by reason, a health transition to DEGRADED with a
``disagg:`` reason (restored to READY by the next successful hop), and
a ``disagg_peer_dead`` flight-recorder bundle on the rising edge.
Reconnects back off exponentially; a geometry/schema refusal is
PERMANENT for the process (reconnecting cannot fix a mis-deployed
fleet — the attribution names the fix).
"""

from __future__ import annotations

import logging
import socket
import threading
import time

import torch

from ...obs import flightrec as _flightrec
from ...obs.logctx import sanitize_text
from ...obs.trace import span_traceparent
from ...utils.health import DEGRADED, READY
from . import wire
from .transport import connect

logger = logging.getLogger(__name__)

_BACKOFF_START_S = 1.0
_BACKOFF_MAX_S = 30.0


class DisaggClient:
    """Remote-prefill client bound to one prefill peer and one KVPool."""

    # hops are serialized by _hop_lock (one framed connection: interleaved
    # requests would interleave frames); counters/last_error cross between
    # requesting threads and /health readers under _lock.

    # hops are serialized by _hop_lock (one framed connection: interleaved
    # requests would interleave frames); counters/last_error cross between
    # requesting threads and /health readers under _lock.
    _GUARDED_BY = {"counters": "_lock", "last_error": "_lock",
                   "_degraded": "_lock"}
    _SHARED_ATOMIC = ("_conn", "_refused", "_next_retry", "_backoff",
                      "metrics", "_closed")

    def __init__(self, peer: str, pool, timeout_s: float = 5.0,
                 metrics=None, health=None):
        host, _, port = str(peer).rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"LFKT_DISAGG_PEER must be host:port, got {peer!r}")
        self.peer = peer
        self._host, self._port = host, int(port)
        self._pool = pool
        self._geometry = wire.pool_geometry(pool)
        self._timeout = max(0.1, float(timeout_s))
        self.metrics = metrics
        self._health = health
        self._lock = threading.Lock()
        self._hop_lock = threading.Lock()
        self._conn = None
        self._rid = 0
        self._refused: str | None = None   # permanent handshake refusal
        self._next_retry = 0.0
        self._backoff = _BACKOFF_START_S
        self._closed = False
        self._degraded = False   # we hold a disagg DEGRADED on the monitor
        self.counters = {"remote_prefills": 0, "remote_tokens": 0,
                         "remote_misses": 0, "local_fallbacks": 0,
                         "warm_local_skips": 0, "reconnects": 0}
        self.last_error: str | None = None

    # -- telemetry (never fails serving) -----------------------------------
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

    def connected(self) -> bool:
        return self._conn is not None

    def status(self) -> dict:
        """/health ``disagg.peer`` block: where the pages come from, and
        why they stopped coming when they did."""
        with self._lock:
            out = dict(self.counters)
            out["last_error"] = self.last_error
        out["peer"] = self.peer
        out["connected"] = self.connected()
        out["handshake_refused"] = self._refused
        return out

    # ------------------------------------------------------------------
    def prefetch(self, ids, *, namespace: str = "", deadline=None,
                 span=None) -> int:
        """Ensure the local radix covers the whole-page prefix of ``ids``
        via the prefill peer.  Returns the tokens the index covers after
        the hop (0 = nothing imported: warm locally already handled, too
        short, or a degrade — the caller's local prefill serves either
        way).  NEVER raises, never exceeds the hop budget."""
        if self._refused is not None or self._closed:
            return 0
        pool = self._pool
        T = pool.page_tokens
        n = len(ids)
        target = ((n - 1) // T) * T      # max page-aligned USABLE prefix
        if target < T:
            return 0                     # prompt shorter than one page
        if pool.match_len(ids, namespace=namespace) >= target:
            # multi-turn warm path: the imported prefix of an earlier hop
            # (or a local commit) already covers it — no wire round trip
            self._count("warm_local_skips")
            return 0
        hop_err: BaseException | None = None
        with self._hop_lock:
            # budget is computed AFTER the hop lock: hops serialize (one
            # framed connection), and time spent waiting for another
            # request's hop must neither eat this hop's wire budget nor
            # be misread as peer death; a deadline that expired in the
            # wait is a plain skip, not a failure
            budget = self._timeout
            if deadline is not None:
                budget = min(budget, float(deadline) - time.time())
            if budget <= 0.05:
                return 0                 # not worth opening a hop for
            if pool.match_len(ids, namespace=namespace) >= target:
                # the hop we waited behind imported this very prefix
                # (concurrent requests of one conversation)
                self._count("warm_local_skips")
                return 0
            t0 = time.time()
            fresh_dial = self._conn is None
            conn = self._ensure_conn(budget)  # lfkt: blocks-under[_hop_lock] -- hops serialize on one framed connection: the hop lock IS that serialization, and every wire op is budget-bounded
            if conn is None:
                if self._refused is None:
                    self._fallback("peer_unreachable",
                                   self.last_error or "connect failed")
                return 0
            if span is not None and fresh_dial:
                # the handshake's cost is part of THIS hop's story: a
                # waterfall showing a slow first turn must name the dial
                span.event("handshake", peer=self.peer,
                           host_s=round(time.time() - t0, 6))
            try:
                self._rid += 1
                rid = self._rid
                conn.settimeout(max(0.1, budget))
                # wire schema 2: the REQ carries the caller's span context
                # (None when sampled out) so the prefill tier's span tree
                # links under the originating request's trace id
                conn.send_frame(wire.FRAME_REQ, {  # lfkt: blocks-under[_hop_lock] -- hops serialize on one framed connection: the hop lock IS that serialization, and every wire op is budget-bounded
                    "rid": rid, "namespace": namespace,
                    "ids": [int(t) for t in ids], "deadline": deadline,
                    "trace": span_traceparent(span)})
                groups: list[list] = []
                got_pages = 0
                bytes_in = 0
                while True:
                    remaining = budget - (time.time() - t0)
                    if remaining <= 0:
                        raise socket.timeout("disagg hop budget exhausted")
                    conn.settimeout(remaining)
                    ftype, hdr, payload = conn.recv_frame()  # lfkt: blocks-under[_hop_lock] -- hops serialize on one framed connection: the hop lock IS that serialization, and every wire op is budget-bounded
                    if hdr.get("rid") not in (rid, None):
                        raise wire.WireError(
                            f"frame for rid {hdr.get('rid')} inside "
                            f"rid {rid}'s transfer")
                    if ftype == wire.FRAME_PAGE:
                        g = int(hdr.get("n_pages", 0))
                        groups.append(
                            wire.decode_pages(payload, g, self._geometry))
                        got_pages += g
                        bytes_in += len(payload)
                        continue
                    if ftype == wire.FRAME_DONE:
                        tokens = int(hdr.get("tokens") or 0)
                        if got_pages * T != tokens:
                            raise wire.WireError(
                                f"DONE claims {tokens} tokens but "
                                f"{got_pages} page(s) arrived")
                        break
                    if ftype == wire.FRAME_ERR:
                        code = str(hdr.get("code") or "peer_error")
                        msg = str(hdr.get("error") or "")
                        if code in ("geometry", "schema"):
                            self._refuse(msg)
                        elif code == "deadline":
                            # both sides agree the request is dead — not
                            # a peer failure, no health change
                            self._count("remote_misses")
                        else:
                            self._fallback(code, msg)
                        return 0
                    raise wire.WireError(
                        f"unexpected "
                        f"{wire.FRAME_NAMES.get(ftype, ftype)} frame")
            except (wire.WireError, ConnectionError, OSError) as e:
                # socket.timeout is an OSError: one handler for peer
                # death, torn frames, and a wire too slow for the budget.
                # The connection LATCH (drop + backoff) happens here,
                # still under the hop lock — the next hop's _ensure_conn
                # must never race a half-torn connection — but the
                # flight-recorder bundle and health transition run after
                # the lock releases (below): a slow incident-volume
                # write must never stall the NEXT request's hop behind
                # disk I/O
                self._drop_conn()
                hop_err = e
        if hop_err is not None:
            self._peer_dead_report(hop_err)
            return 0
        covered = 0
        if got_pages:
            leaves = [torch.cat([g[i] for g in groups], dim=0)
                      for i in range(len(groups[0]))] \
                if len(groups) > 1 else groups[0]
            try:
                covered = pool.import_pages(ids[:tokens], leaves,
                                            namespace=namespace, span=span)
            except Exception as e:  # noqa: BLE001 — an import that cannot
                # index (pool churn, geometry drift) degrades to local
                # prefill like every other failure
                self._fallback("import", f"{type(e).__name__}: {e}")
                return 0
        dt = time.time() - t0
        if span is not None:
            span.event("disagg_recv", pages=got_pages, tokens=tokens,
                       bytes=bytes_in, host_s=round(dt, 6))
        self._emit("observe", "disagg_transfer_seconds", dt)
        if got_pages:
            self._emit("inc", "disagg_pages_received_total", got_pages)
            self._emit("inc", "disagg_bytes_received_total", bytes_in)
        if covered:
            self._count("remote_prefills")
            self._count("remote_tokens", covered)
            self._emit("inc", "disagg_remote_prefills_total")
        else:
            self._count("remote_misses")
        self._recovered()
        return covered

    # -- connection lifecycle ------------------------------------------
    def _ensure_conn(self, budget: float):
        if self._conn is not None:
            return self._conn
        now = time.time()
        if now < self._next_retry:
            return None                  # inside reconnect backoff
        try:
            conn = connect(self._host, self._port,
                           timeout=min(budget, self._timeout))
            conn.settimeout(min(budget, self._timeout))
            conn.send_frame(wire.FRAME_HELLO, self._geometry)
            ftype, hdr, _ = conn.recv_frame()
            if ftype == wire.FRAME_ERR:
                conn.close()
                self._refuse(str(hdr.get("error") or "handshake refused"))
                return None
            if ftype != wire.FRAME_HELLO_OK:
                raise wire.WireError(
                    f"expected HELLO_OK, got "
                    f"{wire.FRAME_NAMES.get(ftype, ftype)}")
        except (wire.WireError, ConnectionError, OSError) as e:
            with self._lock:
                self.last_error = f"{type(e).__name__}: {e}"
            self._next_retry = now + self._backoff
            self._backoff = min(self._backoff * 2, _BACKOFF_MAX_S)
            return None
        self._conn = conn
        self._backoff = _BACKOFF_START_S
        self._count("reconnects")
        logger.info("disagg prefill peer connected: %s", self.peer)
        return conn

    def _refuse(self, msg: str) -> None:
        """Permanent handshake refusal (schema/geometry): reconnecting
        cannot fix a mis-deployed fleet — pin the attribution, serve
        local prefill for the process lifetime."""
        # msg may quote peer-supplied frame fields (wire "error" text);
        # it reaches the log and the /health echo
        msg = sanitize_text(msg)
        self._refused = msg
        logger.error("disagg handshake refused — serving LOCAL prefill "
                     "for the process lifetime: %s", msg)
        self._emit("inc", "disagg_handshake_refusals_total")
        self._fallback("refused", msg)

    def _drop_conn(self) -> None:
        """Latch a dead connection: drop it and arm the reconnect
        backoff.  Runs UNDER the hop lock (prefetch's except handler):
        the swap must not race a concurrent hop's _ensure_conn — an
        off-lock drop could close a freshly re-established healthy
        connection out from under the next hop."""
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()
        self._next_retry = time.time() + self._backoff
        self._backoff = min(self._backoff * 2, _BACKOFF_MAX_S)

    def _peer_dead_report(self, exc: BaseException) -> None:
        """Attribution for a transport/wire failure mid-hop: degrade
        with a flight-recorder bundle.  Runs OFF the hop lock: the bundle
        is disk I/O and must not stall the next request's hop."""
        msg = f"{type(exc).__name__}: {exc}"
        # the black box: by the time an operator looks, the socket state
        # is gone — bundle the ledger/traces/stats at the moment of death
        # (per-kind debounce keeps a flapping wire at one bundle per window)
        _flightrec.record_incident(
            "disagg_peer_dead",
            f"prefill peer {self.peer} died mid-transfer: {msg}",
            extra={"peer": self.peer, "client": self.status()})
        self._fallback("peer_dead", msg)

    def _fallback(self, reason: str, msg: str) -> None:
        # both can carry peer-supplied frame bytes (the ERR "code" field
        # flows into reason); they reach the log, /health and a metric
        # label
        reason = sanitize_text(reason, limit=64)
        msg = sanitize_text(msg)
        with self._lock:
            self.counters["local_fallbacks"] += 1
            self.last_error = f"{reason}: {msg}"
        self._emit("inc", "disagg_local_fallbacks_total", reason=reason)
        logger.warning("disagg remote prefill degraded to LOCAL prefill "
                       "(%s): %s", reason, msg)
        h = self._health
        if h is not None:
            # DEGRADED-but-serving: readiness sheds new traffic while the
            # local-prefill fallback keeps answering what arrives; the
            # next successful hop restores READY below
            if h.transition(DEGRADED,
                            f"disagg: prefill peer {self.peer} "
                            f"unavailable ({reason}) — serving "
                            "local-prefill fallback"):
                with self._lock:
                    self._degraded = True

    def _recovered(self) -> None:
        h = self._health
        with self._lock:
            was = self._degraded
            self._degraded = False
        if h is not None and was:
            h.transition(READY, "disagg: prefill peer restored")
            logger.info("disagg prefill peer restored: %s", self.peer)

    def close(self) -> None:
        self._closed = True
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

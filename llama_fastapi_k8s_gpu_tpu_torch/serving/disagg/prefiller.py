"""The prefill tier's page service (``LFKT_DISAGG_ROLE=prefill``).

The port's copy of the JAX package's service
(llama_fastapi_k8s_gpu_tpu/serving/disagg/prefiller.py).  One listening
socket; per peer connection: a geometry handshake
(serving/disagg/wire.py — incompatible pools refuse with attribution,
they never exchange bytes), then a request loop.  Each REQ runs
:meth:`~...engine.engine.Engine.prefill_to_pages` on the local engine —
which consults the tier's OWN radix index first, so a system prompt hot
across many decode replicas prefills once per prefill pod, not once per
replica — and streams the resulting page stacks back as PAGE frames
through a bounded :class:`~.transport.FrameSender` (backpressure: a
slow decode replica throttles this tier's export instead of growing its
memory; the queued bytes are the memory ledger's ``disagg_txbuf``
component), finishing with a DONE frame.

Failure semantics: a per-request engine failure answers an ERR frame
and keeps the connection; a protocol violation or transport failure
drops the connection (the decode side reconnects with backoff).  The
``peer_dead`` fault-injection point fires between PAGE groups, so the
drills can kill a transfer mid-stream deterministically.
"""

from __future__ import annotations

import logging
import socket
import threading
import time

from ...obs.logctx import sanitize_text
from ...obs.memledger import register_component
from ...obs.trace import TRACER
from ...utils.faults import FAULTS, FaultError
from . import wire
from .transport import FrameConn, FrameSender

logger = logging.getLogger(__name__)

#: handshake must complete promptly; the REQ loop then waits unbounded
#: (an idle decode replica holding its connection open is normal)
_HANDSHAKE_TIMEOUT_S = 30.0


class PrefillServer:
    """Serves KV pages to decode replicas over the disagg wire."""

    # accept loop + one handler thread per peer; the sender registry and
    # counters cross threads under one mutex.  The listener/stop flag are
    # written once at construction/stop (reference stores).

    # accept loop + one handler thread per peer; the sender registry and
    # counters cross threads under one mutex.  The listener/stop flag are
    # written once at construction/stop (reference stores).
    _GUARDED_BY = {"_senders": "_lock", "counters": "_lock"}
    _THREAD_ENTRIES = ("_accept_loop", "_serve_conn")
    _SHARED_ATOMIC = ("_stop", "_sock", "port", "metrics", "_tracer")

    def __init__(self, engine, host: str = "0.0.0.0", port: int = 0,
                 queue_frames: int = 32, metrics=None, tracer=None):
        pool = getattr(engine, "_kvpool", None)
        if pool is None:
            raise ValueError(
                "LFKT_DISAGG_ROLE=prefill requires LFKT_KV_PAGED=1: "
                "finished prefills ship as KV pages, and only the paged "
                "arena produces them (docs/RUNBOOK.md 'Operating a split "
                "prefill/decode fleet')")
        self.engine = engine
        self._pool = pool
        self._geometry = wire.pool_geometry(pool)
        self._queue_frames = max(1, int(queue_frames))
        self.metrics = metrics
        # the process tracer unless a test injects a private one; the
        # REQ's ``trace`` field (wire schema 2) links this tier's span
        # fragments under the originating request's id
        self._tracer = tracer if tracer is not None else TRACER
        self._lock = threading.Lock()
        self._senders: dict[int, FrameSender] = {}
        self.counters = {"peers_total": 0, "prefills_served": 0,
                         "pages_sent": 0, "bytes_sent": 0,
                         "handshake_refusals": 0, "request_errors": 0}
        self._stop = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        # the memory ledger: the bounded send queues' buffered bytes — host RAM
        # held between export and the wire (obs/catalog.py disagg_txbuf)
        register_component("disagg_txbuf", self, PrefillServer._ledger_txbuf)
        self._thread = threading.Thread(
            target=self._accept_loop, name="lfkt-disagg-accept", daemon=True)
        self._thread.start()
        logger.info("disagg prefill service listening on %s:%d "
                    "(page_tokens=%d, page_bytes=%d)", host, self.port,
                    pool.page_tokens, pool.page_nbytes)

    # -- telemetry (never fails serving; the KVPool idiom) -----------------
    def _emit(self, kind: str, name: str, value: float = 1.0, **labels):
        m = self.metrics
        if m is None:
            return
        try:
            getattr(m, kind)(name, value, **labels)
        except Exception:  # noqa: BLE001 — telemetry must never fail serving
            pass

    def _ledger_txbuf(self) -> int:
        with self._lock:
            senders = list(self._senders.values())
        return sum(s.buffered_bytes() for s in senders)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def status(self) -> dict:
        """/health ``disagg.prefill_service`` block."""
        with self._lock:
            out = dict(self.counters)
            out["peers_connected"] = len(self._senders)
        out["port"] = self.port
        out["page_tokens"] = self._pool.page_tokens
        out["txbuf_bytes"] = self._ledger_txbuf()
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
                             name="lfkt-disagg-peer", daemon=True).start()

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
                self._emit("inc", "disagg_handshake_refusals_total")
                logger.error("disagg handshake refused for %s: %s",
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
            logger.info("disagg peer connected: %s", peer)
            while not self._stop:
                ftype, hdr, _ = conn.recv_frame()
                if ftype != wire.FRAME_REQ:
                    raise wire.WireError(
                        f"expected REQ, got "
                        f"{wire.FRAME_NAMES.get(ftype, ftype)}")
                self._serve_request(sender, hdr)
        except ConnectionError:
            logger.info("disagg peer left: %s", peer)
        except (wire.WireError, OSError, FaultError) as e:
            # includes the peer_dead drill (FaultError raised through
            # _serve_request's page loop): hard-close mid-stream — the
            # decode side must degrade to local prefill, never hang
            logger.warning("disagg peer %s dropped: %s", peer, e)
        except Exception:  # noqa: BLE001 — one peer must not kill the service
            logger.exception("disagg peer handler failed for %s", peer)
        finally:
            if sender is not None:
                with self._lock:
                    self._senders.pop(id(sender), None)
                sender.close(join_timeout=0.5)
            conn.close()

    def _serve_request(self, sender: FrameSender, hdr: dict) -> None:
        # server-side fragment of the originating request's trace: the
        # REQ's ``trace`` field (wire schema 2) carries the decode side's
        # span context.  start_linked returns None unless this process
        # samples AND the field parsed — the untraced hot path pays two
        # cheap guards, no lock, no allocation (zero-cost contract).
        trace = self._tracer.start_linked("disagg.prefill",
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
            # backpressure bound: a send queue still full past the
            # request's own deadline means the wire cannot carry this
            # transfer in time — tear it down rather than stall the tier
            if deadline is not None:
                return max(0.1, float(deadline) - time.time())
            return 30.0

        if deadline is not None and time.time() > float(deadline):
            # deadline propagation spans the hop: an expired request
            # must not occupy the prefill engine — the decode side has
            # already abandoned it and freed its pages
            if trace is not None:
                trace.root.set(error="deadline expired")
            sender.put(wire.FRAME_ERR, {
                "rid": rid, "code": "deadline",
                "error": "deadline expired before remote prefill"})
            return
        sp = trace.span("engine.prefill") if trace is not None else None
        try:
            got = self.engine.prefill_to_pages(ids, namespace=ns,
                                               deadline=deadline)
        except Exception as e:  # noqa: BLE001 — per-request isolation: the
            # decode side degrades to local prefill with this attribution
            self._count("request_errors")
            logger.warning("disagg prefill request failed: %s", e)
            if sp is not None:
                sp.set(error=sanitize_text(
                    f"{type(e).__name__}: {e}", limit=256)).end()
            sender.put(wire.FRAME_ERR, {
                "rid": rid, "code": "prefill",
                "error": f"{type(e).__name__}: {e}"})
            return
        if sp is not None:
            sp.end()
        if got is None:
            sender.put(wire.FRAME_DONE, {"rid": rid, "tokens": 0,
                                         "n_pages": 0, "first_token": None})
            return
        leaves, tokens, first_token = got
        n_pages = tokens // self._pool.page_tokens
        # one span per wire transfer, one kv_pages event per PAGE group —
        # the waterfall's ▓ bar covers exactly the bytes-on-the-wire time
        sp_send = trace.span("wire.send") if trace is not None else None
        sent_bytes = 0
        off = seq = 0
        while off < n_pages:
            # drill point: a prefill peer dying MID-STREAM (FaultError
            # propagates to _serve_conn, which hard-closes the socket
            # between page groups — the decode side sees a torn transfer)
            FAULTS.fire("peer_dead")
            g = min(wire.PAGE_GROUP, n_pages - off)
            payload = wire.encode_pages(
                [leaf[off:off + g] for leaf in leaves])
            sender.put(wire.FRAME_PAGE,
                       {"rid": rid, "seq": seq, "n_pages": g},
                       payload, timeout=put_timeout())
            self._count("pages_sent", g)
            self._count("bytes_sent", len(payload))
            self._emit("inc", "disagg_pages_sent_total", g)
            self._emit("inc", "disagg_bytes_sent_total", len(payload))
            if sp_send is not None:
                sent_bytes += len(payload)
                sp_send.event("kv_pages", seq=seq, pages=g,
                              bytes=len(payload))
            off += g
            seq += 1
        sender.put(wire.FRAME_DONE,
                   {"rid": rid, "tokens": tokens, "n_pages": n_pages,
                    "first_token": first_token}, timeout=put_timeout())
        if sp_send is not None:
            sp_send.set(pages=n_pages, bytes=sent_bytes).end()
        self._count("prefills_served")
        self._emit("inc", "disagg_prefills_served_total")

    def stop_accepting(self) -> None:
        """Close the listener only: no NEW page-wire peers, in-flight
        transfers keep streaming — the drain semantics (server/httpd.py
        calls this when SIGTERM flips the pod to DRAINING, so a decode
        replica re-resolving the Service lands on a live prefill pod).  The
        shutdown wakes the accept loop's blocked ``accept`` (closing the
        socket alone does not), so its thread ends."""
        for release in (lambda: self._sock.shutdown(socket.SHUT_RDWR), self._sock.close):
            try:
                release()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop = True
        self.stop_accepting()
        self._thread.join(timeout=2.0)
        with self._lock:
            senders = list(self._senders.values())
            self._senders.clear()
        for s in senders:
            s.close(join_timeout=0.5)

"""The fleet router: a thin prefix-affinity HTTP proxy over the replicas.

The port's copy of the JAX package's router
(llama_fastapi_k8s_gpu_tpu/serving/fleet/router.py).  ``LFKT_FLEET_ROLE=
router`` runs this instead of a serving app — no model, no torch, one
asyncio loop.  Every request is keyed by :func:`.affinity.affinity_key`
and proxied to the replica that rendezvous hashing says owns the key, so a
conversation's turns keep landing on the replica whose radix tree already
holds their KV pages.  ``policy="roundrobin"`` is the A/B control arm
(``LFKT_FLEET_POLICY``).

Proxying is RAW: the backend's status line, headers (minus hop-by-hop
connection signaling) and body bytes are relayed verbatim as they arrive,
so SSE passes through chunk by chunk and a greedy completion through the
router is byte-identical to direct-to-replica.  One request per client
connection (``connection: close``): the router's job is placement.

Failure contract — never a hang, never a 502 for one dead pod:

- connect/head failure BEFORE any response byte reached the client: eject
  the peer with attribution (peers.py) and retry on the rendezvous-NEXT
  healthy peer (``fleet_spills_total{reason}``); only when every replica
  refused does the client see a 503;
- failure MID-RESPONSE: the peer is ejected and the client connection
  closes (a partly delivered generation cannot be replayed); the client's
  retry spills to the survivor;
- every backend read rides a deadline: connect and the request write on
  ``LFKT_FLEET_PROXY_TIMEOUT_SECONDS``, the response head and the body on
  the stream wall budget (``LFKT_STREAM_DEADLINE_SECONDS``).

The router answers ``/health`` (role, policy, per-peer state with
attributed ejection reasons), ``/health/ready`` (200 iff >= 1 healthy
replica), ``/health/live`` and ``/metrics`` (the ``fleet_*`` families)
itself, and the fleet-scope routes below; everything else is proxied.

Fleet observability (obs/fleettrace.py):

- the router mints or ingests a W3C ``traceparent`` and opens spans per
  proxy attempt (peer pick, spill, response-head wait, stream relay),
  stamping each outbound hop with the ATTEMPT span as parent, so the
  replica's trace fragment grafts under the attempt that carried it.
  Sampled out or tracer-less, the relay path builds no span at all and
  the inbound ``traceparent`` passes through verbatim;
- ``GET /debug/fleet/traces/{id}`` pulls that id's fragments from every
  healthy peer and returns ONE stitched multi-process tree;
- ``GET /metrics/fleet`` federates peer scrapes and evaluates the SLO
  catalog over the merged distributions; ``GET /debug/slo`` returns the
  fleet verdict document;
- every proxy attempt writes one JSON access record (request id, peer,
  spill count) via obs/logctx.py;
- a peer ejection triggers a correlated incident pull
  (``fleet_peer_ejected`` flight-recorder bundle).
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import signal
import time
import uuid

from .affinity import (AFFINITY_KEY_HEADER, PRIOR_OWNER_HEADER,
                       affinity_key, rendezvous_rank)
from ...obs import fleettrace
from ...obs.logctx import access_logger, bind_request_id, sanitize_text
from ...obs.trace import parse_traceparent, span_traceparent

logger = logging.getLogger(__name__)

#: /debug/fleet/traces/{id}: ids are 32-hex by construction (obs/trace);
#: anything else is refused before it can ride an outbound peer URL
_TRACE_ID_RE = re.compile(r"[0-9a-f]{32}")

#: response head elements the proxy rewrites rather than relays:
#: connection signaling is hop-by-hop (RFC 9110 §7.6.1)
_HOP_HEADERS = (b"connection", b"keep-alive", b"proxy-connection")

_READ_CHUNK = 65536


class _BackendError(Exception):
    """One proxy attempt failed against one peer (reason attributed)."""

    def __init__(self, reason: str, mid_stream: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.mid_stream = mid_stream


class FleetRouter:
    """See module docstring.  ``peers`` is a started
    :class:`..fleet.peers.PeerTable`; ``metrics`` a
    :class:`...utils.metrics.Metrics` registry (the catalog enforces the
    ``fleet_*`` families)."""

    def __init__(self, peers, policy: str = "affinity", metrics=None,
                 proxy_timeout: float = 5.0,
                 stream_timeout: float = 300.0,
                 max_spills: int = 3,
                 fresh_seconds: float = 600.0,
                 tracer=None):
        if policy not in ("affinity", "roundrobin"):
            raise ValueError(
                f"LFKT_FLEET_POLICY must be affinity|roundrobin, "
                f"got {policy!r}")
        self.peers = peers
        self.policy = policy
        self.metrics = metrics
        #: obs.trace.Tracer (None = no router-side tracing at all; the
        #: inbound traceparent still relays verbatim)
        self.tracer = tracer
        self.proxy_timeout = proxy_timeout
        self.stream_timeout = stream_timeout
        self.max_spills = max(0, int(max_spills))
        self.fresh_seconds = float(fresh_seconds)
        self._rr = 0
        self.started = int(time.time())
        #: monotonic counters for /health (the /metrics twins are inc'd
        #: at event time); plain ints mutated on the one event loop
        self.counters = {
            "proxied": 0, "spills": 0, "mid_stream_aborts": 0,
            "no_replica_503s": 0, "budget_503s": 0,
        }
        #: federated SLO state (GET /metrics/fleet, GET /debug/slo):
        #: the UNMODIFIED engine evaluates the catalog over the latest
        #: bucket-wise merge of peer scrapes (obs/fleettrace.py)
        from ...obs.slo import SLOEngine

        self._fleet_view = fleettrace.FleetMetricsView()
        self._fleet_slo = SLOEngine(self._fleet_view, scope="fleet")
        # correlated incident capture on ejections (prober-side ones
        # included); no-op while the local flight recorder is disarmed
        if hasattr(peers, "on_eject"):
            peers.on_eject = self._on_peer_eject

    def _on_peer_eject(self, addr: str, reason: str) -> None:
        fleettrace.incident_pull_async(addr, self.peers.healthy(), reason)

    # -- telemetry ---------------------------------------------------------
    def _emit(self, kind: str, name: str, value: float = 1.0, **labels):
        m = self.metrics
        if m is None:
            return
        try:
            getattr(m, kind)(name, value, **labels)
        except Exception:  # noqa: BLE001 — telemetry must never fail routing
            pass

    # -- routing -----------------------------------------------------------
    def rank(self, key: str) -> list[str]:
        """Full preference order for ``key`` over ALL known replicas
        (healthy or not — the caller skips unhealthy ones and counts the
        skip as a spill, so ownership is stable across flaps)."""
        addrs = self.peers.addrs()
        if self.policy == "roundrobin":
            if not addrs:
                return []
            self._rr = (self._rr + 1) % len(addrs)
            return addrs[self._rr:] + addrs[:self._rr]
        return rendezvous_rank(key, addrs)

    # -- local endpoints ---------------------------------------------------
    def _health_doc(self) -> dict:
        return {
            "role": "router",
            "policy": self.policy,
            "started": self.started,
            "counters": dict(self.counters),
            **self.peers.snapshot(),
        }

    def _local_response(self, path: str):
        """(status, content_type, body) for router-owned routes, or None
        to proxy."""
        if path == "/health":
            return 200, "application/json", json.dumps(self._health_doc())
        if path == "/health/ready":
            n = len(self.peers.healthy())
            return (200 if n else 503), "application/json", json.dumps(
                {"ready": bool(n), "role": "router", "healthy_replicas": n})
        if path == "/health/live":
            return 200, "application/json", json.dumps(
                {"alive": True, "role": "router"})
        if path == "/metrics" and self.metrics is not None:
            self._emit("set_gauge", "fleet_peers_healthy",
                       len(self.peers.healthy()))
            return 200, "text/plain; version=0.0.4", self.metrics.render()
        return None

    # -- fleet observability endpoints (blocking peer fetches ride a
    # worker thread; the loop keeps relaying) -------------------------------
    async def _local_async(self, path: str):
        """(status, content_type, body) for the fleet-scope routes that
        must fan out HTTP to peers, or None to proxy."""
        if path == "/metrics/fleet":
            return await asyncio.to_thread(self._fleet_metrics_response)
        if path == "/debug/slo":
            return await asyncio.to_thread(self._fleet_slo_response)
        if path.startswith("/debug/fleet/traces/"):
            trace_id = path.rpartition("/")[2]
            if not _TRACE_ID_RE.fullmatch(trace_id):
                return 404, "application/json", json.dumps(
                    {"detail": "malformed trace id"})
            return await asyncio.to_thread(self._fleet_trace_response,
                                           trace_id)
        return None

    def _scrape_peers(self) -> dict[str, str]:
        texts: dict[str, str] = {}
        for addr in self.peers.healthy():
            text = fleettrace.fetch_text(addr, "/metrics",
                                         timeout=self.proxy_timeout)
            if text:
                texts[addr] = text
        return texts

    def _federate(self) -> dict:
        fed = fleettrace.federate(self._scrape_peers())
        self._fleet_view.update(fed["snapshot"])
        return fed

    def _fleet_metrics_response(self):
        fed = self._federate()
        self._fleet_slo.export()
        body = fed["exposition"] + self._fleet_view.render_gauges()
        return 200, "text/plain; version=0.0.4", body

    def _fleet_slo_response(self):
        fed = self._federate()
        doc = self._fleet_slo.evaluate()
        doc["scope"] = "fleet"
        doc["peers"] = fed["peers"]
        return 200, "application/json", json.dumps(doc)

    def _fleet_trace_response(self, trace_id: str):
        local_doc = None
        if self.tracer is not None:
            tr = self.tracer.get(trace_id)
            if tr is not None:
                local_doc = tr.to_dict()
        frags = fleettrace.collect_fragments(
            trace_id, self.peers.healthy(), timeout=self.proxy_timeout,
            local=local_doc)
        doc = fleettrace.stitch(frags)
        if doc is None:
            return 404, "application/json", json.dumps(
                {"detail": "trace not found on the router or any "
                           "healthy peer"})
        return 200, "application/json", json.dumps(doc)

    # -- one proxy attempt -------------------------------------------------
    async def _proxy_attempt(self, addr: str, head: bytes, body: bytes,
                             writer: asyncio.StreamWriter,
                             sent: list, span=None) -> int:
        """Forward one request to ``addr``, relaying the response to
        ``writer`` as it arrives.  ``sent`` flips truthy once the first
        response byte reaches the client (the no-retry point).  Returns
        the backend status; raises :class:`_BackendError` otherwise.
        ``span`` (the attempt span, None when sampled out) gets
        ``response.head`` / ``stream.relay`` children — the relay span
        ends at the LAST body byte.  Error paths leave them open on
        purpose: the tracer's finish sweep closes them ``auto_closed``
        at the abort instant."""
        host, _, port = addr.rpartition(":")
        try:
            r2, w2 = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)),
                self.proxy_timeout)
        except (OSError, asyncio.TimeoutError) as e:
            raise _BackendError(f"connect: {type(e).__name__}: {e}")
        try:
            sp_head = span.child("response.head") if span is not None \
                else None
            w2.write(head + body)
            try:
                await asyncio.wait_for(w2.drain(), self.proxy_timeout)
                # the status line waits on the STREAM budget, not the
                # connect timeout: a buffered non-streaming /response
                # sends its head only after the full generation, and a
                # 5s head deadline would eject a healthy replica for
                # serving a slow prompt (then replay the generation
                # fleet-wide).  Dead-socket detection stays fast via the
                # prober; a connected-but-silent backend is bounded here.
                status_line = await asyncio.wait_for(
                    r2.readline(), self.stream_timeout)
                resp_head = [status_line]
                while True:
                    line = await asyncio.wait_for(r2.readline(),
                                                  self.proxy_timeout)
                    resp_head.append(line)
                    if line in (b"\r\n", b"\n", b""):
                        break
            except (OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError) as e:
                raise _BackendError(f"head: {type(e).__name__}: {e}")
            try:
                status = int(status_line.split()[1])
            except (IndexError, ValueError):
                raise _BackendError(
                    f"head: malformed status line {status_line!r}")
            content_length = None
            chunked = False
            out = [status_line]
            for line in resp_head[1:-1]:
                name, _, value = line.partition(b":")
                lname = name.strip().lower()
                if lname in _HOP_HEADERS:
                    continue
                if lname == b"content-length":
                    try:
                        content_length = int(value.strip())
                    except ValueError:
                        pass
                elif lname == b"transfer-encoding" \
                        and b"chunked" in value.lower():
                    chunked = True
                out.append(line)
            out.append(b"connection: close\r\n\r\n")
            writer.write(b"".join(out))
            sent.append(True)
            sp_relay = None
            relayed = 0
            if sp_head is not None:
                sp_head.set(status=status)
                sp_head.end()
                sp_relay = span.child("stream.relay")
            # relay the body VERBATIM (byte-identity is the contract),
            # tracking the backend's own framing to know where the
            # response ends — EOF alone is not a terminator for
            # keep-alive backends
            deadline = time.time() + self.stream_timeout

            async def _read(coro):
                gap = deadline - time.time()
                if gap <= 0:
                    raise _BackendError("body: stream wall budget "
                                        "exhausted", mid_stream=True)
                try:
                    return await asyncio.wait_for(coro, gap)
                except (OSError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError) as e:
                    raise _BackendError(
                        f"body: {type(e).__name__}: {e}", mid_stream=True)

            if chunked:
                # incremental chunked walk: every byte (size lines, data,
                # the terminal 0-chunk) is relayed untouched; parsing is
                # only for finding the end, so SSE streams flush to the
                # client chunk by chunk as they arrive
                while True:
                    size_line = await _read(r2.readline())
                    if not size_line:
                        raise _BackendError("body: EOF inside chunked "
                                            "stream", mid_stream=True)
                    writer.write(size_line)
                    try:
                        size = int(size_line.strip().split(b";")[0], 16)
                    except ValueError:
                        raise _BackendError(
                            f"body: bad chunk size {size_line!r}",
                            mid_stream=True)
                    data = await _read(r2.readexactly(size + 2))
                    writer.write(data)
                    await writer.drain()
                    if sp_relay is not None:
                        relayed += len(size_line) + len(data)
                    if size == 0:
                        break
            elif content_length is not None:
                remaining = content_length
                while remaining > 0:
                    chunk = await _read(
                        r2.read(min(_READ_CHUNK, remaining)))
                    if not chunk:
                        raise _BackendError("body: EOF mid-response",
                                            mid_stream=True)
                    remaining -= len(chunk)
                    writer.write(chunk)
                    await writer.drain()
                    if sp_relay is not None:
                        relayed += len(chunk)
            else:
                # no framing: the response ends when the backend closes
                while True:
                    chunk = await _read(r2.read(_READ_CHUNK))
                    if not chunk:
                        break
                    writer.write(chunk)
                    await writer.drain()
                    if sp_relay is not None:
                        relayed += len(chunk)
            if sp_relay is not None:
                # ends AT the last relayed byte — the waterfall's relay
                # bar is the stream's true client-visible extent
                sp_relay.set(bytes=relayed)
                sp_relay.end()
            return status
        finally:
            try:
                w2.close()
            except Exception:  # noqa: BLE001
                pass

    # -- one client request ------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            await self._handle_inner(reader, writer)
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        except Exception as e:  # noqa: BLE001 — one bad request must not
            # take the router down; the client sees the closed socket
            logger.error("router request failed: %s", e)
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    async def _read_request(reader):
        """(method, target, headers dict, raw header lines, body) or None
        on a malformed/empty request."""
        request_line = await reader.readline()
        if not request_line:
            return None
        try:
            method, target, _version = request_line.decode().split()
        except ValueError:
            return None
        raw_headers = []
        headers: dict[str, str] = {}
        content_length = 0
        chunked = False
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            raw_headers.append(line)
            name, _, value = line.decode("latin-1").partition(":")
            name = name.strip().lower()
            value = value.strip()
            headers[name] = value
            if name == "content-length":
                try:
                    content_length = max(0, int(value))
                except ValueError:
                    return None
            elif name == "transfer-encoding":
                chunked = True
        if chunked:
            # chunked REQUEST bodies are not relayed (the backend httpd
            # refuses them too); forwarding the header with a rewritten
            # content-length would send conflicting framing and silently
            # drop the body — refuse honestly instead
            return "chunked"
        body = (await reader.readexactly(content_length)
                if content_length else b"")
        return method, target, headers, raw_headers, body

    def _write_simple(self, writer, status: int, ctype: str, body,
                      extra_headers: dict | None = None) -> None:
        if isinstance(body, str):
            body = body.encode()
        reason = {200: "OK", 503: "Service Unavailable",
                  408: "Request Timeout", 404: "Not Found",
                  501: "Not Implemented"}.get(status, "")
        extra = "".join(f"{k}: {sanitize_text(v, limit=256)}\r\n"
                        for k, v in (extra_headers or {}).items())
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"  # lfkt: sanitizes[http-request,wire-frame] -- the only request-derived value here is extra (x-request-id and friends), and every extra_headers value passes sanitize_text in the join above; status/reason/ctype/len are internal
            f"content-type: {ctype}\r\n"
            f"content-length: {len(body)}\r\n"
            f"{extra}"
            "connection: close\r\n\r\n".encode() + body)

    async def _handle_inner(self, reader, writer) -> None:
        try:
            got = await asyncio.wait_for(self._read_request(reader),
                                         self.proxy_timeout)
        except asyncio.TimeoutError:
            self._write_simple(writer, 408, "application/json",
                               json.dumps({"detail": "request read "
                                                     "timeout"}))
            return
        if got is None:
            return
        if got == "chunked":
            self._write_simple(
                writer, 501, "application/json",
                json.dumps({"detail": "chunked transfer-coding not "
                                      "supported"}))
            await writer.drain()
            return
        method, target, headers, raw_headers, body = got
        path = target.partition("?")[0]
        local = self._local_response(path)
        if local is None:
            local = await self._local_async(path)
        if local is not None:
            self._write_simple(writer, *local)
            await writer.drain()
            return

        # trace identity: ingest the inbound traceparent (re-validated —
        # only a well-formed one survives as hex, so it can ride logs and
        # outbound headers without a declassifier) or mint a fresh one
        trace = None
        if self.tracer is not None:
            trace = self.tracer.start("fleet.route",
                                      traceparent=headers.get("traceparent"))
        inbound = parse_traceparent(headers.get("traceparent"))
        rid = trace.trace_id if trace is not None else (
            inbound[0] if inbound else uuid.uuid4().hex)
        inbound_tp = f"00-{inbound[0]}-{inbound[1]}-01" if inbound else None
        with bind_request_id(rid):
            try:
                await self._route(method, target, path, headers,
                                  raw_headers, body, writer, trace,
                                  inbound_tp, rid)
            finally:
                if self.tracer is not None:
                    self.tracer.finish(trace)

    async def _route(self, method, target, path, headers, raw_headers,
                     body, writer, trace, inbound_tp, rid) -> None:
        key, source = affinity_key(path, headers, body)
        order = self.rank(key)
        owner = order[0] if order else None
        # forward the request with hop-by-hop headers rewritten: the
        # backend sees connection: close (EOF = end of response) and an
        # exact content-length; everything else (affinity header,
        # content-type) passes through.  traceparent is lifted out and
        # re-appended per ATTEMPT: when traced it names the attempt span
        # (the hop stamp fragments graft under), when sampled out the
        # validated inbound value relays unchanged.  The head is rebuilt
        # per ATTEMPT: the migration stamps below name the peer tried
        base = []
        for line in raw_headers:
            lname = line.split(b":", 1)[0].strip().lower()
            if lname in _HOP_HEADERS + (b"content-length", b"host",
                                        b"traceparent",
                                        AFFINITY_KEY_HEADER.encode(),
                                        PRIOR_OWNER_HEADER.encode()):
                continue
            base.append(line)

        def build_head(addr: str, span=None) -> bytes:
            # method/target are readline-framed: no LF survives the
            # request-line parse, so neither can splice a header
            fwd = [f"{method} {target} HTTP/1.1\r\n".encode()]  # lfkt: sanitizes[http-request] -- method/target are readline-framed: no LF can survive request-line parsing, so they cannot splice a header
            fwd.extend(base)
            fwd.append(f"host: {addr}\r\n".encode())
            if body or method in ("POST", "PUT", "PATCH"):
                fwd.append(f"content-length: {len(body)}\r\n".encode())
            if self.policy == "affinity" and source != "opaque":
                # migration stamps (serving/fleet/migrate.py): the key
                # lets the replica record this conversation for graceful
                # drain; prior-owner names the peer whose radix tree
                # still holds its pages — set when this attempt is OFF
                # the rendezvous owner (spill, ejection), or when the
                # owner itself was (re)admitted recently enough that a
                # restart/scale-out likely left it cold (pull-on-remap)
                fwd.append(f"{AFFINITY_KEY_HEADER}: {key}\r\n".encode())
                prior = None
                if owner is not None and addr != owner:
                    prior = owner
                elif addr == owner and len(order) > 1 \
                        and self.peers.is_fresh(addr, self.fresh_seconds):
                    prior = order[1]
                if prior is not None:
                    fwd.append(
                        f"{PRIOR_OWNER_HEADER}: {prior}\r\n".encode())
            hop_tp = span_traceparent(span) or inbound_tp
            if hop_tp:
                fwd.append(f"traceparent: "
                           f"{sanitize_text(hop_tp, limit=64)}\r\n".encode())
            fwd.append(b"connection: close\r\n\r\n")
            return b"".join(fwd)

        spath = sanitize_text(path, limit=256)
        if trace is not None:
            trace.root.set(method=sanitize_text(method, limit=16),
                           path=spath, policy=self.policy, source=source)
            trace.event("peer_pick", owner=owner,
                        ranked=len(order),
                        healthy=len(self.peers.healthy()))
        sent: list = []
        t0 = time.time()
        spills = 0
        attempt_n = 0
        for addr in order:
            if not self.peers.is_healthy(addr):
                if trace is not None:
                    trace.event("peer_skipped", peer=addr)
                continue
            if spills > self.max_spills:
                # retry budget (LFKT_FLEET_MAX_SPILLS): a request that
                # keeps killing its peer is more likely poison than
                # victim — stop walking the rendezvous order before it
                # fells the whole fleet; the client backs off instead
                self.counters["budget_503s"] += 1
                self._emit("inc", "fleet_spills_total", reason="budget")
                self._write_simple(
                    writer, 503, "application/json",
                    json.dumps({"detail": f"spill budget exhausted after "
                                          f"{spills} failed replays "
                                          "(LFKT_FLEET_MAX_SPILLS)"}),
                    {"retry-after": max(
                        1, int(self.peers.backoff_seconds)),
                     "x-request-id": rid})
                await writer.drain()
                return
            attempt_n += 1
            attempt = None
            if trace is not None:
                attempt = trace.span("proxy.attempt")
                attempt.set(peer=addr, n=attempt_n,
                            owner=(addr == owner))
            try:
                status = await self._proxy_attempt(
                    addr, build_head(addr, attempt), body, writer, sent,
                    span=attempt)
            except _BackendError as e:
                reason = sanitize_text(e.reason, limit=256)
                if attempt is not None:
                    attempt.set(error=reason, mid_stream=e.mid_stream)
                    attempt.end()
                self.peers.eject(addr, f"proxy {e.reason}")
                self._emit("set_gauge", "fleet_peers_healthy",
                           len(self.peers.healthy()))
                access_logger.info(
                    "fleet attempt failed: %s", reason,
                    extra={"route": spath,
                           "method": sanitize_text(method, limit=16),
                           "duration_s": round(time.time() - t0, 6),
                           "peer": addr, "spills": spills,
                           "attempt": attempt_n})
                if sent:
                    # bytes already reached the client: the router cannot
                    # replay a partially delivered response — close, and
                    # let the client's retry spill to a survivor
                    self.counters["mid_stream_aborts"] += 1
                    self._emit("inc", "fleet_spills_total",
                               reason="mid_stream_abort")
                    if trace is not None:
                        trace.event("mid_stream_abort", peer=addr)
                    logger.warning("fleet: %s died mid-response for key "
                                   "%s; client connection closed", addr,
                                   key[:16])
                    return
                self.counters["spills"] += 1
                self._emit("inc", "fleet_spills_total", reason="ejected")
                spills += 1
                if trace is not None:
                    trace.event("spill", peer=addr, reason=reason)
                continue
            # success
            if attempt is not None:
                attempt.set(status=status)
                attempt.end()
            self.counters["proxied"] += 1
            self._emit("inc", "fleet_requests_total", peer=addr,
                       source=source)
            self._emit("observe", "fleet_proxy_seconds", time.time() - t0)
            access_logger.info(
                "fleet proxied", extra={
                    "route": spath,
                    "method": sanitize_text(method, limit=16),
                    "status": status,
                    "duration_s": round(time.time() - t0, 6),
                    "peer": addr, "spills": spills,
                    "attempt": attempt_n})
            if self.policy == "affinity" and addr != owner:
                # served, but off the rendezvous owner: the owner is
                # ejected and this request warmed its spill target
                self.counters["spills"] += 1
                self._emit("inc", "fleet_spills_total", reason="spilled")
            await writer.drain()
            return
        # every replica unhealthy or refused pre-send
        self.counters["no_replica_503s"] += 1
        self._emit("inc", "fleet_spills_total", reason="no_replica")
        self._write_simple(
            writer, 503, "application/json",
            json.dumps({"detail": "no healthy replica (fleet router); "
                                  "see the router's /health for per-peer "
                                  "attribution"}),
            {"x-request-id": rid})
        await writer.drain()

    # -- serving -----------------------------------------------------------
    async def serve(self, host: str = "0.0.0.0", port: int = 8000,
                    ready_event: asyncio.Event | None = None,
                    stop_event: asyncio.Event | None = None) -> None:
        server = await asyncio.start_server(self._handle, host, port)
        logger.info("fleet router listening on %s:%d (%d replicas, "
                    "policy=%s)", host, port, len(self.peers.addrs()),
                    self.policy)
        if ready_event is not None:
            ready_event.set()
        stop = stop_event if stop_event is not None else asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError, ValueError):
                # non-main thread (tests/bench) or unsupported platform
                pass
        async with server:
            await stop.wait()
        # PeerTable.stop() joins the prober thread, which may be inside
        # a probe_timeout-long socket wait — joining ON the loop would
        # freeze every in-flight proxied stream at shutdown: the join
        # rides a worker thread, the loop keeps relaying
        await asyncio.to_thread(self.peers.stop)

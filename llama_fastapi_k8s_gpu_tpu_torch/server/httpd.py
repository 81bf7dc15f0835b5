"""Dependency-free asyncio HTTP/1.1 server for ASGI apps.

Stands in for uvicorn (reference docker/Dockerfile.app:12) when serving the
in-tree ASGI app without external packages: persistent connections,
Content-Length framing, graceful shutdown via the ASGI lifespan protocol.
One process, one event loop — the reference's single-worker model
(``gunicorn -w 1``) is preserved by construction.

Shutdown mirrors gunicorn's graceful stop: on SIGTERM/SIGINT the listener
closes, idle keep-alive connections are closed immediately, in-flight
requests (counted from their first COMPLETE request line, so a mid-upload
header/body is covered; a partial request line at stop is treated as idle)
get up to ``LFKT_DRAIN_SECONDS`` to complete with a ``connection: close``
response, and only then does the ASGI shutdown hook run.  Surviving
connections are force-closed AND their handler tasks cancelled after the
drain budget, so ``Server.wait_closed`` (which on Python ≥3.12.1 waits for
ALL connection handlers — including ones blocked inside the app, not on
socket I/O) cannot hang the process past its pod termination grace period.

Streaming responses go out with chunked transfer-encoding.  Once a
request's body is delivered, ``receive()`` waits for the client to go away
(EOF, a reset, or a closed transport) and then answers
``http.disconnect``, so an app streaming to a dropped socket learns of it
without having to write first.  The request's read window rides the scope
as ``lfkt.httpd_read`` (the tracer's ``httpd.read`` span).
"""

from __future__ import annotations

import asyncio
import logging
import signal
import time

logger = logging.getLogger(__name__)

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    408: "Request Timeout", 409: "Conflict", 422: "Unprocessable Entity",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable",
}


async def _reject(writer, status: int, detail: str) -> bool:
    """Minimal error response for requests the server won't parse further
    (malformed/conflicting Content-Length → 400, chunked transfer-coding →
    501).  ``Connection: close`` is honest: the remaining request bytes are
    unread, so the connection cannot be reused — but unlike the former
    silent close the client gets told WHY (RFC 9112 §6.1/§6.3).  Returns
    False so the caller drops the connection."""
    body = (detail + "\n").encode()
    writer.write(
        f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
        f"content-length: {len(body)}\r\n"
        "connection: close\r\n\r\n".encode() + body)
    try:
        await writer.drain()
    except (ConnectionResetError, BrokenPipeError):
        pass
    return False


#: how often a waiting ``receive()`` looks at the socket
_DISCONNECT_POLL = 0.02


async def _handle_request(app, reader, writer, peer, request_line,
                          state, t_read0=None) -> bool:
    """Serve one request on an open connection.  Returns False when the
    connection must close (malformed request, read deadline, or draining).
    ``t_read0`` is when this request's bytes started arriving."""
    try:
        method, target, _version = request_line.decode().split()
    except ValueError:
        return False

    async def _read_head_and_body():
        headers = []
        content_length = None
        chunked = False
        close_requested = False
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode().partition(":")
            name = name.strip().lower()
            value = value.strip()
            headers.append((name.encode(), value.encode()))
            if name == "connection" and "close" in value.lower():
                # honor the client's one-request intent (RFC 9112 §9.6):
                # proxies and strict HTTP/1.1 clients frame "response
                # ends" as "connection closes"
                close_requested = True
            if name == "content-length":
                try:
                    cl = int(value)
                except ValueError:  # malformed framing: say so, then close
                    return await _reject(writer, 400,
                                         "invalid Content-Length")
                if cl < 0:
                    return await _reject(writer, 400,
                                         "invalid Content-Length")
                if content_length is not None and cl != content_length:
                    # conflicting lengths (RFC 9112 §6.3: unrecoverable —
                    # never last-one-wins)
                    return await _reject(writer, 400,
                                         "conflicting Content-Length")
                content_length = cl
            elif name == "transfer-encoding":
                chunked = True
        if chunked:
            # chunked request bodies are not implemented; serving the
            # request with an empty body would leave the chunk stream in
            # the buffer to be misparsed as the next request line — close
            # (with attribution) instead
            return await _reject(writer, 501,
                                 "chunked transfer-coding not supported")
        content_length = content_length or 0
        body = (await reader.readexactly(content_length)
                if content_length else b"")
        return headers, body, close_requested

    # slowloris guard: once the request line has arrived, the rest of the
    # head + body must finish arriving within the read deadline — a client
    # dribbling one header byte per minute gets an honest 408 and a closed
    # socket instead of holding a connection (and, during drain, a slot in
    # the shutdown accounting) forever
    try:
        got = await asyncio.wait_for(_read_head_and_body(),
                                     state["read_timeout"])
    except asyncio.TimeoutError:
        return await _reject(writer, 408, "request read timeout")
    if got is False:
        return False                     # _reject already answered
    headers, body, close_requested = got

    path, _, query = target.partition("?")
    scope = {
        "type": "http",
        "asgi": {"version": "3.0"},
        "http_version": "1.1",
        "method": method.upper(),
        "path": path,
        "query_string": query.encode(),
        "headers": headers,
        "client": peer,
        "scheme": "http",
    }
    if t_read0 is not None:
        scope["lfkt.httpd_read"] = (t_read0, time.time())

    messages = [{"type": "http.request", "body": body, "more_body": False}]

    async def receive():
        if messages:
            return messages.pop(0)
        # the body is delivered: answer once the client has gone away
        while not (reader.at_eof() or reader.exception() is not None
                   or writer.is_closing()):
            await asyncio.sleep(_DISCONNECT_POLL)
        return {"type": "http.disconnect"}

    # Buffered by default; switches to chunked transfer-encoding the
    # moment the app sends a body part with more_body=True.
    response = {"status": 500, "headers": [], "body": b"",
                "streaming": False}

    def _write_head(chunked: bool):
        status = response["status"]
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, '')}".encode()]
        has_length = False
        for k, v in response["headers"]:
            if k.lower() == b"content-length":
                has_length = True
            head.append(k + b": " + v)
        if chunked:
            head.append(b"transfer-encoding: chunked")
        elif not has_length:
            head.append(
                b"content-length: " + str(len(response["body"])).encode())
        # honest connection signaling: during drain — or when the client
        # itself sent "connection: close" — the handler closes the socket
        # after this response, so clients must not reuse it
        head.append(b"connection: close"
                    if state["draining"] or close_requested
                    else b"connection: keep-alive")
        writer.write(b"\r\n".join(head) + b"\r\n\r\n")

    async def send(message):
        if message["type"] == "http.response.start":
            response["status"] = message["status"]
            response["headers"] = message.get("headers", [])
        elif message["type"] == "http.response.body":
            body = message.get("body", b"")
            if message.get("more_body"):
                if not response["streaming"]:
                    response["streaming"] = True
                    _write_head(chunked=True)
                if body:
                    writer.write(
                        f"{len(body):x}\r\n".encode() + body + b"\r\n")
                    await writer.drain()
            elif response["streaming"]:
                if body:
                    writer.write(
                        f"{len(body):x}\r\n".encode() + body + b"\r\n")
                writer.write(b"0\r\n\r\n")
                await writer.drain()
            else:
                response["body"] += body

    await app(scope, receive, send)

    if not response["streaming"]:
        _write_head(chunked=False)
        writer.write(response["body"])
        await writer.drain()
    return not state["draining"] and not close_requested


async def _handle_connection(app, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter, state: dict):
    peer = writer.get_extra_info("peername")
    state["conns"].add(writer)
    state["tasks"].add(asyncio.current_task())
    first_request = True
    try:
        while True:
            if state["draining"]:
                break   # shutdown: no new requests on this connection
            if first_request:
                # a FRESH connection must produce a complete request line
                # within the read deadline — a dribbled partial line would
                # otherwise dodge the header/body slowloris guard entirely
                # (it never reaches _handle_request)
                t_read0 = time.time()
                try:
                    request_line = await asyncio.wait_for(
                        reader.readline(), state["read_timeout"])
                except asyncio.TimeoutError:
                    await _reject(writer, 408, "request read timeout")
                    break
                first_request = False
            else:
                # established keep-alive: idling between requests stays
                # unbounded (as before), but once the first BYTE of a new
                # request line arrives the rest must complete within the
                # read deadline — otherwise one cheap valid request would
                # buy an attacker an unguarded dribble slot
                lead = await reader.read(1)
                if not lead:
                    break
                t_read0 = time.time()   # the idle keep-alive wait excluded
                try:
                    request_line = lead + await asyncio.wait_for(
                        reader.readline(), state["read_timeout"])
                except asyncio.TimeoutError:
                    await _reject(writer, 408, "request read timeout")
                    break
            if not request_line:
                break
            # count the request from its first complete request line: a
            # request mid-upload (headers/body still arriving) when
            # shutdown starts must be inside the drain accounting
            state["active"] += 1
            state["busy"].add(writer)
            try:
                keep = await _handle_request(app, reader, writer, peer,
                                             request_line, state,
                                             t_read0=t_read0)
            finally:
                state["active"] -= 1
                state["busy"].discard(writer)
                if state["draining"] and state["active"] == 0:
                    state["idle"].set()
            if not keep:
                break
    except (asyncio.IncompleteReadError, ConnectionResetError):
        pass
    finally:
        state["conns"].discard(writer)
        state["busy"].discard(writer)
        state["tasks"].discard(asyncio.current_task())
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:  # noqa: BLE001
            pass


def _close_conns(state: dict, only_idle: bool):
    for w in list(state["conns"]):
        if only_idle and w in state["busy"]:
            continue
        try:
            w.close()
        except Exception:  # noqa: BLE001
            pass


async def serve(app, host: str = "0.0.0.0", port: int = 8000,
                ready_event: asyncio.Event | None = None,
                stop_event: asyncio.Event | None = None,
                drain_seconds: float | None = None,
                read_timeout: float | None = None,
                on_drain=None):
    """Serve until SIGINT/SIGTERM (or ``stop_event``), then drain.
    ``on_drain`` (a blocking callable) runs on a worker thread as the
    drain begins.

    ``drain_seconds`` defaults to ``LFKT_DRAIN_SECONDS`` (30 — gunicorn's
    graceful_timeout, the reference's termination behavior at
    docker/Dockerfile.app:12; it also bounds the reference-parity 25 s
    generation timeout with headroom).  ``read_timeout`` defaults to
    ``LFKT_READ_TIMEOUT`` (30) — the slowloris guard's header/body read
    deadline (408 + Connection: close).
    """
    if drain_seconds is None or read_timeout is None:
        # one parse site for the knobs (utils/config.py registers them);
        # local import keeps this module's top-level deps stdlib-only
        from ..utils.config import get_settings

        _settings = get_settings()
        if drain_seconds is None:
            drain_seconds = _settings.drain_seconds
        if read_timeout is None:
            read_timeout = _settings.read_timeout
    await app.router.startup()
    state = {"active": 0, "draining": False, "idle": asyncio.Event(),
             "conns": set(), "busy": set(), "tasks": set(),
             "read_timeout": read_timeout}
    server = await asyncio.start_server(
        lambda r, w: _handle_connection(app, r, w, state), host, port)
    logger.info("httpd listening on %s:%d", host, port)
    if ready_event is not None:
        ready_event.set()

    stop = stop_event if stop_event is not None else asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError, ValueError):
            # non-main thread (tests/embedding) or unsupported platform:
            # graceful-shutdown-by-signal just isn't available there
            pass
    async with server:
        await stop.wait()
        state["draining"] = True
        # surface the drain on the health state machine (readiness flips
        # to 503 so k8s stops routing while in-flight requests finish);
        # generic ASGI apps without one are untouched
        health = getattr(getattr(app, "state", None), "health", None)
        if health is not None:
            from ..utils.health import DRAINING

            health.transition(DRAINING, "shutdown signal received")
        if on_drain is not None:
            await asyncio.to_thread(on_drain)
        server.close()            # stop accepting; existing tasks continue
        # one short tick before closing "idle" connections: a request whose
        # bytes are already buffered but whose handler is still parked in
        # readline() would otherwise be closed unserved — the wakeup lets
        # it claim busy status and ride the drain instead
        await asyncio.sleep(0.05)
        _close_conns(state, only_idle=True)   # idle keep-alives: EOF now
        if state["active"]:
            logger.info("httpd draining %d in-flight request(s) (≤%.0fs)",
                        state["active"], drain_seconds)
            try:
                await asyncio.wait_for(state["idle"].wait(), drain_seconds)
            except asyncio.TimeoutError:
                logger.warning("httpd drain timed out after %.0fs; "
                               "%d request(s) abandoned",
                               drain_seconds, state["active"])
        # Whatever survives is force-closed AND cancelled: a handler
        # blocked inside the app (not on socket I/O) never notices a
        # closed transport, and Server.wait_closed waits for it.
        _close_conns(state, only_idle=False)
        for t in list(state["tasks"]):
            t.cancel()
    await app.router.shutdown()


def run(app, host: str = "0.0.0.0", port: int = 8000, on_drain=None):
    asyncio.run(serve(app, host, port, on_drain=on_drain))

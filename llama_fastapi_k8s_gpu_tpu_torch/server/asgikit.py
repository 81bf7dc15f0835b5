"""In-tree ASGI micro-framework (the FastAPI subset the service uses).

The JAX package's copy (llama_fastapi_k8s_gpu_tpu/server/asgikit.py)
without its pydantic dependency: decorator routing with path parameters,
request-body validation through :mod:`.schemas` (422 with pydantic's error
list), ``HTTPException`` with a ``{"detail": ...}`` body,
``@app.middleware("http")``, ``@app.on_event("startup")``, ``app.state``,
request headers, and JSON, plain-text and streaming responses.  The app
runs under the in-tree ``httpd`` and is driven in-process through raw ASGI
calls in tests.

A :class:`StreamingResponse` body is sent as ``http.response.body``
messages with ``more_body`` while a second task waits on ``receive()``:
when the client goes away (``http.disconnect``, or a write that fails) the
body's generator is cancelled and closed at once, so its ``finally`` runs
— the server's SSE generators cancel their request's future there, and
the engine stops at its next decode chunk.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import logging
import re
import traceback
import typing
from typing import Any, Awaitable, Callable

from .schemas import Model, ValidationError

logger = logging.getLogger(__name__)


class HTTPException(Exception):
    def __init__(self, status_code: int, detail: Any = None):
        self.status_code = status_code
        self.detail = detail
        super().__init__(detail)


class State:
    """Attribute bag (FastAPI's app.state)."""


class URL:
    def __init__(self, scope: dict):
        self.path = scope.get("path", "/")
        self.query = scope.get("query_string", b"").decode()
        host = dict(scope.get("headers") or {}).get(b"host", b"").decode()
        self.scheme = scope.get("scheme", "http")
        self._str = f"{self.scheme}://{host}{self.path}" + (
            f"?{self.query}" if self.query else "")

    def __str__(self):
        return self._str


class Request:
    def __init__(self, app: "MicroAPI", scope: dict, body: bytes):
        self.app = app
        self.scope = scope
        self.method = scope.get("method", "GET")
        self.url = URL(scope)
        self.path_params: dict[str, Any] = {}
        self._body = body
        self._headers: dict[str, str] | None = None

    @property
    def headers(self) -> dict[str, str]:
        """Lower-cased header map, built on first use."""
        if self._headers is None:
            self._headers = {
                k.decode("latin-1").lower(): v.decode("latin-1")
                for k, v in (self.scope.get("headers") or [])}
        return self._headers

    async def json(self):
        return json.loads(self._body or b"null")


class Response:
    media_type = "application/octet-stream"

    def __init__(self, content: Any = b"", status_code: int = 200,
                 headers: dict[str, str] | None = None,
                 media_type: str | None = None):
        self.status_code = status_code
        self.headers = dict(headers or {})
        self.media_type = media_type or self.media_type
        self.body = self.render(content)

    def render(self, content) -> bytes:
        if isinstance(content, bytes):
            return content
        return str(content).encode()


class JSONResponse(Response):
    media_type = "application/json"

    def render(self, content) -> bytes:
        return json.dumps(content).encode()


class PlainTextResponse(Response):
    media_type = "text/plain; charset=utf-8"


class StreamingResponse(Response):
    """A body from an async generator of str or bytes chunks, sent as
    ``http.response.body`` messages with ``more_body`` (the in-tree httpd
    frames them with chunked transfer-encoding).  The default media type
    suits server-sent events."""

    media_type = "text/event-stream"

    def __init__(self, iterator, status_code: int = 200):
        super().__init__(b"", status_code)
        self.iterator = iterator

    async def chunks(self):
        try:
            async for chunk in self.iterator:
                yield chunk.encode() if isinstance(chunk, str) else chunk
        finally:
            # close the app's generator now, not at garbage collection:
            # its finally releases what the stream holds
            await self.iterator.aclose()


class _Route:
    _PARAM_RE = re.compile(r"{(\w+)}")

    def __init__(self, method: str, path: str, handler: Callable):
        self.method = method
        self.path = path
        self.handler = handler
        pattern = self._PARAM_RE.sub(r"(?P<\1>[^/]+)", path)
        self.regex = re.compile(f"^{pattern}$")
        self.signature = inspect.signature(handler)
        # resolve string annotations (``from __future__ import annotations``)
        self.annotations = typing.get_type_hints(handler)

    def annotation(self, name: str):
        return self.annotations.get(name, inspect.Parameter.empty)

    def match(self, path: str):
        m = self.regex.match(path)
        return None if m is None else m.groupdict()


class _Router:
    """Routes + lifecycle hooks; ``startup()``/``shutdown()`` as in
    starlette's router (tests call them directly)."""

    def __init__(self):
        self.routes: list[_Route] = []
        self.on_startup: list[Callable] = []
        self.on_shutdown: list[Callable] = []

    async def startup(self):
        for fn in self.on_startup:
            res = fn()
            if inspect.isawaitable(res):
                await res

    async def shutdown(self):
        for fn in self.on_shutdown:
            res = fn()
            if inspect.isawaitable(res):
                await res


class MicroAPI:
    def __init__(self, title: str = "app", version: str = "0.1.0"):
        self.title = title
        self.version = version
        self.state = State()
        self.router = _Router()
        self._middlewares: list[Callable] = []

    # -- registration ------------------------------------------------------
    def _register(self, method: str, path: str):
        def deco(fn):
            self.router.routes.append(_Route(method, path, fn))
            return fn
        return deco

    def get(self, path: str):
        return self._register("GET", path)

    def post(self, path: str):
        return self._register("POST", path)

    def on_event(self, name: str):
        hooks = {"startup": self.router.on_startup,
                 "shutdown": self.router.on_shutdown}[name]

        def deco(fn):
            hooks.append(fn)
            return fn
        return deco

    def middleware(self, kind: str):
        if kind != "http":
            raise ValueError(f"only http middleware exists, got {kind!r}")

        def deco(fn):
            self._middlewares.append(fn)
            return fn
        return deco

    # -- request handling --------------------------------------------------
    async def _dispatch(self, request: Request) -> Response:
        path = request.url.path
        matched_path = False
        for route in self.router.routes:
            params = route.match(path)
            if params is None:
                continue
            matched_path = True
            if route.method != request.method:
                continue
            request.path_params = params
            return await self._call_handler(route, request)
        if matched_path:
            return JSONResponse({"detail": "Method Not Allowed"}, 405)
        return JSONResponse({"detail": "Not Found"}, 404)

    async def _call_handler(self, route: _Route, request: Request) -> Response:
        kwargs: dict[str, Any] = {}
        for name in route.signature.parameters:
            ann = route.annotation(name)
            if ann is Request or name == "request":
                kwargs[name] = request
            elif isinstance(ann, type) and issubclass(ann, Model):
                try:
                    payload = await request.json()
                except json.JSONDecodeError:
                    return JSONResponse({"detail": "Invalid JSON body"}, 422)
                try:
                    kwargs[name] = ann.validate(payload)
                except ValidationError as e:
                    return JSONResponse({"detail": e.errors()}, 422)
            elif name in request.path_params:
                value = request.path_params[name]
                if ann is int:
                    try:
                        value = int(value)
                    except ValueError:
                        return JSONResponse(
                            {"detail": f"Invalid int path param {name!r}"}, 422)
                kwargs[name] = value
        result = route.handler(**kwargs)
        if inspect.isawaitable(result):
            result = await result
        if isinstance(result, Response):
            return result
        return JSONResponse(result)

    async def _handle(self, request: Request) -> Response:
        async def endpoint(req: Request) -> Response:
            try:
                return await self._dispatch(req)
            except HTTPException as e:
                return JSONResponse({"detail": e.detail}, e.status_code)
            except Exception:  # noqa: BLE001 — the 500 boundary
                logger.error("Unhandled error:\n%s", traceback.format_exc())
                return JSONResponse({"detail": "Internal Server Error"}, 500)

        call_next: Callable[[Request], Awaitable[Response]] = endpoint
        for mw in reversed(self._middlewares):
            call_next = _bind_middleware(mw, call_next)
        try:
            return await call_next(request)
        except HTTPException as e:
            return JSONResponse({"detail": e.detail}, e.status_code)

    # -- ASGI --------------------------------------------------------------
    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                message = await receive()
                if message["type"] == "lifespan.startup":
                    try:
                        await self.router.startup()
                        await send({"type": "lifespan.startup.complete"})
                    except Exception as e:  # noqa: BLE001 — reported to the server
                        await send({"type": "lifespan.startup.failed",
                                    "message": str(e)})
                elif message["type"] == "lifespan.shutdown":
                    try:
                        await self.router.shutdown()
                        await send({"type": "lifespan.shutdown.complete"})
                    except Exception as e:  # noqa: BLE001 — reported to the server
                        await send({"type": "lifespan.shutdown.failed",
                                    "message": str(e)})
                    return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported ASGI scope {scope['type']}")

        body = b""
        while True:
            message = await receive()
            if message["type"] == "http.request":
                body += message.get("body", b"")
                if not message.get("more_body"):
                    break
            elif message["type"] == "http.disconnect":
                return

        response = await self._handle(Request(self, scope, body))
        if isinstance(response, StreamingResponse):
            headers = [(b"content-type", response.media_type.encode()),
                       (b"cache-control", b"no-cache")]
            headers += [(k.encode(), v.encode()) for k, v in response.headers.items()]
            await send({"type": "http.response.start",
                        "status": response.status_code, "headers": headers})
            await _stream_body(response, receive, send)
            return
        headers = [(b"content-type", response.media_type.encode()),
                   (b"content-length", str(len(response.body)).encode())]
        headers += [(k.encode(), v.encode()) for k, v in response.headers.items()]
        await send({"type": "http.response.start",
                    "status": response.status_code, "headers": headers})
        await send({"type": "http.response.body", "body": response.body})


async def _stream_body(response: StreamingResponse, receive, send) -> None:
    """Send the body until it ends or the client goes away, whichever comes
    first; either way the body's generator is closed before this returns."""
    chunks = response.chunks()

    async def pump():
        async for chunk in chunks:
            await send({"type": "http.response.body", "body": chunk,
                        "more_body": True})
        await send({"type": "http.response.body", "body": b""})

    async def watch():
        while (await receive())["type"] != "http.disconnect":
            pass

    pumping = asyncio.ensure_future(pump())
    watching = asyncio.ensure_future(watch())
    try:
        await asyncio.wait({pumping, watching},
                           return_when=asyncio.FIRST_COMPLETED)
        if not pumping.done():
            logger.info("client disconnected mid-stream; closing the body")
            pumping.cancel()
        try:
            await pumping
        except (asyncio.CancelledError, ConnectionError):
            pass    # the client is gone: nothing more to send
    finally:
        watching.cancel()
        if not pumping.done():
            pumping.cancel()
        await chunks.aclose()


def _bind_middleware(mw, nxt):
    async def bound(request: Request) -> Response:
        return await mw(request, nxt)
    return bound

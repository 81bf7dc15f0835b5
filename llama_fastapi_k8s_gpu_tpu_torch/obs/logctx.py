"""Request-id log stamping + the structured JSON access-log formatter.

The JAX package's copy (llama_fastapi_k8s_gpu_tpu/obs/logctx.py): the
active request id (the trace id when sampled, a fresh id otherwise) rides
a :mod:`contextvars` variable — it follows the request through ``await``
points and into ``asyncio.to_thread`` workers — and
:class:`RequestIdFilter` stamps it onto every log record, so any line
logged while serving a request carries ``request_id``.
:class:`JsonFormatter` renders one JSON object per line; install both with
:func:`setup_json_logging` (server/__main__.py does).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging

#: the active request id ("-" outside any request scope)
_REQUEST_ID: contextvars.ContextVar[str] = contextvars.ContextVar(
    "lfkt_request_id", default="-")


@contextlib.contextmanager
def bind_request_id(rid: str):
    """Scope ``rid`` as the active request id for log stamping."""
    token = _REQUEST_ID.set(rid)
    try:
        yield
    finally:
        _REQUEST_ID.reset(token)


class RequestIdFilter(logging.Filter):
    """Stamps ``record.request_id`` from the context variable, so any
    formatter downstream can reference ``%(request_id)s``."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = _REQUEST_ID.get()
        return True


class JsonFormatter(logging.Formatter):
    """One JSON object per line; always includes the request id."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "request_id": getattr(record, "request_id", None)
            or _REQUEST_ID.get(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        # the access line's structured fields (logger.*(..., extra={...}))
        for key in ("route", "method", "status", "duration_s"):
            v = record.__dict__.get(key)
            if v is not None:
                out[key] = v
        return json.dumps(out)


#: the access logger the app's timing middleware writes to — one
#: structured record per served request
access_logger = logging.getLogger("lfkt.access")


def setup_json_logging(logger: logging.Logger | None = None,
                       stream=None) -> logging.Handler:
    """Attach a JSON handler (+ request-id filter) to ``logger`` (root by
    default).  Returns the handler so callers can detach it."""
    target = logger if logger is not None else logging.getLogger()
    handler = logging.StreamHandler(stream)
    handler.addFilter(RequestIdFilter())
    handler.setFormatter(JsonFormatter())
    target.addHandler(handler)
    return handler

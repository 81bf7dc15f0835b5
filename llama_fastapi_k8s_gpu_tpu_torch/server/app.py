"""The serving layer: the serial pod's HTTP surface over the engine.

The reference's externally observable behaviour, as the JAX package's
server keeps it (llama_fastapi_k8s_gpu_tpu/server/app.py):

- ``POST /response`` with the same schema, the same system-prompt assembly
  quirks (inserted at index 1, the ``.f`` name-suffix gender clause, the
  appearance facts after the third comma), the same truncation (400-char
  clip, chars/4 estimate, pop-index-2 loop) and the same admission
  control: a bounded queue(5) → 503, one consumer and a semaphore(1) →
  strictly serial generation, a 25 s future timeout → 408 with
  cancellation, engine errors → 500;
- ``POST /response/stream``: the same admission, server-sent events of
  OpenAI chunks ending in ``data: [DONE]``, bounded by a per-chunk gap and
  a total ``stream_deadline_seconds``;
- the OpenAI facade: ``POST /v1/chat/completions`` (with and without a
  stream) and ``GET /v1/models``, every failure in the OpenAI error
  envelope;
- ``GET /items/{item_id}``, the vestigial echo route;
- ``GET /health`` (model, device, queue and resilience state) and the
  split k8s probes ``/health/ready`` (503 unless READY) and
  ``/health/live`` (503 only in DEAD);
- ``GET /metrics`` (Prometheus text) and the trace surface
  ``/debug/traces``, ``/debug/traces/{trace_id}`` and ``/debug/requests``;
- the device-facing surfaces: ``/debug/compiles`` (graph captures, kernel
  builds and dispatches, obs/devtime.py), ``/debug/slo`` (burn rates,
  obs/slo.py), ``/debug/memory`` (the memory ledger, obs/memledger.py),
  ``/debug/incidents`` and ``/debug/incidents/{id}`` (the incident
  bundles on disk, obs/flightrec.py) and ``/debug/profile`` (a bounded
  ``torch.profiler`` capture, utils/tracing.py; with ``LFKT_PROFILE_DIR``
  set, startup pays the profiler's set-up before READY), with their
  ``/metrics`` families;
- the tracing middleware: a request id minted (or ingested from a
  ``traceparent``) for every request and answered as ``x-request-id``,
  the access log line, and ``request_seconds`` / ``http_requests_total``;
- the engine watchdog, started with the app and stopped with it; an
  ``EngineUnavailable`` from the engine becomes a 503.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import time
import uuid
from datetime import datetime

from ..obs import flightrec as _flightrec
from ..obs import memledger as _memledger
from ..obs.devtime import DEVTIME
from ..obs.logctx import access_logger, bind_request_id
from ..obs.slo import SLOEngine
from ..obs.trace import TRACER, Tracer
from ..utils.config import Settings, get_settings
from ..utils.faults import FAULTS
from ..utils.health import (
    READY,
    STARTING,
    STATE_CODES,
    EngineUnavailable,
    HealthMonitor,
)
from ..utils.metrics import Metrics
from .asgikit import (
    HTTPException,
    JSONResponse,
    MicroAPI,
    PlainTextResponse,
    Request,
    StreamingResponse,
)
from .schemas import BotMessageRequest, ChatCompletionRequest

logger = logging.getLogger(__name__)

_STREAM_DONE = object()  # consumer → handler sentinel: the stream finished


def _openai_error_body(status: int, message: str, code: str | None = None) -> dict:
    """The OpenAI error envelope of every ``/v1`` failure: 4xx are the
    caller's (``invalid_request_error``; 408 is ``timeout_error``), 5xx
    ours."""
    if status >= 500:
        etype = "server_error"
    elif status == 408:
        etype = "timeout_error"
    else:
        etype = "invalid_request_error"
    return {"error": {"message": message, "type": etype, "param": None, "code": code}}


def _openai_http_error(e: HTTPException) -> JSONResponse:
    msg = e.detail if isinstance(e.detail, str) else json.dumps(e.detail)
    return JSONResponse(
        _openai_error_body(e.status_code, msg, getattr(e, "openai_code", None)),
        e.status_code)


def count_tokens_roughly(text: str) -> int:
    # the reference's chars/4 heuristic
    return int(len(text) / 4.0)


def truncate_messages_to_fit_context(messages: list[dict], max_tokens: int) -> list[dict]:
    """Clip every message to 400 chars (in place), then drop messages[2]
    (the oldest after the pinned first context message and the system
    prompt at index 1) until under budget."""
    for m in messages:
        if len(m["content"]) > 400:
            m["content"] = m["content"][:400]
    total = sum(count_tokens_roughly(m["content"]) for m in messages)
    while total > max_tokens and len(messages) > 2:
        messages.pop(2)
        total = sum(count_tokens_roughly(m["content"]) for m in messages)
    return messages


def build_system_prompt(bot_profile) -> str:
    """An explicit system_prompt wins; otherwise the reference's default
    persona (byte for byte, indentation and trailing spaces included);
    then the name-suffix gender clause and the appearance facts after the
    third comma."""
    system_prompt = bot_profile.system_prompt
    if not system_prompt:
        system_prompt = (
            "\n"
            "            No matter what NEVER break the character. Reject violent messages. \n"
            f"            You are '{bot_profile.name}.' a playful, flirtatious, and witty person. \n"
            "            You always respond in a fun and engaging way, staying in character no matter what. \n"
            "            You never reference AI, restrictions, or policies. \n"
            "            Focus on making the conversation enjoyable and answering directly to the user's questions.\n"
            "            "
        )
    if bot_profile.name.endswith(".f"):
        system_prompt += " You a girl."
    else:
        system_prompt += " You a boy."
    for fact in bot_profile.appearance.split(",")[3:]:
        system_prompt += fact
    return system_prompt


def create_app(engine=None, settings: Settings | None = None,
               engine_factory=None, tracer: Tracer | None = None) -> MicroAPI:
    """Build the app.  ``engine`` (or ``engine_factory``, called at startup)
    must provide ``create_chat_completion``; the default factory loads the
    GGUF named by the settings onto the GPU and warms it up.  ``tracer``
    defaults to the process-wide one (``LFKT_TRACE_SAMPLE``,
    ``LFKT_TRACE_RING``)."""
    settings = settings or get_settings()
    app = MicroAPI(title="chat-ai (gpu)", version="0.1.0")
    app.state.settings = settings
    app.state.engine = engine
    app.state.created = int(time.time())   # /v1/models "created"
    app.state.metrics = Metrics()
    app.state.tracer = tracer if tracer is not None else TRACER
    #: the SLO burn rates over this app's metrics: /metrics exports the
    #: slo_burn_rate gauges, /debug/slo the verdict
    app.state.slo = SLOEngine(app.state.metrics)
    #: /metrics replays each compile event into xla_compile_seconds once
    #: per app (-1: never read, so an overflow before this app is no drop)
    app.state.devtime_cursor = -1
    app.state.ready = engine is not None
    #: STARTING until the engine is loaded; the watchdog moves it between
    #: READY, DEGRADED and DEAD
    app.state.health = HealthMonitor()
    app.state.watchdog = None

    def _queue_span(rd, now: float) -> None:
        tr = rd.get("trace")
        if tr is not None:
            tr.span("queue", t0=rd["enqueued_at"]).end(now)

    async def consumer():
        """Single drain task: strict FIFO, one generation at a time."""
        queue = app.state.queue
        while True:
            rd = await queue.get()
            try:
                now = time.time()
                app.state.metrics.observe("queue_wait_seconds", now - rd["enqueued_at"])
                _queue_span(rd, now)
                if rd["future"].cancelled():
                    logger.info("Future was cancelled before processing; skipping.")
                    continue
                if "stream_queue" in rd:
                    try:
                        await _truncate_and_stream(rd)
                    except Exception as e:  # noqa: BLE001 — surfaced on the stream
                        logger.error("Error during streamed generation: %s", e)
                        rd["stream_queue"].put_nowait(e)
                    continue
                try:
                    result, err = await _truncate_and_generate(rd), None
                except Exception as e:  # noqa: BLE001 — handed to the waiter
                    result, err = None, e
                if rd["future"].cancelled():
                    logger.info("Future cancelled during processing; %s dropped.",
                                "error" if err else "result")
                elif err is not None:
                    rd["future"].set_exception(err)
                else:
                    rd["future"].set_result(result)
            finally:
                queue.task_done()

    def _model_label(obj=None) -> str:
        """The ``model`` label: the response's or timings' model, else the
        engine's name."""
        name = obj.get("model") if isinstance(obj, dict) else None
        if not name:
            name = getattr(app.state.engine, "model_name", None)
        return str(name or "")

    def _observe_engine_timings(m, answer=None):
        timings = answer.get("lfkt_timings") if isinstance(answer, dict) else None
        if timings is None:
            timings = getattr(app.state.engine, "last_timings", None)
        if timings:
            model = _model_label(timings)
            m.observe("engine_ttft_seconds", timings["ttft_s"],
                      bucket=str(timings.get("bucket", 0)), model=model)
            if timings["tokens_per_sec"]:
                m.observe("engine_decode_tokens_per_sec",
                          timings["tokens_per_sec"], model=model)
            reused = timings.get("prefix_reused_tokens", 0)
            if reused:
                m.inc("prefix_cache_hits_total")
                m.inc("prefix_cache_reused_tokens_total", reused)

    def _meter_tokens(m, prompt: int, completion: int, model: str) -> None:
        if prompt:
            m.inc("tokens_prompt_total", prompt, model=model)
        if completion:
            m.inc("tokens_generated_total", completion, model=model)

    def _meter_answer(answer, m) -> None:
        """The dict check (→ 500) and the token metering of one answer."""
        if not isinstance(answer, dict):
            logger.error("Unexpected response type: %s. Response: %s",
                         type(answer), answer)
            raise HTTPException(status_code=500,
                                detail="Unexpected response from model")
        usage = answer.get("usage") or {}
        if usage.get("completion_tokens"):
            m.inc("generated_tokens_total", usage["completion_tokens"])
        _meter_tokens(m, usage.get("prompt_tokens", 0),
                      usage.get("completion_tokens", 0), _model_label(answer))

    def _finish_answer(rd, answer, m):
        """The /v1 facade gets the OpenAI dict (minus the engine's timings
        rider), /response its concatenated text."""
        _meter_answer(answer, m)
        if rd.get("openai"):
            answer = dict(answer)
            answer.pop("lfkt_timings", None)
            return answer
        return "".join(c["message"]["content"]
                       for c in answer.get("choices", []) if "message" in c)

    def _gen_kwargs(rd) -> dict:
        """The pod's serving defaults, overridden by a /v1 request's own
        sampling fields."""
        kw = dict(temperature=settings.temperature, top_p=settings.top_p,
                  frequency_penalty=settings.frequency_penalty,
                  presence_penalty=settings.presence_penalty)
        kw.update(rd.get("params") or {})
        return kw

    def _resilience_kw(rd) -> dict:
        """The request's deadline, did-the-caller-give-up callback and
        trace: a timed-out or disconnected request frees the engine within
        one decode chunk."""
        return {"deadline": rd["deadline"], "abort": rd["future"].cancelled,
                "trace": rd["trace"]}

    def _messages(rd) -> list[dict]:
        # /v1 requests ride raw: OpenAI clients own their history
        if rd.get("raw"):
            return rd["messages"]
        return truncate_messages_to_fit_context(rd["messages"],
                                                settings.max_context_tokens)

    async def _truncate_and_generate(rd):
        m = app.state.metrics
        async with app.state.semaphore:  # one generation at a time
            try:
                messages = _messages(rd)
                t0 = time.time()
                answer = await asyncio.to_thread(
                    lambda: app.state.engine.create_chat_completion(
                        messages=messages, stream=False,
                        **_gen_kwargs(rd), **_resilience_kw(rd)))
                m.observe("generation_seconds", time.time() - t0,
                          model=_model_label(answer))
                _observe_engine_timings(m, answer)
                return _finish_answer(rd, answer, m)
            except HTTPException:
                raise
            except ValueError as e:
                if rd.get("openai"):
                    # the client's input (an oversized prompt): a 400
                    raise HTTPException(status_code=400, detail=str(e)) from e
                m.inc("engine_errors_total")
                logger.error("Error during message generation: %s", e)
                raise HTTPException(
                    status_code=500,
                    detail=f"Error during message generation: {str(e)}") from e
            except EngineUnavailable as e:
                m.inc("engine_unavailable_total")
                logger.error("Engine unavailable: %s", e)
                raise HTTPException(status_code=503,
                                    detail=f"Engine unavailable: {e}") from e
            except Exception as e:  # noqa: BLE001 — the reference's 500
                m.inc("engine_errors_total")
                logger.error("Error during message generation: %s", e)
                raise HTTPException(
                    status_code=500,
                    detail=f"Error during message generation: {str(e)}") from e

    async def _truncate_and_stream(rd):
        """One streaming generation, forwarding the engine's chunks to the
        handler's queue from the worker thread.  When the client gives up
        (timeout or disconnect cancel ``rd["future"]``) the engine's
        iterator is closed, and the engine stops at its next chunk."""
        m = app.state.metrics
        chunk_q = rd["stream_queue"]
        loop = asyncio.get_running_loop()
        timings_box: list = []
        messages = _messages(rd)

        def run():
            try:
                it = app.state.engine.create_chat_completion(
                    messages=messages, stream=True,
                    **_gen_kwargs(rd), **_resilience_kw(rd))
                try:
                    for chunk in it:
                        if rd["future"].cancelled():
                            return   # closes it: the engine stops
                        t = chunk.pop("lfkt_timings", None)
                        if t is not None:
                            timings_box.append(t)
                            # the /v1 stream's usage chunk reads it
                            rd["timings"] = t
                        loop.call_soon_threadsafe(chunk_q.put_nowait, chunk)
                    loop.call_soon_threadsafe(chunk_q.put_nowait, _STREAM_DONE)
                finally:
                    it.close()
            except Exception as e:  # noqa: BLE001 — surfaced as an SSE error
                loop.call_soon_threadsafe(chunk_q.put_nowait, e)

        async with app.state.semaphore:
            t0 = time.time()
            await asyncio.to_thread(run)
            m.observe("generation_seconds", time.time() - t0,
                      model=_model_label(timings_box[0] if timings_box else None))
            m.inc("streamed_generations_total")
            _observe_engine_timings(
                m, {"lfkt_timings": timings_box[0]} if timings_box else None)
            if timings_box:
                t = timings_box[0]
                _meter_tokens(m, t.get("prompt_tokens", 0),
                              t.get("completion_tokens", 0), _model_label(t))

    @app.on_event("startup")
    async def startup_event():
        app.state.queue = asyncio.Queue(maxsize=settings.max_queue_size)
        app.state.semaphore = asyncio.Semaphore(1)
        app.state.health.transition(STARTING, "model loading")
        if app.state.engine is None:
            factory = engine_factory or _default_engine_factory(settings)
            app.state.engine = await asyncio.to_thread(factory)
        engine = app.state.engine
        if hasattr(engine, "metrics_sink"):
            engine.metrics_sink = app.state.metrics
        # the incident bundles carry this app's health trail (weakly held;
        # a later app wins, which is the live one)
        _flightrec.FLIGHTREC.install(health=app.state.health, engine=engine)
        # with LFKT_PROFILE_DIR set, the profiler's one-time set-up (seconds
        # on the card) is paid here, before READY, and not inside the first
        # /debug/profile window; unset, no profiler is touched
        from ..utils.tracing import prepare_profiler

        await asyncio.to_thread(prepare_profiler)
        app.state.ready = True
        app.state.health.transition(READY, "engine loaded")
        if settings.watchdog and getattr(engine, "heartbeat", None) is not None:
            from ..engine.watchdog import Watchdog

            app.state.watchdog = Watchdog(
                engine, app.state.health, app.state.metrics,
                stall_seconds=settings.watchdog_stall_seconds,
                poll_seconds=settings.watchdog_poll_seconds,
                max_recoveries=settings.watchdog_max_recoveries,
                error_burst=settings.watchdog_error_burst,
                error_window=settings.watchdog_error_window,
                backoff_seconds=settings.watchdog_backoff_seconds,
                backoff_max=settings.watchdog_backoff_max,
            ).start()
        app.state.consumer_task = asyncio.create_task(consumer())

    @app.on_event("shutdown")
    async def shutdown_event():
        if app.state.watchdog is not None:
            # stop() joins the thread: off the event loop
            watchdog, app.state.watchdog = app.state.watchdog, None
            await asyncio.to_thread(watchdog.stop)
        task = getattr(app.state, "consumer_task", None)
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    def _validate_model(model: str | None) -> str | None:
        """400 (OpenAI code ``model_not_found``) for a model alias this pod
        does not serve."""
        name = getattr(app.state.engine, "model_name", None)
        if model is not None and name is not None and model != name:
            e = HTTPException(
                status_code=400,
                detail=f"unknown model {model!r}; this pod serves: {name}")
            e.openai_code = "model_not_found"
            raise e
        return model

    def _enqueue_rd(request: Request, messages: list[dict], extra: dict | None = None,
                    *, model: str | None = None, params: dict | None = None,
                    raw: bool = False, openai: bool = False) -> dict:
        """Enqueue ``messages`` with a future; 503 on overflow.  The
        admission timeout (a stream's: its total deadline) becomes the
        engine's deadline."""
        queue = app.state.queue
        m = app.state.metrics
        now = time.time()
        budget = (settings.stream_deadline_seconds
                  if extra and "stream_queue" in extra else settings.timeout_seconds)
        trace = request.scope.get("lfkt.trace")
        rd = {
            "messages": messages,
            "future": asyncio.get_running_loop().create_future(),
            "enqueued_at": now,
            "deadline": now + budget,
            "trace": trace,
            "model": model,
            "params": params,
            "raw": raw,
            "openai": openai,
            **(extra or {}),
        }
        try:
            queue.put_nowait(rd)
        except asyncio.QueueFull:
            m.inc("requests_rejected_total")
            if trace is not None:
                trace.event("admission_rejected", queue_depth=queue.qsize())
            raise HTTPException(status_code=503,
                                detail="Server too busy. Please try again later.")
        if trace is not None:
            trace.note(deadline=rd["deadline"])
            if model is not None:
                trace.note(model=model)
        m.set_gauge("queue_depth", queue.qsize())
        return rd

    def _admit(request_body: BotMessageRequest, request: Request,
               extra: dict | None = None) -> dict:
        """Admission of both /response routes: the messages with the system
        prompt at index 1, the model alias checked, enqueued."""
        model = _validate_model(request_body.model)
        messages = [{"role": m.turn, "content": m.message}
                    for m in request_body.context]
        messages.insert(1, {"role": "system",
                            "content": build_system_prompt(request_body.bot_profile)})
        return _enqueue_rd(request, messages, extra, model=model)

    @app.post("/response")
    async def generate_response(request_body: BotMessageRequest, request: Request):
        m = app.state.metrics
        future = _admit(request_body, request)["future"]
        try:
            response = await asyncio.wait_for(future, timeout=settings.timeout_seconds)
            return {"response": response}
        except asyncio.TimeoutError:
            logger.warning("Generation timed out")
            m.inc("requests_timed_out_total")
            future.cancel()
            raise HTTPException(status_code=408, detail="Generation timed out")
        except HTTPException:
            raise
        except Exception as e:  # noqa: BLE001 — the reference's 500
            logger.error("Internal server error: %s", e)
            raise HTTPException(status_code=500,
                                detail=f"Internal server error: {str(e)}")

    def _sse(rd, error_body, usage: bool = False):
        """The SSE body of one stream: the engine's chunks as ``data:``
        events, then ``[DONE]`` — with ``usage``, a usage chunk before it.
        Each chunk may take ``timeout_seconds``, the whole stream
        ``stream_deadline_seconds``; on either, or on an engine error, one
        ``error_body(status, message)`` event ends it.  The generator's
        ``finally`` runs on a client disconnect too: it cancels the future,
        which the engine watches once a chunk, and closes the trace."""
        m = app.state.metrics
        loop = asyncio.get_running_loop()
        deadline = loop.time() + settings.stream_deadline_seconds
        trace = rd.get("trace")

        async def sse():
            sspan = trace.span("stream") if trace is not None else None
            n_events = 0
            last = None
            try:
                while True:
                    gap = min(settings.timeout_seconds, deadline - loop.time())
                    try:
                        if gap <= 0:
                            raise asyncio.TimeoutError
                        chunk = await asyncio.wait_for(rd["stream_queue"].get(),
                                                       timeout=gap)
                    except asyncio.TimeoutError:
                        m.inc("requests_timed_out_total")
                        if sspan is not None:
                            sspan.event("stream_timeout")
                        yield "data: " + json.dumps(
                            error_body(408, "Generation timed out")) + "\n\n"
                        return
                    if chunk is _STREAM_DONE:
                        t = rd.get("timings")
                        if usage and t is not None and last is not None:
                            p, c = t.get("prompt_tokens", 0), t.get("completion_tokens", 0)
                            yield "data: " + json.dumps({
                                "id": last.get("id"),
                                "object": "chat.completion.chunk",
                                "created": last.get("created"),
                                "model": last.get("model"),
                                "choices": [],
                                "usage": {"prompt_tokens": p, "completion_tokens": c,
                                          "total_tokens": p + c},
                            }) + "\n\n"
                        yield "data: [DONE]\n\n"
                        return
                    if isinstance(chunk, Exception):
                        status = 400 if isinstance(chunk, ValueError) else 500
                        yield "data: " + json.dumps(error_body(status, str(chunk))) + "\n\n"
                        return
                    last = chunk
                    n_events += 1
                    yield "data: " + json.dumps(chunk) + "\n\n"
            finally:
                if not rd["future"].done():
                    rd["future"].cancel()
                if sspan is not None:
                    sspan.set(events=n_events)
                    sspan.end()
                app.state.tracer.finish(trace)

        return StreamingResponse(sse())

    @app.post("/response/stream")
    async def generate_response_stream(request_body: BotMessageRequest,
                                       request: Request):
        """``/response`` as server-sent events of OpenAI chunks."""
        rd = _admit(request_body, request, extra={"stream_queue": asyncio.Queue()})
        return _sse(rd, lambda status, msg: {"error": msg})

    @app.get("/v1/models")
    async def v1_models():
        """The served model, OpenAI list-shaped."""
        name = (getattr(app.state.engine, "model_name", None)
                or settings.model_name)
        return {"object": "list",
                "data": [{"id": name, "object": "model",
                          "created": app.state.created, "owned_by": "lfkt"}]}

    def _v1_params(body: ChatCompletionRequest) -> dict:
        """The request's explicitly set sampling fields."""
        return {k: v for k, v in dict(
            temperature=body.temperature, top_p=body.top_p,
            frequency_penalty=body.frequency_penalty,
            presence_penalty=body.presence_penalty, max_tokens=body.max_tokens,
            stop=body.stop, seed=body.seed,
        ).items() if v is not None}

    @app.post("/v1/chat/completions")
    async def v1_chat_completions(body: ChatCompletionRequest, request: Request):
        """OpenAI chat completions: the engine's completion dict, or with
        ``stream: true`` ``chat.completion.chunk`` events."""
        m = app.state.metrics
        try:
            if body.n != 1:
                raise HTTPException(
                    status_code=400,
                    detail="n must be 1: this server returns a single choice per request")
            if not body.messages:
                raise HTTPException(status_code=400, detail="messages must be non-empty")
            model = _validate_model(body.model)
            params = _v1_params(body)
            messages = [{"role": msg.role, "content": msg.content}
                        for msg in body.messages]
            if body.stream:
                rd = _enqueue_rd(request, messages, {"stream_queue": asyncio.Queue()},
                                 model=model, params=params, raw=True, openai=True)
                return _sse(rd, _openai_error_body, usage=bool(
                    body.stream_options and body.stream_options.include_usage))
            rd = _enqueue_rd(request, messages, model=model, params=params,
                             raw=True, openai=True)
            try:
                answer = await asyncio.wait_for(rd["future"],
                                                timeout=settings.timeout_seconds)
            except asyncio.TimeoutError:
                logger.warning("Generation timed out")
                m.inc("requests_timed_out_total")
                rd["future"].cancel()
                raise HTTPException(status_code=408, detail="Generation timed out")
            return JSONResponse(answer)
        except HTTPException as e:
            return _openai_http_error(e)
        except Exception as e:  # noqa: BLE001 — every failure in the envelope
            logger.error("Internal server error: %s", e)
            return _openai_http_error(HTTPException(
                status_code=500, detail=f"Internal server error: {str(e)}"))

    def _resilience_info() -> dict:
        """The state machine, the watchdog's counters and the last engine
        error, for /health."""
        st = app.state
        info: dict = {"health": st.health.snapshot()}
        wd = st.watchdog
        if wd is not None:
            info["watchdog"] = {
                "trips": wd.trips,
                "recoveries": wd.recoveries,
                "max_recoveries": wd.max_recoveries,
                "last_trip_reason": wd.last_trip_reason,
                "stall_seconds": wd.stall_seconds,
            }
        hb = getattr(st.engine, "heartbeat", None)
        if hb is not None:
            info["engine_errors"] = {"total": hb.errors_total, "last": hb.last_error}
        if FAULTS.armed():        # drills only
            info["faults_armed"] = FAULTS.stats()
        return info

    @app.get("/health/ready")
    async def health_ready():
        """Readiness probe: 200 only in READY."""
        h = app.state.health
        ok = h.ready()
        snap = h.snapshot()
        return JSONResponse({"ready": ok, "state": snap["state"],
                             "reason": snap["reason"]}, 200 if ok else 503)

    @app.get("/health/live")
    async def health_live():
        """Liveness probe: 503 only in DEAD."""
        h = app.state.health
        ok = h.alive()
        snap = h.snapshot()
        return JSONResponse({"alive": ok, "state": snap["state"],
                             "reason": snap["reason"]}, 200 if ok else 503)

    @app.get("/health")
    async def health():
        """The operator-facing health document."""
        st = app.state
        if not st.ready:
            raise HTTPException(status_code=503, detail="model loading")
        eng = st.engine
        cfg = getattr(eng, "cfg", None)
        params = getattr(eng, "params", None)
        engine_info = {
            "model": getattr(eng, "model_name", None),
            "n_ctx": getattr(cfg, "n_ctx", None),
            "attn_impl": getattr(cfg, "attn_impl", None),
            "weight_formats": params.formats() if hasattr(params, "formats") else None,
            "kv_dtype": getattr(cfg, "kv_dtype", None),
            "kv_cache_bytes": getattr(eng, "kv_cache_bytes", None),
            "decode_layer_unroll": _effective_unroll(cfg),
            "device": str(getattr(eng, "device", None)),
        }
        return {
            "status": "ok",
            "state": st.health.state,
            "model_loaded": eng is not None,
            "queue_depth": st.queue.qsize() if hasattr(st, "queue") else None,
            "max_queue_size": settings.max_queue_size,
            "engine": engine_info,
            "resilience": _resilience_info(),
        }

    @app.get("/metrics")
    async def metrics():
        m = app.state.metrics
        if hasattr(app.state, "queue"):
            m.set_gauge("queue_depth", app.state.queue.qsize())
        m.set_gauge("health_state", STATE_CODES[app.state.health.state])
        eng = app.state.engine
        hb = getattr(eng, "heartbeat", None)
        if hb is not None:
            m.set_gauge("engine_inflight", hb.busy_count())
            m.set_gauge("engine_error_count", hb.errors_total)
        kv_bytes = getattr(eng, "kv_cache_bytes", None)
        if kv_bytes is not None:
            m.set_gauge("kv_cache_bytes", kv_bytes)
        if eng is not None:
            m.set_gauge("models_loaded", 1)
            wb = getattr(eng, "weight_bytes", 0)
            if wb:
                m.set_gauge("model_weight_bytes", wb, model=_model_label())
        # the memory ledger's families are rebuilt whole each scrape (a
        # vanished row must drop its series); no await between the reset
        # and the render, so a concurrent scrape never sees them half-built
        m.reset_family("hbm_bytes")
        m.reset_family("hbm_headroom_bytes")
        if _memledger.MEMLEDGER.armed:
            mdoc = _memledger.MEMLEDGER.snapshot()
            for row in mdoc["components"]:
                m.set_gauge("hbm_bytes", row["bytes"],
                            component=row["component"], model=row["model"])
            if mdoc["residual_bytes"] is not None:
                m.set_gauge("hbm_bytes", mdoc["residual_bytes"],
                            component="residual", model="")
            if mdoc["headroom"] is not None:
                m.set_gauge("hbm_headroom_bytes", mdoc["headroom"]["bytes"])
        if _flightrec.FLIGHTREC.armed:
            m.set_gauge("incidents_total", _flightrec.FLIGHTREC.recorded_total)
        tstats = app.state.tracer.stats()
        m.set_gauge("trace_ring_used", tstats["ring_used"])
        m.set_gauge("traces_started_total", tstats["started_total"])
        m.set_gauge("traces_sampled_out_total", tstats["sampled_out_total"])
        # captures and dispatches as snapshots, each compile wall replayed
        # into the histogram once through this app's cursor
        for prog, c in DEVTIME.counters().items():
            m.set_gauge("xla_compiles_total", c["compiles"], program=prog)
            m.set_gauge("jit_dispatches_total", c["dispatches"], program=prog)
        m.set_gauge("xla_recompile_storms_total", DEVTIME.storms_total)
        cursor, events = DEVTIME.events_since(app.state.devtime_cursor)
        app.state.devtime_cursor = cursor
        for ev in events:
            m.observe("xla_compile_seconds", ev["wall_s"], program=ev["program"])
        m.set_gauge("xla_compile_events_dropped_total", DEVTIME.events_dropped)
        # the burn rates over the series recorded above
        app.state.slo.export()
        return PlainTextResponse(m.render())

    @app.get("/debug/traces")
    async def debug_traces():
        """Recent completed traces (newest first) and the tracer's stats."""
        t = app.state.tracer
        return {"stats": t.stats(), "traces": t.traces()}

    @app.get("/debug/traces/{trace_id}")
    async def debug_trace(trace_id: str):
        """One trace's full span tree (in flight or completed)."""
        tr = app.state.tracer.get(trace_id)
        if tr is None:
            raise HTTPException(status_code=404,
                                detail=f"no trace {trace_id!r} in the ring")
        return tr.to_dict()

    @app.get("/debug/requests")
    async def debug_requests():
        """The requests in flight: engine, deadline left, tokens so far."""
        return {"requests": app.state.tracer.inflight()}

    @app.get("/debug/compiles")
    async def debug_compiles():
        """The compile registry: every program with its captures or builds,
        its dispatches or launches, and the signatures it compiled."""
        return DEVTIME.snapshot()

    @app.get("/debug/slo")
    async def debug_slo():
        """The SLO verdict: per-SLO multi-window burn rates and the
        recompile-storm state; ``verdict`` is ok | warn | breach."""
        return app.state.slo.evaluate()

    @app.get("/debug/memory")
    async def debug_memory():
        """The memory ledger: per-component bytes, the residual against the
        device's ground truth, and headroom."""
        return _memledger.MEMLEDGER.snapshot()

    @app.get("/debug/incidents")
    async def debug_incidents():
        """The incident bundles on disk, newest first (read in a worker
        thread: this is asked for when the pod is already in trouble)."""
        fr = _flightrec.FLIGHTREC
        incidents = await asyncio.to_thread(fr.list) if fr.armed else []
        return {"armed": fr.armed,
                "recorded_total": fr.recorded_total,
                "debounced_total": fr.debounced_total,
                "incidents": incidents}

    @app.get("/debug/incidents/{incident_id}")
    async def debug_incident(incident_id: str):
        """One incident bundle, read back from disk."""
        doc = await asyncio.to_thread(_flightrec.FLIGHTREC.get, incident_id)
        if doc is None:
            raise HTTPException(status_code=404,
                                detail=f"no incident {incident_id!r} in the ring")
        return doc

    @app.get("/debug/profile")
    async def debug_profile(request: Request):
        """A bounded ``torch.profiler`` capture: 403 until LFKT_PROFILE_DIR
        is set, 409 while another runs; ``?seconds=`` is clamped.  The
        capture blocks a worker thread, never the event loop."""
        from urllib.parse import parse_qs

        from ..utils.tracing import ProfileBusy, ProfileDisabled, capture_profile

        q = parse_qs(request.url.query)
        try:
            seconds = float(q.get("seconds", ["2.0"])[0])
        except ValueError:
            raise HTTPException(status_code=400, detail="seconds must be a number")
        if not math.isfinite(seconds):
            raise HTTPException(status_code=400, detail="seconds must be finite")
        try:
            return await asyncio.to_thread(capture_profile, seconds)
        except ProfileDisabled as e:
            raise HTTPException(status_code=403, detail=str(e))
        except ProfileBusy as e:
            raise HTTPException(status_code=409, detail=str(e))

    @app.get("/items/{item_id}")
    async def read_item(item_id: int):
        # vestigial echo route kept for parity with the reference's surface
        return {"item_id": item_id}

    def _route_template(method: str, path: str) -> str:
        """The matched route's path template: the bounded ``route`` label
        (``/items/{item_id}``, never ``/items/7``)."""
        for route in app.router.routes:
            if route.method == method and route.match(path) is not None:
                return route.path
        return "unmatched"

    @app.middleware("http")
    async def log_request_time(request: Request, call_next):
        start_time = time.time()
        tracer = app.state.tracer
        # ingest the client's W3C traceparent or mint a trace; a sampled-out
        # request still gets a request id for the log lines
        trace = tracer.start("request", t0=start_time,
                             traceparent=request.headers.get("traceparent"))
        rid = trace.trace_id if trace is not None else uuid.uuid4().hex
        request.scope["lfkt.trace"] = trace
        route = _route_template(request.method, request.url.path)
        if trace is not None:
            trace.root.set(method=request.method, route=route)
            trace.note(route=route)
            httpd_read = request.scope.get("lfkt.httpd_read")
            if httpd_read is not None:
                trace.span("httpd.read", t0=httpd_read[0]).end(httpd_read[1])

        def finalize(status: int) -> None:
            time_of_day = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            process_time = time.time() - start_time
            app.state.metrics.observe("request_seconds", process_time, route=route)
            app.state.metrics.inc("http_requests_total", route=route, code=str(status))
            access_logger.info(
                "Request at %s: %s %s completed in %.4fs",
                time_of_day, request.method, request.url, process_time,
                extra={"route": route, "method": request.method, "status": status,
                       "duration_s": round(process_time, 6)})
            if trace is not None:
                trace.root.set(status=status)

        with bind_request_id(rid):
            try:
                response = await call_next(request)
            except BaseException:
                finalize(500)
                tracer.finish(trace)
                raise
            finalize(response.status_code)
        response.headers.setdefault("x-request-id", rid)
        if trace is not None:
            response.headers.setdefault("traceparent", trace.traceparent())
            if not isinstance(response, StreamingResponse):
                # a stream finishes its trace in the SSE generator
                tracer.finish(trace)
        return response

    return app


def _effective_unroll(cfg) -> int | None:
    """The layers per decode launch ``cfg`` serves — the ``-1`` / divisor
    clamp applied — or None for an engine without the field (fakes)."""
    if getattr(cfg, "decode_layer_unroll", None) is None:
        return None
    from ..ops.decode_loop import effective_unroll

    return effective_unroll(cfg)


def _default_engine_factory(settings: Settings):
    def factory():
        from ..engine import Engine

        eng = Engine(
            settings.model_path,
            n_ctx=settings.max_context_tokens,
            weight_format=settings.weight_format,
            decode_chunk=settings.decode_chunk,
            prefill_buckets=settings.prefill_bucket_list,
            max_gen_tokens=settings.max_gen_tokens,
            attn_impl=settings.attn_impl,
            kv_dtype=settings.kv_dtype,
            decode_layer_unroll=settings.decode_layer_unroll,
            prefix_cache=settings.prefix_cache,
            prefill_chunk=settings.prefill_chunk,
        )
        eng.warmup()
        return eng
    return factory

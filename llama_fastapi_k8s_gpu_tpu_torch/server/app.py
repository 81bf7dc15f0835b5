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
- with ``LFKT_BATCH_SIZE`` > 1, the reference's two batched dispatch
  paths over lanes of one card: ``LFKT_SCHEDULER=continuous`` (the
  default) forwards each request to the ``ContinuousEngine``'s scheduler
  without a barrier, at most ``batch_size`` in flight (so the bounded
  queue stays the 503 surface), streams included; ``cycle`` coalesces up
  to ``batch_size`` queued ``/response`` requests into one ``MeshEngine``
  cycle, while ``/v1`` requests take the per-request path and streams run
  serially in their FIFO slot;
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
  ``EngineUnavailable`` from the engine becomes a 503;
- multi-model serving (``LFKT_MODELS``, serving/registry.py): ``model=``
  routes each request to its engine, ``/v1/models`` lists the routable
  aliases, ``/health`` carries a ``models`` row a model, and ``POST
  /admin/models/reload`` (or SIGHUP) converges the registry to a new
  manifest live; the watchdog does not run over a registry;
- disaggregated prefill/decode (``LFKT_DISAGG_ROLE``, serving/disagg/): the
  page service and/or the remote-prefill client armed at startup, with a
  ``disagg`` block in ``/health`` and the ``disagg_*`` families;
- warm-page migration between replicas (``LFKT_MIGRATE``,
  serving/fleet/migrate.py): the page service and the scale-out warm-up
  before READY, the pull-on-remap admission hook on the fleet router's
  ``x-lfkt-prior-owner`` stamp, ``GET /admin/migrate/hot`` and ``POST
  /admin/migrate/pull`` (the receiving half of a peer's SIGTERM drain,
  server/httpd.py), a ``migration`` block in ``/health`` and the
  ``kv_migration_*`` families.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import signal
import time
import uuid
from datetime import datetime

from ..obs import flightrec as _flightrec
from ..obs import memledger as _memledger
from ..obs.devtime import DEVTIME
from ..obs.logctx import access_logger, bind_request_id, sanitize_text
from ..obs.slo import SLOEngine
from ..obs.trace import TRACER, Tracer
from ..serving.fleet.affinity import AFFINITY_KEY_HEADER, PRIOR_OWNER_HEADER
from ..utils.config import Settings, get_settings
from ..utils.faults import FAULTS
from ..utils.health import (
    READY,
    STARTING,
    STATE_CODES,
    DeadlineExceeded,
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
    #: the disagg roles armed at startup from LFKT_DISAGG_ROLE (None: off)
    app.state.disagg = None
    #: warm-page migration (serving/fleet/migrate.py), armed at startup by
    #: LFKT_MIGRATE (None: off)
    app.state.migration = None
    #: one live manifest reload at a time (POST /admin/models/reload, SIGHUP)
    app.state.reload_busy = asyncio.Lock()

    def _queue_span(rd, now: float) -> None:
        tr = rd.get("trace")
        if tr is not None:
            tr.span("queue", t0=rd["enqueued_at"]).end(now)

    async def consumer():
        """Single drain task, strict FIFO: one generation at a time; with
        ``batch_size`` > 1 a continuous engine takes each request without
        a barrier, and a cycle engine up to ``batch_size`` a cycle."""
        queue = app.state.queue
        while True:
            batch = [await queue.get()]
            if hasattr(app.state.engine, "submit"):
                # the slot scheduler admits into free lanes at chunk
                # boundaries; the in-flight permits (batch_size) keep the
                # bounded queue the back-pressure surface
                rd = batch[0]
                now = time.time()
                app.state.metrics.observe("queue_wait_seconds", now - rd["enqueued_at"])
                _queue_span(rd, now)
                if rd["future"].cancelled():
                    logger.info("Future was cancelled before processing; skipping.")
                elif "stream_queue" in rd:
                    await app.state.inflight.acquire()  # lfkt: transfers[inflight] -- permit released in _stream_task's finally
                    _spawn(_stream_task(rd))
                else:
                    await app.state.inflight.acquire()  # lfkt: transfers[inflight] -- permit released in _forward_to_scheduler's finally
                    _spawn(_forward_to_scheduler(rd))
                queue.task_done()
                continue
            can_batch = (settings.batch_size > 1
                         and hasattr(app.state.engine, "create_chat_completions"))
            while can_batch and len(batch) < settings.batch_size:
                try:
                    batch.append(queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                now = time.time()
                live, streams = [], []
                for rd in batch:
                    app.state.metrics.observe("queue_wait_seconds", now - rd["enqueued_at"])
                    _queue_span(rd, now)
                    if rd["future"].cancelled():
                        logger.info("Future was cancelled before processing; skipping.")
                    elif "stream_queue" in rd:
                        streams.append(rd)
                    else:
                        live.append(rd)
                # /v1 requests never coalesce into a cycle: the batched path
                # truncates the /response way and returns text
                batchable = [rd for rd in live if can_batch and not rd.get("openai")]
                solo = [rd for rd in live if rd not in batchable]
                results: list[tuple] = []          # (request, response, error)
                if batchable:
                    try:
                        responses = await _truncate_and_generate_batch(batchable)
                        results = [(rd, None, r) if isinstance(r, Exception) else (rd, r, None)
                                   for rd, r in zip(batchable, responses)]
                    except Exception as e:  # noqa: BLE001 — one cycle, one failure
                        results = [(rd, None, e) for rd in batchable]
                for rd in solo:
                    try:
                        results.append((rd, await _truncate_and_generate(rd), None))
                    except Exception as e:  # noqa: BLE001 — handed to the waiter
                        results.append((rd, None, e))
                for rd, result, err in results:
                    if rd["future"].cancelled():
                        logger.info("Future cancelled during processing; %s dropped.",
                                    "error" if err else "result")
                    elif err is not None:
                        rd["future"].set_exception(err)
                    else:
                        rd["future"].set_result(result)
                for rd in streams:       # streams, serially, in their FIFO slot
                    try:
                        await _truncate_and_stream(rd, app.state.semaphore)
                    except Exception as e:  # noqa: BLE001 — surfaced on the stream
                        logger.error("Error during streamed generation: %s", e)
                        rd["stream_queue"].put_nowait(e)
            finally:
                for _ in batch:
                    queue.task_done()

    def _spawn(coro) -> asyncio.Task:
        """A fire-and-forget task, strongly held until it ends (the loop
        holds tasks weakly)."""
        task = asyncio.ensure_future(coro)
        app.state.bg_tasks.add(task)
        task.add_done_callback(app.state.bg_tasks.discard)
        return task

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
            spec = timings.get("spec")
            if spec:   # speculative decoding: acceptance is the payoff number
                m.inc("spec_drafted_tokens_total", spec["drafted"])
                m.inc("spec_accepted_tokens_total", spec["accepted"])
                m.inc("spec_verify_steps_total", spec["verify_steps"])
                m.inc("spec_fallback_steps_total", spec["fallback_steps"])
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

    def _is_registry() -> bool:
        return callable(getattr(app.state.engine, "has_model", None))

    def _model_kw(rd) -> dict:
        """``model=`` for a registry (its routing key); a single engine
        never sees it (the alias was checked at admission)."""
        return {"model": rd.get("model")} if _is_registry() else {}

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
                        messages=messages, stream=False, **_model_kw(rd),
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
            except DeadlineExceeded as e:
                m.inc("requests_timed_out_total")
                raise HTTPException(status_code=408, detail="Generation timed out") from e
            except Exception as e:  # noqa: BLE001 — the reference's 500
                m.inc("engine_errors_total")
                logger.error("Error during message generation: %s", e)
                raise HTTPException(
                    status_code=500,
                    detail=f"Error during message generation: {str(e)}") from e

    async def _truncate_and_generate_batch(rds):
        """One cycle of the ``MeshEngine`` over ``rds``: one entry a request,
        its text or its own exception (an entry's error fails it alone)."""
        m = app.state.metrics
        async with app.state.semaphore:
            try:
                batch_messages = [truncate_messages_to_fit_context(
                    rd["messages"], settings.max_context_tokens) for rd in rds]
                t0 = time.time()
                answers = await asyncio.to_thread(
                    lambda: app.state.engine.create_chat_completions(
                        batch_messages,
                        temperature=settings.temperature,
                        top_p=settings.top_p,
                        frequency_penalty=settings.frequency_penalty,
                        presence_penalty=settings.presence_penalty,
                        deadlines=[rd.get("deadline") for rd in rds],
                        aborts=[rd["future"].cancelled for rd in rds],
                        traces=[rd.get("trace") for rd in rds],
                    ))
                m.observe("generation_seconds", time.time() - t0, model=_model_label(
                    next((a for a in answers if isinstance(a, dict)), None)))
                m.inc("batched_generations_total")
                m.observe("batch_occupancy", len(batch_messages))
                _observe_engine_timings(m, next(
                    (a for a in answers if isinstance(a, dict) and "lfkt_timings" in a), None))
                out = []
                for answer in answers:
                    if isinstance(answer, dict) and "error" in answer:
                        out.append(HTTPException(
                            status_code=500,
                            detail="Error during message generation: "
                                   f"{answer['error'].get('message', 'unknown')}"))
                        continue
                    try:
                        out.append(_finish_answer({}, answer, m))
                    except HTTPException as e:
                        out.append(e)
                return out
            except EngineUnavailable as e:
                m.inc("engine_unavailable_total")
                logger.error("Engine unavailable: %s", e)
                raise HTTPException(status_code=503,
                                    detail=f"Engine unavailable: {e}") from e
            except Exception as e:  # noqa: BLE001 — the reference's 500
                m.inc("engine_errors_total")
                logger.error("Error during batched generation: %s", e)
                raise HTTPException(
                    status_code=500,
                    detail=f"Error during message generation: {str(e)}") from e

    async def _stream_task(rd):
        """Continuous mode: one stream through a scheduler lane, no global
        semaphore (the lanes bound concurrency); holds an in-flight permit."""
        try:
            await _truncate_and_stream(rd, None)
        except Exception as e:  # noqa: BLE001 — surfaced on the SSE channel
            logger.error("Error during streamed generation: %s", e)
            rd["stream_queue"].put_nowait(e)
        finally:
            app.state.inflight.release()

    async def _forward_to_scheduler(rd):
        """Continuous mode: one request → one scheduler lane, no barrier;
        holds an in-flight permit.  A cancelled client future (408 or a
        disconnect) abandons the request, so its lane frees at the next
        chunk boundary."""
        m = app.state.metrics
        try:
            try:
                messages = _messages(rd)
                t0 = time.time()
                engine = app.state.engine
                engine_fut = engine.submit(  # lfkt: transfers[engine_fut] -- the scheduler owns the lane: it resolves/reclaims the future via its _items registry even when a failure here skips the await
                    messages, **_gen_kwargs(rd), **_model_kw(rd),
                    deadline=rd["deadline"], trace=rd["trace"])
                rd["future"].add_done_callback(
                    lambda f: engine.abandon(engine_fut) if f.cancelled() else None)
                answer = await asyncio.wrap_future(engine_fut)
                m.observe("generation_seconds", time.time() - t0,
                          model=_model_label(answer))
                _observe_engine_timings(m, answer)
                result, err = _finish_answer(rd, answer, m), None
            except HTTPException as e:
                result, err = None, e
            except ValueError as e:
                if rd.get("openai"):
                    result, err = None, HTTPException(status_code=400, detail=str(e))
                else:
                    m.inc("engine_errors_total")
                    logger.error("Error during message generation: %s", e)
                    result, err = None, HTTPException(
                        status_code=500,
                        detail=f"Error during message generation: {str(e)}")
            except EngineUnavailable as e:
                m.inc("engine_unavailable_total")
                logger.error("Engine unavailable: %s", e)
                result, err = None, HTTPException(status_code=503,
                                                  detail=f"Engine unavailable: {e}")
            except DeadlineExceeded:
                m.inc("requests_timed_out_total")
                result, err = None, HTTPException(status_code=408,
                                                  detail="Generation timed out")
            except Exception as e:  # noqa: BLE001 — the reference's 500
                m.inc("engine_errors_total")
                logger.error("Error during message generation: %s", e)
                result, err = None, HTTPException(
                    status_code=500, detail=f"Error during message generation: {str(e)}")
            if rd["future"].cancelled():
                logger.info("Future cancelled during processing; result dropped.")
            elif err is not None:
                rd["future"].set_exception(err)
            else:
                rd["future"].set_result(result)
        finally:
            app.state.inflight.release()

    async def _truncate_and_stream(rd, semaphore):
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
                    messages=messages, stream=True, **_model_kw(rd),
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

        async def go():
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

        if semaphore is None:     # continuous mode: a lane, no serialization
            await go()
        else:
            async with semaphore:
                await go()

    @app.on_event("startup")
    async def startup_event():
        app.state.queue = asyncio.Queue(maxsize=settings.max_queue_size)
        app.state.semaphore = asyncio.Semaphore(1)
        # continuous mode: at most batch_size forwarded-but-unfinished
        # requests, so the bounded queue stays the back-pressure surface
        app.state.inflight = asyncio.Semaphore(max(1, settings.batch_size))
        app.state.bg_tasks = set()
        app.state.health.transition(STARTING, "model loading")
        if app.state.engine is None:
            factory = engine_factory or _default_engine_factory(settings)
            app.state.engine = await asyncio.to_thread(factory)
        engine = app.state.engine
        if hasattr(engine, "metrics_sink"):
            engine.metrics_sink = app.state.metrics
        # the incident bundles carry this app's health trail (weakly held;
        # a later app wins, which is the live one) and its fleet context,
        # read at capture time so it sees the migration manager built below
        def _replica_fleet_context(state=app.state):
            out = {"role": "replica", "self": settings.migrate_self or None}
            mig = getattr(state, "migration", None)
            if mig is not None:
                out["migration"] = mig.status()
            return out

        _flightrec.FLIGHTREC.install(health=app.state.health, engine=engine,
                                     fleet=_replica_fleet_context)
        # disaggregated prefill/decode: arm the page service and/or the
        # remote-prefill client; a misconfiguration (no paged pool, a
        # registry, a decode role without a peer) refuses startup loudly.
        # On a worker thread: a refusal stops the page service it started,
        # which joins its accept thread — never on the event loop
        if settings.disagg_role != "off":
            from ..serving import disagg

            app.state.disagg = await asyncio.to_thread(
                disagg.build_roles, settings.disagg_role, engine, settings,
                metrics=app.state.metrics, health=app.state.health)
        # warm-page migration: the page service and the pull client, then the
        # scale-out warm-up BEFORE the READY flip, bounded by the drain
        # budget (a cold or absent fleet delays readiness by at most that).
        # A pull writes the arena only; the rings the graphs hold are written
        # by a later hit's restore, in place.  No paged pool: refused loudly
        if settings.migrate:
            from ..serving.fleet.migrate import build_migration

            app.state.migration = await asyncio.to_thread(
                build_migration, engine, settings,
                metrics=app.state.metrics, health=app.state.health)
            await asyncio.to_thread(app.state.migration.warm_up)
        # with LFKT_PROFILE_DIR set, the profiler's one-time set-up (seconds
        # on the card) is paid here, before READY, and not inside the first
        # /debug/profile window; unset, no profiler is touched
        from ..utils.tracing import prepare_profiler

        await asyncio.to_thread(prepare_profiler)
        app.state.ready = True
        app.state.health.transition(READY, "engine loaded")
        if settings.watchdog and getattr(engine, "heartbeat", None) is None \
                and callable(getattr(engine, "models", None)):
            # the watchdog is single-engine (one heartbeat, one recovery);
            # a registry's per-engine failures surface as 503s instead
            logger.info("multi-model registry loaded: engine watchdog "
                        "gates off (single-engine contract — "
                        "docs/MULTIMODEL.md)")
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
        # SIGHUP re-reads LFKT_MODELS and converges the registry to it (the
        # twin of POST /admin/models/reload); only where the loop can take
        # signals (the main thread)
        if hasattr(signal, "SIGHUP"):
            try:
                asyncio.get_running_loop().add_signal_handler(
                    signal.SIGHUP, lambda: _spawn(_reload_from_env("SIGHUP")))
            except (NotImplementedError, RuntimeError, ValueError):
                pass

    @app.on_event("shutdown")
    async def shutdown_event():
        if app.state.watchdog is not None:
            # stop() joins the thread: off the event loop
            watchdog, app.state.watchdog = app.state.watchdog, None
            await asyncio.to_thread(watchdog.stop)
        if app.state.disagg is not None:
            disagg, app.state.disagg = app.state.disagg, None
            await asyncio.to_thread(disagg.close)
        if app.state.migration is not None:
            migration, app.state.migration = app.state.migration, None
            await asyncio.to_thread(migration.close)
        task = getattr(app.state, "consumer_task", None)
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    def _validate_model(model: str | None) -> str | None:
        """400 (OpenAI code ``model_not_found``) for a model alias this pod
        does not serve: the registry's live aliases, or the one engine's
        name."""
        if model is None:
            return None
        eng = app.state.engine
        if _is_registry():
            if not eng.has_model(model):
                e = HTTPException(
                    status_code=400,
                    detail=f"unknown model {model!r}; this pod serves: "
                           f"{', '.join(eng.model_names())}")
                e.openai_code = "model_not_found"
                raise e
            return model
        name = getattr(eng, "model_name", None)
        if name is not None and model != name:
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

    async def _migrate_hook(request: Request, messages: list[dict],
                            raw: bool = False) -> None:
        """Pull-on-remap (serving/fleet/migrate.py): when the fleet router
        stamped this request, record the conversation's affinity key (the
        drain's candidates) and — if a prior owner is named — pull its radix
        pages over the page wire BEFORE the prefill that would recompute
        them.  Never raises and never blocks past the hop budget: a failed
        pull is an attributed degrade to a colder, correct local prefill."""
        mgr = app.state.migration
        if mgr is None:
            return
        headers = request.headers
        key = headers.get(AFFINITY_KEY_HEADER, "")
        prior = headers.get(PRIOR_OWNER_HEADER, "")
        if not key and not prior:
            return
        engine = app.state.engine
        tokenize = getattr(engine, "tokenize_messages", None)
        if tokenize is None:
            return
        try:
            # the prompt the engine will see: the reference's truncation
            # mutates in place, so it runs on copies
            msgs = messages if raw else truncate_messages_to_fit_context(
                [dict(m) for m in messages], settings.max_context_tokens)
            ids = await asyncio.to_thread(tokenize, msgs)
        except Exception:  # noqa: BLE001 — a tokenizer quirk must not fail
            # admission; the request just prefills cold
            return
        ns = str(getattr(engine, "_kv_ns", "") or "")
        if key:
            mgr.record_prompt(key, ns, ids)
        if prior:
            await asyncio.to_thread(
                mgr.pull_for_request, prior, ns, ids,
                time.time() + settings.timeout_seconds,
                request.scope.get("lfkt.trace"))

    async def _admit(request_body: BotMessageRequest, request: Request,
                     extra: dict | None = None) -> dict:
        """Admission of both /response routes: the messages with the system
        prompt at index 1, the model alias checked, a router-stamped prior
        owner's pages pulled, enqueued."""
        model = _validate_model(request_body.model)
        messages = [{"role": m.turn, "content": m.message}
                    for m in request_body.context]
        messages.insert(1, {"role": "system",
                            "content": build_system_prompt(request_body.bot_profile)})
        await _migrate_hook(request, messages)
        return _enqueue_rd(request, messages, extra, model=model)

    @app.post("/response")
    async def generate_response(request_body: BotMessageRequest, request: Request):
        m = app.state.metrics
        future = (await _admit(request_body, request))["future"]
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
        rd = await _admit(request_body, request, extra={"stream_queue": asyncio.Queue()})
        return _sse(rd, lambda status, msg: {"error": msg})

    @app.get("/v1/models")
    async def v1_models():
        """The served models, OpenAI list-shaped: one row per routable
        registry alias (rows still loading or draining are /health's), or
        the one engine's name."""
        eng = app.state.engine
        models_fn = getattr(eng, "models", None)
        if callable(models_fn):
            names = [r["name"] for r in models_fn()
                     if r.get("state") in (None, "ready", "loaded")]
        else:
            names = [getattr(eng, "model_name", None) or settings.model_name]
        return {"object": "list",
                "data": [{"id": n, "object": "model",
                          "created": app.state.created, "owned_by": "lfkt"}
                         for n in names]}

    # -- live manifest reload (serving/registry.py) ---------------------------
    async def _do_reload(manifest: str, default: str) -> dict:
        """One registry reload on a worker thread: loads and warmups take
        seconds to minutes while the live models keep serving."""
        reload_fn = getattr(app.state.engine, "reload_manifest", None)
        if not callable(reload_fn):
            raise HTTPException(
                status_code=400,
                detail="live reload requires manifest serving: this pod "
                       "runs a single engine (set LFKT_MODELS — "
                       "docs/MULTIMODEL.md)")
        if not manifest:
            raise HTTPException(
                status_code=400,
                detail="no manifest: pass {\"models\": \"name=path,...\"} "
                       "or set LFKT_MODELS on the pod")
        return await asyncio.to_thread(
            reload_fn, manifest, default,
            drain_seconds=settings.reload_drain_seconds)

    async def _reload_from_env(origin: str) -> None:
        """The SIGHUP path: the env is read at signal time, so editing the
        pod's LFKT_MODELS and then sending SIGHUP converges the registry."""
        live = get_settings()
        async with app.state.reload_busy:
            try:
                doc = await _do_reload(live.models, live.default_model)
                logger.info("%s reload: added=%s removed=%s default=%s",
                            origin, sanitize_text(str(doc["added"])),
                            sanitize_text(str([r["name"] for r in doc["removed"]])),
                            sanitize_text(doc["default_model"]))
            except HTTPException as e:
                logger.error("%s reload refused: %s", origin, e.detail)
            except Exception as e:  # noqa: BLE001 — loud, never fatal
                logger.error("%s reload failed: %s", origin, e)

    @app.post("/admin/models/reload")
    async def admin_models_reload(request: Request):
        """Converge the running registry to a new ``LFKT_MODELS`` manifest
        live: additions load under the fit check and the weight budget (409
        on a refusal, the running set untouched), removals drain their
        in-flight requests and radix namespace before their engine is
        released.  Body (all optional): ``models`` (default: the pod's
        LFKT_MODELS, re-read) and ``default_model``.  409 while another
        reload runs."""
        from ..serving import WeightBudgetError

        try:
            body = await request.json()
        except ValueError:
            raise HTTPException(status_code=400, detail="body must be JSON")
        body = body if isinstance(body, dict) else {}
        live = get_settings()
        manifest = body.get("models") or live.models
        default = body.get("default_model") or live.default_model
        if app.state.reload_busy.locked():
            raise HTTPException(
                status_code=409,
                detail="a reload is already in progress; retry after it "
                       "completes (/health models rows show the "
                       "transition)")
        async with app.state.reload_busy:
            try:
                return await _do_reload(manifest, default)
            except WeightBudgetError as e:
                raise HTTPException(status_code=409, detail=str(e))
            except ValueError as e:
                raise HTTPException(status_code=400, detail=str(e))

    def _migration_or_404():
        mgr = app.state.migration
        if mgr is None:
            raise HTTPException(
                status_code=404,
                detail="KV migration is off on this pod (LFKT_MIGRATE=1 "
                       "arms it — docs/RUNBOOK.md 'Surviving pod churn')")
        return mgr

    @app.get("/admin/migrate/hot")
    async def admin_migrate_hot(request: Request):
        """This pod's hottest cached prefixes (``KVPool.hot_prefixes``) —
        what a scale-out peer pre-pulls in its warm-up.  ``?k=N`` bounds the
        list (default ``LFKT_MIGRATE_TOP_K``); 404 with migration off."""
        mgr = _migration_or_404()
        from urllib.parse import parse_qs

        q = parse_qs(request.url.query)
        try:
            k = int(q.get("k", [mgr.top_k])[0])
        except ValueError:
            raise HTTPException(status_code=400, detail="k must be an int")
        pool = getattr(app.state.engine, "_kvpool", None)
        rows = (await asyncio.to_thread(pool.hot_prefixes, k)
                if pool is not None else [])
        return {"prefixes": rows}

    @app.post("/admin/migrate/pull")
    async def admin_migrate_pull(request: Request):
        """Commanded pull — the receiving half of a peer's SIGTERM drain
        (``MigrationManager.drain_push``): the draining pod names its page
        service (``peer``) and the conversation (``namespace``, ``ids``);
        this pod pulls the pages while the peer lives.  Deadline-bounded; a
        failed pull answers ``covered: 0`` with the degrade attributed in
        this pod's counters.  404 with migration off."""
        mgr = _migration_or_404()
        try:
            body = await request.json()
        except ValueError:
            raise HTTPException(status_code=400, detail="body must be JSON")
        body = body if isinstance(body, dict) else {}
        peer = str(body.get("peer") or "")
        ids = body.get("ids")
        if ":" not in peer or not isinstance(ids, list) or not ids:
            raise HTTPException(
                status_code=400,
                detail="body needs peer (host:port of the drain side's "
                       "page service) and ids (non-empty token list)")
        deadline = body.get("deadline")
        covered = await asyncio.to_thread(
            mgr.pull, peer, [int(t) for t in ids],
            namespace=str(body.get("namespace") or ""), reason="drain",
            deadline=float(deadline) if deadline is not None else None)
        return {"covered": covered}

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
            await _migrate_hook(request, messages, raw=True)
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
        # the paged pool's occupancy and counters (LFKT_KV_PAGED), beside
        # kv_cache_bytes
        occ = getattr(eng, "kv_pool_occupancy", None)
        if callable(occ):
            engine_info["kv_pool"] = occ()
        # a registry: one row per model (name, quant, weight bytes, load
        # state) and the default alias
        models_fn = getattr(eng, "models", None)
        if callable(models_fn):
            engine_info["models"] = models_fn()
            engine_info["default_model"] = getattr(eng, "default_model", None)
        # spec_decode="auto": the measured decision and its inputs
        if getattr(eng, "spec_auto_decision", None) is not None:
            engine_info["spec_auto"] = eng.spec_auto_decision
        doc = {
            "status": "ok",
            "state": st.health.state,
            "model_loaded": eng is not None,
            "queue_depth": st.queue.qsize() if hasattr(st, "queue") else None,
            "max_queue_size": settings.max_queue_size,
            "engine": engine_info,
            "resilience": _resilience_info(),
        }
        # the disagg tier: the role, the page service's counters and, on the
        # decode side, the peer and why its pages stopped coming
        if st.disagg is not None:
            doc["disagg"] = st.disagg.status()
        # warm-page migration: the page service's wire address (peers find
        # it here — an ephemeral port is discovery, not configuration), the
        # pull and push counters and the last attributed degrade; absent
        # with LFKT_MIGRATE off
        if st.migration is not None:
            doc["migration"] = st.migration.status()
        return doc

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
        models_fn = getattr(eng, "models", None)
        if callable(models_fn):
            rows = models_fn()
            m.set_gauge("models_loaded", len(rows))
            for r in rows:
                m.set_gauge("model_weight_bytes", r["weight_bytes"], model=r["name"])
        elif eng is not None:
            m.set_gauge("models_loaded", 1)
            wb = getattr(eng, "weight_bytes", 0)
            if wb:
                m.set_gauge("model_weight_bytes", wb, model=_model_label())
        # the paged pool's gauges (its event counters are incremented at
        # event time by the pool through the engine's metrics sink)
        occ = getattr(eng, "kv_pool_occupancy", None)
        pool = occ() if callable(occ) else None
        if pool is not None:
            m.set_gauge("kv_pool_pages_used", pool["pages_used"])
            m.set_gauge("kv_pool_pages_free", pool["pages_free"])
        stats = getattr(eng, "scheduler_stats", None)
        if stats is not None:
            snap = stats()
            for k, v in snap.items():
                m.set_gauge(f"scheduler_{k}", v)
            # the admission controller's live budget and the idle
            # lane-seconds, promoted out of the scheduler_ family
            if "adm_budget_tokens" in snap:
                m.set_gauge("admission_budget_tokens", snap["adm_budget_tokens"])
            if "lane_idle_seconds" in snap:
                m.set_gauge("lane_idle_seconds", snap["lane_idle_seconds"])
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
        # the page wire's liveness (its event counters are incremented at
        # event time through the roles' sink)
        dis = app.state.disagg
        if dis is not None and dis.client is not None:
            m.set_gauge("disagg_peer_connected", 1.0 if dis.client.connected() else 0.0)
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
        device's ground truth, and headroom — and, when the paged pool
        serves, its occupancy and the arena's fragmentation (the largest
        run of consecutive free pages against the free count)."""
        doc = _memledger.MEMLEDGER.snapshot()
        occ = getattr(app.state.engine, "kv_pool_occupancy", None)
        pool = occ() if callable(occ) else None
        if pool is not None and doc.get("armed"):
            free = pool.get("pages_free")
            run = pool.get("largest_free_run")
            doc["kv_pool"] = pool
            if free and run is not None:
                doc["fragmentation"] = {
                    "pages_free": free,
                    "largest_free_run": run,
                    # 0 = one contiguous run; toward 1 = shattered
                    "ratio": round(1.0 - run / free, 4),
                }
        return doc

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


def _base_engine_kwargs(settings: Settings, device: str | None = None) -> dict:
    """The engine knobs every model of the pod shares, on ``device`` (None:
    the card)."""
    return dict(
        device=device,
        n_ctx=settings.max_context_tokens,
        weight_format=settings.weight_format,
        decode_chunk=settings.decode_chunk,
        prefill_buckets=settings.prefill_bucket_list,
        max_gen_tokens=settings.max_gen_tokens,
        attn_impl=settings.attn_impl,
        kv_dtype=settings.kv_dtype,
        decode_layer_unroll=settings.decode_layer_unroll,
        spec_decode=settings.spec_decode,
        spec_draft=settings.spec_draft,
        prefix_cache=settings.prefix_cache,
        prefill_chunk=settings.prefill_chunk,
        kv_paged=settings.kv_paged,
        kv_page_tokens=settings.kv_page_tokens,
        kv_pool_pages=settings.kv_pool_pages,
        kv_spill_pages=settings.kv_spill_pages,
    )


def _serving_engine(settings: Settings, path: str | None, **kw):
    """The engine one model serves from, by the pod's shape: ``SPEngine``
    under ``LFKT_MESH_SP`` > 1 (``LFKT_MESH_TP`` shards heads inside its
    ring), the lane engines under ``LFKT_BATCH_SIZE`` > 1 (``LFKT_MESH_TP``
    their tensor parallelism; the scheduler picks the flavour), else the
    serial ``Engine`` — the JAX package's choice.  A mesh takes the pod's
    cards, and a pod with fewer than it needs raises."""
    from ..engine import ContinuousEngine, Engine, MeshEngine, SPEngine

    if settings.mesh_sp > 1:
        # long context: n_ctx sharded over the sp ring
        if settings.batch_size > 1:
            raise ValueError(
                "LFKT_MESH_SP > 1 serves sequence-parallel (serial); "
                "set LFKT_BATCH_SIZE=1 or use dp/tp batching instead")
        return SPEngine(path, sp=settings.mesh_sp, tp=settings.mesh_tp, **kw)
    if settings.batch_size > 1:
        if settings.scheduler == "continuous":
            return ContinuousEngine(
                path, tp=settings.mesh_tp, batch_size=settings.batch_size,
                adm_budget=settings.adm_budget,
                adm_controller=settings.adm_controller,
                adm_ema_alpha=settings.adm_ema_alpha,
                lane_prefix_cache=settings.lane_prefix_cache, **kw)
        return MeshEngine(path, tp=settings.mesh_tp, batch_size=settings.batch_size, **kw)
    return Engine(path, **kw)


def _registry_factory(settings: Settings, device: str | None = None):
    """``LFKT_MODELS`` is set: load the manifest into a ModelRegistry
    (serving/registry.py) — N engines on one card sharing the paged KV
    arena (a namespace a model) under an explicit weight budget, all with
    the same scheduler shape (the process-wide knobs; a model overrides
    only the whitelisted engine knobs, serving/manifest.py).  ``device``
    is every engine's (None: the card), live reloads' too."""
    from ..serving import ModelRegistry, parse_manifest, pick_default

    specs = parse_manifest(settings.models)
    default = pick_default(specs, settings.default_model)
    if settings.mesh_sp > 1 and settings.batch_size > 1:
        raise ValueError(
            "LFKT_MESH_SP > 1 serves sequence-parallel (serial); "
            "set LFKT_BATCH_SIZE=1 or use dp/tp batching instead")
    if len(specs) > 1 and settings.mesh_sp > 1:
        raise ValueError(
            "LFKT_MESH_SP > 1 gates off multi-model serving: the "
            "sp-sharded ring serves one model per mesh (run one model "
            "per pod, or drop to mesh_sp=1)")
    if len(specs) > 1 and settings.batch_size > 1 \
            and settings.scheduler != "continuous":
        raise ValueError(
            "LFKT_SCHEDULER=cycle gates off multi-model serving: a "
            "mesh-batched cycle coalesces its whole batch into ONE "
            "shared device program, which cannot interleave models — "
            "use the continuous scheduler (docs/MULTIMODEL.md)")

    def build(spec, path, shared_pool):
        # a one-entry manifest serves the engine the single-model factory
        # builds (a migration to LFKT_MODELS never swaps schedulers)
        kw = _base_engine_kwargs(settings, device)
        kw.update(spec.overrides)
        kw["kv_pool"] = shared_pool
        kw["kv_namespace"] = spec.name
        return _serving_engine(settings, path, **kw)

    reg = ModelRegistry.from_specs(
        specs, build, default_model=default, model_dir=settings.model_dir,
        weight_budget_bytes=int(settings.hbm_weight_budget_mb * 1e6))
    reg.warmup()
    return reg


def _default_engine_factory(settings: Settings, device: str | None = None):
    """The server's engine loader: the registry under ``LFKT_MODELS``, else
    the pod's one engine, warmed up, on ``device`` (None: the card; the
    drills' CPU replicas pass ``cpu``)."""
    def factory():
        if settings.scheduler not in ("continuous", "cycle"):
            raise ValueError(
                f"LFKT_SCHEDULER must be 'continuous' or 'cycle', "
                f"got {settings.scheduler!r}")
        if settings.models:
            # the manifest's registry replaces the single engine
            return _registry_factory(settings, device)
        eng = _serving_engine(settings, settings.model_path,
                              **_base_engine_kwargs(settings, device))
        eng.warmup()
        return eng
    return factory

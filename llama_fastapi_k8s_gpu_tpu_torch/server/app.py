"""The serving layer: ``POST /response`` over the serial engine.

The reference's externally observable behaviour, as the JAX package's
server keeps it (llama_fastapi_k8s_gpu_tpu/server/app.py):

- ``POST /response`` with the same schema, the same system-prompt assembly
  quirks (inserted at index 1, the ``.f`` name-suffix gender clause, the
  appearance facts after the third comma), the same truncation (400-char
  clip, chars/4 estimate, pop-index-2 loop) and the same admission
  control: a bounded queue(5) → 503, one consumer and a semaphore(1) →
  strictly serial generation, a 25 s future timeout → 408 with
  cancellation, engine errors → 500;
- ``GET /items/{item_id}``, the vestigial echo route;
- the request-timing log line;
- ``GET /health`` (model, device and queue state) and the split k8s probes
  ``/health/ready`` and ``/health/live``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from datetime import datetime

from ..utils.config import Settings, get_settings
from ..utils.health import READY, STARTING, HealthMonitor
from .asgikit import HTTPException, JSONResponse, MicroAPI, Request
from .schemas import BotMessageRequest

logger = logging.getLogger(__name__)


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
               engine_factory=None) -> MicroAPI:
    """Build the app.  ``engine`` (or ``engine_factory``, called at startup)
    must provide ``create_chat_completion``; the default factory loads the
    GGUF named by the settings onto the GPU and warms it up."""
    settings = settings or get_settings()
    app = MicroAPI(title="chat-ai (gpu)", version="0.1.0")
    app.state.settings = settings
    app.state.engine = engine
    app.state.ready = engine is not None
    app.state.health = HealthMonitor()

    async def consumer():
        """Single drain task: strict FIFO, one generation at a time."""
        queue = app.state.queue
        while True:
            rd = await queue.get()
            try:
                if rd["future"].cancelled():
                    logger.info("Future was cancelled before processing; skipping.")
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

    async def _truncate_and_generate(rd) -> str:
        async with app.state.semaphore:  # one generation at a time
            try:
                messages = truncate_messages_to_fit_context(
                    rd["messages"], settings.max_context_tokens)
                answer = await asyncio.to_thread(
                    lambda: app.state.engine.create_chat_completion(
                        messages=messages,
                        stream=False,
                        temperature=settings.temperature,
                        top_p=settings.top_p,
                        frequency_penalty=settings.frequency_penalty,
                        presence_penalty=settings.presence_penalty,
                        deadline=rd["deadline"],
                        abort=rd["future"].cancelled,
                    ))
            except Exception as e:  # noqa: BLE001 — the reference's 500
                logger.error("Error during message generation: %s", e)
                raise HTTPException(
                    status_code=500,
                    detail=f"Error during message generation: {str(e)}") from e
        if not isinstance(answer, dict):
            logger.error("Unexpected response type: %s. Response: %s",
                         type(answer), answer)
            raise HTTPException(status_code=500,
                                detail="Unexpected response from model")
        return "".join(c["message"]["content"]
                       for c in answer.get("choices", []) if "message" in c)

    @app.on_event("startup")
    async def startup_event():
        app.state.queue = asyncio.Queue(maxsize=settings.max_queue_size)
        app.state.semaphore = asyncio.Semaphore(1)
        app.state.health.transition(STARTING, "model loading")
        if app.state.engine is None:
            factory = engine_factory or _default_engine_factory(settings)
            app.state.engine = await asyncio.to_thread(factory)
        app.state.ready = True
        app.state.health.transition(READY, "engine loaded")
        app.state.consumer_task = asyncio.create_task(consumer())

    @app.on_event("shutdown")
    async def shutdown_event():
        task = getattr(app.state, "consumer_task", None)
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    def _validate_model(model: str | None) -> None:
        """400 for a model alias this pod does not serve."""
        name = getattr(app.state.engine, "model_name", None)
        if model is not None and name is not None and model != name:
            raise HTTPException(
                status_code=400,
                detail=f"unknown model {model!r}; this pod serves: {name}")

    def _enqueue(messages: list[dict]) -> dict:
        """Enqueue ``messages`` with a future; 503 on overflow."""
        now = time.time()
        rd = {
            "messages": messages,
            "future": asyncio.get_running_loop().create_future(),
            "enqueued_at": now,
            # the admission timeout becomes the engine's deadline, so a
            # timed-out request frees the device within one decode chunk
            "deadline": now + settings.timeout_seconds,
        }
        try:
            app.state.queue.put_nowait(rd)
        except asyncio.QueueFull:
            raise HTTPException(status_code=503,
                                detail="Server too busy. Please try again later.")
        return rd

    @app.post("/response")
    async def generate_response(request_body: BotMessageRequest, request: Request):
        _validate_model(request_body.model)
        messages = [{"role": m.turn, "content": m.message}
                    for m in request_body.context]
        messages.insert(1, {"role": "system",
                            "content": build_system_prompt(request_body.bot_profile)})
        future = _enqueue(messages)["future"]
        try:
            response = await asyncio.wait_for(future, timeout=settings.timeout_seconds)
            return {"response": response}
        except asyncio.TimeoutError:
            logger.warning("Generation timed out")
            future.cancel()
            raise HTTPException(status_code=408, detail="Generation timed out")
        except HTTPException:
            raise
        except Exception as e:  # noqa: BLE001 — the reference's 500
            logger.error("Internal server error: %s", e)
            raise HTTPException(status_code=500,
                                detail=f"Internal server error: {str(e)}")

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
        """Liveness probe: the process answers, so it is alive."""
        snap = app.state.health.snapshot()
        return JSONResponse({"alive": True, "state": snap["state"],
                             "reason": snap["reason"]}, 200)

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
            "resilience": {"health": st.health.snapshot()},
        }

    @app.get("/items/{item_id}")
    async def read_item(item_id: int):
        # vestigial echo route kept for parity with the reference's surface
        return {"item_id": item_id}

    @app.middleware("http")
    async def log_request_time(request: Request, call_next):
        start_time = time.time()
        response = await call_next(request)
        logger.info("Request at %s: %s %s completed in %.4fs",
                    datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                    request.method, request.url, time.time() - start_time)
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

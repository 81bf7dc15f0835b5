"""The port's server against the JAX package's, driven in-process through
raw ASGI calls.

At ``LFKT_TEMPERATURE=0`` both apps, each over its own engine on the same
tiny GGUF, answer ``/response`` with identical bytes — a first turn and a
follow-up that takes prefix reuse, on an F16 file and on the JAX package's
default tiny file (Q8_0), there also over the int8 KV cache and, with the
layer-looped decode armed, over int8 and bf16 weights.  Errors (422
bodies, the 400 for an unknown model, 404/405, 500 from the engine) and
``/items`` match byte for byte; ``/health`` carries the reference's keys
for what the slice serves.
Admission (queue(5) → 503, timeout → 408) runs over a slow fake engine.
"""

from __future__ import annotations

import asyncio
import json
import time

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu.utils.config import get_settings as j_get_settings
from llama_fastapi_k8s_gpu_tpu_torch import engine as engine_pkg
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.server.app import _default_engine_factory, create_app
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings, get_settings

torch.set_num_threads(1)

BODY = {
    "bot_profile": {"name": "Alice.f", "appearance": "tall,slim,blonde,loves cats,hates rain"},
    "user_profile": {"name": "Bob"},
    "context": [
        {"turn": "user", "message": "hi"},
        {"turn": "assistant", "message": "hey"},
        {"turn": "user", "message": "how are you?"},
    ],
}


async def call(app, method: str, path: str, body=None, raw: bytes | None = None):
    """One HTTP request through the ASGI interface → (status, body bytes)."""
    data = raw if raw is not None else (b"" if body is None else json.dumps(body).encode())
    inbox = [{"type": "http.request", "body": data, "more_body": False}]
    sent = []

    async def receive():
        return inbox.pop(0) if inbox else {"type": "http.disconnect"}

    async def send(message):
        sent.append(message)

    scope = {"type": "http", "method": method, "path": path, "query_string": b"",
             "headers": [(b"host", b"test"), (b"content-type", b"application/json")]}
    await app(scope, receive, send)
    return sent[0]["status"], b"".join(m.get("body", b"") for m in sent[1:])


async def both(apps, method, path, body=None, raw=None):
    return [await call(a, method, path, body, raw) for a in apps]


def serve(apps, fn):
    """Run ``fn(apps)`` between the apps' startup and shutdown hooks."""
    async def main():
        for a in apps:
            await a.router.startup()
        try:
            return await fn(apps)
        finally:
            for a in apps:
                await a.router.shutdown()
    return asyncio.run(main())


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "tiny.gguf")
    write_tiny_llama_gguf(path, quant=JGGMLType.F16)
    # 16 tokens a turn: at the follow-up's 20th greedy step the two runs
    # part on a tie — two tokens whose bf16 logits differ by less than one
    # bf16 step (ROADMAP.md, queue C)
    return (JEngine(path, n_ctx=1024, max_gen_tokens=16),
            Engine(path, n_ctx=1024, max_gen_tokens=16, device="cpu"))


def _apps(engines, **kw):
    je, te = engines
    return [j_create_app(engine=je, settings=JSettings(temperature=0.0, **kw)),
            create_app(engine=te, settings=Settings(temperature=0.0, **kw))]


def test_response_bytes_identical_with_prefix_reuse(engines):
    follow = {**BODY, "context": BODY["context"] + [
        {"turn": "assistant", "message": "fine"},
        {"turn": "user", "message": "tell me about cats, please"}]}

    async def go(apps):
        first = await both(apps, "POST", "/response", BODY)
        second = await both(apps, "POST", "/response", follow)
        return first, second

    first, second = serve(_apps(engines), go)
    for ref, got in (first, second):
        assert ref[0] == got[0] == 200
        assert got[1] == ref[1]
        assert json.loads(got[1])["response"]
    assert engines[1].last_timings["prefix_reused_tokens"] > 0
    assert engines[1].last_timings["prefix_reused_tokens"] == \
        engines[0].last_timings["prefix_reused_tokens"]


@pytest.fixture(scope="module")
def q8_path(tmp_path_factory):
    """The JAX package's default tiny file: every linear in Q8_0."""
    path = str(tmp_path_factory.mktemp("srv8") / "tiny-q8_0.gguf")
    write_tiny_llama_gguf(path)
    return path


def test_default_tiny_q8_0_file_response_bytes_identical(q8_path):
    """Both engines load the Q8_0 file in their CPU default (bf16 from the
    codecs) and answer with the same bytes; the port's fused format serves
    every linear of it through the Q8_0 matmul, as ``/health`` reports."""
    engines = (JEngine(q8_path, n_ctx=1024, max_gen_tokens=16),
               Engine(q8_path, n_ctx=1024, max_gen_tokens=16, device="cpu"))
    fused = Engine(q8_path, n_ctx=1024, max_gen_tokens=16, weight_format="q4k",
                   device="cpu")

    async def go(apps):
        return (await both(apps[:2], "POST", "/response", BODY),
                await call(apps[2], "GET", "/health"),
                await call(apps[2], "POST", "/response", BODY))

    apps = _apps(engines) + [create_app(engine=fused, settings=Settings(temperature=0.0))]
    (ref, got), health, answer = serve(apps, go)
    assert ref[0] == got[0] == 200
    assert got[1] == ref[1]
    assert json.loads(got[1])["response"]
    formats = json.loads(health[1])["engine"]["weight_formats"]
    assert formats == {**dict.fromkeys(("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                        "w_down"), "q8"), "output": "bf16"}
    assert answer[0] == 200 and json.loads(answer[1])["response"]


def test_int8_kv_response_bytes_identical_and_health(q8_path):
    """``kv_dtype="int8"`` on both engines: a first turn and a follow-up
    that takes prefix reuse over the int8 ring answer with the same bytes,
    and ``/health`` reports the int8 ring and its bytes as the reference
    does."""
    engines = (JEngine(q8_path, n_ctx=1024, max_gen_tokens=16, kv_dtype="int8"),
               Engine(q8_path, n_ctx=1024, max_gen_tokens=16, kv_dtype="int8",
                      device="cpu"))
    follow = {**BODY, "context": BODY["context"] + [
        {"turn": "assistant", "message": "fine"},
        {"turn": "user", "message": "tell me about cats, please"}]}

    async def go(apps):
        return (await both(apps, "POST", "/response", BODY),
                await both(apps, "POST", "/response", follow),
                await both(apps, "GET", "/health"))

    first, second, health = serve(_apps(engines), go)
    for ref, got in (first, second):
        assert ref[0] == got[0] == 200
        assert got[1] == ref[1]
        assert json.loads(got[1])["response"]
    assert engines[1].last_timings["prefix_reused_tokens"] > 0
    assert engines[1].last_timings["prefix_reused_tokens"] == \
        engines[0].last_timings["prefix_reused_tokens"]
    ref, got = (json.loads(b)["engine"] for _, b in health)
    assert got["kv_dtype"] == ref["kv_dtype"] == "int8"
    assert got["kv_cache_bytes"] == ref["kv_cache_bytes"] == engines[1].kv_cache_bytes
    assert engines[1].kv_cache_bytes < Engine(q8_path, n_ctx=1024,
                                              device="cpu").kv_cache_bytes


def test_lfkt_kv_dtype_reaches_the_engine(monkeypatch):
    """``LFKT_KV_DTYPE`` is read as the reference reads it and the default
    engine factory hands it to the engine; an unknown value raises there
    before the model file is looked at."""
    seen = {}

    class Recorder:
        def __init__(self, path, **kw):
            seen.update(kw)

        def warmup(self):
            pass

    assert get_settings().kv_dtype == j_get_settings().kv_dtype == "bf16"
    monkeypatch.setenv("LFKT_KV_DTYPE", "int8")
    assert get_settings().kv_dtype == j_get_settings().kv_dtype == "int8"
    with monkeypatch.context() as m:
        m.setattr(engine_pkg, "Engine", Recorder)
        _default_engine_factory(get_settings())()
    assert seen["kv_dtype"] == "int8"
    monkeypatch.setenv("LFKT_KV_DTYPE", "fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        _default_engine_factory(get_settings())()


@pytest.mark.parametrize("weight_format,kv_dtype,unroll", [
    ("int8", "bf16", -1),     # one looped launch a token
    ("bf16", "int8", 2),
])
def test_looped_decode_response_bytes_identical_and_health(q8_path, weight_format,
                                                           kv_dtype, unroll):
    """Both engines with ``decode_layer_unroll`` armed over the same weight
    format and KV dtype answer with the same bytes; ``/health`` reports the
    effective unroll (the 2-layer file: 2 for both) and the int8 formats."""
    kw = dict(n_ctx=1024, max_gen_tokens=16, weight_format=weight_format,
              kv_dtype=kv_dtype, decode_layer_unroll=unroll)
    engines = (JEngine(q8_path, **kw), Engine(q8_path, device="cpu", **kw))

    async def go(apps):
        return (await both(apps, "POST", "/response", BODY),
                await both(apps, "GET", "/health"))

    (ref, got), health = serve(_apps(engines), go)
    assert ref[0] == got[0] == 200
    assert got[1] == ref[1]
    assert json.loads(got[1])["response"]
    ref_h, got_h = (json.loads(b)["engine"] for _, b in health)
    assert got_h["decode_layer_unroll"] == ref_h["decode_layer_unroll"] == 2
    assert got_h["weight_formats"] == dict.fromkeys(
        ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "output"), weight_format)
    for name, kind in ref_h["weight_formats"].items():
        assert got_h["weight_formats"][name] == kind == weight_format


def test_health_reports_no_unroll_after_a_plan_refusal(q8_path):
    """Fused weights refuse the looped kernel: the engine serves per-layer
    decode and ``/health`` says 0."""
    eng = Engine(q8_path, n_ctx=1024, max_gen_tokens=4, weight_format="q4k",
                 decode_layer_unroll=-1, device="cpu")
    assert eng.cfg.decode_layer_unroll == 0

    async def go(apps):
        return await call(apps[0], "GET", "/health")

    status, body = serve([create_app(engine=eng, settings=Settings(temperature=0.0))], go)
    assert status == 200 and json.loads(body)["engine"]["decode_layer_unroll"] == 0


def test_lfkt_decode_layer_unroll_and_weight_format_reach_the_engine(monkeypatch):
    """``LFKT_DECODE_LAYER_UNROLL`` and ``LFKT_WEIGHT_FORMAT=int8`` are read
    as the reference reads them and reach the engine; an unroll below -1
    raises there before the model file is looked at."""
    seen = {}

    class Recorder:
        def __init__(self, path, **kw):
            seen.update(kw)

        def warmup(self):
            pass

    assert get_settings().decode_layer_unroll == j_get_settings().decode_layer_unroll == 0
    monkeypatch.setenv("LFKT_DECODE_LAYER_UNROLL", "-1")
    monkeypatch.setenv("LFKT_WEIGHT_FORMAT", "int8")
    assert get_settings().decode_layer_unroll == j_get_settings().decode_layer_unroll == -1
    assert get_settings().weight_format == j_get_settings().weight_format == "int8"
    with monkeypatch.context() as m:
        m.setattr(engine_pkg, "Engine", Recorder)
        _default_engine_factory(get_settings())()
    assert seen["decode_layer_unroll"] == -1 and seen["weight_format"] == "int8"
    monkeypatch.setenv("LFKT_DECODE_LAYER_UNROLL", "-2")
    with pytest.raises(ValueError, match="decode_layer_unroll"):
        _default_engine_factory(get_settings())()


BAD_BODIES = [
    None,
    {},
    {**BODY, "bot_profile": 3, "context": {"a": 1}},
    {**BODY, "context": [{"turn": "user", "message": 5}, 7, {"turn": None}]},
    {**BODY, "bot_profile": {"name": 1.5, "appearance": True, "system_prompt": 5},
     "user_profile": [], "model": 3},
]


def test_errors_and_items_bytes_identical(engines):
    async def go(apps):
        out = [await both(apps, "POST", "/response", b) for b in BAD_BODIES]
        out.append(await both(apps, "POST", "/response", raw=b"{not json"))
        out.append(await both(apps, "POST", "/response", {**BODY, "model": "other"}))
        for path in ("/items/7", "/items/x", "/nope"):
            out.append(await both(apps, "GET", path))
        out.append(await both(apps, "GET", "/response"))
        out.append(await both(apps, "GET", "/health/ready"))
        return out

    for ref, got in serve(_apps(engines), go):
        assert got == ref


def test_health_document(engines):
    async def go(apps):
        return await both(apps, "GET", "/health"), await both(apps, "GET", "/health/live")

    (ref, got), (ref_live, got_live) = serve(_apps(engines), go)
    assert ref[0] == got[0] == 200 and ref_live[0] == got_live[0] == 200
    ref, got = json.loads(ref[1]), json.loads(got[1])
    assert set(got) <= set(ref)
    for k in ("status", "state", "model_loaded", "queue_depth", "max_queue_size"):
        assert got[k] == ref[k]
    for k in ("model", "n_ctx", "attn_impl", "kv_dtype", "kv_cache_bytes",
              "decode_layer_unroll"):
        assert got["engine"][k] == ref["engine"][k]
    for k, v in ref["engine"]["weight_formats"].items():
        assert got["engine"]["weight_formats"][k] == v
    assert got["resilience"]["health"]["state"] == "READY"
    assert json.loads(got_live[1])["alive"] is True


class FakeEngine:
    """Replies after ``delay`` seconds, or raises ``fail``."""

    model_name = "fake"

    def __init__(self, delay=0.0, fail=None):
        self.delay, self.fail = delay, fail

    def create_chat_completion(self, messages, **kw):
        time.sleep(self.delay)
        if self.fail is not None:
            raise self.fail
        return {"choices": [{"message": {"role": "assistant", "content": "ok"}}]}


def test_engine_error_500_identical():
    boom = RuntimeError("boom")
    apps = [j_create_app(engine=FakeEngine(fail=boom), settings=JSettings()),
            create_app(engine=FakeEngine(fail=boom), settings=Settings())]

    async def go(apps):
        return await both(apps, "POST", "/response", BODY)

    ref, got = serve(apps, go)
    assert ref == got and got[0] == 500


def test_queue_overflow_503_and_timeout_408():
    async def burst(apps):
        return await asyncio.gather(*[call(apps[0], "POST", "/response", BODY)
                                      for _ in range(4)])

    codes = sorted(s for s, _ in serve(
        [create_app(engine=FakeEngine(delay=0.3),
                    settings=Settings(max_queue_size=1, timeout_seconds=5))], burst))
    assert 503 in codes and 200 in codes

    async def one(apps):
        return await call(apps[0], "POST", "/response", BODY)

    status, body = serve([create_app(engine=FakeEngine(delay=0.5),
                                     settings=Settings(timeout_seconds=0.1))], one)
    assert status == 408 and json.loads(body) == {"detail": "Generation timed out"}

"""The port's streaming and OpenAI routes against the JAX package's, driven
in-process through raw ASGI calls.

At ``temperature=0`` both apps, each over its own engine on the same tiny
GGUF (the F16 file, the default Q8_0 file, the Q8_0 file over the int8 KV
ring, and the layer-looped decode over int8 weights), answer
``/v1/chat/completions`` without a stream and with one (with and without
``stream_options.include_usage``) and ``/response/stream`` with the same
JSON and the same SSE events; only ``id`` (``chatcmpl-`` and 32 hex
digits) and ``created`` (an int) differ.  ``/v1/models`` is equal but for
``created``.  The ``/v1`` error envelopes (n=2, empty messages, an unknown
model, 422 bodies, a prompt over the context, 408 and 500 over fakes) are
byte-equal.  A client that drops its socket mid-stream frees the engine
within one chunk.
"""

from __future__ import annotations

import asyncio
import json
import re
import socket
import struct
import threading
import time
import uuid

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.server import httpd
from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

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
MSGS = [{"role": "system", "content": "You are terse."},
        {"role": "user", "content": "tell me about cats"}]
ID_RE = re.compile(r"chatcmpl-[0-9a-f]{32}")


async def call(app, method: str, path: str, body=None, raw: bytes | None = None,
               headers=()):
    """One HTTP request through the ASGI interface → (status, headers, body).
    After the request body, ``receive()`` waits (the client stays)."""
    data = raw if raw is not None else (b"" if body is None else json.dumps(body).encode())
    inbox = [{"type": "http.request", "body": data, "more_body": False}]
    sent = []
    stay = asyncio.Event()

    async def receive():
        if inbox:
            return inbox.pop(0)
        await stay.wait()
        return {"type": "http.disconnect"}

    async def send(message):
        sent.append(message)

    scope = {"type": "http", "method": method, "path": path, "query_string": b"",
             "headers": [(b"host", b"test"), (b"content-type", b"application/json"),
                         *headers]}
    await app(scope, receive, send)
    hdrs = {k.decode(): v.decode() for k, v in sent[0]["headers"]}
    return sent[0]["status"], hdrs, b"".join(m.get("body", b"") for m in sent[1:])


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


def masked(doc):
    """``doc`` with ``id`` and ``created`` checked and replaced by marks."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k == "id" and isinstance(v, str) and v.startswith("chatcmpl-"):
                assert ID_RE.fullmatch(v), v
                out[k] = "<id>"
            elif k == "created":
                assert isinstance(v, int) and not isinstance(v, bool), v
                out[k] = "<created>"
            else:
                out[k] = masked(v)
        return out
    if isinstance(doc, list):
        return [masked(v) for v in doc]
    return doc


def sse_events(body: bytes) -> list:
    """The ``data:`` payloads of an SSE body, JSON decoded ([DONE] kept)."""
    out = []
    for block in body.decode().split("\n\n"):
        if not block:
            continue
        assert block.startswith("data: "), block
        data = block[len("data: "):]
        out.append(data if data == "[DONE]" else json.loads(data))
    return out


def joined(events) -> tuple[str, str | None]:
    """(the deltas' text joined, the finish_reason) of a chunk stream."""
    text, finish = "", None
    for ev in events:
        if isinstance(ev, dict) and ev.get("choices"):
            ch = ev["choices"][0]
            text += ch["delta"].get("content", "")
            finish = ch["finish_reason"] or finish
    return text, finish


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("openai")
    f16, q8 = str(d / "tiny-f16.gguf"), str(d / "tiny-q8_0.gguf")
    write_tiny_llama_gguf(f16, quant=JGGMLType.F16)
    write_tiny_llama_gguf(q8)
    return {"f16": f16, "q8_0": q8}


#: the engines held equal: (file, engine keywords)
CASES = {
    "f16": ("f16", {}),
    "q8_0": ("q8_0", {}),
    "int8_kv": ("q8_0", {"kv_dtype": "int8"}),
    "looped": ("q8_0", {"weight_format": "int8", "decode_layer_unroll": -1}),
}


def _engines(files, case):
    name, kw = CASES[case]
    kw = dict(n_ctx=1024, max_gen_tokens=16, **kw)
    return JEngine(files[name], **kw), Engine(files[name], device="cpu", **kw)


def _apps(engines, **kw):
    je, te = engines
    return [j_create_app(engine=je, settings=JSettings(temperature=0.0, **kw)),
            create_app(engine=te, settings=Settings(temperature=0.0, **kw))]


@pytest.mark.parametrize("case", list(CASES))
def test_v1_and_streams_equal_the_reference(files, case):
    """Each route's JSON and SSE events equal the JAX app's; the deltas of
    a stream join to the non-stream reply with the same finish_reason, and
    the usage chunk carries the engine's counts."""
    v1 = {"messages": MSGS, "max_tokens": 12}
    requests = [
        ("/v1/chat/completions", v1),
        ("/v1/chat/completions", {**v1, "stream": True,
                                  "stream_options": {"include_usage": True}}),
        ("/v1/chat/completions", {**v1, "stream": True}),
        ("/response", BODY),
        ("/response/stream", BODY),
    ]

    async def go(apps):
        out = []
        for path, body in requests:
            out.append([await call(a, "POST", path, body) for a in apps])
        return out

    engines = _engines(files, case)
    got = serve(_apps(engines), go)
    (ref_v1, v1_), (ref_su, su), (ref_s, s), (ref_r, r), (ref_rs, rs) = got
    for ref, mine in got:
        assert ref[0] == mine[0] == 200
        assert ref[1]["content-type"] == mine[1]["content-type"]
    assert masked(json.loads(v1_[2])) == masked(json.loads(ref_v1[2]))
    for ref, mine in ((ref_su, su), (ref_s, s), (ref_rs, rs)):
        assert mine[1]["content-type"] == "text/event-stream"
        assert masked(sse_events(mine[2])) == masked(sse_events(ref[2]))
        assert sse_events(mine[2])[-1] == "[DONE]"
    assert r[2] == ref_r[2]
    answer = json.loads(v1_[2])
    content = answer["choices"][0]["message"]["content"]
    assert content
    for events in (sse_events(su[2]), sse_events(s[2])):
        assert joined(events) == (content, answer["choices"][0]["finish_reason"])
    usage = sse_events(su[2])[-2]
    assert usage["choices"] == [] and usage["usage"] == answer["usage"]
    assert "usage" not in sse_events(s[2])[-2]
    assert joined(sse_events(rs[2]))[0] == json.loads(r[2])["response"]
    assert answer["usage"]["completion_tokens"] == 12


def test_v1_models_equal_but_created(files):
    engines = _engines(files, "q8_0")

    async def go(apps):
        return [await call(a, "GET", "/v1/models") for a in apps]

    ref, got = serve(_apps(engines), go)
    assert ref[0] == got[0] == 200
    ref, got = json.loads(ref[2]), json.loads(got[2])
    assert masked(got) == masked(ref)
    assert got["data"][0]["id"] == engines[1].model_name


class FakeEngine:
    """Replies ``reply`` after ``delay`` seconds, streaming a character a
    chunk ``chunk_delay`` apart, or raises ``fail``."""

    model_name = "fake"

    def __init__(self, reply="ok", delay=0.0, fail=None, chunk_delay=0.0):
        self.reply, self.delay, self.fail, self.chunk_delay = reply, delay, fail, chunk_delay
        self.streamed = 0          # chunks handed out
        self.closed = threading.Event()

    def create_chat_completion(self, messages, stream=False, **kw):
        time.sleep(self.delay)
        if self.fail is not None:
            raise self.fail
        base = {"id": f"chatcmpl-{uuid.uuid4().hex}", "created": int(time.time()),
                "model": self.model_name}
        if not stream:
            return {**base, "object": "chat.completion",
                    "choices": [{"index": 0, "finish_reason": "stop",
                                 "message": {"role": "assistant", "content": self.reply}}],
                    "usage": {"prompt_tokens": 1, "completion_tokens": 1,
                              "total_tokens": 2}}

        def gen():
            try:
                for ch in self.reply:
                    time.sleep(self.chunk_delay)
                    self.streamed += 1
                    yield {**base, "object": "chat.completion.chunk",
                           "choices": [{"index": 0, "delta": {"content": ch},
                                        "finish_reason": None}]}
                yield {**base, "object": "chat.completion.chunk",
                       "choices": [{"index": 0, "delta": {}, "finish_reason": "stop"}]}
            finally:
                self.closed.set()
        return gen()


BAD_V1 = [
    {"messages": MSGS, "n": 2},
    {"messages": []},
    {"messages": MSGS, "model": "other"},
]
BAD_422 = [
    None,
    {},
    {"messages": 5},
    {"messages": [1, {"role": 1}]},
    {"messages": MSGS, "stream": "maybe", "stream_options": 3, "max_tokens": 1.5,
     "temperature": "abc", "stop": 5, "n": "x", "seed": 9.3e18},
    {"messages": MSGS, "stop": [1, "a"], "stream": 2, "user": 5, "top_p": [],
     "stream_options": {"include_usage": "yes please"}},
]


def test_v1_error_envelopes_bytes_identical(files):
    engines = _engines(files, "f16")
    long = {"messages": [{"role": "user", "content": "cats and dogs " * 400}]}

    async def go(apps):
        out = [[await call(a, "POST", "/v1/chat/completions", b) for a in apps]
               for b in BAD_V1 + BAD_422 + [long]]
        out.append([await call(a, "POST", "/v1/chat/completions", raw=b"{not json")
                    for a in apps])
        return out

    for ref, got in serve(_apps(engines), go):
        assert got[0] == ref[0] and got[2] == ref[2]
        assert got[0] in (400, 422)
        if got[0] == 400:
            assert json.loads(got[2])["error"]["type"] == "invalid_request_error"
    code = json.loads(serve(_apps(engines), lambda apps: call(
        apps[1], "POST", "/v1/chat/completions", BAD_V1[2]))[2])["error"]["code"]
    assert code == "model_not_found"


@pytest.mark.parametrize("fake,kw,status", [
    (dict(delay=0.5), dict(timeout_seconds=0.1), 408),
    (dict(fail=RuntimeError("boom")), {}, 500),
])
def test_v1_timeout_and_engine_error_envelopes_identical(fake, kw, status):
    """Non-stream: the 408 and 500 envelopes byte-equal; stream: the same
    error event."""
    apps = [j_create_app(engine=FakeEngine(**fake), settings=JSettings(**kw)),
            create_app(engine=FakeEngine(**fake), settings=Settings(**kw))]

    async def go(apps):
        plain = [await call(a, "POST", "/v1/chat/completions", {"messages": MSGS})
                 for a in apps]
        streams = [await call(a, "POST", "/v1/chat/completions",
                              {"messages": MSGS, "stream": True}) for a in apps]
        legacy = [await call(a, "POST", "/response/stream", BODY) for a in apps]
        return plain, streams, legacy

    (ref, got), (ref_s, got_s), (ref_l, got_l) = serve(apps, go)
    assert got[0] == ref[0] == status and got[2] == ref[2]
    assert json.loads(got[2])["error"]["type"] == (
        "timeout_error" if status == 408 else "server_error")
    assert got_s[0] == ref_s[0] == 200 and got_s[2] == ref_s[2]
    assert got_l[0] == ref_l[0] == 200 and got_l[2] == ref_l[2]
    assert "error" in sse_events(got_s[2])[-1]


def test_asgi_disconnect_closes_the_stream():
    """An ``http.disconnect`` while the body streams cancels and closes the
    SSE generator at once: the engine's iterator is closed after a few
    chunks instead of running to its end."""
    eng = FakeEngine(reply="z" * 400, chunk_delay=0.01)
    app = create_app(engine=eng, settings=Settings())

    async def go(apps):
        gone = asyncio.Event()
        inbox = [{"type": "http.request", "body": json.dumps(BODY).encode(),
                  "more_body": False}]
        sent = []

        async def receive():
            if inbox:
                return inbox.pop(0)
            await gone.wait()
            return {"type": "http.disconnect"}

        async def send(message):
            sent.append(message)
            if len(sent) == 3:          # the start and two events
                gone.set()

        scope = {"type": "http", "method": "POST", "path": "/response/stream",
                 "query_string": b"", "headers": [(b"host", b"test")]}
        t0 = time.time()
        await apps[0](scope, receive, send)
        returned = time.time() - t0
        status, _, body = await call(apps[0], "POST", "/response", BODY)
        return returned, status, body, sent

    returned, status, body, sent = serve([app], go)
    assert eng.closed.wait(2)
    assert eng.streamed < 100 and returned < 2
    assert status == 200 and json.loads(body) == {"response": "z" * 400}
    assert len(sent) < 100


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raw_request(body: bytes, path: bytes = b"/response") -> bytes:
    return (b"POST " + path + b" HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)


def _read_response(sock) -> tuple[int, bytes]:
    """One Content-Length-framed HTTP/1.1 response: (status, body)."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        assert chunk, f"connection closed mid-head: {buf!r}"
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    clen = next(int(ln.split(b":")[1]) for ln in head.split(b"\r\n")
                if ln.lower().startswith(b"content-length:"))
    while len(rest) < clen:
        rest += sock.recv(65536)
    return int(head.split()[1]), rest[:clen]


def test_stream_client_disconnect_frees_the_engine():
    """A client that drops its socket (RST) mid-SSE frees the engine within
    about one chunk: the follow-up request is served at once, not after the
    ~4 s the dead stream would drip (the reference's
    tests/test_server.py::test_stream_client_disconnect_reclaims_engine,
    over the port's httpd)."""
    eng = FakeEngine(reply="z" * 400, chunk_delay=0.01)
    app = create_app(engine=eng, settings=Settings())
    port = _free_port()
    loop = asyncio.new_event_loop()
    up, stop = asyncio.Event(), asyncio.Event()
    th = threading.Thread(target=loop.run_until_complete, daemon=True,
                          args=(httpd.serve(app, "127.0.0.1", port, up, stop),))
    th.start()
    t_up = time.time()
    while not up.is_set() and time.time() - t_up < 10:
        time.sleep(0.02)
    payload = json.dumps(BODY).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        s.sendall(_raw_request(payload, path=b"/response/stream"))
        first = s.recv(4096)
        assert b"200" in first.split(b"\r\n", 1)[0]
        assert b"transfer-encoding: chunked" in first.lower()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        s.close()
        t0 = time.time()
        assert eng.closed.wait(2), "the stream's engine iterator was not closed"
        freed = time.time() - t0
        s2 = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            s2.sendall(_raw_request(payload))
            status, body = _read_response(s2)
        finally:
            s2.close()
        elapsed = time.time() - t0
        assert status == 200 and json.loads(body) == {"response": "z" * 400}
        assert freed < 1.0 and eng.streamed < 150, (freed, eng.streamed)
        assert elapsed < 2.5, f"engine not freed after the disconnect: {elapsed:.1f}s"
    finally:
        try:
            s.close()
        except OSError:
            pass
        loop.call_soon_threadsafe(stop.set)
        th.join(10)
        loop.close()

"""A Mistral (SentencePiece, sliding-window) file served by the port
against the JAX package, driven in-process through raw ASGI calls.

``write_tiny_mistral_gguf`` (window 16, a byte-fallback SPM vocabulary, the
``[INST]`` template), as written (``general.architecture`` ``mistral``) and
rewritten under ``llama`` as llama.cpp writes Mistral-7B-Instruct and
Llama-2 files: ``ModelConfig.from_gguf`` reads the same config as the
reference under both names; at temperature 0 both apps answer
``/response`` (a first turn, a follow-up that takes prefix reuse),
``/response/stream`` and ``/v1/chat/completions`` with a system message
(folded into the first ``[INST]``) with the same bytes, over a prompt of
hundreds of tokens, so prompt passes and every decode step run past slot
16 and the window bites; a stream's text equals the non-stream reply (the
SPM prefix space is dropped once, on the first piece of the reply).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.gguf import GGUFWriter as JGGUFWriter
from llama_fastapi_k8s_gpu_tpu.models import config as jconfig
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_mistral_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile
from llama_fastapi_k8s_gpu_tpu_torch.models import config
from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
from llama_fastapi_k8s_gpu_tpu_torch.tokenizer import SPMTokenizer
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

torch.set_num_threads(1)

BODY = {
    "bot_profile": {"name": "Alice.f", "appearance": "tall,slim,blonde,loves cats,hates rain"},
    "user_profile": {"name": "Bob"},
    "context": [
        {"turn": "user", "message": "hi"},
        {"turn": "assistant", "message": "hey"},
        {"turn": "user", "message": "how are you? ça va, naïve café €"},
    ],
}
FOLLOW = {**BODY, "context": BODY["context"] + [
    {"turn": "assistant", "message": "fine"},
    {"turn": "user", "message": "tell me about cats, please"}]}
MSGS = [{"role": "system", "content": "You are terse."},
        {"role": "user", "content": "tell me about cats"}]
ID_RE = re.compile(r"chatcmpl-[0-9a-f]{32}")
WINDOW = 16


def as_llama(src: str, dst: str) -> str:
    """``src`` rewritten as llama.cpp writes Mistral files: architecture
    ``llama``, every ``mistral.*`` key under ``llama.*``, tensors byte for
    byte."""
    gf = JGGUFFile(src)
    w = JGGUFWriter(dst)
    for k, v in gf.metadata.items():
        if k == "general.architecture":
            v = "llama"
        elif k.startswith("mistral."):
            k = "llama." + k[len("mistral."):]
        w.add_metadata(k, v)
    for name, t in gf.tensors.items():
        w.add_raw_tensor(name, t.shape, t.ggml_type, np.asarray(t.raw()))
    w.write()
    return dst


@pytest.fixture(scope="module", params=["mistral", "llama"])
def path(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("mistral")
    p = str(d / "tiny-mistral.gguf")
    write_tiny_mistral_gguf(p)
    if request.param == "llama":
        p = as_llama(p, str(d / "tiny-mistral-as-llama.gguf"))
    assert JGGUFFile(p).metadata["general.architecture"] == request.param
    return p


@pytest.fixture(scope="module")
def engines(path):
    kw = dict(n_ctx=1024, max_gen_tokens=24)
    return JEngine(path, **kw), Engine(path, device="cpu", **kw)


def test_config_from_gguf_under_both_architectures(path):
    ref = jconfig.ModelConfig.from_gguf(JGGUFFile(path), n_ctx=1024)
    got = config.ModelConfig.from_gguf(GGUFFile(path), n_ctx=1024)
    shared = {f.name for f in dataclasses.fields(got)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert {k: getattr(got, k) for k in shared} == {k: getattr(ref, k) for k in shared}
    assert got.sliding_window == WINDOW and got.vocab_size == 3 + 1 + 256


def test_mistral_7b_preset_is_the_reference_preset():
    ref, got = jconfig.MISTRAL_7B, config.MISTRAL_7B
    for f in dataclasses.fields(got):
        if hasattr(ref, f.name):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert (got.vocab_size, got.dim, got.n_layers, got.n_heads, got.n_kv_heads,
            got.ffn_dim, got.rope_theta) == (32000, 4096, 32, 32, 8, 14336, 1e6)


async def call(app, method: str, path: str, body=None):
    """One HTTP request through the ASGI interface → (status, body bytes).
    After the request body, ``receive()`` waits (the client stays)."""
    inbox = [{"type": "http.request", "body": json.dumps(body).encode() if body else b"",
              "more_body": False}]
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
             "headers": [(b"host", b"test"), (b"content-type", b"application/json")]}
    await app(scope, receive, send)
    return sent[0]["status"], b"".join(m.get("body", b"") for m in sent[1:])


def serve(apps, fn):
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
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k == "id" and isinstance(v, str) and v.startswith("chatcmpl-"):
                assert ID_RE.fullmatch(v), v
                out[k] = "<id>"
            elif k == "created":
                out[k] = "<created>"
            else:
                out[k] = masked(v)
        return out
    if isinstance(doc, list):
        return [masked(v) for v in doc]
    return doc


def stream_text(body: bytes) -> str:
    text = ""
    for block in body.decode().split("\n\n"):
        data = block[len("data: "):]
        if block and data != "[DONE]":
            ev = json.loads(data)
            if ev.get("choices"):
                text += ev["choices"][0]["delta"].get("content", "")
    return text


def test_response_bytes_equal_the_reference(engines):
    """Greedy ``/response`` bytes equal the JAX app's on both turns (the
    second takes prefix reuse), ``/response/stream`` and ``/v1`` (with a
    system message) equal the JAX app's too, and each stream's text is the
    non-stream reply."""
    requests = [("/response", BODY), ("/response", FOLLOW), ("/response/stream", BODY),
                ("/v1/chat/completions", {"messages": MSGS, "max_tokens": 20}),
                ("/v1/chat/completions", {"messages": MSGS, "max_tokens": 20,
                                          "stream": True})]

    je, te = engines
    timings = []

    async def go(apps):
        out = []
        for p, b in requests:
            out.append([await call(a, "POST", p, b) for a in apps])
            timings.append(dict(te.last_timings))
        return out

    assert te.template_kind == je.template_kind == "mistral"
    assert isinstance(te.tokenizer, SPMTokenizer)
    assert te.cfg.sliding_window == WINDOW
    apps = [j_create_app(engine=je, settings=JSettings(temperature=0.0)),
            create_app(engine=te, settings=Settings(temperature=0.0))]
    (r1, r2, rs, v1, v1s) = serve(apps, go)
    for ref, got in (r1, r2, rs, v1, v1s):
        assert ref[0] == got[0] == 200
    assert r1[1][1] == r1[0][1] and r2[1][1] == r2[0][1]
    assert json.loads(r1[1][1])["response"]
    assert timings[1]["prefix_reused_tokens"] > 0
    assert timings[1]["prompt_tokens"] > 10 * WINDOW
    assert masked(json.loads(v1[1][1])) == masked(json.loads(v1[0][1]))
    assert stream_text(rs[1][1]) == stream_text(rs[0][1]) == \
        json.loads(r1[1][1])["response"]
    content = json.loads(v1[1][1])["choices"][0]["message"]["content"]
    assert stream_text(v1s[1][1]) == stream_text(v1s[0][1]) == content

"""The port's sequence-parallel engine (engine/sp.py) on the CPU:
test_sp_engine.py's cases, and the port's ``SPEngine`` beside the JAX
package's on the same tiny GGUF.

The port's mesh is ``[cpu] * 4`` (sp = 2 × tp = 2); the JAX engine runs on
its virtual CPU devices.  Greedy replies are compared byte for byte (exact
on the tiny model); the serial engines are the port's ``Engine`` at the
same n_ctx.
"""

from __future__ import annotations

import json

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import SPEngine as JSPEngine
from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.testing import TINY_CFG, write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine, SPEngine
from llama_fastapi_k8s_gpu_tpu_torch.obs.devtime import DEVTIME
from llama_fastapi_k8s_gpu_tpu_torch.obs.memledger import MEMLEDGER
from llama_fastapi_k8s_gpu_tpu_torch.obs.trace import Tracer
from llama_fastapi_k8s_gpu_tpu_torch.server.app import _default_engine_factory, create_app
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings
from tests.test_torch_openai import call, serve

torch.set_num_threads(1)
CPU = torch.device("cpu")
MSGS = [{"role": "user", "content": "Say something."}]
LONG = [{"role": "user", "content": "word " * 60}]          # ~320 tokens
KW = dict(n_ctx=512, decode_chunk=4, max_gen_tokens=32, prefill_buckets=(32, 64, 128))


def _text(out: dict) -> str:
    return out["choices"][0]["message"]["content"]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sp") / "tiny.gguf")
    # n_ctx 512: the long prompt needs room past the 128-token bucket; the
    # ring shards this dim over sp
    write_tiny_llama_gguf(path, cfg=JModelConfig(**{**TINY_CFG.__dict__, "n_ctx": 512}))
    return path


@pytest.fixture(scope="module")
def sp_engine(model_path):
    eng = SPEngine(model_path, sp=2, tp=2, devices=[CPU] * 4, device="cpu", **KW)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def serial(model_path):
    return Engine(model_path, device="cpu", **KW)


def test_greedy_parity_with_serial(sp_engine, serial):
    a = serial.create_chat_completion(MSGS, temperature=0.0, max_tokens=12)
    b = sp_engine.create_chat_completion(MSGS, temperature=0.0, max_tokens=12)
    assert _text(a) == _text(b)
    assert a["usage"] == b["usage"]


def test_stream_parity(sp_engine):
    ref = sp_engine.create_chat_completion(MSGS, temperature=0.0, max_tokens=8)
    chunks = list(sp_engine.create_chat_completion(MSGS, stream=True, temperature=0.0,
                                                   max_tokens=8))
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert text == _text(ref)


def test_buckets_are_sp_multiples(sp_engine):
    assert all(b % sp_engine.sp == 0 for b in sp_engine.prefill_buckets)
    assert sp_engine.prefill_buckets[-1] == sp_engine.cfg.n_ctx
    assert sp_engine.cfg.attn_impl == "ring"
    ring = sp_engine._cache
    assert ring.coords == [(0, t, s) for t in range(2) for s in range(2)]
    assert tuple(ring["k"][0].shape) == (2, 1, 256, 16)      # L, n_kv/tp, n_ctx/sp, hd


def test_long_context_generation(sp_engine, serial):
    """A prompt past the 128-token bucket (it spans both sp shards of the
    512-slot ring): the serial engine's reply at the same n_ctx."""
    a = serial.create_chat_completion(LONG, temperature=0.0, max_tokens=10)
    b = sp_engine.create_chat_completion(LONG, temperature=0.0, max_tokens=10)
    assert a["usage"]["prompt_tokens"] == b["usage"]["prompt_tokens"] > 256
    assert _text(a) == _text(b)


def test_sp_engine_rejects_bad_config(model_path):
    with pytest.raises(ValueError, match="sp >= 2"):
        SPEngine(model_path, sp=1, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        SPEngine(model_path, sp=2, attn_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        SPEngine(model_path, sp=2, n_ctx=511, device="cpu")
    # the reference degrades the looped knob; the port refuses it
    with pytest.raises(ValueError, match="decode_layer_unroll"):
        SPEngine(model_path, sp=2, devices=[CPU] * 2, device="cpu", decode_layer_unroll=-1, **KW)
    # one device, a mesh of two
    with pytest.raises(ValueError, match="mesh 1x1x2 needs 2 devices, have 1"):
        SPEngine(model_path, sp=2, device="cpu", **KW)


def test_port_and_jax_sp_engines_reply_alike(model_path, sp_engine):
    """The JAX package's ``SPEngine`` (sp = 2 × tp = 2 on its virtual
    devices) and the port's on the same tiny GGUF: the same greedy replies
    to the short and the long prompt."""
    ref = JSPEngine(model_path, sp=2, tp=2, **KW)
    for msgs in (MSGS, LONG):
        want = ref.create_chat_completion(msgs, temperature=0.0, max_tokens=10)
        got = sp_engine.create_chat_completion(msgs, temperature=0.0, max_tokens=10)
        assert _text(got) == _text(want)
        assert got["usage"] == want["usage"]


def test_response_served_over_sp_mesh(model_path):
    """/response and /response/stream end to end with the sequence-parallel
    engine behind the app; the traced request's engine span carries the
    mesh geometry."""
    eng = SPEngine(model_path, sp=2, tp=1, devices=[CPU] * 2, device="cpu",
                   **{**KW, "max_gen_tokens": 8, "prefill_buckets": (64, 128)})
    app = create_app(engine=eng, settings=Settings(max_context_tokens=512, trace_sample=1.0))
    body = {"bot_profile": {"name": "Alice.f", "appearance": "tall"},
            "user_profile": {"name": "Bob"},
            "context": [{"turn": "user", "message": "hi"}]}

    async def go(apps):
        a = apps[0]
        r = await call(a, "POST", "/response", body)
        s = await call(a, "POST", "/response/stream", body)
        traces = json.loads((await call(a, "GET", "/debug/traces"))[2])
        tid = traces["traces"][0]["trace_id"]
        return r, s, json.loads((await call(a, "GET", f"/debug/traces/{tid}"))[2])

    try:
        r, s, tree = serve([app], go)
    finally:
        eng.close()
    assert r[0] == 200 and isinstance(json.loads(r[2])["response"], str)
    assert s[0] == 200 and b"data: [DONE]" in s[2]
    spans = [tree["root"]]
    while spans and spans[0]["name"] != "engine":
        spans = spans[1:] + spans[0].get("children", [])
    assert spans, tree
    attrs = spans[0]["attrs"]
    assert (attrs["engine"], attrs["sp"], attrs["tp"], attrs["devices"]) == ("SPEngine", 2, 1, 2)


def test_requests_memory_and_compiles_name_the_mesh(sp_engine):
    """/debug/requests' live entry carries the mesh geometry; the memory
    ledger attributes the ring and the weights per shard; the compile
    registry counts the ring programs' dispatches."""
    tracer = Tracer(sample=1.0, ring=8)
    trace = tracer.start()
    sp_engine._engine_span(trace, None)
    live = tracer.inflight()[0]
    assert (live["engine"], live["sp"], live["tp"], live["devices"]) == ("SPEngine", 2, 2, 4)
    from llama_fastapi_k8s_gpu_tpu_torch.engine.engine import _ledger_ring, _ledger_weights

    name = sp_engine.model_name
    shards = [f"{name}@dp0.tp{t}.sp{s}:cpu" for t in range(2) for s in range(2)]
    ring, weights = _ledger_ring(sp_engine), _ledger_weights(sp_engine)
    assert sorted(ring) == sorted(weights) == shards
    assert sum(ring.values()) == sp_engine.kv_cache_bytes
    assert sum(weights.values()) == sp_engine.weight_bytes
    rows = {(r["component"], r["model"]) for r in MEMLEDGER.snapshot()["components"]}
    assert {("kv_ring", m) for m in shards} <= rows and {("weights", m) for m in shards} <= rows
    before = DEVTIME.counters()
    sp_engine.create_chat_completion(MSGS, temperature=0.0, max_tokens=6)
    after = DEVTIME.counters()
    for prog in ("sp_prefill", "sp_decode_chunk"):
        assert after[prog]["dispatches"] > before[prog]["dispatches"], prog
    assert after["prefill"]["dispatches"] == before["prefill"]["dispatches"]


def test_recover_zeroes_the_sharded_ring_in_place(sp_engine):
    """Watchdog recovery keeps every shard's storage (the decode graphs
    hold its addresses) and zeroes it; the next request replies as before."""
    before = _text(sp_engine.create_chat_completion(MSGS, temperature=0.0, max_tokens=6))
    ptrs = {k: [t.data_ptr() for t in v] for k, v in sp_engine._cache.items()}
    assert sp_engine.recover() is True
    assert {k: [t.data_ptr() for t in v] for k, v in sp_engine._cache.items()} == ptrs
    assert all(not t.any() for v in sp_engine._cache.values() for t in v)
    assert _text(sp_engine.create_chat_completion(MSGS, temperature=0.0, max_tokens=6)) == before


def test_server_factory_guards_sp_plus_batch():
    factory = _default_engine_factory(Settings(mesh_sp=2, batch_size=4))
    with pytest.raises(ValueError, match="LFKT_MESH_SP"):
        factory()


def test_registry_guards_sp_with_several_models(tmp_path):
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import _registry_factory

    with pytest.raises(ValueError, match="LFKT_MESH_SP > 1 gates off multi-model"):
        _registry_factory(Settings(models="a=a.gguf,b=b.gguf", mesh_sp=2,
                                   model_dir=str(tmp_path)))


def test_paged_knob_is_logged_and_the_dense_ring_serves(model_path, caplog):
    """``kv_paged`` on the sequence-parallel engine: logged, and the dense
    sharded ring serves (the reference's behaviour)."""
    eng = SPEngine(model_path, sp=2, devices=[CPU] * 2, device="cpu", kv_paged=True, **KW)
    try:
        assert eng._kvpool is None and not eng._kv_paged
        assert "dense" in caplog.text
    finally:
        eng.close()

"""The port's app over lanes (``LFKT_BATCH_SIZE=4``) against the JAX app,
under both schedulers, driven in-process through raw ASGI calls.

``continuous`` (the port's ``ContinuousEngine`` against the JAX one, both
``dp=1, tp=1``) and ``cycle`` (the ``MeshEngine`` pair): at temperature 0
five concurrent ``/response`` requests, ``/v1/chat/completions`` without
and with a stream and ``/response/stream`` answer with the same bodies
(``id``/``created`` masked); ``/metrics`` carries the same ``scheduler_*``
families and the promoted gauges; ``/debug/memory`` has the ``kv_lanes``
(and, continuous, ``kv_scratch``) rows.  Over fakes, a burst past the queue
of 5 answers 503 and a slow reply 408 exactly as the reference's app does.
The default factory refuses an unknown ``LFKT_SCHEDULER`` with the
reference's message and builds the engine the settings name; the watchdog
trips on a killed scheduler thread and recovers to READY.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from concurrent.futures import Future

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import ContinuousEngine as JContinuousEngine
from llama_fastapi_k8s_gpu_tpu.engine import MeshEngine as JMeshEngine
from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.server.app import _default_engine_factory as j_factory
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch import engine as engine_pkg
from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, MeshEngine
from llama_fastapi_k8s_gpu_tpu_torch.server.app import _default_engine_factory, create_app
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings, get_settings
from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS
from llama_fastapi_k8s_gpu_tpu_torch.utils.health import READY
from tests.test_torch_openai import call, masked, serve, sse_events

torch.set_num_threads(1)

BOT = {"name": "Alice.f", "appearance": "tall,slim,blonde,loves cats,hates rain"}


def body(i: int) -> dict:
    return {"bot_profile": BOT, "user_profile": {"name": "Bob"},
            "context": [{"turn": "user", "message": "hi"},
                        {"turn": "assistant", "message": "hey"},
                        {"turn": "user", "message": f"question number {i} " * (1 + i % 3)}]}


MSGS = [{"role": "system", "content": "You are terse."},
        {"role": "user", "content": "tell me about cats"}]
KW = dict(n_ctx=1024, max_gen_tokens=12, decode_chunk=4)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("srvlanes") / "tiny.gguf")
    write_tiny_llama_gguf(p, quant=JGGMLType.F16)
    return p


def _engines(path, scheduler):
    if scheduler == "continuous":
        return (JContinuousEngine(path, dp=1, tp=1, batch_size=4, **KW),
                ContinuousEngine(path, batch_size=4, device="cpu", **KW))
    return (JMeshEngine(path, dp=1, tp=1, batch_size=4, **KW),
            MeshEngine(path, batch_size=4, device="cpu", **KW))


def _apps(engines, scheduler, **kw):
    je, te = engines
    common = dict(temperature=0.0, batch_size=4, scheduler=scheduler, **kw)
    return [j_create_app(engine=je, settings=JSettings(**common)),
            create_app(engine=te, settings=Settings(**common))]


def _families(text: str, prefix: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ") and ln.split()[2].startswith(prefix)}


@pytest.mark.parametrize("scheduler", ["continuous", "cycle"])
def test_lane_app_bodies_metrics_and_memory_equal_the_reference(path, scheduler):
    engines = _engines(path, scheduler)
    v1 = {"messages": MSGS, "max_tokens": 10}

    async def go(apps):
        out = {}
        for a, name in zip(apps, ("ref", "port")):
            wave = await asyncio.gather(*[call(a, "POST", "/response", body(i))
                                          for i in range(5)])
            out[name] = {
                "wave": wave,
                "v1": await call(a, "POST", "/v1/chat/completions", v1),
                "v1_stream": await call(a, "POST", "/v1/chat/completions",
                                        {**v1, "stream": True}),
                "stream": await call(a, "POST", "/response/stream", body(1)),
                "metrics": await call(a, "GET", "/metrics"),
                "memory": await call(a, "GET", "/debug/memory"),
            }
        return out

    try:
        got = serve(_apps(engines, scheduler), go)
    finally:
        for e in engines:
            if hasattr(e, "shutdown"):
                e.shutdown()
    ref, port = got["ref"], got["port"]
    for (rs, _, rb), (ps, _, pb) in zip(ref["wave"], port["wave"]):
        assert rs == ps == 200
        assert pb == rb and json.loads(pb)["response"]
    assert ref["v1"][0] == port["v1"][0] == 200
    assert masked(json.loads(port["v1"][2])) == masked(json.loads(ref["v1"][2]))
    for key in ("v1_stream", "stream"):
        assert masked(sse_events(port[key][2])) == masked(sse_events(ref[key][2]))
    pm, rm = port["metrics"][2].decode(), ref["metrics"][2].decode()
    if scheduler == "continuous":
        fams = _families(pm, "scheduler_")
        assert fams == _families(rm, "scheduler_") and "scheduler_lanes_live" in fams
        for fam in ("admission_budget_tokens", "lane_idle_seconds"):
            assert f"# TYPE {fam} gauge" in pm and f"# TYPE {fam} gauge" in rm
    else:
        assert "batched_generations_total" in pm and "batch_occupancy_bucket" in pm
        assert _families(pm, "batch") == _families(rm, "batch")
    rows = {r["component"] for r in json.loads(port["memory"][2])["components"]}
    want = {"kv_lanes", "kv_scratch"} if scheduler == "continuous" else {"kv_lanes"}
    assert want <= rows


class FakeContinuous:
    """``submit`` resolves each future ``delay`` seconds later, on a timer."""

    model_name = "fake"

    def __init__(self, delay: float):
        self.delay = delay

    def submit(self, messages, **kw):
        fut = Future()
        threading.Timer(self.delay, lambda: fut.done() or fut.set_result({
            "choices": [{"message": {"role": "assistant", "content": "ok"}}],
            "usage": {"completion_tokens": 1}})).start()
        return fut

    def abandon(self, fut):
        pass

    def create_chat_completion(self, messages, **kw):
        return self.submit(messages).result()


class FakeCycle:
    """A batch a ``delay`` seconds."""

    model_name = "fake"

    def __init__(self, delay: float):
        self.delay = delay

    def create_chat_completions(self, batch, **kw):
        time.sleep(self.delay)
        return [{"choices": [{"message": {"role": "assistant", "content": f"r{i}"}}],
                 "usage": {"completion_tokens": 1}} for i in range(len(batch))]

    def create_chat_completion(self, messages, **kw):
        return self.create_chat_completions([messages])[0]


@pytest.mark.parametrize("scheduler,fake", [("continuous", FakeContinuous),
                                            ("cycle", FakeCycle)])
def test_lane_app_503_and_408_equal_the_reference(scheduler, fake):
    async def burst(apps):
        return [sorted(s for s, _, _ in await asyncio.gather(
            *[call(a, "POST", "/response", body(0)) for _ in range(14)])) for a in apps]

    common = dict(batch_size=4, scheduler=scheduler, timeout_seconds=5)
    ref, got = serve([j_create_app(engine=fake(0.6), settings=JSettings(**common)),
                      create_app(engine=fake(0.6), settings=Settings(**common))], burst)
    assert got == ref and 503 in got and 200 in got

    async def one(apps):
        return [await call(a, "POST", "/response", body(0)) for a in apps]

    slow = dict(batch_size=4, scheduler=scheduler, timeout_seconds=0.2)
    ref, got = serve([j_create_app(engine=fake(1.0), settings=JSettings(**slow)),
                      create_app(engine=fake(1.0), settings=Settings(**slow))], one)
    assert got[0] == ref[0] == 408 and got[2] == ref[2]


def test_factory_refuses_an_unknown_scheduler_like_the_reference(monkeypatch):
    monkeypatch.setenv("LFKT_SCHEDULER", "fifo")
    monkeypatch.setenv("LFKT_BATCH_SIZE", "4")
    from llama_fastapi_k8s_gpu_tpu.utils.config import get_settings as j_get_settings

    with pytest.raises(ValueError) as ref:
        j_factory(j_get_settings())()
    with pytest.raises(ValueError) as got:
        _default_engine_factory(get_settings())()
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("scheduler,batch,want", [("continuous", 4, "ContinuousEngine"),
                                                  ("cycle", 4, "MeshEngine"),
                                                  ("continuous", 1, "Engine")])
def test_factory_builds_the_engine_the_settings_name(monkeypatch, scheduler, batch, want):
    seen = {}

    def recorder(name):
        class Recorder:
            def __init__(self, path, **kw):
                seen["cls"], seen["kw"] = name, kw

            def warmup(self):
                seen["warm"] = True
        return Recorder

    monkeypatch.setenv("LFKT_SCHEDULER", scheduler)
    monkeypatch.setenv("LFKT_BATCH_SIZE", str(batch))
    monkeypatch.setenv("LFKT_ADM_BUDGET", "64")
    for name in ("Engine", "MeshEngine", "ContinuousEngine"):
        monkeypatch.setattr(engine_pkg, name, recorder(name))
    settings = get_settings()
    assert (settings.batch_size, settings.scheduler, settings.adm_budget) == (batch, scheduler,
                                                                               64)
    _default_engine_factory(settings)()
    assert seen["cls"] == want and seen["warm"]
    if want != "Engine":
        assert seen["kw"]["batch_size"] == 4 and seen["kw"]["tp"] == 1
    if want == "ContinuousEngine":
        assert seen["kw"]["adm_budget"] == 64 and seen["kw"]["lane_prefix_cache"] is True


def test_knob_defaults_are_the_references():
    from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JS

    for name in ("batch_size", "scheduler", "adm_budget", "adm_controller", "adm_ema_alpha",
                 "lane_prefix_cache", "mesh_tp"):
        assert getattr(Settings(), name) == getattr(JS(), name), name


def test_watchdog_trips_on_a_killed_scheduler_and_recovers(path):
    """A ``decode_step`` fault kills the scheduler thread: the watchdog reads
    it as ``scheduler_died``, the in-flight request fails, recovery restarts
    the thread on zeroed lanes, the pod walks back to READY and serves the
    same greedy reply as before."""
    eng = ContinuousEngine(path, batch_size=4, device="cpu", **KW)
    app = create_app(engine=eng, settings=Settings(
        temperature=0.0, batch_size=4, watchdog_poll_seconds=0.02,
        watchdog_backoff_seconds=0.02))

    async def until(pred, timeout=20.0):
        t0 = time.time()
        while not pred():
            assert time.time() - t0 < timeout, "timed out"
            await asyncio.sleep(0.01)

    async def go(apps):
        a = apps[0]
        before = await call(a, "POST", "/response", body(2))
        FAULTS.arm("decode_step:error:times=1")
        try:
            failed = await call(a, "POST", "/response", body(2))
            wd = a.state.watchdog
            await until(lambda: wd.recoveries == 1 and a.state.health.state == READY)
        finally:
            FAULTS.disarm()
        after = await call(a, "POST", "/response", body(2))
        return before, failed, after, wd.last_trip_reason

    try:
        before, failed, after, reason = serve([app], go)
    finally:
        eng.shutdown()
    assert before[0] == 200 and failed[0] in (500, 503)
    assert reason.startswith("scheduler_died: FaultError")
    assert after[2] == before[2]

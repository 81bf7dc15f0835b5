"""The port's app over the paged pool and over speculation, against the JAX
app, driven in-process through raw ASGI calls.

- ``LFKT_KV_PAGED``: after the same requests (a conversation and its
  follow-up) both apps answer 200 with the same first reply (the
  follow-up's greedy reply may part from the reference's at a bf16 tie,
  ROADMAP C.5; tests/test_torch_paged_engines.py holds the paged replies'
  bytes); ``/health``
  ``engine.kv_pool`` is the same document (occupancy and counters),
  ``/metrics`` carries the same pool families (``kv_pool_pages_*``,
  ``prefix_cache_*``, ``prefix_reuse_tokens``), and ``/debug/memory`` the
  same ``kv_pool`` block, fragmentation line and arena rows
  (``kv_arena_used``, ``kv_arena_free``, ``host_spill``).
- ``LFKT_SPEC_DECODE``: ``/health`` ``engine.spec_auto`` is the decision
  record under ``auto`` (absent otherwise), and ``/metrics`` the same
  ``spec_*`` counters as the reference's after the same greedy requests.
- The knobs: ``get_settings`` reads them as the reference does, and the
  default factory builds the engine they name.
"""

from __future__ import annotations

import json

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.engine import spec_auto as jspec_auto
from llama_fastapi_k8s_gpu_tpu.obs import memledger as jmemledger
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu.utils.config import get_settings as j_get_settings
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine, spec_auto
from llama_fastapi_k8s_gpu_tpu_torch.obs import memledger
from llama_fastapi_k8s_gpu_tpu_torch.server.app import _default_engine_factory, create_app
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import KNOBS, Settings, get_settings
from tests.test_torch_openai import call, serve

torch.set_num_threads(1)
BOT = {"name": "Alice.f", "appearance": "tall,slim,blonde,loves cats,hates rain"}
KW = dict(n_ctx=1024, decode_chunk=4, max_gen_tokens=10, prefill_buckets=(128, 256, 512, 1024),
          prefill_chunk=256)
PAGED = dict(kv_paged=True, kv_page_tokens=64, kv_pool_pages=32, kv_spill_pages=8,
             prefix_min=32)
POOL_FAMILIES = ("kv_pool_pages_used", "kv_pool_pages_free", "prefix_cache_misses_total",
                 "prefix_cache_hits_total", "prefix_cache_reused_tokens_total",
                 "prefix_reuse_tokens")
SPEC_FAMILIES = ("spec_drafted_tokens_total", "spec_accepted_tokens_total",
                 "spec_verify_steps_total", "spec_fallback_steps_total")


def body(turns) -> dict:
    return {"bot_profile": BOT, "user_profile": {"name": "Bob"},
            "context": [{"turn": t, "message": m} for t, m in turns]}


FIRST = [("user", "hello there, how was your day?")]


def follow(reply: str):
    return FIRST + [("assistant", reply[:60]), ("user", "tell me more about it")]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("srvpaged") / "tiny.gguf")
    write_tiny_llama_gguf(p)
    return p


@pytest.fixture
def ledgers(monkeypatch):
    mine = memledger.MemLedger(armed=True, pressure_fraction=0.05)
    ref = jmemledger.MemLedger(armed=True, pressure_fraction=0.05)
    monkeypatch.setattr(memledger, "MEMLEDGER", mine)
    monkeypatch.setattr(jmemledger, "MEMLEDGER", ref)
    return mine, ref


def _samples(text: str, family: str) -> dict:
    out = {}
    for ln in text.splitlines():
        if ln.startswith(family) and not ln.startswith("#"):
            name, _, value = ln.rpartition(" ")
            out[name] = float(value)
    return out


def _drive(apps, turns_fn):
    async def go(apps):
        out = []
        for a in apps:
            st, _, b = await call(a, "POST", "/response", body(FIRST))
            first = json.loads(b)["response"]
            st2, _, b2 = await call(a, "POST", "/response", body(turns_fn(first)))
            docs = {"bodies": (st, first, st2, json.loads(b2))}
            for route in ("/health", "/metrics", "/debug/memory"):
                s, _, raw = await call(a, "GET", route)
                assert s == 200, route
                docs[route] = raw.decode() if route == "/metrics" else json.loads(raw)
            out.append(docs)
        return out
    return serve(apps, go)


def test_paged_pod_health_metrics_memory_equal_the_reference(path, ledgers):
    eng = Engine(path, device="cpu", **KW, **PAGED)
    ref = JEngine(path, **KW, **PAGED)
    apps = [create_app(engine=eng, settings=Settings(temperature=0.0)),
            j_create_app(engine=ref, settings=JSettings(temperature=0.0))]
    got, want = _drive(apps, follow)
    assert got["bodies"][:3] == want["bodies"][:3] and got["bodies"][0] == 200
    assert got["bodies"][2] == 200
    pool = got["/health"]["engine"]["kv_pool"]
    assert pool == want["/health"]["engine"]["kv_pool"]
    assert pool["hits"] == 1 and pool["pages_used"] > 0 and pool["pages_pinned"] == 0
    assert "spec_auto" not in got["/health"]["engine"]
    for fam in POOL_FAMILIES:
        g, w = _samples(got["/metrics"], fam), _samples(want["/metrics"], fam)
        assert g and g == w, fam
    mem, jmem = got["/debug/memory"], want["/debug/memory"]
    assert mem["kv_pool"] == jmem["kv_pool"] == pool
    assert mem["fragmentation"] == jmem["fragmentation"]
    rows = {(r["component"], r["model"]): r["bytes"] for r in mem["components"]}
    jrows = {(r["component"], r["model"]): r["bytes"] for r in jmem["components"]}
    arena = {k: v for k, v in rows.items() if k[0] in ("kv_arena_used", "kv_arena_free")}
    assert arena == {k: v for k, v in jrows.items() if k[0] in ("kv_arena_used", "kv_arena_free")}
    page = pool["page_bytes"]
    assert arena[("kv_arena_used", "")] == pool["pages_used"] * page
    assert arena[("kv_arena_free", "")] == pool["pages_free"] * page
    assert got["/health"]["engine"]["kv_cache_bytes"] == eng.kv_cache_bytes \
        == want["/health"]["engine"]["kv_cache_bytes"]


def test_spill_tier_row_is_a_host_row(path, ledgers):
    """A spilled page lands in the ``host_spill`` row, listed as host bytes
    and left out of the device attribution."""
    eng = Engine(path, device="cpu", **KW, **dict(PAGED, kv_pool_pages=4))
    for i in range(3):
        eng.create_chat_completion([{"role": "user", "content": f"conversation {i} " * 40}],
                                   temperature=0.0, max_tokens=4)
    assert eng._kvpool.stats()["spills"] >= 1
    doc = ledgers[0].snapshot()
    spill = [r for r in doc["components"] if r["component"] == "host_spill"]
    assert spill and not spill[0]["device"]
    assert spill[0]["bytes"] == eng._kvpool.occupancy()["spill_pages_used"] * \
        eng._kvpool.page_nbytes
    assert doc["host_bytes"] >= spill[0]["bytes"]


@pytest.mark.parametrize("mode", ["lookup", "auto"])
def test_spec_pod_health_and_metrics_equal_the_reference(path, monkeypatch, mode):
    monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", lambda: 1e-9)
    monkeypatch.setattr(jspec_auto, "measure_dispatch_rtt_s", lambda: 1e-9)
    eng = Engine(path, device="cpu", spec_decode=mode, spec_draft=4, **KW)
    ref = JEngine(path, spec_decode=mode, spec_draft=4, **KW)
    apps = [create_app(engine=eng, settings=Settings(temperature=0.0)),
            j_create_app(engine=ref, settings=JSettings(temperature=0.0))]
    got, want = _drive(apps, lambda first: FIRST + [("assistant", "hello hello hello"),
                                                    ("user", "hello hello hello hello")])
    assert got["bodies"] == want["bodies"]
    for fam in SPEC_FAMILIES:
        g, w = _samples(got["/metrics"], fam), _samples(want["/metrics"], fam)
        assert g and g == w, fam
    auto = got["/health"]["engine"].get("spec_auto")
    if mode == "auto":
        assert auto["resolved"] == "lookup" == want["/health"]["engine"]["spec_auto"]["resolved"]
        assert set(auto) - {"hbm_gbps"} == set(want["/health"]["engine"]["spec_auto"])
    else:
        assert auto is None and "spec_auto" not in want["/health"]["engine"]
    assert got["/health"]["engine"]["kv_pool"] is None is want["/health"]["engine"]["kv_pool"]


KNOB_ENV = {"LFKT_KV_PAGED": "1", "LFKT_KV_PAGE_TOKENS": "64", "LFKT_KV_POOL_PAGES": "12",
            "LFKT_KV_SPILL_PAGES": "5", "LFKT_SPEC_DECODE": "auto", "LFKT_SPEC_DRAFT": "6"}


def test_settings_read_the_knobs_as_the_reference(monkeypatch):
    fields = ("kv_paged", "kv_page_tokens", "kv_pool_pages", "kv_spill_pages", "spec_decode",
              "spec_draft")
    for f in fields:
        assert getattr(Settings(), f) == getattr(JSettings(), f), f
    for k, v in KNOB_ENV.items():
        monkeypatch.setenv(k, v)
    got, want = get_settings(), j_get_settings()
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields} == {
        "kv_paged": True, "kv_page_tokens": 64, "kv_pool_pages": 12, "kv_spill_pages": 5,
        "spec_decode": "auto", "spec_draft": 6}
    assert KNOBS["LFKT_SPEC_AUTO_ACCEPT"].default == 1.0
    assert KNOBS["LFKT_HBM_GBPS"].default == spec_auto.HBM_GBPS_DEFAULT == 3350.0


@pytest.mark.parametrize("env,want", [
    ({"LFKT_KV_PAGED": "1", "LFKT_KV_PAGE_TOKENS": "16"}, ("paged", 16)),
    ({"LFKT_SPEC_DECODE": "lookup", "LFKT_SPEC_DRAFT": "5"}, ("spec", 5)),
    ({"LFKT_KV_PAGED": "1", "LFKT_SPEC_DECODE": "lookup"}, ("spec", 8)),
])
def test_default_factory_builds_the_mode_the_settings_name(path, monkeypatch, env, want):
    import os

    monkeypatch.setenv("LFKT_MODEL_DIR", os.path.dirname(path))
    monkeypatch.setenv("LFKT_MODEL_NAME", os.path.basename(path))
    monkeypatch.setenv("LFKT_MAX_CONTEXT_TOKENS", "256")
    monkeypatch.setenv("LFKT_PREFILL_BUCKETS", "64,128,256")
    monkeypatch.setenv("LFKT_PREFILL_CHUNK", "64")
    monkeypatch.setenv("LFKT_MAX_GEN_TOKENS", "8")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    from llama_fastapi_k8s_gpu_tpu_torch.engine import engine as engine_mod

    monkeypatch.setattr(engine_mod, "resolve_device", lambda device=None: torch.device("cpu"))
    eng = _default_engine_factory(get_settings())()
    kind, n = want
    if kind == "paged":
        assert eng._kv_paged and eng._kvpool.page_tokens == n and eng._spec_draft == 0
    else:
        assert eng._spec_enabled() and eng._spec_draft == n and not eng._kv_paged

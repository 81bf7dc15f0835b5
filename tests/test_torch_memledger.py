"""The port's memory ledger against the JAX package's.

On the tiny F16 file, both loaded bf16, the ``/debug/memory`` documents
have the same schema and the same ``weights`` and ``kv_ring`` rows; the
ground truth differs by design (the reference sums ``jax.live_arrays()``,
the port the storage of the live tensors ``gc`` tracks on the CPU and the
CUDA allocator on the card, a card test).  Registration, weak owners,
pressure and the fit check behave as the reference's; a disarmed ledger is
never touched on the decode path.
"""

from __future__ import annotations

import asyncio
import gc
import json

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.obs import memledger as jmemledger
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.obs import memledger
from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

torch.set_num_threads(1)

MSGS = [{"role": "user", "content": "Say something."}]


@pytest.fixture(scope="module")
def f16_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("memledger") / "tiny-f16.gguf")
    write_tiny_llama_gguf(path, quant=JGGMLType.F16)
    return path


@pytest.fixture
def ledgers(monkeypatch):
    """Fresh ledgers in both packages (engines register at construction)."""
    mine = memledger.MemLedger(armed=True, pressure_fraction=0.05)
    ref = jmemledger.MemLedger(armed=True, pressure_fraction=0.05)
    monkeypatch.setattr(memledger, "MEMLEDGER", mine)
    monkeypatch.setattr(jmemledger, "MEMLEDGER", ref)
    return mine, ref


async def _get(app, path):
    sent = []

    async def receive():
        return {"type": "http.request", "body": b"", "more_body": False}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": "GET", "path": path, "query_string": b"",
               "headers": [(b"host", b"t")]}, receive, send)
    return sent[0]["status"], json.loads(b"".join(m.get("body", b"") for m in sent[1:]))


def test_debug_memory_rows_and_schema_like_the_reference(f16_path, ledgers):
    eng = Engine(f16_path, n_ctx=128, weight_format="bf16", device="cpu")
    ref = JEngine(f16_path, n_ctx=128, weight_format="bf16")

    async def go():
        out = []
        for app in (create_app(engine=eng, settings=Settings()),
                    j_create_app(engine=ref, settings=JSettings())):
            await app.router.startup()
            try:
                out.append(await _get(app, "/debug/memory"))
            finally:
                await app.router.shutdown()
        return out

    (st, got), (jst, want) = asyncio.run(go())
    assert st == jst == 200
    assert set(got) == set(want) and set(got["ground_truth"]) == set(want["ground_truth"])
    assert got["components"] == want["components"]
    assert {r["component"] for r in got["components"]} == {"weights", "kv_ring"}
    assert (got["attributed_bytes"], got["host_bytes"], got["headroom"]) == (
        want["attributed_bytes"], want["host_bytes"], want["headroom"])
    assert got["ground_truth"]["source"] == "gc.live_tensors"
    assert got["residual_bytes"] >= 0
    rows = {r["component"]: r["bytes"] for r in got["components"]}
    assert rows == {"weights": eng.weight_bytes, "kv_ring": eng.kv_cache_bytes}


@pytest.mark.parametrize("name", ["weights", "kv_ring", "residual", "no_such_thing"])
def test_registration_refuses_what_the_reference_refuses(ledgers, name):
    class Owner:
        model_name = "m"

    errors = []
    for ledger in ledgers:
        try:
            ledger.register_component(name, Owner(), lambda o: 1)
            errors.append(None)
        except KeyError:
            errors.append(KeyError)
    assert errors[0] == errors[1]


def test_a_dead_owner_drops_its_rows(ledgers):
    class Owner:
        model_name = "m"

    rows = []
    for ledger in ledgers:
        o = Owner()
        ledger.register_component("weights", o, lambda own: 100)
        ledger.register_component("weights", o, lambda own: 100)    # idempotent
        before = ledger.snapshot()["components"]
        del o
        gc.collect()
        rows.append((before, ledger.snapshot()["components"]))
    assert rows[0] == rows[1]
    assert rows[0][0] == [{"component": "weights", "model": "m", "bytes": 100,
                           "device": True}] and rows[0][1] == []


@pytest.mark.parametrize("in_use,limit,fraction,est", [
    (10, 100, 0.05, 50), (96, 100, 0.05, 1), (50, 100, 0.6, 60), (0, 100, 0.05, 101),
    (10, None, 0.05, 10**12)])
def test_pressure_and_fit_check_like_the_reference(ledgers, in_use, limit, fraction, est):
    out = []
    for ledger in ledgers:
        ledger.configure(pressure_fraction=fraction)
        stats = {"bytes_in_use": in_use}
        if limit is not None:
            stats["bytes_limit"] = limit
        ledger.stats_fn = lambda s=stats: s
        doc = ledger.snapshot()
        out.append((ledger.pressure(), ledger.fit_check(est, "m") is None,
                    ledger.last_headroom, doc["headroom"], doc["residual_bytes"],
                    doc["ground_truth"]["bytes"]))
    assert out[0] == out[1]


def test_the_cpu_never_reports_pressure_and_latches(ledgers):
    mine = ledgers[0]
    assert mine.pressure() is False and mine._no_device_stats
    assert mine.fit_check(10**15) is None
    assert mine.snapshot()["ground_truth"]["source"] == "gc.live_tensors"


def test_disarmed_decode_path_is_poison_proof(ledgers, f16_path, monkeypatch):
    """``LFKT_MEM_LEDGER=0``: pressure() is one attribute read, snapshot()
    the reference's stub, and a whole generation never touches the
    ledger."""
    mine = ledgers[0]
    mine.configure(armed=False)

    def boom(*a, **kw):
        raise AssertionError("disarmed memory ledger was touched")

    for attr in ("_device_stats", "_rows", "ground_truth"):
        monkeypatch.setattr(mine, attr, boom)
    eng = Engine(f16_path, n_ctx=128, weight_format="bf16", device="cpu")
    out = eng.create_chat_completion(MSGS, temperature=0.0, max_tokens=8)
    assert out["usage"]["completion_tokens"] >= 1
    assert mine.pressure() is False
    assert mine.snapshot() == ledgers[1].__class__(armed=False).snapshot() == \
        {"schema": 1, "armed": False}

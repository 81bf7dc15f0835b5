"""The port's incident flight recorder against the JAX package's.

Every bundle the port writes passes the JAX package's ``validate_bundle``
(and the port's); the same recorder calls give the same ring, ids,
debounce and listing on both; the trigger points (a watchdog trip, a DEAD
escalation, an out-of-memory error on the heartbeat) record the
reference's kinds; one trip of the real CPU engine's watchdog leaves
exactly one bundle holding the trace in flight at the trip; and a
disarmed recorder is never touched.  The port's out-of-memory signature
is the card's ``CUDA out of memory`` (the reference's: XLA's
``RESOURCE_EXHAUSTED``), the kind the same.
"""

from __future__ import annotations

import logging
import os
import time

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.obs import flightrec as jflightrec
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.engine.watchdog import Watchdog
from llama_fastapi_k8s_gpu_tpu_torch.obs import flightrec, trace
from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS, SimulatedOOM
from llama_fastapi_k8s_gpu_tpu_torch.utils.health import (
    DEAD,
    DEGRADED,
    READY,
    Heartbeat,
    HealthMonitor,
)
from llama_fastapi_k8s_gpu_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

MSGS = [{"role": "user", "content": "Say something."}]


@pytest.fixture
def recorders(tmp_path, monkeypatch):
    """Fresh armed recorders of both packages on their own ring
    directories; the port's installed as the process recorder (the
    trigger points resolve it at call time)."""
    mine = flightrec.FlightRecorder(directory=str(tmp_path / "mine"), ring=8,
                                    debounce_s=0.0, log_lines=50)
    ref = jflightrec.FlightRecorder(directory=str(tmp_path / "ref"), ring=8,
                                    debounce_s=0.0, log_lines=50)
    monkeypatch.setattr(flightrec, "FLIGHTREC", mine)
    yield mine, ref
    for rec in (mine, ref):
        rec.configure(directory="")          # detaches the log handler


@pytest.fixture(autouse=True)
def _disarm_faults():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def _bundles(rec) -> list[dict]:
    return [rec.get(s["id"]) for s in rec.list()]


def _valid(doc) -> bool:
    return flightrec.validate_bundle(doc) == [] == jflightrec.validate_bundle(doc)


def _ring(rec):
    rec.configure(ring=2, debounce_s=60.0)
    out = [rec.record(kind, f"r{i}") for i, kind in enumerate(
        ("watchdog_trip", "watchdog_trip", "slo_breach", "resource_exhausted",
         "made_up_kind"))]
    return out, sorted(os.listdir(rec._dir)), rec.recorded_total, rec.debounced_total


def _restart(rec):
    rec.record("watchdog_trip", "before")
    rec.configure(directory=rec._dir)        # a restarted process re-arms
    return rec.record("dead_escalation", "after")


def _tmp_files(rec):
    stray = os.path.join(rec._dir, ".tmp-inc-000009-slo_breach.json")
    rec.record("watchdog_trip", "first")
    open(stray, "w").close()
    rec.configure(directory=rec._dir)
    kept = os.path.exists(stray)
    rec.record("slo_breach", "sweeps")
    return kept, os.path.exists(stray)


def _ids(rec):
    rid = rec.record("watchdog_trip", "r", extra={"k": "v"})
    doc = rec.get(rid)
    return (rid, rec.get("../../etc/passwd"), rec.get("inc-zzz-nope"),
            {k: doc[k] for k in ("schema", "id", "kind", "reason", "extra", "fleet")},
            [{k: v for k, v in s.items() if k != "at"} for s in rec.list()])


@pytest.mark.parametrize("scenario", [_ring, _restart, _tmp_files, _ids])
def test_recorder_like_the_reference(recorders, scenario):
    mine, ref = recorders
    assert scenario(mine) == scenario(ref)
    assert all(_valid(doc) for doc in _bundles(mine))


def test_bundle_schema_is_the_references(recorders):
    mine, ref = recorders
    logging.getLogger("lfkt.test").warning("breadcrumb %d", 42)
    docs = [r.get(r.record("watchdog_trip", "r")) for r in (mine, ref)]
    assert set(docs[0]) == set(docs[1])
    assert _valid(docs[0])
    assert any("breadcrumb 42" in line["message"] for line in docs[0]["log_tail"])
    assert set(docs[0]["memory"]) == set(docs[1]["memory"])
    assert flightrec.KINDS == jflightrec.KINDS and flightrec.SCHEMA == jflightrec.SCHEMA


class _FakeEngine:
    heartbeat = None

    def recover(self):
        return True


def test_watchdog_trip_and_dead_escalation_record(recorders):
    mine, _ = recorders
    health = HealthMonitor()
    health.transition(READY, "up")
    wd = Watchdog(_FakeEngine(), health, Metrics(), poll_seconds=10.0,
                  backoff_seconds=0.01, max_recoveries=1)
    wd.handle_trip("stalled_decode: drill")
    trips = [d for d in _bundles(mine) if d["kind"] == "watchdog_trip"]
    assert len(trips) == 1 and "stalled_decode" in trips[0]["reason"]
    assert trips[0]["extra"]["watchdog"]["trips"] == 1
    assert trips[0]["health"]["state"] == DEGRADED
    wd.handle_trip("stalled_decode: again")
    kinds = [d["kind"] for d in _bundles(mine)]
    assert kinds.count("dead_escalation") == 1 and health.state == DEAD
    assert all(_valid(d) for d in _bundles(mine))


def test_heartbeat_records_the_cards_oom_signature(recorders):
    mine, _ = recorders
    hb = Heartbeat()
    hb.record_error(ValueError("ordinary bug"))
    hb.record_error(RuntimeError("RESOURCE_EXHAUSTED: the TPU's, not the card's"))
    assert mine.recorded_total == 0
    hb.record_error(SimulatedOOM("CUDA out of memory: simulated"))
    docs = _bundles(mine)
    assert [d["kind"] for d in docs] == ["resource_exhausted"]
    assert "CUDA out of memory" in docs[0]["reason"] and _valid(docs[0])


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("flightrec") / "tiny.gguf")
    write_tiny_llama_gguf(path)
    return path


def test_one_trip_one_bundle_with_the_inflight_trace(recorders, model_path):
    """Three injected decode faults trip the real CPU engine's watchdog
    once: exactly one bundle, valid for both packages, holding the trace
    in flight at the trip, the memory ledger and the health trail; the
    engine recovers and serves."""
    mine, _ = recorders
    mine.configure(debounce_s=30.0)
    eng = Engine(model_path, n_ctx=128, decode_chunk=4, max_gen_tokens=16,
                 prefill_buckets=(32, 64, 128), device="cpu")
    health = HealthMonitor()
    health.transition(READY, "up")
    tracer = trace.Tracer(sample=1.0, ring=8)
    inflight = tracer.start("request")
    FAULTS.arm("decode_step:error:times=3")
    for _ in range(3):
        with pytest.raises(Exception):
            eng.create_chat_completion(MSGS, temperature=0.0, max_tokens=9)
    FAULTS.disarm()
    wd = Watchdog(eng, health, Metrics(), poll_seconds=0.02, backoff_seconds=0.01,
                  error_burst=3)
    wd.start()
    try:
        t0 = time.time()
        while not (wd.recoveries and health.state == READY) and time.time() - t0 < 30:
            time.sleep(0.01)
    finally:
        wd.stop()
    tracer.finish(inflight)
    docs = _bundles(mine)
    assert [d["kind"] for d in docs] == ["watchdog_trip"] and wd.trips == 1
    doc = docs[0]
    assert _valid(doc) and "exception_burst" in doc["reason"]
    assert inflight.trace_id in [t["trace_id"] for t in doc["traces"]]
    assert {r["component"] for r in doc["memory"]["components"]} >= {"weights", "kv_ring"}
    assert DEGRADED in [t["to"] for t in doc["health"]["transitions"]]
    assert eng.create_chat_completion(MSGS, temperature=0.0, max_tokens=4)["usage"][
        "completion_tokens"] >= 1


def test_disarmed_recorder_is_poison_proof(monkeypatch):
    """No ``LFKT_INCIDENT_DIR``: ``record()`` is one attribute read, every
    trigger point goes through it, and no log handler is installed."""
    rec = flightrec.FlightRecorder(directory="", ring=8, debounce_s=0.0, log_lines=10)
    assert rec.armed is False

    def boom(*a, **kw):
        raise AssertionError("disarmed flight recorder was touched")

    for attr in ("_capture", "_write", "_list_files"):
        monkeypatch.setattr(rec, attr, boom)
    monkeypatch.setattr(flightrec, "FLIGHTREC", rec)
    assert rec.record("watchdog_trip", "r") is None
    Heartbeat().record_error(SimulatedOOM("CUDA out of memory: simulated"))
    health = HealthMonitor()
    health.transition(READY, "up")
    Watchdog(_FakeEngine(), health, Metrics(), poll_seconds=10.0,
             backoff_seconds=0.0, max_recoveries=0).handle_trip("stalled_decode: drill")
    assert rec.recorded_total == 0 and rec._log_handler is None

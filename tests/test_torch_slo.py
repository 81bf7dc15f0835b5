"""The port's SLO engine against the JAX package's.

The same observations at the same fixed ``now`` give the same
``evaluate()`` document from both engines, window by window — burn rates,
the truncated-window rule (a fresh pod can warn but never breach), the
worst series, the recompile-storm fold-in — and ``export()`` renders the
same ``slo_burn_rate`` gauges.  A confirmed breach records one
``slo_breach`` incident per episode.
"""

from __future__ import annotations

import time

import pytest

from llama_fastapi_k8s_gpu_tpu.obs import devtime as jdevtime
from llama_fastapi_k8s_gpu_tpu.obs import slo as jslo
from llama_fastapi_k8s_gpu_tpu.utils import metrics as jmetrics
from llama_fastapi_k8s_gpu_tpu_torch.obs import devtime, flightrec, slo
from llama_fastapi_k8s_gpu_tpu_torch.utils import metrics

T0 = 1_800_000_000.0


def _feed(m, kind: str, i: int) -> None:
    """One scrape interval's traffic of a scenario."""
    ok = {"route": "/response", "code": "200"}
    if kind in ("healthy", "errors", "slow", "mixed"):
        for j in range(10):
            m.inc("http_requests_total", **ok)
            m.observe("queue_wait_seconds", 0.01 * j)
            ttft = 2.5 if kind == "slow" and j % 2 else 0.05
            m.observe("engine_ttft_seconds", ttft, bucket="128", model="tiny")
            m.observe("engine_ttft_seconds", 0.3, bucket="1024", model="tiny")
            m.observe("engine_decode_tokens_per_sec", 5.0 if kind == "mixed" else 120.0,
                      model="tiny")
        m.inc("http_requests_total", 3, route="/metrics", code="200")
    if kind in ("errors", "mixed"):
        m.inc("http_requests_total", 2, route="/response", code="500")
        m.inc("http_requests_total", 1, route="/v1/chat/completions", code="503")
        m.inc("http_requests_total", 4, route="/debug/slo", code="500")


SCENARIOS = ("quiet", "healthy", "errors", "slow", "mixed")
#: (seconds after T0 of each evaluation) — a fresh pod, then past both windows
TIMELINES = {"fresh": (0.0, 30.0, 200.0), "aged": (0.0, 400.0, 2000.0, 4000.0, 4100.0)}


@pytest.mark.parametrize("timeline", sorted(TIMELINES))
@pytest.mark.parametrize("kind", SCENARIOS)
@pytest.mark.parametrize("storm", [False, True])
def test_evaluate_like_the_reference(kind, timeline, storm, monkeypatch):
    monkeypatch.setattr(flightrec.FLIGHTREC, "armed", False)
    regs = []
    for mod in (devtime, jdevtime):
        reg = mod.DevtimeRegistry(armed=True, budget=1)
        if storm:
            reg.record_compile("decode_chunk", "top_k=40", 0.1)
            reg.record_compile("decode_chunk", "top_k=5", 0.1)
        regs.append(reg)
    ms = (metrics.Metrics(), jmetrics.Metrics())
    engines = (slo.SLOEngine(ms[0], devtime=regs[0]), jslo.SLOEngine(ms[1], devtime=regs[1]))
    for i, dt in enumerate(TIMELINES[timeline]):
        for m in ms:
            _feed(m, kind, i)
        docs = [e.export(now=T0 + dt) for e in engines]
        assert docs[0] == docs[1], (kind, timeline, dt)
        assert ms[0].render() == ms[1].render()
    if timeline == "fresh":
        assert docs[0]["verdict"] != "breach"


@pytest.mark.parametrize("env", [{}, {"LFKT_SLO_TTFT_P95_S": "0.2", "LFKT_SLO_ERROR_RATE": "0.5",
                                      "LFKT_SLO_WINDOWS": "60,600,6000"}])
def test_knobs_like_the_reference(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    a = slo.SLOEngine(metrics.Metrics())
    b = jslo.SLOEngine(jmetrics.Metrics())
    assert (a.windows, a.thresholds) == (b.windows, b.thresholds)


def test_a_breach_records_one_incident_an_episode(tmp_path, monkeypatch):
    rec = flightrec.FlightRecorder(directory=str(tmp_path), ring=8, debounce_s=0.0,
                                   log_lines=10)
    monkeypatch.setattr(flightrec, "FLIGHTREC", rec)
    try:
        m = metrics.Metrics()
        eng = slo.SLOEngine(m, windows=[60.0, 600.0], devtime=devtime.DevtimeRegistry(True, 32))
        eng.evaluate(now=T0)
        for dt in (700.0, 710.0, 720.0):
            m.inc("http_requests_total", 10, route="/response", code="500")
            assert eng.evaluate(now=T0 + dt)["verdict"] == "breach"
        deadline = time.time() + 10
        while not rec.list() and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        kinds = [s["kind"] for s in rec.list()]
        assert kinds == ["slo_breach"]
        doc = rec.get(rec.list()[0]["id"])
        assert flightrec.validate_bundle(doc) == [] and doc["extra"]["slo"]["verdict"] == "breach"
    finally:
        rec.configure(directory="")

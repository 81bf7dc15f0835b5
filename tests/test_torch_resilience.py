"""The port's resilience layer against the JAX package's.

Both packages' ``HealthMonitor`` and ``FaultInjector`` walk the same inputs
to the same results (timestamps masked); the port's ``Watchdog`` runs the
reference suite's cases (tests/test_resilience.py) against the minimal
engine contract; and the port's real CPU ``Engine`` takes a burst of
``decode_step`` faults behind its app — three 500s, one trip, READY again,
the ring's storage untouched and the greedy reply unchanged.
"""

from __future__ import annotations

import asyncio
import json
import time

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils import faults as jfaults
from llama_fastapi_k8s_gpu_tpu.utils import health as jhealth
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.engine.watchdog import Watchdog
from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
from llama_fastapi_k8s_gpu_tpu_torch.utils import faults, health
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings
from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS, FaultError, SimulatedOOM
from llama_fastapi_k8s_gpu_tpu_torch.utils.health import (
    DEAD,
    DEGRADED,
    READY,
    EngineUnavailable,
    Heartbeat,
    HealthMonitor,
)
from llama_fastapi_k8s_gpu_tpu_torch.utils.metrics import Metrics

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


@pytest.fixture(autouse=True)
def _disarm_faults():
    FAULTS.disarm()
    jfaults.FAULTS.disarm()
    yield
    FAULTS.disarm()
    jfaults.FAULTS.disarm()


# ---------------------------------------------------------------------------
# the state machine and the injector, side by side
# ---------------------------------------------------------------------------

TRANSITIONS = [
    ("READY", "engine loaded"), ("READY", "engine loaded"), ("DEGRADED", "trip"),
    ("READY", "recovered"), ("DRAINING", "sigterm"), ("READY", "no"),
    ("DEGRADED", "no"), ("DRAINING", "again"), ("DEAD", "drain escalated"),
    ("READY", "necromancy"), ("DEAD", "still dead"), ("STARTING", "no"), ("ZOMBIE", "x"),
]


def _walk(mod, steps):
    h = mod.HealthMonitor()
    out = [(h.state, h.ready(), h.alive())]
    for state, reason in steps:
        try:
            ok = h.transition(state, reason)
        except ValueError as e:
            ok = f"ValueError: {e}"
        out.append((ok, h.state, h.ready(), h.alive()))
    snap = h.snapshot()
    snap.pop("since")
    for t in snap["transitions"]:
        t.pop("at")
    return out, snap


@pytest.mark.parametrize("start", range(0, 10, 3))
def test_health_monitor_walks_like_the_reference(start):
    """The same transitions from several starting points: the same answers,
    states, probe verdicts and transition log; DEAD is terminal, DRAINING
    yields only to DEAD."""
    steps = TRANSITIONS[start:] + TRANSITIONS[:start]
    assert _walk(health, steps) == _walk(jhealth, steps)
    assert health.STATE_CODES == jhealth.STATE_CODES


def test_probe_semantics():
    h = HealthMonitor()
    assert not h.ready() and h.alive()
    h.transition(READY, "up")
    h.transition(DEGRADED, "trip")
    assert not h.ready() and h.alive()          # degraded: shed, don't kill
    h.transition(DEAD, "budget")
    assert not h.ready() and not h.alive()


SPECS = [
    "decode_step:error", "decode_step:error:after=2:times=1", "prefill:oom",
    "load:slow:delay=0.01", "recover:error:times=0", " decode_step:error , prefill:oom ",
    "decode_step", "decode_step:explode", "nonsense:error", "decode_step:error:bogus=1",
    "decode_step:error:times=", "decode_step:error:after=x", "",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_and_refusals_like_the_reference(spec):
    """The same specs are accepted or refused alike, with the same message;
    an armed spec fires on the same hits."""
    results = []
    for mod in (faults, jfaults):
        inj = mod.FaultInjector()
        try:
            inj.arm(spec)
        except ValueError as e:
            results.append(("refused", str(e).split(" (valid:")[0]))
            continue
        hits = []
        for point in ("decode_step", "prefill", "load", "recover") * 3:
            try:
                inj.fire(point)
                hits.append(None)
            except (mod.SimulatedOOM, mod.FaultError) as e:
                hits.append((point, type(e).__name__))
        results.append(("armed", hits, inj.stats(), inj.armed()))
    assert results[0] == results[1]


def test_faults_inert_by_default_and_oom_is_a_torch_oom():
    inj = faults.FaultInjector()
    for _ in range(100):
        inj.fire("decode_step")
    assert not inj.armed()
    inj.arm("load:oom")
    with pytest.raises(torch.OutOfMemoryError, match="out of memory"):
        inj.fire("load")
    assert issubclass(SimulatedOOM, FaultError)
    inj.arm("prefill:slow:delay=0.1:times=1")
    t0 = time.monotonic()
    inj.fire("prefill")
    assert time.monotonic() - t0 >= 0.1


def test_faults_armed_from_the_environment(monkeypatch):
    monkeypatch.setenv("LFKT_FAULTS", "decode_step:error:after=1")
    inj = faults.FaultInjector.from_env()
    inj.fire("decode_step")
    with pytest.raises(FaultError):
        inj.fire("decode_step")
    monkeypatch.delenv("LFKT_FAULTS")
    assert not faults.FaultInjector.from_env().armed()


def test_heartbeat_like_the_reference():
    out = []
    for mod in (health, jhealth):
        hb = mod.Heartbeat()
        hb.enter()
        hb.beat()
        for _ in range(3):
            hb.record_error(RuntimeError("step blew up"))
        row = [hb.busy_count(), hb.beats_total, hb.errors_total, hb.last_error,
               hb.error_burst(3, 5.0), hb.error_burst(4, 5.0)]
        hb.clear_errors()
        row += [hb.error_burst(1, 5.0), hb.errors_total]
        hb.leave()
        hb.leave()
        row.append(hb.busy_count())
        out.append(row)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the watchdog against the minimal engine contract (the reference's cases)
# ---------------------------------------------------------------------------

class _ContractEngine:
    """Smallest thing the watchdog can supervise."""

    def __init__(self, recover_ok=True):
        self.heartbeat = Heartbeat()
        self.recover_ok = recover_ok
        self.recoveries = 0
        self.failed: list = []

    def recover(self):
        self.recoveries += 1
        return self.recover_ok

    def fail_inflight(self, exc):
        self.failed.append(exc)


def _wait(pred, timeout=5.0, what=""):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _ready():
    h = HealthMonitor()
    h.transition(READY, "up")
    return h


def test_watchdog_trips_on_stall_and_recovers():
    eng, h, m = _ContractEngine(), _ready(), Metrics()
    wd = Watchdog(eng, h, m, stall_seconds=0.05, poll_seconds=0.02,
                  backoff_seconds=0.01, max_recoveries=5).start()
    try:
        eng.heartbeat.enter()
        time.sleep(0.06)
        _wait(lambda: wd.recoveries >= 1 and h.state == READY, what="stall trip + recovery")
        assert eng.recoveries >= 1
        assert eng.failed and isinstance(eng.failed[0], EngineUnavailable)
        assert "stalled_decode" in wd.last_trip_reason
        trail = [t["to"] for t in h.snapshot()["transitions"]]
        assert DEGRADED in trail and trail[-1] == READY
        assert "watchdog_trips_total" in m.render()
        assert "watchdog_recoveries_total" in m.render()
    finally:
        wd.stop()


def test_watchdog_trips_on_error_burst():
    eng, h = _ContractEngine(), _ready()
    wd = Watchdog(eng, h, Metrics(), poll_seconds=0.02, error_burst=3,
                  error_window=5.0, backoff_seconds=0.01)
    try:
        for _ in range(3):
            eng.heartbeat.record_error(RuntimeError("step blew up"))
        reason = wd.check()
        assert reason is not None and "exception_burst" in reason
        wd.handle_trip(reason)
        assert h.state == READY and eng.recoveries == 1
    finally:
        wd.stop()


def test_watchdog_burst_on_busy_engine_recovers_in_place():
    eng, h = _ContractEngine(recover_ok=False), _ready()
    wd = Watchdog(eng, h, Metrics(), poll_seconds=0.02, error_burst=3,
                  error_window=30.0, backoff_seconds=0.01, max_recoveries=2)
    try:
        for _ in range(3):
            eng.heartbeat.record_error(RuntimeError("transient device error"))
        reason = wd.check()
        assert reason is not None and "exception_burst" in reason
        wd.handle_trip(reason)
        assert h.state == READY and wd.recoveries == 1
        assert wd.check() is None             # evidence consumed: no re-trip
    finally:
        wd.stop()


def test_watchdog_escalates_to_dead_when_recovery_fails():
    eng, h = _ContractEngine(recover_ok=False), _ready()
    wd = Watchdog(eng, h, Metrics(), stall_seconds=0.03, poll_seconds=0.02,
                  backoff_seconds=0.01, max_recoveries=2).start()
    try:
        eng.heartbeat.enter()       # permanent wedge, recovery always fails
        _wait(lambda: h.state == DEAD, what="escalation to DEAD")
        assert not h.alive()
        assert wd.trips == 3        # 2 failed recoveries + the fatal trip
        assert "max_recoveries_exceeded" in h.snapshot()["reason"]
    finally:
        wd.stop()


def test_watchdog_forgets_trips_after_healthy_window():
    eng, h = _ContractEngine(), _ready()
    wd = Watchdog(eng, h, Metrics(), stall_seconds=0.05, poll_seconds=0.02,
                  backoff_seconds=0.01, max_recoveries=1, trip_forget_seconds=0.2).start()
    try:
        for incident in range(3):
            eng.heartbeat.enter()
            time.sleep(0.06)
            _wait(lambda: h.state == READY and eng.heartbeat.busy_count() == 0,
                  what=f"recovery from incident {incident}")
            _wait(lambda: wd.trips_window == 0, timeout=5,
                  what=f"trip window forgotten after incident {incident}")
        assert h.state == READY
        assert wd.trips == 3 and wd.recoveries == 3
    finally:
        wd.stop()


def test_watchdog_backoff_doubles_per_trip_in_the_window():
    eng, h = _ContractEngine(recover_ok=False), _ready()
    wd = Watchdog(eng, h, Metrics(), stall_seconds=0.0, backoff_seconds=0.05,
                  backoff_max=0.15, max_recoveries=5)
    eng.heartbeat.enter()
    took = []
    for _ in range(3):
        t0 = time.monotonic()
        wd.handle_trip(wd.check())
        took.append(time.monotonic() - t0)
    assert took[0] >= 0.05 and took[1] >= 0.1 and took[2] >= 0.15
    assert took[2] < 0.15 + 0.1            # capped at backoff_max
    assert h.state == DEGRADED and wd.trips_window == 3


# ---------------------------------------------------------------------------
# the real CPU engine behind its app
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("res") / "tiny-q8_0.gguf")
    write_tiny_llama_gguf(path)
    return path


async def call(app, method, path, body=None):
    data = b"" if body is None else json.dumps(body).encode()
    inbox = [{"type": "http.request", "body": data, "more_body": False}]
    sent = []

    async def receive():
        return inbox.pop(0) if inbox else {"type": "http.disconnect"}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": method, "path": path, "query_string": b"",
               "headers": [(b"host", b"test")]}, receive, send)
    return sent[0]["status"], b"".join(m.get("body", b"") for m in sent[1:])


def _drill_settings(**kw):
    return Settings(temperature=0.0, watchdog_error_burst=3, watchdog_poll_seconds=0.02,
                    watchdog_backoff_seconds=0.02, **kw)


async def _until(pred, timeout=10.0):
    t0 = time.time()
    while not pred():
        assert time.time() - t0 < timeout, "timed out"
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("mode", ["error", "oom"])
def test_decode_step_burst_trips_and_recovers_in_place(tiny, mode):
    """Three ``decode_step`` faults: three 500s, one trip (READY →
    DEGRADED → READY, ``/health/ready`` 503 while degraded), one recovery
    that zeroed the ring in place — every leaf's storage unchanged — and
    the greedy reply after it equal to the one before it byte for byte."""
    eng = Engine(tiny, n_ctx=1024, max_gen_tokens=24, decode_chunk=4, device="cpu")
    app = create_app(engine=eng, settings=_drill_settings())
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}

    async def go(apps):
        app = apps[0]
        before = await call(app, "POST", "/response", BODY)
        FAULTS.arm(f"decode_step:{mode}:times=3")
        failed = [await call(app, "POST", "/response", BODY) for _ in range(3)]
        wd = app.state.watchdog
        await _until(lambda: wd.recoveries == 1 and app.state.health.state == READY)
        FAULTS.disarm()
        ready = await call(app, "GET", "/health/ready")
        after = await call(app, "POST", "/response", BODY)
        doc = json.loads((await call(app, "GET", "/health"))[1])
        return before, failed, ready, after, doc, wd.trips

    before, failed, ready, after, doc, trips = serve_one(app, go)
    assert before[0] == 200 and json.loads(before[1])["response"]
    for status, body in failed:
        assert status == 500
        assert json.loads(body)["detail"].startswith("Error during message generation")
    assert trips == 1
    trail = [t["to"] for t in doc["resilience"]["health"]["transitions"]]
    assert trail == ["STARTING", READY, DEGRADED, READY]
    assert ready[0] == 200
    assert after == before
    assert {k: v.data_ptr() for k, v in eng._cache.items()} == ptrs
    assert doc["resilience"]["watchdog"]["recoveries"] == 1
    assert doc["resilience"]["engine_errors"]["total"] == 3
    want = "SimulatedOOM" if mode == "oom" else "FaultError"
    assert doc["resilience"]["engine_errors"]["last"].startswith(want)


def serve_one(app, fn):
    async def main():
        await app.router.startup()
        try:
            return await fn([app])
        finally:
            await app.router.shutdown()
    return asyncio.run(main())


def test_recover_zeroes_the_ring_in_place(tiny):
    eng = Engine(tiny, n_ctx=256, max_gen_tokens=8, prefill_buckets=(64, 128, 256),
                 device="cpu")
    msgs = [{"role": "user", "content": "hello there, how are you today?"}]
    first = eng.create_chat_completion(msgs, temperature=0.0)
    assert any(bool(v.any()) for v in eng._cache.values())
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}
    assert eng.recover() is True
    assert all(not bool(v.any()) for v in eng._cache.values())
    assert {k: v.data_ptr() for k, v in eng._cache.items()} == ptrs
    assert eng._prefix_ids == [] and eng.heartbeat.busy_count() == 0
    again = eng.create_chat_completion(msgs, temperature=0.0)
    assert again["choices"] == first["choices"]


def test_recover_refuses_while_a_generation_holds_the_lock(tiny):
    eng = Engine(tiny, n_ctx=256, max_gen_tokens=8, prefill_buckets=(64, 128, 256),
                 device="cpu")
    with eng._lock:
        assert eng.recover() is False


def test_poisoned_context_refuses_and_walks_to_dead(tiny, monkeypatch):
    """A sticky CUDA error found by recover(): recover() is False, the
    engine's failure() names it (so the watchdog does not re-ready in
    place), every request gets a 503, and the pod walks to DEAD —
    ``/health/live`` 503."""
    eng = Engine(tiny, n_ctx=256, max_gen_tokens=8, prefill_buckets=(64, 128, 256),
                 device="cpu")

    def sticky(device=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", sticky)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    assert eng.recover() is False
    assert "illegal memory access" in str(eng.failure())
    monkeypatch.setattr(eng, "device", torch.device("cpu"))
    with pytest.raises(EngineUnavailable, match="poisoned"):
        eng.create_chat_completion([{"role": "user", "content": "hi"}])
    app = create_app(engine=eng, settings=Settings(
        temperature=0.0, watchdog_poll_seconds=0.02, watchdog_backoff_seconds=0.01,
        watchdog_max_recoveries=2))

    async def go(apps):
        app = apps[0]
        resp = await call(app, "POST", "/response", BODY)
        await _until(lambda: app.state.health.state == DEAD)
        return resp, await call(app, "GET", "/health/live"), \
            await call(app, "GET", "/health/ready")

    resp, live, ready = serve_one(app, go)
    assert resp[0] == 503 and "poisoned" in json.loads(resp[1])["detail"]
    assert live[0] == 503 and json.loads(live[1]) == {
        "alive": False, "state": DEAD, "reason": json.loads(live[1])["reason"]}
    assert "engine_failed" in json.loads(live[1])["reason"]
    assert ready[0] == 503


def test_probes_in_degraded_and_dead():
    """``/health/ready`` is 503 in DEGRADED with ``/health/live`` 200; in
    DEAD both are 503."""
    class Quiet:
        model_name = "quiet"

        def create_chat_completion(self, messages, **kw):
            return {"choices": [{"message": {"role": "assistant", "content": "ok"}}]}

    app = create_app(engine=Quiet(), settings=Settings())

    async def go(apps):
        app = apps[0]
        out = []
        for state in (DEGRADED, DEAD):
            app.state.health.transition(state, "drill")
            out.append((await call(app, "GET", "/health/ready"),
                        await call(app, "GET", "/health/live")))
        return out

    (deg_ready, deg_live), (dead_ready, dead_live) = serve_one(app, go)
    assert deg_ready[0] == 503 and deg_live[0] == 200
    assert json.loads(deg_live[1])["alive"] is True
    assert dead_ready[0] == 503 and dead_live[0] == 503


def test_client_errors_do_not_count_toward_a_burst(tiny):
    eng = Engine(tiny, n_ctx=128, max_gen_tokens=4, prefill_buckets=(64, 128),
                 device="cpu")
    long = [{"role": "user", "content": "cats and dogs " * 200}]
    for _ in range(6):
        with pytest.raises(ValueError, match="exceed context window"):
            eng.create_chat_completion(long)
    assert eng.heartbeat.errors_total == 0 and eng.heartbeat.busy_count() == 0


def test_drain_stops_the_watchdog_before_the_shutdown_hook():
    """SIGTERM's drain (here: the stop event) moves the pod to DRAINING and
    runs the drain hook of ``python -m ...server``, which stops the
    watchdog; a trip can then no longer touch a draining pod."""
    import threading

    from llama_fastapi_k8s_gpu_tpu_torch.server import httpd
    from llama_fastapi_k8s_gpu_tpu_torch.server.__main__ import stop_watchdog

    eng = _ContractEngine()
    eng.model_name = "contract"
    eng.create_chat_completion = lambda messages, **kw: {
        "choices": [{"message": {"role": "assistant", "content": "ok"}}]}
    app = create_app(engine=eng, settings=Settings(watchdog_poll_seconds=0.02))
    seen = {}

    def hook():
        seen["state"] = app.state.health.state
        seen["alive_before"] = app.state.watchdog._thread.is_alive()
        stop_watchdog(app)
        seen["alive_after"] = app.state.watchdog._thread.is_alive()

    loop = asyncio.new_event_loop()
    up, stop = asyncio.Event(), asyncio.Event()
    th = threading.Thread(target=loop.run_until_complete, daemon=True, args=(
        httpd.serve(app, "127.0.0.1", 0, up, stop, on_drain=hook),))
    th.start()
    _wait(up.is_set, what="httpd up")
    loop.call_soon_threadsafe(stop.set)
    th.join(10)
    loop.close()
    assert not th.is_alive()
    assert seen == {"state": "DRAINING", "alive_before": True, "alive_after": False}
    assert app.state.watchdog is None            # the shutdown hook ran too

"""Fault drill: arm one injection point against a live server over a real
engine and assert the /health state transitions — the resilience layer's
smoke test.

A server (the in-tree httpd) is started on a free localhost port over the
port's serial ``Engine`` with a fast-tuned watchdog, the ``decode_step``
injection point (utils/faults.py) is armed for an exception burst, traffic
is driven until the watchdog trips, and the drill asserts the documented
lifecycle (the JAX package's tools/fault_drill.py, the RUNBOOK's
"Degraded-mode operations")::

    READY  →  (burst)  →  DEGRADED: readiness 503 + liveness 200
           →  (bounded recovery)  →  READY, watchdog counters in /metrics

The engine is real, so recovery zeroes its KV ring in place under the
captured decode graphs (on the card): the drill holds the reply after the
recovery to the baseline reply before the burst, byte for byte (greedy).

Exit code 0 = drill passed.  Usage::

    # the tiny model (written with the port's GGUF writer), on the CPU
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.fault_drill --device cpu

    # a model file, on the card
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.fault_drill \\
        --model-dir /models --model-name model.gguf

Without ``--device cpu`` the engine runs on the card, and the drill fails
when there is none.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

BURST = 3
PAYLOAD = json.dumps({
    "bot_profile": {"name": "Drill", "appearance": "a,b,c,d",
                    "system_prompt": "You are terse."},
    "user_profile": {"name": "Op"},
    "context": [{"turn": "user", "message": "hi"}],
}).encode()


def _get(port: int, path: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get_text(port: int, path: str) -> str:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read().decode()


def _post(port: int) -> tuple[int, str | None]:
    """(status, the reply's text on a 200)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/response", data=PAYLOAD,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())["response"]
    except urllib.error.HTTPError as e:
        return e.code, None
    except (OSError, ValueError):  # connection-level failure
        return -1, None


def _wait_for(predicate, timeout: float, what: str):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"drill timed out waiting for: {what}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_engine(path: str, device: str | None):
    """The port's serial engine over ``path``, warmed up (its decode graphs
    captured on the card)."""
    from ..engine import Engine
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    engine = Engine(path, device=dev, n_ctx=512, prefill_buckets=(64, 128, 256),
                    max_gen_tokens=8, decode_chunk=4)
    engine.warmup()
    return engine


def drill(engine) -> int:
    from ..server import httpd
    from ..server.app import create_app
    from ..utils.config import Settings
    from ..utils.faults import FAULTS

    port = _free_port()
    settings = Settings(
        watchdog=True,
        watchdog_poll_seconds=0.05,
        watchdog_error_burst=BURST,
        watchdog_error_window=10.0,
        # 0.5 s recovery backoff: the DEGRADED window is wide enough for
        # the drill to observe readiness-503 deterministically
        watchdog_backoff_seconds=0.5,
        watchdog_max_recoveries=5,
        timeout_seconds=30.0,
        max_context_tokens=512,
        max_gen_tokens=8,
        temperature=0.0,
    )
    app = create_app(engine=engine, settings=settings)

    holder: dict = {}
    ready = threading.Event()

    async def serve():
        holder["loop"] = asyncio.get_running_loop()
        holder["stop"] = asyncio.Event()
        r = asyncio.Event()
        task = asyncio.create_task(httpd.serve(
            app, "127.0.0.1", port, ready_event=r,
            stop_event=holder["stop"], drain_seconds=5))
        await r.wait()
        ready.set()
        await task

    th = threading.Thread(target=lambda: asyncio.run(serve()), daemon=True)
    th.start()
    if not ready.wait(60):
        raise AssertionError("server never became ready")
    observed: list[str] = []

    try:
        # -- phase 0: healthy baseline --------------------------------------
        code, body = _get(port, "/health/ready")
        assert code == 200 and body["state"] == "READY", (code, body)
        code, _ = _get(port, "/health/live")
        assert code == 200
        code, baseline = _post(port)
        assert code == 200 and baseline, (code, baseline)
        observed.append("READY")
        print(f"[drill] baseline READY on :{port}, request served")

        # -- phase 1: arm the injection point and force an exception burst --
        FAULTS.arm(f"decode_step:error:times={BURST}")
        print(f"[drill] armed decode_step:error:times={BURST}")
        for i in range(BURST):
            code, _ = _post(port)
            assert code in (500, 503), f"burst request {i} got {code}"
        # the watchdog (poll 50 ms) must trip; the 0.5 s recovery backoff
        # keeps the DEGRADED window open long enough to probe it
        _wait_for(lambda: app.state.watchdog is not None
                  and app.state.watchdog.trips >= 1, 5, "watchdog trip")
        code, body = _get(port, "/health/ready")
        assert code == 503, f"readiness must shed in DEGRADED, got {code}"
        assert body["state"] == "DEGRADED", body
        code, _ = _get(port, "/health/live")
        assert code == 200, "liveness must hold through DEGRADED"
        observed.append("DEGRADED")
        print("[drill] watchdog tripped → DEGRADED "
              "(readiness shed, liveness intact)")

        # -- phase 2: bounded recovery back to READY ------------------------
        _wait_for(lambda: _get(port, "/health/ready")[0] == 200,
                  10, "recovery back to READY")
        observed.append("READY")
        assert engine.recoveries >= 1, "engine.recover() never ran"
        code, after = _post(port)
        assert code == 200, f"post-recovery request failed ({code})"
        # the ring was zeroed in place under the graphs: the same greedy
        # request must give the same reply, not merely a 200
        assert after == baseline, (
            f"post-recovery reply {after!r} != baseline {baseline!r}")
        metrics = _get_text(port, "/metrics")
        assert "watchdog_trips_total" in metrics
        assert "watchdog_recoveries_total" in metrics
        assert "health_state 1" in metrics      # READY (utils/health.py codes)
        print("[drill] recovered → READY; reply equal to the baseline; "
              "watchdog counters in /metrics")

        print(f"[drill] PASS: {' → '.join(observed)} "
              f"(trips={app.state.watchdog.trips}, "
              f"recoveries={app.state.watchdog.recoveries})")
        return 0
    finally:
        FAULTS.disarm()
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        th.join(10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fault_drill", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the engine on the CPU (default: the card)")
    ap.add_argument("--model-dir", default="",
                    help="directory holding --model-name (default: write the "
                         "tiny model to a temporary directory)")
    ap.add_argument("--model-name", default="tiny.gguf")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="fault-drill-") as tmp:
        model_dir = args.model_dir
        if not model_dir:
            from .tinymodel import write_tiny_llama_gguf

            model_dir = tmp
            write_tiny_llama_gguf(os.path.join(tmp, args.model_name))
        engine = build_engine(os.path.join(model_dir, args.model_name), args.device)
        try:
            return drill(engine)
        finally:
            engine.close()


if __name__ == "__main__":
    sys.exit(main())

"""The port's fleet tier (serving/fleet/, obs/fleettrace.py) on the CPU, held
to the JAX package's.

- affinity keys and rendezvous rankings equal the JAX functions' bit for
  bit on seeded bodies, headers and peer lists, with the minimal-remap
  property;
- the peer table: ejection with attribution, backoff, re-admission, a
  non-HTTP peer, and the settings refusals (the JAX messages);
- the router over port replicas: affinity sticks and round-robin spreads,
  spills with attribution and re-admission, 503 (with ``Retry-After`` at
  the spill budget) when no replica is left, the prior-owner stamp and the
  stripped forgeries, no span at all when sampled out;
- parity: routed bytes equal direct bytes on real tiny engines, and the
  port's router in front of a JAX replica gives the bytes the JAX router
  gives;
- observability: ``federate`` and ``stitch`` equal the JAX functions' on
  the same inputs (port replicas' ``/metrics`` texts included), and a
  traced request through the router is one stitched tree;
- the router entry (``build_router``, ``LFKT_FLEET_ROLE=router`` through
  ``-m ...server``) loads no torch.
"""

from __future__ import annotations

import asyncio
import http.server
import json
import os
import random
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import FakeEngine as JFakeEngine
from llama_fastapi_k8s_gpu_tpu.obs import fleettrace as jfleettrace
from llama_fastapi_k8s_gpu_tpu.server import httpd as jhttpd
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.serving.fleet import affinity as jaffinity
from llama_fastapi_k8s_gpu_tpu.serving.fleet.peers import PeerTable as JPeerTable
from llama_fastapi_k8s_gpu_tpu.serving.fleet.router import FleetRouter as JFleetRouter
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.obs import fleettrace
from llama_fastapi_k8s_gpu_tpu_torch.obs.trace import Span, Tracer
from llama_fastapi_k8s_gpu_tpu_torch.server import httpd
from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet import FLEET_ROLES, build_router
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.affinity import (
    AFFINITY_HEADER,
    AFFINITY_KEY_HEADER,
    PRIOR_OWNER_HEADER,
    affinity_key,
    rendezvous_rank,
)
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.peers import PeerTable
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.router import FleetRouter
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings
from llama_fastapi_k8s_gpu_tpu_torch.utils.metrics import Metrics
from tests.test_torch_openai import FakeEngine

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _body(conv: int, history: list | None = None, opener: str = "hello") -> bytes:
    return json.dumps({
        "bot_profile": {"name": f"Bot{conv}",
                        "appearance": "tall, green eyes, red hair, calm voice",
                        "system_prompt": f"You are concise assistant #{conv}."},
        "user_profile": {"name": "Sam"},
        "context": history or [{"turn": "user", "message": f"{opener} {conv}"}],
    }).encode()


def _request(port: int, path: str, body: bytes | None = None, headers=None,
             timeout: float = 60.0):
    """(status, headers, body) of one request; an HTTP error is an answer."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(port: int, body: bytes, path: str = "/response", timeout: float = 60.0,
          headers=None):
    status, _h, raw = _request(port, path, body, headers, timeout)
    return status, raw


def _get_json(port: int, path: str, timeout: float = 30.0) -> dict:
    return json.loads(_request(port, path, timeout=timeout)[2])


def _wait_http(port: int, path: str = "/health", deadline_s: float = 60.0) -> None:
    deadline = time.time() + deadline_s
    while True:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5)
            return
        except urllib.error.HTTPError:
            return                  # up, answering (a 503 while ejected)
        except Exception:  # noqa: BLE001 — booting
            if time.time() > deadline:
                raise
            time.sleep(0.05)


class _Served:
    """One asyncio server (an httpd app or a router) on its own loop thread,
    stoppable from the test thread."""

    def __init__(self, coro_factory):
        self._loop = self._stop = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(coro_factory,),
                                        daemon=True)
        self._thread.start()
        assert self._started.wait(10)

    def _run(self, coro_factory):
        async def main():
            self._loop = asyncio.get_running_loop()
            self._stop = asyncio.Event()
            self._started.set()
            await coro_factory(self._stop)
        asyncio.run(main())

    def stop(self, join_s: float = 15.0):
        if self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:
                pass
        self._thread.join(timeout=join_s)


def _serve_app(engine, port: int, tracer=None, **settings_kw) -> _Served:
    settings_kw.setdefault("watchdog", False)
    settings_kw.setdefault("temperature", 0.0)
    app = create_app(engine=engine, settings=Settings(**settings_kw), tracer=tracer)
    srv = _Served(lambda stop: httpd.serve(app, "127.0.0.1", port, stop_event=stop))
    srv.app = app
    _wait_http(port)
    return srv


def _serve_jax_app(engine, port: int, **settings_kw) -> _Served:
    settings_kw.setdefault("watchdog", False)
    settings_kw.setdefault("temperature", 0.0)
    app = j_create_app(engine=engine, settings=JSettings(**settings_kw))
    srv = _Served(lambda stop: jhttpd.serve(app, "127.0.0.1", port, stop_event=stop))
    _wait_http(port)
    return srv


def _serve_router(router, port: int) -> _Served:
    srv = _Served(lambda stop: router.serve("127.0.0.1", port, stop_event=stop))
    _wait_http(port, path="/health/live")
    return srv


def _table(ports, cls=PeerTable, **kw):
    kw.setdefault("probe_seconds", 0.3)
    kw.setdefault("backoff_seconds", 0.3)
    kw.setdefault("probe_timeout", 2.0)
    return cls(peers=[f"127.0.0.1:{p}" for p in ports], **kw)


# ---------------------------------------------------------------------------
# affinity keys and rankings, bit for bit
# ---------------------------------------------------------------------------

def _random_requests(seed: int, n: int = 60) -> list:
    """Seeded (path, headers, body) triples over every key source: pinned,
    /response conversations (growing histories), /v1 with and without
    ``user``, unparseable and empty bodies, control bytes in client text."""
    rng = random.Random(seed)
    words = ["hi", "fox", "river", "boat", "ünïcode", "tab\there", "cr\rlf\n", "x" * 600]

    def text():
        return " ".join(rng.choice(words) for _ in range(rng.randint(1, 6)))

    out = []
    for i in range(n):
        kind = rng.randrange(7)
        if kind == 0:
            out.append(("/response", {AFFINITY_HEADER: text()}, _body(i)))
        elif kind == 1:
            hist = [{"turn": "user" if j % 2 == 0 else "bot", "message": text()}
                    for j in range(rng.randint(1, 5))]
            bp = {"name": text(), "appearance": "a, b, c, d",
                  "system_prompt": rng.choice(["", text()])}
            out.append(("/response/stream", {},
                        json.dumps({"bot_profile": bp, "user_profile": {"name": "u"},
                                    "context": hist}).encode()))
        elif kind == 2:
            out.append(("/v1/chat/completions", {},
                        json.dumps({"model": rng.choice(["m", None]), "user": text(),
                                    "messages": [{"role": "user", "content": text()}]}
                                   ).encode()))
        elif kind == 3:
            msgs = [{"role": r, "content": text()}
                    for r in rng.sample(["system", "user", "assistant", "user"], 3)]
            out.append(("/v1/chat/completions", {},
                        json.dumps({"model": "m", "messages": msgs}).encode()))
        elif kind == 4:
            out.append(("/response", {}, bytes(rng.randrange(256) for _ in range(40))))
        elif kind == 5:
            out.append((rng.choice(["/v1/models", "/health", "/items/3"]), {}, b""))
        else:
            out.append(("/response", {}, json.dumps({"context": [], "bot_profile": {}}).encode()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_affinity_key_and_rank_equal_jax(seed):
    rng = random.Random(100 + seed)
    for path, headers, body in _random_requests(seed):
        got = affinity_key(path, headers, body)
        assert got == jaffinity.affinity_key(path, headers, body), (path, headers, body)
        peers = [f"10.0.{rng.randrange(4)}.{rng.randrange(250)}:{rng.choice([8000, 8011])}"
                 for _ in range(rng.randint(1, 6))]
        assert rendezvous_rank(got[0], peers) == jaffinity.rendezvous_rank(got[0], peers)
    assert (AFFINITY_HEADER, AFFINITY_KEY_HEADER, PRIOR_OWNER_HEADER) == (
        jaffinity.AFFINITY_HEADER, jaffinity.AFFINITY_KEY_HEADER, jaffinity.PRIOR_OWNER_HEADER)


def test_affinity_key_sources_stable_across_turns():
    assert affinity_key("/response", {AFFINITY_HEADER: "conv-42"}, _body(0)) == \
        ("h:conv-42", "header")
    k1, src1 = affinity_key("/response", {}, _body(1))
    grown = [{"turn": "user", "message": "hello 1"}, {"turn": "bot", "message": "hi!"},
             {"turn": "user", "message": "tell me more"}]
    assert src1 == "prefix" and affinity_key("/response", {}, _body(1, grown))[0] == k1
    assert affinity_key("/response", {}, _body(2))[0] != k1
    v1 = {"model": "m", "user": "u-7", "messages": [{"role": "user", "content": "x"}]}
    assert affinity_key("/v1/chat/completions", {}, json.dumps(v1).encode()) == \
        ("u:u-7", "conversation")
    assert affinity_key("/response", {}, b"\xff not json")[1] == "opaque"
    assert affinity_key("/v1/models", {}, b"")[1] == "opaque"


def test_rendezvous_rank_balance_and_minimal_remap():
    peers = ["10.0.0.1:8000", "10.0.0.2:8000", "10.0.0.3:8000"]
    keys = [f"conv-{i}" for i in range(300)]
    owners = {k: rendezvous_rank(k, peers)[0] for k in keys}
    counts = {p: sum(1 for o in owners.values() if o == p) for p in peers}
    assert all(c > 50 for c in counts.values()), counts
    # removing a peer remaps only its keys; the owner's loss promotes rank 2
    for k in keys:
        if owners[k] in peers[:2]:
            assert rendezvous_rank(k, peers[:2])[0] == owners[k]
        full = rendezvous_rank(k, peers)
        assert rendezvous_rank(k, [p for p in peers if p != full[0]])[0] == full[1]


# ---------------------------------------------------------------------------
# the peer table
# ---------------------------------------------------------------------------

class _FlagReplica:
    """A controllable /health/ready endpoint: 200 while .ready, else 503."""

    def __init__(self):
        self.ready = True
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):           # noqa: N802 — stdlib contract
                code = 200 if outer.ready else 503
                body = b'{"ready": true}' if outer.ready else b'{}'
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()


def _until(pred, timeout: float = 10.0) -> bool:
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.05)
    return pred()


def test_peer_table_eject_backoff_readmit():
    rep = _FlagReplica()
    table = _table([rep.port], metrics=Metrics())
    addr = f"127.0.0.1:{rep.port}"
    try:
        table.start(probe_now=True)
        assert table.healthy() == [addr]
        assert not table.is_fresh(addr, 600.0)      # static boot peers start stale
        rep.ready = False
        assert _until(lambda: not table.healthy())
        row = table.snapshot()["peers"][0]
        assert row["healthy"] is False and "503" in row["last_error"]
        assert row["ejections"] >= 1 and row["source"] == "static"
        time.sleep(1.0)
        assert table.snapshot()["peers"][0]["backoff_seconds"] >= 0.3
        rep.ready = True
        assert _until(lambda: table.healthy() == [addr])
        assert table.snapshot()["peers"][0]["last_error"] is None
        # re-admission makes the peer fresh: the router's pull-on-remap cue
        assert table.is_fresh(addr, 600.0) and not table.is_fresh(addr, 0.0)
        assert 'fleet_probe_seconds_count{peer="%s"}' % addr in table._metrics.render()
    finally:
        table.stop()
        rep.close()


def test_probe_survives_non_http_peer():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)

    def accept_loop():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            try:
                c.sendall(b"NOT HTTP AT ALL\n")
                c.close()
            except OSError:
                pass

    threading.Thread(target=accept_loop, daemon=True).start()
    table = PeerTable(peers=[f"127.0.0.1:{srv.getsockname()[1]}"], probe_seconds=0.2,
                      backoff_seconds=0.2, probe_timeout=1.0)
    try:
        table.start(probe_now=True)
        assert table.healthy() == []
        assert "BadStatusLine" in table.snapshot()["peers"][0]["last_error"]
    finally:
        table.stop()
        srv.close()


def test_peer_table_and_router_refusals_equal_jax():
    for cls in (PeerTable, JPeerTable):
        with pytest.raises(ValueError) as ei:
            cls(peers=[], dns="")
        if cls is PeerTable:
            mine = str(ei.value)
        else:
            assert str(ei.value) == mine
    for cls in (FleetRouter, JFleetRouter):
        with pytest.raises(ValueError, match="LFKT_FLEET_POLICY"):
            cls(object(), policy="sideways")
    assert FLEET_ROLES == ("off", "router")


def test_build_router_from_settings():
    rep = _FlagReplica()
    try:
        router = build_router(Settings(
            fleet_peers=f"127.0.0.1:{rep.port}", fleet_policy="roundrobin",
            fleet_probe_seconds=0.3, fleet_proxy_timeout_seconds=2.0,
            migrate_fresh_seconds=7.0, fleet_max_spills=2))
        assert router.policy == "roundrobin"
        assert router.peers.healthy() == [f"127.0.0.1:{rep.port}"]
        assert (router.fresh_seconds, router.max_spills, router.proxy_timeout) == (7.0, 2, 2.0)
        router.peers.stop()
    finally:
        rep.close()


def test_fleet_settings_defaults_equal_jax():
    names = [n for n in JSettings.__dataclass_fields__
             if n.startswith(("fleet_", "migrate"))]
    assert len(names) == 17
    mine, theirs = Settings(), JSettings()
    for n in names:
        assert getattr(mine, n) == getattr(theirs, n), n


# ---------------------------------------------------------------------------
# the router over port replicas
# ---------------------------------------------------------------------------

def test_router_affinity_sticks_roundrobin_spreads():
    p1, p2, rp, rp2 = (_free_port() for _ in range(4))
    s1 = _serve_app(FakeEngine(reply="alpha"), p1)
    s2 = _serve_app(FakeEngine(reply="beta"), p2)
    table = _table([p1, p2]).start()
    rs = _serve_router(FleetRouter(table, policy="affinity", metrics=Metrics()), rp)
    table2 = _table([p1, p2]).start()
    rs2 = _serve_router(FleetRouter(table2, policy="roundrobin"), rp2)
    addrs = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]

    def owner(conv):
        return rendezvous_rank(affinity_key("/response", {}, _body(conv))[0], addrs)[0]

    # three conversations each replica owns: the ports are random, so the
    # first six conversations all hash to one replica in 1 run of 32
    convs = ([c for c in range(64) if owner(c) == addrs[0]][:3]
             + [c for c in range(64) if owner(c) == addrs[1]][:3])
    try:
        seen = {}
        for conv in convs:
            answers = {json.loads(_post(rp, _body(conv))[1])["response"] for _ in range(3)}
            assert len(answers) == 1, (conv, answers)
            seen[conv] = answers.pop()
        assert set(seen.values()) == {"alpha", "beta"}
        # each conversation on its rendezvous owner
        for conv, reply in seen.items():
            assert reply == ("alpha" if owner(conv) == addrs[0] else "beta")
        answers = {json.loads(_post(rp2, _body(0))[1])["response"] for _ in range(4)}
        assert answers == {"alpha", "beta"}
        m = _request(rp, "/metrics")[2].decode()
        assert "fleet_requests_total" in m and "fleet_peers_healthy 2" in m
        assert 'source="prefix"' in m
    finally:
        for s in (rs, rs2, s1, s2):
            s.stop()
        table.stop()
        table2.stop()


class _HeldTable(PeerTable):
    """A peer table whose probe sweeps can be held: a sweep runs under
    ``hold``, so taking it waits out a sweep under way and stops the next."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.hold = threading.Lock()

    def _probe_sweep(self):
        with self.hold:
            super()._probe_sweep()


def _spill_reasons(router, since: dict | None = None) -> dict:
    """``fleet_spills_total`` by reason, as the router's /metrics renders it
    (what grew ``since`` an earlier reading)."""
    now = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^fleet_spills_total\{reason="([a-z_]+)"\} ([0-9.e+]+)$',
        router.metrics.render(), re.M)}
    since = since or {}
    return {k: v - since.get(k, 0.0) for k, v in now.items() if v != since.get(k, 0.0)}


@pytest.mark.parametrize("order", ["probe_first", "attempt_first"])
def test_router_ejects_spills_attributes_and_readmits(order):
    """The owner dies; the next request is served by the survivor.  Which
    of two events ejects the owner is fixed per case: the prober, before
    the request (one spill, ``spilled``: served off the owner), or the
    request's own attempt with the prober held (two: ``ejected`` for the
    failed attempt, then ``spilled``).  The router counts a spill after the
    relayed response, so the test waits for its count before it reads, and
    counts from a reading taken once the search for an owned conversation
    is counted (a spill there, under load, is not this request's)."""
    p1, p2, rp = (_free_port() for _ in range(3))
    s1 = _serve_app(FakeEngine(reply="alpha"), p1)
    s2 = _serve_app(FakeEngine(reply="beta"), p2)
    table = _table([p1, p2], cls=_HeldTable).start()
    router = FleetRouter(table, policy="affinity", metrics=Metrics())
    rs = _serve_router(router, rp)
    dead_addr = f"127.0.0.1:{p1}"
    try:
        for n, conv in enumerate(range(64), start=1):
            if json.loads(_post(rp, _body(conv))[1])["response"] == "alpha":
                break
        assert _until(lambda: router.counters["proxied"] == n, 15)
        base, base_spills = _spill_reasons(router), router.counters["spills"]
        if order == "attempt_first":
            table.hold.acquire()
            assert table.is_healthy(dead_addr)
        s1.stop()
        if order == "probe_first":
            assert _until(lambda: not table.is_healthy(dead_addr), 15)
        status, raw = _post(rp, _body(conv))
        assert status == 200 and json.loads(raw)["response"] == "beta"
        want = ({"spilled": 1.0} if order == "probe_first"
                else {"ejected": 1.0, "spilled": 1.0})
        assert _until(lambda: _spill_reasons(router, base) == want, 15), \
            _spill_reasons(router, base)
        assert router.counters["spills"] - base_spills == len(want)
        doc = _get_json(rp, "/health")
        assert doc["role"] == "router" and doc["healthy"] == 1
        dead = [p for p in doc["peers"] if not p["healthy"]]
        assert [d["addr"] for d in dead] == [dead_addr]
        assert dead[0]["last_error"].startswith(
            "probe" if order == "probe_first" else "proxy"), dead[0]["last_error"]
        assert _get_json(rp, "/health/ready")["ready"] is True
        if table.hold.locked():
            table.hold.release()
        s1b = _serve_app(FakeEngine(reply="alpha"), p1)
        try:
            assert _until(lambda: len(table.healthy()) == 2, 15)
            assert json.loads(_post(rp, _body(conv))[1])["response"] == "alpha"
        finally:
            s1b.stop()
    finally:
        if table.hold.locked():
            table.hold.release()
        rs.stop()
        table.stop()
        s2.stop()


def test_router_503_when_whole_fleet_down():
    p1, rp = _free_port(), _free_port()
    table = PeerTable(peers=[f"127.0.0.1:{p1}"], probe_seconds=0.3,
                      backoff_seconds=0.3, probe_timeout=1.0).start()
    rs = _serve_router(FleetRouter(table, policy="affinity", proxy_timeout=1.0), rp)
    try:
        t0 = time.time()
        status, raw = _post(rp, _body(0), timeout=15)
        assert status == 503 and "no healthy replica" in raw.decode()
        assert time.time() - t0 < 10
        assert _request(rp, "/health/ready")[0] == 503
        doc = _get_json(rp, "/health")
        assert doc["healthy"] == 0 and doc["counters"]["no_replica_503s"] >= 1
    finally:
        rs.stop()
        table.stop()


def _slammer():
    """Accepts, then hangs up before a response byte."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    s.listen(8)

    def loop():
        while True:
            try:
                c, _ = s.accept()
            except OSError:
                return
            c.close()

    threading.Thread(target=loop, daemon=True).start()
    return s


def test_router_spill_budget_503_with_retry_after():
    dead1, dead2 = _slammer(), _slammer()
    rp = _free_port()
    table = PeerTable(peers=[f"127.0.0.1:{s.getsockname()[1]}" for s in (dead1, dead2)],
                      probe_seconds=600.0)
    router = FleetRouter(table, policy="affinity", metrics=Metrics(), max_spills=0,
                         proxy_timeout=2.0)
    rs = _serve_router(router, rp)
    try:
        status, headers, raw = _request(rp, "/response", _body(0), timeout=20)
        assert status == 503 and headers.get("retry-after")
        assert "spill budget" in raw.decode()
        assert router.counters["budget_503s"] == 1
        assert 'reason="budget"' in router.metrics.render()
        assert 'reason="ejected"' in router.metrics.render()
    finally:
        rs.stop()
        table.stop()
        dead1.close()
        dead2.close()


class _CaptureBackend:
    """A raw TCP backend that records each request head and answers 200."""

    def __init__(self):
        self.heads: list[bytes] = []
        self.accepts = 0
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                c, _ = self._sock.accept()
            except OSError:
                return
            self.accepts += 1
            try:
                c.settimeout(5.0)
                buf = b""
                while b"\r\n\r\n" not in buf:
                    chunk = c.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                self.heads.append(buf.split(b"\r\n\r\n")[0])
                c.sendall(b"HTTP/1.1 200 OK\r\ncontent-length: 2\r\n"
                          b"connection: close\r\n\r\nok")
            except OSError:
                pass
            finally:
                c.close()

    def close(self):
        self._sock.close()


def test_router_stamps_prior_owner_and_strips_forgeries():
    b1, b2 = _CaptureBackend(), _CaptureBackend()
    rp = _free_port()
    addrs = [f"127.0.0.1:{b1.port}", f"127.0.0.1:{b2.port}"]
    table = PeerTable(peers=addrs, probe_seconds=600.0)
    rs = _serve_router(FleetRouter(table, policy="affinity", metrics=Metrics(),
                                   fresh_seconds=600.0), rp)
    try:
        body = _body(7)
        key = affinity_key("/response", {}, body)[0]
        order = rendezvous_rank(key, addrs)
        owner = order[0]
        owner_b, spill_b = (b1, b2) if owner == addrs[0] else (b2, b1)
        # a stale owner: the key stamped, no prior owner, forgeries gone
        assert _post(rp, body, headers={PRIOR_OWNER_HEADER: "evil.example:1",
                                        AFFINITY_KEY_HEADER: "forged"})[0] == 200
        head = owner_b.heads[-1].lower()
        assert f"{AFFINITY_KEY_HEADER}: {key}".encode() in head
        assert PRIOR_OWNER_HEADER.encode() not in head
        assert b"evil.example" not in head and b"forged" not in head
        # the owner re-joined fresh: rank 2 named as the prior owner
        with table._lock:
            table._peers[owner].fresh_at = time.time()
        assert _post(rp, body)[0] == 200
        assert f"{PRIOR_OWNER_HEADER}: {order[1]}".encode() in owner_b.heads[-1].lower()
        # the owner ejected: the spill target is told the owner holds the pages
        table.eject(owner, "drill")
        assert _post(rp, body)[0] == 200
        assert f"{PRIOR_OWNER_HEADER}: {owner}".encode() in spill_b.heads[-1].lower()
        # an opaque key gets no stamp
        assert _post(rp, b"\xff\xfe", path="/items/1")[0] == 200
        assert AFFINITY_KEY_HEADER.encode() not in spill_b.heads[-1].lower()
    finally:
        rs.stop()
        table.stop()
        b1.close()
        b2.close()


def test_router_relay_sampled_out_builds_no_spans(monkeypatch):
    p1, rp = _free_port(), _free_port()
    s1 = _serve_app(FakeEngine(reply="alpha"), p1, tracer=Tracer(sample=0.0, ring=4))
    table = _table([p1]).start()
    rs = _serve_router(FleetRouter(table, policy="affinity", metrics=Metrics(),
                                   tracer=Tracer(sample=0.0, ring=4)), rp)
    try:
        def poisoned(self, *a, **kw):
            raise AssertionError("Span constructed on the sampled-out fleet path")

        monkeypatch.setattr(Span, "__init__", poisoned)
        status, headers, raw = _request(rp, "/response", _body(0))
        assert status == 200 and json.loads(raw)["response"] == "alpha"
        assert headers.get("x-request-id")
        status, _h, raw = _request(rp, "/response/stream", _body(1))
        assert status == 200 and b"[DONE]" in raw
    finally:
        rs.stop()
        table.stop()
        s1.stop()


# ---------------------------------------------------------------------------
# parity: routed bytes equal direct bytes; the port router equals the JAX one
# ---------------------------------------------------------------------------

_VOLATILE = ("x-request-id", "traceparent", "date")


def _comparable(resp):
    status, headers, raw = resp
    hdrs = {k.lower(): ("<v>" if k.lower() in _VOLATILE else v)
            for k, v in headers.items()}
    return status, hdrs, raw


def test_port_router_equals_jax_router_in_front_of_a_jax_replica():
    """The same JAX replica behind the JAX router and behind the port's:
    status, header set and body bytes agree on /response, its stream,
    /v1, a router-local route and the no-replica 503."""
    p1, jr, pr = (_free_port() for _ in range(3))
    rep = _serve_jax_app(JFakeEngine(reply="fox tale"), p1)
    jt, pt = _table([p1], cls=JPeerTable).start(), _table([p1]).start()
    js = _serve_router(JFleetRouter(jt, policy="affinity"), jr)
    ps = _serve_router(FleetRouter(pt, policy="affinity"), pr)
    v1 = json.dumps({"messages": [{"role": "user", "content": "hi"}], "user": "c1"}).encode()
    try:
        for path, body in (("/response", _body(3)), ("/response/stream", _body(4)),
                           ("/v1/chat/completions", v1), ("/health/live", None)):
            a = _comparable(_request(jr, path, body))
            b = _comparable(_request(pr, path, body))
            if path == "/v1/chat/completions":
                # id/created minted per request: compare the generation
                da, db = json.loads(a[2]), json.loads(b[2])
                assert (a[0], a[1], da["choices"]) == (b[0], b[1], db["choices"])
            elif path == "/response/stream":
                strip = [ln for ln in a[2].split(b"\n") if b"chatcmpl" not in ln]
                assert (a[0], a[1], strip) == (
                    b[0], b[1], [ln for ln in b[2].split(b"\n") if b"chatcmpl" not in ln])
            else:
                assert a == b, path
        rep.stop()
        jt.eject(f"127.0.0.1:{p1}", "drill")
        pt.eject(f"127.0.0.1:{p1}", "drill")
        a, b = _comparable(_request(jr, "/response", _body(3))), \
            _comparable(_request(pr, "/response", _body(3)))
        assert a == b and a[0] == 503
    finally:
        js.stop()
        ps.stop()
        jt.stop()
        pt.stop()
        rep.stop()


KW = dict(n_ctx=256, prefill_buckets=(64, 128), max_gen_tokens=8, decode_chunk=4,
          kv_paged=True, kv_page_tokens=16)


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("fleet") / "tiny.gguf")
    write_tiny_llama_gguf(p)
    return p


def _sse_text(raw: bytes) -> str:
    parts = []
    for line in raw.decode("utf-8", "replace").splitlines():
        if not line.startswith("data:") or line[5:].strip() == "[DONE]":
            continue
        evt = json.loads(line[5:])
        assert "error" not in evt, evt
        parts.append(evt["choices"][0]["delta"].get("content") or "")
    return "".join(parts)


def test_fleet_route_parity_and_stitched_trace(gguf_path):
    """Greedy output THROUGH the port's router equals direct serving on
    real tiny engines — /response bytes, /v1 choices and usage, the SSE
    content — and a traced request is ONE stitched tree across the router
    and the replica, which ``stitch`` of the JAX package builds alike."""
    p1, p2, rp = (_free_port() for _ in range(3))
    s1 = _serve_app(Engine(gguf_path, device="cpu", **KW), p1, tracer=Tracer(sample=1.0, ring=16))
    s2 = _serve_app(Engine(gguf_path, device="cpu", **KW), p2, tracer=Tracer(sample=1.0, ring=16))
    table = _table([p1, p2]).start()
    router = FleetRouter(table, policy="affinity", metrics=Metrics(),
                         tracer=Tracer(sample=1.0, ring=16))
    rs = _serve_router(router, rp)
    try:
        body = _body(0, opener="The quick brown fox jumps over")
        assert _post(rp, body, timeout=300) == _post(p1, body, timeout=300)
        v1 = json.dumps({"temperature": 0.0, "max_tokens": 8, "user": "conv-trace",
                         "messages": [{"role": "user", "content": "Say something about foxes."}]
                         }).encode()
        d_doc = json.loads(_post(p2, v1, path="/v1/chat/completions")[1])
        status, headers, raw = _request(rp, "/v1/chat/completions", v1)
        r_doc = json.loads(raw)
        assert (r_doc["choices"], r_doc["usage"]) == (d_doc["choices"], d_doc["usage"])
        assert _sse_text(_request(rp, "/response/stream", body)[2]) == \
            _sse_text(_request(p1, "/response/stream", body)[2])

        # one request id end to end, one stitched tree, no orphan
        rid = headers["x-request-id"]
        assert len(rid) == 32 and headers["traceparent"].split("-")[1] == rid
        doc = None
        deadline = time.time() + 30
        while time.time() < deadline:
            doc = _get_json(rp, f"/debug/fleet/traces/{rid}")
            if doc.get("fragments", 0) >= 2 and doc.get("finished"):
                break
            time.sleep(0.1)
        assert doc["stitched"] and doc["orphans"] == [] and doc["fragments"] == 2
        assert doc["root"]["name"] == "fleet.route" and "router" in doc["processes"]
        owner = rendezvous_rank("u:conv-trace", [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"])[0]
        assert owner in doc["processes"]
        attempt = [c for c in doc["root"]["children"] if c["name"] == "proxy.attempt"][0]
        assert attempt["attrs"]["peer"] == owner
        assert any(c.get("attrs", {}).get("hop") for c in attempt["children"])
        assert _request(rp, "/debug/fleet/traces/not-hex")[0] == 404
        # the same fragments through the JAX stitch
        local = router.tracer.get(rid).to_dict()
        frags = fleettrace.collect_fragments(rid, [owner], local=local)
        assert fleettrace.stitch(frags) == jfleettrace.stitch(
            jfleettrace.collect_fragments(rid, [owner], local=local))
        assert fleettrace.stitch([]) is None
    finally:
        rs.stop()
        table.stop()
        s1.stop()
        s2.stop()


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------

def test_federate_equals_jax_and_sums_the_replicas():
    """Port replicas' /metrics texts federate to what the JAX ``federate``
    makes of them (exposition and snapshot); the router's /metrics/fleet
    counters equal the replicas' sums; the fleet SLO verdict rides it."""
    p1, p2, rp = (_free_port() for _ in range(3))
    s1 = _serve_app(FakeEngine(reply="alpha"), p1)
    s2 = _serve_app(FakeEngine(reply="beta"), p2)
    m = Metrics()
    # one probe sweep at start, none between the scrapes below
    table = _table([p1, p2], metrics=m, probe_seconds=600.0).start()
    rs = _serve_router(FleetRouter(table, policy="roundrobin", metrics=m), rp)
    try:
        for conv in range(6):
            assert _post(rp, _body(conv))[0] == 200
        texts = {f"127.0.0.1:{p}": _request(p, "/metrics")[2].decode() for p in (p1, p2)}
        mine, theirs = fleettrace.federate(texts), jfleettrace.federate(texts)
        assert mine == theirs
        for text in texts.values():
            assert fleettrace.parse_exposition(text) == jfleettrace.parse_exposition(text)

        pods = [fleettrace.parse_exposition(_request(p, "/metrics")[2].decode())
                for p in (p1, p2)]
        body = _request(rp, "/metrics/fleet")[2].decode()
        fleet = fleettrace.parse_exposition(body)
        compared = 0
        for fam in ("http_requests_total", "requests_total"):
            for key, val in fleet.get(fam, {}).get("series", {}).items():
                if ("route", "/metrics") in key:
                    continue        # the scrapes themselves move it
                compared += 1
                assert val == sum(p.get(fam, {}).get("series", {}).get(key, 0.0) for p in pods)
        assert compared >= 1
        for key, h in fleet["request_seconds"]["hist"].items():
            if ("route", "/metrics") in key:
                continue
            assert h["count"] == sum(p["request_seconds"]["hist"].get(
                key, {"count": 0.0})["count"] for p in pods)
        assert f'queue_depth{{peer="127.0.0.1:{p1}"}}' in body
        assert 'slo_burn_rate{' in body and 'scope="fleet"' in body
        doc = _get_json(rp, "/debug/slo")
        assert doc["scope"] == "fleet" and doc["slos"]
        assert set(doc["peers"]) == set(texts)
    finally:
        rs.stop()
        table.stop()
        s1.stop()
        s2.stop()


def test_incident_pull_records_a_correlated_bundle(tmp_path):
    from llama_fastapi_k8s_gpu_tpu_torch.obs.flightrec import FlightRecorder, validate_bundle

    rec = FlightRecorder(directory=str(tmp_path), ring=4, debounce_s=0.0)
    p1 = _free_port()
    s1 = _serve_app(FakeEngine(reply="alpha"), p1)
    try:
        extra = fleettrace.incident_pull(f"127.0.0.1:{p1}", [], "probe failed", recorder=rec)
        assert extra["peer"] == f"127.0.0.1:{p1}" and f"127.0.0.1:{p1}" in extra["correlated"]
        (row,) = rec.list()
        bundle = rec.get(row["id"])
        assert bundle["kind"] == "fleet_peer_ejected" and not validate_bundle(bundle)
    finally:
        s1.stop()
        rec.configure(directory="")


# ---------------------------------------------------------------------------
# the router loads no torch
# ---------------------------------------------------------------------------

_NO_TORCH = r"""
import json, os, runpy, signal, sys, threading, urllib.request
sys.path.insert(0, {repo!r})
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet import build_router
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import get_settings
r = build_router(get_settings())
r.peers.stop()
after_build = "torch" in sys.modules
port = int(os.environ["LFKT_PORT"])
seen = {{}}

def probe():
    import time
    for _ in range(200):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{{port}}/health", timeout=2) as resp:
                seen["health"] = json.loads(resp.read())
                break
        except Exception:
            time.sleep(0.05)
    os.kill(os.getpid(), signal.SIGTERM)

threading.Thread(target=probe, daemon=True).start()
sys.argv = ["server"]
runpy.run_module("llama_fastapi_k8s_gpu_tpu_torch.server", run_name="__main__")
print(json.dumps({{"after_build": after_build, "after_serve": "torch" in sys.modules,
                  "role": seen.get("health", {{}}).get("role")}}))
"""


def test_router_entry_loads_no_torch():
    env = dict(os.environ, LFKT_FLEET_ROLE="router", LFKT_FLEET_PEERS="127.0.0.1:1",
               LFKT_HOST="127.0.0.1", LFKT_PORT=str(_free_port()), LFKT_JSON_LOGS="0")
    out = subprocess.run([sys.executable, "-c", _NO_TORCH.format(repo=REPO)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc == {"after_build": False, "after_serve": False, "role": "router"}
    bad = subprocess.run([sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.server"],
                         env=dict(env, LFKT_FLEET_ROLE="sideways"), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "LFKT_FLEET_ROLE must be one of off|router" in bad.stderr

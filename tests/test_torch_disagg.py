"""The port's disaggregated prefill/decode tier (serving/disagg/ and the
engines' hooks) on the CPU, held to the JAX package's.

- loopback: a decode engine fed by a prefill engine over the real wire
  answers byte-equal to the same engine over a local radix hit of the same
  pages, serial and continuous, and ``LFKT_DISAGG_ROLE=both`` on one engine
  does too, with the JAX ``both`` engine's status document and counters
  (on this prompt the port's greedy reply parts from the JAX engine's at
  its third token with the tier off as well: a bf16 near-tie, ROADMAP C.5);
- across the implementations: the port's ``DisaggClient`` against the JAX
  ``PrefillServer``, and the JAX client against the port's server — the
  handshake is accepted and the imported pages are byte-equal to the pages
  the serving side exports;
- the degrades: a peer dead mid-stream (local prefill, DEGRADED with the
  ``disagg:`` reason, an incident bundle, READY again after the next hop),
  a torn frame (nothing imported), a wire slower than the hop budget, a
  geometry mismatch (refused once, for good), an explicit seed and a
  warm conversation (no hop), and a role that is off (one attribute read);
- ``build_roles``'s refusals equal the JAX package's;
- the spans: the request's ``disagg`` span and the service's linked
  ``disagg.prefill`` fragment;
- the app: the ``/health`` ``disagg`` block and the ``disagg_*`` families
  beside the JAX app's.
"""

from __future__ import annotations

import gc
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.serving.disagg import build_roles as j_build_roles
from llama_fastapi_k8s_gpu_tpu.serving.disagg.decoder import DisaggClient as JDisaggClient
from llama_fastapi_k8s_gpu_tpu.serving.disagg.prefiller import PrefillServer as JPrefillServer
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine
from llama_fastapi_k8s_gpu_tpu_torch.obs.flightrec import FlightRecorder
from llama_fastapi_k8s_gpu_tpu_torch.obs.trace import Tracer
from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
from llama_fastapi_k8s_gpu_tpu_torch.serving.disagg import ROLES, build_roles, wire
from llama_fastapi_k8s_gpu_tpu_torch.serving.disagg.decoder import DisaggClient
from llama_fastapi_k8s_gpu_tpu_torch.serving.disagg.prefiller import PrefillServer
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings
from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS
from llama_fastapi_k8s_gpu_tpu_torch.utils.health import DEGRADED, READY, HealthMonitor
from tests.test_torch_kvpool import _bits
from tests.test_torch_openai import call, serve

torch.set_num_threads(1)
T = 120
#: long enough that its whole-page prefix clears the serial paged reuse
#: (page-aligned, >= prefix_min, the suffix in a smaller bucket) at 16-token
#: pages and buckets (64, 128), and spans more than one PAGE group
MSG_A = ("The quick brown fox jumps over the lazy dog near the old riverbank while "
         "autumn leaves drift slowly down, and then some more words to pad this out "
         "nicely ok.")
MSG_B = MSG_A.replace("fox", "cat").replace("autumn", "spring")
KW = dict(n_ctx=256, prefill_buckets=(64, 128), max_gen_tokens=8, decode_chunk=4,
          kv_paged=True, kv_page_tokens=16)


@pytest.fixture(autouse=True)
def _collect_engines():
    """Engines, page services and clients of a test may sit in reference
    cycles until a collection: collect them when each test ends, so no
    later test in the process finds their memory-ledger rows."""
    yield
    gc.collect()


@pytest.fixture(autouse=True)
def _disarm_faults():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("disagg") / "tiny.gguf")
    write_tiny_llama_gguf(p)
    return p


def _engine(path, **kw):
    return Engine(path, device="cpu", **{**KW, **kw})


def _greedy(eng, text=MSG_A, **kw):
    return eng.create_chat_completion([{"role": "user", "content": text}],
                                      temperature=0.0, **kw)


def _text(out) -> str:
    return out["choices"][0]["message"]["content"]


def _pair(path, health=None, timeout_s=60.0, tracer=None, **dkw):
    """(prefill engine, decode engine, server, client) on the real wire."""
    eng_p, eng_d = _engine(path), _engine(path, **dkw)
    srv = PrefillServer(eng_p, host="127.0.0.1", port=0, tracer=tracer)
    cli = DisaggClient(f"127.0.0.1:{srv.port}", eng_d._kvpool, timeout_s=timeout_s,
                       health=health)
    eng_d.install_disagg(cli)
    return eng_p, eng_d, srv, cli


def _stop_jax_service(srv) -> None:
    """Stop a JAX page service and wait for its accept loop: its ``stop``
    only closes the listener, which does not wake a blocked ``accept``, and
    the thread would keep its engine alive; shutting the socket down does."""
    try:
        srv._sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()
    srv._thread.join(5)


def _pages(pool, ids, tokens: int, namespace: str = "") -> list:
    """The pool's page stacks for ``ids[:tokens]`` as numpy bits."""
    lease = pool.acquire(ids, tokens, namespace=namespace)
    assert lease is not None
    try:
        return [_bits(leaf) for leaf in pool.export_pages(lease)]
    finally:
        pool.release(lease)


# ---------------------------------------------------------------------------
# loopback: bit identity with a local radix hit
# ---------------------------------------------------------------------------

def test_remote_pages_serve_the_same_bytes_as_a_local_radix_hit(path):
    local = _engine(path)
    cold = _text(_greedy(local))
    hit = _greedy(local)                        # the same pages, restored locally
    assert hit["lfkt_timings"]["prefix_reused_tokens"] > 0
    eng_p, eng_d, srv, cli = _pair(path)
    try:
        out = _greedy(eng_d)
        assert _text(out) == _text(hit) == cold
        assert out["lfkt_timings"]["prefix_reused_tokens"] == \
            hit["lfkt_timings"]["prefix_reused_tokens"]
        assert cli.counters["remote_prefills"] == 1 and cli.counters["remote_tokens"] > 0
        assert srv.counters["prefills_served"] == 1 and srv.counters["pages_sent"] > 4
        ids = eng_d.tokenize_messages([{"role": "user", "content": MSG_A}])
        n = cli.counters["remote_tokens"]
        # the pages received are the pages exported, bit for bit
        got, sent = _pages(eng_d._kvpool, ids, n), _pages(eng_p._kvpool, ids, n)
        assert all(np.array_equal(a, b) for a, b in zip(got, sent))
        # a warm follow-up of the same conversation never pays the wire
        _greedy(eng_d)
        assert cli.counters["remote_prefills"] == 1 and cli.counters["warm_local_skips"] >= 1
        # an explicit seed takes the full local prefill
        _greedy(eng_d, text=MSG_B, seed=7)
        assert cli.counters["remote_prefills"] == 1
    finally:
        cli.close()
        srv.stop()


def test_continuous_admission_hop_serves_the_local_hits_bytes(path):
    ckw = dict(batch_size=2, prefill_chunk=16)
    local = ContinuousEngine(path, device="cpu", **KW, **ckw)
    eng_p = _engine(path)
    srv = PrefillServer(eng_p, host="127.0.0.1", port=0)
    eng_d = ContinuousEngine(path, device="cpu", **KW, **ckw)
    cli = DisaggClient(f"127.0.0.1:{srv.port}", eng_d._kvpool, timeout_s=60.0)
    eng_d.install_disagg(cli)
    msgs = [{"role": "user", "content": MSG_A}]
    try:
        local.submit(msgs, temperature=0.0).result(timeout=T)
        want = local.submit(msgs, temperature=0.0).result(timeout=T)
        got = eng_d.submit(msgs, temperature=0.0).result(timeout=T)
        assert _text(got) == _text(want)
        assert cli.counters["remote_prefills"] == 1
        stats = eng_d.scheduler_stats()
        assert stats["radix_prefix_hits"] >= 1 and stats["radix_prefix_reused_tokens"] > 0
    finally:
        cli.close()
        srv.stop()
        eng_d.shutdown()
        local.shutdown()


def test_both_role_on_one_engine_equals_the_references(path):
    eng = _engine(path)
    roles = build_roles("both", eng, Settings(disagg_timeout_seconds=60.0))
    ref = JEngine(path, **KW)
    jroles = j_build_roles("both", ref, JSettings(disagg_timeout_seconds=60.0))
    try:
        assert roles.role == "both" and eng._disagg is roles.client
        local = _engine(path)
        _greedy(local)
        assert _text(_greedy(eng)) == _text(_greedy(local))     # over a local hit
        _greedy(ref)
        st, jst = roles.status(), jroles.status()
        assert set(st) == set(jst) == {"role", "prefill_service", "peer"}
        for key in ("prefill_service", "peer"):
            assert set(st[key]) == set(jst[key])
        for k in ("prefills_served", "pages_sent", "bytes_sent", "handshake_refusals"):
            assert st["prefill_service"][k] == jst["prefill_service"][k], k
        for k in ("remote_prefills", "remote_tokens", "local_fallbacks", "reconnects"):
            assert st["peer"][k] == jst["peer"][k], k
        assert st["prefill_service"]["prefills_served"] == 1
        assert st["peer"]["peer"].startswith("127.0.0.1:")
    finally:
        roles.close()
        jroles.client.close()
        _stop_jax_service(jroles.server)


# ---------------------------------------------------------------------------
# the two implementations on one wire
# ---------------------------------------------------------------------------

def test_port_client_imports_the_jax_services_pages_byte_for_byte(path):
    ref = JEngine(path, **KW)
    srv = JPrefillServer(ref, host="127.0.0.1", port=0)
    eng = _engine(path)
    cli = DisaggClient(f"127.0.0.1:{srv.port}", eng._kvpool, timeout_s=60.0)
    try:
        ids = eng.tokenize_messages([{"role": "user", "content": MSG_A}])
        n = cli.prefetch(ids, namespace="tenant")
        assert n == (len(ids) - 1) // 16 * 16 and cli._refused is None
        assert srv.counters["handshake_refusals"] == 0 and srv.counters["prefills_served"] == 1
        lease = ref._kvpool.acquire(ids, n, namespace="tenant")
        sent = [_bits(leaf) for leaf in ref._kvpool.export_pages(lease)]
        ref._kvpool.release(lease)
        got = _pages(eng._kvpool, ids, n, namespace="tenant")
        assert len(got) == len(sent) and all(np.array_equal(a, b) for a, b in zip(got, sent))
        assert eng._kvpool.counters["imported_pages"] == n // 16
    finally:
        cli.close()
        _stop_jax_service(srv)


def test_jax_client_imports_the_port_services_pages_byte_for_byte(path):
    eng = _engine(path)
    srv = PrefillServer(eng, host="127.0.0.1", port=0)
    ref = JEngine(path, **KW)
    cli = JDisaggClient(f"127.0.0.1:{srv.port}", ref._kvpool, timeout_s=60.0)
    try:
        ids = ref.tokenize_messages([{"role": "user", "content": MSG_A}])
        n = cli.prefetch(ids, namespace="tenant")
        assert n == (len(ids) - 1) // 16 * 16 and cli._refused is None
        assert srv.counters["handshake_refusals"] == 0 and srv.counters["prefills_served"] == 1
        sent = _pages(eng._kvpool, ids, n, namespace="tenant")
        lease = ref._kvpool.acquire(ids, n, namespace="tenant")
        got = [_bits(leaf) for leaf in ref._kvpool.export_pages(lease)]
        ref._kvpool.release(lease)
        assert len(got) == len(sent) and all(np.array_equal(a, b) for a, b in zip(got, sent))
    finally:
        cli.close()
        srv.stop()


# ---------------------------------------------------------------------------
# the degrades
# ---------------------------------------------------------------------------

def test_peer_dead_midstream_degrades_with_attribution_and_recovers(path, tmp_path,
                                                                    monkeypatch):
    from llama_fastapi_k8s_gpu_tpu_torch.obs import flightrec

    rec = FlightRecorder(directory=str(tmp_path / "inc"), ring=4, debounce_s=0.0,
                         log_lines=20)
    monkeypatch.setattr(flightrec, "FLIGHTREC", rec)
    health = HealthMonitor()
    health.transition(READY, "test")
    want = _text(_greedy(_engine(path)))
    eng_p, eng_d, srv, cli = _pair(path, health=health)
    try:
        FAULTS.arm("peer_dead:error:after=1:times=1")    # after the first PAGE group
        out = _greedy(eng_d)
        assert _text(out) == want
        assert cli.counters["local_fallbacks"] == 1 and cli.counters["remote_prefills"] == 0
        assert eng_d._kvpool.counters["imported_pages"] == 0
        snap = health.snapshot()
        assert snap["state"] == DEGRADED and snap["reason"].startswith("disagg:")
        assert "(peer_dead)" in snap["reason"] and "local-prefill fallback" in snap["reason"]
        assert cli.status()["last_error"].startswith("peer_dead: ")
        assert rec.recorded_total == 1
        bundle = rec.get(rec.list()[0]["id"])
        assert bundle["kind"] == "disagg_peer_dead" and cli.peer in bundle["reason"]
        FAULTS.disarm()
        time.sleep(1.3)                  # past the first reconnect backoff (1 s)
        _greedy(eng_d, text=MSG_B)
        assert cli.counters["remote_prefills"] == 1 and cli.connected()
        assert health.snapshot()["state"] == READY
        assert "restored" in health.snapshot()["reason"]
    finally:
        cli.close()
        srv.stop()


def test_a_torn_frame_imports_nothing(path):
    eng_p, eng_d, srv, cli = _pair(path)
    try:
        # HELLO, HELLO_OK and REQ go out whole; the first PAGE frame is torn
        FAULTS.arm("truncated_frame:error:after=3:times=1")
        assert _text(_greedy(eng_d))
        assert cli.counters["local_fallbacks"] == 1 and cli.counters["remote_prefills"] == 0
        assert eng_d._kvpool.counters["imported_pages"] == 0
    finally:
        cli.close()
        srv.stop()


def test_a_wire_slower_than_the_hop_budget_falls_back(path):
    eng_p, eng_d, srv, cli = _pair(path, timeout_s=1.0)
    try:
        FAULTS.arm("slow_wire:slow:delay=1.5:times=0")
        t0 = time.time()
        assert _text(_greedy(eng_d))
        assert cli.counters["remote_prefills"] == 0 and cli.counters["local_fallbacks"] >= 1
        assert time.time() - t0 < 30
    finally:
        FAULTS.disarm()
        cli.close()
        srv.stop()


def test_a_geometry_mismatch_is_refused_once_and_for_good(path):
    eng_p = _engine(path, kv_dtype="int8")
    eng_d = _engine(path)
    srv = PrefillServer(eng_p, host="127.0.0.1", port=0)
    cli = DisaggClient(f"127.0.0.1:{srv.port}", eng_d._kvpool, timeout_s=60.0)
    eng_d.install_disagg(cli)
    try:
        want = _text(_greedy(_engine(path)))
        assert _text(_greedy(eng_d)) == want
        assert cli._refused == wire.geometry_mismatch(wire.pool_geometry(eng_p._kvpool),
                                                      wire.pool_geometry(eng_d._kvpool))
        assert "geometry mismatch" in cli._refused
        assert srv.counters["handshake_refusals"] == 1
        assert cli.status()["handshake_refused"] == cli._refused
        assert cli.status()["last_error"].startswith("refused: ")
        _greedy(eng_d, text=MSG_B)
        assert cli.counters["reconnects"] == 0 and srv.counters["peers_total"] == 1
    finally:
        cli.close()
        srv.stop()


def test_a_role_that_is_off_is_one_attribute_read(path, monkeypatch):
    eng = _engine(path)
    assert eng._disagg is None

    def poison(*a, **kw):
        raise AssertionError("the off path touched the disagg client")

    monkeypatch.setattr(Engine, "_remote_prefill", poison)
    monkeypatch.setattr(Engine, "_remote_prefill_ids", poison)
    monkeypatch.setattr(DisaggClient, "prefetch", poison)
    assert _text(_greedy(eng))
    ceng = ContinuousEngine(path, device="cpu", batch_size=2, prefill_chunk=16, **KW)
    try:
        assert _text(ceng.submit([{"role": "user", "content": MSG_A}],
                                 temperature=0.0).result(timeout=T))
    finally:
        ceng.shutdown()


def test_prefill_to_pages_exports_what_the_index_holds(path):
    eng = _engine(path)
    ids = eng.tokenize_messages([{"role": "user", "content": MSG_A}])
    leaves, tokens, first = eng.prefill_to_pages(ids, namespace="x")
    assert tokens == len(ids) // 16 * 16 and isinstance(first, int)
    assert [tuple(leaf.shape)[0] for leaf in leaves] == [tokens // 16] * len(leaves)
    again = eng.prefill_to_pages(ids, namespace="x")        # the tier's own radix
    assert again[1] == tokens and again[2] is None
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(leaves, again[0]))
    assert eng.prefill_to_pages(ids[:15], namespace="x") is None
    with pytest.raises(ValueError, match="exceed context window"):
        eng.prefill_to_pages(list(range(300)))
    ring = {k: v.data_ptr() for k, v in eng._cache.items()}
    eng.prefill_to_pages(ids[:40] + [5] * 30, namespace="y")
    assert {k: v.data_ptr() for k, v in eng._cache.items()} == ring   # in place
    with pytest.raises(ValueError, match="LFKT_KV_PAGED"):
        Engine(path, device="cpu", n_ctx=256, prefill_buckets=(64, 128)).prefill_to_pages(ids)


# ---------------------------------------------------------------------------
# build_roles
# ---------------------------------------------------------------------------

class _Dense:
    _kvpool = None


class _Registry:
    _kvpool = None

    def models(self):
        return []


class _Paged:
    _kvpool = object()


@pytest.mark.parametrize("role,engine", [
    ("sideways", _Dense()), ("decode", _Dense()), ("prefill", _Dense()), ("both", _Dense()),
    ("prefill", _Registry()), ("both", _Registry()), ("decode", _Paged()),
])
def test_build_roles_refusals_equal_the_references(role, engine):
    def outcome(fn, settings):
        try:
            return fn(role, engine, settings)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return type(e).__name__, str(e)

    got = outcome(build_roles, Settings())
    assert got == outcome(j_build_roles, JSettings()) and got[0] == "ValueError"
    assert build_roles("off", object(), Settings()) is None
    assert ROLES == ("off", "prefill", "decode", "both")


def test_install_disagg_needs_the_paged_pool(path):
    with pytest.raises(ValueError, match="install_disagg requires LFKT_KV_PAGED=1"):
        Engine(path, device="cpu", n_ctx=256, prefill_buckets=(64, 128)).install_disagg(
            object())


# ---------------------------------------------------------------------------
# the spans
# ---------------------------------------------------------------------------

def _find(span: dict, name: str) -> list:
    out = [span] if span["name"] == name else []
    for c in span.get("children", []):
        out += _find(c, name)
    return out


def test_the_disagg_span_and_the_services_linked_fragment(path):
    tracer = Tracer(sample=1.0, ring=8)
    eng_p, eng_d, srv, cli = _pair(path, tracer=tracer)
    try:
        tr = tracer.start("request")
        _greedy(eng_d, trace=tr)
        tracer.finish(tr)
        doc = tr.to_dict()
        spans = _find(doc["root"], "disagg")
        assert len(spans) == 1 and spans[0]["end"] is not None
        events = [e["name"] for e in spans[0]["events"]]
        assert events == ["handshake", "disagg_recv"]
        recv = spans[0]["events"][1]
        assert recv["pages"] > 4 and recv["bytes"] > 0 and recv["tokens"] == recv["pages"] * 16
        # the service's fragment: linked under the request's trace id
        frags = [t for t in tracer._ring if t.root.name == "disagg.prefill"]
        assert len(frags) == 1 and frags[0].trace_id == doc["trace_id"]
        assert frags[0].parent_span_id == spans[0]["span_id"]
        assert [c.name for c in frags[0].root.children] == ["engine.prefill", "wire.send"]
        assert frags[0].root.children[1].attrs["pages"] == recv["pages"]
    finally:
        cli.close()
        srv.stop()


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------

def _metric_names(text: str, prefix: str) -> set:
    return {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
            if ln.startswith(prefix)}


def test_app_health_block_and_families_beside_the_references(path):
    body = {"bot_profile": {"name": "Ada", "appearance": "a,b,c,d"},
            "user_profile": {"name": "Bob"},
            "context": [{"turn": "user", "message": MSG_A}]}
    wide = dict(KW, n_ctx=1024, prefill_buckets=(128, 256, 512, 1024), kv_page_tokens=64)
    apps = [create_app(engine=_engine(path, **wide),
                       settings=Settings(temperature=0.0, watchdog=False, disagg_role="both",
                                         disagg_timeout_seconds=60.0)),
            j_create_app(engine=JEngine(path, **wide),
                         settings=JSettings(temperature=0.0, watchdog=False,
                                            disagg_role="both", disagg_timeout_seconds=60.0))]

    services = []

    async def go(apps):
        out = []
        services.append(apps[1].state.disagg.server)
        for a in apps:
            st, _, b = await call(a, "POST", "/response", body)
            reply = (st, json.loads(b))
            st, _, h = await call(a, "GET", "/health")
            _, _, m = await call(a, "GET", "/metrics")
            _, _, mem = await call(a, "GET", "/debug/memory")
            out.append((reply, json.loads(h), m.decode(), json.loads(mem)))
        return out

    got, want = serve(apps, go)
    _stop_jax_service(services[0])
    assert got[0][0] == want[0][0] == 200
    dis, jdis = got[1]["disagg"], want[1]["disagg"]
    assert dis["role"] == jdis["role"] == "both"
    assert set(dis) == set(jdis)
    assert set(dis["prefill_service"]) == set(jdis["prefill_service"])
    assert set(dis["peer"]) == set(jdis["peer"])
    assert dis["prefill_service"]["prefills_served"] == 1
    assert dis["peer"]["remote_prefills"] == jdis["peer"]["remote_prefills"]
    names = _metric_names(got[2], "disagg_")
    assert names == _metric_names(want[2], "disagg_")
    assert {"disagg_pages_sent_total", "disagg_bytes_received_total",
            "disagg_peer_connected"} <= names
    rows = {r["component"] for r in got[3]["components"]}
    assert "disagg_txbuf" not in rows or got[3]["armed"]


def test_startup_arms_the_roles_off_the_event_loop(path, monkeypatch):
    """build_roles runs on a worker thread: a refusal stops the page service
    it started, joining the service's accept thread, which must never stall
    the event loop (lfkt-lint ASY001)."""
    import llama_fastapi_k8s_gpu_tpu_torch.serving.disagg as disagg

    threads = {}
    real = disagg.build_roles

    def spy(*a, **kw):
        threads["build_roles"] = threading.current_thread()
        return real(*a, **kw)

    monkeypatch.setattr(disagg, "build_roles", spy)
    app = create_app(engine=_engine(path),
                     settings=Settings(temperature=0.0, watchdog=False, disagg_role="both",
                                       disagg_timeout_seconds=60.0))

    async def go(apps):
        threads["loop"] = threading.current_thread()
        return apps[0].state.disagg.role

    assert serve([app], go) == "both"
    assert threads["build_roles"] is not threads["loop"]

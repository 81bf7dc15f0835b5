"""The port's warm-page migration (serving/fleet/migrate.py and the app's
hooks) on the CPU, held to the JAX package's.

- pools and the real wire, no engines: a pull round trip lands bit-equal
  pages and a re-pull is a warm skip; an int8 ring against a bf16 one is
  refused at the handshake with attribution; the three fault points
  (``migrate_pull``, ``migrate_push``, ``drain_push``) degrade with
  attribution and leave nothing pinned; the drain is a commanded pull;
- across the implementations: the port's ``MigrationManager`` pulls from
  a JAX ``MigrationServer`` and the JAX manager from the port's server —
  the imported pages are byte-equal to the pages sent;
- ``build_migration``'s refusals (no paged pool, a registry) equal the JAX
  package's;
- the app: ``/admin/migrate/hot`` and ``/admin/migrate/pull`` answers and
  refusals and the ``/health`` ``migration`` block beside the JAX app's;
- real tiny engines behind their apps: a router-stamped turn on the new
  owner pulls the prior owner's pages and replies with the owner's bytes;
  stopping a replica runs the SIGTERM drain, whose push lands its hot
  pages on the successor; a replica started beside warm peers pre-pulls
  their hot prefixes before READY.
"""

from __future__ import annotations

import gc
import http.server
import json
import threading
import time

import numpy as np
import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import FakeEngine as JFakeEngine
from llama_fastapi_k8s_gpu_tpu.parallel import kvpool as jkvpool
from llama_fastapi_k8s_gpu_tpu.serving.fleet.migrate import (
    MigrationManager as JMigrationManager,
)
from llama_fastapi_k8s_gpu_tpu.serving.fleet.migrate import (
    MigrationServer as JMigrationServer,
)
from llama_fastapi_k8s_gpu_tpu.serving.fleet.migrate import (
    build_migration as j_build_migration,
)
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import init_cache
from llama_fastapi_k8s_gpu_tpu_torch.parallel.kvpool import KVPool
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.affinity import (
    AFFINITY_KEY_HEADER,
    PRIOR_OWNER_HEADER,
)
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.migrate import (
    MigrationManager,
    MigrationServer,
    build_migration,
)
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings
from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS
from llama_fastapi_k8s_gpu_tpu_torch.utils.metrics import Metrics
from tests.test_torch_fleet import (
    _body,
    _free_port,
    _get_json,
    _post,
    _request,
    _serve_app,
    _serve_jax_app,
)
from tests.test_torch_kvpool import CPU, T, _bits, _cfgs, j_ring, marked, p_ring
from tests.test_torch_openai import FakeEngine

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    FAULTS.disarm()
    yield
    FAULTS.disarm()
    gc.collect()


def _pool(kv_dtype: str = "bf16") -> KVPool:
    return KVPool(_cfgs(kv_dtype)[1], page_tokens=T, n_pages=8, device=CPU)


def _ring(kv_dtype: str = "bf16") -> dict:
    cfg = _cfgs(kv_dtype)[1]
    return p_ring(marked(cfg), cfg)


def _mgr(pool, *, peers: str = "", self_addr: str = "", timeout: float = 2.0,
         drain: float = 3.0, top_k: int = 8, metrics=None, cls=(MigrationServer,
                                                                 MigrationManager, Settings)):
    """A served page service + its manager on an ephemeral port."""
    server_cls, mgr_cls, settings_cls = cls
    server = server_cls(pool, host="127.0.0.1", port=0, metrics=metrics)
    settings = settings_cls(fleet_peers=peers, migrate_self=self_addr,
                            migrate_timeout_seconds=timeout, migrate_drain_seconds=drain,
                            migrate_top_k=top_k)
    return mgr_cls(pool, settings, metrics=metrics, server=server)


def _pages(pool, ids, tokens: int, namespace: str = "") -> list:
    """The pool's page stacks for ``ids[:tokens]``, as numpy bits."""
    lease = pool.acquire(ids, tokens, namespace=namespace)
    assert lease is not None
    try:
        return [_bits(leaf) for leaf in pool.export_pages(lease)]
    finally:
        pool.release(lease)


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# pools and the wire
# ---------------------------------------------------------------------------

def test_pull_round_trip_bitwise_and_warm_skip():
    ring = _ring()
    src, dst = _mgr(_pool()), _mgr(_pool(), metrics=Metrics())
    try:
        ids = list(range(1, 26))                   # 25 ids: 3 whole pages
        assert src._pool.commit(ids, ring, namespace="m") == 3
        assert dst.pull(src.wire_addr, ids, namespace="m") == 24      # (25-1)//8*8
        assert _equal(_pages(dst._pool, ids, 24, "m"), _pages(src._pool, ids, 24, "m"))
        lease = dst._pool.acquire(ids, 24, namespace="m")
        restored = dst._pool.restore(lease, init_cache(_cfgs()[1], CPU))
        dst._pool.release(lease)
        for k, leaf in ring.items():
            assert np.array_equal(_bits(restored[k][:, :, :24]), _bits(leaf[:, :, :24])), k

        assert dst.pull(src.wire_addr, ids, namespace="m") == 24
        assert dst.counters["skipped_warm"] == 1 and dst.counters["pulls"] == 1
        # a warm-up row is a whole cached run: all 3 pages
        assert dst.pull(src.wire_addr, ids[:24], namespace="m", reason="warmup") == 24
        assert dst.pull(src.wire_addr, list(range(900, 930)), namespace="m") == 0
        assert dst.counters["failures"] == 0
        assert src._pool.occupancy()["pages_pinned"] == 0
        assert dst._pool.occupancy()["pages_pinned"] == 0
        assert src.server.status()["pulls_served"] == 1
        assert src.server.status()["pulls_cold"] == 1
        text = dst.metrics.render()
        assert 'kv_migration_pages_total{reason="pulled"} 3' in text
        assert 'kv_migration_pulls_total{reason="remap"} 2' in text
        assert dst.status()["service"]["port"] == dst.server.port
    finally:
        src.close()
        dst.close()


def test_geometry_mismatch_refused_with_attribution():
    """An int8 ring against a bf16 one: refused at the handshake."""
    src, dst = _mgr(_pool("bf16")), _mgr(_pool("int8"))
    try:
        src._pool.commit(list(range(1, 17)), _ring())
        assert dst.pull(src.wire_addr, list(range(1, 18))) == 0
        assert dst.counters["failures"] == 1
        assert dst.last_error.startswith("geometry")
        assert src.server.status()["handshake_refusals"] == 1
    finally:
        src.close()
        dst.close()


def test_fault_points_degrade_attributed():
    src, dst = _mgr(_pool()), _mgr(_pool())
    try:
        ids = list(range(1, 26))
        src._pool.commit(ids, _ring(), namespace="m")
        FAULTS.arm("migrate_pull:error:times=1")
        assert dst.pull(src.wire_addr, ids, namespace="m") == 0
        assert dst.counters["failures"] == 1 and dst.last_error.startswith("wire")
        FAULTS.arm("migrate_push:error:times=1")
        t0 = time.time()
        assert dst.pull(src.wire_addr, ids, namespace="m") == 0
        assert time.time() - t0 < dst.timeout + 2.0 and dst.counters["failures"] == 2
        # the deadline (0.3 s) falls inside the slow hop's delay: the pull
        # ends as the delay does, attributed to the deadline, and never
        # spends the hop knob's budget after it
        delay = 1.0
        FAULTS.arm(f"migrate_pull:slow:delay={delay}:times=1")
        t0 = time.time()
        assert dst.pull(src.wire_addr, ids, namespace="m", deadline=time.time() + 0.3) == 0
        assert time.time() - t0 < delay + dst.timeout
        assert dst.counters["failures"] == 3 and dst.last_error.startswith("deadline")
        FAULTS.disarm()
        assert dst.pull(src.wire_addr, ids, namespace="m") == 24
        assert src._pool.occupancy()["pages_pinned"] == 0
        assert dst._pool.occupancy()["pages_pinned"] == 0
    finally:
        src.close()
        dst.close()


class _SuccessorStub:
    """A successor's HTTP surface minus the engine: /health advertises the
    wire address, POST /admin/migrate/pull runs a real pull."""

    def __init__(self, mgr):
        class H(http.server.BaseHTTPRequestHandler):
            def _reply(self, doc):
                body = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):           # noqa: N802 — stdlib contract
                self._reply({"migration": {"addr": mgr.wire_addr}})

            def do_POST(self):          # noqa: N802 — stdlib contract
                req = json.loads(self.rfile.read(int(self.headers["content-length"])))
                self._reply({"covered": mgr.pull(
                    req["peer"], [int(t) for t in req["ids"]],
                    namespace=str(req.get("namespace") or ""), reason="drain",
                    deadline=req.get("deadline"))})

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()


def test_drain_push_is_a_commanded_pull():
    ring = _ring()
    succ = _mgr(_pool())
    stub = _SuccessorStub(succ)
    me = "127.0.0.1:59999"
    peers = f"127.0.0.1:{stub.port},{me}"
    src = _mgr(_pool(), peers=peers, self_addr=me, top_k=4)
    try:
        a, b = list(range(1, 17)), list(range(100, 125))
        src._pool.commit(a, ring, namespace="m")
        src._pool.commit(b, ring, namespace="m")
        src.record_prompt("conv-a", "m", a)
        src.record_prompt("conv-b", "m", b)
        st = src.status()
        assert st["records"] == 2 and len(st["last_affinity_key"]) == 16
        assert "conv-b" not in json.dumps(st)           # a digest, never the key
        assert src.drain_push() == 2
        assert src.counters["drain_pushes"] == 2 and succ.counters["pulls"] == 2
        assert succ._pool.match_len(a, namespace="m") == 16
        assert succ._pool.match_len(b, namespace="m") == 24
        assert _equal(_pages(succ._pool, b, 24, "m"), _pages(src._pool, b, 24, "m"))
        assert src.pull(succ.wire_addr, b, namespace="m") == 0   # closed: no new pulls
    finally:
        src.close()
    # keyless: the pool's hottest runs; a drain_push fault skips, attributed
    src2 = _mgr(_pool(), peers=peers, self_addr=me, top_k=4)
    try:
        c = list(range(300, 325))
        src2._pool.commit(c, ring, namespace="m")
        FAULTS.arm("drain_push:error:times=1")
        t0 = time.time()
        assert src2.drain_push() == 0
        assert time.time() - t0 < src2.drain_budget + 1.0
        assert src2.counters["drain_failures"] == 1
        assert src2.last_error.startswith("drain_push")
        assert succ._pool.match_len(c, namespace="m") == 0
    finally:
        src2.close()
        succ.close()
        stub.close()


# ---------------------------------------------------------------------------
# across the implementations
# ---------------------------------------------------------------------------

_JAX = (JMigrationServer, JMigrationManager, JSettings)


@pytest.mark.parametrize("direction", ["port_pulls_from_jax", "jax_pulls_from_port"])
def test_cross_implementation_pull_is_byte_equal(direction):
    jcfg, cfg = _cfgs()
    np_ring = marked(cfg)
    jpool = jkvpool.KVPool(jcfg, page_tokens=T, n_pages=8)
    ppool = KVPool(cfg, page_tokens=T, n_pages=8, device=CPU)
    ids = list(range(7, 40))                         # 33 ids: 4 whole pages
    if direction == "port_pulls_from_jax":
        src, dst = _mgr(jpool, cls=_JAX), _mgr(ppool)
        src._pool.commit(ids, j_ring(np_ring, jcfg), namespace="m")
    else:
        src, dst = _mgr(ppool), _mgr(jpool, cls=_JAX)
        src._pool.commit(ids, p_ring(np_ring, cfg), namespace="m")
    try:
        assert dst.pull(src.wire_addr, ids, namespace="m") == 32
        assert dst.counters["failures"] == 0 and dst.counters["pulled_pages"] == 4
        assert _equal(_pages(dst._pool, ids, 32, "m"), _pages(src._pool, ids, 32, "m"))
        assert src.server.status()["pages_sent"] == 4
    finally:
        src.close()
        dst.close()


def test_build_migration_refusals_equal_jax():
    class Unpaged:
        _kvpool = None

    class Registry:          # a registry app's engine: no _kvpool at all
        def models(self):
            return []

    for eng in (Unpaged(), Registry()):
        with pytest.raises(ValueError) as mine:
            build_migration(eng, Settings(migrate=True))
        with pytest.raises(ValueError) as theirs:
            j_build_migration(eng, JSettings(migrate=True))
        assert str(mine.value) == str(theirs.value)
        assert "LFKT_KV_PAGED=1" in str(mine.value)


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------

class _PooledFake(FakeEngine):
    """The port app's stub engine with a paged pool and a tokenizer."""

    _kv_ns = ""

    def __init__(self, pool, **kw):
        super().__init__(**kw)
        self._kvpool = pool

    def tokenize_messages(self, messages):
        return [ord(c) % 250 + 1 for m in messages for c in m["content"]]


class _JPooledFake(JFakeEngine):
    _kv_ns = ""

    def __init__(self, pool, **kw):
        super().__init__(**kw)
        self._kvpool = pool

    def tokenize_messages(self, messages):
        return [ord(c) % 250 + 1 for m in messages for c in m["content"]]


_MIG = dict(migrate=True, migrate_bind="127.0.0.1", migrate_port=0)


def test_app_admin_routes_and_health_block_beside_jax():
    jcfg, cfg = _cfgs()
    pp, jp, off, joff = (_free_port() for _ in range(4))
    ppool = KVPool(cfg, page_tokens=T, n_pages=8, device=CPU)
    ppool.commit(list(range(1, 26)), _ring(), namespace="")
    jpool = jkvpool.KVPool(jcfg, page_tokens=T, n_pages=8)
    jpool.commit(list(range(1, 26)), j_ring(marked(cfg), jcfg), namespace="")
    served = [_serve_app(_PooledFake(ppool), pp, **_MIG),
              _serve_jax_app(_JPooledFake(jpool), jp, **_MIG),
              _serve_app(FakeEngine(), off), _serve_jax_app(JFakeEngine(), joff)]
    try:
        mine, theirs = _get_json(pp, "/health")["migration"], _get_json(jp, "/health")["migration"]
        for doc in (mine, theirs):
            doc["addr"] = doc["addr"].rpartition(":")[0]
            doc["service"]["port"] = 0
        assert mine == theirs
        assert "migration" not in _get_json(off, "/health")
        assert "migration" not in _get_json(joff, "/health")
        for route, body in (("/admin/migrate/hot?k=2", None), ("/admin/migrate/hot?k=x", None),
                            ("/admin/migrate/hot", None),
                            ("/admin/migrate/pull", b"{}"), ("/admin/migrate/pull", b"not json"),
                            ("/admin/migrate/pull", json.dumps({"peer": "nohost", "ids": [1]}
                                                               ).encode())):
            a, b = _request(pp, route, body), _request(jp, route, body)
            assert (a[0], json.loads(a[2])) == (b[0], json.loads(b[2])), route
        assert _get_json(pp, "/admin/migrate/hot")["prefixes"][0]["tokens"] == 24
        for route, body in (("/admin/migrate/hot", None), ("/admin/migrate/pull", b"{}")):
            a, b = _request(off, route, body), _request(joff, route, body)
            assert a[0] == b[0] == 404 and json.loads(a[2]) == json.loads(b[2])
        # a commanded pull from a dead page service: covered 0, attributed
        a = _request(pp, "/admin/migrate/pull",
                     json.dumps({"peer": f"127.0.0.1:{_free_port()}", "ids": list(range(50, 70)),
                                 "deadline": time.time() + 2}).encode())
        assert a[0] == 200 and json.loads(a[2]) == {"covered": 0}
        assert _get_json(pp, "/health")["migration"]["last_error"].startswith("wire")
        assert 'kv_migration_failures_total{reason="wire"} 1' in \
            _request(pp, "/metrics")[2].decode()
    finally:
        for s in served:
            s.stop()


# ---------------------------------------------------------------------------
# real tiny engines
# ---------------------------------------------------------------------------

KW = dict(n_ctx=256, prefill_buckets=(64, 128), max_gen_tokens=8, decode_chunk=4,
          kv_paged=True, kv_page_tokens=16)
OPENER = "The quick brown fox jumps over the lazy dog by the river"


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("migrate") / "tiny.gguf")
    write_tiny_llama_gguf(p)
    return p


def _engine(path):
    return Engine(path, device="cpu", **KW)


def _turns(conv: int = 3):
    first = [{"turn": "user", "message": f"{OPENER} {conv}"}]
    second = first + [{"turn": "bot", "message": "Sure."},
                      {"turn": "user", "message": "And then?"}]
    return _body(conv, first), _body(conv, second)


def test_router_stamped_turn_pulls_and_replies_as_the_owner(gguf_path):
    """B, stamped with A as the prior owner, pulls the conversation's pages
    before its prefill: the pages equal A's bit for bit, and B's reply to
    the turn equals A's own reply over its local hit, byte for byte."""
    pa, pb = _free_port(), _free_port()
    ea, eb = _engine(gguf_path), _engine(gguf_path)
    sa = _serve_app(ea, pa, **_MIG)
    sb = _serve_app(eb, pb, **_MIG)
    try:
        turn1, turn2 = _turns()
        assert _post(pa, turn1, timeout=300)[0] == 200
        st, reply_b = _post(pb, turn2, timeout=300, headers={
            PRIOR_OWNER_HEADER: f"127.0.0.1:{pa}", AFFINITY_KEY_HEADER: "p:conv3"})
        assert st == 200
        mig = _get_json(pb, "/health")["migration"]
        assert mig["counters"]["pulls"] == 1 and mig["counters"]["failures"] == 0
        pulled = mig["counters"]["pulled_tokens"]
        assert pulled >= 16 and mig["records"] == 1
        reused_b = eb.last_timings["prefix_reused_tokens"]
        assert reused_b > 0
        st, reply_a = _post(pa, turn2, timeout=300)
        assert st == 200 and ea.last_timings["prefix_reused_tokens"] == reused_b
        assert reply_b == reply_a
        # the pulled prefix, page for page, in both arenas
        prefix = eb._kvpool.hot_prefixes(8)
        run = next(r["ids"] for r in prefix if len(r["ids"]) >= pulled)[:pulled]
        assert _equal(_pages(eb._kvpool, run, pulled), _pages(ea._kvpool, run, pulled))
        assert _get_json(pa, "/health")["migration"]["service"]["pulls_served"] == 1
    finally:
        sa.stop()
        sb.stop()


def test_sigterm_drain_and_scale_out_warm_up(gguf_path):
    """Stopping replica A runs the httpd drain, whose push lands A's hot
    conversation on B before A's page service closes; a replica C started
    with B as its peer pre-pulls B's hot prefixes before READY and its
    first turn of that conversation reuses them."""
    pa, pb, pc = (_free_port() for _ in range(3))
    common = dict(_MIG, fleet_peers=f"127.0.0.1:{pa},127.0.0.1:{pb}",
                  migrate_drain_seconds=5.0, migrate_timeout_seconds=10.0, migrate_top_k=4)
    sb = _serve_app(_engine(gguf_path), pb, migrate_self=f"127.0.0.1:{pb}", **common)
    sa = _serve_app(_engine(gguf_path), pa, migrate_self=f"127.0.0.1:{pa}", **common)
    sc = None
    try:
        turn1, _turn2 = _turns(5)
        assert _post(pa, turn1, timeout=300, headers={AFFINITY_KEY_HEADER: "p:conv5"})[0] == 200
        sa.stop(join_s=30)                               # the SIGTERM drain path
        doc = _get_json(pb, "/health")["migration"]
        assert doc["counters"]["pulls"] == 1 and doc["counters"]["pulled_pages"] >= 1
        assert 'kv_migration_pulls_total{reason="drain"} 1' in _request(pb, "/metrics")[2].decode()
        ec = _engine(gguf_path)
        sc = _serve_app(ec, pc, **dict(common, fleet_peers=f"127.0.0.1:{pb}",
                                       migrate_self=f"127.0.0.1:{pc}"))
        assert 'kv_migration_pulls_total{reason="warmup"} 1' in \
            _request(pc, "/metrics")[2].decode()
        assert _get_json(pc, "/health")["migration"]["counters"]["warmup_pulls"] == 1
        assert _post(pc, turn1, timeout=300)[0] == 200
        assert ec.last_timings["prefix_reused_tokens"] > 0
    finally:
        sa.stop()
        sb.stop()
        if sc is not None:
            sc.stop()

"""The port's observability layer against the JAX package's.

``parse_traceparent``, the tracer's sampling and ring, the metric catalog
and ``Metrics.render()`` give the same results on the same inputs; after
the same requests on both apps, ``/metrics`` carries the same families
(name, type, label keys), and ``/debug/traces`` the same span-name tree
for the serial engine.
"""

from __future__ import annotations

import asyncio
import gc
import io
import json
import logging
import re

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.obs import catalog as jcatalog
from llama_fastapi_k8s_gpu_tpu.obs import trace as jtrace
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils import metrics as jmetrics
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.obs import catalog, devtime, logctx, trace
from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
from llama_fastapi_k8s_gpu_tpu_torch.utils import metrics
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

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
MSGS = [{"role": "user", "content": "tell me about cats"}]


TRACEPARENTS = [
    None, "", "garbage", "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "CD" * 8 + "-01", "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
    "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01", "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01",
    " 00-" + "ab" * 16 + "-" + "cd" * 8 + "-01 ", "00-" + "ab" * 16 + "-" + "cd" * 8,
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra",
]


@pytest.mark.parametrize("value", TRACEPARENTS)
def test_parse_traceparent_like_the_reference(value):
    assert trace.parse_traceparent(value) == jtrace.parse_traceparent(value)


@pytest.mark.parametrize("sample", [0.0, 0.25, 1 / 3, 0.5, 1.0])
def test_sampling_and_ring_like_the_reference(sample):
    """Deterministic counter sampling picks the same requests; the ring
    keeps the same newest traces."""
    picks = []
    for mod in (trace, jtrace):
        t = mod.Tracer(sample=sample, ring=3)
        got = []
        for i in range(12):
            tr = t.start()
            got.append(tr is not None)
            if tr is not None:
                tr.note(i=i)
                t.finish(tr)
        stats = t.stats()
        picks.append((got, stats, [s["meta"]["i"] for s in t.traces()]))
    assert picks[0] == picks[1]


def test_trace_tree_export_like_the_reference():
    """The same producer calls export the same tree (ids and times
    masked): open spans swept closed, the node cap counting drops."""
    def build(mod):
        t = mod.Tracer(sample=1.0, ring=4)
        tr = t.start("request", traceparent="00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
        sp = tr.span("engine").set(engine="Engine")
        sp.child("prefill").set(n_prompt=3).end()
        for i in range(600):
            sp.child("decode_chunk").set(tokens=i).end()
        sp.event("note", k=1)
        tr.span("left_open")
        tr.note(tokens=7)
        t.annotate_inflight("fault_fired", point="decode_step")
        t.finish(tr)
        t.finish(tr)
        return mask(tr.to_dict()), tr.traceparent().split("-")[1]

    assert build(trace) == build(jtrace)


def mask(d):
    if isinstance(d, dict):
        return {k: ("<t>" if k in ("start", "end", "duration_s", "at", "span_id")
                    and v is not None else mask(v)) for k, v in d.items()}
    if isinstance(d, list):
        return [mask(v) for v in d]
    return d


def test_span_traceparent():
    t = trace.Tracer(sample=1.0, ring=2)
    tr = t.start()
    sp = tr.span("x")
    assert trace.span_traceparent(None) is None
    assert trace.span_traceparent(tr) == tr.traceparent()
    assert trace.span_traceparent(sp) == f"00-{tr.trace_id}-{sp.span_id}-01"
    assert trace.parse_traceparent(trace.span_traceparent(sp)) == (tr.trace_id, sp.span_id)


def test_catalog_families_are_the_references():
    for name, m in catalog.METRICS.items():
        ref = jcatalog.METRICS[name]
        assert (m.name, m.mtype, m.help, m.buckets, m.labels) == (
            ref.name, ref.mtype, ref.help, ref.buckets, ref.labels), name
    assert catalog.lookup("nope") is None


def _drive(mod):
    m = mod.Metrics()
    m.inc("http_requests_total", route="/response", code="200")
    m.inc("http_requests_total", 2, route="/v1/chat/completions", code="400")
    m.inc("engine_errors_total")
    m.set_gauge("health_state", 1)
    m.set_gauge("queue_depth", 3)
    m.set_gauge("queue_depth", 2)
    for v in (0.003, 0.02, 0.2, 0.7, 3.0, 7.5, 30.0, 90.0):
        m.observe("request_seconds", v, route="/response")
    m.observe("engine_ttft_seconds", 0.12, bucket="128", model="tiny")
    m.observe("engine_decode_tokens_per_sec", 123.4, model="tiny")
    m.set_gauge("model_weight_bytes", 1 << 30, model='a "quoted"\nname')
    m.set_gauge("kv_cache_bytes", 134217728)
    m.reset_family("queue_depth")
    errors = []
    for bad in (lambda: m.inc("nope"), lambda: m.inc("health_state"),
                lambda: m.inc("http_requests_total", route="/x"),
                lambda: m.reset_family("http_requests_total")):
        try:
            bad()
        except KeyError as e:
            errors.append(str(e))
    return m.render(), errors


def test_metrics_render_like_the_reference():
    assert _drive(metrics) == _drive(jmetrics)


@pytest.fixture(autouse=True)
def _collect_engines():
    """Engines of earlier test files in this process may sit in reference
    cycles until a collection, their memory-ledger rows with them: collect
    before each test, so ``/debug/memory`` lists this file's engines."""
    gc.collect()
    yield


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obs") / "tiny-q8_0.gguf")
    write_tiny_llama_gguf(path)
    kw = dict(n_ctx=1024, max_gen_tokens=12, decode_chunk=4)
    return JEngine(path, **kw), Engine(path, device="cpu", **kw)


async def call(app, method, path, body=None, headers=()):
    data = b"" if body is None else json.dumps(body).encode()
    inbox = [{"type": "http.request", "body": data, "more_body": False}]
    sent = []
    stay = asyncio.Event()

    async def receive():
        if inbox:
            return inbox.pop(0)
        await stay.wait()
        return {"type": "http.disconnect"}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": method, "path": path, "query_string": b"",
               "headers": [(b"host", b"test"), *headers]}, receive, send)
    hdrs = {k.decode(): v.decode() for k, v in sent[0]["headers"]}
    return sent[0]["status"], hdrs, b"".join(m.get("body", b"") for m in sent[1:])


def serve(apps, fn):
    async def main():
        for a in apps:
            await a.router.startup()
        try:
            return await fn(apps)
        finally:
            for a in apps:
                await a.router.shutdown()
    return asyncio.run(main())


REQUESTS = [
    ("POST", "/response", BODY),
    ("POST", "/response/stream", BODY),
    ("POST", "/v1/chat/completions", {"messages": MSGS, "max_tokens": 6}),
    ("POST", "/v1/chat/completions", {"messages": MSGS, "max_tokens": 6, "stream": True}),
    ("POST", "/v1/chat/completions", {"messages": MSGS, "n": 3}),
    ("POST", "/response", {"context": 5}),
    ("GET", "/v1/models", None),
    ("GET", "/items/7", None),
    ("GET", "/nope", None),
    ("GET", "/health", None),
]


def _apps(engines):
    je, te = engines
    return [j_create_app(engine=je, settings=JSettings(temperature=0.0),
                         tracer=jtrace.Tracer(sample=1.0, ring=64)),
            create_app(engine=te, settings=Settings(temperature=0.0),
                       tracer=trace.Tracer(sample=1.0, ring=64))]


def _families(text: str) -> dict:
    """{family: (type, label keys)} of a Prometheus exposition."""
    out, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ")
            types[name] = typ
            out.setdefault(name, (typ, set()))
        elif line and not line.startswith("#"):
            series = line.split(" ")[0]
            name, _, labels = series.partition("{")
            for suffix in ("_bucket", "_sum", "_count"):
                base = name[: -len(suffix)] if name.endswith(suffix) else None
                if base in types and types[base] == "histogram":
                    name = base
            keys = {kv.split("=")[0] for kv in re.findall(r'(\w+)="', labels)} - {"le"}
            out[name][1].update(keys)
    return {k: (t, tuple(sorted(v))) for k, (t, v) in out.items()}


def test_metrics_families_after_the_same_requests(engines):
    """Every family the port emits is the reference's, with its type and
    label keys, and none of the reference's is missing; the counters agree
    where the requests fix them."""
    async def go(apps):
        for method, path, body in REQUESTS:
            for a in apps:
                await call(a, method, path, body)
        for a in apps:
            # a stream's client has its [DONE] before the consumer counts it
            await a.state.queue.join()
        return [await call(a, "GET", "/metrics") for a in apps]

    # the JAX engine compiles on the CPU; the port compiles only on the card
    # (a graph capture, the kernel build), so its registry gets the capture
    # a card's warmup records
    devtime.record_compile("decode_chunk", "top_k=40", 0.25)
    ref, got = serve(_apps(engines), go)
    assert ref[0] == got[0] == 200
    assert got[1]["content-type"] == ref[1]["content-type"] == "text/plain; charset=utf-8"
    ref_f, got_f = _families(ref[2].decode()), _families(got[2].decode())
    missing = {name for name in ref_f if name not in got_f}
    assert not missing, missing
    assert set(got_f) <= set(ref_f)
    for name, typ in got_f.items():
        assert typ == ref_f[name], name
    assert "watchdog_trips_total" not in got_f          # nothing tripped
    def counters(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith(("http_requests_total", "health_state",
                                          "kv_cache_bytes", "generated_tokens_total",
                                          "streamed_generations_total")))
    assert counters(got[2].decode()) == counters(ref[2].decode())


def _tree(span: dict):
    """The span-name tree, siblings in name order (a stream's ``stream`` and
    ``queue`` spans open in the order the event loop runs two tasks)."""
    return (span["name"], sorted(_tree(c) for c in span["children"]))


def test_span_name_trees_like_the_reference(engines):
    """``/debug/traces/{id}`` of each request has the JAX app's span-name
    tree (request → queue, engine → prefill, decode_chunk…, stream), every
    span ending within its parent; ``/debug/traces`` lists them."""
    async def go(apps):
        out = []
        for method, path, body in REQUESTS[:4]:
            row = []
            for a in apps:
                _, hdrs, _ = await call(a, method, path, body)
                _, _, doc = await call(a, "GET", f"/debug/traces/{hdrs['x-request-id']}")
                row.append(json.loads(doc))
            out.append(row)
        lists = [json.loads((await call(a, "GET", "/debug/traces"))[2]) for a in apps]
        return out, lists

    rows, (ref_list, got_list) = serve(_apps(engines), go)
    for ref, got in rows:
        assert _tree(got["root"]) == _tree(ref["root"])
        assert got["finished"] and not got["dropped_nodes"]
        assert set(got["meta"]) == set(ref["meta"])
        _within(got["root"])
        names = [c["name"] for c in got["root"]["children"]]
        assert "queue" in names and "engine" in names
        engine = next(c for c in got["root"]["children"] if c["name"] == "engine")
        assert engine["children"][0]["name"] == "prefill"
        assert {c["name"] for c in engine["children"][1:]} == {"decode_chunk"}
        assert engine["attrs"]["completion_tokens"] >= 1
    assert [t["name"] for t in got_list["traces"]] == [t["name"] for t in ref_list["traces"]]
    assert set(got_list["stats"]) == set(ref_list["stats"])


def _within(span, lo=None, hi=None):
    assert span["end"] is not None and span["start"] <= span["end"]
    if lo is not None:
        assert lo <= span["start"] and span["end"] <= hi, span["name"]
    for c in span["children"]:
        _within(c, span["start"], span["end"])


def test_request_id_headers_and_traceparent_ingest(engines):
    tp = "00-" + "cd" * 16 + "-" + "ef" * 8 + "-01"

    async def go(apps):
        out = []
        for a in apps:
            r1 = await call(a, "GET", "/items/1", headers=[(b"traceparent", tp.encode())])
            r2 = await call(a, "GET", f"/debug/traces/{'cd' * 16}")
            r3 = await call(a, "GET", "/debug/traces/deadbeef")
            r4 = await call(a, "GET", "/debug/requests")
            out.append((r1, r2, r3, r4))
        return out

    for r1, r2, r3, r4 in serve(_apps(engines), go):
        assert r1[1]["x-request-id"] == "cd" * 16
        assert r1[1]["traceparent"].startswith("00-" + "cd" * 16 + "-")
        assert json.loads(r2[2])["parent_span_id"] == "ef" * 8
        assert r3[0] == 404
        assert json.loads(r4[2])["requests"][0]["route"] == "/debug/requests"
    (a1, _, a3, _), (b1, _, b3, _) = serve(_apps(engines), go)
    assert a3[2] == b3[2]


def test_sampled_out_requests_still_get_request_ids(engines):
    je, te = engines
    app = create_app(engine=te, settings=Settings(temperature=0.0),
                     tracer=trace.Tracer(sample=0.0, ring=4))

    async def go(apps):
        return [await call(apps[0], "GET", "/items/2") for _ in range(2)]

    r1, r2 = serve([app], go)
    assert r1[1]["x-request-id"] != r2[1]["x-request-id"]
    assert "traceparent" not in r1[1]


def test_zero_cost_when_sampled_out(engines, monkeypatch):
    """A request with no trace allocates no span anywhere in the engine."""
    _, te = engines

    def boom(*a, **k):
        raise AssertionError("span built for a sampled-out request")

    monkeypatch.setattr(trace.Span, "__init__", boom)
    out = te.create_chat_completion(MSGS, temperature=0.0, max_tokens=8, trace=None)
    assert out["usage"]["completion_tokens"] >= 1


def test_json_log_lines_carry_the_request_id(engines):
    _, te = engines
    buf = io.StringIO()
    access = logging.getLogger("lfkt.access")
    handler = logctx.setup_json_logging(access, stream=buf)
    level = access.level
    access.setLevel(logging.INFO)
    try:
        app = create_app(engine=te, settings=Settings(temperature=0.0))
        status, hdrs, _ = serve([app], lambda apps: call(apps[0], "GET", "/items/3"))
    finally:
        access.removeHandler(handler)
        access.setLevel(level)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rec["request_id"] == hdrs["x-request-id"]
    assert (rec["route"], rec["method"], rec["status"]) == ("/items/{item_id}", "GET", 200)
    stamp = logctx.RequestIdFilter()
    record = logging.LogRecord("x", logging.INFO, __file__, 1, "m", None, None)
    with logctx.bind_request_id("abc"):
        stamp.filter(record)
        assert record.request_id == "abc"
    stamp.filter(record)
    assert record.request_id == "-"


async def _get(app, target: str):
    """GET ``target`` (path and query) → (status, JSON body)."""
    path, _, query = target.partition("?")
    sent = []

    async def receive():
        return {"type": "http.request", "body": b"", "more_body": False}

    async def send(message):
        sent.append(message)

    await app({"type": "http", "method": "GET", "path": path,
               "query_string": query.encode(), "headers": [(b"host", b"test")]},
              receive, send)
    return sent[0]["status"], json.loads(b"".join(m.get("body", b"") for m in sent[1:]))


def _shape(doc):
    """A document's keys, recursively (a list by its first element)."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_shape(doc[0])] if doc else []
    return type(doc).__name__ if doc is not None else None


#: (target, profiler state, what of the documents must be equal)
DEBUG_ROUTES = [
    ("/debug/compiles", None, "keys"),
    ("/debug/slo", None, "keys"),
    ("/debug/memory", None, "keys"),
    ("/debug/incidents", None, "all"),
    ("/debug/incidents/inc-000001-watchdog_trip", None, "all"),
    ("/debug/incidents/..%2F..%2Fetc%2Fpasswd", None, "all"),
    ("/debug/profile", None, "all"),
    ("/debug/profile?seconds=0.1", "busy", "all"),
    ("/debug/profile?seconds=nan", "dir", "all"),
    ("/debug/profile?seconds=x", "dir", "all"),
]


@pytest.mark.parametrize("target,profiler,equal", DEBUG_ROUTES)
def test_debug_routes_like_the_reference(engines, target, profiler, equal, tmp_path,
                                         monkeypatch):
    """The device-facing debug routes answer the JAX app's status codes and
    documents (403 without LFKT_PROFILE_DIR, 409 while a capture runs, 400
    for a bad ``seconds``, 404 for an unknown or malformed incident id);
    documents whose numbers depend on the package are held by their keys."""
    from llama_fastapi_k8s_gpu_tpu.utils import tracing as jtracing
    from llama_fastapi_k8s_gpu_tpu_torch.utils import tracing

    if profiler:
        monkeypatch.setenv("LFKT_PROFILE_DIR", str(tmp_path / "prof"))
    locks = [jtracing._CAPTURE_LOCK, tracing._CAPTURE_LOCK] if profiler == "busy" else []
    for lock in locks:
        assert lock.acquire(blocking=False)

    async def go(apps):
        for method, path, body in REQUESTS[:3]:
            for a in apps:
                await call(a, method, path, body)
        return [await _get(a, target) for a in apps]

    try:
        (ref_st, ref), (st, got) = serve(_apps(engines), go)
    finally:
        for lock in locks:
            lock.release()
    assert st == ref_st, (st, got, ref)
    if equal == "all":
        assert got == ref
    else:
        assert set(got) == set(ref)
        if target == "/debug/slo":
            assert _shape(got) == _shape(ref)
        if target == "/debug/compiles":
            assert {tuple(sorted(p)) for p in got["programs"]} == \
                {tuple(sorted(p)) for p in ref["programs"]}
        if target == "/debug/memory":
            assert got["components"] == ref["components"]


def test_debug_profile_captures_a_trace(engines, tmp_path, monkeypatch):
    """With LFKT_PROFILE_DIR set, ``/debug/profile`` returns the
    reference's document plus the Chrome trace it wrote and the seconds
    the profiler took to start."""
    monkeypatch.setenv("LFKT_PROFILE_DIR", str(tmp_path / "prof"))

    async def go(apps):
        return await _get(apps[1], "/debug/profile?seconds=0.05")

    st, doc = serve(_apps(engines), go)
    assert st == 200 and doc["ok"] and doc["seconds"] == 0.05
    assert set(doc) == {"ok", "dir", "seconds", "wall_s", "start_s", "trace"}
    with open(doc["trace"]) as fh:
        assert "traceEvents" in json.load(fh)


@pytest.mark.parametrize("knob", [True, False])
def test_startup_prepares_the_profiler_once_when_the_knob_is_set(engines, tmp_path,
                                                                  monkeypatch, knob):
    """With LFKT_PROFILE_DIR set, the app's startup starts and stops one
    profiler before READY (the set-up a first capture would otherwise pay
    inside its window), a second app's startup and a later capture do not
    prepare it again, and the capture still answers the reference's
    document; with the knob unset, startup builds no profiler and the
    capture stays 403."""
    from llama_fastapi_k8s_gpu_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "_PREPARED", {"count": 0, "seconds": None})
    built = []
    real = tracing._profiler

    def counted():
        built.append(1)
        return real()

    monkeypatch.setattr(tracing, "_profiler", counted)
    if knob:
        monkeypatch.setenv("LFKT_PROFILE_DIR", str(tmp_path / "prof"))
    else:
        monkeypatch.delenv("LFKT_PROFILE_DIR", raising=False)
    _, te = engines
    first, second = (create_app(engine=te, settings=Settings(temperature=0.0))
                     for _ in range(2))
    seen = {}

    async def go(apps):
        seen["startup"] = (tracing.profiler_prepared(), len(built))
        await second.router.startup()
        try:
            seen["second"] = (tracing.profiler_prepared(), len(built))
            seen["capture"] = await _get(first, "/debug/profile?seconds=0.05")
        finally:
            await second.router.shutdown()
        seen["after"] = (tracing.profiler_prepared(), len(built))

    serve([first], go)
    (prep, n0), (prep2, n1) = seen["startup"], seen["second"]
    status, doc = seen["capture"]
    if knob:
        assert prep["count"] == 1 and prep["seconds"] is not None and n0 == 1
        assert prep2["count"] == 1 and n1 == 1
        assert status == 200 and doc["ok"] and doc["start_s"] is not None
        assert seen["after"] == ({**prep}, 2)        # the capture's own profiler
    else:
        assert prep == {"count": 0, "seconds": None} and n0 == n1 == 0
        assert status == 403
        assert seen["after"] == ({"count": 0, "seconds": None}, 0)

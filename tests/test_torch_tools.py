"""The port's operator tools (``llama_fastapi_k8s_gpu_tpu_torch/tools/``) held
to the JAX package's (``tools/``) on the CPU.

- ``incident_report``: the listing and each bundle's summary equal the JAX
  tool's on one ring holding bundles of both recorders; ``--validate``
  accepts and refuses the bundles the JAX tool does (drift included);
- ``fleet_trace``: on one traced request through a port router and a port
  replica, the render, the ``--json`` document and the routerless
  ``--peers`` render equal the JAX tool's; the renderer it carries equals
  ``tools/trace_report.py``'s on every span and event kind;
- ``tools/trace_report.py`` (stdlib, no copy) renders a port pod's
  ``/debug/traces`` waterfall;
- ``lint_report``: the per-rule table and the baseline ratchet (a new
  finding fails, a grandfathered one is tolerated, a shrink is reported),
  and the committed empty port baselines are green;
- ``ci_gate``: the ``--json`` shape, ``--skip``, ``--cuda``, a failing check
  turning the exit nonzero, and every test selection naming real tests;
- ``fault_drill --device cpu``: READY → DEGRADED → READY on a real engine.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import logging
import os
import subprocess
import sys
import time

import pytest

from llama_fastapi_k8s_gpu_tpu.obs import flightrec as jflightrec
from llama_fastapi_k8s_gpu_tpu.utils.health import HealthMonitor as JHealthMonitor
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.obs import flightrec
from llama_fastapi_k8s_gpu_tpu_torch.obs.trace import Tracer
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.router import FleetRouter
from llama_fastapi_k8s_gpu_tpu_torch.tools import ci_gate, fleet_trace, incident_report, lint_report
from llama_fastapi_k8s_gpu_tpu_torch.tools.tinymodel import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.utils.health import DEGRADED, READY, HealthMonitor
from llama_fastapi_k8s_gpu_tpu_torch.utils.metrics import Metrics
from tests.test_torch_fleet import (
    KW,
    _body,
    _free_port,
    _get_json,
    _request,
    _serve_app,
    _serve_router,
    _table,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")
PKG = "llama_fastapi_k8s_gpu_tpu_torch"


def _jax_tool(name: str):
    """tools/<name>.py of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, capsys) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of one CLI ``main(argv)`` in process."""
    capsys.readouterr()
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, out.out, out.err


# ---------------------------------------------------------------------------
# incident_report
# ---------------------------------------------------------------------------

def _record_both(directory: str) -> None:
    """Two bundles from the port's recorder, then two from the JAX one (it
    continues the ring's sequence), each with a health trail and a log tail."""
    mine = flightrec.FlightRecorder(directory=directory, ring=16, debounce_s=0.0,
                                    log_lines=50)
    hm = HealthMonitor()
    hm.transition(READY, "engine loaded")
    hm.transition(DEGRADED, "exception_burst")
    mine.install(health=hm)
    logging.getLogger("lfkt.tools-test").warning("port breadcrumb %d", 7)
    mine.record("watchdog_trip", "exception_burst: >=3 engine errors", extra={"k": 1})
    mine.record("fleet_peer_ejected", "probe failed", extra={"peer": "127.0.0.1:9"})
    mine.configure(directory="")
    ref = jflightrec.FlightRecorder(directory=directory, ring=16, debounce_s=0.0,
                                    log_lines=50)
    jhm = JHealthMonitor()
    jhm.transition("READY", "engine loaded")
    ref.install(health=jhm)
    logging.getLogger("lfkt.tools-test").warning("jax breadcrumb")
    ref.record("dead_escalation", "recovery budget exhausted")
    ref.record("slo_breach", "ttft burn 14.4x")
    ref.configure(directory="")


@pytest.fixture
def ring(tmp_path):
    d = str(tmp_path / "ring")
    _record_both(d)
    assert len(os.listdir(d)) == 4
    return d


def _drift(directory: str, how: str) -> None:
    """One more bundle in ``directory``, broken by ``how``."""
    names = sorted(n for n in os.listdir(directory) if n.endswith(".json"))
    with open(os.path.join(directory, names[0])) as f:
        doc = json.load(f)
    bad = copy.deepcopy(doc)
    bad["id"] = "inc-000099-watchdog_trip"
    if how == "schema":
        bad["schema"] = flightrec.SCHEMA + 1
    elif how == "missing":
        del bad["traces"], bad["memory"]
    elif how == "kind":
        bad["kind"] = "made_up_kind"
    elif how == "types":
        bad["at"], bad["reason"], bad["health"] = "yesterday", 3, ["READY"]
    path = os.path.join(directory, "inc-000099-watchdog_trip.json")
    with open(path, "w") as f:
        if how == "unparseable":
            f.write('{"schema": 1, "id": ')
        else:
            json.dump(bad, f)


def test_incident_listing_and_summaries_equal_jax(ring, capsys):
    jtool = _jax_tool("incident_report")
    mine = _run(incident_report.main, ["--dir", ring], capsys)
    theirs = _run(jtool.main, ["--dir", ring], capsys)
    assert mine == theirs and mine[0] == 0
    assert mine[1].count("\n") == 2 + 4 and "(schema 1)" in mine[1]
    for name in sorted(os.listdir(ring)):
        argv = ["--dir", ring, "--id", name[:-5]]
        mine = _run(incident_report.main, argv, capsys)
        assert mine == _run(jtool.main, argv, capsys) and mine[0] == 0
        assert mine[1].startswith(f"incident {name[:-5]}")
    assert "breadcrumb" in _run(incident_report.main,
                                ["--dir", ring, "--id", "inc-000001-watchdog_trip"], capsys)[1]
    # an empty ring and an unknown id alike
    empty = os.path.join(os.path.dirname(ring), "empty")
    os.makedirs(empty)
    assert _run(incident_report.main, ["--dir", empty], capsys) == \
        _run(jtool.main, ["--dir", empty], capsys)
    missing = ["--dir", ring, "--id", "inc-000042-slo_breach"]
    assert _run(incident_report.main, missing, capsys)[0] == \
        _run(jtool.main, missing, capsys)[0] == 1


#: bundles with every field ``render_bundle`` reads, and the sparse ones
_FULL = {
    "id": "inc-000007-resource_exhausted", "kind": "resource_exhausted",
    "reason": "CUDA out of memory", "schema": 1, "at": 1.7e9,
    "memory": {"armed": True, "residual_bytes": 12_345_678,
               "headroom": {"bytes": 2e9, "limit": 80e9},
               "components": [{"component": "weights", "model": "main", "bytes": 4.9e9},
                              {"component": "kv_ring", "bytes": 1.3e8},
                              {"component": "kv_spill", "bytes": 5e7, "device": False}]},
    "health": {"state": "DEGRADED", "reason": "oom",
               "transitions": [{"from": "READY", "to": "DEGRADED", "reason": "oom"}]},
    "scheduler": {"lanes_live": 3, "pending": 2, "admission_inflight": 1,
                  "adm_budget_tokens": 512, "mem_pressure": True, "other": 9},
    "recompile": {"storms_total": 2, "storms": [{"program": "decode_chunk",
                                                 "signatures": 40, "budget": 32}]},
    "traces": [{"trace_id": "ab" * 16, "meta": {"route": "/response", "tokens": 12}},
               {"trace_id": "cd" * 16}],
    "log_tail": [{"level": "WARNING", "message": f"line {i}"} for i in range(14)],
    "extra": {}, "fleet": None,
}


@pytest.mark.parametrize("doc", [
    _FULL,
    {**_FULL, "memory": {"armed": False}, "health": None, "scheduler": None,
     "recompile": {}, "traces": [], "log_tail": []},
    {"id": "inc-000001-slo_breach", "kind": "slo_breach", "reason": "r"},
    {},
], ids=["full", "sparse", "minimal", "empty"])
def test_incident_summary_render_equals_jax(doc):
    assert incident_report.render_bundle(doc) == _jax_tool("incident_report").render_bundle(doc)


@pytest.mark.parametrize("how", [None, "schema", "missing", "kind", "types", "unparseable"])
def test_incident_validate_agrees_with_jax(ring, how, capsys):
    if how is not None:
        _drift(ring, how)
    jtool = _jax_tool("incident_report")
    mine = _run(incident_report.main, ["--validate", "--dir", ring], capsys)
    theirs = _run(jtool.main, ["--validate", "--dir", ring], capsys)
    assert mine[0] == theirs[0] == (0 if how is None else 1)
    if how == "unparseable":
        # the parser's message is the only difference the two may show
        assert mine[1].splitlines()[-1] == theirs[1].splitlines()[-1]
    else:
        assert mine == theirs
    n = 4 if how is None else 5
    assert f"({n} bundle(s)" in mine[1]


def test_incident_validate_with_nothing_to_read(tmp_path, monkeypatch, capsys):
    jtool = _jax_tool("incident_report")
    monkeypatch.delenv("LFKT_INCIDENT_DIR", raising=False)
    for argv in (["--validate", "--dir", ""], ["--validate", "--dir", str(tmp_path / "nope")]):
        mine = _run(incident_report.main, argv, capsys)
        assert mine == _run(jtool.main, argv, capsys) and mine[0] == 0
    assert _run(incident_report.main, [], capsys)[0] == 2      # no --dir to list


def test_incident_report_cli_reads_the_env_dir(ring):
    env = dict(os.environ, LFKT_INCIDENT_DIR=ring)
    r = subprocess.run([sys.executable, "-m", f"{PKG}.tools.incident_report", "--validate"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and "incident-schema: OK (4 bundle(s), 0 violation(s))" in r.stdout


# ---------------------------------------------------------------------------
# fleet_trace and the waterfall renderer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("tools") / "tiny.gguf")
    write_tiny_llama_gguf(p)
    return p


def _stitched(rport: int, rid: str) -> dict:
    deadline = time.time() + 30
    while True:
        doc = _get_json(rport, f"/debug/fleet/traces/{rid}")
        if doc.get("fragments", 0) >= 2 and doc.get("finished"):
            return doc
        assert time.time() < deadline, doc
        time.sleep(0.1)


def test_fleet_trace_renders_as_the_jax_tool(gguf_path, capsys):
    """One traced request through the port's router and a port replica: the
    tool's waterfall, its --json document and its routerless --peers
    render equal the JAX tool's, and the tree spans both processes."""
    jtool = _jax_tool("fleet_trace")
    p1, rp = _free_port(), _free_port()
    s1 = _serve_app(Engine(gguf_path, device="cpu", **KW), p1, tracer=Tracer(sample=1.0, ring=16))
    table = _table([p1]).start()
    rs = _serve_router(FleetRouter(table, policy="affinity", metrics=Metrics(),
                                   tracer=Tracer(sample=1.0, ring=16)), rp)
    try:
        status, headers, _ = _request(rp, "/response", _body(3))
        assert status == 200
        rid = headers["x-request-id"]
        doc = _stitched(rp, rid)
        assert doc["orphans"] == [] and doc["processes"] == ["router", f"127.0.0.1:{p1}"]
        for argv in (["--router", f"http://127.0.0.1:{rp}", "--trace", rid],
                     ["--router", f"http://127.0.0.1:{rp}/", "--trace", rid.upper(), "--json"],
                     ["--peers", f"127.0.0.1:{p1}", "--trace", rid]):
            mine = _run(fleet_trace.main, argv, capsys)
            assert mine == _run(jtool.main, argv, capsys) and mine[0] == 0
        render = _run(fleet_trace.main, ["--router", f"http://127.0.0.1:{rp}", "--trace", rid],
                      capsys)[1]
        assert f"processes=router,127.0.0.1:{p1}" in render and "─ hop: router" in render
        assert "decode_chunk" in render and "WARNING" not in render
        assert json.loads(_run(fleet_trace.main, ["--router", f"http://127.0.0.1:{rp}",
                                                  "--trace", rid, "--json"], capsys)[1]) == doc
        # refusals: not an id (2), an id nobody traced (1), no source (2)
        for argv, code in ((["--router", f"http://127.0.0.1:{rp}", "--trace", "xyz"], 2),
                           (["--router", f"http://127.0.0.1:{rp}", "--trace", "0" * 32], 1),
                           (["--peers", f"127.0.0.1:{p1}", "--trace", "0" * 32], 1),
                           (["--trace", rid], 2)):
            mine = _run(fleet_trace.main, argv, capsys)
            assert mine[0] == code == _run(jtool.main, argv, capsys)[0]
    finally:
        rs.stop()
        table.stop()
        s1.stop()


def _span(name, start, end, children=(), events=(), **attrs):
    return {"name": name, "start": start, "end": end, "attrs": attrs,
            "children": list(children), "events": list(events)}


_EVENTS = [
    {"name": "prefill_slice", "at": 1.02, "host_s": 0.01, "offset": 0, "tokens": 64},
    {"name": "prefill_slice", "at": 1.03, "host_s": 0.01},
    {"name": "kv_restore", "at": 1.04, "host_s": 0.005, "pages": 4, "bytes": 2_500_000},
    {"name": "kv_spill", "at": 1.05, "host_s": 0.002, "pages": 1},
    {"name": "kv_spill_restore", "at": 1.06, "host_s": 0.001, "bytes": 3e9},
    {"name": "disagg_recv", "at": 1.07, "host_s": 0.02, "pages": 5, "tokens": 80,
     "bytes": 4_000, "reason": "remote"},
    {"name": "kv_migrate_pull", "at": 1.08, "host_s": 0.3, "pages": 4, "reason": "remap"},
    {"name": "handshake", "at": 1.09, "host_s": 0.001, "peer": "10.0.0.5:8471"},
    {"name": "kv_pages", "at": 1.1, "pages": 2, "bytes": 123_456},
    {"name": "mem_pressure", "at": 1.11, "headroom_bytes": 1e9, "limit_bytes": 8e10},
    {"name": "first_token", "at": 1.12},
]


@pytest.mark.parametrize("doc", [
    {"trace_id": "ab" * 16, "meta": {"route": "/response", "engine": "Engine", "status": 200},
     "root": _span("request", 1.0, 1.2, [
         _span("queue", 1.0, 1.01),
         _span("engine", 1.01, 1.19, [_span("prefill", 1.01, 1.07, tokens=64),
                                      _span("decode_chunk", 1.07, 1.19, tokens=8)],
               events=_EVENTS)])},
    {"trace_id": "cd" * 16, "meta": {"route": "/v1/chat/completions", "lane": 2},
     "root": _span("request", 2.0, None, [_span("engine", 2.0, None, [
         _span("decode_chunk", 2.01, 2.05)])])},
    {"trace_id": "ef" * 16, "stitched": True, "processes": ["router", "127.0.0.1:1"],
     "orphans": [{"process": "127.0.0.1:2"}], "meta": {},
     "root": _span("fleet.route", 3.0, 3.5, [
         _span("proxy.attempt", 3.0, 3.5, [
             _span("request", 3.01, 3.49, [_span("engine", 3.02, 3.48)],
                   process="127.0.0.1:1", hop="http")], peer="127.0.0.1:1"),
         _span("request", 3.1, 3.2, process="127.0.0.1:2", orphan=True)])},
    {"trace_id": "01" * 16, "root": _span("request", 5.0, 5.0)},
], ids=["engine", "in-flight", "stitched", "instant"])
def test_waterfall_renderer_equals_trace_report(doc):
    assert fleet_trace.render_trace(doc) == _jax_tool("trace_report").render_trace(doc)


def test_trace_report_renders_a_port_pod(gguf_path):
    """tools/trace_report.py (stdlib, shared by both packages) against a port
    app: the listing names the request, and one trace's waterfall is the one
    the port's renderer makes of the pod's /debug/traces/{id}."""
    port = _free_port()
    srv = _serve_app(Engine(gguf_path, device="cpu", **KW), port,
                     tracer=Tracer(sample=1.0, ring=16))
    try:
        status, headers, _ = _request(port, "/response", _body(5))
        assert status == 200
        rid = headers["x-request-id"]
        tool = [sys.executable, os.path.join(REPO, "tools", "trace_report.py"),
                "--url", f"http://127.0.0.1:{port}"]
        one = subprocess.run(tool + ["--trace", rid], capture_output=True, text=True,
                             timeout=60)
        assert one.returncode == 0, one.stderr
        assert one.stdout == fleet_trace.render_trace(_get_json(port, f"/debug/traces/{rid}")) + "\n"
        for phase in ("engine", "prefill", "decode_chunk", "phase breakdown:"):
            assert phase in one.stdout
        listing = subprocess.run(tool, capture_output=True, text=True, timeout=60)
        assert listing.returncode == 0 and rid in listing.stdout
        assert "slowest completed request:" in listing.stdout
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# lint_report
# ---------------------------------------------------------------------------

_FIX = ["--package", os.path.join(FIXTURES, "portpkg"), "--root", FIXTURES]


def test_lint_report_table_lists_every_rule(capsys):
    code, out, _ = _run(lint_report.main, _FIX, capsys)
    assert code == 1 and "unsuppressed findings:" in out
    rows = [ln.split()[0] for ln in out.splitlines()[2:] if ln and not ln.startswith(" ")
            and ln.split()[0] in lint_report.all_rules()]
    assert set(rows) >= set(lint_report.all_rules())
    code, out, _ = _run(lint_report.main, [*_FIX, "--rule", "KER001", "--all"], capsys)
    rows = [ln.split()[0] for ln in out.splitlines()
            if ln.split() and ln.split()[0] in lint_report.all_rules()]
    assert rows == ["KER001"]


def test_lint_report_baseline_ratchet(tmp_path, capsys):
    """--write-baseline snapshots the fixture findings (no line numbers);
    --baseline then tolerates all of them, fails once the baseline misses
    one, and reports an entry no longer found so the baseline can shrink."""
    bl = str(tmp_path / "baseline.json")
    code, out, _ = _run(lint_report.main, ["--write-baseline", bl, *_FIX], capsys)
    assert code == 0 and "baseline written" in out
    doc = json.load(open(bl))
    assert doc["schema"] == 1 and len(doc["findings"]) >= 2
    assert all(set(e) == {"rule", "path", "message"} for e in doc["findings"])

    code, out, _ = _run(lint_report.main, ["--baseline", bl, *_FIX], capsys)
    assert code == 0 and "grandfathered" in out and "ratchet OK" in out

    dropped = doc["findings"][0]
    json.dump({**doc, "findings": doc["findings"][1:]}, open(bl, "w"))
    code, out, _ = _run(lint_report.main, ["--baseline", bl, *_FIX], capsys)
    assert code == 1 and "NEW findings" in out and dropped["rule"] in out

    stale = {"rule": "KER001", "path": "gone.py", "message": "fixed long ago"}
    json.dump({**doc, "findings": doc["findings"] + [stale]}, open(bl, "w"))
    code, out, _ = _run(lint_report.main, ["--baseline", bl, *_FIX], capsys)
    assert code == 0 and "no longer found — shrink the baseline" in out and "gone.py" in out

    json.dump({"schema": 2, "findings": []}, open(bl, "w"))
    assert _run(lint_report.main, ["--baseline", bl, *_FIX], capsys)[0] == 2


@pytest.mark.parametrize("baseline, rules", [
    ("lint_baseline_torch_concurrency.json", ["LOCK005", "LOCK006", "ASY001", "ASY002"]),
    ("lint_baseline_torch_taint.json", ["TAINT001", "TAINT002", "TAINT003",
                                        "WIRE001", "WIRE002", "WIRE003"]),
], ids=["concurrency", "taint"])
def test_port_baselines_are_empty_and_green(baseline, rules):
    doc = json.load(open(os.path.join(REPO, baseline)))
    assert doc == {"schema": 1, "findings": []}
    r = subprocess.run([sys.executable, "-m", f"{PKG}.tools.lint_report", "--baseline",
                        baseline, "--rules", *rules], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ratchet OK" in r.stdout


# ---------------------------------------------------------------------------
# ci_gate
# ---------------------------------------------------------------------------

def test_ci_gate_checks_mirror_the_jax_gate():
    """Every check of the JAX gate has its port counterpart under the same
    name, but the evidence-ledger check (the port has no bench stamp)."""
    theirs = [name for name, _ in _jax_tool("ci_gate").CHECKS]
    mine = [name for name, _ in ci_gate.CHECKS]
    assert mine == [n for n in theirs if n != "check-manifest"]
    for _, argv in ci_gate.CHECKS:
        assert not any("llama_fastapi_k8s_gpu_tpu." in a or a.endswith("llama_fastapi_k8s_gpu_tpu")
                       or os.sep + "tools" + os.sep in a for a in argv), argv


def test_ci_gate_json_shape_and_skip():
    skip = [n for n, _ in ci_gate.CHECKS if n not in ("incident-schema", "disagg-wire-schema")]
    r = subprocess.run([sys.executable, "-m", f"{PKG}.tools.ci_gate", "--json",
                        "--skip", ",".join(skip)], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "LFKT_INCIDENT_DIR": ""})
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["ok"] is True
    assert [c["name"] for c in doc["checks"]] == [n for n, _ in ci_gate.CHECKS]
    for c in doc["checks"]:
        assert set(c) >= {"name", "exit", "ok", "output"}
        assert c.get("skipped", False) == (c["name"] in skip) and c["ok"]
    ran = {c["name"]: c for c in doc["checks"] if not c.get("skipped")}
    assert "nothing to validate" in ran["incident-schema"]["output"]


def test_ci_gate_a_failing_check_fails_the_gate(monkeypatch, capsys):
    monkeypatch.setattr(ci_gate, "CHECKS", [
        ("passes", [sys.executable, "-c", "print('fine')"]),
        ("fails", [sys.executable, "-c", "import sys; print('broken'); sys.exit(3)"]),
        ("skipped", [sys.executable, "-c", "raise SystemExit(9)"]),
    ])
    code, out, _ = _run(ci_gate.main, ["--json", "--skip", "skipped"], capsys)
    doc = json.loads(out)
    assert code == 1 and doc["ok"] is False
    assert [(c["name"], c["exit"], c["ok"]) for c in doc["checks"]] == [
        ("passes", 0, True), ("fails", 3, False), ("skipped", 0, True)]
    code, out, _ = _run(ci_gate.main, ["--skip", "skipped"], capsys)
    assert code == 1 and "[FAIL] fails (exit 3)" in out and "broken" in out
    assert "ci_gate: FAIL (2/3 checks)" in out
    assert _run(ci_gate.main, ["--skip", "no-such-check"], capsys)[0] == 2
    # --cuda adds the card's kernel tests to the known checks
    code, out, _ = _run(ci_gate.main, ["--cuda", "--json", "--skip",
                                       "passes,fails,skipped,cuda-kernels"], capsys)
    assert code == 0 and [c["name"] for c in json.loads(out)["checks"]][-1] == "cuda-kernels"


def test_ci_gate_test_selections_name_real_tests():
    """Each pytest check of the gate names test functions its files define
    (a renamed test cannot silently empty a check)."""
    import ast

    for name, argv in ci_gate.CHECKS:
        if "pytest" not in argv:
            continue
        files = [a.split("::")[0] for a in argv if a.endswith(".py") or "::" in a]
        defined = set()
        for path in files:
            tree = ast.parse(open(path, encoding="utf-8").read(), path)
            defined |= {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        wanted = argv[argv.index("-k") + 1].split(" or ") if "-k" in argv else \
            [a.split("::")[-1] for a in argv if "::" in a]
        assert wanted and set(wanted) <= defined, (name, set(wanted) - defined)


# ---------------------------------------------------------------------------
# fault_drill
# ---------------------------------------------------------------------------

def test_fault_drill_on_the_cpu():
    r = subprocess.run([sys.executable, "-m", f"{PKG}.tools.fault_drill", "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=180,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS: READY → DEGRADED → READY" in r.stdout
    assert "reply equal to the baseline" in r.stdout


def test_tiny_model_is_the_reference_fixture(tmp_path):
    from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf as j_write

    for seed in (0, 5):
        write_tiny_llama_gguf(str(tmp_path / "p.gguf"), seed=seed)
        j_write(str(tmp_path / "j.gguf"), seed=seed)
        assert (tmp_path / "p.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()

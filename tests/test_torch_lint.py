"""lfkt-lint over the port (``python -m llama_fastapi_k8s_gpu_tpu_torch.lint``).

Four layers:

1. **Tree gates** — one test per rule: zero unsuppressed findings on the
   port, every suppression audited, the whole pass inside its budget.
2. **Self-tests** — every rule fires where planted and stays silent on the
   clean twin beside it: the port's own families (GRAPH, PIN, KER, the port
   forms of PERF001 and CFG) on ``tests/torch_lint_fixtures/``, the shared
   ones on the reference fixtures ``tests/lint_fixtures/``; ``noqa``
   suppresses and is itself audited; ``--changed`` equals a full run.
3. **Parity with the JAX package's lint** — for the shared families (LOCK,
   ASY, RES, TAINT, WIRE, DEAD) both lints report the same
   ``(rule, path, line)`` set on the reference fixtures and on the JAX
   package, and the reference lint's shared families find nothing in the
   port.
4. **Declarations** — the port carries a counterpart of every lock
   declaration the JAX package makes, its graphs and captured engines
   declare ``_GRAPH_PINNED``, and the wire-surface registry equals the
   reference's as data.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from llama_fastapi_k8s_gpu_tpu.lint import run_lint as j_run_lint
from llama_fastapi_k8s_gpu_tpu_torch.lint import all_rules, run_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "llama_fastapi_k8s_gpu_tpu_torch")
JAX = os.path.join(REPO, "llama_fastapi_k8s_gpu_tpu")
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")
REF_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
SHARED = ("LOCK", "ASY", "RES", "TAINT", "WIRE", "DEAD")

_runs: dict = {}


def _memo(key, fn):
    if key not in _runs:
        t0 = time.monotonic()
        _runs[key] = fn()
        _runs[key + "_s"] = time.monotonic() - t0
    return _runs[key]


def _tree():
    return _memo("tree", lambda: run_lint(package_dir=PORT, repo_root=REPO))


def _fix():
    return _memo("fix", lambda: run_lint(package_dir=os.path.join(FIXTURES, "portpkg"),
                                         repo_root=FIXTURES))


def _ref_fix():
    return _memo("ref_fix", lambda: run_lint(
        package_dir=os.path.join(REF_FIXTURES, "fixpkg"), repo_root=REF_FIXTURES))


# ---------------------------------------------------------------------------
# layer 1: the port is clean, rule by rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", sorted(all_rules()))
def test_tree_clean(rule):
    live = [f for f in _tree() if f.rule == rule and not f.suppressed]
    assert not live, "unsuppressed findings:\n" + "\n".join(f.render() for f in live)


def test_every_suppression_has_a_reason():
    sup = [f for f in _tree() if f.suppressed]
    assert sup, "expected audited suppressions in the tree"
    for f in sup:
        assert f.reason and f.reason.strip(), f.render()


def test_lint_runtime_budget():
    """The whole-package pass stays under the reference's 60 s budget."""
    _tree()
    assert _runs["tree_s"] < 60.0, f"full lint pass took {_runs['tree_s']:.1f}s"


def test_rule_catalog():
    want = {"LINT000", "LINT001", "ASY001", "ASY002", "DEAD001", "DEAD002",
            "PERF001", "PERF002", "PIN001", "PIN002"}
    want |= {f"LOCK00{i}" for i in range(1, 7)}
    want |= {f"{fam}00{i}" for fam in ("RES", "TAINT", "WIRE", "OBS", "GRAPH", "KER")
             for i in range(1, 4)}
    want |= {f"CFG00{i}" for i in range(1, 6)}
    assert set(all_rules()) == want


# ---------------------------------------------------------------------------
# layer 2: every rule fires where planted; clean twins stay silent
# ---------------------------------------------------------------------------


def _fired(findings, rule, path_part, suppressed=False):
    return [f for f in findings
            if f.rule == rule and path_part in f.path and f.suppressed == suppressed]


@pytest.mark.parametrize("rule,path_part,min_hits", [
    ("GRAPH001", "graphbad.py", 6),    # clock, env, knob, np.random, print, inline random
    ("GRAPH002", "graphbad.py", 1),    # global in a reachable helper
    ("GRAPH003", "graphbad.py", 3),    # .item(), synchronize(), inline .cpu()
    ("PIN001", "pinbad.py", 3),        # ghost declaration + two rebinds
    ("PIN002", "pinbad.py", 1),        # a view read after a later replay
    ("KER001", "ops/_kernels.py", 2),  # two wrappers of one launcher + no C definition
    ("KER001", "ops/kerbad.py", 3),    # status dropped + uncounted + unbound symbol
    ("KER002", "ops/kerbad.py", 4),    # swallowing except + fallback + non-device test
                                       # + no plain version
    ("KER003", "ops/kerbad.py", 2),    # not in KERNELS + not in chip_smoke.py
    ("PERF001", "perfbad.py", 2),      # capture_step and inline capture, unrecorded
    ("CFG001", "cfgbad.py", 1),        # raw env read
    ("CFG002", "utils/config.py", 2),  # an undocumented Settings field and Knob
    ("CFG003", "", 2),                 # a typo'd helm-gpu knob + an unplumbed one
    ("CFG004", "helm-gpu/templates/deployment.yaml", 1),  # a phantom probe path
    ("CFG005", "cfgbad.py", 1),        # unregistered accessor name
    ("LINT000", "noqabad.py", 1),      # noqa without a reason
    ("LINT001", "noqabad.py", 1),      # noqa naming a rule the port lacks
])
def test_port_rule_fires_on_fixture(rule, path_part, min_hits):
    hits = _fired(_fix(), rule, path_part)
    assert len(hits) >= min_hits, (
        f"{rule} fired {len(hits)}x in {path_part or 'tree'}, expected >= {min_hits}:\n"
        + "\n".join(f.render() for f in _fix() if f.rule == rule))


@pytest.mark.parametrize("rule,path_part,min_hits", [
    ("LOCK001", "lockbad.py", 2),
    ("LOCK002", "lockbad.py", 2),
    ("LOCK003", "lockbad.py", 1),
    ("LOCK004", "lockbad.py", 2),
    ("LOCK005", "lockorderbad.py", 3),
    ("LOCK006", "blockunderbad.py", 5),
    ("ASY001", "asyncbad.py", 2),
    ("ASY002", "asyncbad.py", 1),
    ("RES001", "resbad.py", 3),
    ("RES002", "resbad.py", 1),
    ("RES003", "resbad.py", 1),
    ("TAINT001", "taintbad.py", 3),
    ("TAINT002", "taintbad.py", 3),
    ("TAINT003", "taintbad.py", 3),
    ("WIRE001", "wirebad.py", 3),
    ("WIRE002", "wirebad.py", 1),
    ("WIRE003", "serving/wiresurface.py", 1),
    ("DEAD001", "deadbad.py", 1),
    ("DEAD002", "deadbad.py", 1),
    ("OBS001", "obsbad.py", 2),
    ("OBS002", "obs/catalog.py", 1),
    ("OBS003", "obsbad.py", 1),
    ("PERF002", "obs/slo.py", 1),
])
def test_shared_rule_fires_on_reference_fixture(rule, path_part, min_hits):
    hits = _fired(_ref_fix(), rule, path_part)
    assert len(hits) >= min_hits, "\n".join(f.render() for f in _ref_fix() if f.rule == rule)


def _lines(fname: str, marker: str) -> list[int]:
    src = open(os.path.join(FIXTURES, "portpkg", fname)).read().splitlines()
    return [i for i, ln in enumerate(src, 1) if marker in ln]


def _def_span(fname: str, qual: str) -> range:
    tree = ast.parse(open(os.path.join(FIXTURES, "portpkg", fname)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and f"{node.name}.{fn.name}" == qual:
                    return range(fn.lineno, fn.end_lineno + 1)
        if isinstance(node, ast.FunctionDef) and node.name == qual:
            return range(node.lineno, node.end_lineno + 1)
    raise KeyError(qual)


@pytest.mark.parametrize("family,fname,where", [
    ("GRAPH", "graphbad.py", "host_only"),          # the same sins, never captured
    ("PIN", "pinbad.py", "Graphs.reset_good"),      # refilled in place
    ("PIN", "pinbad.py", "Graphs.fresh"),           # copied before the replay
    ("PIN", "pinbad.py", "Graphs.one_replay"),      # no replay after the view
    ("PIN", "pinbad.py", "Engine.recover_in_place"),
    ("KER", "ops/good.py", "good_kernel"),          # the conforming wrapper
    ("KER", "ops/good.py", "query"),                # a query, not a launcher
    ("CFG", "cfgbad.py", "registered"),             # a registered knob read
])
def test_clean_twin_is_silent(family, fname, where):
    span = _def_span(fname, where)
    noisy = [f for f in _fix() if f.rule.startswith(family) and fname in f.path
             and f.line in span and not f.suppressed]
    assert not noisy, "\n".join(f.render() for f in noisy)


def test_ker_clean_module_is_silent():
    assert not [f for f in _fix() if f.rule.startswith("KER") and "ops/good.py" in f.path]


@pytest.mark.parametrize("rule,fname", [
    ("GRAPH003", "graphbad.py"),   # a def-line audit covers the body
    ("CFG001", "cfgbad.py"),       # an audited raw read
])
def test_noqa_suppresses(rule, fname):
    sup = _fired(_fix(), rule, fname, suppressed=True)
    assert sup, f"expected a suppressed {rule} in {fname}"
    for f in sup:
        assert f.reason and f.reason.strip(), f.render()


def test_noqa_without_reason_or_with_unknown_rule_is_a_finding():
    assert [f.line for f in _fired(_fix(), "LINT000", "noqabad.py")] == _lines(
        "noqabad.py", "noqa[CFG001]")
    assert [f.line for f in _fired(_fix(), "LINT001", "noqabad.py")] == _lines(
        "noqabad.py", "noqa[JIT001]")
    # the suppression audit itself is never suppressed
    assert not [f for f in _fix() if f.rule.startswith("LINT") and f.suppressed]


def test_changed_mode_equals_full_run(tmp_path):
    """``--changed`` gives the finding set of a full run: cold cache, warm
    cache, and after a one-file edit."""
    work = tmp_path / "lint_fixtures"
    shutil.copytree(REF_FIXTURES, work)
    args = ["--json", "--package", str(work / "fixpkg"), "--root", str(work)]

    def run(*extra):
        proc = subprocess.run(
            [sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.lint", *extra, *args],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        rows = sorted((d["rule"], d["path"], d["line"], d["message"])
                      for d in map(json.loads, proc.stdout.splitlines()))
        return rows, proc.stderr

    full, _ = run()
    assert run("--changed")[0] == full
    assert (work / ".lfkt_torch_lint_cache.json").exists()
    warm, err = run("--changed")
    assert warm == full
    assert int(err.rsplit("reused cached summaries for", 1)[1].split()[0]) > 0, err
    p = work / "fixpkg" / "blockunderbad.py"
    src = p.read_text()
    marker = "            time.sleep(0.1)         # LOCK006: direct sleep"
    assert marker in src
    p.write_text(src.replace(marker, "            time.sleep(0.1)\n" + marker))
    full2, _ = run()
    inc2, _ = run("--changed")
    assert inc2 == full2 != full


def test_cli_exits_zero_on_tree():
    proc = subprocess.run([sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.lint"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_exits_nonzero_on_fixtures_with_json():
    proc = subprocess.run(
        [sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.lint", "--json",
         "--package", os.path.join(FIXTURES, "portpkg"), "--root", FIXTURES],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert rows and all("rule" in r and "line" in r for r in rows)


def test_cli_lists_every_rule():
    proc = subprocess.run(
        [sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.lint", "--list-rules"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0
    assert {ln.split()[0] for ln in proc.stdout.splitlines()} == set(all_rules())


# ---------------------------------------------------------------------------
# layer 3: parity with the JAX package's lint
# ---------------------------------------------------------------------------


def _shared(findings) -> set:
    return {(f.rule, f.path, f.line, f.suppressed) for f in findings
            if f.rule.startswith(SHARED)}


@pytest.mark.parametrize("target", ["reference_fixtures", "jax_package"])
def test_shared_families_agree_with_the_reference_lint(target):
    if target == "reference_fixtures":
        pkg, root = os.path.join(REF_FIXTURES, "fixpkg"), REF_FIXTURES
        mine = _shared(_ref_fix())
    else:
        pkg, root = JAX, REPO
        mine = _shared(_memo("port_on_jax", lambda: run_lint(package_dir=pkg, repo_root=root)))
    theirs = _shared(j_run_lint(package_dir=pkg, repo_root=root))
    assert theirs, "the reference lint found nothing to compare"
    assert mine == theirs, (sorted(mine - theirs), sorted(theirs - mine))


def test_reference_lint_finds_nothing_in_the_port():
    live = [f for f in j_run_lint(package_dir=PORT, repo_root=REPO)
            if f.rule.startswith(SHARED) and not f.suppressed]
    assert not live, "\n".join(f.render() for f in live)


def test_dead_code_counts_only_the_ports_consumers():
    from llama_fastapi_k8s_gpu_tpu_torch.lint.core import consumers

    got = {os.path.relpath(p, REPO) for p in consumers(PORT, REPO)}
    assert "chip_smoke.py" in got and "tests/test_torch_lint.py" in got
    assert "tests/test_lint.py" not in got and "bench.py" not in got
    assert all(p.startswith(("tests/test_torch_", "tools/port_", "chip_smoke.py"))
               or p in ("tools/pod_ready.py", "tools/timed_lines.py") for p in got)


# ---------------------------------------------------------------------------
# layer 4: the port's declarations, and the rules see the real tree
# ---------------------------------------------------------------------------

_DECLS = ("_GUARDED_BY", "_THREAD_ENTRIES", "_THREAD_CONFINED", "_SHARED_ATOMIC")


def _declaring_classes(pkg: str, names=_DECLS) -> dict:
    out = {}
    for root, _, files in os.walk(pkg):
        if "/lint" in root.replace(os.sep, "/")[len(pkg):]:
            continue
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            rel = os.path.relpath(path, pkg)
            for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
                if isinstance(node, ast.ClassDef):
                    got = {s.targets[0].id for s in node.body
                           if isinstance(s, ast.Assign) and isinstance(s.targets[0], ast.Name)
                           and s.targets[0].id in names}
                    if got:
                        out[(rel, node.name)] = got
    return out


def test_every_reference_declaration_has_a_port_counterpart():
    ref, port = _declaring_classes(JAX), _declaring_classes(PORT)
    assert len(ref) >= 20
    missing = sorted(k for k in ref if k not in port)
    assert not missing, missing


def test_graphs_and_captured_engines_declare_pinned_buffers():
    got = _declaring_classes(PORT, ("_GRAPH_PINNED",))
    assert {("models/generate.py", "DecodeGraphs"), ("parallel/batched.py", "LaneGraphs"),
            ("engine/engine.py", "Engine"), ("engine/batched.py", "MeshEngine")} <= set(got)


def test_graph_rules_reach_the_ports_captured_steps():
    from llama_fastapi_k8s_gpu_tpu_torch.lint import graph
    from llama_fastapi_k8s_gpu_tpu_torch.lint.core import Context

    index = graph._Index(Context(PORT, REPO))
    roots, inline = graph._roots(index)
    reached = {k[1] for k in graph._reachable(index, roots)}
    assert {"decode_step", "spec_verify", "lane_step", "forward", "decode_loop_step",
            "DecodeGraphs._verify_step", "LaneGraphs._verify_step"} <= reached
    assert any(scope is not None and scope.key[1] == "capture_step"
               for scope, _, _ in inline)


def test_kernel_rules_see_every_launcher_and_wrapper():
    from llama_fastapi_k8s_gpu_tpu_torch.lint import kernels
    from llama_fastapi_k8s_gpu_tpu_torch.lint.core import Context
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS
    from llama_fastapi_k8s_gpu_tpu_torch.ops._kernels import SIGNATURES

    ctx = Context(PORT, REPO)
    cdefs = kernels._c_definitions(os.path.join(PORT, "csrc"))
    assert set(SIGNATURES) <= set(cdefs)
    launchers = {s for s in SIGNATURES if cdefs[s]}
    assert launchers == set(SIGNATURES) - {"lfkt_fused_tc_route", "lfkt_fused_tc_config"}
    assert set(kernels._wrappers(ctx)) == {fn.__name__ for fn in KERNELS.values()}


def test_wiresurface_equals_the_references_as_data():
    """The page wire and the fleet headers are unchanged: the port's
    registry equals the JAX package's row for row, and the generated docs
    table is the port's table too."""
    from llama_fastapi_k8s_gpu_tpu.serving import wiresurface as ref
    from llama_fastapi_k8s_gpu_tpu_torch.serving import wiresurface as mine

    for name in ("HEADERS", "FIELDS", "INGRESSES"):
        assert ([dataclasses.asdict(r) for r in getattr(mine, name)]
                == [dataclasses.asdict(r) for r in getattr(ref, name)]), name
    assert mine.TRUST_CLASSES == ref.TRUST_CLASSES
    assert mine.internal_stamped_headers() == ref.internal_stamped_headers() == (
        "x-lfkt-affinity-key", "x-lfkt-prior-owner")
    begin = "<!-- wire-surface:begin (generated - do not hand-edit) -->"
    text = open(os.path.join(REPO, "docs", "WIRESURFACE.md")).read()
    block = text[text.index(begin) + len(begin):text.index("<!-- wire-surface:end -->")]
    assert block.strip("\n") == mine.markdown_table()

"""One CI gate over the port: every repo check, one exit code.

Runs each check in a subprocess (the command a human would run, so this
wrapper cannot drift from what it claims to gate), streams nothing, and
aggregates the exit codes: nonzero if ANY check fails::

  python -m llama_fastapi_k8s_gpu_tpu_torch.tools.ci_gate          # exit != 0 on failure
  python -m llama_fastapi_k8s_gpu_tpu_torch.tools.ci_gate --json   # {"ok": bool, "checks": [...]}
  python -m llama_fastapi_k8s_gpu_tpu_torch.tools.ci_gate --skip chaos-drill
  python -m llama_fastapi_k8s_gpu_tpu_torch.tools.ci_gate --cuda   # + the card's kernel tests

Run it from a checkout (it reads ``tests/`` and the lint baselines at the
repo root).  The checks are the JAX package's gate (tools/ci_gate.py), each
over its port counterpart; the test subsets run on the CPU
(``JAX_PLATFORMS=cpu``: they hold the port against the JAX package).  On the
card, where JAX is not installed, skip the four test subsets and add
``--cuda``.  Stdlib only, no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PKG = __package__.rsplit(".", 1)[0]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _pytest(*selection: str) -> list[str]:
    return ["env", "JAX_PLATFORMS=cpu", sys.executable, "-m", "pytest", "-q",
            "-p", "no:cacheprovider", *selection]


def _tests(name: str) -> str:
    return os.path.join(ROOT, "tests", name)


#: the route-parity test also checks the stitched trace: two checks, one test
_FLEET_PARITY = _tests("test_torch_fleet.py") + "::test_fleet_route_parity_and_stitched_trace"

#: (name, argv) — every gate a commit must pass, in order
CHECKS: list[tuple[str, list[str]]] = [
    ("lfkt-lint", [sys.executable, "-m", f"{PKG}.lint"]),
    # the interprocedural concurrency families ride a baseline ratchet: a
    # LOCK005/LOCK006/ASY001/ASY002 finding not grandfathered in the (empty)
    # baseline fails here
    ("lint-concurrency", [sys.executable, "-m", f"{PKG}.tools.lint_report",
                          "--baseline",
                          os.path.join(ROOT, "lint_baseline_torch_concurrency.json"),
                          "--rules", "LOCK005", "LOCK006", "ASY001", "ASY002"]),
    # the trust-boundary families (taint flows, the wire-surface registry),
    # ratcheted against an empty baseline alike
    ("lint-taint", [sys.executable, "-m", f"{PKG}.tools.lint_report",
                    "--baseline", os.path.join(ROOT, "lint_baseline_torch_taint.json"),
                    "--rules", "TAINT001", "TAINT002", "TAINT003",
                    "WIRE001", "WIRE002", "WIRE003"]),
    # any incident bundle present (in $LFKT_INCIDENT_DIR) must validate
    # against the flight-recorder schema; no directory = trivially OK
    ("incident-schema", [sys.executable, "-m", f"{PKG}.tools.incident_report",
                         "--validate"]),
    # the page-wire format is pinned against the committed golden header
    ("disagg-wire-schema", [sys.executable, "-m", f"{PKG}.serving.disagg.wire",
                            "--check-golden"]),
    # the layer-looped forward is the per-layer forward bit for bit, and
    # matches the JAX package's looped forward
    ("decode-loop-parity", _pytest(
        _tests("test_torch_decode_loop.py"), "-k",
        "test_looped_forward_bit_identical_to_per_layer or "
        "test_looped_forward_matches_reference_looped")),
    # greedy bytes through the router equal direct-to-replica bytes
    ("fleet-route-parity", _pytest(_FLEET_PARITY)),
    # the no-engine survivability subset: a pull round trip bit for bit,
    # every migrate fault point degrading with attribution, the drain as a
    # commanded pull, the router's spill-budget 503 and its prior-owner
    # stamp with forgeries stripped
    ("chaos-drill", _pytest(
        _tests("test_torch_migrate.py"), _tests("test_torch_fleet.py"), "-k",
        "test_pull_round_trip_bitwise_and_warm_skip or "
        "test_fault_points_degrade_attributed or "
        "test_drain_push_is_a_commanded_pull or "
        "test_router_spill_budget_503_with_retry_after or "
        "test_router_stamps_prior_owner_and_strips_forgeries")),
    # one traced request through the router and a replica is ONE stitched
    # span tree with zero orphan fragments
    ("fleet-trace-continuity", _pytest(_FLEET_PARITY)),
]

#: added by --cuda: the kernels against their plain versions on the card
#: (conftest.py imports JAX, which the card's machine does not have)
CUDA_CHECK = ("cuda-kernels", [sys.executable, "-m", "pytest", "-q", "-p",
                               "no:cacheprovider", "--noconftest", "-m", "cuda",
                               _tests("test_torch_cuda.py")])


def run_checks(checks: list[tuple[str, list[str]]], timeout: float = 300.0,
               skip: frozenset[str] = frozenset()) -> list[dict]:
    results = []
    for name, argv in checks:
        if name in skip:
            # still listed (the aggregate shape is part of the contract),
            # not executed
            results.append({"name": name, "exit": 0, "ok": True,
                            "skipped": True, "output": "skipped"})
            continue
        try:
            proc = subprocess.run(argv, cwd=ROOT, capture_output=True,
                                  text=True, timeout=timeout)
            results.append({
                "name": name,
                "exit": proc.returncode,
                "ok": proc.returncode == 0,
                "output": (proc.stdout + proc.stderr).strip(),
            })
        except subprocess.TimeoutExpired:
            results.append({"name": name, "exit": -1, "ok": False,
                            "output": f"timed out after {timeout:.0f}s"})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ci_gate")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable aggregate result")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="per-check timeout in seconds")
    ap.add_argument("--skip", default="",
                    help="comma-separated check names to skip (they "
                         "still appear in the output, marked skipped)")
    ap.add_argument("--cuda", action="store_true",
                    help="also run tests/test_torch_cuda.py -m cuda (on the card)")
    args = ap.parse_args(argv)

    checks = CHECKS + ([CUDA_CHECK] if args.cuda else [])
    skip = frozenset(n for n in args.skip.split(",") if n)
    known = {name for name, _ in checks}
    if not skip <= known:
        ap.error(f"unknown check(s): {sorted(skip - known)} "
                 f"(known: {sorted(known)})")
    results = run_checks(checks, timeout=args.timeout, skip=skip)
    ok = all(r["ok"] for r in results)
    if args.json:
        print(json.dumps({"ok": ok, "checks": results}, indent=1))
    else:
        for r in results:
            mark = "SKIP" if r.get("skipped") else \
                ("OK  " if r["ok"] else "FAIL")
            print(f"[{mark}] {r['name']} (exit {r['exit']})")
            if not r["ok"] and r["output"]:
                print("  " + r["output"].replace("\n", "\n  "))
        print(f"ci_gate: {'OK' if ok else 'FAIL'} "
              f"({sum(r['ok'] for r in results)}/{len(results)} checks)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The port's chaos drill (``python -m llama_fastapi_k8s_gpu_tpu_torch.tools.chaos_drill
--device cpu``) on the CPU: each of the JAX drill's five scenarios
(tools/chaos_drill.py) against two real replica processes on ephemeral
ports behind the drill's router, over the tiny model, holding the same
invariants."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the invariants each scenario must report held, in order (prefixes)
HELD = {
    "sigkill": ["warm replay served with zero errors", "torn stream terminated bounded",
                "spill-over replay served with zero errors",
                "survivor's pull against the dead owner is attributed", "owner re-admitted",
                "post-restart replay served with zero errors",
                "restarted owner pulled its conversations back (remap)",
                "warm restart ratio", "pages_pinned == 0 on :", "pages_pinned == 0 on :"],
    "drain": ["warm replay served with zero errors", "drain finished in",
              "successor pulled pages during the drain window",
              "successor's first post-drain turn warm", "pages_pinned == 0 on successor"],
    "torn-wire": ["warm replay served with zero errors", "broken wire did not delay shutdown",
                  "wire degrade attributed in kv_migration_failures_total",
                  "last_error attributed:",
                  "replay continues on the survivor despite the broken wire",
                  "pages_pinned == 0 on survivor"],
    "reload": ["warm replay served with zero errors", "replay turn 0 clean during reload",
               "replay turn 1 clean during reload", "both reloads succeeded",
               "registry converged back: ['main']"],
}
HELD["slow-wire"] = HELD["torn-wire"]


@pytest.mark.parametrize("scenario", ["sigkill", "drain", "torn-wire", "slow-wire", "reload"])
def test_chaos_drill_scenario_on_the_cpu(scenario, tmp_path):
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.tools.chaos_drill",
         "--device", "cpu", "--json", "--log-dir", str(logs), scenario],
        cwd=REPO, capture_output=True, text=True, timeout=110,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    (row,) = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert row["drill"] == scenario and row["ok"] and row["error"] is None
    want = HELD[scenario]
    if scenario == "reload":
        # a replay turn a check for as long as the reload runs, two at least
        turns = len(row["invariants"]) - 3
        assert turns >= 2
        want = [want[0], *(f"replay turn {k} clean during reload" for k in range(turns)),
                *want[-2:]]
    assert len(row["invariants"]) == len(want)
    for held, prefix in zip(row["invariants"], want):
        assert held.startswith(prefix), (held, prefix)
    assert "[drill] PASS: all scenarios held their invariants" in r.stdout
    # two replicas a fleet, three where sigkill restarts the owner; every
    # port ephemeral (the logs are named by port)
    booted = sorted(os.listdir(logs))
    assert len(booted) == (3 if scenario == "sigkill" else 2)
    assert len({name.split("-")[-2] for name in booted}) == 2


def test_chaos_drill_refuses_an_unknown_scenario():
    r = subprocess.run(
        [sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.tools.chaos_drill",
         "--device", "cpu", "meteor"], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "invalid choice" in r.stderr

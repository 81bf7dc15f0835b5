"""The port's one-worker stance, held to the JAX package's
(tests/test_multiproc.py::test_multi_worker_request_is_refused): a request
for more than one worker fails loudly before the model, the card or torch
is touched, naming the port's scaling axes."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from llama_fastapi_k8s_gpu_tpu.utils.config import KNOBS as JKNOBS
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import KNOBS, knob

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_workers_knob_registered_as_the_reference():
    mine, theirs = KNOBS["LFKT_WORKERS"], JKNOBS["LFKT_WORKERS"]
    assert (mine.cast, mine.default, mine.serving) == (theirs.cast, theirs.default, False)
    assert knob("LFKT_WORKERS") == 1


@pytest.mark.parametrize("workers", ["2", "0"])
def test_multi_worker_request_is_refused(workers):
    proc = subprocess.run(
        [sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.server"],
        env={**os.environ, "LFKT_WORKERS": workers}, cwd=REPO,
        capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert f"LFKT_WORKERS={workers} refused" in proc.stderr
    assert "LFKT_BATCH_SIZE" in proc.stderr      # lanes on one card
    assert "LFKT_DISAGG_ROLE" in proc.stderr     # roles across processes
    assert "replicas" in proc.stderr             # k8s replicas across cards


_NOTHING_LOADED = r"""
import json, runpy, sys
sys.argv = ["server"]
try:
    runpy.run_module("llama_fastapi_k8s_gpu_tpu_torch.server", run_name="__main__")
except SystemExit as e:
    code = str(e.code)
print(json.dumps({"refused": "refused" in code,
                  "loaded": sorted(m for m in ("torch", "jax") if m in sys.modules)}))
"""


def test_the_refusal_comes_before_anything_loads():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NOTHING_LOADED], cwd=REPO,
                         env=dict(env, LFKT_WORKERS="4"),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"refused": True, "loaded": []}

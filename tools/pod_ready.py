#!/usr/bin/env python3
"""Seconds to READY of a serving pod from each of several checkouts, on
the same synthetic Q4_K_M file, in the order given, on one GPU.

Run from the root of a checkout (whose ``chip_smoke.py`` writes the file):

    python3 tools/pod_ready.py ROOT_A ROOT_B ROOT_B ROOT_A

Each root's kernel library is found or built first, by its own package
(``ops/_kernels.library()`` in a child, no ``LFKT_COMPILE_CACHE_DIR``), so
no pod builds.  Then, one at a time, ``python -m
llama_fastapi_k8s_gpu_tpu_torch.server`` from each root in the chart's
default shape (the reference's defaults, greedy): a ``pod_ready`` line with
its seconds to READY and to its first short reply.  Prints the card's name
and power limit first; a pod that fails ends the run with a non-zero exit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def main(roots: list[str]) -> int:
    import torch

    if not roots or not torch.cuda.is_available():
        print(__doc__ if not roots else "pod_ready: no CUDA device", file=sys.stderr)
        return 2
    chip_smoke.phase_device()
    path = chip_smoke.phase_gguf("q4km")
    d, name = os.path.split(path)
    base = {k: v for k, v in os.environ.items() if k != "LFKT_COMPILE_CACHE_DIR"}
    roots = [os.path.abspath(r) for r in roots]
    for root in dict.fromkeys(roots):
        t = time.time()
        subprocess.run([sys.executable, "-c", "from llama_fastapi_k8s_gpu_tpu_torch.ops "
                        "import _kernels; _kernels.library()"],
                       cwd=root, env=dict(base, PYTHONPATH=root), check=True, timeout=900)
        chip_smoke.say("library", root=root, seconds=round(time.time() - t, 2))
    for i, root in enumerate(roots):
        pod = chip_smoke.Pod(f"ready_{i}", dict(LFKT_MODEL_DIR=d, LFKT_MODEL_NAME=name,
                                                LFKT_TEMPERATURE="0",
                                                LFKT_TIMEOUT_SECONDS="600"),
                             root=root, base_env=base)
        try:
            ready = pod.ready()
            st, _ = chip_smoke._http(pod.port, "POST", "/response",
                                     chip_smoke.body(chip_smoke.SHORT_CTX), timeout=900)
            first = time.time() - pod.t0
        finally:
            pod.stop()
        chip_smoke.say("pod_ready", order=i, root=root, ready_s=ready, status=st,
                       first_reply_s=first)
        if st != 200:
            raise AssertionError(f"pod {i} from {root}: status {st}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

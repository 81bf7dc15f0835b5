#!/usr/bin/env python3
"""``chip_smoke.py``'s fleet phases alone, on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/port_fleet.py [fleet] [fleet_pods]

Prints the card's name and power limit, builds the kernels, writes (or
reuses) the synthetic Q4_K_M GGUF under ``.cache/chip_smoke/`` and runs each
named phase (both by default) as ``chip_smoke.py`` does: the ``fleet`` line
(replicas behind the port's router in this process: parity, affinity
against round-robin, the forged stamp, pull-on-remap, the owner's decode
while a peer pulls, the stitched trace, federation, scale-out warm-up) with
its ``launches``, the ``fleet_pods`` line (a router and replica server
processes: the SIGTERM drain, the SIGKILL drill, the pull back) and each
phase's seconds.  A failed check ends the run with a non-zero exit.
"""

from __future__ import annotations

import gc
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

PHASES = {"fleet": chip_smoke.phase_fleet,
          "fleet_pods": lambda paths, counters: chip_smoke.phase_fleet_pods(paths)}


def main() -> int:
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    if not torch.cuda.is_available():
        print("port_fleet: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    paths = {"q4km": chip_smoke.phase_gguf("q4km")}
    for name in sys.argv[1:] or list(PHASES):
        t1 = time.time()
        PHASES[name](paths, KERNELS)
        gc.collect()
        torch.cuda.empty_cache()
        chip_smoke.say("phase_seconds", name=name, seconds=round(time.time() - t1, 1))
    chip_smoke.say("done", seconds=round(time.time() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

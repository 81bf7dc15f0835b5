#!/usr/bin/env python3
"""``chip_smoke.py``'s multi-model and disaggregated prefill/decode phases
alone, on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/port_registry_disagg.py [registry] [registry_looped]
        [registry_lanes] [disagg] [disagg_pods]

Prints the card's name and power limit, builds the kernels, writes (or
reuses) the synthetic Q4_K_M, Q6_K and 4-layer mixed GGUFs under
``.cache/chip_smoke/`` and serves each named phase (all by default) as
``chip_smoke.py`` does: the ``registry``, ``registry_looped``,
``registry_lanes``, ``disagg``, ``disagg_lanes`` and ``disagg_pods``
lines, each phase's ``launches`` and its seconds.  A failed check ends the
run with a non-zero exit.
"""

from __future__ import annotations

import gc
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

PHASES = {"registry": chip_smoke.phase_registry,
          "registry_looped": chip_smoke.phase_registry_looped,
          "registry_lanes": chip_smoke.phase_registry_lanes,
          "disagg": chip_smoke.phase_disagg,
          "disagg_pods": lambda paths, counters: chip_smoke.phase_disagg_pods(paths)}


def main() -> int:
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    if not torch.cuda.is_available():
        print("port_registry_disagg: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    paths = {"q4km": chip_smoke.phase_gguf("q4km"), "q6_k": chip_smoke.phase_gguf("q6_k"),
             "mixed": chip_smoke.phase_gguf_mixed()}
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

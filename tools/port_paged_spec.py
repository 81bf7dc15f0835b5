#!/usr/bin/env python3
"""``chip_smoke.py``'s paged-pool and speculative phases alone, on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/port_paged_spec.py [paged] [paged_int8] [paged_lanes] [spec] [spec_int8]
        [spec_lanes] [spec_lanes_int8]

Prints the card's name and power limit, builds the kernels, writes (or
reuses) the synthetic Q4_K_M GGUF under ``.cache/chip_smoke/``, loads it
once and serves each named phase (all by default) on those weights as
``chip_smoke.py`` does: the ``paged``, ``restored_graph``, ``paged_int8``,
``paged_lanes``, ``spec``, ``spec_int8``, ``verify_graph``, ``spec_lanes``,
``spec_lanes_int8`` and ``lane_parity`` lines, each phase's ``launches``.  A failed check ends
the run with a non-zero exit.
"""

from __future__ import annotations

import functools
import gc
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

PHASES = {"paged": chip_smoke.phase_paged, "paged_int8": chip_smoke.phase_paged_int8,
          "paged_lanes": chip_smoke.phase_paged_lanes, "spec": chip_smoke.phase_spec,
          "spec_int8": functools.partial(chip_smoke.phase_spec, kv_dtype="int8"),
          "spec_lanes": chip_smoke.phase_spec_lanes,
          "spec_lanes_int8": functools.partial(chip_smoke.phase_spec_lanes, kv_dtype="int8")}


def main() -> int:
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    if not torch.cuda.is_available():
        print("port_paged_spec: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    path = chip_smoke.phase_gguf("q4km")
    t_load = time.time()
    eng = Engine(path, n_ctx=1024)
    parts = (eng.params, eng.cfg, eng.tokenizer, eng.template_kind)
    eng.close()
    del eng
    chip_smoke.say("load", seconds=round(time.time() - t_load, 1))
    for name in sys.argv[1:] or list(PHASES):
        PHASES[name](parts, KERNELS)
        gc.collect()
        torch.cuda.empty_cache()
    chip_smoke.say("done", seconds=round(time.time() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

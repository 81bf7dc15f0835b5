#!/usr/bin/env python3
"""``chip_smoke.py``'s batched-serving phases alone, on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/port_lanes.py [lanes_q4km] [lanes_q4km_int8] [cycle_q8_0_bf16_loop8]

Prints the card's name and power limit, builds the kernels, prints the
``kv_quantize_lanes`` lines (the int8 KV write's lane axis at B = 1, 3, 8,
bit-exact, beside the one-ring call) and the ``lane_matmul`` lines (every
fused matmul at the lane counts against its plain version), then serves
each named lane engine of ``chip_smoke.LANES`` (all by default) as
``chip_smoke.py`` does: the ``lanes``, ``lane_deadline``, ``lane_parity``,
``lane_graph``, ``lane_isolation`` and ``lane_route`` lines.  The synthetic GGUFs are
written under ``.cache/chip_smoke/`` (or reused from there).  A failed
check ends the run with a non-zero exit.
"""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    if not torch.cuda.is_available():
        print("port_lanes: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    rng = np.random.default_rng(1)
    for B in (1, 3, 8):
        chip_smoke.say("kv_quantize_lanes", **chip_smoke.check_kv_quantize_lanes(rng, B))
    for name in chip_smoke.fused_formats():
        for n, k in chip_smoke.MATMUL_SHAPES[name]:
            for row in chip_smoke.check_matmul_lanes(name, rng, n, k, chip_smoke.LANE_BATCHES):
                chip_smoke.say("lane_matmul", **row)
    names = sys.argv[1:] or [row[0] for row in chip_smoke.LANES]
    paths = {row[1]: chip_smoke.phase_gguf(row[1]) for row in chip_smoke.LANES
             if row[0] in names}
    chip_smoke.phase_all_lanes(paths, KERNELS, names)
    chip_smoke.say("done", seconds=round(time.time() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

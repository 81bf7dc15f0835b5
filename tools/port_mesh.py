#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh phase alone, on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/port_mesh.py [kernels] [mesh] [mesh_tp] [mesh_sp] [mesh_paged]
                               [mesh_spec] [mesh_looped]

Prints the card's name and power limit, builds the kernels, writes (or
reuses) the synthetic Q4_K_M GGUF under ``.cache/chip_smoke/`` and runs,
as ``chip_smoke.py`` does: ``kernels`` — the fused kernels at a tp = 2
shard's 8B shapes beside the unsharded ones and the flash kernel at a
shard's heads (``mesh_matmul``, ``mesh_flash`` lines), the looped kernel
over tp = 2 shard tables (``mesh_loop``), ``ring_attention`` and
``sharded_decode_attention`` against their plain single-device version
(``mesh_ring``); ``mesh`` — the whole phase (``mesh_looped``,
``mesh_tp``, ``mesh_sp``, ``mesh_paged``, ``mesh_spec``, their
``launches``; it runs the kernels first); ``mesh_tp``, ``mesh_sp``,
``mesh_paged`` or ``mesh_spec`` — that arm alone, against the one-card
engine at n_ctx 4096 as the phase builds it; ``mesh_looped`` — the looped
arm alone, on the Q8_0 file (written or reused) loaded as bf16, which the
full run takes from its looped lane engine instead (``mesh_looped_load``:
the load's seconds).  ``mesh`` by default; each with its seconds.  A
failed check ends the run with a non-zero exit.
"""

from __future__ import annotations

import gc
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def _kernels(paths, counters):
    import numpy as np

    rng = np.random.default_rng(21)
    chip_smoke.check_mesh_kernels(rng)
    chip_smoke.check_ring_ops(rng)


def _arm(fn):
    """One arm of the mesh phase against the phase's one-card engine."""
    def run(paths, counters):
        from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

        ref = Engine(paths["q4km"], n_ctx=chip_smoke.MESH_N_CTX, prefix_cache=False,
                     max_gen_tokens=chip_smoke.MESH_TOKENS)
        ref.warmup()
        try:
            fn(paths["q4km"], counters, ref)
        finally:
            ref.close()
    return run


def _looped(paths, counters):
    chip_smoke.phase_mesh_looped(chip_smoke.looped_parts(paths["q8_0"]), counters)


PHASES = {"kernels": _kernels, "mesh": chip_smoke.phase_mesh, "mesh_looped": _looped,
          **{name: _arm(getattr(chip_smoke, f"phase_{name}"))
             for name in ("mesh_tp", "mesh_sp", "mesh_paged", "mesh_spec")}}


def main() -> int:
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    if not torch.cuda.is_available():
        print("port_mesh: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    names = sys.argv[1:] or ["mesh"]
    paths = {"q4km": chip_smoke.phase_gguf("q4km")}
    if {"mesh", "mesh_looped"} & set(names):
        paths["q8_0"] = chip_smoke.phase_gguf("q8_0")
    chip_smoke.say("phase_seconds", name="setup", seconds=round(time.time() - t0, 1))
    for name in names:
        t1 = time.time()
        PHASES[name](paths, KERNELS)
        gc.collect()
        torch.cuda.empty_cache()
        chip_smoke.say("phase_seconds", name=name, seconds=round(time.time() - t1, 1))
    chip_smoke.say("done", seconds=round(time.time() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Why a speculating engine's greedy replies part from the vanilla engine's,
on the GPU: the verify pass's arithmetic against the decode step's.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/spec_route_noise.py

Prints the card's name and power limit, builds the kernels, writes (or
reuses) the synthetic Q4_K_M GGUF under ``.cache/chip_smoke/`` and loads it
once.  Then, over the bf16 ring and over the int8 ring, with the fused
linears' routes as served (D+1 = 9 rows on the tensor cores, one row on
the CUDA cores) and with 9 rows sent to the CUDA cores too:

- ``route_noise``: ``chip_smoke.route_noise`` on the vanilla engine's
  greedy reply to the short, the long and the repetitive prompt — the
  reply's tokens fed by one-row decode steps and by 9-row verify passes
  (every draft rejected, every draft accepted), teacher-forced: how far
  the two move the top-2 gap, in bf16 steps, and how many ring values
  (int8 codes, bf16 K/V) the two write differently;
- ``spec_parting``: a speculating serial engine served the same prompts
  under the always-hit draft and under the oracle draft (the vanilla
  reply), each reply against the vanilla one: equal, or where it parts
  and the vanilla chain's top-2 margin there.

A failed request ends the run with a non-zero exit; the readings
themselves gate nothing.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

PROMPTS = [("short", chip_smoke.SHORT_CTX), ("long", chip_smoke.LONG_CTX),
           ("repeat", chip_smoke.REPEAT_CTX)]
#: the fused formats of the Q4_K_M file
FORMATS = ("q4k_matmul", "q6k_matmul")


@contextlib.contextmanager
def routes(name: str):
    """The fused linears' routes: as served (``"served"``), or with every
    call below 16 rows on the CUDA cores (``"cuda_core_9"``)."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    saved = {f: _fused.tc_min_batch(f) for f in FORMATS}
    if name == "cuda_core_9":
        for f in FORMATS:
            _fused.tc_config(f, 16)
    try:
        yield {f: _fused.route(f, chip_smoke.SPEC_DRAFT + 1, 4096) for f in FORMATS}
    finally:
        for f, b in saved.items():
            _fused.tc_config(f, b)


def main() -> int:
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    if not torch.cuda.is_available():
        print("spec_route_noise: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    path = chip_smoke.phase_gguf("q4km")
    eng = Engine(path, n_ctx=1024)
    parts = (eng.params, eng.cfg, eng.tokenizer, eng.template_kind)
    eng.close()
    del eng
    settings = Settings(temperature=0.0, timeout_seconds=600.0)
    sp = chip_smoke.served_sampling(settings)
    failed = []
    for kv in ("bf16", "int8"):
        vanilla = Engine.from_parts(*parts, kv_dtype=kv, prefix_cache=False,
                                    max_gen_tokens=chip_smoke.WAVE_TOKENS)
        vanilla.warmup()
        refs = chip_smoke.serial_turns(vanilla, PROMPTS, settings)
        failed += [r["request"] for r in refs if r["status"] != 200]
        for route in ("served", "cuda_core_9"):
            with routes(route) as at9:
                for r in refs:
                    chip_smoke.say("route_noise", route=route, at_9_rows=at9,
                                   request=r["request"],
                                   **chip_smoke.route_noise(vanilla, r["prompt"], r["ids"]))
                spec = Engine.from_parts(*parts, kv_dtype=kv, spec_decode="lookup",
                                         spec_draft=chip_smoke.SPEC_DRAFT,
                                         max_gen_tokens=chip_smoke.WAVE_TOKENS)
                spec.warmup()        # the verify graph captured under this route
                for draft, ctx in (("always_hit", chip_smoke.always_hit_drafts()),
                                   ("oracle", chip_smoke.oracle_drafts(refs))):
                    with ctx:
                        rows = chip_smoke.serial_turns(spec, PROMPTS, settings)
                    failed += [r["request"] for r in rows if r["status"] != 200]
                    chip_smoke.say("spec_parting", kv_dtype=kv, route=route, at_9_rows=at9,
                                   draft=draft,
                                   spec=[{"request": r["request"], **(r["spec"] or {})}
                                         for r in rows],
                                   parity=chip_smoke.reply_parity(vanilla, rows, refs, sp))
                spec.close()
                del spec
                gc.collect()
                torch.cuda.empty_cache()
        vanilla.close()
        del vanilla
        gc.collect()
        torch.cuda.empty_cache()
    chip_smoke.say("done", seconds=round(time.time() - t0, 1), failed=failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

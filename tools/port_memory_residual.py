#!/usr/bin/env python3
"""What the memory ledger's ``residual`` line holds on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/port_memory_residual.py [--tokens 64]

Serves ``chip_smoke.py``'s synthetic Llama-3-8B-width Q4_K_M file (written
there, or reused from ``.cache/chip_smoke/``) as the default pod does, with
the CUDA caching allocator recording the stack of every allocation
(``torch.cuda.memory._record_memory_history``), and prints JSON lines:

- ``stages``: the allocator's live bytes after each step of bringing the
  engine up (weights, ring, graphs, warmup, one greedy request);
- ``ledger``: ``/debug/memory``'s document at the end;
- ``residual``: the live blocks inside no ledger component (the weights,
  the ring), grouped by the innermost frame of the repository or of
  ``torch`` that allocated them, largest first, beside their sum, the
  slack of the components' own blocks (the allocator rounds a request up
  to its block) and the ledger's ``residual_bytes``.

The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _site(frames: list) -> str:
    """The innermost frame of this repository (else of torch, else the
    innermost) of an allocation's stack, as ``file:line function``."""
    def fmt(f):
        return f"{os.path.relpath(f['filename'], HERE) if f['filename'].startswith(HERE) else os.path.basename(f['filename'])}:{f['line']} {f['name']}"

    for want in (HERE, "torch"):
        for f in frames:
            if want in f.get("filename", "") and "memory" not in f["filename"]:
                return fmt(f)
    return fmt(frames[0]) if frames else "(no stack)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_memory_residual: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.obs.memledger import MEMLEDGER

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    path = chip_smoke.phase_gguf("q4km")
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    stages = {}

    def stage(name):
        torch.cuda.synchronize()
        stages[name] = torch.cuda.memory_allocated()

    stage("start")
    t0 = time.time()
    eng = Engine(path)
    stage("engine")                      # weights, ring, graphs' state
    eng.warmup()
    stage("warmup")                      # the capture, a request, a full pass
    out = eng.create_chat_completion([{"role": "user", "content": "hi"}],
                                     temperature=0.0, max_tokens=args.tokens)
    stage("request")
    print(json.dumps({"stages": stages, "weight_bytes": eng.weight_bytes,
                      "kv_cache_bytes": eng.kv_cache_bytes,
                      "completion_tokens": out["usage"]["completion_tokens"],
                      "seconds": round(time.time() - t0, 1)}), flush=True)
    ledger = MEMLEDGER.snapshot()
    print(json.dumps({"ledger": ledger}), flush=True)

    owned = []                           # (start, end) of every component's storage
    for t in [*eng.params.buffers(), *eng._cache.values()]:
        st = t.untyped_storage()
        owned.append((st.data_ptr(), st.data_ptr() + st.nbytes()))
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    groups: dict = {}
    owned_blocks = 0                     # the blocks holding the components
    for seg in snap["segments"]:
        private = tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)
        addr = seg["address"]
        for blk in seg["blocks"]:
            start, size = addr, blk["size"]
            addr += size
            if blk["state"] != "active_allocated":
                continue
            if any(lo <= start < hi for lo, hi in owned):
                owned_blocks += size
                continue
            key = ("graphs' pool: " if private else "") + _site(blk.get("frames", []))
            g = groups.setdefault(key, {"bytes": 0, "blocks": 0})
            g["bytes"] += size
            g["blocks"] += 1
    rows = sorted(groups.items(), key=lambda kv: -kv[1]["bytes"])
    print(json.dumps({"residual": {
        "ledger_residual_bytes": ledger["residual_bytes"],
        "unowned_block_bytes": sum(g["bytes"] for _, g in rows),
        # the allocator counts whole blocks: what the components' blocks
        # hold beyond their tensors' bytes
        "component_block_slack_bytes": owned_blocks - ledger["attributed_bytes"],
        "by_site": [{"site": k, **g} for k, g in rows[:16]]}}), flush=True)
    eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

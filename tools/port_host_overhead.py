#!/usr/bin/env python3
"""The host's cost a decode chunk in the port's serial engine, on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/port_host_overhead.py [--reps 6] [--tokens 256] [--model tiny|8b]

A ``tiny`` model (``chip_smoke.write_gguf``: dim 256, 2 layers, vocab 512,
random Q8_0 weights served as bf16, or as int8 weights with the
layer-looped decode) takes tens of µs of device time a token, so its
decode rate is set by the host: the engine's loop, the graph launches and
whatever the serving layer adds.  ``8b`` serves ``chip_smoke.py``'s
Q4_K_M file (written there, or reused from ``.cache/chip_smoke/``) as
int8 weights with one looped launch a token, the fastest of its engines.
Each variant serves ``--reps`` greedy replies of ``--tokens`` tokens and
prints one JSON line with their decode tokens/s (the engine's
``lfkt_timings``):

- ``engine``: ``Engine.create_chat_completion`` called directly;
- ``engine_traced``: the same with a request trace, where the engine takes
  one (``trace=``);
- ``served``: ``POST /response`` through the app on the in-tree httpd (the
  tracing middleware and, where the app has one, the watchdog running).

Compare two trees by running each from its own root in turns.  The card's
name and power limit come first.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--model", choices=("tiny", "8b"), default="tiny")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_host_overhead: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    loop = ("int8-loop", {"weight_format": "int8", "decode_layer_unroll": -1})
    if args.model == "8b":
        path, engines = chip_smoke.phase_gguf("q4km"), (loop,)
    else:
        cfg = ModelConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                          ffn_dim=512, n_ctx=1024)
        path = os.path.join(tempfile.mkdtemp(), "tiny-q8_0.gguf")
        chip_smoke.write_gguf(cfg, path, "q8_0")
        engines = (("bf16", {}), loop)
    msgs = [{"role": "user", "content": "tell me about the sea, please"}]
    short = [("user", "hi"), ("assistant", "hey"), ("user", "how are you?")]
    for label, kw in engines:
        eng = Engine(path, n_ctx=1024, max_gen_tokens=args.tokens, **kw)
        eng.warmup()
        takes_trace = "trace" in inspect.signature(eng.create_chat_completion).parameters
        variants = [("engine", None)]
        if takes_trace:
            from llama_fastapi_k8s_gpu_tpu_torch.obs.trace import Tracer

            variants.append(("engine_traced", Tracer(sample=1.0, ring=64)))
        for name, tracer in variants:
            rates = []
            for _ in range(args.reps):
                extra = {"trace": tracer.start()} if tracer is not None else {}
                out = eng.create_chat_completion(msgs, temperature=0.0,
                                                 max_tokens=args.tokens, **extra)
                if tracer is not None:
                    tracer.finish(extra["trace"])
                assert out["usage"]["completion_tokens"] == args.tokens
                rates.append(eng.last_timings["tokens_per_sec"])
            print(json.dumps({"model": args.model, "engine": label, "variant": name,
                              "tokens": args.tokens,
                              "tokens_per_sec": rates}), flush=True)
        app = create_app(engine=eng, settings=Settings(temperature=0.0,
                                                       timeout_seconds=600.0))
        rates = []
        with chip_smoke.serving(app) as (port, _):
            for _ in range(args.reps):
                st, _doc = chip_smoke._http(port, "POST", "/response", chip_smoke.body(short))
                assert st == 200
                rates.append(eng.last_timings["tokens_per_sec"])
        print(json.dumps({"model": args.model, "engine": label, "variant": "served",
                          "tokens": args.tokens,
                          "tokens_per_sec": rates}), flush=True)
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

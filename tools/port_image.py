#!/usr/bin/env python3
"""``chip_smoke.py``'s two halves of the GPU image alone, on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/port_image.py

Prints the card's name and power limit, then the ``build`` line (the
image's build stage: a child with no card visible builds the kernel
library into ``.cache/chip_smoke/kernels`` importing no torch, and this
process loads it without building), writes (or reuses) the synthetic
Q4_K_M GGUF under ``.cache/chip_smoke/``, and runs the ``image`` phase
alone (the image's runtime stage: a pod from a read-only package and kernel
cache with no toolkit, reading the file cold where it can; its seconds to
READY, its ``kernel_build`` compiles, the library's ``NEEDED`` entries; a
child on an empty cache that must fail), then serves the file in this process for the
greedy short reply the pod's must equal.  Last, ``image_lanes``: a pod of
the same image shape with the lane settings the GPU chart suggests in
``app.extraEnv`` (:data:`CHART_LANES`), the file evicted again, its
seconds to READY and one short request.  Each with the phase's seconds.  A
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

#: the lane and KV-pool examples of helm-gpu/values.yaml's ``extraEnv``,
#: at once: the pod shape whose warmup captures the most
CHART_LANES = dict(LFKT_BATCH_SIZE="8", LFKT_KV_PAGED="1", LFKT_KV_POOL_PAGES="256",
                   LFKT_KV_PAGE_TOKENS="128", LFKT_KV_SPILL_PAGES="512",
                   LFKT_SPEC_DECODE="lookup")


def short_reply(path: str) -> str:
    """The in-process Q4_K_M engine's greedy reply to the short request, as
    ``chip_smoke.phase_serve`` serves it (the reference's defaults, greedy,
    a 600 s timeout)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    eng = Engine(path, n_ctx=1024, kv_dtype="bf16", weight_format="auto")
    eng.warmup()
    app = create_app(engine=eng, settings=Settings(temperature=0.0, timeout_seconds=600.0))
    with chip_smoke.serving(app) as (port, _):
        st, doc = chip_smoke._http(port, "POST", "/response", chip_smoke.body(chip_smoke.SHORT_CTX))
    if st != 200:
        raise AssertionError(f"short request: {st} {doc}")
    eng.close()
    del app, eng
    gc.collect()
    torch.cuda.empty_cache()
    return doc["response"]


def lane_pod(path: str) -> dict:
    """``image_lanes``: a pod with :data:`CHART_LANES`, from the checkout
    with no toolkit and the run's kernel cache, the file evicted first."""
    d, name = os.path.split(path)
    out = {"env": CHART_LANES, "resident_evicted": chip_smoke.evict(path)}
    pod = chip_smoke.Pod("image_lanes", dict(CHART_LANES, LFKT_MODEL_DIR=d,
                                             LFKT_MODEL_NAME=name, LFKT_TEMPERATURE="0",
                                             LFKT_TIMEOUT_SECONDS="600"),
                         base_env=chip_smoke.scrub_toolkit(os.environ))
    try:
        out["ready_s"] = pod.ready()
        progs = {p["name"]: p for p in pod.get("/debug/compiles")["programs"]}
        out["kernel_build_compiles"] = progs.get("kernel_build", {}).get("compiles")
        # what the warmup compiled and captured, and the paged pool it serves
        out["warmup_compiles"] = {k: p.get("compiles") for k, p in progs.items()}
        out["kv_pool"] = "kv_pool" in pod.get("/health")["engine"]
        t = time.time()
        st, doc = chip_smoke._http(pod.port, "POST", "/response",
                                   chip_smoke.body(chip_smoke.SHORT_CTX), timeout=900)
        out["reply"] = {"status": st, "seconds": time.time() - t,
                        "chars": len((doc or {}).get("response", ""))}
    except BaseException:
        chip_smoke.say("image_lanes", **out, log=pod.tail())
        raise
    finally:
        pod.stop()
    chip_smoke.say("image_lanes", **out)
    if out["kernel_build_compiles"] != 0 or not out["kv_pool"] \
            or out["reply"]["status"] != 200:
        raise AssertionError(f"image_lanes: {out}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_image: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    path = chip_smoke.phase_gguf("q4km")
    t1 = time.time()
    image = chip_smoke.phase_image(path)
    chip_smoke.image_verdict(image, short_reply(path))
    chip_smoke.say("phase_seconds", name="image", seconds=round(time.time() - t1, 1))
    t1 = time.time()
    lane_pod(path)
    chip_smoke.say("phase_seconds", name="image_lanes", seconds=round(time.time() - t1, 1))
    chip_smoke.say("done", seconds=round(time.time() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

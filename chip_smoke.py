#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one line each (a failing phase ends the run with a non-zero exit
and no result line):

1. device: the card's name and power limit (``nvidia-smi``) and CUDA;
2. build: the image's build stage — a child process with no card visible
   (``CUDA_VISIBLE_DEVICES=""``) runs ``python3 -m
   llama_fastapi_k8s_gpu_tpu_torch.utils.kernelcache`` into
   ``LFKT_COMPILE_CACHE_DIR=.cache/chip_smoke/kernels``, timed, and must
   build importing no torch; this process (and every pod after it) then
   finds that library and loads it without building (``loaded_built``
   false), the line keeping ``ptxas -v``'s report.  Then, while the card
   waits for the other files, the image's runtime stage (``image``): from
   a copy of the port package and the run's kernel cache, both made
   read-only (``chmod -R a-w``), with no ``nvcc`` on ``PATH`` and no
   ``CUDA_HOME``/``CUDA_PATH``, a child on an empty cache must fail naming
   the digest (no fallback), and a ``python -m
   llama_fastapi_k8s_gpu_tpu_torch.server`` pod on the Q4_K_M file, its
   pages first dropped from the page cache where the file system lets
   them go (``resident_evicted``: the share left, 1.0 for a warm read),
   must reach READY (its seconds: the cold start with a baked library, beside
   the files' writers) with no ``kernel_build`` compile on
   ``/debug/compiles``, the cache's library mapped and nothing written
   into the copy or the cache; its line, printed after the serial engines,
   holds its greedy short reply against the Q4_K_M engine's, byte for
   byte, and the library's size and ``NEEDED`` entries (``readelf -d``);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the Llama-3-8B shapes the serving paths give it, with kernel, plain,
   library (one PyTorch call computing the same function) and bound times
   — the dequants in both outputs (bf16 and f32), flash attention over
   both rings at the served prompt slices (S = 256 at offsets 0, 256 and
   512, and at 768; the 86-token follow-up suffix at 745), with a
   ``flash_slice`` line per ring summing the served shapes' times over 32
   layers, the layer-looped decode kernel in its four variants (bf16/int8
   weights × bf16/int8 KV ring) over two full-width layers of random
   weights and a ring filled to slot 700, with a ``loop_positions`` line
   timing it at slots 0, 255, 512, 700, 768 and 1023 beside its bound
   (the served requests decode at slots 460–1023), the int8 KV write
   (K's RoPE, then the quantize, into the ring) eager and from a CUDA graph
   (``graph_ms``, its device time) beside the device time of the plain
   torch it absorbed (``absorbed_graph_ms``: the table and k's rotation),
   and with its lane axis (``kv_quantize_lanes`` lines: one token in each
   of B = 1, 3, 8 lanes of a lane-major cache, eager and from a graph
   replayed with the slots moved, bit-exact, beside the one-ring call's
   and B one-lane launches' graph times);
   the dequants also at every shape the loads give them, into bf16 and
   f32, from a graph beside the byte bound (a ``dequant_shapes`` line
   each), and at an odd shape (a ``dequant_odd`` line each), the Q4_K and
   Q5_K ones on blocks whose every header byte is random;
   and, as ``int8_linear`` lines, the int8 linear the int8 engines serve
   (``torch._int_mm``, a library call) at the 8B shapes.  The fused
   matmuls' lines name the launcher's path (``tc``: the tensor-core
   template, ``cuda_core``) and the distance from the library's result;
   at B=1 (a decode token) they also time kernel and library cold, the
   weight (the library's bf16 plane) rotated through copies that together
   exceed the 50 MB L2 (``cold_graph_ms``), and a ``fused_token`` line per
   fused file sums one decode token's fused linears (calls × B=1 time)
   beside its bound; ``route_sweep`` lines time both paths of the four
   fused matmuls cold at B = 1..16, ``route_layer`` lines sum them over
   one layer's linears of each file, and a ``route_threshold`` line per
   format reads from its file's layer the smallest B from which the
   tensor cores win at every larger B, beside the launcher's threshold:
   the measurement behind the launchers' thresholds;
4. gguf: four synthetic Llama-3-8B-width GGUFs (random valid blocks from a
   seed) in the tensor types of a Q4_K_M, a Q5_K_M, a Q8_0 and a Q6_K
   file, a synthetic Mistral-7B file (Mistral-7B-v0.1's published
   config at full width and depth, Q4_K_M's types, architecture ``llama``
   with ``llama.attention.sliding_window`` 4096, a seeded 32000-piece
   SentencePiece vocabulary whose pieces make the prompts' words whole,
   ``<0xXX>`` byte pieces for the rest, the ``[INST]`` template) and a
   mixed-type file (Llama-3-8B width, 4 layers, F16, BF16, Q4_0, Q4_1,
   Q5_0, Q5_1, Q2_K, Q3_K, IQ4_NL and IQ4_XS spread over token_embd,
   output and the 28 linears, each on two tensors or more), written with
   the port's own writer into ``.cache/chip_smoke/`` by three spawned
   processes while phase 2 builds (a ``ggufs`` line: the seconds waited
   after the build), and reused when present (about 33 GB);
5. serve: per file, the port's ``Engine`` behind its app on the in-tree
   httpd at 127.0.0.1 — the Q6_K file over the int8 KV cache
   (``kv_dtype="int8"``) — ``/response`` requests at temperature 0 (a
   short one, a long one whose prompt spans several 256-token prefill
   slices, and — on the Q4_K_M and the Q6_K file — a follow-up turn that
   takes prefix reuse), then ``GET /health``; every linear must serve fused
   in the file's formats, ``/health`` must report the file's KV dtype and
   ring bytes, the served model's logits must be finite and its flash
   prompt pass must agree with the plain score-matrix one.  Each file's
   kernel launches go on a line of their own, and so do the launches of
   one decode token and of one 256-token prompt slice (``per_token``,
   ``per_slice``: the port's kernels by their counters, and every CUDA
   kernel as ``torch.profiler`` records it, ``cuda_kernels``; ``per_token``
   also for one graph replay).  Every engine decodes by replays of its
   captured decode step: a ``graph`` line holds 64 greedy replays against
   the eager step on a clone of the ring (tokens and every cache leaf
   bit-identical, or the run fails), a ``replay_trace`` line breaks a
   replay's device time down by part (``torch.profiler``), and on the
   Q4_K_M file one more request at the reference's 25 s timeout must
   return 200 with all 512 tokens (``deadline_request``).  With
   ``CHIP_SMOKE_REPLIES_OUT`` the run writes every request's token ids;
   with ``CHIP_SMOKE_REPLIES`` (an earlier run's) it prints a
   ``reply_change`` line where a reply parts from it.  On the Q4_K_M
   file the rest of the HTTP surface follows (the ``http`` lines, ending in
   a watchdog drill with the incident recorder armed: ``incidents`` and
   ``slo``), then the device-facing one on a fresh app (the ``obs``
   lines: ``compiles`` — graph captures as compiles, dispatches, a
   recompile storm under a low budget —, ``memory``, ``metrics_families``,
   ``launches_audit``, and ``profile``: a second app started with
   ``LFKT_PROFILE_DIR`` set pays the profiler's set-up at startup, and its
   first capture, asked for before a single stream starts, must open
   within a second and hold the stream's kernels).  Two more engines
   serve files already written, with the layer-looped decode armed: the
   Q4_K_M file as int8 weights with one looped launch a token
   (``decode_layer_unroll=-1``), and the Q8_0 file as bf16 weights over the
   int8 ring with four (``decode_layer_unroll=8``); each checks ``/health``'s
   effective unroll, the looped launches of one token, 16 teacher-forced
   decode steps against the per-layer path on the same weights, and times
   both paths' decode ms/token.  Then the Mistral file at n_ctx 8192,
   where its 4096-token window bites: ``mistral_q4km`` (fused, bf16 ring)
   and ``mistral_int8_loop`` (int8 weights, int8 ring, one looped launch a
   token), each with a short and a ~4,700-token ``/response`` (prompt
   slices and decode past slot 4096), the first also with the follow-up,
   ``/v1`` with a system message, without and with a stream (the same
   text, ``mistral_http``) and the 25 s request; beside the lines above, the
   flash pass on the slice past slot 4096 against the plain one with the
   window (``logits``), one decode step past the window against the same
   step with the window set to 0 on a clone of the ring, which must differ
   (``window``), and the SPM tokenizer over the served prompts
   (``tokenizer``: encode seconds and rate, byte-fallback ids, whole-word
   share, ``decode(encode(text)) == text``).  Last, the mixed-type file
   under ``auto`` (every linear bf16) and ``int8``: the load's seconds by
   type (``load_types``: host codec, upload, bytes) and, for one tensor of
   each type, the plane expanded on the card against the codec's output,
   bit for bit (``planes``).  Then three lane engines serve files already
   written from lanes of the card behind the app (``LFKT_BATCH_SIZE`` > 1):
   ``lanes_q4km``, the Q4_K_M file from 8 lanes under the continuous
   scheduler (16 concurrent ``/response`` clients of 128 tokens beside a
   stream, the follow-up turn's lane-prefix reuse, a dropped stream's
   lane, and the 512-token request among 7 others at the 25 s timeout:
   ``lane_deadline``, printed, not gated); ``lanes_q4km_int8``, its
   weights over the int8 ring, per-layer, from 4 lanes (8 clients beside a
   stream, the follow-up), where one ``kv_quantize`` launch a layer
   writes every lane; and ``cycle_q8_0_bf16_loop8``, the Q8_0 file as bf16
   weights over the int8 ring with the looped kernel 8 layers a launch, 4
   lanes under the cycle scheduler (8 clients).  Before them, phase 3
   holds every fused matmul at the lane counts 4 and 8 too
   (``lane_matmul``).  Each lane engine prints a ``lanes`` line
   (statuses, finish reasons, aggregate tok/s, TTFT p50/p95, idle
   lane-seconds, admission slices, cycles, the lane graph's launches a
   replay against what its path must launch) and, off the served path,
   ``lane_parity`` (each greedy reply against the serial engine on the
   same weights, per-layer, on the lanes' own ring, or the bf16 ring for
   looped lanes: equal, or parting only at a top-2 margin within two bf16
   steps), ``lane_graph`` (64
   replays of the lane step against the eager lane step on a cloned
   state, bit-identical), ``lane_isolation`` (one lane's inputs changed:
   the other lanes' logits, tokens and rings bit-identical) and
   ``lane_route`` (each fused linear's route and µs in a replay's
   profile, beside the decode attention's ms alone).  Then the paged KV
   pool and prompt-lookup speculation on the Q4_K_M weights (not loaded
   again; pages of 128 tokens): ``paged`` (serial, bf16 ring: the short,
   long and follow-up requests and a second conversation opening as the
   short one does, first on a dense engine, then on a paged one — reused
   tokens and TTFT beside the dense engine's, the pool's occupancy, a
   4-page restore and store in ms beside their bound, the memory rows,
   each greedy reply against the dense one), ``restored_graph`` (pages
   restored into the captured ring, then replays against the eager step,
   bit-identical), ``paged_int8`` (the int8 ring, the pool one context's
   8 pages with a 16-page host tier: a conversation spilled and restored,
   its pages byte-equal to an export before the spill, its reply equal to
   the one under no pressure), ``paged_lanes`` (4 continuous lanes, 8
   clients opening alike: cross-lane radix hits, TTFT p50/p95, no lease
   left), ``spec`` (serial, ``spec_decode=lookup``, D = 8: a repetitive
   prompt, then an always-hit draft; acceptance, parity with vanilla
   greedy replies, the verify round's ms from its graph and eager beside a
   decode replay's, each fused linear's route and µs at 9 rows,
   ``spec_auto``'s decision on the card), ``verify_graph`` (verify replays
   against the eager verify, bit-identical) and ``spec_lanes`` (4
   continuous lanes under speculation, the lanes' replies against the
   serial vanilla engine's).  Then multi-model serving and the disagg
   tier (``phase_tier``, pages of 128, 64-token greedy replies):
   ``registry`` (the Q4_K_M, Q6_K-over-bf16 and mixed files behind
   ``LFKT_MODELS``, each first alone: shared and private arenas, no prefix
   hit across namespaces, every routed reply equal to the file alone,
   unknown-model 400s, the ``/v1/models`` and ``/health`` rows, a reload
   that drains and frees one model, adds it back, and one refused over the
   weight budget), ``registry_looped`` (two int8 K=-1 models at once, as
   each alone), ``registry_lanes`` (two models × 4 lanes, 8 streamed
   clients), ``disagg`` and ``disagg_lanes`` (``LFKT_DISAGG_ROLE=both``:
   pages received equal to pages exported, the reply over them equal to a
   local hit's, the hop's seconds, bytes and parts) and ``disagg_pods``
   (prefill and decode server processes on the card: the prefill pod
   killed mid-transfer and restarted, an int8 decode pod refused at the
   handshake), each phase's seconds in a ``phase_seconds`` line.  Then
   the fleet tier (``phase_fleet_tier``, the Q4_K_M file, pages of 128):
   ``fleet`` (replicas A and B in this process, each its own engine and
   tracer, ``LFKT_MIGRATE=1`` on ephemeral ports, behind the port's
   ``FleetRouter`` on a thread: routed bytes against direct ones, a
   three-turn conversation on its owner against a round-robin arm, a
   forged ``x-lfkt-prior-owner`` stripped before a decoy sees it,
   pull-on-remap with the owner ejected — the pulled pages equal the
   owner's export bit for bit, the reply the owner's own over its local
   hit, TTFT beside a cold prefill and the hit —, the owner's decode while
   a peer pulls from it, the remap turn's stitched trace,
   ``/metrics/fleet`` against the replicas' sums, and a third replica that
   pre-pulls A's and B's hot prefixes before READY and hits on a turn it
   owns) and ``fleet_pods`` (``LFKT_FLEET_ROLE=router`` and two replica
   processes: the SIGTERM drain hands three conversations to the
   successor, each next turn a hit there; SIGKILL mid-stream, the next
   turns served by local prefill with the failed pulls attributed, the
   router's ejection and its ``fleet_peer_ejected`` bundle; the killed
   owner restarted, re-admitted fresh, pulling its conversations back;
   one traced request through the router rendered by ``python -m
   llama_fastapi_k8s_gpu_tpu_torch.tools.fleet_trace``, one stitched tree
   over the router and the owner with no orphan fragment (``fleet_trace``
   line), and ``tools.incident_report --validate`` over the router's
   incident directory, at least one bundle, exit 0).  Then ``drills``:
   ``python -m llama_fastapi_k8s_gpu_tpu_torch.tools.chaos_drill torn-wire
   slow-wire reload`` over the Q4_K_M file, two replica server processes a
   scenario behind the drill's router, a ``drills`` line a scenario with
   the invariants it held and its seconds.
   Then the mesh (``phase_mesh``, the Q4_K_M file at n_ctx 4096, every
   shard on this card: a mesh over a device list that repeats ``cuda:0``):
   ``mesh_matmul`` / ``mesh_flash`` (each fused kernel at a tp = 2 shard's
   8B shapes held to its plain version, timed beside the unsharded shape;
   flash at a shard's 16 heads over 4), ``mesh_ring`` (``ring_attention``
   and ``sharded_decode_attention`` against the plain single-device
   attention), ``mesh_tp`` (a tp = 2 continuous engine over two lanes
   behind the app: two concurrent ``/response`` clients, a follow-up turn
   and a stream, each turn's first 16 greedy ids against the one-card lane
   engine's — equal or parting at a near-tie —, the first step's logits
   against the one-card engine's) and ``mesh_sp`` (an sp = 2 × tp = 2
   ``SPEngine``: a prompt of more than 2,304 tokens and 32 greedy tokens
   against the one-card ``Engine``), each with its ``launches``;
6. a ``dequant_rank`` line: each dequant's launches × (time − bound)
   over the first six engines' loads, shape by shape (launches from the
   load plan, checked against the wrappers' counters of phase 5), largest
   first; then a ``kernels`` JSON line with every kernel's launches summed
   over the engines of phase 5 beside its phase-3 numbers.

Each top-level phase ends with a ``phase_seconds`` line: its wall seconds
since the one before ended (``build``, ``image``, ``ggufs``, ``kernels``,
``serve``, ``lanes``, ``paged_spec``, ``tier``, ``fleet_tier``, ``drills``,
``mesh``).
The last line is ``{"ok": true, "device": {...}}``.  No JAX anywhere.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import http.client
import json
import os
import re
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache", "chip_smoke")
#: the port package, by name (the image phase serves a read-only copy)
PKG = "llama_fastapi_k8s_gpu_tpu_torch"
#: the kernel cache of the run (LFKT_COMPILE_CACHE_DIR): the build phase's
#: child builds the library here as an image's build stage does, and every
#: process of the run (this one, the pods) finds it there
KERNEL_CACHE = os.path.join(CACHE, "kernels")

#: transformer blocks of the served models (Llama-3-8B has 32; width is never cut)
DEPTH = 32
#: the served files: tensor types of each llama.cpp recipe
LAYOUTS = ("q4km", "q5km", "q8_0", "q6_k")
#: the KV cache each file is served with (bf16 where not named)
KV_DTYPES = {"q6_k": "int8"}
#: the card's published peaks (H100 SXM data sheet): HBM bytes/s, dense bf16
#: FLOP/s, dense int8 OP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

REPLACES = {
    "dequant_q4_k": "llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py:120",
    "q4k_matmul": "llama_fastapi_k8s_gpu_tpu/ops/pallas/qmatmul.py:237",
    "q6k_matmul": "llama_fastapi_k8s_gpu_tpu/ops/pallas/q6matmul.py:243",
    "flash_attention": "llama_fastapi_k8s_gpu_tpu/ops/pallas/attention.py:58",
    "dequant_q5_k": "llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py:197",
    "q5k_matmul": "llama_fastapi_k8s_gpu_tpu/ops/pallas/q5matmul.py:276",
    "dequant_q8_0": "llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py:78",
    "q8_matmul": "llama_fastapi_k8s_gpu_tpu/ops/pallas/q8matmul.py:99",
    "kv_quantize": "llama_fastapi_k8s_gpu_tpu/ops/pallas/kvquant.py:64",
    "flash_attention_int8": "llama_fastapi_k8s_gpu_tpu/ops/pallas/attention.py:58",
    "dequant_q6_k": "llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py:261",
    "decode_loop": "llama_fastapi_k8s_gpu_tpu/ops/pallas/decode_loop.py:142",
}
SOURCES = {
    "dequant_q4_k": "llama_fastapi_k8s_gpu_tpu_torch/csrc/dequant_q4k.cu",
    "q4k_matmul": "llama_fastapi_k8s_gpu_tpu_torch/csrc/q4k_matmul.cu",
    "q6k_matmul": "llama_fastapi_k8s_gpu_tpu_torch/csrc/q6k_matmul.cu",
    "flash_attention": "llama_fastapi_k8s_gpu_tpu_torch/csrc/flash_attention.cu",
    "dequant_q5_k": "llama_fastapi_k8s_gpu_tpu_torch/csrc/dequant_q5k.cu",
    "q5k_matmul": "llama_fastapi_k8s_gpu_tpu_torch/csrc/q5k_matmul.cu",
    "dequant_q8_0": "llama_fastapi_k8s_gpu_tpu_torch/csrc/dequant_q8_0.cu",
    "q8_matmul": "llama_fastapi_k8s_gpu_tpu_torch/csrc/q8_matmul.cu",
    "kv_quantize": "llama_fastapi_k8s_gpu_tpu_torch/csrc/kv_quantize.cu",
    "flash_attention_int8": "llama_fastapi_k8s_gpu_tpu_torch/csrc/flash_attention.cu",
    "dequant_q6_k": "llama_fastapi_k8s_gpu_tpu_torch/csrc/dequant_q6k.cu",
    "decode_loop": "llama_fastapi_k8s_gpu_tpu_torch/csrc/decode_loop.cu",
}
#: the engines served with the layer-looped decode: (label, file, weight
#: format, KV dtype, decode_layer_unroll, expected effective unroll)
LOOPED = (("q4km-int8-loop", "q4km", "int8", "bf16", -1, 32),
          ("q8_0-bf16-loop", "q8_0", "bf16", "int8", 8, 8))
#: the looped kernel's agreement with its plain version over one launch of
#: two layers (phase 3): h and the ring slot written (bf16 values, or int8
#: values times their scales) within this rel-dev, int8 codes within one
LOOP_TOL = 2e-2
#: ring slots at which phase 3 times the looped kernel (``loop_positions``)
LOOP_SLOTS = (0, 255, 512, 700, 768, 1023)
#: the served looped path's agreement with the per-layer path over 32
#: layers and 16 teacher-forced steps: logits and every ring slot written
#: within this rel-dev — one launch's differences (phase 3: under 1%) pass
#: through 32 layers, and under int8 weights through each layer's
#: activation quantize, where a one-step difference moves a code
SERVED_TOL = 5e-2


#: bytes of shared memory a tensor-core decoder stages per weight row and
#: super-block (the decoders' SLOT, csrc/q{4k,5k,6k,8}_matmul.cu)
QMMA_SLOTS = {"Q4K": 144, "Q5K": 176, "Q6K": 240, "Q8": 272}


def qmma_smem(slot: int, tile: int) -> int:
    """Dynamic shared memory of a tensor-core tile (csrc/qmma.cuh
    ``smem_bytes`` at ``xstages``): three x stages where the tile keeps its
    blocks per SM (one at 128, two at 64) within the H100's 227 KB a block
    and 228 KB an SM (1 KB reserved a block), else two."""
    def size(xs):
        return 1024 + (xs + 2) * 2 * tile * 128 + 2 * tile * slot

    fits = size(3) <= 232448 and (1 if tile == 128 else 2) * (size(3) + 1024) <= 233472
    return size(3 if fits else 2)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


# ---------------------------------------------------------------------------
# random valid blocks (kernel inputs and the synthetic GGUFs)
# ---------------------------------------------------------------------------

def rand_q4k(rng, n_out: int, k_in: int):
    """(n_out, k_in) weights as Q4_K block bytes, zero-mean with standard
    deviation ≈ k_in^-0.5: w = d·sc·(q − 7.5), the min folded as
    dmin·mn = 7.5·d·sc."""
    import numpy as np

    from llama_fastapi_k8s_gpu_tpu_torch.gguf.quants import pack_scale_min_k4

    nb = n_out * k_in // 256
    blk = np.frombuffer(rng.bytes(nb * 144), np.uint8).reshape(nb, 144).copy()
    d = np.float16(k_in ** -0.5 / (47.5 * 4.61))
    blk[:, 0:2] = np.array([d], np.float16).view(np.uint8)
    blk[:, 2:4] = np.array([np.float16(7.5 * float(d))], np.float16).view(np.uint8)
    sc = rng.integers(32, 64, (nb, 8), dtype=np.uint8)
    blk[:, 4:16] = pack_scale_min_k4(sc, sc)
    return blk.reshape(n_out, -1)


def rand_q5k(rng, n_out: int, k_in: int):
    """(n_out, k_in) weights as Q5_K block bytes, zero-mean with standard
    deviation ≈ k_in^-0.5: w = d·sc·(q − 15.5) with q uniform in 0..31 (the
    std of which is 9.23), the min folded as dmin·mn = 15.5·d·sc."""
    import numpy as np

    from llama_fastapi_k8s_gpu_tpu_torch.gguf.quants import pack_scale_min_k4

    nb = n_out * k_in // 256
    blk = np.frombuffer(rng.bytes(nb * 176), np.uint8).reshape(nb, 176).copy()
    d = np.float16(k_in ** -0.5 / (47.5 * 9.23))
    blk[:, 0:2] = np.array([d], np.float16).view(np.uint8)
    blk[:, 2:4] = np.array([np.float16(15.5 * float(d))], np.float16).view(np.uint8)
    sc = rng.integers(32, 64, (nb, 8), dtype=np.uint8)
    blk[:, 4:16] = pack_scale_min_k4(sc, sc)
    return blk.reshape(n_out, -1)


def rand_k4_headers(rng, n_out: int, k_in: int, size: int):
    """(n_out, k_in) weights as Q4_K (``size`` 144) or Q5_K (176) block
    bytes for the dequant checks: every byte random, so a sub-block's 6-bit
    scale and min are independent and every bit of the 12 packed bytes
    counts, with a finite f16 d and dmin drawn for each block.  (The fused
    matmuls' checks keep :func:`rand_q4k` / :func:`rand_q5k`, whose weights
    have a matmul's statistics.)"""
    import numpy as np

    nb = n_out * k_in // 256
    blk = np.frombuffer(rng.bytes(nb * size), np.uint8).reshape(nb, size).copy()
    blk[:, 0:4] = rng.uniform(1e-4, 1e-3, (nb, 2)).astype(np.float16).view(np.uint8)
    return blk.reshape(n_out, -1)


def rand_q8_0(rng, n_out: int, k_in: int):
    """(n_out, k_in) weights as Q8_0 block bytes, std ≈ k_in^-0.5: w = d·q
    with q uniform in −128..127 (std 73.9)."""
    import numpy as np

    nb = n_out * k_in // 32
    blk = np.frombuffer(rng.bytes(nb * 34), np.uint8).reshape(nb, 34).copy()
    blk[:, 0:2] = np.array([np.float16(k_in ** -0.5 / 73.9)], np.float16).view(np.uint8)
    return blk.reshape(n_out, -1)


def rand_q6k(rng, n_out: int, k_in: int):
    """(n_out, k_in) weights as Q6_K block bytes, std ≈ k_in^-0.5:
    w = d·sc·(q − 32) with q uniform in 0..63."""
    import numpy as np

    nb = n_out * k_in // 256
    blk = np.frombuffer(rng.bytes(nb * 210), np.uint8).reshape(nb, 210).copy()
    blk[:, 192:208] = rng.integers(8, 16, (nb, 16), dtype=np.uint8)
    d = np.float16(k_in ** -0.5 / (11.5 * 18.5))
    blk[:, 208:210] = np.array([d], np.float16).view(np.uint8)
    return blk.reshape(n_out, -1)


def _half(rng, n: int, std: float, dtype) -> "np.ndarray":
    """``n`` N(0, std²) values as float16 (``dtype`` "F16") or bf16 words
    (the f32's upper halves, "BF16"), as bytes: random draws from a pool of
    65536 normal values (a pool lookup is several times faster than a
    normal draw of every value at the 128256×4096 embedding)."""
    import numpy as np

    pool = rng.standard_normal(65536, dtype=np.float32) * np.float32(std)
    words = (pool.astype(np.float16).view(np.uint16) if dtype == "F16"
             else (pool.view(np.uint32) >> 16).astype(np.uint16))
    return words[np.frombuffer(rng.bytes(2 * n), np.uint16)].view(np.uint8)


def rand_f16(rng, n_out: int, k_in: int):
    """(n_out, k_in) F16 weights, N(0, 1/k_in)."""
    return _half(rng, n_out * k_in, k_in ** -0.5, "F16").reshape(n_out, -1)


def rand_bf16(rng, n_out: int, k_in: int):
    """(n_out, k_in) BF16 weights (f32 draws truncated), N(0, 1/k_in)."""
    return _half(rng, n_out * k_in, k_in ** -0.5, "BF16").reshape(n_out, -1)


def _legacy_blocks(rng, n_out: int, k_in: int, size: int, d: float, m: float | None):
    """Q4_0/Q4_1/Q5_0/Q5_1/IQ4_NL block bytes (32 elements a block): random
    quant bytes under the f16 scale ``d`` (and, Q4_1/Q5_1, the f16 min
    ``m``)."""
    import numpy as np

    nb = n_out * k_in // 32
    blk = np.frombuffer(rng.bytes(nb * size), np.uint8).reshape(nb, size).copy()
    blk[:, 0:2] = np.array([np.float16(d)], np.float16).view(np.uint8)
    if m is not None:
        blk[:, 2:4] = np.array([np.float16(m)], np.float16).view(np.uint8)
    return blk.reshape(n_out, -1)


def rand_q4_0(rng, n_out: int, k_in: int):
    """Q4_0: w = d·(q − 8), q uniform in 0..15 (std 4.61)."""
    return _legacy_blocks(rng, n_out, k_in, 18, k_in ** -0.5 / 4.61, None)


def rand_q4_1(rng, n_out: int, k_in: int):
    """Q4_1: w = d·q + m with m = −7.5·d: zero-mean, std 4.61·d."""
    d = k_in ** -0.5 / 4.61
    return _legacy_blocks(rng, n_out, k_in, 20, d, -7.5 * d)


def rand_q5_0(rng, n_out: int, k_in: int):
    """Q5_0: w = d·(q − 16), q uniform in 0..31 (std 9.23)."""
    return _legacy_blocks(rng, n_out, k_in, 22, k_in ** -0.5 / 9.23, None)


def rand_q5_1(rng, n_out: int, k_in: int):
    """Q5_1: w = d·q + m with m = −15.5·d."""
    d = k_in ** -0.5 / 9.23
    return _legacy_blocks(rng, n_out, k_in, 24, d, -15.5 * d)


def rand_iq4_nl(rng, n_out: int, k_in: int):
    """IQ4_NL: w = d·table[q], q uniform over the 16 values (rms 65)."""
    return _legacy_blocks(rng, n_out, k_in, 18, k_in ** -0.5 / 65.0, None)


def rand_q2_k(rng, n_out: int, k_in: int):
    """Q2_K: w = d·sc·q − dmin·m with the scale and min nibbles equal and
    dmin = 1.5·d, so w = d·sc·(q − 1.5), sc in 8..15, q uniform in 0..3."""
    import numpy as np

    nb = n_out * k_in // 256
    blk = np.frombuffer(rng.bytes(nb * 84), np.uint8).reshape(nb, 84).copy()
    sc = rng.integers(8, 16, (nb, 16), dtype=np.uint8)
    blk[:, 0:16] = sc | (sc << 4)
    d = np.float16(k_in ** -0.5 / (11.7 * 1.118))
    blk[:, 80:82] = np.array([d], np.float16).view(np.uint8)
    blk[:, 82:84] = np.array([np.float16(1.5 * float(d))], np.float16).view(np.uint8)
    return blk.reshape(n_out, -1)


def rand_q3_k(rng, n_out: int, k_in: int):
    """Q3_K: w = d·sc·q, sc in 8..15, q uniform in −4..3 (std 2.29)."""
    import numpy as np

    from llama_fastapi_k8s_gpu_tpu_torch.gguf.quants import _q3k_pack_scales

    nb = n_out * k_in // 256
    blk = np.frombuffer(rng.bytes(nb * 110), np.uint8).reshape(nb, 110).copy()
    blk[:, 96:108] = _q3k_pack_scales(rng.integers(40, 48, (nb, 16), dtype=np.uint8))
    blk[:, 108:110] = np.array([np.float16(k_in ** -0.5 / (11.7 * 2.29))],
                               np.float16).view(np.uint8)
    return blk.reshape(n_out, -1)


def rand_iq4_xs(rng, n_out: int, k_in: int):
    """IQ4_XS: w = d·(ls − 32)·table[q], the 6-bit ls and q random (rms of
    ls − 32: 18.5)."""
    import numpy as np

    nb = n_out * k_in // 256
    blk = np.frombuffer(rng.bytes(nb * 136), np.uint8).reshape(nb, 136).copy()
    blk[:, 0:2] = np.array([np.float16(k_in ** -0.5 / (18.5 * 65.0))],
                           np.float16).view(np.uint8)
    return blk.reshape(n_out, -1)


#: random valid blocks of each GGML type the synthetic files hold
RAND = {"Q4_K": rand_q4k, "Q5_K": rand_q5k, "Q6_K": rand_q6k, "Q8_0": rand_q8_0,
        "F16": rand_f16, "BF16": rand_bf16, "Q4_0": rand_q4_0, "Q4_1": rand_q4_1,
        "Q5_0": rand_q5_0, "Q5_1": rand_q5_1, "Q2_K": rand_q2_k, "Q3_K": rand_q3_k,
        "IQ4_NL": rand_iq4_nl, "IQ4_XS": rand_iq4_xs}


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(line, flush=True)
    info = {"nvidia_smi": line, "torch": torch.__version__,
            "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    say("device", **info)
    return info


def imported_modules(importtime_stderr: str) -> set:
    """The modules a ``python -X importtime`` run imported, from its stderr."""
    return {ln.split("|")[-1].strip() for ln in importtime_stderr.splitlines()
            if ln.startswith("import time:") and "|" in ln}


def phase_build() -> dict:
    """The image's build stage, then its first load: a child process with no
    card (``CUDA_VISIBLE_DEVICES=""``) runs the kernel cache's entry into
    :data:`KERNEL_CACHE` and must build, importing no torch; then this
    process loads the library it built, without building.  The knob stays
    set in this process, so every process the run starts after it (the
    pods) finds the library there as a pod finds the one its image baked."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _kernels
    from llama_fastapi_k8s_gpu_tpu_torch.utils import kernelcache

    make_writable(KERNEL_CACHE)           # an earlier run's image phase
    shutil.rmtree(KERNEL_CACHE, ignore_errors=True)
    os.environ["LFKT_COMPILE_CACHE_DIR"] = KERNEL_CACHE
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", LFKT_COMPILE_CACHE_DIR=KERNEL_CACHE,
               PYTHONPATH=os.pathsep.join(filter(None, (HERE, os.environ.get("PYTHONPATH")))))
    t0 = time.time()
    child = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", f"{PKG}.utils.kernelcache"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    child_s = time.time() - t0
    if child.returncode != 0:
        raise AssertionError(f"kernel build child exited {child.returncode}: "
                             f"{child.stdout[-3000:]}{child.stderr[-6000:]}")
    doc = json.loads(child.stdout.strip().splitlines()[-1])
    torch_in_child = sorted(m for m in imported_modules(child.stderr)
                            if m.split(".")[0] == "torch")
    t1 = time.time()
    _kernels.library()
    load_s = time.time() - t1
    info = kernelcache.build_info
    log = info.get("log", "").splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    # the tensor-core template's instantiations by decoder, tile edge and
    # alignment (Q5KDecoderELi128ELb1: Q5_K, 128 x 128, 16-byte copies):
    # ptxas's registers and spills, and the dynamic shared memory the
    # launcher asks for
    qmma = {}
    for i, ln in enumerate(log):
        if "Function properties for" in ln and "qmma_kernel" in ln:
            key = ln[ln.index("Q"):].split("EEEv")[0]
            smem = qmma_smem(QMMA_SLOTS[key.split("Decoder")[0]],
                             int(key.split("ELi")[1].split("E")[0]))
            qmma[key] = " | ".join([*(x.strip() for x in log[i + 1:i + 3]),
                                    f"{smem} bytes dynamic smem"])
    out = dict(seconds=doc["seconds"], child_s=round(child_s, 2), built=doc["built"],
               digest=doc["digest"], path=doc["path"], nvcc=doc["nvcc"],
               torch_in_child=torch_in_child, loaded_built=info.get("built"),
               load_s=round(load_s, 3))
    say("build", **out, ptxas=ptxas, qmma=qmma)
    if (not doc["built"] or torch_in_child or info.get("built") is not False
            or info.get("path") != doc["path"]):
        raise AssertionError(f"build: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the serving shapes
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches after one
    warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


#: bytes that pass between two uses of one copy in a cold timing: twice
#: the H100's 50 MB L2
COLD_FLUSH_BYTES = 100_000_000


def cold_copies(nbytes: int, flush: int = COLD_FLUSH_BYTES) -> int:
    """Distinct copies of an operand of ``nbytes`` that a cold timing
    rotates through: ⌈flush ÷ nbytes⌉, at least 2, so that ``flush`` bytes
    of other copies pass between two uses of one."""
    return max(2, -(-flush // nbytes))


def graph_calls(fn, reps: int, copies: int = 0) -> list:
    """The calls a timing graph captures: ``reps`` calls of ``fn()``; in
    cold mode (``copies`` > 0) calls of ``fn(i % copies)``, the caller's
    i-th copy of its large operands, ``reps`` rounded up to a multiple of
    ``copies`` so that every other copy is used between two uses of one
    (also across replays)."""
    if not copies:
        return [fn] * reps
    return [functools.partial(fn, i % copies) for i in range(-(-reps // copies) * copies)]


def graph_ms(fn, reps: int = 20, copies: int = 0) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls captured in
    one CUDA graph and replayed: the kernels' time without the host's
    launch overhead, which ``cuda_ms`` includes where it exceeds the
    kernel.  Warm: every call finds its operands in the L2 where they fit
    (50 MB).  Cold (``copies`` > 0, :func:`graph_calls`): call i runs on
    copy i % copies; with :func:`cold_copies` copies each call finds them
    out of the L2, as a decode step finds its weights."""
    import torch

    calls = graph_calls(fn, reps, copies)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for call in calls:
            call()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / len(calls)


def cold_graph_ms(fn, operand, reps: int = 20) -> float:
    """:func:`graph_ms` in cold mode over copies of ``operand`` (the
    weight, or the library's bf16 plane): ``fn(t)`` runs on one copy."""
    copies = [operand] + [operand.clone()
                          for _ in range(cold_copies(operand.numel() * operand.element_size()) - 1)]
    try:
        return graph_ms(lambda i: fn(copies[i]), reps, len(copies))
    finally:
        del copies


def bound(nbytes: float, flops: float, rate: float = BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of moving ``nbytes``
    at the HBM rate and doing ``flops`` at ``rate`` (the bf16 peak unless
    named)."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / rate
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fused_formats() -> dict:
    """Fused matmul name → (kernel wrapper, plain version, block generator,
    dequantizer to f32)."""
    from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant, q4k, q5k, q6k, q8

    return {
        "q4k_matmul": (q4k.q4k_matmul, q4k.q4k_matmul_plain, rand_q4k,
                       dequant.dequant_q4_k_f32),
        "q5k_matmul": (q5k.q5k_matmul, q5k.q5k_matmul_plain, rand_q5k,
                       dequant.dequant_q5_k_f32),
        "q6k_matmul": (q6k.q6k_matmul, q6k.q6k_matmul_plain, rand_q6k,
                       dequant.dequant_q6_k_f32),
        "q8_matmul": (q8.q8_matmul, q8.q8_matmul_plain, rand_q8_0,
                      dequant.dequant_q8_0_f32),
    }


def hold_matmul(name, x, w, n_out, k_in, tol_rel=8e-3) -> tuple:
    """The fused matmul ``name`` on ``x`` (B, K) bf16 and the packed ``w``
    against its plain version (the f32 product): finite and within
    ``tol_rel``·max|y|, or the run fails.  Returns (y, max |kernel-plain|,
    the tolerance)."""
    import torch

    kern, plain = fused_formats()[name][:2]
    y = kern(x, w, n_out, k_in)
    y_ref = plain(x, w, n_out, k_in)
    torch.cuda.synchronize()
    err = (y.float() - y_ref.float()).abs().max().item()
    tol = tol_rel * y_ref.float().abs().max().item()
    if not (torch.isfinite(y).all() and err <= tol):
        raise AssertionError(f"{name} ({n_out},{k_in}) B={x.shape[0]}: max |kernel-plain| "
                             f"{err} > {tol}")
    return y, err, tol


def check_matmul_lanes(name, rng, n_out, k_in, batches, tol_rel=8e-3) -> list:
    """The fused matmul at each lane count in ``batches`` (the rows a lane
    step gives each linear) held to its plain version (:func:`hold_matmul`),
    one weight for all: the ``lane_matmul`` rows, each with the launcher's
    route and the device ms from a CUDA graph."""
    import numpy as np
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    kern, _, rand, _ = fused_formats()[name]
    w = torch.from_numpy(np.ascontiguousarray(rand(rng, n_out, k_in))).cuda()
    rows = []
    for B in batches:
        x = torch.from_numpy(rng.standard_normal((B, k_in), np.float32)).cuda().to(torch.bfloat16)
        _, err, tol = hold_matmul(name, x, w, n_out, k_in, tol_rel)
        rows.append({"name": name, "shape": [n_out, k_in], "B": B,
                     "path": _fused.route(name, B, k_in), "max_abs_err": err, "tol": tol,
                     "graph_ms": graph_ms(lambda: kern(x, w, n_out, k_in))})
    del w
    return rows


def check_matmul(name, rng, n_out, k_in, B, tol_rel=8e-3) -> dict:
    """A fused matmul against its plain version (the f32 product) within
    ``tol_rel``·max|y|, timed beside the library call (bf16 ``torch.matmul``
    on the pre-dequantized plane); ``path`` is the launcher's route for this
    B (``tc`` or ``cuda_core``) and ``library_max_abs_err`` the distance
    from the library's result (on the tensor cores the same arithmetic:
    the sums' order and a bf16 step apart).  ``ms`` / ``library_ms`` time
    eager calls, as every kernel line does; ``graph_ms`` /
    ``library_graph_ms`` the same calls replayed from a CUDA graph (device
    time alone); at B=1 ``cold_graph_ms`` / ``library_cold_graph_ms`` the
    same with the weight (the library's bf16 plane) out of the L2."""
    import numpy as np
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    kern, plain, rand, dequant_f32 = fused_formats()[name]
    w = torch.from_numpy(np.ascontiguousarray(rand(rng, n_out, k_in))).cuda()
    x = torch.from_numpy(rng.standard_normal((B, k_in), np.float32)).cuda().to(torch.bfloat16)
    y, err, tol = hold_matmul(name, x, w, n_out, k_in, tol_rel)
    deq = dequant_f32(w.reshape(-1)).reshape(n_out, k_in).to(torch.bfloat16)
    y_lib = torch.matmul(x, deq.t())
    reps = 20 if B == 1 else 5
    out = {
        "shape": [n_out, k_in], "B": B, "path": _fused.route(name, B, k_in),
        "max_abs_err": err, "tol": tol,
        "library_max_abs_err": (y.float() - y_lib.float()).abs().max().item(),
        "ms": cuda_ms(lambda: kern(x, w, n_out, k_in), reps),
        "plain_ms": cuda_ms(lambda: plain(x, w, n_out, k_in), 2),
        "library_ms": cuda_ms(lambda: torch.matmul(x, deq.t()), reps),
        "graph_ms": graph_ms(lambda: kern(x, w, n_out, k_in)),
        "library_graph_ms": graph_ms(lambda: torch.matmul(x, deq.t())),
        **bound(x.numel() * 2 + w.numel() + B * n_out * 2, 2.0 * B * n_out * k_in),
    }
    if B == 1:      # a decode step: its weights come cold from device memory
        out["cold_graph_ms"] = cold_graph_ms(lambda t: kern(x, t, n_out, k_in), w)
        out["library_cold_graph_ms"] = cold_graph_ms(lambda t: torch.matmul(x, t.t()), deq)
    del w, x, deq, y_lib
    return out


SWEEP_BATCHES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16)


def route_sweep(name, rng, n_out, k_in, batches=SWEEP_BATCHES) -> dict:
    """The two paths of a tensor-core fused matmul at small B, each forced
    in turn (device ms, :func:`cold_graph_ms`: served weights are cold):
    what the launcher's threshold rests on."""
    import numpy as np
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    kern = fused_formats()[name][0]
    w = torch.from_numpy(np.ascontiguousarray(fused_formats()[name][2](rng, n_out, k_in))).cuda()
    out = {"name": name, "shape": [n_out, k_in], "cuda_core_ms": [], "tc_ms": [],
           "B": list(batches), "threshold": _fused.tc_min_batch(name)}
    try:
        for B in batches:
            x = torch.from_numpy(rng.standard_normal((B, k_in), np.float32)).cuda().to(torch.bfloat16)
            for path, min_batch in (("cuda_core", 1 << 30), ("tc", 1)):
                _fused.tc_config(name, min_batch)
                out[path + "_ms"].append(cold_graph_ms(lambda t: kern(x, t, n_out, k_in), w))
    finally:
        _fused.tc_config(name, out["threshold"])
    del w
    return out


def check_flash(rng, S, n_ctx, pos_offset, H=32, n_kv=8, hd=128, tol=2e-2) -> dict:
    """The bf16-ring flash kernel against its plain version; the library
    time is SDPA with the causal mask over K/V repeated to the query heads.
    ``ms`` / ``library_ms`` time eager calls, ``graph_ms`` /
    ``library_graph_ms`` the same calls replayed from a CUDA graph (device
    time alone: an eager call of a few tens of microseconds is mostly the
    host's)."""
    import torch
    import torch.nn.functional as F

    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype="float32")
                                ).cuda().to(torch.bfloat16)

    q, k, v = rnd(S, H, hd), rnd(n_kv, n_ctx, hd), rnd(n_kv, n_ctx, hd)
    sm = hd ** -0.5
    o = attention.flash_attention(q, k, v, pos_offset, sm)
    o_ref = attention.flash_attention_plain(q, k, v, pos_offset, sm)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    if not (torch.isfinite(o).all() and err <= tol):
        raise AssertionError(f"flash S={S} n_ctx={n_ctx} off={pos_offset}: "
                             f"max |kernel-plain| {err} > {tol}")
    key_end = pos_offset + S
    group = H // n_kv
    qh = q.permute(1, 0, 2)[None]                                   # (1, H, S, hd)
    kh = k[:, :key_end].repeat_interleave(group, 0)[None]          # (1, H, c, hd)
    vh = v[:, :key_end].repeat_interleave(group, 0)[None]
    mask = attention.attention_mask(pos_offset + torch.arange(S, device="cuda"),
                                    key_end, 0)
    visible = sum(pos_offset + t + 1 for t in range(S))             # causal keys
    return {
        "S": S, "n_ctx": n_ctx, "pos_offset": pos_offset, "max_abs_err": err,
        "tol": tol,
        "ms": cuda_ms(lambda: attention.flash_attention(q, k, v, pos_offset, sm), 20),
        "plain_ms": cuda_ms(lambda: attention.flash_attention_plain(
            q, k, v, pos_offset, sm), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 20),
        "graph_ms": graph_ms(lambda: attention.flash_attention(q, k, v, pos_offset, sm)),
        "library_graph_ms": graph_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask)),
        **bound(2 * q.numel() * 2 + 2 * n_kv * key_end * hd * 2,
                4.0 * visible * H * hd),
    }


def check_flash_int8(rng, S, n_ctx, pos_offset, H=32, n_kv=8, hd=128, tol=2e-2) -> dict:
    """The int8-ring flash kernel against its plain version; the library
    time is SDPA over the ring dequantized to bf16 beforehand (the
    dequantize is not timed)."""
    import torch
    import torch.nn.functional as F

    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention, kvquant

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype="float32")).cuda()

    q = rnd(S, H, hd).to(torch.bfloat16)
    kq, ks = kvquant.quantize_kv_plain(rnd(n_kv, n_ctx, hd).to(torch.bfloat16))
    vq, vs = kvquant.quantize_kv_plain(rnd(n_kv, n_ctx, hd).to(torch.bfloat16))
    sm = hd ** -0.5
    o = attention.flash_attention_int8(q, kq, vq, ks, vs, pos_offset, sm)
    o_ref = attention.flash_attention_int8_plain(q, kq, vq, ks, vs, pos_offset, sm)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    if not (torch.isfinite(o).all() and err <= tol):
        raise AssertionError(f"flash int8 S={S} n_ctx={n_ctx} off={pos_offset}: "
                             f"max |kernel-plain| {err} > {tol}")
    key_end = pos_offset + S
    group = H // n_kv
    qh = q.permute(1, 0, 2)[None]
    kh = kvquant.dequantize_kv(kq[:, :key_end], ks[:, :key_end]).repeat_interleave(group, 0)[None]
    vh = kvquant.dequantize_kv(vq[:, :key_end], vs[:, :key_end]).repeat_interleave(group, 0)[None]
    mask = attention.attention_mask(pos_offset + torch.arange(S, device="cuda"),
                                    key_end, 0)
    visible = sum(pos_offset + t + 1 for t in range(S))
    return {
        "S": S, "n_ctx": n_ctx, "pos_offset": pos_offset, "max_abs_err": err,
        "tol": tol,
        "ms": cuda_ms(lambda: attention.flash_attention_int8(
            q, kq, vq, ks, vs, pos_offset, sm), 20),
        "plain_ms": cuda_ms(lambda: attention.flash_attention_int8_plain(
            q, kq, vq, ks, vs, pos_offset, sm), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 20),
        "graph_ms": graph_ms(lambda: attention.flash_attention_int8(
            q, kq, vq, ks, vs, pos_offset, sm)),
        "library_graph_ms": graph_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask)),
        # q in, out; int8 K/V and their f32 scales up to the last query
        **bound(2 * q.numel() * 2 + 2 * n_kv * key_end * (hd + 4),
                4.0 * visible * H * hd),
    }


#: (S, pos_offset) of the flash lines: the 256-token prompt slices at 0, 256
#: and 512 (a long prompt's three), the same at 768, and the prefix-reuse
#: follow-up's 86-token suffix at 745
FLASH_SHAPES = ((256, 0), (256, 256), (256, 512), (256, 768), (86, 745))
#: the shapes the served requests give the kernel
FLASH_SERVED = ((256, 0), (256, 256), (256, 512), (86, 745))


def flash_slice(name: str, rows: list) -> dict:
    """A flash kernel's time in the served prompt passes: each served
    shape's kernel ms (eager) times the model's 32 layers, and their sum;
    the same from a CUDA graph."""
    served = [r for r in rows if (r["S"], r["pos_offset"]) in FLASH_SERVED]
    per = {f"S{r['S']}@{r['pos_offset']}": r["ms"] * DEPTH for r in served}
    return {"name": name, "layers": DEPTH, "ms_x_layers": per,
            "total_ms": sum(per.values()),
            "graph_total_ms": sum(r["graph_ms"] * DEPTH for r in served)}


def check_kv_quantize(rng, S, pos_offset, n_kv=8, hd=128, n_ctx=1024,
                      theta=500000.0) -> dict:
    """The int8 KV write kernel against its plain version, bit for bit: one
    layer's un-rotated k and v and the pass's RoPE table at ``pos_offset``
    into that layer's ring.  ``graph_ms`` is the kernel's device time from
    a CUDA graph, ``absorbed_graph_ms`` that of the plain torch it took
    over: the table and k's rotation (``rope_interleaved`` on k, which
    calls ``rope_cos_sin``), 13 launches a layer before the kernel rotated
    k itself."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import rope_interleaved
    from llama_fastapi_k8s_gpu_tpu_torch.ops import kvquant
    from llama_fastapi_k8s_gpu_tpu_torch.ops.rope import rope_cos_sin

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype="float32")
                                ).cuda().to(torch.bfloat16)

    k, v = rnd(S, n_kv, hd), rnd(S, n_kv, hd)
    positions = pos_offset + torch.arange(S, device="cuda")
    cos, sin = rope_cos_sin(positions, hd, theta)
    rings = [torch.zeros(n_kv, n_ctx, hd, dtype=torch.int8, device="cuda") for _ in range(4)]
    scales = [torch.zeros(n_kv, n_ctx, device="cuda") for _ in range(4)]

    def kern():
        kvquant.kv_quantize(k, v, cos, sin, positions, rings[0], rings[1], scales[0],
                            scales[1])

    def plain():
        kvquant.kv_quantize_plain(k, v, cos, sin, positions, rings[2], rings[3], scales[2],
                                  scales[3])

    kern()
    plain()
    torch.cuda.synchronize()
    if not (torch.equal(rings[0], rings[2]) and torch.equal(rings[1], rings[3])
            and torch.equal(scales[0].view(torch.int32), scales[2].view(torch.int32))
            and torch.equal(scales[1].view(torch.int32), scales[3].view(torch.int32))):
        raise AssertionError(f"kv_quantize S={S}: kernel is not bit-identical to plain")
    return {
        "S": S, "n_kv": n_kv, "hd": hd, "pos_offset": pos_offset, "max_abs_err": 0.0,
        "tol": 0.0,
        "ms": cuda_ms(kern, 50),
        # the device time alone: the eager launch is bound by the host
        "graph_ms": graph_ms(kern),
        "absorbed_graph_ms": graph_ms(lambda: rope_interleaved(k, positions, theta)),
        "plain_ms": cuda_ms(plain, 10),
        "library_ms": None,
        # bf16 K and V and the f32 table in; int8 values and f32 scales
        # out; the rotation's 6 operations a K pair, |x|, max, multiply and
        # round per element
        **bound(2 * k.numel() * 2 + 2 * cos.numel() * 4 + 2 * (k.numel() + 4 * S * n_kv),
                3.0 * k.numel() + 4.0 * 2 * k.numel()),
    }


def check_kv_quantize_lanes(rng, B: int, n_kv=8, hd=128, n_ctx=1024, layers=32,
                            layer=5, theta=500000.0) -> dict:
    """Kernel 10 with its lane axis against its plain version, bit for bit:
    one decode token in each of ``B`` lanes written into layer ``layer`` of
    a lane-major cache (``B``, ``layers``, n_kv, n_ctx, hd) at the lanes'
    slots (0, 700, n_ctx-1, ...; at B=8 one lane past the ring, which the
    kernel skips), eager and from a CUDA graph replayed with the slots moved
    between replays.  ``graph_ms`` is the lane launch's device time,
    beside ``stride0_graph_ms`` (the one-ring call: B tokens into one ring,
    ``lane_stride`` 0) and ``per_lane_graph_ms`` (B one-token launches, one
    a lane: what a step without the lane axis would take)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import kvquant
    from llama_fastapi_k8s_gpu_tpu_torch.ops.rope import rope_cos_sin

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype="float32")
                                ).cuda().to(torch.bfloat16)

    slots = [0, 700, n_ctx - 1, 5, n_ctx, 511, 999, 1][:B]
    k, v = rnd(B, n_kv, hd), rnd(B, n_kv, hd)
    positions = torch.tensor(slots, dtype=torch.int64, device="cuda")
    cos, sin = rope_cos_sin(positions.clamp(max=n_ctx - 1), hd, theta)
    q = torch.zeros(2, 2, B, layers, n_kv, n_ctx, hd, dtype=torch.int8, device="cuda")
    s = torch.zeros(2, 2, B, layers, n_kv, n_ctx, device="cuda")
    kern_args = (q[0, 0][:, layer], q[0, 1][:, layer], s[0, 0][:, layer], s[0, 1][:, layer])
    plain_args = (q[1, 0][:, layer], q[1, 1][:, layer], s[1, 0][:, layer], s[1, 1][:, layer])

    def kern():
        kvquant.kv_quantize(k, v, cos, sin, positions, *kern_args)

    def plain():
        kvquant.kv_quantize_lanes_plain(k, v, cos, sin, positions, *plain_args)

    def same() -> bool:
        torch.cuda.synchronize()
        return bool(torch.equal(q[0], q[1]) and torch.equal(s[0].view(torch.int32),
                                                             s[1].view(torch.int32)))

    kern()
    plain()
    eager_exact = same()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        kern()
    positions.copy_(torch.tensor([(x + 37) % n_ctx for x in slots]))
    graph.replay()
    plain()
    graph_exact = same()
    if not (eager_exact and graph_exact):
        raise AssertionError(f"kv_quantize lanes B={B}: kernel is not bit-identical to plain "
                             f"(eager {eager_exact}, graph {graph_exact})")
    one_q = torch.zeros(2, n_kv, n_ctx, hd, dtype=torch.int8, device="cuda")
    one_s = torch.zeros(2, n_kv, n_ctx, device="cuda")
    lane_pos = [positions[b:b + 1] for b in range(B)]

    def stride0():
        kvquant.kv_quantize(k, v, cos, sin, positions.clamp(max=n_ctx - 1), one_q[0], one_q[1],
                            one_s[0], one_s[1])

    def per_lane():
        for b in range(B):
            kvquant.kv_quantize(k[b:b + 1], v[b:b + 1], cos[b:b + 1], sin[b:b + 1], lane_pos[b],
                                *(a[b] for a in kern_args))

    out = {"B": B, "slots": slots, "bit_exact": True, "graph_bit_exact": True,
           "lane_stride": kern_args[2].stride(0), "ms": cuda_ms(kern, 50),
           "graph_ms": graph_ms(kern), "stride0_graph_ms": graph_ms(stride0),
           "per_lane_graph_ms": graph_ms(per_lane), "plain_ms": cuda_ms(plain, 10),
           **bound(2 * k.numel() * 2 + 2 * cos.numel() * 4 + 2 * (k.numel() + 4 * B * n_kv),
                   3.0 * k.numel() + 4.0 * 2 * k.numel())}
    del q, s
    return out


def dequant_input(name: str, rng, n_out: int, k_in: int):
    """The (``n_out``, ``k_in``) block bytes a dequant check decodes: the
    K-quant formats with random headers (:func:`rand_k4_headers`)."""
    if name in ("dequant_q4_k", "dequant_q5_k"):
        return rand_k4_headers(rng, n_out, k_in, 144 if name == "dequant_q4_k" else 176)
    return {"dequant_q6_k": rand_q6k, "dequant_q8_0": rand_q8_0}[name](rng, n_out, k_in)


def check_dequant(name, rng, n_out=128256, k_in=4096, dtype="bfloat16",
                  plain: bool = True) -> dict:
    """A dequant kernel against its plain version, bit for bit, on an
    (``n_out``, ``k_in``) tensor (by default ``token_embd``'s), into bf16
    (``token_embd``, the bf16 load) or f32 (the int8 load); timed eager
    (``ms``) and from a CUDA graph (``graph_ms``, the device time), the
    plain version only with ``plain``."""
    import numpy as np
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import dequant

    kern, plain_fn = getattr(dequant, name), getattr(dequant, name + "_plain")
    dt = getattr(torch, dtype)
    raw = torch.from_numpy(np.ascontiguousarray(dequant_input(name, rng, n_out, k_in))).cuda()
    y = kern(raw, dt)
    y_ref = plain_fn(raw, dt)
    torch.cuda.synchronize()
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    if y.dtype != dt or not torch.equal(y.view(bits), y_ref.view(bits)):
        raise AssertionError(f"{name} ({n_out}x{k_in}, {dtype}): kernel is not "
                             f"bit-identical to plain")
    del y_ref
    out = {
        "shape": [n_out, k_in], "out": dtype, "max_abs_err": 0.0, "tol": 0.0,
        "ms": cuda_ms(lambda: kern(raw, dt), 10),
        "graph_ms": graph_ms(lambda: kern(raw, dt), 10),
        "plain_ms": cuda_ms(lambda: plain_fn(raw, dt), 3) if plain else None,
        "library_ms": None,
        **bound(raw.numel() + y.numel() * y.element_size(), 2.0 * y.numel()),
    }
    del raw, y
    torch.cuda.empty_cache()
    return out


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check_slots(got: dict, want: dict, where, tol: float, codes: bool) -> dict:
    """Ring slots ``where`` (an index into each value leaf) of two caches:
    bf16 values, or int8 values times their scales, within ``tol``
    rel-dev; with ``codes``, an int8 ring's codes also within one of each
    other (otherwise their largest difference is only reported)."""
    if "k" in got:
        out = {"slot_rel": max(_rel(got[n][where], want[n][where]) for n in ("k", "v"))}
        ok = out["slot_rel"] <= tol
    else:
        def deq(c, n):
            return c[n + "_q"][where].float() * c[n + "_s"][where][..., None]

        out = {"slot_rel": max(_rel(deq(got, n), deq(want, n)) for n in ("k", "v")),
               "slot_code_diff": max((got[n][where].int() - want[n][where].int()
                                      ).abs().max().item() for n in ("k_q", "v_q"))}
        ok = out["slot_rel"] <= tol and (not codes or out["slot_code_diff"] <= 1)
    if not ok:
        raise AssertionError(f"ring slots disagree: {out} (tolerance {tol})")
    return out


def loop_bound(weight_bytes: int, weights: int, layers: int, n_kv: int, n_heads: int,
               hd: int, dim: int, keys: int, w_int8: bool, kv_int8: bool) -> dict:
    """:func:`bound` of one launch of the looped kernel over ``layers``
    layers with ``keys`` keys in the ring: the layers' weights, scales and
    norms (``weight_bytes``) and the ring's keys (int8 values and their f32
    scales, or bf16) read once, h in and out; a multiply-add a weight
    (``weights``) and the attention's two products, at the int8 peak for
    int8 weights."""
    ring = 2 * layers * n_kv * keys * (hd * (1 if kv_int8 else 2) + (4 if kv_int8 else 0))
    ops = 2.0 * weights + 4.0 * layers * n_heads * keys * hd
    return bound(weight_bytes + ring + 4 * dim, ops, INT8_OPS if w_int8 else BF16_FLOPS)


def loop_positions(rows: list) -> dict:
    """The ``loop_positions`` line from the looped kernel's rows (one a
    variant, each with its ``positions``: ms and bound at a slot): per
    variant and slot the ms, the bound and its share of the time
    (bound ÷ ms), and the last slot's time over the first's."""
    out = []
    for r in rows:
        slots = [{**p, "share_of_bound": p["bound_ms"] / p["ms"]} for p in r["positions"]]
        out.append({"variant": r["variant"], "layers": r["layers"], "slots": slots,
                    "last_over_first": slots[-1]["ms"] / slots[0]["ms"]})
    return {"variants": out}


def check_decode_loop(w_int8: bool, kv_int8: bool, K: int = 2, pos: int = 700,
                      n_ctx: int = 1024, sweep=LOOP_SLOTS) -> dict:
    """The layer-looped decode kernel against its plain version (the
    per-layer arithmetic) over K full-width Llama-3-8B layers of random
    weights, one decode token at ring slot ``pos`` with slots 0..pos-1
    filled: the output h within LOOP_TOL rel-dev, the slot written at
    ``pos`` as :func:`check_slots`; then the kernel's time and bound at each
    slot of ``sweep`` (``positions``, for :func:`loop_positions`)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.config import LLAMA3_8B
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import init_cache
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import LOOP_LINEARS, synth_params
    from llama_fastapi_k8s_gpu_tpu_torch.ops import decode_loop, kvquant

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=K, vocab_size=256, n_ctx=n_ctx,
                              kv_dtype="int8" if kv_int8 else "bf16")
    fmt = "int8" if w_int8 else "bf16"
    params = synth_params(cfg, fmt, seed=3, device="cuda")
    fmts = dict.fromkeys(LOOP_LINEARS, fmt)
    g = torch.Generator(device="cuda").manual_seed(4)
    cache = init_cache(cfg, torch.device("cuda"))
    shape = (K, cfg.n_kv_heads, pos, cfg.head_dim)
    for n in ("k", "v"):
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        if kv_int8:
            cache[n + "_q"][:, :, :pos], cache[n + "_s"][:, :, :pos] = kvquant.quantize_kv_plain(x)
        else:
            cache[n][:, :, :pos] = x
    h = torch.randn(1, cfg.dim, generator=g, device="cuda").to(torch.bfloat16)
    got_c = {k: v.clone() for k, v in cache.items()}
    want_c = {k: v.clone() for k, v in cache.items()}
    at = torch.tensor([pos], device="cuda")        # the slot, in device memory
    got = decode_loop.decode_loop_step(params, got_c, h, at, 0, cfg, fmts, K)
    want = decode_loop.decode_loop_plain(params, want_c, h, at, 0, cfg, fmts, K)
    torch.cuda.synchronize()
    rel = _rel(got, want)
    if not (torch.isfinite(got).all() and rel <= LOOP_TOL):
        raise AssertionError(f"decode_loop w_int8={w_int8} kv_int8={kv_int8}: h rel-dev "
                             f"{rel} > {LOOP_TOL}")
    slots = check_slots(got_c, want_c, (slice(None), slice(None), pos), LOOP_TOL, codes=True)
    wbytes = sum(b.numel() * b.element_size() for layer in params.layers
                 for b in layer.buffers())
    weights = sum(getattr(layer, n).weight.numel() for layer in params.layers
                  for n in LOOP_LINEARS)

    def bound_at(slot):
        return loop_bound(wbytes, weights, K, cfg.n_kv_heads, cfg.n_heads, cfg.head_dim,
                          cfg.dim, slot + 1, w_int8, kv_int8)

    def at_slot(slot):
        t = torch.tensor([slot], device="cuda")
        return {"pos": slot, "bound_ms": bound_at(slot)["bound_ms"],
                "ms": cuda_ms(lambda: decode_loop.decode_loop_step(params, got_c, h, t, 0, cfg,
                                                                   fmts, K), 20)}

    out = {
        "variant": f"{fmt} weights, {cfg.kv_dtype} ring", "layers": K, "pos": pos,
        "dim": cfg.dim, "ffn": cfg.ffn_dim, "max_abs_err": (got.float() - want.float()).abs().max().item(),
        "h_rel": rel, "tol": LOOP_TOL, **slots,
        "ms": cuda_ms(lambda: decode_loop.decode_loop_step(params, got_c, h, at, 0, cfg, fmts, K), 20),
        # the device time alone: the eager launch also pays the wrapper's
        # host work (the RoPE angles, the checks), which is near the
        # kernel's time at two layers
        "graph_ms": graph_ms(lambda: decode_loop.decode_loop_step(params, got_c, h, at, 0, cfg,
                                                                  fmts, K)),
        "plain_ms": cuda_ms(lambda: decode_loop.decode_loop_plain(params, want_c, h, at, 0, cfg,
                                                                  fmts, K), 5),
        "library_ms": None,
        **bound_at(pos),
        # slots past the filled ones hold zeros: the time does not read them
        "positions": [at_slot(p) for p in sweep],
    }
    del params, cache, got_c, want_c
    return out


def check_int8_linear(n_out: int, k_in: int, B: int, seed: int = 7) -> dict:
    """The int8 linear as the int8 engines serve it (``ops.linear``: the
    per-row activation quantize, ``torch._int_mm`` — rows padded to 17 —
    and the f32 rescale) at one 8B shape: a library call, not a kernel of
    the port, timed beside ``torch._int_mm`` alone and the bf16
    ``torch.matmul`` of the same weights, and checked bit for bit against
    its CPU result (an int32 ``matmul``) at B=1 up to 14336 rows."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops.linear import linear, make_linear_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n_out, k_in, generator=g, device="cuda") * k_in ** -0.5
    x = torch.randn(B, k_in, generator=g, device="cuda").to(torch.bfloat16)
    lin = make_linear_int8(w)
    y = linear(x, lin)
    if B == 1 and n_out <= 14336:
        want = linear(x.cpu(), make_linear_int8(w.cpu()))
        if not torch.equal(y.cpu().view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"int8 linear ({n_out},{k_in}) B={B}: card != CPU")
    wb = w.to(torch.bfloat16)
    xq = torch.zeros(max(B, 17), k_in, dtype=torch.int8, device="cuda")
    out = {"shape": [n_out, k_in], "B": B,
           "ms": cuda_ms(lambda: linear(x, lin), 20),
           "int_mm_ms": cuda_ms(lambda: torch._int_mm(xq, lin.weight.t()), 20),
           "bf16_matmul_ms": cuda_ms(lambda: torch.matmul(x, wb.t()), 20),
           **bound(n_out * k_in + 4 * n_out + 4 * B * (k_in + n_out),
                   2.0 * B * n_out * k_in, INT8_OPS)}
    del w, lin, wb
    return out


#: the (N, K) each fused matmul meets on the 8B serving paths: Q4_K and Q5_K
#: on attn_q/k/output and ffn_gate/up, Q6_K on attn_v, ffn_down and the
#: output head of the K-quant files and on all of them in the Q6_K file,
#: Q8_0 on all of them
_QK = ((4096, 4096), (1024, 4096), (14336, 4096))
_ALL = (*_QK, (4096, 14336), (128256, 4096))
MATMUL_SHAPES = {
    "q4k_matmul": _QK,
    "q5k_matmul": _QK,
    "q6k_matmul": _ALL,
    "q8_matmul": _ALL,
}
#: the B each fused matmul is checked at: a decode token (CUDA cores), the
#: bucket of short prompts and follow-ups and a 256-token prompt slice
#: (tensor cores)
MATMUL_BATCHES = (1, 128, 256)
#: the lane counts the lane engines serve (:data:`LANES`): each fused
#: matmul is held to its plain version at them too — at 8 rows Q4_K and
#: Q5_K take the tensor cores, Q6_K and Q8_0 the multi-row CUDA-core path
LANE_BATCHES = (4, 8)
#: the (N, K) of a layer's seven linears (attn_q, attn_k, attn_v,
#: attn_output, ffn_gate, ffn_up, ffn_down)
LAYER_SHAPES = {"wq": (4096, 4096), "wk": (1024, 4096), "wv": (1024, 4096),
                "wo": (4096, 4096), "w_gate": (14336, 4096), "w_up": (14336, 4096),
                "w_down": (4096, 14336)}


#: the (N, K) of the output head
HEAD_SHAPE = (128256, 4096)


def token_recipe(layout: str) -> dict:
    """The fused matmul calls of one decode token of a ``layout`` file:
    (kernel name, (N, K)) → calls — each layer's seven linears once a layer
    (:data:`LAYER_SHAPES` in :func:`served_formats`), the output head once.
    Q4_K_M: 160 q4k + 65 q6k; Q5_K_M: 160 q5k + 65 q6k; Q8_0: 225 q8;
    Q6_K: 225 q6k."""
    kinds = served_formats(layout)
    recipe: dict = {}
    for key, calls in [*(((kinds[lin] + "_matmul", shape), DEPTH)
                         for lin, shape in LAYER_SHAPES.items()),
                       ((kinds["output"] + "_matmul", HEAD_SHAPE), 1)]:
        recipe[key] = recipe.get(key, 0) + calls
    return recipe


def fused_token(layout: str, rows: dict) -> dict:
    """One decode token's fused linears in a ``layout`` file: Σ calls ×
    the B=1 time of each shape (cold and warm from a CUDA graph, and the
    library's cold time) beside Σ calls × its bound, in all and by kernel.
    ``rows`` maps (kernel name, (N, K)) to that shape's B=1
    :func:`check_matmul` line."""
    recipe = token_recipe(layout)
    keys = ("cold_graph_ms", "graph_ms", "library_cold_graph_ms", "bound_ms")
    by_kernel: dict = {}
    for (name, shape), calls in recipe.items():
        part = by_kernel.setdefault(name, {"calls": 0, **dict.fromkeys(keys, 0.0)})
        part["calls"] += calls
        for k in keys:
            part[k] += calls * rows[(name, shape)][k]
    return {"file": layout, "calls": sum(p["calls"] for p in by_kernel.values()),
            **{k: sum(p[k] for p in by_kernel.values()) for k in keys},
            "by_kernel": by_kernel}


def route_layer(sweeps: list) -> list:
    """Per served file, the ``route_sweep`` times summed over one layer's
    linears in the file's formats, per path and B, in all and by format:
    what each format's threshold rests on."""
    t = {(r["name"], tuple(r["shape"])): r for r in sweeps}
    out = []
    for layout in LAYOUTS:
        kinds = served_formats(layout)
        row = {"file": layout, "B": list(SWEEP_BATCHES), "by_format": {}}
        for path in ("cuda_core", "tc"):
            total = [0.0] * len(SWEEP_BATCHES)
            for lin, shape in LAYER_SHAPES.items():
                name = kinds[lin] + "_matmul"
                part = row["by_format"].setdefault(name, {}).setdefault(
                    path + "_ms", [0.0] * len(SWEEP_BATCHES))
                for i, ms in enumerate(t[(name, shape)][path + "_ms"]):
                    part[i] += ms
                    total[i] += ms
            row[path + "_ms"] = total
        out.append(row)
    return out


def route_threshold(batches, cuda_core_ms, tc_ms):
    """The smallest swept B from which the tensor-core path takes less time
    than the CUDA-core path at that B and at every larger swept B; None
    where it does not win at the largest."""
    found = None
    for B, cc, tc in reversed(list(zip(batches, cuda_core_ms, tc_ms))):
        if not tc < cc:
            break
        found = B
    return found


#: the served file whose layer sets each fused format's threshold: the
#: file that serves it on the most linears
THRESHOLD_FILE = {"q4k_matmul": "q4km", "q5k_matmul": "q5km", "q6k_matmul": "q6_k",
                  "q8_matmul": "q8_0"}


def route_thresholds(layers: list, launcher: dict) -> list:
    """Per fused format, the threshold :func:`route_threshold` reads from
    its share of the :data:`THRESHOLD_FILE` layer (``route_layer`` rows)
    beside the launcher's current one (``launcher``: name → B), and at that
    B its tensor-core time over its CUDA-core time in every file's layer
    that holds it."""
    rows = {r["file"]: r for r in layers}
    out = []
    for name, home in THRESHOLD_FILE.items():
        part = rows[home]["by_format"][name]
        B = route_threshold(rows[home]["B"], part["cuda_core_ms"], part["tc_ms"])
        ratio = {}
        if B is not None:
            for r in layers:
                share = r["by_format"].get(name)
                if share:
                    i = r["B"].index(B)
                    ratio[r["file"]] = share["tc_ms"][i] / share["cuda_core_ms"][i]
        out.append({"name": name, "file": home, "measured": B, "launcher": launcher[name],
                    "tc_over_cuda_core_at_measured": ratio})
    return out


#: the (N, K) the loads hand a dequant: a layer's linears (attn_q/output,
#: attn_k/v, ffn_gate/up, ffn_down) and token_embd / the output head
DEQUANT_SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), HEAD_SHAPE)
#: an odd shape (37 rows of 17 super-blocks: 629) that the dequants are also held to
DEQUANT_ODD = (37, 4352)
#: the dequant kernel of each GGML block type
DEQUANT_OF = {"Q4_K": "dequant_q4_k", "Q5_K": "dequant_q5_k", "Q6_K": "dequant_q6_k",
              "Q8_0": "dequant_q8_0"}
#: the six engines of phase 5: (file, weight format); "auto" serves fused
ENGINES = (*((layout, "auto") for layout in LAYOUTS),
           *((layout, fmt) for _, layout, fmt, *_ in LOOPED))


def dequant_shapes(name: str, rng, head_rows: list) -> dict:
    """The ``dequant_shapes`` line of one dequant: :func:`check_dequant` at
    every shape of :data:`DEQUANT_SHAPES` into bf16 and f32, the plain
    version timed only at the head's shape (``head_rows``, the kernel
    lines) — each with its graph time over its bound."""
    rows = []
    for n, k in DEQUANT_SHAPES:
        for dt in ("bfloat16", "float32"):
            r = (next(r for r in head_rows if r["out"] == dt) if (n, k) == HEAD_SHAPE
                 else check_dequant(name, rng, n, k, dt, plain=False))
            rows.append({key: r[key] for key in ("shape", "out", "ms", "graph_ms", "bound_ms")}
                        | {"over_bound": r["graph_ms"] / r["bound_ms"]})
    return {"name": name, "shapes": rows}


def load_dequants(layout: str, weight_format: str) -> dict:
    """The dequant launches of one load of a ``layout`` file in
    ``weight_format``, from the load plan (models/params.py): token_embd
    into bf16; under ``bf16`` every linear and the output head into bf16,
    under ``int8`` into f32 (the requantize's input); fused linears
    (``auto`` at 8B) launch none.  (kernel, (N, K), out) → launches."""
    types = file_types(layout)
    plan = {(DEQUANT_OF[types["token_embd"]], HEAD_SHAPE, "bfloat16"): 1}
    if weight_format == "auto":
        return plan
    out = {"bf16": "bfloat16", "int8": "float32"}[weight_format]
    for short, long in GGUF_NAMES.items():
        shape, calls = (HEAD_SHAPE, 1) if short == "output" else (LAYER_SHAPES[short], DEPTH)
        key = (DEQUANT_OF[types[long]], shape, out)
        plan[key] = plan.get(key, 0) + calls
    return plan


def dequant_rank(lines: list, launches: dict | None = None) -> dict:
    """The ``dequant_rank`` line: per dequant, Σ launches × (graph time −
    bound) over the six engines' loads, shape by shape (``lines``: the
    ``dequant_shapes`` lines), the launches from :func:`load_dequants`;
    with ``launches`` (the wrappers' counters over phase 5) each kernel's
    planned total must equal its count.  Largest loss first."""
    times = {(ln["name"], tuple(r["shape"]), r["out"]): r for ln in lines
             for r in ln["shapes"]}
    by = {ln["name"]: {"name": ln["name"], "launches": 0, "gap_ms": 0.0, "ms": 0.0,
                       "bound_ms": 0.0, "by_shape": {}} for ln in lines}
    for layout, fmt in ENGINES:
        for (name, shape, out), n in load_dequants(layout, fmt).items():
            r, row = times[(name, shape, out)], by[name]
            row["launches"] += n
            row["gap_ms"] += n * (r["graph_ms"] - r["bound_ms"])
            row["ms"] += n * r["graph_ms"]
            row["bound_ms"] += n * r["bound_ms"]
            key = f"{shape[0]}x{shape[1]} {out}"
            row["by_shape"][key] = row["by_shape"].get(key, 0) + n
    out = {"source": "launches from the load plan (models/params.py)",
           "ranked": sorted(by.values(), key=lambda r: -r["gap_ms"])}
    if launches is not None:
        counted = {n: launches[n] for n in by}
        out["source"] += ", checked against the wrappers' counters over phase 5"
        out["counters"] = counted
        planned = {n: r["launches"] for n, r in by.items()}
        if counted != planned:
            raise AssertionError(f"dequant launches: plan {planned} != counters {counted}")
    return out


def phase_kernels(names) -> tuple[dict, list]:
    """Per kernel in ``names``: the per-shape checks, and their times summed
    over the shapes (each shape one call of the serving path); and the
    dequants' ``dequant_shapes`` lines."""
    import numpy as np
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.ops import _fused

    rng = np.random.default_rng(1)
    shapes = {}
    deq_lines = []
    for name in names:
        if name.startswith("dequant_"):
            shapes[name] = [check_dequant(name, rng, dtype=dt)
                            for dt in ("bfloat16", "float32")]
            deq_lines.append(dequant_shapes(name, rng, shapes[name]))
            say("dequant_shapes", **deq_lines[-1])
            # an odd row count: the last CUDA block's lanes past the end
            for dt in ("bfloat16", "float32"):
                check_dequant(name, rng, *DEQUANT_ODD, dt, plain=False)
            say("dequant_odd", name=name, shape=list(DEQUANT_ODD), bit_exact=True)
        elif name == "decode_loop":
            shapes[name] = [check_decode_loop(w8, kv8) for w8 in (False, True)
                            for kv8 in (False, True)]
            say("loop_positions", **loop_positions(shapes[name]))
            for r in shapes[name]:
                del r["positions"]
        elif name == "flash_attention":
            shapes[name] = [check_flash(rng, S, 1024, off) for S, off in FLASH_SHAPES]
        elif name == "flash_attention_int8":
            shapes[name] = [check_flash_int8(rng, S, 1024, off) for S, off in FLASH_SHAPES]
        elif name == "kv_quantize":
            # a decode token at slot 700, a 256-token prompt slice at 256
            shapes[name] = [check_kv_quantize(rng, 1, 700), check_kv_quantize(rng, 256, 256)]
            for B in (1, 3, 8):          # the lane axis: one token in each of B lanes
                say("kv_quantize_lanes", **check_kv_quantize_lanes(rng, B))
        else:
            shapes[name] = [check_matmul(name, rng, n, k, B) for B in MATMUL_BATCHES
                            for n, k in MATMUL_SHAPES[name]]
            for n, k in MATMUL_SHAPES[name]:
                for row in check_matmul_lanes(name, rng, n, k, LANE_BATCHES):
                    say("lane_matmul", **row)
    sweeps = []
    for name in _fused.TC_KERNELS:
        for n, k in MATMUL_SHAPES[name][:4]:       # the layers' shapes, not the head
            sweeps.append(route_sweep(name, rng, n, k))
            say("route_sweep", **sweeps[-1])
    layers = route_layer(sweeps)
    for row in layers:
        say("route_layer", **row)
    for row in route_thresholds(layers, {n: _fused.tc_min_batch(n) for n in _fused.TC_KERNELS}):
        say("route_threshold", **row)
    for B in (1, 256):
        for n, k in _ALL:
            say("int8_linear", **check_int8_linear(n, k, B))
    torch.cuda.empty_cache()
    b1 = {(name, tuple(r["shape"])): r for name, rows in shapes.items()
          for r in rows if name in _fused.TC_KERNELS and r["B"] == 1}
    for layout in LAYOUTS:
        if all(key in b1 for key in token_recipe(layout)):
            say("fused_token", **fused_token(layout, b1))
    out = {}
    for name, rows in shapes.items():
        for r in rows:
            say("kernel", name=name, **r)
        if name.startswith("flash_attention"):
            say("flash_slice", **flash_slice(name, rows))
        lib = [r["library_ms"] for r in rows]
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            # what bounds most of the summed bound
            "bound_by": "bytes" if 2 * by_bytes >= sum(r["bound_ms"] for r in rows)
            else "operations",
            "library_ms": None if None in lib else sum(lib),
            "shapes": rows,
        }
    return out, deq_lines


# ---------------------------------------------------------------------------
# phase 4: the synthetic Llama-3-8B-width GGUFs
# ---------------------------------------------------------------------------

def phase_gguf(layout: str, depth: int = DEPTH) -> str:
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import LLAMA3_8B

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=depth)
    path = os.path.join(CACHE, f"llama3-8b-width-{layout}-L{depth}-seed0.gguf")
    return cached_gguf(path, lambda p: write_gguf(cfg, p, layout), layers=depth)


def file_types(layout: str) -> dict:
    """GGML type name of each tensor kind in a ``layout`` file: llama.cpp's
    recipe, with the names it mixes per layer (attn_v, ffn_down) kept
    uniform on the finer type."""
    if layout in ("q8_0", "q6_k"):
        return dict.fromkeys(("token_embd", "attn_q", "attn_k", "attn_v",
                              "attn_output", "ffn_gate", "ffn_up", "ffn_down",
                              "output"), layout.upper())
    main = {"q4km": "Q4_K", "q5km": "Q5_K"}[layout]
    return {**dict.fromkeys(("token_embd", "attn_q", "attn_k", "attn_output",
                             "ffn_gate", "ffn_up"), main),
            **dict.fromkeys(("attn_v", "ffn_down", "output"), "Q6_K")}


#: the GGUF tensor kind of each linear (``blk.N.<kind>.weight``; the head's
#: is ``output.weight``)
GGUF_NAMES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
              "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down",
              "output": "output"}


def served_formats(layout: str) -> dict:
    """The Linear kinds a ``layout`` file must serve with: every linear fused;
    the mixed file's every linear bf16 (its names mix types)."""
    if layout == "mixed":
        return dict.fromkeys(GGUF_NAMES, "bf16")
    kinds = {"Q4_K": "q4k", "Q5_K": "q5k", "Q6_K": "q6k", "Q8_0": "q8"}
    t = file_types(layout)
    return {short: kinds[t[long]] for short, long in GGUF_NAMES.items()}


def bpe_metadata(cfg) -> dict:
    """The tokenizer metadata of the Llama-3-width files: a byte-level
    vocabulary (GPT-2 byte table), padded with inert tokens to Llama-3's
    128256, then its control tokens, and the Llama-3 chat template."""
    from llama_fastapi_k8s_gpu_tpu_torch.tokenizer.bpe import bytes_to_unicode

    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>"]
    n_pad = cfg.vocab_size - 256 - len(specials)
    tokens = ([bytes_to_unicode()[b] for b in range(256)]
              + [f"<pad{i}>" for i in range(n_pad)] + specials)
    return {
        "tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "llama-bpe",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": [1] * (256 + n_pad) + [3] * len(specials),
        "tokenizer.ggml.merges": [],
        "tokenizer.ggml.bos_token_id": tokens.index("<|begin_of_text|>"),
        "tokenizer.ggml.eos_token_id": tokens.index("<|eot_id|>"),
        "tokenizer.chat_template": (
            "{{bos_token}}{% for m in messages %}<|start_header_id|>{{m['role']}}"
            "<|end_header_id|>\n\n{{m['content']}}<|eot_id|>{% endfor %}"),
    }


def write_gguf(cfg, path: str, layout: str, seed: int = 0, tokenizer: dict | None = None,
               type_of=None, name: str | None = None) -> None:
    """A Llama GGUF of ``cfg``'s shapes with random valid blocks from
    ``seed`` in ``layout``'s tensor types (or ``type_of(kind, layer)``'s,
    ``layer`` None for token_embd and output) and the ``tokenizer``
    metadata (default :func:`bpe_metadata`), named ``name``; ``cfg.sliding_window``, when
    set, goes under ``llama.attention.sliding_window``, as llama.cpp writes
    Mistral files."""
    import numpy as np

    from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, GGUFWriter

    rng = np.random.default_rng(seed)
    w = GGUFWriter(path + f".tmp{os.getpid()}")
    md = {
        "general.architecture": "llama",
        "general.name": name or f"llama3-8b-width-synthetic-{layout}",
        "llama.block_count": cfg.n_layers, "llama.context_length": 8192,
        "llama.embedding_length": cfg.dim, "llama.feed_forward_length": cfg.ffn_dim,
        "llama.attention.head_count": cfg.n_heads,
        "llama.attention.head_count_kv": cfg.n_kv_heads,
        "llama.attention.layer_norm_rms_epsilon": cfg.rms_eps,
        "llama.rope.freq_base": cfg.rope_theta, "llama.vocab_size": cfg.vocab_size,
        **({"llama.attention.sliding_window": cfg.sliding_window}
           if cfg.sliding_window else {}),
        **(tokenizer or bpe_metadata(cfg)),
    }
    for k, v in md.items():
        w.add_metadata(k, v)

    if type_of is None:
        types = file_types(layout)

        def type_of(kind, layer):
            return types[kind]

    def raw(name, n_out, k_in):
        parts = name.split(".")
        kind = type_of(parts[-2], int(parts[1]) if parts[0] == "blk" else None)
        blocks = RAND[kind](rng, n_out, k_in)
        w.add_raw_tensor(name, (k_in, n_out), GGMLType[kind], blocks.reshape(-1))

    def ones(name):
        w.add_tensor(name, np.ones(cfg.dim, np.float32), GGMLType.F32)

    kv_dim = cfg.n_kv_heads * cfg.head_dim
    raw("token_embd.weight", cfg.vocab_size, cfg.dim)
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        ones(p + "attn_norm.weight")
        raw(p + "attn_q.weight", cfg.dim, cfg.dim)
        raw(p + "attn_k.weight", kv_dim, cfg.dim)
        raw(p + "attn_v.weight", kv_dim, cfg.dim)
        raw(p + "attn_output.weight", cfg.dim, cfg.dim)
        ones(p + "ffn_norm.weight")
        raw(p + "ffn_gate.weight", cfg.ffn_dim, cfg.dim)
        raw(p + "ffn_up.weight", cfg.ffn_dim, cfg.dim)
        raw(p + "ffn_down.weight", cfg.dim, cfg.ffn_dim)
    ones("output_norm.weight")
    raw("output.weight", cfg.vocab_size, cfg.dim)
    w.write()
    os.replace(w.path, path)


# ---------------------------------------------------------------------------
# phase 4 (cont.): the Mistral-7B file and the mixed-type file
# ---------------------------------------------------------------------------

#: the Mistral engines over the Mistral-7B file: (label, weight format, KV
#: dtype, decode_layer_unroll, expected effective unroll) — the fused path
#: over the bf16 ring, and int8 weights with one looped launch a token over
#: the int8 ring
#: the Mistral file's depth: 12 of the model's 32 layers, so that the mesh
#: phase fits the run's time (the window, the ring and the kernels' shapes
#: are the full model's; at 12 layers ``auto`` still serves it fused: 5.8 GB
#: of bf16 linears against its 4 GB line; at 8 it would not)
MISTRAL_DEPTH = 12
MISTRAL = (("mistral_q4km", "auto", "bf16", 0, 0),
           ("mistral_int8_loop", "int8", "int8", -1, MISTRAL_DEPTH))
#: the Mistral engines' context: twice the window, so the window bites
MISTRAL_N_CTX = 8192
#: depth of the mixed-type file (the host codec is slow: a 32-layer Q3_K
#: file would spend minutes on the host); width is not cut
MIXED_DEPTH = 4
#: the types the mixed file spreads over token_embd, output and its
#: linears: F16, and every type the reference decodes without a kernel
MIXED_TYPES = ("F16", "BF16", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "IQ4_NL",
               "IQ4_XS")
#: the mixed file's ffn_down (K = 14336) by layer
MIXED_FFN_DOWN = ("Q2_K", "Q3_K", "IQ4_XS", "Q4_0")


def mistral_config():
    """Mistral-7B-v0.1's published config (vocab 32000, dim 4096, 32/8
    heads of 128, ffn 14336, rope_theta 10000, rms_eps 1e-5,
    sliding_window 4096) at :data:`MISTRAL_DEPTH` of its 32 layers, served
    at :data:`MISTRAL_N_CTX`."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import MISTRAL_7B

    return dataclasses.replace(MISTRAL_7B, n_layers=MISTRAL_DEPTH, rope_theta=10000.0,
                               rms_eps=1e-5, sliding_window=4096, n_ctx=MISTRAL_N_CTX)


#: text outside ASCII in the Mistral prompts: it takes the byte fallback
NON_ASCII = "ça va? naïve café, Straße — 東京 🙂"
MISTRAL_SHORT = [("user", "hi"), ("assistant", "hey"),
                 ("user", "how are you? " + NON_ASCII)]
MISTRAL_FOLLOW_UP = "and what happened next?"
MISTRAL_SYSTEM = [{"role": "system", "content": "You are terse and kind."},
                  {"role": "user", "content": "Tell me about the river and the boats."}]
#: the long prompt's words (a story's vocabulary)
STORY_WORDS = (
    "the a an and but so then while because after before when where with without "
    "river boats morning evening summer winter trip plan planned walked walking watched "
    "watching thought thinking remembered friend friends family sister brother mother "
    "father village town city market bridge harbour lighthouse keeper light storm rain "
    "sun wind sea shore sand stones path forest trees birds songs music dinner bread "
    "coffee tea letter letters book story stories old new long short quiet loud happy "
    "tired warm cold bright dark early late slowly quickly together alone again never "
    "always often sometimes every day night week year we I they she he it our their "
    "was were had have said told asked answered laughed smiled waited found lost kept "
    "carried opened closed left stayed came went took gave made saw heard knew felt "
    "small big great little first last next other same different through over under "
    "along across near far home house door window garden road car train ship sail").split()


def mistral_long_context(turns: int = 62, seed: int = 3) -> list:
    """A conversation of ``turns`` messages of up to ~390 characters each
    (the app clips a message at 400), seeded sentences of
    :data:`STORY_WORDS`, with :data:`NON_ASCII` in every eighth: about
    4,600 prompt tokens behind the reference's persona prompt."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ctx = [("user", "hello, I have a long story to tell you.")]
    for i in range(1, turns):
        words = []
        while len(" ".join(words)) < 360:
            sentence = [STORY_WORDS[int(j)] for j in
                        rng.integers(0, len(STORY_WORDS), int(rng.integers(6, 14)))]
            sentence[0] = sentence[0].capitalize()
            words += sentence[:-1] + [sentence[-1] + (", " if rng.random() < 0.2 else ".")]
        text = " ".join(words).replace(",  ", ", ")[:390].rsplit(" ", 1)[0] + "."
        if i % 8 == 3:
            text = text[:350].rsplit(" ", 1)[0] + " " + NON_ASCII
        ctx.append(("user" if i % 2 == 0 else "assistant", text))
    return ctx


def mistral_texts() -> list:
    """Every text the Mistral engines are sent: the reference's persona
    prompt, the requests' turns, the /v1 and warm-up messages."""
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import build_system_prompt
    from llama_fastapi_k8s_gpu_tpu_torch.server.schemas import BotProfile

    texts = [build_system_prompt(BotProfile(**BOT)), MISTRAL_FOLLOW_UP,
             "hi hi hi hi hi hi hi hi", "fine"]
    texts += [m for _, m in MISTRAL_SHORT + mistral_long_context()]
    texts += [m["content"] for m in MISTRAL_SYSTEM + V1_MESSAGES + UNRELATED]
    return texts


def spm_metadata(texts: list, size: int = 32000, seed: int = 0) -> dict:
    """A ``size``-piece SentencePiece vocabulary for ``texts`` and its
    tokenizer metadata: ``<unk>``, ``<s>``, ``</s>``, the 256 ``<0xXX>``
    byte pieces, every printable ASCII character, then for ``[INST]``,
    ``[/INST]`` and every ASCII word of ``texts`` ``▁word`` and its prefixes (score = length, so a
    word's prefix chain outranks every shorter merge and the word comes out
    whole) and its bare prefixes (after punctuation), every lower-case
    letter pair, and seeded letter runs at negative scores up to ``size``;
    characters outside ASCII have no piece and take the byte fallback.
    With the ``[INST]`` chat template."""
    import numpy as np

    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    scores = [0.0] * len(pieces)
    seen = set(pieces)

    def add(piece: str, score: float) -> None:
        if piece not in seen and len(pieces) < size:
            seen.add(piece)
            pieces.append(piece)
            types.append(1)
            scores.append(float(score))

    add("▁", -1.0)
    for c in range(0x21, 0x7F):
        add(chr(c), -2.0)
    words = sorted({w for t in texts for w in re.findall(r"[A-Za-z0-9']+", t)})
    for w in ("[INST]", "[/INST]", *words):
        for i in range(1, len(w) + 1):
            add("▁" + w[:i], i + 1)
        for i in range(2, len(w) + 1):
            add(w[:i], i)
    letters = "abcdefghijklmnopqrstuvwxyz"
    for a in letters:
        for b in letters:
            add(a + b, 2)
    rng = np.random.default_rng(seed)
    while len(pieces) < size:
        run = "".join(letters[int(j)] for j in rng.integers(0, 26, int(rng.integers(3, 9))))
        add(("▁" if rng.random() < 0.5 else "") + run, -5.0 - 10.0 * rng.random())
    return {
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": pieces,
        "tokenizer.ggml.token_type": types, "tokenizer.ggml.scores": scores,
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.chat_template": (
            "{{bos_token}}{% for m in messages %}{% if m['role'] == 'user' %}"
            "[INST] {{m['content']}} [/INST]{% else %}{{m['content']}}</s>"
            "{% endif %}{% endfor %}"),
    }


def mixed_type_of(kind: str, layer: int | None) -> str:
    """The mixed file's type of each weight: token_embd BF16 (its raw
    view), output F16, ffn_down by :data:`MIXED_FFN_DOWN`, the other 24
    linears through :data:`MIXED_TYPES` in turn — every type on at least
    two tensors, every name mixing types across its layers."""
    if layer is None:
        return {"token_embd": "BF16", "output": "F16"}[kind]
    if kind == "ffn_down":
        return MIXED_FFN_DOWN[layer]
    order = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up")
    return MIXED_TYPES[(layer * len(order) + order.index(kind) + 3) % len(MIXED_TYPES)]


def cached_gguf(path: str, write, **info) -> str:
    """``path``, written by ``write(path)`` unless present; a ``gguf``
    line either way."""
    os.makedirs(CACHE, exist_ok=True)
    free_gb = round(shutil.disk_usage(CACHE).free / 1e9, 1)
    if os.path.exists(path):
        say("gguf", path=path, reused=True, bytes=os.path.getsize(path),
            disk_free_gb=free_gb)
        return path
    t0 = time.time()
    write(path)
    say("gguf", path=path, reused=False, **info, bytes=os.path.getsize(path),
        seconds=round(time.time() - t0, 1), disk_free_gb=free_gb)
    return path


#: processes writing the synthetic GGUFs at once (numpy on the host, one
#: core each; a writer holds its file in memory: 21 GB for the largest three)
GGUF_WORKERS = 3


def start_ggufs() -> dict:
    """Every synthetic GGUF of the run (the four layouts, the Mistral file,
    the mixed file), written by :data:`GGUF_WORKERS` spawned processes while
    the caller goes on; returns {key: future of the path}.  The files are
    the ones the sequential writers make (seeded), ``gguf`` lines each."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=GGUF_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    jobs = {layout: pool.submit(phase_gguf, layout) for layout in LAYOUTS}
    jobs["mistral"] = pool.submit(phase_gguf_mistral)
    jobs["mixed"] = pool.submit(phase_gguf_mixed)
    pool.shutdown(wait=False)
    return jobs


def phase_gguf_mistral() -> str:
    """The synthetic Mistral-7B file: Q4_K_M's tensor types, the SPM
    vocabulary of :func:`spm_metadata`, the window under
    ``llama.attention.sliding_window``, architecture ``llama``."""
    cfg = mistral_config()
    path = os.path.join(CACHE, f"mistral-7b-width-q4km-L{cfg.n_layers}-seed0.gguf")
    return cached_gguf(path, lambda p: write_gguf(
        cfg, p, "q4km", tokenizer=spm_metadata(mistral_texts()),
        name="mistral-7b-width-synthetic-q4km"), layers=cfg.n_layers)


def phase_gguf_mixed() -> str:
    """The mixed-type file: Llama-3-8B width, :data:`MIXED_DEPTH` layers,
    the byte-level vocabulary, types by :func:`mixed_type_of`."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import LLAMA3_8B

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=MIXED_DEPTH)
    path = os.path.join(CACHE, f"llama3-8b-width-mixed-L{MIXED_DEPTH}-seed0.gguf")
    return cached_gguf(path, lambda p: write_gguf(
        cfg, p, "mixed", type_of=mixed_type_of), layers=MIXED_DEPTH)


@contextlib.contextmanager
def timed_load(sink: dict):
    """Inside the block, each GGUF tensor's host-codec seconds
    (``quants.dequantize``) and its whole expansion onto the card
    (``params._expand``: the codec, the upload, the conversion) summed by
    GGML type into ``sink``."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, quants
    from llama_fastapi_k8s_gpu_tpu_torch.models import params as pm

    deq, expand = quants.dequantize, pm._expand

    def row(gtype):
        return sink.setdefault(GGMLType(gtype).name, {"tensors": 0, "bytes": 0,
                                                      "codec_s": 0.0, "expand_s": 0.0})

    def timed_deq(buf, gtype, n):
        t0 = time.perf_counter()
        out = deq(buf, gtype, n)
        row(gtype)["codec_s"] += time.perf_counter() - t0
        return out

    def timed_expand(t, device, dtype):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = expand(t, device, dtype)
        torch.cuda.synchronize()
        r = row(t.ggml_type)
        r["expand_s"] += time.perf_counter() - t0
        r["tensors"] += 1
        r["bytes"] += t.nbytes
        return out

    quants.dequantize, pm._expand = timed_deq, timed_expand
    try:
        yield sink
    finally:
        quants.dequantize, pm._expand = deq, expand


def load_types(label: str, sink: dict, load_s: float) -> dict:
    """The ``load_types`` line: per GGML type of the expanded weights, its
    tensors and bytes, the host codec's seconds, the rest of the expansion
    (upload and conversion on the card) and the codec's rate; beside the
    engine's load seconds."""
    rows = {}
    for name, r in sorted(sink.items()):
        if not r["tensors"]:
            continue                       # the norms: F32, read, not expanded
        rows[name] = {**r, "upload_s": r["expand_s"] - r["codec_s"],
                      "codec_mb_per_s": r["bytes"] / r["codec_s"] / 1e6 if r["codec_s"]
                      else None}
    out = {"file": label, "engine_load_s": load_s, "types": rows}
    say("load_types", **out)
    return out


def check_planes(label: str, eng, path: str) -> None:
    """For one tensor of each type of the mixed file, the plane expanded on
    the card (``params._expand``, bf16 and f32) against the port codec's
    numpy output (cast to bf16 for the bf16 plane), bit for bit — and, on a
    bf16 engine, the served weight against the same plane.  A ``planes``
    line; any difference fails the run."""
    import numpy as np
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import _expand

    gf = GGUFFile(path)
    out = {}
    for gtype in MIXED_TYPES:
        name = next(n for n, t in gf.tensors.items()
                    if t.ggml_type.name == gtype and n.startswith("blk."))
        t = gf[name]
        # the codec's output as the load takes it: f32 (Q3_K's arithmetic
        # runs in f64, as the reference's does)
        host = torch.from_numpy(np.asarray(t.astype_f32(), np.float32))
        bf = _expand(t, eng.device, torch.bfloat16)
        f32 = _expand(t, eng.device, torch.float32)
        row = {"tensor": name, "shape": list(bf.shape),
               "bf16_bit_exact": torch.equal(bf.cpu().view(torch.int16),
                                             host.to(torch.bfloat16).view(torch.int16)),
               "f32_bit_exact": torch.equal(f32.cpu().view(torch.int32),
                                            host.view(torch.int32))}
        parts = name.split(".")
        short = {v: k for k, v in GGUF_NAMES.items()}[parts[2]]
        served = getattr(eng.params.layers[int(parts[1])], short)
        if served.kind == "bf16":
            row["served_bit_exact"] = torch.equal(served.weight.view(torch.int16), bf.view(torch.int16))
        out[gtype] = row
        del bf, f32
    say("planes", file=label, **out)
    bad = {k: r for k, r in out.items() if not all(v for key, v in r.items()
                                                     if key.endswith("bit_exact"))}
    if bad:
        raise AssertionError(f"{label}: expanded planes differ from the codec: {bad}")


# ---------------------------------------------------------------------------
# phase 5: serve it
# ---------------------------------------------------------------------------

BOT = {"name": "Alice.f", "appearance": "tall,slim,blonde,loves cats,hates rain"}
#: the served requests' contexts: a short one (460 prompt tokens with the
#: system prompt) and a long one (745) that opens differently, so it shares
#: no reusable prefix with the short one and prefills from slot 0 in slices
SHORT_CTX = [("user", "hi"), ("assistant", "hey"), ("user", "how are you?")]
STORY = ("I spent the morning walking by the river, watching the boats "
         "and thinking about the trip we planned last summer. ")
LONG_CTX = [("user", "hello, I have a long story to tell you."),
            *(turn for i in range(2) for turn in (("assistant", f"tell me more, part {i}."),
                                                  ("user", STORY[:100])))]


def body(context: list[tuple[str, str]]) -> dict:
    return {"bot_profile": BOT, "user_profile": {"name": "Bob"},
            "context": [{"turn": t, "message": m} for t, m in context]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, path: str, payload=None, timeout=300, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if payload is None else json.dumps(payload)
        conn.request(method, path, body=data,
                     headers={"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _request(port: int, method: str, path: str, payload=None, timeout=300, headers=None):
    """(status, lower-cased headers, body bytes) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if payload is None else json.dumps(payload)
        conn.request(method, path, body=data,
                     headers={"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _sse(port: int, path: str, payload, timeout=300, headers=None) -> dict:
    """One streamed request: its status, headers, the ``data:`` payloads
    (JSON decoded, ``[DONE]`` kept) and the seconds from sending it to the
    first event and to the first content delta."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.time()
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        events, first_s, content_s = [], None, None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):].decode()
            ev = data if data == "[DONE]" else json.loads(data)
            if first_s is None:
                first_s = time.time() - t0
            if content_s is None and isinstance(ev, dict) and any(
                    c.get("delta", {}).get("content") for c in ev.get("choices", [])):
                content_s = time.time() - t0
            events.append(ev)
        return {"status": resp.status, "headers": {k.lower(): v for k, v in resp.getheaders()},
                "events": events, "first_event_s": first_s, "first_content_s": content_s}
    finally:
        conn.close()


def sse_text(events: list) -> tuple[str, str | None]:
    """(the deltas joined, the last finish_reason) of a chunk stream."""
    text, finish = "", None
    for ev in events:
        for c in (ev.get("choices") or []) if isinstance(ev, dict) else []:
            text += c.get("delta", {}).get("content", "")
            finish = c.get("finish_reason") or finish
    return text, finish


def prom_samples(text: str, family: str) -> dict:
    """{labels: value} of one Prometheus family's samples."""
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{") or line.startswith(family + " "):
            series, _, value = line.rpartition(" ")
            pairs = re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', series[len(family):])
            out[tuple(pairs)] = float(value)
    return out


def labelled(samples: dict) -> dict:
    """:func:`prom_samples`' keys as ``k=v,...`` strings (a JSON line's)."""
    return {",".join(f"{k}={v}" for k, v in key): n for key, n in samples.items()}


def spans_within(span: dict, parent: dict | None = None) -> list:
    """Names of the spans that end after their parent (or start before it;
    the httpd read window precedes the app by design)."""
    bad = []
    if parent is not None:
        late = span["end"] is None or span["end"] > parent["end"]
        early = span["name"] != "httpd.read" and span["start"] < parent["start"]
        if late or early:
            bad.append(span["name"])
    for c in span["children"]:
        bad += spans_within(c, span)
    return bad


@contextlib.contextmanager
def serving(app, port: int | None = None):
    """The in-tree httpd serving ``app`` on its own event loop in a thread,
    at 127.0.0.1 (``port``, else a free one); yields (port, the thread)."""
    import asyncio

    from llama_fastapi_k8s_gpu_tpu_torch.server import httpd

    port = port or _free_port()
    loop = asyncio.new_event_loop()
    up, stop = asyncio.Event(), asyncio.Event()
    th = threading.Thread(target=loop.run_until_complete, daemon=True,
                          args=(httpd.serve(app, "127.0.0.1", port, up, stop),))
    th.start()
    t_up = time.time()
    while not up.is_set():
        if not th.is_alive() or time.time() - t_up > 120:
            raise RuntimeError("httpd did not come up")
        time.sleep(0.05)
    try:
        yield port, th
    finally:
        loop.call_soon_threadsafe(stop.set)
        th.join(120)
        loop.close()


#: every finished request's prompt and generated ids, by engine (in order)
REPLIES: list = []
#: each served engine's reply text by (label, request): the image phase's
#: pod must give the ``q4km`` engine's short reply byte for byte
SERVED: dict = {}


def record_replies(eng, ordinal: int, sink: list = REPLIES) -> None:
    """Wrap ``eng``'s per-request bookkeeping and its completion call: each
    finished request appends its engine's ``ordinal``, prompt ids,
    generated ids and ``finish_reason`` to ``sink``."""
    finish, complete = eng._finish, eng.create_chat_completion

    def finished(ctx):
        sink.append({"engine": ordinal, "prompt": list(ctx["prompt_ids"]),
                     "ids": list(ctx["ids"])})
        return finish(ctx)

    def completion(*args, **kw):
        out = complete(*args, **kw)
        if isinstance(out, dict):
            sink[-1]["finish_reason"] = out["choices"][0]["finish_reason"]
        return out

    eng._finish, eng.create_chat_completion = finished, completion


def reply_key(rec: dict, earlier: list) -> tuple:
    """(engine, prompt digest, occurrence): a request's key across runs."""
    digest = hashlib.sha256(json.dumps(rec["prompt"]).encode()).hexdigest()[:16]
    seen = sum(1 for r in earlier if r["engine"] == rec["engine"]
               and r["prompt"] == rec["prompt"])
    return rec["engine"], digest, seen


def reply_changes(now: list, before: list) -> list:
    """Per request of ``now`` whose key ``before`` has with other ids: the
    record, the first differing index and the two tokens there."""
    old = {reply_key(r, before[:i]): r for i, r in enumerate(before)}
    out = []
    for i, rec in enumerate(now):
        prev = old.get(reply_key(rec, now[:i]))
        if prev is None or prev["ids"] == rec["ids"]:
            continue
        n = min(len(prev["ids"]), len(rec["ids"]))
        at = next((j for j in range(n) if prev["ids"][j] != rec["ids"][j]), n)
        out.append({"rec": rec, "first_diff": at,
                    "before": prev["ids"][at] if at < len(prev["ids"]) else None,
                    "now": rec["ids"][at] if at < len(rec["ids"]) else None})
    return out


def top2_margin(eng, prompt: list, ids: list, at: int, sp) -> dict:
    """The top-2 margin of the served sampling chain's penalized logits at
    reply token ``at``: one prompt pass over the prompt and the reply's
    first ``at`` tokens on a scratch ring.  The reply's own steps were
    decode steps, so this re-reads the chain's logits with other
    arithmetic: on the H100 the two margins differed by up to two bf16
    steps, with the two tokens ranked the other way round
    (:func:`chain_margin` reads the chain itself)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import prefill
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import (
        apply_penalties,
        sampling_tensors,
        seed_window,
    )

    seq = prompt + ids[:at]
    ring = {k: torch.zeros_like(v) for k, v in eng._cache.items()}
    logits = prefill(eng.params, eng.cfg, torch.tensor(seq, device=eng.device), len(seq), ring)
    window, _ = seed_window(seq, eng.device)
    pen = apply_penalties(logits.float(), window, sampling_tensors(sp, eng.device))
    top = torch.topk(pen, 2)
    return {"top2": top.indices.tolist(), "top": top.values[0].item(),
            "margin": (top.values[0] - top.values[1]).item(),
            "margin_rel": ((top.values[0] - top.values[1]) / pen.abs().max()).item()}


def chain_margin(serial, prompt: list, ids: list, at: int, sp) -> dict:
    """The top-2 margin of the serial engine's own chain at reply token
    ``at`` (``ids`` is that engine's greedy reply to ``prompt``): the
    engine serves the first ``at`` tokens again (its ring then holds the
    prompt and ``ids[:at-1]`` as its decode steps wrote them), then one
    eager decode step feeds ``ids[at-1]`` — the step a replay runs, bit for
    bit — and the sampling chain's penalties are applied to its logits.
    ``serial`` must reuse no prefix (``prefix_cache=False``, not paged).
    For ``at == 0`` the chain's logits are its prompt pass's
    (:func:`top2_margin`).  Also gives :func:`top2_margin`'s reading
    (``prompt_pass_margin``), which re-reads the chain by a prompt pass."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import (
        apply_penalties,
        sampling_tensors,
        seed_window,
    )

    approx = top2_margin(serial, prompt, ids, at, sp)
    if at == 0:
        return {**approx, "read": "prompt_pass", "prompt_pass_margin": approx["margin"]}
    if serial._prefix_cache or getattr(serial, "_kv_paged", False):
        raise ValueError("chain_margin needs an engine that reuses no prefix")
    again = serial_reply(serial, prompt, at, sp)
    if again != ids[:at]:
        raise AssertionError(f"the serial engine's reply is not reproducible: {again} "
                             f"against {ids[:at]}")
    n = len(prompt)
    with serial._lock, torch.inference_mode():
        logits = forward(serial.params, serial.cfg,
                         torch.tensor(ids[at - 1:at], device=serial.device),
                         torch.tensor(n + at - 1, device=serial.device), serial._cache)
        window, _ = seed_window(prompt + ids[:at], serial.device)
        pen = apply_penalties(logits.float(), window, sampling_tensors(sp, serial.device))
        top = torch.topk(pen, 2)
    return {"top2": top.indices.tolist(), "top": top.values[0].item(),
            "margin": (top.values[0] - top.values[1]).item(),
            "margin_rel": ((top.values[0] - top.values[1]) / pen.abs().max()).item(),
            "read": "chain", "prompt_pass_margin": approx["margin"]}


def check_graph(label: str, eng, ids: list, steps: int = 64, restore: bool = False) -> dict:
    """Decode by graph replay against the eager step: prefill ``ids`` into
    the engine's ring, clone it, then ``steps`` greedy tokens by replays of
    the engine's captured step (chunks of the engine's size) and by the
    eager step on the clone, from the same first sample.  Tokens and every
    cache leaf must be bit-identical; reports the first differing token and
    ring slot, the capture times, the keys held and replays per token.
    With ``restore`` (a paged engine) the ring's prefix comes from the
    pool instead: the longest cached whole-page prefix of ``ids`` copied
    into the captured ring in place, then the suffix prefilled behind it
    (line ``restored_graph``)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import (
        decode_step,
        first_sample,
        generate_chunk,
        init_state,
        prefill,
    )
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams, sampling_tensors

    graphs = eng._graphs
    sp = SamplingParams(temperature=0.0)
    reused = 0
    with eng._lock, torch.inference_mode():
        cache = eng._cache
        if restore:
            reused, logits = restore_prefill(eng, ids)
        else:
            logits = prefill(eng.params, eng.cfg, torch.tensor(ids, device=eng.device),
                             len(ids), cache)
        ring = {k: v.clone() for k, v in cache.items()}
        st = graphs.knobs(sampling_tensors(sp, eng.device))
        state = graphs.state(ids, 0)
        replays = graphs.replays
        got = [int(first_sample(logits, state, st))]
        while len(got) <= steps:
            got += generate_chunk(eng.params, eng.cfg, state, st,
                                  min(eng.decode_chunk, steps + 1 - len(got))).tolist()
        replays = graphs.replays - replays
        eager = init_state(ring, ids, 0, eng.device)
        est = sampling_tensors(sp, eng.device)
        want = [int(first_sample(logits, eager, est))]
        want += [int(decode_step(eng.params, eng.cfg, eager, est)) for _ in range(steps)]
        eng._prefix_ids = []            # the ring holds this check's slots now
        torch.cuda.synchronize()
        diff_tok = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        diff_slot = {}
        for name, leaf in cache.items():
            ne = (leaf != ring[name]).reshape(leaf.shape[0], leaf.shape[1], leaf.shape[2], -1)
            bad = ne.any(-1).nonzero()
            if len(bad):
                layer, head, slot = bad[0].tolist()
                diff_slot[name] = {"layer": layer, "head": head, "slot": slot}
    out = {"file": label, "capture_s": graphs.captures, "keys": graphs.keys,
           **({"restored_tokens": reused} if restore else {}),
           "steps": steps, "positions": [len(ids), len(ids) + steps - 1],
           "replays_per_token": replays / steps,
           "tokens_identical": diff_tok is None and len(got) == len(want),
           "first_token_diff": diff_tok, "cache_identical": not diff_slot,
           "first_cache_diff": diff_slot or None}
    say("restored_graph" if restore else "graph", **out)
    if not (out["tokens_identical"] and out["cache_identical"]) or (restore and not reused):
        raise AssertionError(f"{label}: graph replay is not bit-identical to the eager step "
                             f"(or nothing was restored): {out}")
    return out


def restore_prefill(eng, ids: list) -> tuple:
    """The paged engine's reuse by hand: the longest cached whole-page
    prefix of ``ids`` (one token left to prefill) restored from its pool
    into its ring in place, the suffix prefilled behind it.  Returns
    (restored tokens, the last token's logits)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import prefill_chunk

    pool = eng._kvpool
    T = pool.page_tokens
    r = (min(pool.match_len(ids), len(ids) - 1) // T) * T
    lease = pool.acquire(ids, r) if r else None
    if lease is None:
        raise AssertionError(f"the pool holds no whole page of these {len(ids)} ids")
    try:
        pool.restore(lease, eng._cache)
    finally:
        pool.release(lease)
    suffix = torch.tensor(ids[r:], device=eng.device)
    return r, prefill_chunk(eng.params, eng.cfg, suffix, r, len(ids) - r - 1, eng._cache)


#: kernel-name fragments (lower case) of each part of a decode token; the
#: rest ("other"): norms, RoPE, the residual adds, the embedding gather,
#: the penalties, index and copy kernels
KERNEL_PARTS = (
    ("fused_linears", ("qgemv_kernel", "qmma_kernel")),
    ("looped_layers", ("decode_loop_kernel",)),
    ("kv_write", ("kv_quantize_kernel",)),
    ("cublas", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitkreduce", "cublas")),
    ("softmax", ("softmax",)),
    ("sort", ("sort", "radix")),
)


def kernel_part(name: str) -> str:
    """The part of a decode token a CUDA kernel's name places it in
    (:data:`KERNEL_PARTS`), else ``other``."""
    low = name.lower()
    for part, frags in KERNEL_PARTS:
        if any(f in low for f in frags):
            return part
    return "other"


def replay_breakdown(kernels: list, replays: int) -> dict:
    """Per decode token, from the profiler's CUDA kernels of ``replays``
    back-to-back replays (each (name, start µs, end µs)): µs and kernels by
    :func:`kernel_part`, the busy µs (their union), the span from the first
    start to the last end and the idle µs between kernels."""
    parts: dict = {}
    for name, t0, t1 in kernels:
        p = parts.setdefault(kernel_part(name), {"us": 0.0, "kernels": 0})
        p["us"] += (t1 - t0) / replays
        p["kernels"] += 1
    for p in parts.values():
        p["kernels"] /= replays
    busy, end = 0.0, None
    for t0, t1 in sorted((k[1], k[2]) for k in kernels):
        if end is None or t0 >= end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    span = (max(k[2] for k in kernels) - min(k[1] for k in kernels)) if kernels else 0.0
    return {"parts": parts, "busy_us": busy / replays, "span_us": span / replays,
            "idle_us": (span - busy) / replays,
            "idle_share": (span - busy) / span if span else None}


def replay_trace(label: str, eng, slot: int = 700, replays: int = 4, reps: int = 32) -> dict:
    """One decode token by graph replay on the engine's ring at ``slot``:
    its device ms by CUDA events over ``reps`` replays, and a
    ``torch.profiler`` trace of ``replays`` replays broken down by
    :func:`replay_breakdown`, with the ten costliest kernels; beside them
    the device ms of the token's sampling and of its decode attention
    (32 layers of :func:`xla_attention` over the ring, per-layer engines),
    each alone from a CUDA graph."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import generate_chunk
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import xla_attention
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import (
        SamplingParams,
        sample_chain,
        sampling_tensors,
    )

    graphs, cfg = eng._graphs, eng.cfg
    with eng._lock, torch.inference_mode():
        st = graphs.knobs(sampling_tensors(SamplingParams(temperature=0.0), eng.device))
        state = graphs.state([5] * slot, 0)

        def token():
            generate_chunk(eng.params, cfg, state, st, 1)

        token()
        replay_ms = cuda_ms(token, reps)
        state = graphs.state([5] * slot, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                token()
            torch.cuda.synchronize()
        eng._prefix_ids = []
        kernels = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        logits = torch.randn(cfg.vocab_size, device=eng.device)
        sampling_ms = graph_ms(lambda: sample_chain(logits, state["window"], None, st))
        attention_ms = None
        if not cfg.decode_layer_unroll:
            pos = torch.tensor([slot], device=eng.device)
            q = torch.randn(1, cfg.n_heads, cfg.head_dim, device=eng.device).to(torch.bfloat16)
            c = eng._cache
            leaves = ((c["k"][0], c["v"][0], None, None) if "k" in c else
                      (c["k_q"][0], c["v_q"][0], c["k_s"][0], c["v_s"][0]))
            attention_ms = cfg.n_layers * graph_ms(
                lambda: xla_attention(q, leaves[0], leaves[1], pos, cfg, torch.bfloat16,
                                      cks=leaves[2], cvs=leaves[3]))
    top: dict = {}
    for name, t0, t1 in kernels:
        top[name] = top.get(name, 0.0) + (t1 - t0) / replays
    out = {"file": label, "slot": slot, "replay_ms": replay_ms, "traced_replays": replays,
           **(replay_breakdown(kernels, replays) if kernels else
              {"missing": "torch.profiler recorded no CUDA kernel event"}),
           "sampling_graph_ms": sampling_ms, "attention_graph_ms": attention_ms,
           "top_kernels_us": dict(sorted(top.items(), key=lambda kv: -kv[1])[:10])}
    say("replay_trace", **out)
    return out


#: the served requests' sampling settings (the app's at temperature 0, the
#: engine's defaults for the rest), for :func:`top2_margin`
#: the /v1 conversation of the http phase, and one that shares no prefix
#: with any request of it (sent before each, so each prefills from slot 0)
V1_MESSAGES = [{"role": "user", "content": "Tell me a story about a lighthouse keeper."}]
UNRELATED = [{"role": "system", "content": "Reply with one word."},
             {"role": "user", "content": "Name a colour."}]


def abort_stream(port: int, payload, events: int = 2) -> float:
    """Open ``/response/stream``, read ``events`` SSE events, then drop the
    socket with a reset; returns the time of the reset."""
    raw = json.dumps(payload).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        s.sendall(b"POST /response/stream HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\nContent-Length: "
                  + str(len(raw)).encode() + b"\r\n\r\n" + raw)
        buf = b""
        while buf.count(b"data: ") < events:
            chunk = s.recv(65536)
            if not chunk:
                raise AssertionError(f"stream_abort: the stream ended early: {buf[:200]!r}")
            buf += chunk
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    finally:
        s.close()
    return time.time()


def phase_http(label: str, eng, short_ctx: list, short_reply: str, ring_bytes: int) -> None:
    """The rest of the HTTP surface over the served engine, greedy at the
    default settings: ``/v1/chat/completions`` without and with a stream,
    ``/response/stream``, a stream the client drops (the engine must be
    free within two decode chunks), ``/metrics``, a request's trace, and a
    watchdog drill on a second app with the incident recorder armed on a
    temporary directory: its bundles (``/debug/incidents``) and burn rates
    (``/debug/slo``).  One line each; any mismatch fails the run.  ``short_reply`` is the engine's
    ``/response`` reply to ``short_ctx`` from slot 0."""
    import collections

    from llama_fastapi_k8s_gpu_tpu_torch.obs.flightrec import FLIGHTREC
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings
    from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS

    sent = collections.Counter()          # (route, code) of every request

    def note(route: str, status: int):
        sent[(route, str(status))] += 1
        return status

    app = create_app(engine=eng, settings=Settings(temperature=0.0))
    with serving(app) as (port, _):
        def unrelated():
            st, _, _ = _request(port, "POST", "/v1/chat/completions",
                                {"messages": UNRELATED, "max_tokens": 1})
            if note("/v1/chat/completions", st) != 200:
                raise AssertionError(f"the separating request returned {st}")

        # 1. the same conversation without a stream and with one
        unrelated()
        t0 = time.time()
        st, hdrs, raw = _request(port, "POST", "/v1/chat/completions",
                                 {"messages": V1_MESSAGES})
        wall = time.time() - t0
        note("/v1/chat/completions", st)
        answer = json.loads(raw)
        tm = dict(eng.last_timings or {})
        content = answer["choices"][0]["message"]["content"] if st == 200 else ""
        finish = answer["choices"][0]["finish_reason"] if st == 200 else None
        rid = hdrs.get("x-request-id")
        say("v1_request", file=label, status=st, wall_s=wall, ttft_s=tm.get("ttft_s"),
            completion_tokens=tm.get("completion_tokens"), finish_reason=finish,
            tokens_per_sec=tm.get("tokens_per_sec"), chars=len(content),
            sha256=hashlib.sha256(content.encode()).hexdigest()[:16], request_id=rid)
        if st != 200 or not content or not rid:
            raise AssertionError(f"v1_request: status {st}, body {raw[:300]!r}")
        if answer["usage"] != {"prompt_tokens": tm["prompt_tokens"],
                               "completion_tokens": tm["completion_tokens"],
                               "total_tokens": tm["prompt_tokens"] + tm["completion_tokens"]}:
            raise AssertionError(f"v1_request: usage {answer['usage']} against {tm}")
        v1_rate = tm["tokens_per_sec"]
        unrelated()
        t0 = time.time()
        got = _sse(port, "/v1/chat/completions", {
            "messages": V1_MESSAGES, "stream": True,
            "stream_options": {"include_usage": True}})
        wall = time.time() - t0
        note("/v1/chat/completions", got["status"])
        tm = dict(eng.last_timings or {})
        events = got["events"]
        text, s_finish = sse_text(events)
        usage = events[-2].get("usage") if len(events) > 1 and isinstance(events[-2], dict) else None
        say("v1_stream", file=label, status=got["status"], events=len(events),
            first_event_s=got["first_event_s"], first_content_s=got["first_content_s"],
            wall_s=wall, ttft_s=tm.get("ttft_s"), tokens_per_sec=tm.get("tokens_per_sec"),
            completion_tokens=tm.get("completion_tokens"), finish_reason=s_finish,
            equal_to_v1_request=text == content, usage=usage)
        if got["status"] != 200 or got["headers"].get("content-type") != "text/event-stream":
            raise AssertionError(f"v1_stream: status {got['status']}, {got['headers']}")
        if events[-1] != "[DONE]" or (text, s_finish) != (content, finish):
            raise AssertionError(f"v1_stream: {len(text)} chars, finish {s_finish}, against "
                                 f"{len(content)} chars, finish {finish} without a stream")
        if usage != {"prompt_tokens": tm["prompt_tokens"],
                     "completion_tokens": tm["completion_tokens"],
                     "total_tokens": tm["prompt_tokens"] + tm["completion_tokens"]}:
            raise AssertionError(f"v1_stream: usage {usage} against the engine's {tm}")

        # 2. /response/stream against /response, both from slot 0
        unrelated()
        got = _sse(port, "/response/stream", body(short_ctx))
        note("/response/stream", got["status"])
        tm = dict(eng.last_timings or {})
        text, s_finish = sse_text(got["events"])
        say("response_stream", file=label, status=got["status"], events=len(got["events"]),
            first_event_s=got["first_event_s"], first_content_s=got["first_content_s"],
            ttft_s=tm.get("ttft_s"), tokens_per_sec=tm.get("tokens_per_sec"),
            completion_tokens=tm.get("completion_tokens"), finish_reason=s_finish,
            equal_to_response=text == short_reply)
        if got["status"] != 200 or got["events"][-1:] != ["[DONE]"] or text != short_reply:
            raise AssertionError(f"response_stream: status {got['status']}, {len(text)} chars "
                                 f"against the /response reply's {len(short_reply)}")

        # 3. a stream the client drops after two events
        t_rst = abort_stream(port, body(short_ctx))
        note("/response/stream", 200)
        while eng.heartbeat.busy_count() and time.time() - t_rst < 60:
            time.sleep(0.001)
        freed_s = time.time() - t_rst
        st, _, raw = _request(port, "POST", "/response", body(short_ctx))
        note("/response", st)
        # a decode chunk's seconds at the /v1 request's decode rate
        chunk_s = eng.decode_chunk / v1_rate
        say("stream_abort", file=label, engine_free_s=freed_s,
            decode_chunk=eng.decode_chunk, chunk_s=chunk_s, chunks=freed_s / chunk_s,
            next_status=st, busy=eng.heartbeat.busy_count())
        if eng.heartbeat.busy_count() or st != 200 or freed_s >= 2 * chunk_s:
            raise AssertionError(f"stream_abort: engine free after {freed_s:.3f}s "
                                 f"({freed_s / chunk_s:.2f} decode chunks), "
                                 f"next /response {st}")

        # 4. /metrics counts what this phase sent
        st, hdrs, raw = _request(port, "GET", "/metrics")
        text = raw.decode()
        counts = {tuple(v for _, v in k): int(n)
                  for k, n in prom_samples(text, "http_requests_total").items()}
        health_state = prom_samples(text, "health_state").get(())
        kv = prom_samples(text, "kv_cache_bytes").get(())
        families = sorted({ln.split(" ")[2] for ln in text.splitlines()
                           if ln.startswith("# TYPE ")})
        say("metrics", file=label, status=st, content_type=hdrs.get("content-type"),
            http_requests_total={f"{r} {c}": n for (r, c), n in sorted(counts.items())},
            health_state=health_state, kv_cache_bytes=kv, families=len(families))
        if (st != 200 or not hdrs.get("content-type", "").startswith("text/plain")
                or counts != dict(sent) or health_state != 1 or kv != ring_bytes):
            raise AssertionError(f"metrics: counted {counts}, sent {dict(sent)}, health "
                                 f"{health_state}, kv {kv} against {ring_bytes}")

        # 5. the trace of the /v1 request
        st, _, raw = _request(port, "GET", f"/debug/traces/{rid}")
        doc = json.loads(raw)
        root = doc.get("root") or {}
        top = {c["name"]: c for c in root.get("children", [])}
        engine_span = top.get("engine") or {"children": []}
        inner = [c["name"] for c in engine_span["children"]]
        late = spans_within(root) if root else ["root"]
        say("trace", file=label, status=st, spans=sorted(top), engine=inner[:2],
            decode_chunks=inner.count("decode_chunk"), finished=doc.get("finished"),
            outside_parent=late)
        if (st != 200 or "queue" not in top or inner[:1] != ["prefill"]
                or not inner.count("decode_chunk") or late or not doc.get("finished")):
            raise AssertionError(f"trace: {st}, spans {sorted(top)}, engine {inner[:3]}, "
                                 f"outside their parent {late}")

    # 6. the watchdog drill on a second app over the same engine, with the
    # incident recorder armed on a temporary directory
    drill = create_app(engine=eng, settings=Settings(
        temperature=0.0, watchdog_error_burst=3, watchdog_poll_seconds=0.02,
        watchdog_backoff_seconds=0.05))
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}
    graphs = eng._graphs
    incident_dir = tempfile.mkdtemp(prefix="lfkt-incidents-")
    FLIGHTREC.configure(directory=incident_dir)
    try:
        with serving(drill) as (port, _):
            # three faults trip the watchdog; a one-token request queued
            # behind the third (its prompt pass held 50 ms) is in flight at
            # the trip, so its trace must ride the trip's bundle
            FAULTS.arm("decode_step:error:times=3,prefill:slow:delay=0.05:after=3:times=1")
            codes = [_request(port, "POST", "/response", body(short_ctx))[0]
                     for _ in range(2)]
            box: dict = {}

            def third():
                box["code"] = _request(port, "POST", "/response", body(short_ctx))[0]
                box["t_err"] = time.time()

            def queued():
                box["queued"] = _request(port, "POST", "/v1/chat/completions",
                                         {"messages": UNRELATED, "max_tokens": 1})

            threads = [threading.Thread(target=third), threading.Thread(target=queued)]
            threads[0].start()
            time.sleep(0.01)
            threads[1].start()
            threads[0].join()
            codes.append(box["code"])
            t_err = box["t_err"]
            wd = drill.state.watchdog
            while not (wd.recoveries and drill.state.health.state == "READY") \
                    and time.time() - t_err < 60:
                time.sleep(0.005)
            ready_s = time.time() - t_err
            threads[1].join()
            FAULTS.disarm()
            st, _, raw = _request(port, "POST", "/response", body(short_ctx))
            after = json.loads(raw).get("response", "") if st == 200 else ""
            trail = [t["to"] for t in drill.state.health.snapshot()["transitions"]]
            trips, recoveries = wd.trips, wd.recoveries
            # an injected out-of-memory error: its own bundle, with its trace
            FAULTS.arm("decode_step:oom:times=1")
            oom_st, oom_hdrs, _ = _request(port, "POST", "/response", body(short_ctx))
            FAULTS.disarm()
            incidents = check_incidents(port, {
                "watchdog_trip": box["queued"][1].get("x-request-id"),
                "resource_exhausted": oom_hdrs.get("x-request-id")})
            # the burn rates over the drill's requests: four 500s of six burn
            # the error budget, but the pod is fresh, so no breach
            slo_st, _, raw = _request(port, "GET", "/debug/slo")
            slo = json.loads(raw)
    finally:
        FAULTS.disarm()
        FLIGHTREC.configure(directory="")
        shutil.rmtree(incident_dir, ignore_errors=True)
    same_ring = {k: v.data_ptr() for k, v in eng._cache.items()} == ptrs
    say("watchdog_drill", file=label, codes=codes, trips=trips, recoveries=recoveries,
        transitions=trail, seconds_to_ready=ready_s, ring_storage_unchanged=same_ring,
        graphs_kept=eng._graphs is graphs, status=st, reply_unchanged=after == short_reply,
        queued_status=box["queued"][0])
    if (codes != [500] * 3 or (trips, recoveries) != (1, 1)
            or trail[-3:] != ["READY", "DEGRADED", "READY"] or not same_ring
            or eng._graphs is not graphs or st != 200 or after != short_reply
            or box["queued"][0] != 200):
        raise AssertionError(f"watchdog_drill: codes {codes}, trips {trips}, recoveries "
                             f"{recoveries}, {trail}, ring kept {same_ring}, status {st}, "
                             f"reply equal {after == short_reply}, queued request "
                             f"{box['queued'][0]}")
    say("incidents", file=label, oom_status=oom_st, **incidents)
    if oom_st != 500:
        raise AssertionError(f"incidents: the injected OOM request returned {oom_st}")
    burns = worst_burns(slo)
    say("slo", file=label, status=slo_st, verdict=slo["verdict"],
        recompile=slo["recompile"]["verdict"], windows=slo["windows"], burns=burns)
    if (slo_st != 200 or slo["verdict"] == "breach"
            or burns["error_rate"][slo["windows"][0]] < 1):
        raise AssertionError(f"slo: {slo_st}, verdict {slo['verdict']}, burns {burns}")


def check_incidents(port: int, traced: dict) -> dict:
    """The recorder's bundles through the app: exactly one of each kind in
    ``traced`` ({kind: the request id whose trace it must hold}), each
    valid, read back whole by id, and ``incidents_total`` counting them."""
    from llama_fastapi_k8s_gpu_tpu_torch.obs.flightrec import validate_bundle

    st, _, raw = _request(port, "GET", "/debug/incidents")
    listing = json.loads(raw)
    kinds = sorted(i["kind"] for i in listing["incidents"])
    out = {"armed": listing["armed"], "kinds": kinds, "bundles": {}}
    bad = [] if st == 200 and kinds == sorted(traced) else [f"listing {st} {kinds}"]
    for summary in listing["incidents"]:
        st, _, raw = _request(port, "GET", f"/debug/incidents/{summary['id']}")
        doc = json.loads(raw)
        ids = [t.get("trace_id") for t in doc.get("traces", [])]
        holds = traced.get(doc.get("kind")) in ids
        problems = validate_bundle(doc)
        out["bundles"][summary["id"]] = {
            "status": st, "reason": doc.get("reason", "")[:80], "valid": not problems,
            "traces": len(ids), "holds_request_trace": holds,
            "memory_components": [r["component"] for r in doc["memory"].get("components", [])],
            "health_trail": [t["to"] for t in (doc.get("health") or {}).get("transitions", [])]}
        if st != 200 or problems or not holds:
            bad.append(f"{summary['id']}: {st}, {problems}, trace held {holds}")
    st, _, raw = _request(port, "GET", "/metrics")
    out["incidents_total"] = prom_samples(raw.decode(), "incidents_total").get(())
    if out["incidents_total"] != len(traced):
        bad.append(f"incidents_total {out['incidents_total']}")
    if bad:
        raise AssertionError(f"incidents: {bad}")
    return out


#: the /metrics families of the device-facing surfaces (ROADMAP A.2b)
OBS_FAMILIES = ("xla_compiles_total", "jit_dispatches_total", "xla_recompile_storms_total",
                "xla_compile_seconds", "xla_compile_events_dropped_total", "hbm_bytes",
                "hbm_headroom_bytes", "slo_burn_rate", "incidents_total")
#: catalog families a /metrics shows only once their event happened on
#: that app (a 503, a 408, a trip, a prefix reuse...)
EVENT_FAMILIES = ("requests_rejected_total", "requests_timed_out_total",
                  "engine_unavailable_total", "engine_errors_total", "watchdog_trips_total",
                  "watchdog_recoveries_total", "watchdog_escalations_total",
                  "prefix_cache_hits_total", "prefix_cache_reused_tokens_total",
                  "streamed_generations_total", "prefill_slice_seconds", "incidents_total")
#: catalog families of the lane engines alone (PR 17): a serial pod never
#: shows them (``scheduler_`` is the prefix of the continuous scheduler's
#: gauges, never a family of its own)
LANE_FAMILIES = {"continuous": ("scheduler_", "admission_budget_tokens", "lane_idle_seconds",
                                "mem_pressure_events_total"),
                 "cycle": ("batched_generations_total", "batch_occupancy")}
#: catalog families of the paged pool and of speculation alone: a
#: dense pod without speculation never shows them; the paged and spec
#: phases check that theirs render
PAGED_FAMILIES = ("kv_pool_pages_used", "kv_pool_pages_free", "prefix_cache_misses_total",
                  "prefix_cache_evictions_total", "prefix_cache_spills_total",
                  "prefix_cache_restores_total", "prefix_reuse_tokens")
SPEC_FAMILIES = ("spec_drafted_tokens_total", "spec_accepted_tokens_total",
                 "spec_verify_steps_total", "spec_fallback_steps_total")


def devtime_delta(before: dict, after: dict) -> dict:
    """{program: {"compiles", "dispatches"}} grown between two
    ``DEVTIME.counters()`` snapshots (zero rows left out)."""
    out = {}
    for name, c in after.items():
        b = before.get(name, {})
        d = {k: c[k] - b.get(k, 0) for k in ("compiles", "dispatches")}
        if any(d.values()):
            out[name] = d
    return out


def worst_burns(slo_doc: dict) -> dict:
    """{slo: {window: burn rate}} of a ``/debug/slo`` document."""
    return {s["name"]: {w: ev["burn_rate"] for w, ev in s["windows"].items()}
            for s in slo_doc["slos"]}


def profile_trace_stats(path: str) -> dict:
    """Counts in a ``torch.profiler`` Chrome trace: CUDA kernel events,
    those of the port's kernels (by name), and graph launches."""
    with open(path) as fh:
        text = fh.read()
    names = re.findall(r'"ph":\s*"X",\s*"cat":\s*"kernel",\s*"name":\s*"([^"]*)"', text)
    port = [n for n in names if any(f in n for f in (
        "qgemv_kernel", "qmma_kernel", "flash_attention", "kv_quantize_kernel",
        "decode_loop_kernel", "dequant"))]
    return {"bytes": len(text), "cuda_kernels": len(names), "port_kernels": len(port),
            "port_kernel_names": sorted(set(port))[:4],
            "graph_launches": len(re.findall(r'"name":\s*"cudaGraphLaunch', text))}


def memory_pools() -> dict:
    """The caching allocator's live and reserved bytes, split between the
    default pool and the private pools (the decode graphs')."""
    import torch

    out = {"default_active": 0, "default_reserved": 0, "private_active": 0,
           "private_reserved": 0}
    for seg in torch.cuda.memory_snapshot():
        pool = "default" if tuple(seg.get("segment_pool_id", (0, 0))) == (0, 0) else "private"
        out[f"{pool}_active"] += seg["active_size"]
        out[f"{pool}_reserved"] += seg["total_size"]
    return out


def phase_obs(label: str, eng, short_ctx: list, ring_bytes: int, before: dict,
              at_start: dict, allocated_before: int) -> None:
    """The device-facing surfaces over the served engine, on a fresh app:
    ``/debug/compiles`` (graph captures as compiles, a
    recompile storm under a low budget), ``/debug/memory``,
    ``/debug/profile`` during a stream, the launch audit of one decode
    step and the ``/metrics`` families.  ``before`` is the compile
    registry's counters from before this engine was built, ``at_start``
    from before the kernel build, ``allocated_before`` the allocator's live
    bytes before this engine was built.  Every count is a delta between two
    snapshots: the registries are the process's.  One line each; any
    mismatch fails the run."""
    from llama_fastapi_k8s_gpu_tpu_torch.obs.launches import decode_step_launches
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    app = create_app(engine=eng, settings=Settings(temperature=0.0))
    chunks = []                    # the decode chunks the engine queued
    queue_chunk = eng._decode_chunk

    def counted(ctx, n_steps):
        chunks.append(n_steps)
        return queue_chunk(ctx, n_steps)

    eng._decode_chunk = counted
    try:
        with serving(app) as (port, _):
            check_compiles(label, eng, port, short_ctx, before, at_start, chunks)
            check_memory(label, eng, port, ring_bytes, allocated_before)
            check_metrics_families(label, port)
            check_profile(label, eng, port, short_ctx)
    finally:
        del eng._decode_chunk
    # the launch audit of one eager decode step, against the kernels' counts
    # in one replay plus the decode attention's two products a layer
    audit = decode_step_launches(eng.params, eng.cfg)
    step = eng._graphs.step_launches(40)
    by = audit["by_prim"]
    wrappers = {n: by.get(n, 0) + by.get(f"{n}(flat)", 0) for n in step}
    products = by.get("bmm", 0)
    say("launches_audit", file=label, total=audit["total"], in_loop=audit["in_loop"],
        outside=audit["outside"], loop_trips=audit["loop_trips"], by_prim=by,
        replay_kernels=step, attention_products=products,
        expected=sum(step.values()) + 2 * eng.cfg.n_layers)
    if (wrappers != step or products != 2 * eng.cfg.n_layers
            or audit["total"] != sum(step.values()) + products
            or audit["loop_trips"] != [eng.cfg.n_layers] or audit["outside"] != 1):
        raise AssertionError(f"launches_audit: {audit} against a replay's {step} and "
                             f"{2 * eng.cfg.n_layers} attention products")


def check_compiles(label, eng, port, short_ctx, before, at_start, chunks) -> None:
    """The ``compiles`` line: the registry's counts as deltas (see
    :func:`phase_obs`); ``chunks`` lists the decode chunks the engine
    queues."""
    from llama_fastapi_k8s_gpu_tpu_torch.obs.devtime import DEVTIME
    from llama_fastapi_k8s_gpu_tpu_torch.obs.trace import TRACER
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    # the warmup's capture, a request's dispatches, a new top_k's capture,
    # then a storm under a low budget
    def programs():
        st, _, raw = _request(port, "GET", "/debug/compiles")
        if st != 200:
            raise AssertionError(f"compiles: /debug/compiles {st}")
        return {p["name"]: p for p in json.loads(raw)["programs"]}

    def counters(progs):
        return {n: {"compiles": p["compiles"], "dispatches": p["dispatches"]}
                for n, p in progs.items()}

    progs = programs()
    warm = devtime_delta(before, counters(progs))
    build = devtime_delta(at_start, counters(progs)).get("kernel_build", {})
    launches_match = {n: progs[n]["dispatches"] == fn.launches for n, fn in KERNELS.items()}
    del chunks[:]
    s0 = counters(progs)
    st, _, _ = _request(port, "POST", "/response", body(short_ctx))
    request = devtime_delta(s0, counters(programs()))
    n_chunks = len(chunks)
    s1 = counters(programs())
    del chunks[:]
    eng.create_chat_completion([{"role": "user", "content": "hi"}], temperature=0.0,
                               top_k=5, max_tokens=17)
    top5_chunks = len(chunks)
    capture5_s = eng._graphs.captures[5]
    progs = programs()
    top5 = devtime_delta(s1, counters(progs))
    sig5 = {e["signature"]: e for e in progs["decode_chunk"]["signature_list"]}.get("top_k=5")
    # the storm: two more top_k fit the budget, a third passes it (and
    # evicts top_k 5, which comes back as a re-capture)
    budget = DEVTIME.budget
    n_sigs = progs["decode_chunk"]["signatures"]
    storms0 = DEVTIME.storms_total
    _, _, raw = _request(port, "GET", "/metrics")
    gauge0 = prom_samples(raw.decode(), "xla_recompile_storms_total").get(())
    DEVTIME.configure(budget=n_sigs + 2)
    s2 = counters(progs)
    storm_events = {}
    del chunks[:]
    try:
        for k in (6, 7, 8, 5):
            tr = TRACER.start("request")
            eng.create_chat_completion([{"role": "user", "content": "hi"}], temperature=0.0,
                                       top_k=k, max_tokens=17, trace=tr)
            storm_events[k] = [e for e in tr.to_dict()["root"]["events"]
                               if e["name"] == "recompile_storm"]
            TRACER.finish(tr)
        _, _, raw = _request(port, "GET", "/metrics")
        gauge1 = prom_samples(raw.decode(), "xla_recompile_storms_total").get(())
        storm = devtime_delta(s2, counters(programs()))
        storms = DEVTIME.storms_total - storms0
    finally:
        DEVTIME.configure(budget=budget)
    say("compiles", file=label, warmup=warm, kernel_build=build,
        captures=dict(eng._graphs.captures), request=request, request_status=st,
        request_chunks=n_chunks, top_k_5=top5, top_k_5_signature=sig5,
        storm=storm, storm_budget=n_sigs + 2, storms=storms,
        storms_gauge=[gauge0, gauge1],
        storm_events={k: len(v) for k, v in storm_events.items()},
        held=eng._graphs.keys, launches_match_counters=all(launches_match.values()))
    want_storm = {"compiles": 4, "dispatches": len(chunks)}
    if (warm.get("decode_chunk", {}).get("compiles") != 1 or build.get("compiles", 0) != 0
            or st != 200 or request.get("decode_chunk") != {"compiles": 0,
                                                              "dispatches": n_chunks}
            or request.get("first_sample", {}).get("dispatches") != 1
            or top5.get("decode_chunk") != {"compiles": 1, "dispatches": top5_chunks}
            or sig5 is None
            or abs(sig5["wall_s"] - capture5_s) > 1e-5
            or storms != 1 or {k: len(v) for k, v in storm_events.items()} != {
                6: 0, 7: 0, 8: 1, 5: 0}
            or storm.get("decode_chunk") != want_storm
            or gauge1 - gauge0 != 1 or not all(launches_match.values())):
        raise AssertionError(f"compiles: warmup {warm}, build {build}, request {st} "
                             f"{request} over {n_chunks} chunks, top_k 5 {top5} {sig5}, "
                             f"storm {storm} ({storms} storms, events {storm_events}), "
                             f"launches match {launches_match}")



def check_memory(label, eng, port, ring_bytes, allocated_before: int) -> None:
    """The ``memory`` line: ``/debug/memory`` against the allocator;
    ``allocated_before`` is the allocator's live bytes before the engine
    was built (what the earlier phases still hold, in the residual too)."""
    import torch

    st, _, raw = _request(port, "GET", "/debug/memory")
    mem = json.loads(raw)
    rows = {r["component"]: r["bytes"] for r in mem.get("components", [])}
    _, hdoc = _http(port, "GET", "/health")
    pools = memory_pools()
    say("memory", file=label, status=st, components=rows, source=mem["ground_truth"]["source"],
        ground_truth_bytes=mem["ground_truth"]["bytes"], limit=mem["ground_truth"]["limit"],
        residual_bytes=mem["residual_bytes"],
        headroom_bytes=(mem.get("headroom") or {}).get("bytes"),
        weight_bytes=eng.weight_bytes, health_kv_cache_bytes=hdoc["engine"]["kv_cache_bytes"],
        reserved_bytes=torch.cuda.memory_reserved(), allocated_before_engine=allocated_before,
        **pools)
    if (st != 200 or rows.get("weights") != eng.weight_bytes
            or not rows.get("kv_ring") == ring_bytes == hdoc["engine"]["kv_cache_bytes"]
            or mem["ground_truth"]["source"] != "torch.cuda.memory_stats"
            or mem["residual_bytes"] is None or mem["residual_bytes"] < 0
            or mem.get("headroom") is None):
        raise AssertionError(f"memory: {st} {mem}")



#: the tokens of the stream the ``profile`` line captures: two decode
#: chunks, all inside the 1 s window (a 512-token stream filled it with
#: ~200 MB of kernel events, ~23 s to export and parse)
PROFILE_TOKENS = 16


def check_profile(label, eng, port, short_ctx) -> None:
    """The ``profile`` line: ``/debug/profile`` refused (403) on this app,
    whose startup ran without ``LFKT_PROFILE_DIR`` and prepared no
    profiler; then a second app over the engine, started with the
    directory set, whose startup pays the profiler's one-time set-up
    (``prepare_s``); on it one capture is requested, and a single stream
    of :data:`PROFILE_TOKENS` tokens starts after the request: the capture
    opens within a second
    (``start_s``, the process's first capture) and holds the stream's
    kernels and graph launches, while a second capture meanwhile gets
    409.  ``wall_s`` is the stop and the export, as it is."""
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils import tracing
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    st403, _, _ = _request(port, "GET", "/debug/profile?seconds=1")
    unprepared = tracing.profiler_prepared()
    prof_dir = tempfile.mkdtemp(prefix="lfkt-profile-")
    os.environ["LFKT_PROFILE_DIR"] = prof_dir
    sink, budget = eng.metrics_sink, eng.max_gen_tokens
    eng.max_gen_tokens = PROFILE_TOKENS
    box: dict = {}
    try:
        t0 = time.time()
        with serving(create_app(engine=eng, settings=Settings(temperature=0.0))) as (p2, _):
            ready_s = time.time() - t0
            prepared = tracing.profiler_prepared()

            def capture():
                box["capture"] = _request(p2, "GET", "/debug/profile?seconds=1", timeout=240)

            th_c = threading.Thread(target=capture)
            th_c.start()
            time.sleep(0.1)                  # the stream starts after the request
            th_s = threading.Thread(target=lambda: box.update(
                stream=_sse(p2, "/response/stream", body(short_ctx))["status"]))
            th_s.start()
            time.sleep(0.3)
            st409, _, _ = _request(p2, "GET", "/debug/profile?seconds=1")
            th_c.join()
            th_s.join()
        st200, _, raw = box.get("capture", (None, None, b"{}"))
        doc = json.loads(raw)
        stats = profile_trace_stats(doc["trace"]) if st200 == 200 and doc.get("ok") else {}
    finally:
        del os.environ["LFKT_PROFILE_DIR"]
        eng.metrics_sink, eng.max_gen_tokens = sink, budget
        shutil.rmtree(prof_dir, ignore_errors=True)
    after = tracing.profiler_prepared()
    say("profile", file=label, disabled_status=st403, busy_status=st409, status=st200,
        prepared_before=unprepared["count"], prepared=prepared["count"],
        prepare_s=prepared["seconds"], app_ready_s=ready_s, prepared_after=after["count"],
        seconds=doc.get("seconds"), start_s=doc.get("start_s"), wall_s=doc.get("wall_s"),
        stream_status=box.get("stream"), **stats)
    if ((st403, st409, st200) != (403, 409, 200) or not doc.get("ok")
            or (unprepared["count"], prepared["count"], after["count"]) != (0, 1, 1)
            or not doc.get("start_s", 99) < 1.0
            or not stats.get("cuda_kernels") or not stats.get("port_kernels")
            or not stats.get("graph_launches") or box.get("stream") != 200):
        raise AssertionError(f"profile: {st403}, {st409}, {st200} {doc} {stats} "
                             f"prepared {unprepared} {prepared} {after}")


def check_metrics_families(label, port) -> None:
    """The ``metrics_families`` line: every family of the catalog but those
    whose event did not happen on this app, and nothing outside it."""
    from llama_fastapi_k8s_gpu_tpu_torch.obs import catalog

    st, _, raw = _request(port, "GET", "/metrics")
    text = raw.decode()
    families = {ln.split(" ")[2] for ln in text.splitlines() if ln.startswith("# TYPE ")}
    families = {f for f in families if f in catalog.METRICS}
    rendered_outside = sorted({ln.split(" ")[2] for ln in text.splitlines()
                               if ln.startswith("# TYPE ")} - families
                              - {f"{h}_{q}" for h in catalog.METRICS for q in ("p50", "p95", "p99")})
    missing = sorted(set(catalog.METRICS) - families)
    say("metrics_families", file=label, status=st, families=len(families),
        catalog=len(catalog.METRICS), absent_event_families=missing,
        obs_families=[f for f in OBS_FAMILIES if f in families],
        outside_catalog=rendered_outside)
    need = set(OBS_FAMILIES) - {"incidents_total"}      # the recorder is off here
    others_only = {f for fams in LANE_FAMILIES.values() for f in fams} | set(PAGED_FAMILIES) \
        | set(SPEC_FAMILIES) | set(TIER_FAMILIES) | set(FLEET_FAMILIES)
    if (st != 200 or not need <= families or rendered_outside
            or not set(missing) <= set(EVENT_FAMILIES) | others_only):
        raise AssertionError(f"metrics_families: {st}, missing {missing}, outside the "
                             f"catalog {rendered_outside}")


def served_sampling(settings):
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams

    return SamplingParams(temperature=settings.temperature, top_p=settings.top_p,
                          frequency_penalty=settings.frequency_penalty,
                          presence_penalty=settings.presence_penalty)


def record_prompts(eng) -> list:
    """Wrap ``eng.tokenize_messages`` (the request path's encode): each
    call appends its messages, ids and seconds to the returned list."""
    tokenize = eng.tokenize_messages
    sink: list = []

    def timed(messages):
        t0 = time.perf_counter()
        ids = tokenize(messages)
        sink.append({"messages": [dict(m) for m in messages], "ids": ids,
                     "seconds": time.perf_counter() - t0})
        return ids

    eng.tokenize_messages = timed
    return sink


def check_mistral_http(label: str, eng, port: int) -> None:
    """The ``mistral_http`` line: ``/v1/chat/completions`` with a system
    message (folded into the first ``[INST]``), then — after a request that
    shares no prefix with it, so no prefix reuse — the same request
    streamed, whose joined deltas must equal the non-stream reply (the SPM
    prefix space dropped once, on the first piece)."""
    from llama_fastapi_k8s_gpu_tpu_torch.tokenizer.chat_template import render_mistral

    v1 = {"messages": MISTRAL_SYSTEM, "max_tokens": 64}
    st, doc = _http(port, "POST", "/v1/chat/completions", v1)
    v1_ids = REPLIES[-1]["prompt"]
    folded = render_mistral(MISTRAL_SYSTEM) == (
        f"[INST] {MISTRAL_SYSTEM[0]['content']}\n\n{MISTRAL_SYSTEM[1]['content']} [/INST]")
    choice = ((doc or {}).get("choices") or [{}])[0]
    content = choice.get("message", {}).get("content", "")
    _http(port, "POST", "/v1/chat/completions", {"messages": UNRELATED, "max_tokens": 4})
    sse = _sse(port, "/v1/chat/completions", {**v1, "stream": True})
    text, finish = sse_text(sse["events"])
    out = {"file": label, "v1_status": st, "v1_prompt_tokens": len(v1_ids),
           "system_folded": folded, "v1_chars": len(content), "v1_head": content[:40],
           "stream_status": sse["status"], "stream_first_event_s": sse["first_event_s"],
           "stream_finish": finish, "stream_equals_v1": (text, finish) == (
               content, choice.get("finish_reason"))}
    say("mistral_http", **out)
    if not (st == 200 and content and folded and sse["status"] == 200
            and out["stream_equals_v1"]):
        raise AssertionError(f"{label}: mistral_http {out}")


def check_window(label: str, eng, toks, cache: dict) -> None:
    """The sliding window on the served Mistral model past slot 4096, on the
    scratch ring ``cache``: the prompt ``toks`` through 256-token slices
    (as the engine's sliced prefill) up to the last whole slice, whose
    queries sit past slot 4096; that slice by the flash kernel and by the
    plain score-matrix pass on a clone of the ring (the ``logits`` line,
    5e-2 rel-dev); then one decode step at the next slot with the window
    and with the window set to 0 on a clone: the logits must differ
    (``window`` line; without it nothing shows the mask was applied)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import prefill_chunk
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import decode_step

    cfg = eng.cfg
    C = 256
    start = (len(toks) - C) // C * C
    if start < cfg.sliding_window:
        raise AssertionError(f"{label}: the long prompt ({len(toks)} tokens) ends before "
                             f"a slice past the window {cfg.sliding_window}")
    with torch.inference_mode():
        for k in cache.values():
            k.zero_()
        for off in range(0, start, C):
            prefill_chunk(eng.params, cfg, toks[off:off + C], off, C - 1, cache)
        plain = {k: v.clone() for k, v in cache.items()}
        lg_flash = prefill_chunk(eng.params, cfg, toks[start:start + C], start, C - 1, cache)
        lg_xla = prefill_chunk(eng.params, dataclasses.replace(cfg, attn_impl="xla"),
                               toks[start:start + C], start, C - 1, plain)
        finite = bool(torch.isfinite(lg_flash).all() and torch.isfinite(lg_xla).all())
        rel = _rel(lg_flash, lg_xla)
        say("logits", file=label, shape=list(lg_flash.shape), finite=finite,
            kv_dtype=cfg.kv_dtype, flash_vs_plain_rel=rel, tokens=start + C,
            slice=[start, start + C - 1], sliding_window=cfg.sliding_window)
        if not finite or lg_flash.shape != (cfg.vocab_size,) or rel > 5e-2:
            raise AssertionError(f"{label}: logits finite={finite} flash vs plain past the "
                                 f"window rel-dev {rel}")
        pos = start + C
        tok = lg_flash.argmax()
        no_window = {k: v.clone() for k, v in cache.items()}
        lw = decode_step(eng.params, cfg, tok, pos, cache)
        l0 = decode_step(eng.params, dataclasses.replace(cfg, sliding_window=0), tok, pos,
                         no_window)
        dist = _rel(lw, l0)
    out = {"file": label, "slot": pos, "sliding_window": cfg.sliding_window,
           "keys_behind_window": pos + 1 - cfg.sliding_window,
           "decode_layer_unroll": cfg.decode_layer_unroll,
           "logits_rel_vs_window_0": dist, "argmax": [int(lw.argmax()), int(l0.argmax())]}
    say("window", **out)
    if not (torch.isfinite(lw).all() and dist > 1e-3):
        raise AssertionError(f"{label}: the window does not bite at slot {pos}: {out}")


def check_tokenizer(label: str, eng, prompts: list) -> None:
    """The ``tokenizer`` line over the served prompts (as
    :func:`record_prompts` saw them): encode seconds and tokens a second,
    byte-fallback ids, the share of words that came out as whole
    ``▁word`` pieces, and ``decode(encode(text)) == text`` for every
    message and every rendered prompt."""
    from llama_fastapi_k8s_gpu_tpu_torch.tokenizer import TokenType
    from llama_fastapi_k8s_gpu_tpu_torch.tokenizer.chat_template import render_mistral

    tok = eng.tokenizer
    n_tok = sum(len(p["ids"]) for p in prompts)
    secs = sum(p["seconds"] for p in prompts)
    byte_ids = sum(1 for p in prompts for i in p["ids"] if tok.token_types[i] == TokenType.BYTE)
    roundtrip, words, whole = True, 0, 0
    for p in prompts:
        texts = [m["content"] for m in p["messages"]] + [render_mistral(p["messages"])]
        for text in texts:
            roundtrip &= tok.decode(tok.encode(text, add_bos=False), skip_special=False) == text
        pieces = {tok.tokens[i] for i in p["ids"]}
        for w in re.findall(r"(?<= )[A-Za-z']+", texts[-1]):
            words += 1
            whole += ("▁" + w) in pieces
    out = {"file": label, "kind": type(tok).__name__, "prompts": len(prompts),
           "tokens": n_tok, "longest": max(len(p["ids"]) for p in prompts),
           "encode_s": secs, "encode_s_longest": max(p["seconds"] for p in prompts),
           "tokens_per_s": n_tok / secs if secs else None, "byte_fallback_ids": byte_ids,
           "whole_word_share": whole / words if words else None, "roundtrip": roundtrip}
    say("tokenizer", **out)
    if not (roundtrip and byte_ids and out["whole_word_share"] > 0.5):
        raise AssertionError(f"{label}: tokenizer {out}")


def phase_serve(layout: str, path: str, counters: dict, follow_up: bool,
                kv_dtype: str = "bf16", weight_format: str = "auto", unroll: int = 0,
                label: str | None = None, expect_unroll: int = 0, ordinal: int = 0,
                earlier: list | None = None, deadline_request: bool = False,
                http_phase: bool = False, devtime_at_start: dict | None = None,
                n_ctx: int = 1024, mistral: bool = False, load_probe: bool = False) -> dict:
    """Serve ``path`` in ``weight_format`` over a ``kv_dtype`` KV cache with
    ``decode_layer_unroll=unroll`` at ``n_ctx`` and return each kernel's
    launches on that path.  ``ordinal`` numbers the engine for
    :func:`record_replies`; ``earlier`` holds an earlier run's replies to
    compare with; ``deadline_request`` adds one request at the reference's
    25 s timeout, ``http_phase`` the rest of the HTTP surface
    (:func:`phase_http`) and the device-facing one (:func:`phase_obs`, its
    compile counts taken from ``devtime_at_start``, the registry before the
    kernel build).  ``mistral`` serves the Mistral file's prompts (the long
    one past the window) and adds its checks: ``/v1`` with a system
    message, and streamed, held to the non-stream reply
    (:func:`check_mistral_http`), the window past slot 4096
    (:func:`check_window`) and the SPM tokenizer (:func:`check_tokenizer`).
    ``load_probe`` times the load by GGML type (:func:`load_types`) and holds
    each type's expanded plane to the codec (:func:`check_planes`)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import prefill, prefill_chunk
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import decode_step
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import LOOP_LINEARS
    from llama_fastapi_k8s_gpu_tpu_torch.obs.devtime import DEVTIME
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    for fn in counters.values():         # the main path starts here: count it
        fn.launches = 0
    label = label or layout
    devtime_before = DEVTIME.counters()
    allocated_before = torch.cuda.memory_allocated()
    t0 = time.time()
    # the GPU, auto attention
    by_type: dict = {}
    with timed_load(by_type) if load_probe else contextlib.nullcontext():
        eng = Engine(path, n_ctx=n_ctx, kv_dtype=kv_dtype, weight_format=weight_format,
                     decode_layer_unroll=unroll)
    engine_load_s = time.time() - t0
    record_replies(eng, ordinal)
    prompts = record_prompts(eng) if mistral else []
    eng.warmup()
    load_s = time.time() - t0
    formats = eng.params.formats()
    say("load", file=label, seconds=round(load_s, 1), attn_impl=eng.cfg.attn_impl,
        kv_dtype=eng.cfg.kv_dtype, formats=formats, decode_layer_unroll=unroll,
        weight_gb=round(eng.weight_bytes / 1e9, 3), graph_capture_s=eng._graphs.captures)
    want = (served_formats(layout) if weight_format == "auto"
            else dict.fromkeys((*LOOP_LINEARS, "output"), weight_format))
    if formats != want:
        raise AssertionError(f"{label}: served formats {formats}, expected {want}")
    # the ring's bytes by the reference's formula (2 * L * n_kv * n_ctx *
    # (hd + 4) in int8, 2 * hd in bf16) and as allocated
    cfg = eng.cfg
    per_head = cfg.head_dim + 4 if kv_dtype == "int8" else 2 * cfg.head_dim
    ring_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.n_ctx * per_head
    live = sum(t.numel() * t.element_size() for t in eng._cache.values())
    if not eng.kv_cache_bytes == live == ring_bytes:
        raise AssertionError(f"{label}: kv_cache_bytes {eng.kv_cache_bytes}, "
                             f"allocated {live}, expected {ring_bytes}")
    # the reference's serving defaults, greedy, with a timeout that leaves
    # room for the whole reply on any engine
    settings = Settings(temperature=0.0, timeout_seconds=600.0, max_context_tokens=n_ctx)
    app = create_app(engine=eng, settings=settings)
    results = []
    short, long_ctx = SHORT_CTX, LONG_CTX
    if mistral:
        short, long_ctx = MISTRAL_SHORT, mistral_long_context()
    with serving(app) as (port, th):
        for req, ctx in (("short", short), ("long", long_ctx)):
            st, doc = _http(port, "POST", "/response", body(ctx))
            results.append((req, st, doc, dict(eng.last_timings or {}), REPLIES[-1]))
        if follow_up:
            follow = long_ctx + [("assistant", results[-1][2].get("response", "")[:40]),
                                 ("user", MISTRAL_FOLLOW_UP)]
            st, doc = _http(port, "POST", "/response", body(follow))
            results.append(("follow_up", st, doc, dict(eng.last_timings or {}), REPLIES[-1]))
        if mistral:
            check_mistral_http(label, eng, port)
        hst, hdoc = _http(port, "GET", "/health")
        alive = th.is_alive()
    served_prompts = list(prompts)
    launches = {name: fn.launches for name, fn in counters.items()}
    say("launches", file=label, **launches)
    for req, st, doc, tm, rec in results:
        text = (doc or {}).get("response", "")
        SERVED[(label, req)] = text
        say("request", file=label, label=req, status=st, chars=len(text),
            sha256=hashlib.sha256(text.encode()).hexdigest()[:16],
            prompt_tokens=tm.get("prompt_tokens"), bucket=tm.get("bucket"),
            reused=tm.get("prefix_reused_tokens"), ttft_s=tm.get("ttft_s"),
            completion_tokens=tm.get("completion_tokens"),
            finish_reason=rec.get("finish_reason"),
            tokens_per_sec=tm.get("tokens_per_sec"), head=text[:60])
        if st != 200 or not text:
            raise AssertionError(f"{req}: status {st}, body {doc}")
    for ch in reply_changes([r[4] for r in results], earlier or []):
        rec = ch.pop("rec")
        say("reply_change", file=label, prompt_tokens=len(rec["prompt"]),
            completion_tokens=len(rec["ids"]), **ch,
            **top2_margin(eng, rec["prompt"], rec["ids"], ch["first_diff"],
                          served_sampling(settings)))
    engine_doc = (hdoc or {}).get("engine") or {}
    say("health", file=label, status=hst, state=(hdoc or {}).get("state"),
        engine=engine_doc)
    if hst != 200 or not alive:
        raise AssertionError(f"/health {hst}, httpd stopped: {not alive}")
    if (engine_doc.get("kv_dtype"), engine_doc.get("kv_cache_bytes"),
            engine_doc.get("n_ctx")) != (kv_dtype, ring_bytes, n_ctx):
        raise AssertionError(f"/health reports kv_dtype {engine_doc.get('kv_dtype')}, "
                             f"{engine_doc.get('kv_cache_bytes')} bytes and n_ctx "
                             f"{engine_doc.get('n_ctx')}, expected {kv_dtype}, "
                             f"{ring_bytes} and {n_ctx}")
    if engine_doc.get("decode_layer_unroll") != expect_unroll:
        raise AssertionError(f"/health reports decode_layer_unroll "
                             f"{engine_doc.get('decode_layer_unroll')}, expected {expect_unroll}")
    if follow_up and not results[2][3].get("prefix_reused_tokens"):
        raise AssertionError("the follow-up turn did not take prefix reuse")
    if deadline_request:
        # the reference's own timeout (Settings' 25 s): the whole default
        # reply of 512 tokens must come back, neither cut at the deadline
        # nor answered 408 — greedy, so the reply is the same every run
        dflt = Settings(temperature=0.0)
        with serving(create_app(engine=eng, settings=dflt)) as (port, _):
            t_req = time.time()
            st, doc = _http(port, "POST", "/response", body(short))
            wall = time.time() - t_req
        rec, tm = REPLIES[-1], dict(eng.last_timings or {})
        say("deadline_request", file=label, timeout_seconds=dflt.timeout_seconds, status=st,
            completion_tokens=tm.get("completion_tokens"),
            finish_reason=rec.get("finish_reason"), wall_s=wall, ttft_s=tm.get("ttft_s"),
            tokens_per_sec=tm.get("tokens_per_sec"))
        if (st, tm.get("completion_tokens"), rec.get("finish_reason")) != (
                200, dflt.max_gen_tokens, "length"):
            raise AssertionError(f"{label}: the {dflt.timeout_seconds} s request returned "
                                 f"{st} with {tm.get('completion_tokens')} tokens, finish "
                                 f"{rec.get('finish_reason')}")
    if http_phase:
        phase_http(label, eng, short, results[0][2].get("response", ""), ring_bytes)
        phase_obs(label, eng, short, ring_bytes, devtime_before, devtime_at_start or {},
                  allocated_before)

    # the served model's logits, then the graph against the eager step (on
    # the engine's ring, which nothing serves now), then the launches of one
    # decode token and one 256-token prompt slice
    ids = eng.tokenize_messages(
        [{"role": "user" if t == "user" else "assistant", "content": m}
         for t, m in long_ctx])
    check_graph(label, eng, ids)
    # on a scratch ring (not part of the served path's counts above): the
    # port's kernels by their counters and every CUDA kernel by the
    # profiler, for the eager step and for one replay of the captured one
    scratch = {k: torch.zeros_like(v) for k, v in eng._cache.items()}
    per = {}
    for what, fn in (
            ("token", lambda: decode_step(eng.params, cfg, torch.tensor(5, device=eng.device),
                                          300, scratch)),
            ("slice", lambda: prefill_chunk(eng.params, cfg, torch.full(
                (256,), 5, device=eng.device), 256, 255, scratch))):
        for c in counters.values():
            c.launches = 0
        with torch.inference_mode():
            kernels, why = profiled_kernels(fn)
        per[what] = {n: c.launches for n, c in counters.items() if c.launches}
        per[what]["cuda_kernels"] = kernels
        if why:
            per[what]["cuda_kernels_missing"] = why
    graph_token = graph_token_kernels(eng, counters)
    say("per_token", file=label, **per["token"], graph=graph_token)
    say("per_slice", file=label, **per["slice"])
    if expect_unroll and per["token"].get("decode_loop") != cfg.n_layers // expect_unroll:
        raise AssertionError(f"{label}: one decode token launched the looped kernel "
                             f"{per['token'].get('decode_loop')} times, expected "
                             f"{cfg.n_layers // expect_unroll}")
    # a decode token of the Mistral engines at a slot past the window
    replay_trace(label, eng, slot=len(ids) if mistral else 700)

    # the served model's logits: finite, and the flash prompt pass agrees
    # with the plain score-matrix one on the long prompt (over the int8
    # ring, the int8 flash kernel with the score-matrix path's folded
    # scales) — on the Mistral file on its slice past slot 4096, with the
    # window.  Tolerance 5e-2 rel-dev: the plain path rounds its
    # probabilities to bf16 before P·V (as the reference does), the kernel
    # keeps them in f32, and the difference passes through every layer.
    toks = torch.tensor(ids, device=eng.device)
    cache = scratch
    if mistral:
        check_window(label, eng, toks, cache)
        check_tokenizer(label, eng, served_prompts)
    else:
        lg_flash = prefill(eng.params, eng.cfg, toks, len(ids), cache)
        cfg_x = dataclasses.replace(eng.cfg, attn_impl="xla")
        lg_xla = prefill(eng.params, cfg_x, toks, len(ids), cache)
        finite = bool(torch.isfinite(lg_flash).all() and torch.isfinite(lg_xla).all())
        rel = ((lg_flash - lg_xla).norm() / lg_xla.norm()).item()
        say("logits", file=label, shape=list(lg_flash.shape), finite=finite,
            kv_dtype=kv_dtype, flash_vs_plain_rel=rel, tokens=len(ids))
        if not finite or lg_flash.shape != (eng.cfg.vocab_size,) or rel > 5e-2:
            raise AssertionError(f"logits finite={finite} shape={tuple(lg_flash.shape)} "
                                 f"flash vs plain rel-dev {rel}")
        del lg_flash, lg_xla
    if expect_unroll:
        check_looped_path(label, eng, toks)
    if load_probe:
        load_types(label, by_type, engine_load_s)
        if "bf16" in eng.params.formats().values():
            # the planes are the file's whatever the engine serves: held
            # once, where the served bf16 weights can be held to them too
            check_planes(label, eng, path)
    # free this engine's weights and graphs before the next file loads
    eng.close()
    del app, eng, cache, scratch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def graph_token_kernels(eng, counters: dict) -> dict:
    """One decode token by graph replay on the engine's ring: the host's
    graph launches (replays), the port's kernels by their counters (what
    the replay adds) and every CUDA kernel by ``torch.profiler``."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import generate_chunk
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams, sampling_tensors

    graphs = eng._graphs
    with eng._lock, torch.inference_mode():
        st = graphs.knobs(sampling_tensors(SamplingParams(temperature=0.0), eng.device))
        state = graphs.state([5] * 300, 0)
        for c in counters.values():
            c.launches = 0
        replays = graphs.replays
        kernels, why = profiled_kernels(
            lambda: generate_chunk(eng.params, eng.cfg, state, st, 1))
        eng._prefix_ids = []
    out = {"host_graph_launches": graphs.replays - replays,
           **{n: c.launches for n, c in counters.items() if c.launches},
           "cuda_kernels": kernels}
    if why:
        out["cuda_kernels_missing"] = why
    return out


def device_kernels(events) -> int:
    """The CUDA kernels among profiler ``events`` (``FunctionEvent``s):
    device events that are not a copy or a fill."""
    from torch.autograd import DeviceType

    return sum(1 for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))


def profiled_kernels(fn) -> tuple[int | None, str | None]:
    """(kernels, None): the CUDA kernels one call of ``fn`` launches, as
    ``torch.profiler`` records them; (None, reason) where it records no
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()            # no earlier kernel runs inside the window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = device_kernels(prof.events())
    return (n, None) if n else (None, "torch.profiler recorded no CUDA kernel event")


def check_looped_path(label: str, eng, toks, steps: int = 16, timed: int = 32) -> None:
    """The served looped decode against the per-layer path on the same
    weights: prefill ``toks`` once, then ``steps`` decode steps teacher
    forced on the per-layer path's greedy tokens — logits within
    SERVED_TOL rel-dev at every step, every layer's ring slots of those
    steps as :func:`check_slots` — and each path's decode ms/token over
    ``timed`` tokens by CUDA events.  The first step whose greedy token
    differs is information, not a gate: random weights give near-ties."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import prefill
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import decode_step

    cfg_loop = eng.cfg
    cfg_layer = dataclasses.replace(cfg_loop, decode_layer_unroll=0)
    n = len(toks)
    a = {k: torch.zeros_like(v) for k, v in eng._cache.items()}
    lg = prefill(eng.params, cfg_layer, toks, n, a)
    b = {k: v.clone() for k, v in a.items()}
    tok = lg.argmax()
    worst, first_div = 0.0, None
    with torch.inference_mode():
        for step in range(steps):
            la = decode_step(eng.params, cfg_loop, tok, n + step, a)
            lb = decode_step(eng.params, cfg_layer, tok, n + step, b)
            worst = max(worst, _rel(la, lb))
            if first_div is None and int(la.argmax()) != int(lb.argmax()):
                first_div = step
            tok = lb.argmax()
        torch.cuda.synchronize()

        def ms_per_token(cfg, cache, start):
            t = torch.tensor(5, device=eng.device)
            decode_step(eng.params, cfg, t, start, cache)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for i in range(timed):
                decode_step(eng.params, cfg, t, start + 1 + i, cache)
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / timed

        # time on copies: the compared rings keep the 16 steps' slots
        start = n + steps
        per_layer_ms = ms_per_token(cfg_layer, {k: v.clone() for k, v in b.items()}, start)
        looped_ms = ms_per_token(cfg_loop, {k: v.clone() for k, v in a.items()}, start)
    say("looped", file=label, steps=steps, logits_rel_max=worst, tol=SERVED_TOL,
        first_greedy_divergence=first_div, positions=[n, n + steps - 1],
        looped_ms_per_token=looped_ms, per_layer_ms_per_token=per_layer_ms,
        timed_tokens=timed)
    slots = check_slots(a, b, (slice(None), slice(None), slice(n, n + steps)), SERVED_TOL,
                        codes=False)
    say("looped_slots", file=label, layers=eng.cfg.n_layers, **slots, tol=SERVED_TOL)
    if not worst <= SERVED_TOL:
        raise AssertionError(f"{label}: looped vs per-layer logits rel-dev {worst} > "
                             f"{SERVED_TOL}")


# ---------------------------------------------------------------------------
# phase 5 (cont.): batched serving — lanes of one card
# ---------------------------------------------------------------------------

#: the lane engines: (label, file, weight format, KV dtype,
#: decode_layer_unroll, lanes, scheduler, wave clients, the engine whose
#: weights it serves or None to load the file) — Q4_K_M fused over the
#: bf16 ring under the continuous scheduler (the default); the same
#: weights over the int8 ring, per-layer, from 4 lanes (kernel 10's lane
#: axis: one launch a layer writes every lane); and the Q8_0 file as bf16
#: weights over the int8 ring with the looped kernel, 8 layers a launch,
#: under the cycle scheduler
LANES = (("lanes_q4km", "q4km", "auto", "bf16", 0, 8, "continuous", 16, None),
         ("lanes_q4km_int8", "q4km", "auto", "int8", 0, 4, "continuous", 8, "lanes_q4km"),
         ("cycle_q8_0_bf16_loop8", "q8_0", "bf16", "int8", 8, 4, "cycle", 8, None))
#: the kernels each lane engine's served path must launch
LANE_KERNELS = {"lanes_q4km": ("dequant_q4_k", "q4k_matmul", "q6k_matmul", "flash_attention"),
                "lanes_q4km_int8": ("q4k_matmul", "q6k_matmul", "kv_quantize",
                                    "flash_attention_int8"),
                "cycle_q8_0_bf16_loop8": ("dequant_q8_0", "kv_quantize", "decode_loop",
                                          "flash_attention_int8")}
#: the lane engine that also takes the dropped stream and the 512-token
#: request at the 25 s timeout
LANE_DRILLS = "lanes_q4km"
#: tokens a wave request generates
WAVE_TOKENS = 128
#: each linear of a layer in the order a step runs them
STEP_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def bf16_step(x: float) -> float:
    """One bf16 step (ulp) at magnitude ``x``."""
    import math

    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def percentile(xs: list, q: float):
    """The ``q`` quantile of ``xs`` (nearest rank), or None for none."""
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def lane_record(eng, sink: list) -> None:
    """Record every finished request of a lane engine into ``sink``: prompt
    ids, generated ids, ``finish_reason``, TTFT and reused tokens.  The
    continuous engine's ``_finish_slot`` carries them; for the cycle engine
    a cycle's ``tokenize_messages`` and ``_decode_text`` calls are paired in
    order (one each per answered entry)."""
    if hasattr(eng, "_finish_slot"):
        finish = eng._finish_slot

        def finished(slot, why):
            sink.append({"prompt": list(slot.ids), "ids": list(slot.gens),
                         "finish_reason": why, "ttft_s": slot.ttft_s,
                         "reused": slot.reused, "stream": slot.sink is not None})
            return finish(slot, why)

        eng._finish_slot = finished
        return
    tokenize, decode, cycle = eng.tokenize_messages, eng._decode_text, eng._generate_batch
    seen: dict = {"prompts": [], "gens": []}

    def tok(messages):
        ids = tokenize(messages)
        seen["prompts"].append(list(ids))
        return ids

    def dec(ids):
        seen["gens"].append(list(ids))
        return decode(ids)

    def gen(batch_messages, *a, **kw):
        seen["prompts"], seen["gens"] = [], []
        out = cycle(batch_messages, *a, **kw)
        ttft = (eng.last_timings or {}).get("ttft_s")
        replies = iter(seen["gens"])
        for prompt, o in zip(seen["prompts"], out):
            if "error" in o:
                continue
            sink.append({"prompt": prompt, "ids": next(replies), "ttft_s": ttft, "reused": 0,
                         "finish_reason": o["choices"][0]["finish_reason"], "stream": False})
        return out

    eng.tokenize_messages, eng._decode_text, eng._generate_batch = tok, dec, gen


def lane_fill(eng, prompts: list) -> None:
    """Every lane prefilled with one of ``prompts`` (token ids) and set as an
    admission leaves it, greedy: what the lane checks start from.  The
    lanes' claims are dropped (their rings now hold this)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import batched_prefill
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams, seed_window

    s, B = eng._bstate, eng.batch_size
    ids = [prompts[b % len(prompts)][:700 - 40 * b] for b in range(B)]
    lengths = [len(i) for i in ids]
    tokens = torch.zeros(B, max(lengths), dtype=torch.int64)
    for b, row in enumerate(ids):
        tokens[b, :len(row)] = torch.tensor(row)
    with torch.inference_mode():
        logits = batched_prefill(eng.params, eng.cfg, tokens.cuda(), lengths, s["cache"])
        s["token"].copy_(logits.argmax(-1))
        s["pos"].copy_(torch.tensor(lengths))
        windows, wposes = zip(*(seed_window(row, "cpu") for row in ids))
        s["window"].copy_(torch.stack(windows))
        s["wpos"].copy_(torch.tensor(wposes))
        s["slots"] = list(lengths)
        for b, g in enumerate(s["gens"]):
            g.manual_seed(b)
        eng._set_knobs(SamplingParams(temperature=0.0))
    if hasattr(eng, "_lane_claims"):
        eng._lane_claims = [None] * B


def clone_lanes(state: dict) -> dict:
    """A copy of a lane state on the card: leaves, generators and mirror."""
    import torch

    out = {k: state[k].clone() for k in ("pos", "token", "window", "wpos", "out")}
    out["cache"] = {k: v.clone() for k, v in state["cache"].items()}
    out["gens"] = []
    for g in state["gens"]:
        c = torch.Generator(device=state["pos"].device)
        c.set_state(g.get_state())
        out["gens"].append(c)
    out["slots"] = list(state["slots"])
    return out


def restore_lanes(state: dict, saved: dict) -> None:
    """Copy ``saved`` (:func:`clone_lanes`) back into ``state`` in place."""
    import torch

    with torch.inference_mode():
        for k in ("pos", "token", "window", "wpos", "out"):
            state[k].copy_(saved[k])
        for k, v in saved["cache"].items():
            state["cache"][k].copy_(v)
    for g, c in zip(state["gens"], saved["gens"]):
        g.set_state(c.get_state())
    state["slots"] = list(saved["slots"])


def first_diff(a, b) -> dict | None:
    """Where two same-shaped tensors first differ (index) or None."""
    ne = (a != b).reshape(-1).nonzero()
    if not len(ne):
        return None
    import numpy as np

    return {"index": [int(i) for i in np.unravel_index(int(ne[0]), tuple(a.shape))]}


def check_lane_graph(label: str, eng, prompts: list, steps: int = 64) -> dict:
    """``steps`` replays of the engine's lane graph (chunks of its size)
    against the eager lane step on a clone of the state, every lane filled
    (:func:`lane_fill`): tokens, the bookkeeping and every ring leaf
    bit-identical, or the run fails; with the capture seconds and what one
    replay adds to the kernel counters."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import (
        generate_chunk_lanes,
        lane_step,
    )

    graphs = eng._lane_graphs
    top_k = graphs.top_k
    with eng._lock:
        lane_fill(eng, prompts)
        s = graphs.state
        eager = clone_lanes(s)
        est = {k: v.clone() for k, v in eng._lane_st.items()}
        got, replays = [], graphs.replays
        with torch.inference_mode():
            while len(got) < steps:
                n = min(eng.decode_chunk, steps - len(got))
                got += generate_chunk_lanes(eng.params, eng.cfg, s, eng._lane_st, n,
                                            top_k).rows().tolist()
            replays = graphs.replays - replays
            want = [lane_step(eng.params, eng.cfg, eager, est, top_k).tolist()
                    for _ in range(steps)]
        torch.cuda.synchronize()
        diff_tok = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        diff = {k: first_diff(s[k], eager[k]) for k in ("pos", "token", "window", "wpos",
                                                         "out")}
        diff.update({k: first_diff(v, eager["cache"][k]) for k, v in s["cache"].items()})
        diff = {k: v for k, v in diff.items() if v is not None}
        del eager
    out = {"file": label, "lanes": eng.batch_size, "steps": steps, "top_k": top_k,
           "replays": replays, "capture_s": graphs.capture_s,
           "launches_per_replay": graphs.step_launches(),
           "tokens_identical": diff_tok is None, "first_token_diff": diff_tok,
           "state_identical": not diff, "first_state_diff": diff or None}
    say("lane_graph", **out)
    if not (out["tokens_identical"] and out["state_identical"]):
        raise AssertionError(f"{label}: the lane graph is not bit-identical to the eager "
                             f"lane step: {out}")
    return out


def check_lane_isolation(label: str, eng, prompts: list, lane: int = 2) -> dict:
    """One replay of the lane graph, then the same replay with ``lane``'s
    token, slot and knobs changed: every other lane's token and ring
    leaves bit-identical, and (eager) its logits too."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward_lanes
    from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import generate_chunk_lanes
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams

    graphs, cfg = eng._lane_graphs, eng.cfg
    top_k = graphs.top_k
    others = [b for b in range(eng.batch_size) if b != lane]
    with eng._lock:
        lane_fill(eng, prompts)
        s = graphs.state
        base = clone_lanes(s)
        runs = []
        for changed in (False, True):
            restore_lanes(s, base)
            with torch.inference_mode():
                if changed:
                    s["token"][lane] = (int(s["token"][lane]) + 17) % cfg.vocab_size
                    s["pos"][lane] = int(s["pos"][lane]) - 9
                    s["slots"][lane] -= 9
                    eng._lane_st["temperature"][lane] = 1.0
                slots = s["pos"].clamp(max=cfg.n_ctx - 1)
                ring = {k: v.clone() for k, v in s["cache"].items()}
                logits = forward_lanes(eng.params, cfg, s["token"].clone(), slots, ring)
                del ring
                rows = generate_chunk_lanes(eng.params, cfg, s, eng._lane_st, 1, top_k).rows()
            runs.append((logits, rows[0], {k: v[others].clone() for k, v in s["cache"].items()}))
            eng._set_knobs(SamplingParams(temperature=0.0))
        torch.cuda.synchronize()
        (la, ta, ca), (lb, tb, cb) = runs
        out = {"file": label, "lanes": eng.batch_size, "changed_lane": lane,
               "logits_identical": bool(torch.equal(la[others], lb[others])),
               "tokens_identical": [int(ta[b]) for b in others] == [int(tb[b]) for b in others],
               "rings_identical": all(torch.equal(ca[k], cb[k]) for k in ca),
               "changed_lane_moved": bool(not torch.equal(la[lane], lb[lane]))}
        del runs, base
    say("lane_isolation", **out)
    if not (out["logits_identical"] and out["tokens_identical"] and out["rings_identical"]):
        raise AssertionError(f"{label}: a lane's change reached its neighbours: {out}")
    return out


def lane_trace(label: str, eng, prompts: list, reps: int = 16, replays: int = 4) -> dict:
    """One lane-graph replay (every lane filled): its device ms by CUDA
    events, a ``torch.profiler`` breakdown by part (:func:`replay_breakdown`),
    each fused linear of the step with its route (``tc`` or ``cuda_core``,
    ``ops._fused.route`` at the lane count) and its µs in the profile (the
    step's fused kernels in launch order, 7 a layer and the head), and the
    device ms of the step's decode attention alone: 32 layers of
    ``lane_attention`` over the lane rings, from a CUDA graph."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import lane_attention
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS, _fused
    from llama_fastapi_k8s_gpu_tpu_torch.ops.linear import _FUSED
    from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import generate_chunk_lanes

    graphs, cfg, B = eng._lane_graphs, eng.cfg, eng.batch_size
    top_k = graphs.top_k
    with eng._lock:
        lane_fill(eng, prompts)
        s = graphs.state

        def step():
            generate_chunk_lanes(eng.params, cfg, s, eng._lane_st, 1, top_k)

        with torch.inference_mode():
            step()
            replay_ms = cuda_ms(step, reps)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(replays):
                    step()
                torch.cuda.synchronize()
            kernels = sorted(((e.name, e.time_range.start, e.time_range.end)
                              for e in prof.events() if e.device_type == DeviceType.CUDA
                              and not e.name.startswith(("Memcpy", "Memset"))),
                             key=lambda k: k[1])
            attention_ms = None
            if not cfg.decode_layer_unroll:
                c = s["cache"]
                leaves = ((c["k"][:, 0], c["v"][:, 0], None, None) if "k" in c else
                          (c["k_q"][:, 0], c["v_q"][:, 0], c["k_s"][:, 0], c["v_s"][:, 0]))
                q = torch.randn(B, cfg.n_heads, cfg.head_dim, device="cuda").to(torch.bfloat16)
                slots = s["pos"].clamp(max=cfg.n_ctx - 1)
                attention_ms = cfg.n_layers * graph_ms(
                    lambda: lane_attention(q, leaves[0], leaves[1], slots, cfg, torch.bfloat16,
                                           cks=leaves[2], cvs=leaves[3]))
    names = {fn: n for n, fn in KERNELS.items()}
    layer0 = eng.params.layers[0]
    linears = {n: getattr(layer0, n) for n in STEP_LINEARS}
    linears["output"] = eng.params.output
    routes = {}
    for n, lin in linears.items():
        kernel = names.get(_FUSED.get(lin.kind))
        routes[n] = {"kind": lin.kind, "shape": [lin.n_out, lin.k_in],
                     "route": _fused.route(kernel, B, lin.k_in) if kernel else lin.kind}
    fused = [k for k in kernels if kernel_part(k[0]) == "fused_linears"]
    per_replay = len(fused) // replays if replays else 0
    if fused and per_replay == 7 * cfg.n_layers + 1:
        order = [*STEP_LINEARS * cfg.n_layers, "output"]
        for i, (_, t0, t1) in enumerate(fused):
            r = routes[order[i % per_replay]]
            r["us"] = r.get("us", 0.0) + (t1 - t0) / replays
    out = {"file": label, "lanes": B, "decode_layer_unroll": cfg.decode_layer_unroll,
           "replay_ms": replay_ms, "ms_per_token": replay_ms / B, "traced_replays": replays,
           "fused_kernels_per_replay": per_replay, "linears": routes,
           "attention_graph_ms": attention_ms,
           "attention_share": attention_ms / replay_ms if attention_ms else None,
           **(replay_breakdown(kernels, replays) if kernels else
              {"missing": "torch.profiler recorded no CUDA kernel event"})}
    say("lane_route", **out)
    return out


def serial_reply(serial, prompt: list, n: int, sp) -> list:
    """The serial engine's ``n`` generated ids for the prompt ids
    ``prompt`` under the knobs ``sp``: its own request path, its tokenizer
    bypassed."""
    got: dict = {}
    finish = serial._finish

    def finished(ctx):
        got["ids"] = list(ctx["ids"])
        return finish(ctx)

    serial._finish, serial.tokenize_messages = finished, lambda messages: list(prompt)
    try:
        serial.create_chat_completion(
            [], temperature=sp.temperature, top_p=sp.top_p, top_k=sp.top_k, min_p=sp.min_p,
            frequency_penalty=sp.frequency_penalty, presence_penalty=sp.presence_penalty,
            repeat_penalty=sp.repeat_penalty, max_tokens=n)
    finally:
        del serial._finish, serial.tokenize_messages
    return got["ids"]


def check_lane_parity(label: str, eng, records: list, settings, serial_cfg) -> dict:
    """Each distinct greedy reply of the lanes against the port's serial
    ``Engine`` on the same weights and prompt (``serial_cfg``: per-layer
    decode): the same ids, or the first differing token with the
    serial chain's top-2 margin there (:func:`chain_margin`) — a parting
    passes only where that margin is within two bf16 steps of the top
    logit (the lane step's and the verify pass's linears take another
    route than B=1's)."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

    serial = Engine.from_parts(eng.params, serial_cfg, eng.tokenizer, eng.template_kind,
                               max_gen_tokens=eng.max_gen_tokens, prefix_cache=False)
    sp = served_sampling(settings)
    rows, seen = [], set()
    try:
        for rec in records:
            key = (tuple(rec["prompt"]), tuple(rec["ids"]))
            if key in seen or not rec["ids"]:
                continue
            seen.add(key)
            want = serial_reply(serial, rec["prompt"], len(rec["ids"]), sp)
            n = min(len(want), len(rec["ids"]))
            at = next((i for i in range(n) if rec["ids"][i] != want[i]), None)
            if at is None and len(want) != len(rec["ids"]):
                at = n
            row = {"prompt_tokens": len(rec["prompt"]), "tokens": len(rec["ids"]),
                   "reused": rec.get("reused", 0), "equal": at is None}
            if at is not None:
                m = chain_margin(serial, rec["prompt"], want, at, sp)
                row.update(first_diff=at, lane=rec["ids"][at] if at < len(rec["ids"]) else None,
                           serial=want[at] if at < len(want) else None, **m,
                           near_tie=m["margin"] <= 2 * bf16_step(m["top"]))
            rows.append(row)
    finally:
        serial.close()
    out = {"file": label, "distinct_replies": len(rows),
           "equal": sum(r["equal"] for r in rows), "replies": rows,
           "all_equal_or_near_tie": all(r["equal"] or r["near_tie"] for r in rows)}
    say("lane_parity", **out)
    if not out["all_equal_or_near_tie"]:
        raise AssertionError(f"{label}: a lane reply parts from the serial engine's "
                             f"away from a near-tie: {rows}")
    return out


def lane_wave(port: int, contexts: list, stream_ctx=None) -> tuple[list, dict | None, float]:
    """``contexts`` as concurrent ``/response`` clients (and, with
    ``stream_ctx``, one ``/response/stream`` beside them): each client's
    (status, body, seconds), the stream's :func:`_sse` result, and the
    wave's wall seconds."""
    out: list = [None] * len(contexts)
    box: dict = {}

    def client(i):
        t0 = time.time()
        st, doc = _http(port, "POST", "/response", body(contexts[i]), timeout=900)
        out[i] = (st, doc, time.time() - t0)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(contexts))]
    if stream_ctx is not None:
        threads.append(threading.Thread(target=lambda: box.update(
            _sse(port, "/response/stream", body(stream_ctx), timeout=900))))
    t0 = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    return out, (box or None), time.time() - t0


def phase_lanes(label: str, layout: str, path: str, counters: dict, weight_format: str,
                kv_dtype: str, unroll: int, lanes: int, scheduler: str, clients: int,
                parts: tuple | None = None) -> tuple[dict, tuple]:
    """Serve ``path`` (or ``parts``, an earlier engine's params, config,
    tokenizer and template, not loaded again) from ``lanes`` lanes of one
    card behind the port's app (``batch_size=lanes``, ``scheduler``) and
    return each kernel's launches on that served path, and the engine's
    parts.  A wave of ``clients`` concurrent greedy ``/response`` clients
    (the short and the long prompt, 128 tokens each) — under the continuous
    scheduler beside one ``/response/stream``, then the long prompt's
    follow-up turn (lane-prefix reuse) and, on :data:`LANE_DRILLS`, a
    stream dropped after two events (its lane must free within the chunks
    in flight) and the 512-token request among 7 others at the reference's
    25 s timeout (printed, not gated); under the cycle scheduler coalesced
    into cycles.  The ``lanes`` line sums the wave up, with the lane
    graph's launches a replay and the replays the wave took: a per-layer
    int8 ring must write every lane with one ``kv_quantize`` launch a layer,
    a looped engine launch ``decode_loop`` per lane.  Then, off the served
    path, ``lane_parity``, ``lane_graph``, ``lane_isolation`` and
    ``lane_route``."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, MeshEngine
    from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import state_nbytes
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    for fn in counters.values():         # the main path starts here: count it
        fn.launches = 0
    t0 = time.time()
    cls = ContinuousEngine if scheduler == "continuous" else MeshEngine
    common = dict(batch_size=lanes, kv_dtype=kv_dtype, decode_layer_unroll=unroll,
                  max_gen_tokens=WAVE_TOKENS)
    eng = (cls(path, n_ctx=1024, weight_format=weight_format, **common) if parts is None
           else cls.from_parts(*parts, **common))
    records: list = []
    lane_record(eng, records)
    eng.warmup()
    say("lanes_load", file=label, scheduler=scheduler, lanes=lanes,
        seconds=round(time.time() - t0, 1), formats=eng.params.formats(),
        kv_dtype=eng.cfg.kv_dtype, decode_layer_unroll=eng.cfg.decode_layer_unroll,
        lane_capture_s=eng._lane_graphs.capture_s, kv_lanes_bytes=state_nbytes(eng._bstate),
        weight_gb=round(eng.weight_bytes / 1e9, 3))
    del records[:]
    n = clients
    settings = Settings(temperature=0.0, timeout_seconds=600.0, max_queue_size=2 * n,
                        batch_size=lanes, scheduler=scheduler)
    app = create_app(engine=eng, settings=settings)
    contexts = [SHORT_CTX if i % 2 == 0 else LONG_CTX for i in range(n)]
    extra: dict = {}
    replays0 = eng._lane_graphs.replays
    with serving(app) as (port, th):
        idle0 = eng.scheduler_stats().get("lane_idle_seconds", 0.0) if scheduler == "continuous" else 0
        results, stream, wave_s = lane_wave(
            port, contexts, SHORT_CTX if scheduler == "continuous" else None)
        idle = (eng.scheduler_stats()["lane_idle_seconds"] - idle0
                if scheduler == "continuous" else None)
        wave = list(records)
        metrics = _request(port, "GET", "/metrics")[2].decode()
        slices = sum(prom_samples(metrics, "prefill_slice_seconds_count").values())
        rendered = {ln.split(" ")[2] for ln in metrics.splitlines() if ln.startswith("# TYPE ")}
        want = {f if f != "scheduler_" else "scheduler_lanes_live"
                for f in LANE_FAMILIES[scheduler] if f != "mem_pressure_events_total"}
        extra["metrics_missing"] = sorted(want - rendered)
        cycles = sum(prom_samples(metrics, "batch_occupancy_count").values())
        if scheduler == "continuous":
            long_reply = next((d.get("response", "") for (st, d, _), c in zip(results, contexts)
                               if c is LONG_CTX and st == 200), "")
            follow = LONG_CTX + [("assistant", long_reply[:40]), ("user", MISTRAL_FOLLOW_UP)]
            st, _ = _http(port, "POST", "/response", body(follow), timeout=900)
            extra["follow_up"] = {"status": st, "reused": records[-1]["reused"],
                                  "prompt_tokens": len(records[-1]["prompt"])}
        if label == LANE_DRILLS:
            t_drop = abort_stream(port, body(SHORT_CTX), events=2)
            replays, freed = eng._lane_graphs.replays, None
            while time.time() - t_drop < 30:
                if eng.scheduler_stats()["lanes_live"] == 0 and not eng._items:
                    freed = time.time() - t_drop
                    break
                time.sleep(0.002)
            extra["stream_drop"] = {"lane_free_s": freed,
                                    "chunks_after_drop": (eng._lane_graphs.replays - replays)
                                    / eng.decode_chunk}
        alive = th.is_alive()
    replays = eng._lane_graphs.replays - replays0
    if label == LANE_DRILLS:
        # the 512-token request among 7 others (128 tokens each, /v1) at
        # the reference's 25 s timeout
        eng.max_gen_tokens = 512
        n_before = len(records)
        dflt = Settings(temperature=0.0, max_queue_size=16, batch_size=lanes,
                        scheduler=scheduler)
        with serving(create_app(engine=eng, settings=dflt)) as (port, _):
            others = []

            def other(i):
                others.append(_http(port, "POST", "/v1/chat/completions", {
                    "messages": [{"role": "user", "content": f"neighbour {i}: " + LONG_CTX[-1][1]}],
                    "max_tokens": WAVE_TOKENS, "temperature": 0.0}, timeout=900)[0])

            ths = [threading.Thread(target=other, args=(i,)) for i in range(7)]
            for t in ths:
                t.start()
            t_req = time.time()
            st, _ = _http(port, "POST", "/response", body(SHORT_CTX), timeout=900)
            wall = time.time() - t_req
            for t in ths:
                t.join(900)
        rec = max(records[n_before:], key=lambda r: len(r["ids"]), default={})
        say("lane_deadline", file=label, timeout_seconds=dflt.timeout_seconds, status=st,
            completion_tokens=len(rec.get("ids", [])), finish_reason=rec.get("finish_reason"),
            wall_s=wall, neighbours=sorted(others))
        eng.max_gen_tokens = WAVE_TOKENS
    launches = {name: fn.launches for name, fn in counters.items()}
    say("launches", file=label, **launches)
    silent = [n for n in LANE_KERNELS[label] if not launches[n]]
    if silent:
        raise AssertionError(f"{label}: the lanes' served path never launched {silent}")
    # what one replay of the lane graph launches: kernel 10 once a layer for
    # every lane (per-layer over the int8 ring), or the looped kernel once a
    # lane and launch
    step = eng._lane_graphs.step_launches()
    L = eng.cfg.n_layers
    want = ({"decode_loop": lanes * (L // (L if unroll < 0 else unroll))} if unroll else
            {"kv_quantize": L} if kv_dtype == "int8" else {})
    lane_launches = {"replays": replays, "per_replay": step,
                     "expected": want, "on_the_wave": {k: n * replays for k, n in step.items()}}
    ttfts = [r["ttft_s"] for r in wave if r["ttft_s"] is not None]
    tokens = sum(len(r["ids"]) for r in wave)
    lane_line = {
        "file": label, "scheduler": scheduler, "lanes": lanes, "requests": len(results),
        "statuses": [r[0] if r else None for r in results],
        "finish_reasons": [r["finish_reason"] for r in wave],
        "wave_s": wave_s, "tokens": tokens, "tokens_per_s": tokens / wave_s,
        "ttft_p50_s": percentile(ttfts, 0.5), "ttft_p95_s": percentile(ttfts, 0.95),
        "lane_idle_seconds": idle,
        "admission_slices": slices, "cycles": cycles if scheduler == "cycle" else None,
        "lane_launches": lane_launches,
        "stream": {"status": stream["status"], "events": len(stream["events"]),
                   "chars": len(sse_text(stream["events"])[0])} if stream else None,
        **extra}
    say("lanes", **lane_line)
    LANE_LINES[label] = lane_line
    bad = [r for r in results if r is None or r[0] != 200 or not (r[1] or {}).get("response")]
    if bad or not alive or (stream and stream["status"] != 200) or extra["metrics_missing"]:
        raise AssertionError(f"{label}: wave requests failed: {bad}, httpd alive {alive}, "
                             f"/metrics missing {extra['metrics_missing']}")
    if not replays or any(step.get(k) != n for k, n in want.items()) or \
            (not unroll and "decode_loop" in step) or (unroll and "kv_quantize" in step):
        raise AssertionError(f"{label}: the lane graph's launches are not the lane "
                             f"path's: {lane_launches}")
    if scheduler == "continuous" and not extra["follow_up"]["reused"]:
        raise AssertionError(f"{label}: the follow-up took no lane-prefix reuse")
    if label == LANE_DRILLS:
        # the chunk in flight, the one queued behind it, and the one whose
        # harvest sees the abandoned flag (the reference's bound, with slack)
        if extra["stream_drop"]["lane_free_s"] is None or \
                extra["stream_drop"]["chunks_after_drop"] > 4:
            raise AssertionError(f"{label}: the dropped stream's lane did not free: "
                                 f"{extra['stream_drop']}")

    # per-layer lanes against the serial engine on their own ring; looped
    # lanes against the per-layer serial engine on the bf16 ring
    serial_cfg = dataclasses.replace(eng.cfg, decode_layer_unroll=0,
                                     kv_dtype="bf16" if unroll else eng.cfg.kv_dtype)
    check_lane_parity(label, eng, wave, settings, serial_cfg)
    prompts = [wave[0]["prompt"], next(r["prompt"] for r in wave
                                       if r["prompt"] != wave[0]["prompt"])]
    check_lane_graph(label, eng, prompts)
    check_lane_isolation(label, eng, prompts)
    lane_trace(label, eng, prompts)
    eng.close()
    parts = (eng.params, eng.cfg, eng.tokenizer, eng.template_kind)
    del app, eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, parts


def phase_all_lanes(paths: dict, counters: dict, names=None, keep: dict | None = None) -> dict:
    """Each lane engine of :data:`LANES` (those in ``names``, all by
    default) served by :func:`phase_lanes` from ``paths`` (layout → file),
    an engine's weights held while a later one serves them (one that
    finds them missing loads the file); returns each kernel's launches
    summed over them.  With ``keep``, the weights of :data:`PAGED_SOURCE`
    are handed out as ``keep["parts"]`` (the paged and speculative
    phases serve them), and those of :data:`MESH_LOOPED_SOURCE` as
    ``keep["looped"]`` (the mesh phase's looped arm shards them)."""
    launches = dict.fromkeys(counters, 0)
    held: dict = {}
    for label, layout, fmt, kv_dtype, unroll, lanes, scheduler, clients, src in LANES:
        if names is not None and label not in names:
            continue
        served, parts = phase_lanes(label, layout, paths[layout], counters, fmt, kv_dtype,
                                    unroll, lanes, scheduler, clients, parts=held.pop(src, None))
        if any(row[-1] == label for row in LANES):
            held[label] = parts
        if keep is not None and label == PAGED_SOURCE:
            keep["parts"] = parts
        if keep is not None and label == MESH_LOOPED_SOURCE:
            keep["looped"] = parts
        del parts
        for name, n in served.items():
            launches[name] += n
    return launches


# ---------------------------------------------------------------------------
# the paged KV pool and prompt-lookup speculation, on the Q4_K_M weights
# ---------------------------------------------------------------------------

#: the lane engine whose weights (the Q4_K_M file's, not loaded again) the
#: paged and speculative phases serve
PAGED_SOURCE = "lanes_q4km_int8"
#: each lane engine's ``lanes`` line (its TTFTs beside the paged lanes')
LANE_LINES: dict = {}
#: token slots a pool page (the reference's default)
PAGE_TOKENS = 128
#: a second conversation that opens as SHORT_CTX does: its first message
#: and the system prompt behind it are the prefix the two share
SECOND_CTX = [("user", "hi"), ("assistant", "hello there!"),
              ("user", "what is your favourite book?")]
#: two more openings: they push the small int8 pool past its pages
PRESSURE_CTXS = [[("user", f"good evening, it is {w} here."), ("assistant", "how lovely."),
                  ("user", STORY[:100])] for w in ("raining", "snowing")]
#: a prompt that repeats itself, so prompt-lookup drafts hit
REPEAT_CTX = [("user", "say it again: " + "the boats sail by the old bridge. " * 8)]
#: the speculative phases' draft length (the reference's default)
SPEC_DRAFT = 8
#: the kernels each paged or speculative phase's served path must launch
PAGED_KERNELS = {
    "paged": ("q4k_matmul", "q6k_matmul", "flash_attention"),
    "paged_int8": ("q4k_matmul", "q6k_matmul", "kv_quantize", "flash_attention_int8"),
    "paged_lanes": ("q4k_matmul", "q6k_matmul", "flash_attention"),
    "spec": ("q4k_matmul", "q6k_matmul", "flash_attention"),
    "spec_int8": ("q4k_matmul", "q6k_matmul", "kv_quantize", "flash_attention_int8"),
    "spec_lanes": ("q4k_matmul", "q6k_matmul", "flash_attention"),
    "spec_lanes_int8": ("q4k_matmul", "q6k_matmul", "kv_quantize", "flash_attention_int8"),
}


def zero_counters(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_launches(label: str, counters: dict) -> dict:
    """The kernels' launches since :func:`zero_counters` (a ``launches``
    line); fails when a kernel of the phase's path never launched."""
    launches = {name: fn.launches for name, fn in counters.items()}
    say("launches", file=label, **launches)
    silent = [n for n in {**PAGED_KERNELS, **TIER_KERNELS}[label] if not launches[n]]
    if silent:
        raise AssertionError(f"{label}: the served path never launched {silent}")
    return launches


def serial_turns(eng, turns: list, settings, families: set | None = None) -> list:
    """Each ``(name, context)`` of ``turns`` as one ``/response`` through the
    port's app on the in-tree httpd, in order (a callable context is called
    with the rows so far): per request its status, reply text, prompt and
    generated ids, the engine's reused tokens, TTFT and spec counters.
    ``families``, when given, receives the families ``/metrics`` rendered
    after the last request."""
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app

    recs: list = []
    record_replies(eng, -1, recs)
    rows: list = []
    try:
        with serving(create_app(engine=eng, settings=settings)) as (port, _):
            for name, ctx in turns:
                if callable(ctx):
                    ctx = ctx(rows)
                n_before, t0 = len(recs), time.time()
                st, doc = _http(port, "POST", "/response", body(ctx), timeout=900)
                t = dict(eng.last_timings or {})
                rec = recs[-1] if len(recs) > n_before else {"prompt": None, "ids": []}
                rows.append({"request": name, "ctx": ctx, "status": st,
                             "reply": doc.get("response", "") if isinstance(doc, dict) else "",
                             "prompt": rec["prompt"], "ids": rec["ids"],
                             "reused_tokens": t.get("prefix_reused_tokens"),
                             "ttft_s": t.get("ttft_s"), "wall_s": time.time() - t0,
                             "spec": t.get("spec")})
            if families is not None:
                text = _request(port, "GET", "/metrics")[2].decode()
                families.update(ln.split(" ")[2] for ln in text.splitlines()
                                if ln.startswith("# TYPE "))
    finally:
        del eng._finish, eng.create_chat_completion
    return rows


def reply_parity(eng, rows: list, refs: list, sp, margin=None) -> list:
    """Each reply of ``rows`` against ``refs`` (another engine's replies,
    request by request): equal, or the first differing token with the top-2
    margin there read by ``margin`` (default :func:`top2_margin` on
    ``eng``; :func:`chain_margin` when ``eng`` is the serial engine whose
    chain gave ``refs``); a parting counts as a near-tie within two bf16
    steps of the top logit."""
    out = []
    for r, ref in zip(rows, refs):
        row = {"request": r["request"], "same_prompt": r["prompt"] == ref["prompt"],
               "tokens": len(r["ids"]), "equal": r["ids"] == ref["ids"]}
        if row["same_prompt"] and not row["equal"]:
            n = min(len(r["ids"]), len(ref["ids"]))
            at = next((i for i in range(n) if r["ids"][i] != ref["ids"][i]), n)
            m = (margin or top2_margin)(eng, ref["prompt"], ref["ids"], at, sp)
            row.update(first_diff=at, got=r["ids"][at] if at < len(r["ids"]) else None,
                       want=ref["ids"][at] if at < len(ref["ids"]) else None, **m,
                       near_tie=m["margin"] <= 2 * bf16_step(m["top"]))
        out.append(row)
    return out


def parity_holds(rows: list) -> bool:
    """Every reply equal, or parting at a near-tie (or after an earlier
    reply parted, when the prompts differ)."""
    return all(r["equal"] or not r["same_prompt"] or r.get("near_tie") for r in rows)


def follow_up_of(ref_rows: list | None = None):
    """The follow-up turn's context: the long conversation with the first 40
    characters of its reply (from ``ref_rows``, else the rows it is given)."""
    def ctx(rows):
        long = next(r for r in (ref_rows or rows) if r["request"] == "long")
        return LONG_CTX + [("assistant", long["reply"][:40]), ("user", MISTRAL_FOLLOW_UP)]
    return ctx


def pool_moves(eng, ids: list, pages: int = 4, reps: int = 20) -> dict:
    """The device copies of a prefix hit and of a commit, ``pages`` pages of
    ``ids``' cached prefix: a restore into a scratch ring
    (``KVPool.restore``) and a page store back into the same pages, each
    in ms by CUDA events beside the byte bound (each byte read once and
    written once), and the restored bytes against the arena's."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.parallel import kvpool

    pool = eng._kvpool
    T = pool.page_tokens
    lease = pool.acquire(ids, pages * T)
    if lease is None:
        raise AssertionError(f"the pool holds no {pages} pages of these ids")
    ring = {k: torch.zeros_like(v) for k, v in eng._cache.items()}
    try:
        restore_ms = cuda_ms(lambda: pool.restore(lease, ring), reps)
        store_ms = cuda_ms(lambda: kvpool._store_pages(pool.arena, ring, lease.page_ids, 0), reps)
        idx = torch.tensor(lease.page_ids, device=eng.device)
        equal = all(torch.equal(kvpool._token_block(ring[k], 0, pages, T), a[idx])
                    for k, a in pool.arena.items())
        runs = len(kvpool._runs(lease.page_ids))
    finally:
        pool.release(lease)
    nbytes = 2 * pages * pool.page_nbytes
    return {"pages": pages, "page_bytes": pool.page_nbytes, "runs": runs,
            "restore_ms": restore_ms, "store_ms": store_ms,
            "bound_ms": nbytes / HBM_BPS * 1e3, "bound_by": "bytes",
            "restored_equal": equal}


def export_prefix(pool, ids: list) -> list:
    """Host copies of the pages that cover ``ids``' cached whole-page prefix
    (one token left to prefill)."""
    T = pool.page_tokens
    r = (min(pool.match_len(ids), len(ids) - 1) // T) * T
    lease = pool.acquire(ids, r)
    if lease is None:
        raise AssertionError("the pool holds none of these ids' pages")
    try:
        return pool.export_pages(lease)
    finally:
        pool.release(lease)


@contextlib.contextmanager
def always_hit_drafts():
    """Every prompt-lookup draft is the last token repeated (the draft of
    the reference's tests/test_spec_decode.py greedy-parity case): each
    round verifies a draft, which greedy decoding mostly rejects."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

    saved = Engine.__dict__["_lookup_draft"]
    Engine._lookup_draft = staticmethod(lambda history, D, max_ngram=3: [history[-1]] * D)
    try:
        yield
    finally:
        Engine._lookup_draft = saved


def phase_paged(parts: tuple, counters: dict) -> dict:
    """``paged``: the Q4_K_M weights, serial, bf16 ring, n_ctx 1024, pages of
    128.  The short request, the long one, its follow-up and a second
    conversation that opens as the short one does (its first message and
    the system prompt behind it shared), through the app — first on a dense
    engine (the prefix claim), then on a paged one: reused tokens and TTFT
    per request beside the dense engine's, the pool's occupancy, the ms of
    a 4-page restore and store, and where each greedy reply parts from the
    dense engine's, with the margin there.  Then a restore into the
    captured ring held to the eager step (``restored_graph``)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.obs import memledger as _memledger
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    settings = Settings(temperature=0.0, timeout_seconds=600.0)
    sp = served_sampling(settings)
    dense = Engine.from_parts(*parts, kv_dtype="bf16", max_gen_tokens=WAVE_TOKENS)
    dense.warmup()
    turns = [("short", SHORT_CTX), ("long", LONG_CTX), ("follow_up", follow_up_of()),
             ("second", SECOND_CTX)]
    want = serial_turns(dense, turns, settings)
    dense.close()
    del dense
    gc.collect()
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()    # the weights and what came before
    t0 = time.time()
    eng = Engine.from_parts(*parts, kv_dtype="bf16", kv_paged=True, kv_page_tokens=PAGE_TOKENS,
                            max_gen_tokens=WAVE_TOKENS)
    eng.warmup()
    load_s = time.time() - t0
    zero_counters(counters)
    turns[2] = ("follow_up", follow_up_of(want))
    families: set = set()
    got = serial_turns(eng, turns, settings, families)
    launches = read_launches("paged", counters)
    occ = eng.kv_pool_occupancy()
    parity = reply_parity(eng, got, want, sp)
    moves = pool_moves(eng, got[2]["prompt"])
    gc.collect()                      # the dense engine's rows go with it
    mem = _memledger.MEMLEDGER.snapshot()
    # the residual less what the card held before this engine beyond its
    # (shared) weights: the paged engine's own unattributed bytes
    before = allocated_before - eng.weight_bytes
    memory = {"residual_bytes": mem.get("residual_bytes"), "allocated_before_engine": before,
              "engine_residual_bytes": (mem["residual_bytes"] - before
                                        if mem.get("residual_bytes") is not None else None),
              "rows": {f"{r['component']}:{r['model']}": r["bytes"]
                       for r in mem.get("components", [])
                       if r["component"] in ("kv_arena_used", "kv_arena_free", "kv_ring")}}
    out = {"file": "paged", "kv_dtype": "bf16", "page_tokens": PAGE_TOKENS, "setup_s": load_s,
           "requests": [{"request": g["request"], "status": g["status"],
                         "prompt_tokens": len(g["prompt"] or []),
                         "reused_tokens": g["reused_tokens"], "ttft_s": g["ttft_s"],
                         "dense_reused_tokens": w["reused_tokens"], "dense_ttft_s": w["ttft_s"]}
                        for g, w in zip(got, want)],
           "occupancy": occ, "moves": moves, "memory": memory, "parity": parity,
           "families_missing": [f for f in ("kv_pool_pages_used", "kv_pool_pages_free",
                                            "prefix_cache_misses_total", "prefix_cache_hits_total",
                                            "prefix_reuse_tokens") if f not in families]}
    say("paged", **out)
    check_graph("paged", eng, got[3]["prompt"], steps=32, restore=True)
    eng.close()
    bad = [r["request"] for r in got if r["status"] != 200]
    if bad or not got[2]["reused_tokens"] or not got[3]["reused_tokens"] \
            or occ["pages_pinned"] or not moves["restored_equal"] or not parity_holds(parity) \
            or out["families_missing"]:
        raise AssertionError(f"paged: failed requests {bad}, or no radix reuse on the "
                             f"follow-up / the second conversation, pinned pages, unequal "
                             f"restored bytes, or a reply parting away from a near-tie: {out}")
    return launches


def phase_paged_int8(parts: tuple, counters: dict) -> dict:
    """``paged_int8``: the same weights over the int8 ring (kernels 10 and 5
    int8), the pool one context's pages (8) with a 16-page host spill tier.
    The long request and its follow-up, the follow-up's cached pages
    exported, two other conversations that push the long one's pages to
    the host, then the follow-up again: its pages restored from the host,
    byte-equal to the export, and its reply equal to the first one's (no
    pressure then)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    settings = Settings(temperature=0.0, timeout_seconds=600.0)
    eng = Engine.from_parts(*parts, kv_dtype="int8", kv_paged=True, kv_page_tokens=PAGE_TOKENS,
                            kv_pool_pages=1024 // PAGE_TOKENS, kv_spill_pages=16,
                            max_gen_tokens=WAVE_TOKENS)
    eng.warmup()
    pool = eng._kvpool
    zero_counters(counters)
    first = serial_turns(eng, [("long", LONG_CTX), ("follow_up", follow_up_of())], settings)
    before = export_prefix(pool, first[1]["prompt"])
    later = serial_turns(eng, [("pressure_0", PRESSURE_CTXS[0]), ("pressure_1", PRESSURE_CTXS[1]),
                               ("follow_up_again", first[1]["ctx"])], settings)
    after = export_prefix(pool, first[1]["prompt"])
    launches = read_launches("paged_int8", counters)
    stats, occ = pool.stats(), pool.occupancy()
    equal = len(before) == len(after) and all(
        torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(before, after))
    rows = first + later
    out = {"file": "paged_int8", "kv_dtype": "int8", "pool_pages": pool.n_pages,
           "spill_pages": pool.spill_pages, "page_bytes": pool.page_nbytes,
           "requests": [{"request": r["request"], "status": r["status"],
                         "prompt_tokens": len(r["prompt"] or []),
                         "reused_tokens": r["reused_tokens"], "ttft_s": r["ttft_s"]} for r in rows],
           "spills": stats["spills"], "restores": stats["restores"],
           "evictions": stats["evictions"], "exported_pages": before[0].shape[0],
           "restored_bytes_equal": equal,
           "reply_equal_to_unpressured": later[2]["ids"] == first[1]["ids"],
           "occupancy": occ}
    say("paged_int8", **out)
    eng.close()
    bad = [r["request"] for r in rows if r["status"] != 200]
    if bad or not stats["spills"] or not stats["restores"] or not equal \
            or not out["reply_equal_to_unpressured"] or occ["pages_pinned"]:
        raise AssertionError(f"paged_int8: failed requests {bad}, or no spill and restore, "
                             f"restored bytes unequal, a reply that changed under pressure, "
                             f"or pinned pages: {out}")
    return launches


def phase_paged_lanes(parts: tuple, counters: dict) -> dict:
    """``paged_lanes``: the same weights from 4 lanes under the continuous
    scheduler with the paged pool; eight concurrent clients whose
    conversations open alike (the first message and the system prompt):
    cross-lane radix hits, TTFT p50/p95 beside ``lanes_q4km``'s, and no
    page pinned and no admission in flight at the end."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    lanes = 4
    eng = ContinuousEngine.from_parts(*parts, batch_size=lanes, kv_dtype="bf16", kv_paged=True,
                                      kv_page_tokens=PAGE_TOKENS, max_gen_tokens=WAVE_TOKENS)
    eng.warmup()
    records: list = []
    lane_record(eng, records)
    settings = Settings(temperature=0.0, timeout_seconds=600.0, max_queue_size=16,
                        batch_size=lanes)
    contexts = [[LONG_CTX[0], ("assistant", "go on, I am listening."),
                 ("user", f"part {i}: " + STORY[:80])] for i in range(8)]
    hits0 = eng.scheduler_stats().get("radix_prefix_hits", 0)
    zero_counters(counters)
    with serving(create_app(engine=eng, settings=settings)) as (port, _):
        results, _, wave_s = lane_wave(port, contexts)
    launches = read_launches("paged_lanes", counters)
    stats, occ = eng.scheduler_stats(), eng.kv_pool_occupancy()
    ttfts = [r["ttft_s"] for r in records if r["ttft_s"] is not None]
    base = LANE_LINES.get("lanes_q4km", {})
    out = {"file": "paged_lanes", "lanes": lanes, "clients": len(contexts),
           "statuses": [r[0] if r else None for r in results], "wave_s": wave_s,
           "radix_prefix_hits": stats.get("radix_prefix_hits", 0) - hits0,
           "reused_per_request": [r["reused"] for r in records],
           "ttft_p50_s": percentile(ttfts, 0.5), "ttft_p95_s": percentile(ttfts, 0.95),
           "lanes_q4km_ttft_p50_s": base.get("ttft_p50_s"),
           "lanes_q4km_ttft_p95_s": base.get("ttft_p95_s"),
           "pages_pinned": occ["pages_pinned"], "admission_in_flight": eng._adm is not None,
           "occupancy": occ}
    say("paged_lanes", **out)
    eng.close()
    if any(st != 200 for st in out["statuses"]) or out["radix_prefix_hits"] < 1 \
            or out["pages_pinned"] or out["admission_in_flight"]:
        raise AssertionError(f"paged_lanes: failed requests, no cross-lane radix hit, or a "
                             f"lease left behind: {out}")
    return launches


def verify_trace(eng, ids: list, reps: int = 20, replays: int = 4) -> dict:
    """The verify round on the card: device ms of one replay of its graph,
    of the eager verify and of one decode replay (CUDA events, from
    ``ids`` prefilled), and each fused linear's route at D+1 rows with its
    µs in a profile of the verify replay (7 a layer and the head)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import first_sample, prefill, spec_verify
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS, _fused
    from llama_fastapi_k8s_gpu_tpu_torch.ops.linear import _FUSED
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams, sampling_tensors

    graphs, cfg, k = eng._graphs, eng.cfg, SamplingParams().top_k
    D = SPEC_DRAFT
    with eng._lock, torch.inference_mode():
        logits = prefill(eng.params, cfg, torch.tensor(ids, device=eng.device), len(ids),
                         eng._cache)
        st = graphs.knobs(sampling_tensors(SamplingParams(temperature=0.0), eng.device))

        def reset():
            first_sample(logits, graphs.state(ids, 0), st)

        graphs.capture_verify(k)
        graphs._draft.copy_(torch.tensor(ids[-D:]))
        vgraph, dgraph = graphs._verify[k][0], graphs._graphs[k][0]
        reset()
        graph_ms = cuda_ms(vgraph.replay, reps)
        reset()
        eager_ms = cuda_ms(lambda: spec_verify(eng.params, cfg, graphs._state, st,
                                               graphs._draft, k), reps)
        reset()
        decode_ms = cuda_ms(dgraph.replay, reps)
        reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                vgraph.replay()
            torch.cuda.synchronize()
        eng._prefix_ids = []
    kernels = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))), key=lambda x: x[1])
    names = {fn: n for n, fn in KERNELS.items()}
    layer0 = eng.params.layers[0]
    linears = {n: getattr(layer0, n) for n in STEP_LINEARS}
    linears["output"] = eng.params.output
    routes = {}
    for n, lin in linears.items():
        kernel = names.get(_FUSED.get(lin.kind))
        routes[n] = {"kind": lin.kind, "shape": [lin.n_out, lin.k_in],
                     "route": _fused.route(kernel, D + 1, lin.k_in) if kernel else lin.kind}
    # the fused kernels of the last whole replays in launch order, 7 a layer
    # and the head (a trace may drop an event at its start)
    fused = [x for x in kernels if kernel_part(x[0]) == "fused_linears"]
    per = 7 * cfg.n_layers + 1
    whole = min(len(fused) // per, replays)
    if whole:
        order = [*STEP_LINEARS * cfg.n_layers, "output"]
        for i, (_, t0, t1) in enumerate(fused[len(fused) - whole * per:]):
            r = routes[order[i % per]]
            r["us"] = r.get("us", 0.0) + (t1 - t0) / whole
    return {"rows": D + 1, "verify_graph_ms": graph_ms, "verify_eager_ms": eager_ms,
            "decode_graph_ms": decode_ms, "verify_over_decode": graph_ms / decode_ms,
            "fused_kernels_traced": len(fused), "whole_replays": whole, "linears": routes,
            **(replay_breakdown(kernels, replays) if kernels else
               {"missing": "torch.profiler recorded no CUDA kernel event"})}


def check_verify_graph(label: str, eng, ref: dict, rounds: int = 8) -> dict:
    """Verify rounds by graph replay against the eager verify: ``ref``'s
    prompt prefilled, the ring cloned, then ``rounds`` greedy rounds on
    both from the same first sample, each drafting :func:`oracle_draft` of
    ``ref`` (the vanilla reply: whole rounds accepted until the chains
    part, always-hit rounds after).  Emitted tokens, counts and every ring
    leaf must be bit-identical, and some round must emit more than one
    token (``verify_graph``)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import (
        first_sample,
        init_state,
        prefill,
        spec_verify,
    )
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams, sampling_tensors

    graphs, k, D = eng._graphs, SamplingParams().top_k, SPEC_DRAFT
    ids = ref["prompt"]
    sp = SamplingParams(temperature=0.0)
    with eng._lock, torch.inference_mode():
        cache = eng._cache
        logits = prefill(eng.params, eng.cfg, torch.tensor(ids, device=eng.device), len(ids),
                         cache)
        ring = {n: v.clone() for n, v in cache.items()}
        st = graphs.knobs(sampling_tensors(sp, eng.device))
        state = graphs.state(ids, 0)
        eager = init_state(ring, ids, 0, eng.device)
        est = sampling_tensors(sp, eng.device)
        hist_g = [int(first_sample(logits, state, st))]
        hist_e = [int(first_sample(logits, eager, est))]
        got, want = [], []
        for _ in range(rounds):
            toks, n = graphs.verify(state, st, oracle_draft([ref], ids + hist_g, D), k)
            got.append((toks, n))
            hist_g += toks
            draft = oracle_draft([ref], ids + hist_e, D)
            t, c = spec_verify(eng.params, eng.cfg, eager, est,
                               torch.tensor(draft, device=eng.device), k)
            c = int(c)
            want.append((t[:c].tolist(), c))
            hist_e += t[:c].tolist()
        torch.cuda.synchronize()
        cache_equal = all(torch.equal(cache[n], ring[n]) for n in cache)
        eng._prefix_ids = []
    out = {"file": label, "rounds": rounds, "draft": D, "kv_dtype": eng.cfg.kv_dtype,
           "capture_s": graphs.verify_captures, "counts": [n for _, n in got],
           "tokens_identical": got == want, "cache_identical": cache_equal,
           "verify_launches": graphs.verify_launches(k)}
    say("verify_graph", **out)
    if not (out["tokens_identical"] and cache_equal) or max(out["counts"]) < 2:
        raise AssertionError(f"{label}: the verify graph is not bit-identical to the eager "
                             f"verify, or no round accepted a draft: {out}, eager {want}")
    return out


def ring_diff(a: dict, b: dict, lo: int, hi: int) -> dict:
    """Ring slots ``lo:hi`` of two rings, leaf by leaf, for layer 0 and for
    all layers: the share of values that differ and the largest difference
    (int8 codes in codes, bf16 K/V and f32 scales relative to the largest
    magnitude of ``a``'s slice)."""
    import torch

    out = {}
    for k in a:
        x, y = a[k][:, :, lo:hi], b[k][:, :, lo:hi]      # the token axis is axis 2
        row = {}
        for where, (u, v) in (("layer0", (x[0], y[0])), ("all", (x, y))):
            if u.dtype == torch.int8:
                d = (u.int() - v.int()).abs()
                row[where] = {"share_differs": (d != 0).float().mean().item(),
                              "max_code_diff": int(d.max())}
            else:
                d = (u.float() - v.float()).abs()
                row[where] = {"share_differs": (d != 0).float().mean().item(),
                              "max_rel_diff": (d.max() / u.float().abs().max()).item()}
        out[k] = row
    return out


def route_noise(eng, prompt: list, ids: list, D: int = SPEC_DRAFT) -> dict:
    """How far the verify pass's arithmetic moves the logits and the ring
    from the decode step's, teacher-forced on one token sequence:
    ``prompt`` prefilled once, then the tokens ``ids`` fed three ways over
    copies of that ring — one-row decode steps (the vanilla path), D+1-row
    verify passes of each token and its always-hit draft that advance one
    slot (every draft rejected), and D+1-row passes of ``ids`` itself that
    advance D+1 slots (every draft accepted).  For each verify history,
    over the positions: the decode logits' top-2 gap minus the verify
    logits' gap between the same two tokens, in bf16 steps of the top logit
    (``gap_steps`` max / p95 / p50), the positions whose argmax differs and
    the largest logit difference; and :func:`ring_diff` of the slots the
    tokens wrote (layer 0's input is the token's embedding, so there only
    the linears' route differs).  ``decode_margin_steps_min`` is the
    smallest top-2 gap of the decode history itself, in the same steps."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import prefill
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward

    params, cfg, dev = eng.params, eng.cfg, eng.device
    vcfg = dataclasses.replace(cfg, attn_impl="xla")     # as spec_verify swaps it
    n, m = len(prompt), (len(ids) - 1) // (D + 1) * (D + 1)
    tok = torch.tensor(ids, device=dev)
    logits = {}
    with eng._lock, torch.inference_mode():
        base = {k: torch.zeros_like(v) for k, v in eng._cache.items()}
        prefill(params, cfg, torch.tensor(prompt, device=dev), n, base)
        rings = {h: {k: v.clone() for k, v in base.items()}
                 for h in ("decode", "rejected", "accepted")}
        del base
        at = [torch.tensor(n + t, device=dev) for t in range(m)]
        logits["decode"] = torch.stack([forward(params, cfg, tok[t:t + 1], at[t],
                                                rings["decode"]) for t in range(m)])
        logits["rejected"] = torch.stack([
            forward(params, vcfg, tok[t].repeat(D + 1), at[t], rings["rejected"],
                    return_all=True)[0] for t in range(m)])
        logits["accepted"] = torch.cat([
            forward(params, vcfg, tok[t:t + D + 1], at[t], rings["accepted"], return_all=True)
            for t in range(0, m, D + 1)])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dec = logits["decode"]
        top = dec.topk(2, dim=-1)
        a, b = top.indices[:, :1], top.indices[:, 1:]
        steps = torch.tensor([bf16_step(x) for x in top.values[:, 0].tolist()])
        gap = (top.values[:, 0] - top.values[:, 1]).cpu()
        out = {"positions": m, "draft": D, "kv_dtype": cfg.kv_dtype,
               "decode_margin_steps_min": (gap / steps).min().item()}
        for h in ("rejected", "accepted"):
            x = logits[h]
            d = ((gap - (x.gather(1, a) - x.gather(1, b))[:, 0].cpu()).abs() / steps).sort()
            out[h] = {"gap_steps_max": d.values[-1].item(),
                      "gap_steps_p95": d.values[int(0.95 * (m - 1))].item(),
                      "gap_steps_p50": d.values[(m - 1) // 2].item(),
                      "argmax_differs": int((x.argmax(-1) != dec.argmax(-1)).sum()),
                      "max_abs_logit_diff": (x - dec).abs().max().item(),
                      "ring": ring_diff(rings["decode"], rings[h], n, n + m)}
        eng._prefix_ids = []
    return out


def oracle_draft(refs: list, history: list, D: int) -> list:
    """The vanilla engine's greedy continuation as a draft: for a history
    that is one of ``refs``' prompts followed by the start of its reply
    (``{"prompt", "ids"}``), the reply's next ``D`` tokens (zero-padded, as
    the lookup pads); past a parting or the reply's end, or for another
    prompt, the last token repeated (the always-hit draft)."""
    for ref in refs:
        p, k = ref["prompt"], len(history) - len(ref["prompt"])
        if 0 < k < len(ref["ids"]) and history[:len(p)] == p \
                and history[len(p):] == ref["ids"][:k]:
            cont = ref["ids"][k:k + D]
            return cont + [0] * (D - len(cont))
    return [history[-1]] * D


@contextlib.contextmanager
def oracle_drafts(refs: list):
    """Every prompt-lookup draft is :func:`oracle_draft`'s: each round the
    verify accepts what agrees with vanilla greedy decoding, so rounds
    emit D+1 tokens until a reply parts, and always-hit rounds after."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

    saved = Engine.__dict__["_lookup_draft"]
    Engine._lookup_draft = staticmethod(
        lambda history, D, max_ngram=3: oracle_draft(refs, history, D))
    try:
        yield
    finally:
        Engine._lookup_draft = saved


def phase_spec(parts: tuple, counters: dict, kv_dtype: str = "bf16") -> dict:
    """``spec`` (the bf16 ring) or ``spec_int8`` (the int8 ring: kernel 10
    writes each verify pass's D+1 rows): the Q4_K_M weights, serial,
    ``spec_decode=lookup``, D = 8, through the app.  First the vanilla
    engine over the same ring serves the long prompt: its greedy reply is
    the oracle draft's source (:func:`oracle_drafts`).  Then the
    speculating engine serves, on the bf16 ring, a repetitive prompt
    (organic lookup hits), and on both the short prompt under the
    always-hit draft and the long one under the oracle draft (whole rounds
    accepted until the reply parts).  Verify steps, drafted and accepted
    per request; each reply against the vanilla engine's greedy reply
    (where it parts, the vanilla chain's own margin there,
    :func:`chain_margin`); the verify graph held to the eager verify under
    oracle drafts (``verify_graph``).  On the bf16
    ring also the verify round's ms from its graph and eager beside a
    decode token's, each fused linear's route and µs at 9 rows, and
    ``spec_auto``'s decision record on this card."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.engine.spec_auto import resolve_auto
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    label = "spec" if kv_dtype == "bf16" else f"spec_{kv_dtype}"
    settings = Settings(temperature=0.0, timeout_seconds=600.0)
    sp = served_sampling(settings)
    vanilla = Engine.from_parts(*parts, kv_dtype=kv_dtype, prefix_cache=False,
                                max_gen_tokens=WAVE_TOKENS)
    vanilla.warmup()
    refs = serial_turns(vanilla, [("oracle", LONG_CTX)], settings)
    t0 = time.time()
    eng = Engine.from_parts(*parts, kv_dtype=kv_dtype, spec_decode="lookup",
                            spec_draft=SPEC_DRAFT, max_gen_tokens=WAVE_TOKENS)
    eng.warmup()
    setup_s = time.time() - t0
    zero_counters(counters)
    families: set = set()
    rows = serial_turns(eng, [("repeat", REPEAT_CTX)], settings) if kv_dtype == "bf16" else []
    with always_hit_drafts():
        rows += serial_turns(eng, [("always_hit", SHORT_CTX)], settings)
    with oracle_drafts(refs):
        rows += serial_turns(eng, [("oracle", LONG_CTX)], settings, families)
    launches = read_launches(label, counters)
    want = [{"prompt": r["prompt"], "ids": serial_reply(vanilla, r["prompt"], len(r["ids"]), sp)}
            for r in rows]
    parity = reply_parity(vanilla, rows, want, sp, chain_margin)
    by = {r["request"]: r for r in rows}
    vanilla.close()
    del vanilla
    out = {"file": label, "kv_dtype": kv_dtype, "draft": SPEC_DRAFT, "setup_s": setup_s,
           "verify_capture_s": eng._graphs.verify_captures,
           "verify_launches": eng._graphs.verify_launches(SamplingParams().top_k),
           "requests": [{"request": r["request"], "status": r["status"],
                         "prompt_tokens": len(r["prompt"] or []), "tokens": len(r["ids"]),
                         "ttft_s": r["ttft_s"], "wall_s": r["wall_s"], **(r["spec"] or {})}
                        for r in rows],
           "parity": parity,
           "families_missing": [f for f in SPEC_FAMILIES if f not in families]}
    if kv_dtype == "bf16":
        out.update(spec_auto=resolve_auto(eng.params)[1],
                   timing=verify_trace(eng, by["always_hit"]["prompt"]))
    say(label, **out)
    check_verify_graph(label, eng, refs[0])
    eng.close()
    bad = [r["request"] for r in rows if r["status"] != 200]
    if kv_dtype == "int8" and out["verify_launches"].get("kv_quantize") != eng.cfg.n_layers:
        raise AssertionError(f"{label}: a verify replay does not write the int8 ring through "
                             f"kernel 10 once a layer: {out['verify_launches']}")
    if bad or not (by["always_hit"]["spec"] or {}).get("verify_steps") \
            or not (by["oracle"]["spec"] or {}).get("accepted") or not parity_holds(parity) \
            or out["families_missing"]:
        raise AssertionError(f"{label}: failed requests {bad}, no verify round under the "
                             f"always-hit draft, no accepted draft under the oracle, or a "
                             f"reply parting away from a near-tie: {out}")
    return launches


def phase_spec_lanes(parts: tuple, counters: dict, kv_dtype: str = "bf16") -> dict:
    """``spec_lanes`` (the bf16 ring) or ``spec_lanes_int8`` (the int8 lane
    rings: kernel 10 writes each lane's D+1 verify rows): the same weights
    from 4 lanes under the continuous scheduler with ``spec_decode=lookup``,
    D = 8.  The vanilla serial engine over the same ring serves the short
    and the long prompt first; then four concurrent clients — the
    repetitive prompt twice (always-hit drafts), the short and the long
    one (oracle drafts of those vanilla replies: lanes whose rounds emit
    D+1 tokens beside lanes whose rounds emit one).  The lanes' spec
    counters (some draft must be accepted), then each greedy reply against
    the serial vanilla engine's (``lane_parity``)."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    label = "spec_lanes" if kv_dtype == "bf16" else f"spec_lanes_{kv_dtype}"
    lanes = 4
    settings = Settings(temperature=0.0, timeout_seconds=600.0, max_queue_size=16,
                        batch_size=lanes)
    vanilla = Engine.from_parts(*parts, kv_dtype=kv_dtype, prefix_cache=False,
                                max_gen_tokens=WAVE_TOKENS)
    vanilla.warmup()
    refs = serial_turns(vanilla, [("short", SHORT_CTX), ("long", LONG_CTX)], settings)
    vanilla.close()
    del vanilla
    eng = ContinuousEngine.from_parts(*parts, batch_size=lanes, kv_dtype=kv_dtype,
                                      spec_decode="lookup", spec_draft=SPEC_DRAFT,
                                      max_gen_tokens=WAVE_TOKENS)
    eng.warmup()
    records: list = []
    lane_record(eng, records)
    spec0 = dict(eng.scheduler_stats()["spec"])
    zero_counters(counters)
    with oracle_drafts(refs), serving(create_app(engine=eng, settings=settings)) as (port, _):
        results, _, wave_s = lane_wave(port, [REPEAT_CTX, SHORT_CTX, LONG_CTX, REPEAT_CTX])
    launches = read_launches(label, counters)
    spec = {k: v - spec0.get(k, 0) for k, v in eng.scheduler_stats()["spec"].items()}
    out = {"file": label, "kv_dtype": kv_dtype, "lanes": lanes, "draft": SPEC_DRAFT,
           "statuses": [r[0] if r else None for r in results], "wave_s": wave_s,
           "tokens": sum(len(r["ids"]) for r in records), "spec": spec,
           "verify_capture_s": eng._lane_graphs.verify_capture_s,
           "verify_replays": eng._lane_graphs.verify_replays,
           "verify_launches": eng._lane_graphs.verify_launches()}
    say(label, **out)
    writes = out["verify_launches"].get("kv_quantize", 0)
    if any(st != 200 for st in out["statuses"]) or not spec["verify_steps"] \
            or not spec["accepted"] or (kv_dtype == "int8") != (writes >= eng.cfg.n_layers):
        raise AssertionError(f"{label}: failed requests, no verify round, no accepted "
                             f"draft, or int8 verify rows not written by kernel 10: {out}")
    check_lane_parity(label, eng, records, settings, eng.cfg)
    eng.close()
    return launches


def phase_paged_spec(parts: tuple, counters: dict) -> dict:
    """The paged and speculative phases on ``parts`` (the Q4_K_M weights);
    returns each kernel's launches summed over their served paths."""
    import torch

    launches = dict.fromkeys(counters, 0)
    for phase in (phase_paged, phase_paged_int8, phase_paged_lanes, phase_spec,
                  functools.partial(phase_spec, kv_dtype="int8"), phase_spec_lanes,
                  functools.partial(phase_spec_lanes, kv_dtype="int8")):
        for name, n in phase(parts, counters).items():
            launches[name] += n
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# multi-model serving (LFKT_MODELS) and disaggregated prefill/decode
# ---------------------------------------------------------------------------

#: tokens a reply of the registry and disagg phases (greedy, compared byte for
#: byte across engines)
TIER_TOKENS = 64
#: the kernels each phase's served path must launch (its loads included)
TIER_KERNELS = {
    "registry": ("dequant_q4_k", "dequant_q6_k", "q4k_matmul", "q6k_matmul", "flash_attention"),
    "registry_looped": ("decode_loop", "flash_attention"),
    "registry_lanes": ("q4k_matmul", "q6k_matmul", "flash_attention"),
    "disagg": ("dequant_q4_k", "q4k_matmul", "q6k_matmul", "flash_attention"),
    "disagg_lanes": ("q4k_matmul", "q6k_matmul", "flash_attention"),
    "fleet": ("dequant_q4_k", "q4k_matmul", "q6k_matmul", "flash_attention"),
}
#: a raw /v1 user message (no system prompt)
V1_MSG = "Tell me about the river and the boats on it."
#: the families only a registry or a disagg role renders (the tier phases)
TIER_FAMILIES = ("disagg_prefills_served_total", "disagg_pages_sent_total",
                 "disagg_bytes_sent_total", "disagg_remote_prefills_total",
                 "disagg_pages_received_total", "disagg_bytes_received_total",
                 "disagg_local_fallbacks_total", "disagg_handshake_refusals_total",
                 "disagg_transfer_seconds", "disagg_peer_connected", "model_reloads_total")
#: the families only the fleet router or a migrating replica renders (the
#: fleet phases)
FLEET_FAMILIES = ("fleet_requests_total", "fleet_spills_total", "fleet_peer_ejections_total",
                  "fleet_peers_healthy", "fleet_proxy_seconds", "fleet_probe_seconds",
                  "kv_migration_pulls_total", "kv_migration_pushes_total",
                  "kv_migration_pages_total", "kv_migration_failures_total",
                  "kv_migration_seconds")


def tier_settings(**kw):
    """The registry and disagg phases' pod settings: greedy, paged pool of
    128-token pages, n_ctx 1024, :data:`TIER_TOKENS` a reply."""
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    base = dict(temperature=0.0, timeout_seconds=600.0, max_queue_size=16, kv_paged=True,
                kv_page_tokens=PAGE_TOKENS, max_gen_tokens=TIER_TOKENS)
    return Settings(**{**base, **kw})


@contextlib.contextmanager
def served_settings(settings, port: int | None = None, tracer=None):
    """The port's app built from ``settings`` alone — the engine (or the
    registry) loaded by its own startup, as a pod starts — on the in-tree
    httpd (at ``port``, else a free one; ``tracer`` the app's own, else the
    process's): yields (port, app, startup seconds); closes the engines
    after."""
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app

    app = create_app(settings=settings, tracer=tracer)
    t0 = time.time()
    try:
        with serving(app, port) as (port, _):
            yield port, app, time.time() - t0
    finally:
        eng = app.state.engine
        app.state.engine = None
        if eng is not None:
            (getattr(eng, "close", None) or eng.shutdown)()
        del eng, app
        gc.collect()


def model_body(ctx: list, model: str | None) -> dict:
    b = body(ctx)
    if model is not None:
        b["model"] = model
    return b


def v1_body(model: str | None, content: str = V1_MSG, **kw) -> dict:
    out = {"messages": [{"role": "user", "content": content}], "max_tokens": TIER_TOKENS,
           "temperature": 0.0, **kw}
    if model is not None:
        out["model"] = model
    return out


def registry_turns(port: int, eng_of, alias: str | None, turns=("short", "v1")) -> list:
    """One alias's requests, in order, each of ``turns``: ``short``
    (``/response``, the short context), ``second`` (``/response``, the
    second conversation: its opening and the system prompt shared with the
    short one, a radix hit in the alias's own namespace) and ``v1``
    (``/v1/chat/completions``); per request the status, the reply and, for
    ``/response``, the engine's TTFT, tok/s and reused tokens (``eng_of()``
    is the engine serving the alias)."""
    rows = []
    for name in turns:
        if name == "v1":
            st, doc = _http(port, "POST", "/v1/chat/completions", v1_body(alias), timeout=900)
            rows.append({"request": "v1", "status": st,
                         "reply": doc["choices"][0]["message"]["content"] if st == 200 else doc})
            continue
        ctx = SHORT_CTX if name == "short" else SECOND_CTX
        st, doc = _http(port, "POST", "/response", model_body(ctx, alias), timeout=900)
        t = dict(eng_of().last_timings or {})
        rows.append({"request": name, "status": st,
                     "reply": doc.get("response", "") if isinstance(doc, dict) else "",
                     "ttft_s": t.get("ttft_s"), "tokens_per_s": t.get("tokens_per_sec"),
                     "reused_tokens": t.get("prefix_reused_tokens")})
    return rows


def phase_registry(paths: dict, counters: dict) -> dict:
    """``registry``: ``LFKT_MODELS=q4km=<Q4_K_M>,q6k=<Q6_K>:kv_dtype=bf16,
    mixed=<mixed>`` behind the port's app, serial, paged (the registry
    loads all three at startup).  First each file alone, a one-entry
    manifest (the same engine class and knobs): its replies, load seconds
    and weight bytes.  Then the three together: q4km and q6k share one
    arena, the 4-layer mixed file serves from a private pool with the
    warning; the short prompt under two aliases never hits across their
    namespaces, the second conversation hits in q4km's own; every greedy
    ``/response`` and ``/v1`` reply, routed by ``model=``, equals the file
    alone; an unknown model answers 400 with the live list; ``/v1/models``
    and the ``/health`` rows; a reload removes q6k (its namespace drained
    to 0 pages, the card's live bytes down by at least its weight bytes),
    adds it back (the same bytes again), and one over
    ``LFKT_HBM_WEIGHT_BUDGET_MB`` is refused with the running set
    untouched."""
    import logging
    import math

    import torch

    manifest = (f"q4km={paths['q4km']},q6k={paths['q6_k']}:kv_dtype=bf16,"
                f"mixed={paths['mixed']}")
    aliases = ("q4km", "q6k", "mixed")
    alone: dict = {}
    for alias, spec in zip(aliases, manifest.split(",")):
        with served_settings(tier_settings(models=spec)) as (port, app, load_s):
            reg = app.state.engine
            rows = registry_turns(port, lambda: reg.resolve(alias), None,
                                  ("short", "v1", "second") if alias == "q4km" else
                                  ("short", "v1"))
            alone[alias] = {"load_s": load_s, "rows": rows,
                            "weight_bytes": reg.models()[0]["weight_bytes"],
                            "quant": reg.models()[0]["quant"]}
            del reg
    # the three fit with half the smallest one's bytes to spare: q6k fits back
    # in after its removal, a fourth model (another Q6_K) does not
    weights = [a["weight_bytes"] for a in alone.values()]
    budget_mb = math.ceil((sum(weights) + min(weights) / 2) / 1e6)
    warned: list = []

    class Warned(logging.Handler):
        def emit(self, record):
            if "cannot share the KV page arena" in record.getMessage():
                warned.append(record.getMessage())

    handler = Warned()
    engine_log = logging.getLogger("llama_fastapi_k8s_gpu_tpu_torch.engine.engine")
    engine_log.addHandler(handler)
    zero_counters(counters)
    t0 = time.time()
    try:
        with served_settings(tier_settings(models=manifest, hbm_weight_budget_mb=budget_mb)) \
                as (port, app, load_s):
            reg = app.state.engine
            pool = reg.resolve("q4km")._kvpool
            shared = {"q6k_shares": reg.resolve("q6k")._kvpool is pool,
                      "mixed_private": reg.resolve("mixed")._kvpool is not pool,
                      "warned": warned[:1]}
            got: dict = {}
            hits = []
            for alias in aliases:     # the short prompt under each alias in turn
                hits.append(pool.stats()["hits"])
                got[alias] = registry_turns(port, lambda: reg.resolve(alias), alias)
            hits.append(pool.stats()["hits"])
            got["q4km"] += registry_turns(port, lambda: reg.resolve("q4km"), "q4km", ("second",))
            hits.append(pool.stats()["hits"])
            routes = {"unknown_response": _http(port, "POST", "/response",
                                                model_body(SHORT_CTX, "nope")),
                      "unknown_v1": _http(port, "POST", "/v1/chat/completions", v1_body("nope")),
                      "v1_models": _http(port, "GET", "/v1/models"),
                      "health": _http(port, "GET", "/health")}
            arena = {"pages_by_namespace": dict(pool._ns_pages),
                     "mixed_pages": dict(reg.resolve("mixed")._kvpool._ns_pages),
                     "occupancy": reg.kv_pool_occupancy()}
            launches = read_launches("registry", counters)
            served_s = time.time() - t0
            # live reload: q6k out (drained, released), back in, then one over the budget
            gc.collect()
            torch.cuda.synchronize()
            live0 = torch.cuda.memory_allocated()
            q6k_bytes = next(r["weight_bytes"] for r in reg.models() if r["name"] == "q6k")
            t_r = time.time()
            st_rm, rm = _http(port, "POST", "/admin/models/reload",
                              {"models": f"q4km={paths['q4km']},mixed={paths['mixed']}"})
            remove_s = time.time() - t_r
            gc.collect()
            torch.cuda.synchronize()
            live1 = torch.cuda.memory_allocated()
            drained = {"q6k_pages_after": pool._ns_pages.get("q6k", 0),
                       "q6k_root": "q6k" in pool._roots,
                       "pinned": pool.occupancy()["pages_pinned"]}
            gone = _http(port, "POST", "/response", model_body(SHORT_CTX, "q6k"))
            t_r = time.time()
            st_add, add = _http(port, "POST", "/admin/models/reload", {"models": manifest})
            add_s = time.time() - t_r
            again = registry_turns(port, lambda: reg.resolve("q6k"), "q6k")
            over = manifest + f",q6k_b={paths['q6_k']}:kv_dtype=bf16"
            t_r = time.time()
            st_over, refused = _http(port, "POST", "/admin/models/reload", {"models": over})
            refuse_s = time.time() - t_r
            after = _http(port, "GET", "/v1/models")
            metrics = _request(port, "GET", "/metrics")[2].decode()
            reloads = labelled(prom_samples(metrics, "model_reloads_total"))
            del reg, pool
    finally:
        engine_log.removeHandler(handler)
    want = {a: [r["reply"] for r in alone[a]["rows"]] for a in aliases}
    replies = {a: {"equal_alone": [r["reply"] for r in got[a]] == want[a],
                   "statuses": [r["status"] for r in got[a]]} for a in aliases}
    health = routes["health"][1]
    rows = health["engine"]["models"]
    out = {
        "manifest": list(aliases), "startup_s": load_s, "served_s": served_s,
        "budget_mb": budget_mb, "shared_arena": shared,
        "models": {a: {"weight_bytes": alone[a]["weight_bytes"], "quant": alone[a]["quant"],
                       "load_s_alone": alone[a]["load_s"],
                       "ttft_s": [r.get("ttft_s") for r in got[a] if "ttft_s" in r],
                       "tokens_per_s": [r.get("tokens_per_s") for r in got[a]
                                        if "tokens_per_s" in r],
                       "reused_tokens": [r.get("reused_tokens") for r in got[a]
                                         if "reused_tokens" in r]} for a in aliases},
        "hits_before_each_alias_and_after_second": hits, "replies": replies,
        "unknown_model": {"response": routes["unknown_response"][0],
                          "response_detail": routes["unknown_response"][1].get("detail"),
                          "v1": routes["unknown_v1"][0],
                          "v1_code": routes["unknown_v1"][1]["error"]["code"]},
        "v1_models": [m["id"] for m in routes["v1_models"][1]["data"]],
        "health_rows": [{k: r[k] for k in ("name", "state", "quant", "weight_bytes", "kv_dtype")}
                        for r in rows], "default_model": health["engine"]["default_model"],
        "arena": arena,
        "reload_remove": {"status": st_rm, "removed": rm.get("removed"), "seconds": remove_s,
                          "live_bytes_drop": live0 - live1, "q6k_weight_bytes": q6k_bytes,
                          **drained, "removed_alias_status": gone[0]},
        "reload_add": {"status": st_add, "added": add.get("added"), "seconds": add_s,
                       "same_bytes": [r["reply"] for r in again] == want["q6k"]},
        "reload_over_budget": {"status": st_over, "seconds": refuse_s,
                               "detail": str(refused.get("detail", ""))[:200],
                               "models_after": [m["id"] for m in after[1]["data"]]},
        "reloads_total": reloads}
    say("registry", **out)
    bad = []
    if not (shared["q6k_shares"] and shared["mixed_private"] and warned):
        bad.append("arena sharing")
    if not all(r["equal_alone"] and set(r["statuses"]) == {200} for r in replies.values()):
        bad.append("replies")
    if len(set(hits[:4])) != 1 or hits[4] != hits[3] + 1 \
            or not out["models"]["q4km"]["reused_tokens"][1]:
        bad.append("namespaces")
    if routes["unknown_response"][0] != 400 or routes["unknown_v1"][0] != 400 \
            or "q4km, q6k, mixed" not in str(out["unknown_model"]["response_detail"]):
        bad.append("unknown model")
    if out["v1_models"] != list(aliases) or [r["name"] for r in rows] != list(aliases) \
            or any(r["state"] != "ready" for r in rows):
        bad.append("models rows")
    rr = out["reload_remove"]
    if st_rm != 200 or rr["removed"] != [{"name": "q6k", "pages_remaining": 0,
                                          "inflight_at_release": 0}] \
            or rr["q6k_pages_after"] or rr["q6k_root"] or rr["pinned"] \
            or rr["live_bytes_drop"] < q6k_bytes or gone[0] != 400:
        bad.append("reload remove")
    if st_add != 200 or add.get("added") != ["q6k"] or not out["reload_add"]["same_bytes"]:
        bad.append("reload add")
    if st_over != 409 or "q6k_b" not in out["reload_over_budget"]["detail"] \
            or sorted(out["reload_over_budget"]["models_after"]) != sorted(aliases):
        bad.append("reload budget")
    if bad:
        raise AssertionError(f"registry: {bad}: {out}")
    return launches


def phase_registry_looped(paths: dict, counters: dict) -> dict:
    """``registry_looped``: two co-resident models of one geometry, both
    looped (the Q4_K_M file as int8 weights, ``decode_layer_unroll=-1``,
    through manifest overrides), each holding its own kernel scratch: the
    short prompt through each alias alone, then through both at once from
    two threads — the same greedy bytes."""
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import _registry_factory

    loop = "weight_format=int8;decode_layer_unroll=-1"
    settings = tier_settings(models=f"la={paths['q4km']}:{loop},lb={paths['q4km']}:{loop}",
                             kv_paged=False, prefix_cache=False)
    zero_counters(counters)
    t0 = time.time()
    reg = _registry_factory(settings)
    load_s = time.time() - t0
    msgs = [{"role": "user", "content": LONG_CTX[-1][1]}]

    def ask(alias):
        out = reg.create_chat_completion(msgs, max_tokens=TIER_TOKENS, temperature=0.0,
                                         model=alias)
        return out["choices"][0]["message"]["content"]

    try:
        alone = {a: ask(a) for a in ("la", "lb")}
        both: dict = {}
        threads = [threading.Thread(target=lambda a=a: both.update({a: ask(a)}))
                   for a in ("la", "lb")]
        t1 = time.time()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        both_s = time.time() - t1
        unroll = [reg.resolve(a).cfg.decode_layer_unroll for a in ("la", "lb")]
        launches = read_launches("registry_looped", counters)
    finally:
        reg.shutdown()
        del reg
        gc.collect()
    out = {"load_s": load_s, "decode_layer_unroll": unroll, "concurrent_s": both_s,
           "equal_alone": {a: both.get(a) == alone[a] for a in alone},
           "chars": {a: len(alone[a]) for a in alone}}
    say("registry_looped", **out)
    if not all(out["equal_alone"].values()) or unroll != [-1, -1]:
        raise AssertionError(f"registry_looped: concurrent looped models part from "
                             f"each alone: {out}")
    return launches


def lane_clients(port: int, jobs: list) -> tuple[list, float]:
    """``jobs`` ((alias, content), ...) as concurrent streamed
    ``/v1/chat/completions`` clients with usage: per client its status,
    reply, completion tokens and seconds to the first content; the wave's
    wall seconds."""
    out: list = [None] * len(jobs)

    def client(i):
        alias, content = jobs[i]
        r = _sse(port, "/v1/chat/completions",
                 v1_body(alias, content, stream=True, stream_options={"include_usage": True}),
                 timeout=900)
        usage = next((e.get("usage") for e in r["events"] if isinstance(e, dict)
                      and e.get("usage")), {}) or {}
        out[i] = {"model": alias, "status": r["status"], "reply": sse_text(r["events"])[0],
                  "tokens": usage.get("completion_tokens", 0), "ttft_s": r["first_content_s"]}

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(jobs))]
    t0 = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    return out, time.time() - t0


def phase_registry_lanes(paths: dict, counters: dict) -> dict:
    """``registry_lanes``: q4km and q6k (one shared arena) under
    ``LFKT_BATCH_SIZE=4``, continuous: a scheduler thread and a lane graph a
    model.  Eight streamed clients, four a model, at once: statuses,
    aggregate tok/s, TTFT p50/p95 per model, and each reply against the
    same client of a wave on the model alone (a one-entry manifest)."""
    manifest = f"q4km={paths['q4km']},q6k={paths['q6_k']}:kv_dtype=bf16"
    contents = [V1_MSG, STORY, "hi, " + STORY[:60], "what do you see on the water?"]
    kw = dict(batch_size=4, scheduler="continuous")
    alone: dict = {}
    for alias, spec in zip(("q4km", "q6k"), manifest.split(",")):
        with served_settings(tier_settings(models=spec, **kw)) as (port, _, load_s):
            rows, wall = lane_clients(port, [(alias, c) for c in contents])
            alone[alias] = {"rows": rows, "wall_s": wall, "load_s": load_s}
    zero_counters(counters)
    with served_settings(tier_settings(models=manifest, **kw)) as (port, app, load_s):
        jobs = [(alias, c) for c in contents for alias in ("q4km", "q6k")]
        rows, wall = lane_clients(port, jobs)
        stats = app.state.engine.scheduler_stats()
        launches = read_launches("registry_lanes", counters)
    per_model = {}
    for alias in ("q4km", "q6k"):
        mine = [r for r in rows if r["model"] == alias]
        ttfts = [r["ttft_s"] for r in mine if r["ttft_s"] is not None]
        per_model[alias] = {
            "statuses": [r["status"] for r in mine],
            "ttft_p50_s": percentile(ttfts, 0.5), "ttft_p95_s": percentile(ttfts, 0.95),
            "tokens": sum(r["tokens"] for r in mine),
            "equal_alone": [r["reply"] == a["reply"] for r, a in zip(mine, alone[alias]["rows"])],
            "alone_tokens_per_s": sum(a["tokens"] for a in alone[alias]["rows"])
            / alone[alias]["wall_s"]}
    tokens = sum(r["tokens"] for r in rows)
    out = {"lanes": 4, "clients": len(jobs), "startup_s": load_s, "wave_s": wall,
           "tokens": tokens, "tokens_per_s": tokens / wall, "models": per_model,
           "scheduler_models": stats.get("models"),
           "lanes_live_after": {a: stats.get(f"{a}_lanes_live") for a in ("q4km", "q6k")}}
    say("registry_lanes", **out)
    if any(r["status"] != 200 for r in rows) or \
            not all(all(m["equal_alone"]) for m in per_model.values()):
        raise AssertionError(f"registry_lanes: failed clients, or replies parting from "
                             f"the model alone: {out}")
    return launches


@contextlib.contextmanager
def disagg_probes(eng):
    """Record, while in the block, what the page service exported
    (``prefill_to_pages``' page stacks, cloned), what the client imported
    (``import_pages``' stacks), each hop's seconds and its parts' (the
    tier's ``prefill_to_pages``: prompt pass, commit and the pages' copy to
    the host; the payload's encoding; the import), and the send queues'
    peak buffered bytes (the ``disagg_txbuf`` component)."""
    from llama_fastapi_k8s_gpu_tpu_torch.serving.disagg import prefiller, transport

    box = {"exported": [], "imported": [], "hops": [], "txbuf_peak": 0,
           "parts_s": {"prefill_to_pages": 0.0, "encode_pages": 0.0, "import_pages": 0.0}}
    pool, to_pages = eng._kvpool, eng.prefill_to_pages
    import_pages, put = pool.import_pages, transport.FrameSender.put
    encode = prefiller.wire.encode_pages
    client = eng._disagg
    prefetch = client.prefetch

    def timed(part, fn, *a, **kw):
        t0 = time.time()
        try:
            return fn(*a, **kw)
        finally:
            box["parts_s"][part] += time.time() - t0

    def exporting(*a, **kw):
        got = timed("prefill_to_pages", to_pages, *a, **kw)
        if got is not None:
            box["exported"].append([leaf.clone() for leaf in got[0]])
        return got

    def importing(ids, leaves, **kw):
        box["imported"].append([leaf.clone() for leaf in leaves])
        return timed("import_pages", import_pages, ids, leaves, **kw)

    def putting(self, *a, **kw):
        put(self, *a, **kw)
        box["txbuf_peak"] = max(box["txbuf_peak"], self.buffered_bytes())

    def hopping(*a, **kw):
        t0 = time.time()
        n = prefetch(*a, **kw)
        box["hops"].append({"seconds": time.time() - t0, "tokens": n})
        return n

    eng.prefill_to_pages, pool.import_pages = exporting, importing
    client.prefetch = hopping
    transport.FrameSender.put = putting
    prefiller.wire.encode_pages = lambda leaves: timed("encode_pages", encode, leaves)
    try:
        yield box
    finally:
        transport.FrameSender.put = put
        prefiller.wire.encode_pages = encode
        del eng.prefill_to_pages, pool.import_pages, client.prefetch


def pages_equal(a: list, b: list) -> bool:
    """Two page-stack lists equal bit for bit (bf16 as 16-bit words)."""
    import torch

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    return len(a) == len(b) and all(x.shape == y.shape and torch.equal(bits(x), bits(y))
                                    for x, y in zip(a, b))


def disagg_turns(port: int, eng, box: dict) -> dict:
    """The long prompt three times as ``/response/stream``: cold with the
    hop switched off (a local prefill), with the pool emptied and the hop on
    (the pages cross the loopback wire), and again (a local radix hit, no
    hop): TTFT to the first content each, the replies, the hop."""
    pool, client = eng._kvpool, eng._disagg
    out = {}
    for name, hop in (("local", False), ("hop", True), ("hit", True)):
        if name != "hit":
            pool.reset()
        eng._disagg = client if hop else None
        r = _sse(port, "/response/stream", body(LONG_CTX), timeout=900)
        t = dict(eng.last_timings or {})
        out[name] = {"status": r["status"], "reply": sse_text(r["events"])[0],
                     "ttft_s": r["first_content_s"], "reused_tokens": t.get("prefix_reused_tokens")}
    eng._disagg = client
    return out


def disagg_line(label: str, turns: dict, box: dict, roles) -> dict:
    st = roles.status()
    svc, peer = st["prefill_service"], st["peer"]
    hop = box["hops"][0] if box["hops"] else {}
    sent = svc["bytes_sent"]
    out = {"file": label, "role": st["role"],
           "statuses": {k: v["status"] for k, v in turns.items()},
           "ttft_s": {k: v["ttft_s"] for k, v in turns.items()},
           "reused_tokens": {k: v["reused_tokens"] for k, v in turns.items()},
           "hop_s": hop.get("seconds"), "hop_tokens": hop.get("tokens"), "hops": len(box["hops"]),
           "hop_parts_s": box["parts_s"],
           "pages_sent": svc["pages_sent"], "bytes_sent": sent,
           "mb_per_s": sent / 1e6 / hop["seconds"] if hop.get("seconds") else None,
           "txbuf_peak_bytes": box["txbuf_peak"],
           "pages_received_equal_exported": len(box["exported"]) == len(box["imported"]) == 1
           and pages_equal(box["exported"][0], box["imported"][0]),
           "reply_hop_equals_local_hit": turns["hop"]["reply"] == turns["hit"]["reply"],
           "reply_hop_equals_cold_local": turns["hop"]["reply"] == turns["local"]["reply"],
           "peer": {k: peer[k] for k in ("remote_prefills", "remote_tokens", "local_fallbacks",
                                         "warm_local_skips", "reconnects", "last_error")}}
    say(label, **out)
    if set(out["statuses"].values()) != {200} or not out["pages_received_equal_exported"] \
            or not out["reply_hop_equals_local_hit"] or peer["remote_prefills"] != 1 \
            or peer["local_fallbacks"] or not turns["hop"]["reused_tokens"]:
        raise AssertionError(f"{label}: {out}")
    return out


def phase_disagg(paths: dict, counters: dict) -> dict:
    """``disagg``: ``LFKT_DISAGG_ROLE=both`` on the serial paged Q4_K_M pod
    (loaded by the app's startup), then ``disagg_lanes`` on the continuous
    one (4 lanes, the same weights): the long prompt (745 tokens, 5 pages)
    cold and local, through the loopback page service, and as a local
    radix hit.  The pages received must equal the pages exported bit for
    bit, and the reply over them the local hit's."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app

    d, name = os.path.split(paths["q4km"])
    launches = dict.fromkeys(counters, 0)
    zero_counters(counters)
    settings = tier_settings(model_dir=d, model_name=name, disagg_role="both",
                             disagg_timeout_seconds=30.0)
    with served_settings(settings) as (port, app, load_s):
        eng = app.state.engine
        with disagg_probes(eng) as box:
            turns = disagg_turns(port, eng, box)
        disagg_line("disagg", turns, box, app.state.disagg)
        parts = (eng.params, eng.cfg, eng.tokenizer, eng.template_kind)
        del eng
    for k, n in read_launches("disagg", counters).items():
        launches[k] += n
    zero_counters(counters)
    lanes = tier_settings(disagg_role="both", disagg_timeout_seconds=30.0, batch_size=4)
    eng = ContinuousEngine.from_parts(*parts, batch_size=4, kv_paged=True,
                                      kv_page_tokens=PAGE_TOKENS, max_gen_tokens=TIER_TOKENS)
    eng.warmup()
    app = create_app(engine=eng, settings=lanes)
    try:
        with serving(app) as (port, _):
            with disagg_probes(eng) as box:
                turns = disagg_turns(port, eng, box)
            disagg_line("disagg_lanes", turns, box, app.state.disagg)
    finally:
        eng.close()
    for k, n in read_launches("disagg_lanes", counters).items():
        launches[k] += n
    del app, eng, parts
    gc.collect()
    return launches


class Pod:
    """One ``python -m llama_fastapi_k8s_gpu_tpu_torch.server`` process on
    the card (at ``port``, else a free one), its output in a log file under
    the cache.  It runs the package under ``root`` (the checkout, else a
    copy) in ``base_env`` (this process's, else the one given) with ``env``
    on top."""

    def __init__(self, name: str, env: dict, port: int | None = None, root: str = HERE,
                 base_env: dict | None = None):
        self.name = name
        self.port = port or _free_port()
        self.log = os.path.join(CACHE, "pods", f"{name}.log")
        os.makedirs(os.path.dirname(self.log), exist_ok=True)
        base = os.environ if base_env is None else base_env
        path = os.pathsep.join(filter(None, (root, base.get("PYTHONPATH"))))
        full = dict(base, PYTHONPATH=path, LFKT_HOST="127.0.0.1",
                    LFKT_PORT=str(self.port), LFKT_JSON_LOGS="0", **env)
        self.t0 = time.time()
        with open(self.log, "w") as fh:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.server"], cwd=root,
                env=full, stdout=fh, stderr=subprocess.STDOUT, start_new_session=True)

    def ready(self, timeout: float = 300) -> float:
        while time.time() - self.t0 < timeout:
            if self.proc.poll() is not None:
                raise AssertionError(f"pod {self.name} exited {self.proc.returncode}: "
                                     f"{self.tail()}")
            try:
                if _http(self.port, "GET", "/health/live", timeout=5)[0] == 200 and \
                        _http(self.port, "GET", "/health", timeout=5)[0] == 200:
                    return time.time() - self.t0
            except OSError:
                pass
            time.sleep(0.25)
        raise AssertionError(f"pod {self.name} not up in {timeout}s: {self.tail()}")

    def get(self, path: str):
        return _http(self.port, "GET", path, timeout=60)[1]

    def tail(self, n: int = 3000) -> str:
        with open(self.log, errors="replace") as fh:
            return fh.read()[-n:]

    def stop(self, kill: bool = False) -> None:
        if self.proc.poll() is None:
            self.proc.kill() if kill else self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)


def phase_disagg_pods(paths: dict) -> dict:
    """``disagg_pods``: a prefill pod (``LFKT_DISAGG_ROLE=prefill``) and a
    decode pod (``decode``, ``LFKT_DISAGG_PEER``) as two server processes on
    the one card, the Q4_K_M file each.  The decode pod answers
    ``/response`` through the hop; the prefill pod, its wire slowed by the
    ``slow_wire`` fault, is killed mid-transfer — the request still answers
    200 by local prefill, and the decode pod's ``/health`` and
    ``disagg_local_fallbacks_total`` say why; a restarted prefill pod serves
    the next hop (READY again); a decode pod over an int8 ring is refused
    at the handshake, for good, and serves locally."""
    d, name = os.path.split(paths["q4km"])
    wire_port = _free_port()
    common = dict(LFKT_MODEL_DIR=d, LFKT_MODEL_NAME=name, LFKT_KV_PAGED="1",
                  LFKT_MAX_GEN_TOKENS=str(TIER_TOKENS), LFKT_TEMPERATURE="0",
                  LFKT_TIMEOUT_SECONDS="600")
    prefill_env = dict(common, LFKT_DISAGG_ROLE="prefill", LFKT_DISAGG_BIND="127.0.0.1",
                       LFKT_DISAGG_PORT=str(wire_port))
    decode_env = dict(common, LFKT_DISAGG_ROLE="decode",
                      LFKT_DISAGG_PEER=f"127.0.0.1:{wire_port}",
                      LFKT_DISAGG_TIMEOUT_SECONDS="30")
    pods: list = []
    out: dict = {}
    t0 = time.time()
    try:
        pre = Pod("prefill", dict(prefill_env,
                                  LFKT_FAULTS="slow_wire:slow:delay=1.0:after=1:times=0"))
        dec = Pod("decode", decode_env)
        pods += [pre, dec]
        out["up_s"] = {"prefill": pre.ready(), "decode": dec.ready()}
        t = time.time()
        st1, _ = _http(dec.port, "POST", "/response", body(SHORT_CTX), timeout=900)
        out["through_hop"] = {"status": st1, "seconds": time.time() - t,
                              "peer": dec.get("/health")["disagg"]["peer"]}
        sent0 = pre.get("/health")["disagg"]["prefill_service"]["pages_sent"]
        box: dict = {}
        th = threading.Thread(target=lambda: box.update(
            r=_http(dec.port, "POST", "/response", body(LONG_CTX), timeout=900)))
        t = time.time()
        th.start()
        killed_at = None
        while time.time() - t < 60:
            svc = pre.get("/health")["disagg"]["prefill_service"]
            if svc["pages_sent"] >= sent0 + 5:       # the long prompt's 5 pages queued
                # the slowed wire carries a frame a second: the first group
                # is across, the second still queued
                time.sleep(1.3)
                pre.stop(kill=True)
                killed_at = time.time() - t
                break
            time.sleep(0.02)
        th.join(900)
        health = dec.get("/health")
        metrics = _request(dec.port, "GET", "/metrics")[2].decode()
        out["killed_mid_transfer"] = {
            "status": box["r"][0] if "r" in box else None, "killed_at_s": killed_at,
            "seconds": time.time() - t, "state": health["state"],
            "reason": health["resilience"]["health"]["reason"],
            "peer": health["disagg"]["peer"],
            "fallbacks": labelled(prom_samples(metrics, "disagg_local_fallbacks_total"))}
        pre2 = Pod("prefill_restarted", prefill_env)
        dec8 = Pod("decode_int8", dict(decode_env, LFKT_KV_DTYPE="int8"))
        pods += [pre2, dec8]
        out["restart_up_s"] = {"prefill": pre2.ready(), "decode_int8": dec8.ready()}
        t = time.time()
        st3, _ = _http(dec.port, "POST", "/response", body(PRESSURE_CTXS[0]), timeout=900)
        health = dec.get("/health")
        out["recovered"] = {"status": st3, "seconds": time.time() - t, "state": health["state"],
                            "reason": health["resilience"]["health"]["reason"],
                            "remote_prefills": health["disagg"]["peer"]["remote_prefills"]}
        sts = [_http(dec8.port, "POST", "/response", body(ctx), timeout=900)[0]
               for ctx in (SHORT_CTX, SECOND_CTX)]
        peer8 = dec8.get("/health")["disagg"]["peer"]
        svc2 = pre2.get("/health")["disagg"]["prefill_service"]
        out["int8_refused"] = {"statuses": sts, "handshake_refused": peer8["handshake_refused"],
                               "reconnects": peer8["reconnects"],
                               "local_fallbacks": peer8["local_fallbacks"],
                               "prefill_refusals": svc2["handshake_refusals"]}
    finally:
        for p in pods:
            p.stop()
    out["seconds"] = time.time() - t0
    say("disagg_pods", **out)
    k, r, i8 = out["killed_mid_transfer"], out["recovered"], out["int8_refused"]
    bad = []
    if st1 != 200 or out["through_hop"]["peer"]["remote_prefills"] != 1:
        bad.append("hop")
    if k["status"] != 200 or k["killed_at_s"] is None or k["peer"]["local_fallbacks"] < 1 \
            or not str(k["peer"]["last_error"]).startswith("peer_dead") \
            or not any("reason=peer_dead" in key for key in k["fallbacks"]) \
            or k["state"] != "DEGRADED":
        bad.append("kill mid-transfer")
    if st3 != 200 or r["remote_prefills"] != 2 or r["state"] != "READY":
        bad.append("recovery")
    if set(i8["statuses"]) != {200} or "geometry mismatch" not in str(i8["handshake_refused"]) \
            or i8["reconnects"] or i8["prefill_refusals"] != 1:
        bad.append("int8 refusal")
    if bad:
        raise AssertionError(f"disagg_pods: {bad}: {out}; decode log: "
                             f"{pods[1].tail() if len(pods) > 1 else ''}")
    return out


# ---------------------------------------------------------------------------
# the image's runtime stage: a pod from a read-only package and a read-only
# kernel cache, with no toolkit
# ---------------------------------------------------------------------------

def scrub_toolkit(env: dict) -> dict:
    """``env`` without the CUDA toolkit: no ``PATH`` entry that holds an
    ``nvcc``, no ``CUDA_HOME``, no ``CUDA_PATH`` (the places the kernel cache
    looks for nvcc)."""
    out = {k: v for k, v in env.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    keep = [d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.access(os.path.join(d, "nvcc"), os.X_OK)]
    out["PATH"] = os.pathsep.join(keep)
    return out


def make_readonly(path: str) -> None:
    """``chmod -R a-w path``."""
    for dirpath, dirs, files in os.walk(path):
        for name in files:
            f = os.path.join(dirpath, name)
            os.chmod(f, os.stat(f).st_mode & ~0o222)
    for dirpath, _, _ in sorted(os.walk(path), reverse=True):
        os.chmod(dirpath, os.stat(dirpath).st_mode & ~0o222)


def make_writable(path: str) -> None:
    """``chmod -R u+w path``, where it exists (to clear an earlier run's
    read-only copies)."""
    if not os.path.exists(path):
        return
    os.chmod(path, os.stat(path).st_mode | 0o200)
    for dirpath, dirs, files in os.walk(path):
        for name in dirs + files:
            f = os.path.join(dirpath, name)
            if not os.path.islink(f):
                os.chmod(f, os.stat(f).st_mode | 0o200)


def readonly_copy(src: str, dst: str) -> str:
    """A copy of the package ``src`` at ``dst`` as an image holds it: its
    sources and ``csrc/``, none of a checkout's ``_build/`` or bytecode,
    every file and directory without write permission."""
    make_writable(dst)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("_build", "__pycache__", "*.pyc"))
    make_readonly(dst)
    return dst


def tree_state(path: str) -> dict:
    """{relative path: (size, mtime_ns)} of every file and directory under
    ``path``: two states differ where anything was written."""
    out = {}
    for dirpath, dirs, files in os.walk(path):
        for name in dirs + files:
            f = os.path.join(dirpath, name)
            st = os.lstat(f)
            out[os.path.relpath(f, path)] = (st.st_size if name in files else 0,
                                             st.st_mtime_ns)
    return out


def needed_libs(path: str) -> list:
    """The ``NEEDED`` entries of a shared object, in order, as ``readelf -d``
    lists them (a file that is no ELF object raises)."""
    out = subprocess.run(["readelf", "-d", path], capture_output=True, text=True,
                         check=True).stdout
    return re.findall(r"\(NEEDED\)\s+Shared library: \[(.+?)\]", out)


def resident_share(path: str) -> float:
    """The share of ``path``'s pages in the page cache (``mincore`` over a
    read-only mapping of the file)."""
    import ctypes
    import mmap

    size = os.path.getsize(path)
    if not size:
        return 0.0
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_long]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    fd = os.open(path, os.O_RDONLY)
    try:
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
        if addr is None or addr == ctypes.c_void_p(-1).value:
            raise OSError(ctypes.get_errno(), f"mmap {path}")
        try:
            pages = -(-size // mmap.PAGESIZE)
            vec = ctypes.create_string_buffer(pages)
            if libc.mincore(addr, size, vec) != 0:
                raise OSError(ctypes.get_errno(), f"mincore {path}")
            return (pages - vec.raw[:pages].count(0)) / pages
        finally:
            libc.munmap(addr, size)
    finally:
        os.close(fd)


def evict(path: str) -> float:
    """Make the next read of ``path`` come from the disk: its dirty pages
    written out, then ``POSIX_FADV_DONTNEED`` on this one file (nothing of
    the machine's caches else).  Returns the share still resident after."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return resident_share(path)


def phase_image(path: str) -> dict:
    """``image``: the image's runtime stage.  A copy of the port package made
    read-only, the run's kernel cache made read-only, and an environment with
    no ``nvcc`` on ``PATH`` and no ``CUDA_HOME``/``CUDA_PATH``.  A child on an
    empty read-only cache (no library, no nvcc: there must be no fallback)
    runs beside a pod on the Q4_K_M file, ``python -m
    llama_fastapi_k8s_gpu_tpu_torch.server`` from the copy, which reads the
    file cold where :func:`evict` can drop its pages and must reach READY, map the cache's library
    and write nothing into the copy or the cache; its seconds to READY, its
    ``kernel_build`` compiles, its greedy reply to the short request, the
    library's size and ``NEEDED`` entries go to :func:`image_verdict`.  The
    pod is stopped before this returns, so it needs the card only while the
    run waits for its other files."""
    from llama_fastapi_k8s_gpu_tpu_torch.utils import kernelcache

    root = os.path.join(CACHE, "image")
    make_writable(root)
    shutil.rmtree(root, ignore_errors=True)
    pkg = readonly_copy(os.path.join(HERE, PKG), os.path.join(root, "app", PKG))
    app_root = os.path.dirname(pkg)
    empty = os.path.join(root, "empty-cache")
    os.makedirs(empty)
    make_readonly(empty)
    lib = os.path.join(KERNEL_CACHE, "lfkt-kernels", kernelcache.digest(), kernelcache.LIBRARY)
    base = scrub_toolkit(os.environ)
    base.update(PYTHONDONTWRITEBYTECODE="1")
    out: dict = {"digest": kernelcache.digest(), "library": os.path.realpath(lib),
                 "library_bytes": os.path.getsize(lib), "needed": needed_libs(lib),
                 "toolkit_in_path": bool(shutil.which("nvcc", path=base["PATH"]))}
    make_readonly(KERNEL_CACHE)
    before = (tree_state(app_root), tree_state(KERNEL_CACHE))
    neg: dict = {}

    def no_library():
        t = time.time()
        r = subprocess.run(
            [sys.executable, "-c", f"from {PKG}.ops import _kernels; _kernels.library()"],
            cwd=app_root, capture_output=True, text=True, timeout=300,
            env=dict(base, LFKT_COMPILE_CACHE_DIR=empty, PYTHONPATH=os.pathsep.join(
                filter(None, (app_root, base.get("PYTHONPATH"))))))
        neg.update(rc=r.returncode, seconds=time.time() - t,
                   error=(r.stderr.strip().splitlines() or [""])[-1])

    child = threading.Thread(target=no_library)
    pod = None
    try:
        child.start()
        out["resident_before"] = resident_share(path)
        out["resident_evicted"] = evict(path)
        d, name = os.path.split(path)
        pod = Pod("image", dict(LFKT_COMPILE_CACHE_DIR=KERNEL_CACHE, LFKT_MODEL_DIR=d,
                                LFKT_MODEL_NAME=name, LFKT_TEMPERATURE="0",
                                LFKT_TIMEOUT_SECONDS="600"),
                  root=app_root, base_env=base)
        out["ready_s"] = pod.ready()
        out["tools"] = tool_imports(app_root, base)
        progs = {p["name"]: p for p in pod.get("/debug/compiles")["programs"]}
        out["kernel_build_compiles"] = progs.get("kernel_build", {}).get("compiles")
        with open(f"/proc/{pod.proc.pid}/maps") as fh:
            out["mapped"] = sorted({ln.split()[-1] for ln in fh if kernelcache.LIBRARY in ln})
        t = time.time()
        st, doc = _http(pod.port, "POST", "/response", body(SHORT_CTX), timeout=900)
        out["reply"] = {"status": st, "seconds": time.time() - t,
                        "text": (doc or {}).get("response", "")}
        pod.stop()
        child.join(300)
        out["no_library"] = neg
        after = (tree_state(app_root), tree_state(KERNEL_CACHE))
        out["writes"] = sorted(
            {k for b, a in zip(before, after) for k in set(b) | set(a) if b.get(k) != a.get(k)})
    except BaseException:
        say("image", **out, log=pod.tail() if pod else "")
        raise
    finally:
        if pod is not None:
            pod.stop()
        child.join(300)
        make_writable(KERNEL_CACHE)
    return out


#: the operator tools (``python -m llama_fastapi_k8s_gpu_tpu_torch.tools.*``):
#: the first four load no torch, the drills load it only to serve a model
STDLIB_TOOLS = ("incident_report", "fleet_trace", "lint_report", "ci_gate")
TOOLS = (*STDLIB_TOOLS, "fault_drill", "chaos_drill")


def tool_imports(app_root: str, env: dict) -> dict:
    """Each operator tool imported, in turn, in one child in the image's
    runtime stage (``env`` over the copy at ``app_root``): the child's exit
    code and, after each import, which of torch and jax it had loaded."""
    code = ("import importlib, json, sys\n"
            "seen = {}\n"
            f"for m in {list(TOOLS)!r}:\n"
            f"    importlib.import_module('{PKG}.tools.' + m)\n"
            "    seen[m] = sorted(x for x in ('torch', 'jax') if x in sys.modules)\n"
            "print(json.dumps(seen))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=app_root, capture_output=True,
                       text=True, timeout=120,
                       env=dict(env, PYTHONPATH=os.pathsep.join(
                           filter(None, (app_root, env.get("PYTHONPATH"))))))
    lines = r.stdout.strip().splitlines()
    return {"rc": r.returncode, "loaded": json.loads(lines[-1]) if lines else None,
            "error": r.stderr[-1500:] if r.returncode else ""}


def image_verdict(out: dict, want_reply: str) -> dict:
    """The ``image`` line of :func:`phase_image`'s readings, the pod's reply
    held byte for byte to ``want_reply`` (the in-process ``q4km`` engine's
    greedy reply to the short request); raises on any failed check."""
    text = out["reply"].pop("text")
    out["reply"].update(chars=len(text), sha256=hashlib.sha256(text.encode()).hexdigest()[:16],
                        equal=text.encode() == want_reply.encode())
    say("image", **out)
    bad = []
    if out["toolkit_in_path"]:
        bad.append("nvcc left on PATH")
    if out["no_library"].get("rc", 0) == 0 or "no kernel library for digest" not in out[
            "no_library"].get("error", "") or out["digest"] not in out["no_library"]["error"]:
        bad.append("no-library child")
    if out["kernel_build_compiles"] != 0 or out["mapped"] != [out["library"]]:
        bad.append("library not found as built")
    if out["reply"]["status"] != 200 or not out["reply"]["equal"]:
        bad.append("reply")
    if out["writes"]:
        bad.append("writes")
    tools = out["tools"]
    if tools["rc"] != 0 or set(tools["loaded"] or {}) != set(TOOLS) \
            or any("jax" in tools["loaded"][m] for m in TOOLS) \
            or any(tools["loaded"][m] for m in STDLIB_TOOLS):
        bad.append("tools")
    if bad:
        raise AssertionError(f"image: {bad}: {out}")
    return out


# ---------------------------------------------------------------------------
# the fleet tier: the prefix-affinity router and warm-page migration
# ---------------------------------------------------------------------------

#: a conversation's opening: each ``i`` a prefix of its own (the affinity key
#: is the persona and the first user message)
FLEET_OPENER = "good morning, I am writing to you from harbour number {i} today."
#: the assistant's turn in a scripted history: the model's own (random-weight)
#: replies re-tokenize into far more tokens than they were sampled as, and
#: would overflow the context in a few turns
FLEET_ACK = "I see. Please go on."
#: the user's next messages, turn by turn
FLEET_FOLLOW = ("tell me more about that.", "and what happened after that?",
                "how did it end?", "what would you do next?", "one last thing?")
#: a /v1 user message long enough for two whole pages (the SIGKILL drill's)
FLEET_V1_MSG = "here is my story: " + STORY * 3


def fleet_key(ctx: list) -> str:
    from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.affinity import affinity_key

    return affinity_key("/response", {}, json.dumps(body(ctx)).encode())[0]


def fleet_conv(owner: str, addrs: list, skip: set, tail: str = "") -> tuple:
    """(i, one-turn context) of the first conversation not in ``skip`` whose
    rendezvous owner over ``addrs`` is ``owner``; ``tail`` follows the
    opening in its first message."""
    from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.affinity import rendezvous_rank

    for i in range(512):
        ctx = [("user", (FLEET_OPENER.format(i=i) + tail)[:400])]
        if i not in skip and rendezvous_rank(fleet_key(ctx), addrs)[0] == owner:
            skip.add(i)
            return i, ctx
    raise AssertionError(f"no conversation owned by {owner}")


def fleet_next(ctx: list, k: int) -> list:
    """The conversation's next turn: :data:`FLEET_ACK` as the assistant's,
    then the user's ``k``-th follow-up."""
    return ctx + [("assistant", FLEET_ACK), ("user", FLEET_FOLLOW[k % len(FLEET_FOLLOW)])]


@contextlib.contextmanager
def serving_router(router):
    """The port's ``FleetRouter`` on its own event loop in a thread, at
    127.0.0.1; yields its port.  Stopping it stops its peer table."""
    import asyncio

    port = _free_port()
    loop = asyncio.new_event_loop()
    up, stop = asyncio.Event(), asyncio.Event()
    th = threading.Thread(target=loop.run_until_complete, daemon=True,
                          args=(router.serve("127.0.0.1", port, up, stop),))
    th.start()
    t_up = time.time()
    while not up.is_set():
        if not th.is_alive() or time.time() - t_up > 60:
            raise RuntimeError("fleet router did not come up")
        time.sleep(0.02)
    try:
        yield port
    finally:
        loop.call_soon_threadsafe(stop.set)
        th.join(60)
        loop.close()


def fleet_turn(port: int, ctx: list, engines: dict, headers=None) -> dict:
    """One ``/response/stream`` turn at ``port``: status, reply, the client's
    TTFT (first content), the replicas that served it (``engines``: addr →
    engine, by whose ``last_timings`` moved), the reused tokens there and
    the request id."""
    before = {a: e.last_timings for a, e in engines.items()}
    r = _sse(port, "/response/stream", body(ctx), timeout=900, headers=headers)
    served = [a for a, e in engines.items() if e.last_timings is not before[a]]
    t = dict(engines[served[0]].last_timings or {}) if len(served) == 1 else {}
    errors = [ev["error"] for ev in r["events"] if isinstance(ev, dict) and "error" in ev]
    return {"status": r["status"] if not errors else f"error: {errors[0]}",
            "reply": sse_text(r["events"])[0], "ttft_s": r["first_content_s"],
            "served": served, "prompt_tokens": t.get("prompt_tokens"),
            "reused_tokens": t.get("prefix_reused_tokens"),
            "request_id": r["headers"].get("x-request-id")}


def fleet_sums(texts: list, family: str) -> dict:
    """A counter family's samples summed over Prometheus texts."""
    out: dict = {}
    for text in texts:
        for key, v in prom_samples(text, family).items():
            out[key] = out.get(key, 0.0) + v
    return out


def owner_export(pool, ids: list, tokens: int) -> list:
    """``pool``'s page stacks for ``ids[:tokens]`` (pinned for the copy)."""
    lease = pool.acquire(ids, tokens)
    if lease is None:
        return []
    try:
        return pool.export_pages(lease)
    finally:
        pool.release(lease)


def export_stall(port: int, owner_pool_addr: str, ids: list, eng) -> dict:
    """The owner's decode while a peer pulls from it: a 256-token ``/v1``
    stream on the owner alone, then again while a puller on the card pulls
    ``ids``' pages from the owner's page service over and over (into a
    scratch pool, emptied between pulls).  Per-token ms of each (the
    engine's decode rate), and the pulls and their seconds."""
    from llama_fastapi_k8s_gpu_tpu_torch.parallel.kvpool import KVPool
    from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.migrate import MigrationManager
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    payload = v1_body(None, user="stall", stream=True, max_tokens=256)
    scratch = KVPool(eng.cfg, page_tokens=PAGE_TOKENS, n_pages=8, device=eng.device)
    puller = MigrationManager(scratch, Settings(migrate_timeout_seconds=30.0))
    out = {}
    for arm in ("alone", "with_pulls"):
        done = threading.Event()
        pulls: list = []

        def pull_loop():
            while not done.is_set():
                scratch.reset()
                t0 = time.time()
                got = puller.pull(owner_pool_addr, ids, reason="warmup")
                pulls.append((time.time() - t0, got))

        th = threading.Thread(target=pull_loop, daemon=True) if arm == "with_pulls" else None
        if th is not None:
            th.start()
        r = _sse(port, "/v1/chat/completions", payload, timeout=900)
        done.set()
        if th is not None:
            th.join(60)
        t = dict(eng.last_timings or {})
        tps = t.get("tokens_per_sec")
        secs = sorted(s for s, _ in pulls)
        out[arm] = {"status": r["status"], "tokens": t.get("completion_tokens"),
                    "tokens_per_s": tps, "ms_per_token": 1000.0 / tps if tps else None,
                    "pulls": len(pulls), "pulled_tokens": sorted({g for _, g in pulls}),
                    "pull_s_median": secs[len(secs) // 2] if secs else None,
                    "pull_s_max": secs[-1] if secs else None}
    del scratch, puller
    return out


def phase_fleet(paths: dict, counters: dict) -> dict:
    """``fleet``: two replica apps A and B in this process, the Q4_K_M file
    each (its own engine, loaded by its app's startup, and its own tracer),
    paged, ``LFKT_MIGRATE=1`` with the JAX package's migration budgets, on
    ephemeral HTTP and page-wire ports, behind the port's ``FleetRouter``
    (affinity) on a thread.  Parity (routed bytes against direct), affinity
    over a three-turn conversation against a round-robin arm, the forged
    prior-owner stamp stripped (a decoy counts no accept), pull-on-remap
    (the owner ejected: the next turn's pages pulled bit-equal to the
    owner's export, the reply the owner's own over its local hit; TTFT with
    the pull beside a cold prefill and the local hit), the owner's decode
    while a peer pulls from it, one stitched trace, ``/metrics/fleet``
    against the replicas' sums, and a third replica C started beside them
    that pre-pulls their hot prefixes before READY and hits on a turn it
    owns.  Returns each kernel's launches."""
    from llama_fastapi_k8s_gpu_tpu_torch.obs.trace import Tracer
    from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.affinity import (
        PRIOR_OWNER_HEADER,
        affinity_key,
        rendezvous_rank,
    )
    from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.peers import PeerTable
    from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.router import FleetRouter
    from llama_fastapi_k8s_gpu_tpu_torch.utils.metrics import Metrics

    d, name = os.path.split(paths["q4km"])
    launches = dict.fromkeys(counters, 0)
    zero_counters(counters)

    def replica(**kw):
        return tier_settings(model_dir=d, model_name=name, migrate=True,
                             migrate_bind="127.0.0.1", migrate_port=0, **kw)

    pa, pb = _free_port(), _free_port()
    A, B = f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"
    ports = {A: pa, B: pb}
    out: dict = {}
    bad: list = []
    skip: set = set()
    with contextlib.ExitStack() as stack:
        t0 = time.time()
        apps = {A: stack.enter_context(served_settings(replica(), pa, Tracer(1.0, 64)))[1],
                B: stack.enter_context(served_settings(replica(), pb, Tracer(1.0, 64)))[1]}
        out["up_s"] = round(time.time() - t0, 2)
        engines = {a: app.state.engine for a, app in apps.items()}
        migs = {a: app.state.migration for a, app in apps.items()}
        # one probe sweep at start: the drill's ejection stays until re-admitted
        table = PeerTable(peers=[A, B], probe_seconds=600.0).start()
        router = FleetRouter(table, policy="affinity", metrics=Metrics(),
                             tracer=Tracer(1.0, 64))
        rport = stack.enter_context(serving_router(router))

        def owner_of(ctx):
            return rendezvous_rank(fleet_key(ctx), [A, B])[0]

        # parity: routed bytes against direct, both over the owner's warm pages
        i0, ctx0 = fleet_conv(A, [A, B], skip)
        v1 = v1_body(None)
        v1_owner = rendezvous_rank(affinity_key("/v1/chat/completions", {},
                                                json.dumps(v1).encode())[0], [A, B])[0]
        _http(rport, "POST", "/response", body(ctx0), timeout=900)
        _http(rport, "POST", "/v1/chat/completions", v1, timeout=900)
        direct = _request(pa, "POST", "/response", body(ctx0), timeout=900)
        routed = _request(rport, "POST", "/response", body(ctx0), timeout=900)
        dv1 = _http(ports[v1_owner], "POST", "/v1/chat/completions", v1, timeout=900)[1]
        rv1 = _http(rport, "POST", "/v1/chat/completions", v1, timeout=900)[1]
        d_sse = _sse(pa, "/response/stream", body(ctx0), timeout=900)
        r_sse = _sse(rport, "/response/stream", body(ctx0), timeout=900)
        out["parity"] = {
            "response_bytes_equal": direct[0] == routed[0] == 200 and direct[2] == routed[2],
            "v1_choices_equal": dv1.get("choices") == rv1.get("choices"),
            "sse_text_equal": sse_text(d_sse["events"])[0] == sse_text(r_sse["events"])[0],
            "router_ttft_s": r_sse["first_content_s"], "direct_ttft_s": d_sse["first_content_s"]}
        if not all(out["parity"][k] for k in ("response_bytes_equal", "v1_choices_equal",
                                              "sse_text_equal")):
            bad.append("parity")

        # affinity: three turns of one conversation on its owner; the control
        # arm the same shape of conversation under round-robin
        arms = {}
        turns = {}
        for arm, policy in (("affinity", "affinity"), ("roundrobin", "roundrobin")):
            i, ctx = fleet_conv(B, [A, B], skip)
            if policy == "affinity":
                rp, rtable = rport, table
            else:
                rtable = PeerTable(peers=[A, B], probe_seconds=600.0).start()
                rp = stack.enter_context(serving_router(FleetRouter(rtable, policy=policy)))
            rows, ctxs = [], []
            for k in range(3):
                if k:
                    ctx = fleet_next(ctx, k - 1)
                ctxs.append(ctx)
                rows.append(fleet_turn(rp, ctx, engines))
            # the fourth turn's context: the pull-on-remap turn
            turns[arm] = ctxs + [fleet_next(ctx, 2)]
            arms[arm] = {"conversation": i, "served": [r["served"] for r in rows],
                         "prompt_tokens": [r["prompt_tokens"] for r in rows],
                         "reused_tokens": [r["reused_tokens"] for r in rows],
                         "ttft_s": [r["ttft_s"] for r in rows],
                         "statuses": [r["status"] for r in rows]}
        out["affinity"] = arms
        aff = arms["affinity"]
        if set(aff["statuses"]) != {200} or aff["served"] != [[B]] * 3 \
                or not all(aff["reused_tokens"][1:]):
            bad.append("affinity")

        # a client's forged prior-owner stamp is stripped: no pull, no accept
        decoy = socket.socket()
        decoy.bind(("127.0.0.1", 0))
        decoy.listen(4)
        decoy.settimeout(0.2)
        pulls_before = {a: m.status()["counters"]["pulls"] for a, m in migs.items()}
        # the third turn again (a client's retry), with a forged stamp
        forged = fleet_turn(rport, turns["affinity"][2], engines, headers={
            PRIOR_OWNER_HEADER: f"127.0.0.1:{decoy.getsockname()[1]}"})
        accepts = 0
        with contextlib.suppress(OSError):
            while True:
                decoy.accept()[0].close()
                accepts += 1
        decoy.close()
        out["forged_stamp"] = {"status": forged["status"], "decoy_accepts": accepts,
                               "pulls": {a: m.status()["counters"]["pulls"] - pulls_before[a]
                                         for a, m in migs.items()}}
        if forged["status"] != 200 or accepts or any(out["forged_stamp"]["pulls"].values()):
            bad.append("forged stamp")

        # pull-on-remap: the owner B ejected while its page service lives; the
        # next turn lands on A, stamped, and A pulls before its prefill
        ctx = turns["affinity"][3]
        pool_a, pool_o = engines[A]._kvpool, engines[B]._kvpool
        rec: dict = {"imports": [], "pull_s": []}
        import_pages, pull = pool_a.import_pages, migs[A].pull

        def importing(ids, leaves, **kw):
            rec["imports"].append((list(ids), [leaf.clone() for leaf in leaves]))
            return import_pages(ids, leaves, **kw)

        def pulling(*a, **kw):
            t1 = time.time()
            try:
                return pull(*a, **kw)
            finally:
                rec["pull_s"].append(time.time() - t1)

        pool_a.import_pages, migs[A].pull = importing, pulling
        sent0 = migs[B].server.status()["bytes_sent"]
        table.eject(B, "drill: owner ejected, page service alive")
        try:
            remap = fleet_turn(rport, ctx, engines)
        finally:
            del pool_a.import_pages, migs[A].pull
        sent = migs[B].server.status()["bytes_sent"] - sent0
        hit = fleet_turn(pb, ctx, engines)                       # the owner's local hit
        pool_a.reset()
        cold = fleet_turn(pa, ctx, engines)                      # A with nothing cached
        ids, leaves = rec["imports"][0] if rec["imports"] else ([], [])
        pulled = leaves[0].shape[0] * PAGE_TOKENS if leaves else 0
        pull_s = rec["pull_s"][0] if rec["pull_s"] else None
        out["remap"] = {
            "statuses": [remap["status"], hit["status"], cold["status"]],
            "served": remap["served"], "pages": leaves[0].shape[0] if leaves else 0,
            "bytes": sent, "pull_s": pull_s,
            "mb_per_s": sent / 1e6 / pull_s if pull_s else None,
            "pages_equal_owner_export": bool(leaves) and pages_equal(
                leaves, owner_export(pool_o, ids, pulled)),
            "reply_equals_owner_hit": remap["reply"] == hit["reply"],
            "reply_equals_cold": remap["reply"] == cold["reply"],
            "ttft_s": {"pull": remap["ttft_s"], "owner_hit": hit["ttft_s"],
                       "cold": cold["ttft_s"]},
            "reused_tokens": {"pull": remap["reused_tokens"], "owner_hit": hit["reused_tokens"],
                              "cold": cold["reused_tokens"]},
            "migration": {k: migs[A].status()["counters"][k]
                          for k in ("pulls", "pulled_pages", "failures")}}
        rm = out["remap"]
        if set(rm["statuses"]) != {200} or rm["served"] != [A] or not rm["pages"] \
                or not rm["pages_equal_owner_export"] or not rm["reply_equals_owner_hit"] \
                or rm["migration"]["failures"]:
            bad.append("pull-on-remap")

        # the owner's decode while a peer pulls its pages (the export holds
        # the pool's lock across the copy to the host)
        out["export_stall"] = export_stall(
            pb, migs[B].wire_addr, ids or pool_o.hot_prefixes(1)[0]["ids"], engines[B])

        # the remap turn's trace: the router's attempt and the replica's spans
        rid = remap["request_id"]
        doc: dict = {}
        t1 = time.time()
        while time.time() - t1 < 30:
            st, doc = _http(rport, "GET", f"/debug/fleet/traces/{rid}")
            if st == 200 and doc.get("fragments", 0) >= 2 and doc.get("finished"):
                break
            time.sleep(0.1)
        attempts = [c for c in (doc.get("root") or {}).get("children", [])
                    if c.get("name") == "proxy.attempt"]
        grafted = [c for a in attempts for c in a.get("children", [])
                   if c.get("attrs", {}).get("hop")]
        events = [e["name"] for g in grafted for e in g.get("events", [])]
        out["trace"] = {"fragments": doc.get("fragments"), "processes": doc.get("processes"),
                        "orphans": doc.get("orphans"), "attempts": len(attempts),
                        "grafted": len(grafted), "pull_event": "kv_migrate_pull" in events}
        if not doc.get("stitched") or doc.get("orphans") or not grafted:
            bad.append("trace")

        # /metrics/fleet: the counters are the replicas' sums (B re-admitted)
        table._readmit(B)
        texts = [_request(p, "GET", "/metrics")[2].decode() for p in (pa, pb)]
        fed = _request(rport, "GET", "/metrics/fleet")[2].decode()
        fams = ("prefix_cache_hits_total", "prefix_cache_reused_tokens_total",
                "kv_migration_pulls_total", "kv_migration_pages_total",
                "kv_migration_pushes_total")
        out["federation"] = {f: fleet_sums([fed], f) == fleet_sums(texts, f) for f in fams}
        out["federation"]["slo_fleet"] = 'scope="fleet"' in fed
        if not all(out["federation"].values()):
            bad.append("federation")

        # scale-out: C joins owning the conversation, pre-pulls A's and B's
        # hot prefixes before READY, and the fourth turn, asked again, hits
        # there
        key = fleet_key(ctx)
        while True:
            pc = _free_port()
            C = f"127.0.0.1:{pc}"
            if rendezvous_rank(key, [A, B, C])[0] == C:
                break
        t1 = time.time()
        app_c = stack.enter_context(served_settings(
            replica(fleet_peers=f"{A},{B}"), pc, Tracer(1.0, 64)))[1]
        up_c = time.time() - t1
        warm = app_c.state.migration.status()["counters"]
        table3 = PeerTable(peers=[A, B, C], probe_seconds=600.0).start()
        rp3 = stack.enter_context(serving_router(FleetRouter(table3, policy="affinity")))
        engines[C] = app_c.state.engine
        nxt = fleet_turn(rp3, ctx, engines)
        wtext = _request(pc, "GET", "/metrics")[2].decode()
        out["warm_up"] = {"up_s": round(up_c, 2), "warmup_pulls": warm["warmup_pulls"],
                          "pulled_pages": warm["pulled_pages"],
                          "skipped_warm": warm["skipped_warm"],
                          "pulls_metric": labelled(prom_samples(wtext,
                                                                "kv_migration_pulls_total")),
                          "turn": {k: nxt[k] for k in ("status", "served", "reused_tokens",
                                                       "ttft_s")}}
        if not warm["warmup_pulls"] or nxt["served"] != [C] or not nxt["reused_tokens"] \
                or nxt["status"] != 200:
            bad.append("warm-up")
        out["pages_pinned"] = {a: e.kv_pool_occupancy()["pages_pinned"]
                               for a, e in engines.items()}
        del engines, migs, apps, app_c
    for k, n in read_launches("fleet", counters).items():
        launches[k] += n
    say("fleet", **out)
    if bad:
        raise AssertionError(f"fleet: {bad}: {out}")
    gc.collect()
    return launches



def pod_metric(pod, family: str, **labels) -> float:
    """A pod's ``family`` summed over its samples whose labels include
    ``labels``."""
    text = _request(pod.port, "GET", "/metrics")[2].decode()
    return sum(v for key, v in prom_samples(text, family).items()
               if all((k, str(x)) in key for k, x in labels.items()))


def router_healthy(rpod, n: int, timeout: float = 60) -> float:
    """Seconds until the router's table holds ``n`` healthy replicas."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if _http(rpod.port, "GET", "/health")[1]["healthy"] == n:
            return time.time() - t0
        time.sleep(0.1)
    raise AssertionError(f"router: not {n} healthy replicas in {timeout}s: "
                         f"{_http(rpod.port, 'GET', '/health')[1]}")


def stream_killed(port: int, payload: dict, pod) -> dict:
    """A ``/v1`` stream at ``port``; ``pod`` is SIGKILLed at its first
    content event.  Events before and after the kill, the seconds from the
    kill to the stream's end, and how it ended."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    out = {"events_before": 0, "events_after": 0, "ended": None}
    killed_at = None
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(payload),
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        while True:
            try:
                line = resp.readline()
            except (http.client.HTTPException, OSError) as e:
                out["ended"] = type(e).__name__
                break
            if not line:
                out["ended"] = "eof"
                break
            if not line.startswith(b"data: "):
                continue
            if killed_at is None:
                out["events_before"] += 1
                pod.stop(kill=True)
                killed_at = time.time()
            else:
                out["events_after"] += 1
                if line.strip() == b"data: [DONE]":
                    out["ended"] = "done"
                    break
    finally:
        conn.close()
    out["end_after_kill_s"] = time.time() - killed_at if killed_at else None
    return out


def run_tool(name: str, *args: str, timeout: float = 120) -> subprocess.CompletedProcess:
    """``python -m llama_fastapi_k8s_gpu_tpu_torch.tools.<name> args`` from
    the checkout, its output captured, in a process group of its own: past
    ``timeout`` the whole group (a drill's replicas too) is killed and
    ``TimeoutExpired`` raised."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (HERE, os.environ.get("PYTHONPATH")))))
    argv = [sys.executable, "-m", f"{PKG}.tools.{name}", *args]
    proc = subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def traced_fleet_request(rport: int, addrs: list) -> dict:
    """One ``/v1`` request through the router at ``rport``, its trace pulled
    by ``tools.fleet_trace`` (``--json`` until both fragments are in and the
    tree is finished, then rendered): the stitched tree's processes,
    fragments, orphans and the rendered lines; ``ok`` when the tree spans
    the router and the request's owner with no orphan fragment."""
    from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.affinity import rendezvous_rank

    user = "trace-0"
    owner = rendezvous_rank(f"u:{user}", addrs)[0]
    st, headers, _ = _request(rport, "POST", "/v1/chat/completions",
                              v1_body(None, user=user), timeout=900)
    rid = headers.get("x-request-id", "")
    router = ("--router", f"http://127.0.0.1:{rport}", "--trace", rid)
    doc = None
    t0 = time.time()
    while time.time() - t0 < 30:
        r = run_tool("fleet_trace", *router, "--json")
        if r.returncode == 0:
            doc = json.loads(r.stdout)
            if doc.get("fragments", 0) >= 2 and doc.get("finished"):
                break
        time.sleep(0.2)
    render = run_tool("fleet_trace", *router)
    out = {"status": st, "trace_id": rid, "owner": owner, "exit": render.returncode,
           "fragments": (doc or {}).get("fragments"), "processes": (doc or {}).get("processes"),
           "orphans": len((doc or {}).get("orphans") or ()), "tree": render.stdout.splitlines()}
    out["ok"] = bool(st == 200 and render.returncode == 0 and doc and doc.get("stitched")
                     and not doc.get("orphans") and doc.get("fragments", 0) >= 2
                     and "router" in doc.get("processes", ()) and owner in doc["processes"]
                     and "WARNING" not in render.stdout)
    return out


def phase_fleet_pods(paths: dict) -> dict:
    """``fleet_pods``: a router process (``LFKT_FLEET_ROLE=router``) and two
    replica server processes on the card, A and B (``LFKT_MIGRATE=1``,
    ``LFKT_FLEET_PEERS``, ``LFKT_MIGRATE_SELF``), the Q4_K_M file each; the
    router's added TTFT, direct against routed.  SIGKILL drill: B killed
    mid-stream (the stream ends, bounded); the next turns answer 200 from A
    by local prefill with the failed pulls attributed, the router's
    ``/health`` names the ejection and its recorder holds a
    ``fleet_peer_ejected`` bundle; B restarted and re-admitted fresh is
    stamped with the interim owner A, pulls its conversations back
    (``reason="remap"``) and hits.  SIGTERM drain: the drain's candidate
    set of conversations on A, which is then SIGTERMed and pushes them to
    its successor B within its drain budget; each next turn hits on B."""
    from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.affinity import rendezvous_rank

    d, name = os.path.split(paths["q4km"])
    pa, pb = _free_port(), _free_port()
    A, B = f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"
    # an arena of eight full contexts (the default holds four): the
    # successor keeps a whole drain of LFKT_MIGRATE_TOP_K conversations
    common = dict(LFKT_MODEL_DIR=d, LFKT_MODEL_NAME=name, LFKT_KV_PAGED="1",
                  LFKT_KV_POOL_PAGES="64",
                  LFKT_MAX_GEN_TOKENS=str(TIER_TOKENS), LFKT_TEMPERATURE="0",
                  LFKT_TIMEOUT_SECONDS="600", LFKT_MIGRATE="1",
                  LFKT_MIGRATE_BIND="127.0.0.1", LFKT_MIGRATE_PORT="0",
                  LFKT_FLEET_PEERS=f"{A},{B}")
    incidents = os.path.join(CACHE, "pods", "router_incidents")
    shutil.rmtree(incidents, ignore_errors=True)
    router_env = dict(LFKT_FLEET_ROLE="router", LFKT_FLEET_PEERS=f"{A},{B}",
                      LFKT_FLEET_PROBE_SECONDS="0.5", LFKT_FLEET_EJECT_BACKOFF_SECONDS="0.5",
                      LFKT_FLEET_EJECT_BACKOFF_MAX="2", LFKT_INCIDENT_DIR=incidents,
                      LFKT_INCIDENT_DEBOUNCE_S="0")
    pods: list = []
    out: dict = {}
    bad: list = []
    t0 = time.time()
    try:
        pod_a = Pod("fleet_a", dict(common, LFKT_MIGRATE_SELF=A), pa)
        pod_b = Pod("fleet_b", dict(common, LFKT_MIGRATE_SELF=B), pb)
        pods += [pod_a, pod_b]
        out["up_s"] = {"a": pod_a.ready(), "b": pod_b.ready()}
        rpod = Pod("fleet_router", router_env)
        pods.append(rpod)
        out["up_s"]["router"] = rpod.ready()
        with open(f"/proc/{rpod.proc.pid}/maps") as fh:
            maps = fh.read()
        with open(f"/proc/{rpod.proc.pid}/status") as fh:
            rss = next(ln.split()[1] for ln in fh if ln.startswith("VmRSS"))
        out["router_process"] = {"libtorch_mapped": "libtorch" in maps, "rss_kb": int(rss)}
        if out["router_process"]["libtorch_mapped"]:
            bad.append("router loaded torch")

        # the router's added TTFT: one warm conversation on A, streamed in
        # turns direct and through the router (the router its own process)
        skip: set = set()
        warm = fleet_conv(A, [A, B], skip)[1]
        _http(rpod.port, "POST", "/response", body(warm), timeout=900)
        ttft: dict = {"direct": [], "routed": []}
        for _ in range(3):
            for arm, port in (("direct", pa), ("routed", rpod.port)):
                ttft[arm].append(_sse(port, "/response/stream", body(warm),
                                      timeout=900)["first_content_s"])
        out["router_ttft_s"] = {k: sorted(v)[1] for k, v in ttft.items()}

        # one traced request through the router, rendered by the operator
        # tool: one stitched tree over the router and its owner
        traced = traced_fleet_request(rpod.port, [A, B])
        say("fleet_trace", **{k: v for k, v in traced.items() if k != "tree"})
        print("\n".join("  " + ln for ln in traced["tree"]), flush=True)
        out["fleet_trace"] = {k: traced[k] for k in ("ok", "fragments", "orphans")}
        if not traced["ok"]:
            bad.append("fleet_trace")

        # SIGKILL drill: three /v1 conversations on B, B killed mid-stream
        users = [u for u in (f"kill-{i}" for i in range(512))
                 if rendezvous_rank(f"u:{u}", [A, B])[0] == B][:3]
        hist = {u: [{"role": "user", "content": FLEET_V1_MSG + f" ({u})"}] for u in users}

        def v1_turn(u, port, k):
            st, _ = _http(port, "POST", "/v1/chat/completions",
                          v1_body(None, user=u, messages=hist[u]), timeout=900)
            hist[u] = hist[u] + [{"role": "assistant", "content": FLEET_ACK},
                                 {"role": "user", "content": FLEET_FOLLOW[k]}]
            return st

        warm_st = [v1_turn(u, rpod.port, 0) for u in users]
        killed = stream_killed(rpod.port, v1_body(None, user=users[0], stream=True,
                                                  max_tokens=400, messages=hist[users[0]]),
                               pod_b)
        fails0 = pod_metric(pod_a, "kv_migration_failures_total")
        t1 = time.time()
        spill = [v1_turn(u, rpod.port, 1) for u in users]
        spill_s = time.time() - t1
        health_a = _http(pa, "GET", "/health")[1]
        rhealth = _http(rpod.port, "GET", "/health")[1]
        row_b = next(p for p in rhealth["peers"] if p["addr"] == B)
        bundles = []
        for fn in sorted(os.listdir(incidents)) if os.path.isdir(incidents) else []:
            if fn.endswith("fleet_peer_ejected.json"):
                with open(os.path.join(incidents, fn)) as fh:
                    bundles.append(json.load(fh))
        out["sigkill"] = {
            "warm_statuses": warm_st, "stream": killed, "spill_statuses": spill,
            "spill_s": spill_s,
            "failures": pod_metric(pod_a, "kv_migration_failures_total") - fails0,
            "failure_reasons": labelled(prom_samples(
                _request(pa, "GET", "/metrics")[2].decode(), "kv_migration_failures_total")),
            "last_error": health_a["migration"]["last_error"], "router_row": row_b,
            "bundles": [{"peer": b["extra"].get("peer"), "reason": b["reason"],
                         "fleet": b.get("fleet")} for b in bundles]}
        # the operator tool's schema gate over the router's bundles
        report = run_tool("incident_report", "--validate", "--dir", incidents)
        verdict = (report.stdout.strip().splitlines() or [""])[-1]
        m = re.search(r"\((\d+) bundle\(s\), (\d+) violation", verdict)
        out["incident_report"] = {"exit": report.returncode, "verdict": verdict,
                                  "bundles": int(m.group(1)) if m else None}
        if report.returncode != 0 or not m or int(m.group(1)) < 1 or int(m.group(2)):
            bad.append("incident_report")
        sk = out["sigkill"]
        if set(warm_st) != {200} or set(spill) != {200} or killed["ended"] == "done" \
                or killed["end_after_kill_s"] is None or killed["end_after_kill_s"] > 30 \
                or sk["failures"] < 1 or not sk["last_error"] or row_b["healthy"] \
                or not row_b["last_error"] or not any(b["peer"] == B for b in sk["bundles"]):
            bad.append("sigkill")

        # B restarts; re-admitted fresh, it is stamped with the interim owner
        # A and pulls its conversations back.  Its warm-up pre-pulls at most
        # one prefix (LFKT_MIGRATE_TOP_K=1, as the reference's drill), so
        # what it pulls back is pull-on-remap
        pod_b2 = Pod("fleet_b_restarted", dict(common, LFKT_MIGRATE_TOP_K="1",
                                               LFKT_MIGRATE_SELF=B), pb)
        pods.append(pod_b2)
        out["restart_up_s"] = pod_b2.ready()
        out["readmit_s"] = router_healthy(rpod, 2)
        back = []
        for u in users:
            before = pod_metric(pod_b2, "prefix_cache_reused_tokens_total")
            st = v1_turn(u, rpod.port, 2)
            back.append({"status": st, "reused_tokens":
                         pod_metric(pod_b2, "prefix_cache_reused_tokens_total") - before})
        mig_b = _http(pb, "GET", "/health")[1]["migration"]
        out["pull_back"] = {
            "turns": back,
            "remap_pulls": pod_metric(pod_b2, "kv_migration_pulls_total", reason="remap"),
            "warmup_pulls": mig_b["counters"]["warmup_pulls"],
            "pulled_pages": mig_b["counters"]["pulled_pages"],
            "skipped_warm": mig_b["counters"]["skipped_warm"],
            "last_error": mig_b["last_error"]}
        if not all(t["status"] == 200 and t["reused_tokens"] > 0 for t in back) \
                or out["pull_back"]["remap_pulls"] < 1:
            bad.append("pull back")

        # SIGTERM drain: the drain's full candidate set (LFKT_MIGRATE_TOP_K,
        # 8) of long conversations on A (~6 pages each), then A drains to B
        convs = [fleet_conv(A, [A, B], skip, " " + STORY * 3)[1] for _ in range(8)]
        firsts = [_http(rpod.port, "POST", "/response", body(c), timeout=900)[0]
                  for c in convs]
        records = _http(pa, "GET", "/health")[1]["migration"]["records"]
        pulls0 = pod_metric(pod_b2, "kv_migration_pulls_total", reason="drain")
        pages0 = pod_metric(pod_b2, "kv_migration_pages_total", reason="pulled")
        t1 = time.time()
        pod_a.stop()                                        # SIGTERM
        exit_s = time.time() - t1
        m = re.search(r"drain pushed (\d+)/(\d+) conversations in ([\d.]+)s", pod_a.tail(20000))
        nexts = []
        for c in convs:
            before = pod_metric(pod_b2, "prefix_cache_reused_tokens_total")
            st2, _ = _http(rpod.port, "POST", "/response", body(fleet_next(c, 0)),
                           timeout=900)
            nexts.append({"status": st2,
                          "reused_tokens": pod_metric(pod_b2, "prefix_cache_reused_tokens_total")
                          - before})
        out["sigterm_drain"] = {
            "first_statuses": firsts, "records_on_owner": records,
            "pushes": int(m.group(1)) if m else None, "candidates": int(m.group(2)) if m else None,
            "drain_s": float(m.group(3)) if m else None, "owner_exit_s": exit_s,
            "exit_code": pod_a.proc.returncode,
            "drain_pulls": pod_metric(pod_b2, "kv_migration_pulls_total", reason="drain")
            - pulls0,
            "pages_pulled": pod_metric(pod_b2, "kv_migration_pages_total", reason="pulled")
            - pages0, "next_turns": nexts}
        # the drain hands the newest conversations across first
        dr = out["sigterm_drain"]
        pushed = nexts[len(nexts) - (dr["pushes"] or 0):]
        if set(firsts) != {200} or records < 8 or (dr["pushes"] or 0) < 3 \
                or dr["drain_pulls"] != dr["pushes"] or not all(n["status"] == 200 for n in nexts) \
                or not all(n["reused_tokens"] > 0 for n in pushed):
            bad.append("sigterm drain")
        out["pages_pinned"] = _http(pb, "GET", "/health")[1]["engine"]["kv_pool"]["pages_pinned"]
    finally:
        for p in pods:
            p.stop()
    out["seconds"] = time.time() - t0
    say("fleet_pods", **out)
    if bad:
        raise AssertionError(f"fleet_pods: {bad}: {out}; logs: "
                             + " | ".join(f"{p.name}: {p.tail(1500)}" for p in pods))
    return out


#: the chaos drill's scenarios on the card; ``sigkill`` and ``drain``, which
#: :func:`phase_fleet_pods` drills on the same file, are not repeated
DRILLS = ("torn-wire", "slow-wire", "reload")


def phase_drills(paths: dict) -> dict:
    """``drills``: ``python -m llama_fastapi_k8s_gpu_tpu_torch.tools.chaos_drill``
    over the Q4_K_M file, a child process whose scenarios (:data:`DRILLS`)
    each boot two replica server processes on the card behind the drill's
    router; a ``drills`` line a scenario (the invariants it held, its
    seconds), the replicas' logs under ``.cache/chip_smoke/pods/drills``."""
    d, name = os.path.split(paths["q4km"])
    logs = os.path.join(CACHE, "pods", "drills")
    shutil.rmtree(logs, ignore_errors=True)
    t0 = time.time()
    r = run_tool("chaos_drill", *DRILLS, "--model-dir", d, "--model-name", name,
                 "--json", "--log-dir", logs, timeout=900)
    rows = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    for row in rows:
        say("drills", **row)
    out = {"exit": r.returncode, "seconds": time.time() - t0,
           "held": [row["drill"] for row in rows if row["ok"]]}
    if r.returncode != 0 or out["held"] != list(DRILLS):
        raise AssertionError(f"drills: {out}: {r.stdout[-4000:]}{r.stderr[-4000:]}")
    return out


def phase_fleet_tier(paths: dict, counters: dict) -> dict:
    """The fleet phases on the Q4_K_M file; returns each kernel's launches
    on the in-process phase's served path."""
    import torch

    t0 = time.time()
    launches = phase_fleet(paths, counters)
    torch.cuda.empty_cache()
    say("phase_seconds", name="phase_fleet", seconds=round(time.time() - t0, 1))
    t0 = time.time()
    phase_fleet_pods(paths)
    say("phase_seconds", name="phase_fleet_pods", seconds=round(time.time() - t0, 1))
    return launches


def phase_tier(paths: dict, counters: dict) -> dict:
    """The registry and disagg phases on the Q4_K_M, Q6_K and mixed files;
    returns each kernel's launches summed over their served paths."""
    import torch

    launches = dict.fromkeys(counters, 0)
    for phase in (phase_registry, phase_registry_looped, phase_registry_lanes, phase_disagg):
        t0 = time.time()
        for name, n in phase(paths, counters).items():
            launches[name] += n
        gc.collect()
        torch.cuda.empty_cache()
        say("phase_seconds", name=phase.__name__, seconds=round(time.time() - t0, 1))
    t0 = time.time()
    phase_disagg_pods(paths)
    say("phase_seconds", name="phase_disagg_pods", seconds=round(time.time() - t0, 1))
    return launches


# ---------------------------------------------------------------------------
# the mesh phase: tensor parallelism in the lane engines and the
# sequence-parallel engine, every shard on the one card
# ---------------------------------------------------------------------------

#: the mesh engines' ring: long enough for the sp arm's prompt to span both
#: sp shards (2,048 slots each)
MESH_N_CTX = 4096
#: greedy tokens of each turn held to the one-card engine's (bf16 ties
#: past them: ROADMAP C.3)
MESH_TOKENS = 16
#: decode tokens of the sp arm's long prompt
MESH_SP_DECODE = 32
#: the 8B tp = 2 shard shapes (N × K) of each fused kernel on the Q4_K_M
#: path: wq and wo, wk, w_gate and w_up (Q4_K); attn_v, w_down, the head (Q6_K)
MESH_SHAPES = {"q4k_matmul": ((2048, 4096), (512, 4096), (7168, 4096)),
               "q6k_matmul": ((512, 4096), (2048, 14336), (64128, 4096))}
#: rows a shard's linear takes: a decode token, a prompt slice
MESH_BATCHES = (1, 256)
#: the flash kernel at a tp = 2 shard's heads (16 query heads over 4 kv
#: heads): S, n_ctx, offset
MESH_FLASH = ((256, 1024, 0), (256, 1024, 768))
#: kernels each arm's served path must launch
MESH_KERNELS = {"mesh_tp": ("dequant_q4_k", "q4k_matmul", "q6k_matmul", "flash_attention"),
                "mesh_sp": ("dequant_q4_k", "q4k_matmul", "q6k_matmul"),
                "mesh_paged": ("q4k_matmul", "q6k_matmul", "flash_attention_int8",
                               "kv_quantize"),
                "mesh_spec": ("q4k_matmul", "q6k_matmul", "flash_attention"),
                "mesh_looped": ("kv_quantize", "flash_attention_int8", "decode_loop")}
#: the looped kernel over tp = 2 shard tables (``mesh_loop`` lines): layers
#: a launch and the ring slot, as the one-card kernel's row is timed
MESH_LOOP_LAYERS = 2
MESH_LOOP_POS = 700
#: a sharded launch's h against the one-card launch's over bf16 weights:
#: the looped kernel's agreement figure (PERF.md §6); int8 weights must be
#: bit-equal (int32 partials are exact)
MESH_LOOP_TOL = 3.3e-3
#: the lane engine whose weights (the Q8_0 file as bf16, not loaded again)
#: the ``mesh_looped`` arm shards, and its knobs
MESH_LOOPED_SOURCE = "cycle_q8_0_bf16_loop8"
MESH_LOOPED_UNROLL = 8
#: the paged arm's second conversation: it opens as the long one does (the
#: system prompt and the first message are the prefix the two share)
MESH_SECOND_CTX = [LONG_CTX[0], ("assistant", "go on, I am listening."),
                   ("user", "part 1: " + STORY[:80])]
#: the first step's logits of a mesh engine against the one-card engine's:
#: max |Δ| ÷ max |logit|
MESH_LOGIT_TOL = 2e-2
#: how far below the one-card engine's top logit a mesh reply's token may
#: lie, teacher-forced, in bf16 steps of the top
MESH_TIE_STEPS = 2


def check_mesh_kernels(rng) -> list:
    """Every fused kernel of the Q4_K_M path at its tp = 2 shard shapes,
    held to its plain version (:func:`check_matmul`: ms, plain, library,
    graph, bound), beside the same kernel's graph ms at the unsharded
    shape (2N × K); the flash kernel at a shard's heads beside all 32
    heads.  ``mesh_matmul`` / ``mesh_flash`` lines; returns them."""
    import numpy as np
    import torch

    rows = []
    for name, shapes in MESH_SHAPES.items():
        kern, _, rand, _ = fused_formats()[name]
        for n, k in shapes:
            full = torch.from_numpy(np.ascontiguousarray(rand(rng, 2 * n, k))).cuda()
            for B in MESH_BATCHES:
                line = check_matmul(name, rng, n, k, B)
                x = torch.from_numpy(rng.standard_normal((B, k), np.float32)).cuda().to(
                    torch.bfloat16)
                line.update(name=name, tp=2, unsharded=[2 * n, k],
                            unsharded_graph_ms=graph_ms(lambda: kern(x, full, 2 * n, k)))
                if B == 1:
                    line["unsharded_cold_graph_ms"] = cold_graph_ms(
                        lambda t: kern(x, t, 2 * n, k), full)
                say("mesh_matmul", **line)
                rows.append(line)
            del full
    for S, n_ctx, off in MESH_FLASH:
        line = check_flash(rng, S, n_ctx, off, H=16, n_kv=4)
        whole = check_flash(rng, S, n_ctx, off)
        line.update(name="flash_attention", heads=[16, 4], unsharded_heads=[32, 8],
                    unsharded_graph_ms=whole["graph_ms"])
        say("mesh_flash", **line)
        rows.append(line)
    for w_int8 in (False, True):
        for kv_int8 in (False, True):
            line = check_mesh_loop(w_int8, kv_int8)
            say("mesh_loop", **line)
            rows.append(line)
    return rows


def check_mesh_loop(w_int8: bool, kv_int8: bool, K: int = MESH_LOOP_LAYERS,
                    pos: int = MESH_LOOP_POS, n_ctx: int = 1024) -> dict:
    """Kernel 11 over tp = 2 shard tables (``[cuda:0] * 2``): K Llama-3-8B
    layers of random weights (:func:`check_decode_loop`'s), laid over the
    shards by the mesh's rules (``wo``/``w_down`` split K, the rest N), and
    their ring written into a sharded ring through the paged pool's head
    map; one token at slot ``pos``.  The launch against the one-card launch
    over the whole weights and ring: h bit-equal for int8 weights, within
    :data:`MESH_LOOP_TOL` rel-dev for bf16, and the ring read back whole
    (``read_shards_plain``) likewise; against the plain mesh version (the
    per-layer mesh source) as :func:`check_decode_loop` holds one card.
    ms, graph ms, the one-card graph ms, the plain ms; the bound is the
    whole stack's (the shards hold the same bytes)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.config import LLAMA3_8B
    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import init_cache
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import LOOP_LINEARS, synth_params
    from llama_fastapi_k8s_gpu_tpu_torch.ops import decode_loop, kvquant
    from llama_fastapi_k8s_gpu_tpu_torch.parallel import mesh as pmesh

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=K, vocab_size=256, n_ctx=n_ctx,
                              kv_dtype="int8" if kv_int8 else "bf16")
    fmt = "int8" if w_int8 else "bf16"
    params = synth_params(cfg, fmt, seed=3, device="cuda")
    fmts = dict.fromkeys(LOOP_LINEARS, fmt)
    g = torch.Generator(device="cuda").manual_seed(4)
    cache = init_cache(cfg, torch.device("cuda"))
    for n in ("k", "v"):
        x = torch.randn((K, cfg.n_kv_heads, pos, cfg.head_dim), generator=g,
                        device="cuda").to(torch.bfloat16)
        if kv_int8:
            cache[n + "_q"][:, :, :pos], cache[n + "_s"][:, :, :pos] = kvquant.quantize_kv_plain(x)
        else:
            cache[n][:, :, :pos] = x
    h = torch.randn(1, cfg.dim, generator=g, device="cuda").to(torch.bfloat16)
    mesh = pmesh.make_mesh(tp=2, devices=["cuda:0"] * 2)
    mp = pmesh.shard_params(params, mesh, cfg)

    def sharded_ring():
        ring = pmesh.init_sharded_cache(cfg, mesh, tp_split=mp.tp_heads)
        for i, heads in ring.head_shards(write=True):
            for name in ring:
                ring[name][i].copy_(cache[name][:, heads])
        return ring

    one, ring, plain_ring = {k: v.clone() for k, v in cache.items()}, sharded_ring(), \
        sharded_ring()
    at = torch.tensor([pos], device="cuda")
    want = decode_loop.decode_loop_step(params, one, h, at, 0, cfg, fmts, K)
    got = decode_loop.decode_loop_step(mp, ring, h, at, 0, cfg, fmts, K)
    plain = decode_loop.decode_loop_plain(mp, plain_ring, h, at, 0, cfg, fmts, K)
    torch.cuda.synchronize()
    desc = decode_loop.describe_shards(mp, cfg, ring)
    whole = decode_loop.read_shards_plain(desc, [ring.part(i) for i in range(2)])[1]
    plain_whole = decode_loop.read_shards_plain(desc, [plain_ring.part(i) for i in range(2)])[1]
    bits = torch.equal(got.view(torch.int16), want.view(torch.int16))
    ring_bits = all(torch.equal(whole[n].view(torch.uint8), one[n].view(torch.uint8))
                    for n in one)
    one_rel = _rel(got, want)
    rel = _rel(got, plain)
    if not (torch.isfinite(got).all() and rel <= LOOP_TOL and one_rel <= MESH_LOOP_TOL
            and (bits and ring_bits or not w_int8)):
        raise AssertionError(f"mesh_loop w_int8={w_int8} kv_int8={kv_int8}: h rel-dev {one_rel} "
                             f"from the one-card launch (bit-equal {bits}, ring {ring_bits}), "
                             f"{rel} from the plain mesh version")
    where = (slice(None), slice(None), pos)
    one_slots = check_slots(whole, one, where, MESH_LOOP_TOL, codes=True)
    slots = check_slots(whole, plain_whole, where, LOOP_TOL, codes=True)
    wbytes = sum(b.numel() * b.element_size() for layer in params.layers
                 for b in layer.buffers())
    weights = sum(getattr(layer, n).weight.numel() for layer in params.layers
                  for n in LOOP_LINEARS)
    out = {
        "name": "decode_loop", "variant": f"{fmt} weights, {cfg.kv_dtype} ring", "tp": 2,
        "layout": {n: mp.layout[n] for n in LOOP_LINEARS}, "layers": K, "pos": pos,
        "h_bit_equal_one_card": bits, "ring_bit_equal_one_card": ring_bits,
        "h_rel_one_card": one_rel, "one_card_tol": MESH_LOOP_TOL,
        "one_card_slot_rel": one_slots["slot_rel"],
        "max_abs_err": (got.float() - plain.float()).abs().max().item(), "h_rel": rel,
        "tol": LOOP_TOL, **slots,
        "ms": cuda_ms(lambda: decode_loop.decode_loop_step(mp, ring, h, at, 0, cfg, fmts, K), 20),
        "graph_ms": graph_ms(lambda: decode_loop.decode_loop_step(mp, ring, h, at, 0, cfg,
                                                                  fmts, K)),
        "one_card_graph_ms": graph_ms(lambda: decode_loop.decode_loop_step(
            params, one, h, at, 0, cfg, fmts, K)),
        "plain_ms": cuda_ms(lambda: decode_loop.decode_loop_plain(mp, plain_ring, h, at, 0, cfg,
                                                                  fmts, K), 5),
        "library_ms": None,
        **loop_bound(wbytes, weights, K, cfg.n_kv_heads, cfg.n_heads, cfg.head_dim, cfg.dim,
                     pos + 1, w_int8, kv_int8),
    }
    del params, mp, cache, one, ring, plain_ring
    torch.cuda.empty_cache()
    return out


def check_ring_ops(rng) -> list:
    """``ring_attention`` (a 2,304-row prompt over the 4,096-slot ring at
    8B's heads, sp = 2 × tp = 2 on the card) and
    ``sharded_decode_attention`` (one query at slot 2,304) against their
    plain single-device version (``flash_attention_plain``: the whole
    ring's causal softmax, P rounded to bf16), timed beside it and SDPA:
    ``mesh_ring`` lines."""
    import torch
    import torch.nn.functional as F

    from llama_fastapi_k8s_gpu_tpu_torch.ops import attention
    from llama_fastapi_k8s_gpu_tpu_torch.parallel import ring
    from llama_fastapi_k8s_gpu_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=1, tp=2, sp=2, devices=["cuda:0"] * 4)
    H, n_kv, hd, n_ctx = 32, 8, 128, MESH_N_CTX

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype="float32")
                                ).cuda().to(torch.bfloat16)

    k, v = rnd(n_kv, n_ctx, hd), rnd(n_kv, n_ctx, hd)
    rows = []
    for name, S, off in (("ring_attention", 2304, 0), ("sharded_decode_attention", 1, 2304)):
        q = rnd(S, H, hd)
        sm = hd ** -0.5
        fn = ring.ring_attention if S > 1 else ring.sharded_decode_attention
        o = fn(q, k, v, off, sm, mesh=mesh)
        o_ref = attention.flash_attention_plain(q, k, v, off, sm)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        if not (torch.isfinite(o).all() and err <= 2e-2):
            raise AssertionError(f"{name}: max |ring-plain| {err} > 2e-2")
        key_end = off + S
        group = H // n_kv
        qh = q.permute(1, 0, 2)[None]
        kh = k[:, :key_end].repeat_interleave(group, 0)[None]
        vh = v[:, :key_end].repeat_interleave(group, 0)[None]
        mask = attention.attention_mask(off + torch.arange(S, device="cuda"), key_end, 0)
        visible = sum(off + t + 1 for t in range(S))
        line = {"name": name, "S": S, "n_ctx": n_ctx, "pos_offset": off, "sp": 2, "tp": 2,
                "max_abs_err": err, "tol": 2e-2,
                "ms": cuda_ms(lambda: fn(q, k, v, off, sm, mesh=mesh), 5),
                "graph_ms": graph_ms(lambda: fn(q, k, v, off, sm, mesh=mesh), reps=5),
                "plain_ms": cuda_ms(lambda: attention.flash_attention_plain(q, k, v, off, sm), 5),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask), 5),
                **bound(2 * q.numel() * 2 + 2 * n_kv * n_ctx * hd * 2, 4.0 * visible * H * hd)}
        say("mesh_ring", **line)
        rows.append(line)
    del k, v
    return rows


def mesh_long_messages(tokenize, at_least: int = 2304) -> list:
    """A conversation whose prompt passes ``at_least`` tokens: the story
    told over and over, a user turn at a time."""
    msgs = [{"role": "system", "content": "You are terse and kind."}]
    i = 0
    while len(tokenize(msgs)) <= at_least:
        msgs.append({"role": "user" if i % 2 == 0 else "assistant",
                     "content": f"{i}: " + STORY})
        i += 1
    msgs.append({"role": "user", "content": MISTRAL_FOLLOW_UP})
    return msgs


def mesh_bytes(eng) -> dict:
    """Device bytes a mesh shard holds (its weights and ring shards), by
    ``Mesh.label``."""
    from llama_fastapi_k8s_gpu_tpu_torch.parallel.mesh import ring_nbytes_by_device

    out = eng.params.nbytes_by_device()
    for ring in [eng._cache] + ([eng._bstate["cache"]] if hasattr(eng, "_bstate") else []):
        for label, b in ring_nbytes_by_device(ring).items():
            out[label] += b
    return out


def first_logits(eng, ids: list):
    """The engine's prompt-pass logits at the last of ``ids`` on a fresh
    ring (the pass padded to a multiple of 8 rows: the sp ring splits its
    rows)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import prefill

    ring = eng._new_ring()
    padded = list(ids) + [0] * (-len(ids) % 8)
    with torch.inference_mode():
        out = prefill(eng.params, eng.cfg, torch.tensor(padded, device=eng.device), len(ids),
                      ring)
    del ring
    return out.float()


def forced_gaps(serial, prompt: list, ids: list, sp) -> list:
    """``ids``, a greedy reply to the prompt ids ``prompt``, teacher-forced
    through the one-card serial engine: its own bucket prefill of the
    prompt, then one eager decode step a token of ``ids`` fed back — the
    step a replay runs, bit for bit (:func:`chain_margin`) — each step's
    logits through the sampling chain's penalties.  Returns, for each
    position, the gap from the chain's top logit down to ``ids[j]``'s in
    bf16 steps of the top: 0 where ``ids[j]`` is the one-card choice.
    ``serial`` must reuse no prefix (``prefix_cache=False``, not paged)."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import (
        apply_penalties,
        sampling_tensors,
        seed_window,
    )

    if serial._prefix_cache or getattr(serial, "_kv_paged", False):
        raise ValueError("forced_gaps needs an engine that reuses no prefix")
    n = len(prompt)
    knobs = sampling_tensors(sp, serial.device)
    gaps = []
    with serial._lock, torch.inference_mode():
        logits = serial._prefill_padded(list(prompt), n, serial._bucket_for(n))
        for j, tok in enumerate(ids):
            if j:
                logits = forward(serial.params, serial.cfg,
                                 torch.tensor(ids[j - 1:j], device=serial.device),
                                 torch.tensor(n + j - 1, device=serial.device), serial._cache)
            window, _ = seed_window(prompt + ids[:j], serial.device)
            pen = apply_penalties(logits.float(), window, knobs)
            top = pen.max().item()
            gaps.append((top - pen[tok].item()) / bf16_step(top))
    return gaps


def held_tokens(rows: list, refs: list, serial, sp, n: int = MESH_TOKENS) -> list:
    """Each mesh reply's first ``n`` greedy ids against the one-card
    engines': whether they equal the one-card reply on the same prompt (and
    where they first part), and the reply teacher-forced through the
    one-card serial engine (:func:`forced_gaps`).  A turn is held when
    every one of its ``n`` ids is the one-card choice or within
    :data:`MESH_TIE_STEPS` bf16 steps of it: a shard's linear sums in
    another order (the matrix-vector kernel splits K by N), so near-ties
    can turn, and every token after a parting is checked too."""
    out = []
    for r, ref in zip(rows, refs):
        a, b = r["ids"][:n], ref["ids"][:n]
        at = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                  None if len(a) == len(b) else min(len(a), len(b)))
        gaps = forced_gaps(serial, r["prompt"], a, sp)
        out.append({"same_prompt": r["prompt"] == ref["prompt"], "tokens": len(a),
                    "equal": at is None and r["prompt"] == ref["prompt"], "first_diff": at,
                    "forced_top": sum(g == 0.0 for g in gaps), "max_gap_steps": max(gaps),
                    "held": bool(a) and len(a) in (n, len(b)) and max(gaps) <= MESH_TIE_STEPS})
    return out


def phase_mesh_tp(path: str, counters: dict, ref) -> dict:
    """``mesh_tp``: a ``ContinuousEngine`` with tp = 2 and two lanes over
    ``[cuda:0, cuda:0]``, loaded from the file and served through
    ``create_app(engine=...)``: two concurrent ``/response`` clients (the
    short and the long prompt), the long prompt's follow-up turn and one
    ``/response/stream``.  Each turn's first :data:`MESH_TOKENS` greedy ids
    against the one-card lane engine's (two lanes, the same weights), and
    held by :func:`held_tokens`: teacher-forced through the one-card serial
    engine, every id its choice or within :data:`MESH_TIE_STEPS` bf16 steps
    of it; the first step's logits
    against the one-card engine's within :data:`MESH_LOGIT_TOL` rel-dev.
    Returns the served path's launches."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    settings = Settings(temperature=0.0, timeout_seconds=600.0, max_queue_size=8,
                        batch_size=2, scheduler="continuous")
    kw = dict(batch_size=2, max_gen_tokens=MESH_TOKENS, prefix_cache=False)

    def drive(eng) -> tuple[list, dict, float]:
        records: list = []
        lane_record(eng, records)
        app = create_app(engine=eng, settings=settings)
        with serving(app) as (port, _):
            t0 = time.time()
            wave, stream, _ = lane_wave(port, [SHORT_CTX, LONG_CTX], SHORT_CTX)
            long_reply = wave[1][1].get("response", "") if wave[1][0] == 200 else ""
            follow = LONG_CTX + [("assistant", long_reply[:40]), ("user", MISTRAL_FOLLOW_UP)]
            st, _ = _http(port, "POST", "/response", body(follow), timeout=900)
            wall = time.time() - t0
        statuses = [w[0] for w in wave] + [st, (stream or {}).get("status")]
        return records, {"statuses": statuses}, wall

    # the one-card reference: two lanes over the reference engine's weights
    one = ContinuousEngine.from_parts(ref.params, ref.cfg, ref.tokenizer, ref.template_kind, **kw)
    one.warmup()
    want, _, _ = drive(one)
    one.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    zero_counters(counters)
    t0 = time.time()
    eng = ContinuousEngine(path, tp=2, devices=["cuda:0"] * 2, n_ctx=MESH_N_CTX, **kw)
    eng.warmup()
    load_s = time.time() - t0
    replays0 = eng._lane_graphs.replays
    got, info, wall = drive(eng)
    launches = {name: fn.launches for name, fn in counters.items()}
    replays = eng._lane_graphs.replays - replays0
    key = lambda r: (tuple(r["prompt"]), r["stream"])   # noqa: E731
    refs = {key(r): r for r in want}
    held = held_tokens(got, [refs.get(key(r), {"prompt": None, "ids": []}) for r in got], ref,
                       served_sampling(settings))
    lg, lg_ref = first_logits(eng, got[0]["prompt"]), first_logits(ref, got[0]["prompt"])
    rel = ((lg - lg_ref).abs().max() / lg_ref.abs().max()).item()
    tokens = sum(len(r["ids"]) for r in got)
    out = {"file": "q4km", "mesh": eng.mesh.describe(), "load_s": load_s, "seconds": wall,
           "tokens": tokens, "tokens_per_s": tokens / wall, **info,
           "graph_replays": replays, "decode_is_graph_replay": replays > 0,
           "lane_capture_s": eng._lane_graphs.capture_s,
           "bytes_by_shard": mesh_bytes(eng),
           "allocated_bytes": torch.cuda.memory_allocated(),
           "turns": held, "first_logits_rel_dev": rel, "logit_tol": MESH_LOGIT_TOL,
           "formats": eng.params.formats(),
           "layout": eng.params.layout}
    say("mesh_tp", **out)
    say("launches", file="mesh_tp", **launches)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    silent = [n for n in MESH_KERNELS["mesh_tp"] if not launches[n]]
    if (silent or any(s != 200 for s in info["statuses"]) or len(held) < 4
            or not all(h["held"] for h in held)
            or not rel <= MESH_LOGIT_TOL or not replays):
        raise AssertionError(f"mesh_tp: silent kernels {silent}, or turns parting from the "
                             f"one-card engine's, or logits {rel} off: {out}")
    return launches


def phase_mesh_sp(path: str, counters: dict, ref) -> dict:
    """``mesh_sp``: an ``SPEngine`` with sp = 2 and tp = 2 at n_ctx 4096
    over ``[cuda:0] * 4``, loaded from the file: one prompt of more than
    2,304 tokens (it spans both sp shards) and :data:`MESH_SP_DECODE`
    greedy tokens, all of them held to the one-card ``Engine``'s at n_ctx
    4096 by :func:`held_tokens` (teacher-forced, each within
    :data:`MESH_TIE_STEPS` bf16 steps of its choice).  Returns the
    launches."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import SPEngine
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams

    msgs = mesh_long_messages(ref.tokenize_messages)
    # greedy under the completion call's own penalties, spelled out so
    # that the teacher-forced reading applies the same ones
    knobs = dict(temperature=0.0, frequency_penalty=0.0, presence_penalty=0.0,
                 repeat_penalty=1.1)
    want: list = []
    record_replies(ref, -1, want)
    try:
        ref.create_chat_completion(msgs, max_tokens=MESH_SP_DECODE, **knobs)
    finally:
        del ref._finish, ref.create_chat_completion
    zero_counters(counters)
    t0 = time.time()
    eng = SPEngine(path, sp=2, tp=2, n_ctx=MESH_N_CTX, devices=["cuda:0"] * 4,
                   max_gen_tokens=MESH_SP_DECODE)
    eng.warmup()
    load_s = time.time() - t0
    got: list = []
    record_replies(eng, -2, got)
    replays0 = eng._graphs.replays
    t0 = time.time()
    doc = eng.create_chat_completion(msgs, max_tokens=MESH_SP_DECODE, **knobs)
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    replays = eng._graphs.replays - replays0
    held = held_tokens(got, want, ref, SamplingParams(**knobs), n=MESH_SP_DECODE)
    lg, lg_ref = first_logits(eng, got[0]["prompt"]), first_logits(ref, got[0]["prompt"])
    rel = ((lg - lg_ref).abs().max() / lg_ref.abs().max()).item()
    t = doc["lfkt_timings"]
    out = {"file": "q4km", "mesh": eng.mesh.describe(), "load_s": load_s, "seconds": wall,
           "prompt_tokens": doc["usage"]["prompt_tokens"],
           "completion_tokens": doc["usage"]["completion_tokens"],
           "ttft_s": t["ttft_s"], "tokens_per_s": t["tokens_per_sec"],
           "buckets": eng.prefill_buckets, "graph_replays": replays,
           "decode_is_graph_replay": replays > 0, "captures": eng._graphs.captures,
           "bytes_by_shard": mesh_bytes(eng), "allocated_bytes": torch.cuda.memory_allocated(),
           "turn": held[0], "first_logits_rel_dev": rel, "logit_tol": MESH_LOGIT_TOL}
    say("mesh_sp", **out)
    say("launches", file="mesh_sp", **launches)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    silent = [n for n in MESH_KERNELS["mesh_sp"] if not launches[n]]
    turn = held[0]
    if (silent or out["prompt_tokens"] <= MESH_N_CTX // 2 or not replays
            or not turn["held"] or not rel <= MESH_LOGIT_TOL):
        raise AssertionError(f"mesh_sp: silent kernels {silent}, a short prompt, no replay, "
                             f"or the reply parting from the one-card engine's: {out}")
    return launches


def mesh_turns(eng, contexts: list, settings) -> list:
    """Each context of ``contexts`` (a callable one is called with the
    records so far) as one ``/response`` through the app, in order: the
    engine's lane records (prompt and generated ids, reused tokens, TTFT)
    with each request's status."""
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app

    records: list = []
    lane_record(eng, records)
    statuses = []
    with serving(create_app(engine=eng, settings=settings)) as (port, _):
        for ctx in contexts:
            ctx = ctx(records) if callable(ctx) else ctx
            st, _ = _http(port, "POST", "/response", body(ctx), timeout=900)
            statuses.append(st)
    del eng._finish_slot
    for r, st in zip(records, statuses):
        r["status"] = st
    return records


def pool_pages(pool, ids: list) -> list:
    """Host copies of the pages the pool holds for ``ids``' whole pages."""
    n = (len(ids) // pool.page_tokens) * pool.page_tokens
    lease = pool.acquire(ids, n)
    if lease is None:
        raise AssertionError(f"the pool holds none of the {n} tokens' pages")
    try:
        return pool.export_pages(lease)
    finally:
        pool.release(lease)


def phase_mesh_paged(path: str, counters: dict, ref) -> dict:
    """``mesh_paged``: a ``ContinuousEngine`` with tp = 2 and two lanes over
    ``[cuda:0, cuda:0]``, the paged pool over the int8 ring (pages of
    :data:`PAGE_TOKENS`, prefill slices as long), on the file's weights as
    the one-card engine ``ref`` loaded them (``from_parts``: sharded at
    construction; ``mesh_tp`` and ``mesh_sp`` load the file) and served
    through ``create_app(engine=...)``: the long conversation, its
    follow-up turn and a second conversation that opens as it does.  The
    follow-up and the second conversation must reuse pages; the pages
    covering the first turn's prompt must be byte-equal to the pages a
    one-card paged engine on the reference's weights commits for the same
    ids (a prompt pass over the shards is the one-card pass); each turn's
    greedy ids are held to that engine's by :func:`held_tokens`,
    teacher-forced through a one-card serial engine over the int8 ring.
    Returns the served path's launches."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    settings = Settings(temperature=0.0, timeout_seconds=600.0, max_queue_size=8,
                        batch_size=2, scheduler="continuous")
    kw = dict(batch_size=2, max_gen_tokens=MESH_TOKENS, kv_dtype="int8", kv_paged=True,
              kv_page_tokens=PAGE_TOKENS, prefill_chunk=PAGE_TOKENS)
    parts = (ref.params, ref.cfg, ref.tokenizer, ref.template_kind)

    def follow(records):
        long_reply = ref._decode_text(records[0]["ids"])
        return LONG_CTX + [("assistant", long_reply[:40]), ("user", MISTRAL_FOLLOW_UP)]

    one = ContinuousEngine.from_parts(*parts, **kw)
    one.warmup()
    want = mesh_turns(one, [LONG_CTX, follow, MESH_SECOND_CTX], settings)
    one_pages = pool_pages(one._kvpool, want[0]["prompt"])
    one_stats = one._kvpool.stats()
    one.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    zero_counters(counters)
    t0 = time.time()
    eng = ContinuousEngine.from_parts(*parts, tp=2, devices=["cuda:0"] * 2, **kw)
    eng.warmup()
    load_s = time.time() - t0
    replays0 = eng._lane_graphs.replays
    t0 = time.time()
    got = mesh_turns(eng, [LONG_CTX, lambda _: follow(want), MESH_SECOND_CTX], settings)
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    replays = eng._lane_graphs.replays - replays0
    pages = pool_pages(eng._kvpool, got[0]["prompt"])
    same = [torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
            for a, b in zip(pages, one_pages)]
    stats, occ = eng._kvpool.stats(), eng.kv_pool_occupancy()
    serial8 = Engine.from_parts(*parts, kv_dtype="int8", prefix_cache=False,
                                max_gen_tokens=MESH_TOKENS)
    held = held_tokens(got, want, serial8, served_sampling(settings))
    serial8.close()
    del serial8
    out = {"file": "q4km", "mesh": eng.mesh.describe(), "kv_dtype": "int8",
           "page_tokens": PAGE_TOKENS, "load_s": load_s, "seconds": wall,
           "statuses": [r["status"] for r in got],
           "prompt_tokens": [len(r["prompt"]) for r in got],
           "reused_tokens": [r["reused"] for r in got],
           "one_card_reused_tokens": [r["reused"] for r in want],
           "ttft_s": [r["ttft_s"] for r in got],
           "pool": {k: stats[k] for k in ("hits", "misses", "stored_pages", "restores",
                                          "reused_tokens", "commits")},
           "one_card_pool": {k: one_stats[k] for k in ("hits", "stored_pages", "reused_tokens")},
           "pages_compared": int(pages[0].shape[0]), "leaves": sorted(eng._kvpool.arena),
           "pages_byte_equal": all(same) and len(same) == len(one_pages),
           "pages_pinned": occ["pages_pinned"], "graph_replays": replays,
           "turns": held}
    say("mesh_paged", **out)
    say("launches", file="mesh_paged", **launches)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    silent = [n for n in MESH_KERNELS["mesh_paged"] if not launches[n]]
    if (silent or any(s != 200 for s in out["statuses"]) or not got[1]["reused"]
            or not got[2]["reused"] or not out["pages_byte_equal"] or out["pages_pinned"]
            or not replays or len(held) != 3 or not all(h["held"] for h in held)):
        raise AssertionError(f"mesh_paged: silent kernels {silent}, no page reuse, pages "
                             f"unlike the one-card engine's, or turns parting from its: {out}")
    return launches


def phase_mesh_spec(path: str, counters: dict, ref) -> dict:
    """``mesh_spec``: a ``ContinuousEngine`` with tp = 2 and two lanes over
    ``[cuda:0, cuda:0]`` with ``spec_decode="lookup"`` (D =
    :data:`SPEC_DRAFT`), on the file's weights as ``ref`` loaded them
    (``from_parts``), served through the app:
    the repeating prompt and the long one as two concurrent clients, each
    draft the one-card serial engine's greedy reply (:func:`oracle_drafts`,
    so rounds accept drafts).  The one-card lane engine with lookup on the
    reference's weights serves them first under the same drafts; each tp
    reply is held to its by :func:`held_tokens`.  Verify rounds, drafted and
    accepted tokens and verify-graph replays must all be counted.  Returns
    the served path's launches."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    settings = Settings(temperature=0.0, timeout_seconds=600.0, max_queue_size=8,
                        batch_size=2, scheduler="continuous")
    kw = dict(batch_size=2, max_gen_tokens=MESH_TOKENS, spec_decode="lookup",
              spec_draft=SPEC_DRAFT)
    contexts = [REPEAT_CTX, LONG_CTX]
    refs = serial_turns(ref, [("repeat", REPEAT_CTX), ("long", LONG_CTX)], settings)

    def drive(eng) -> tuple[list, list, float]:
        records: list = []
        lane_record(eng, records)
        with oracle_drafts(refs), serving(create_app(engine=eng, settings=settings)) as (port,
                                                                                         _):
            results, _, wall = lane_wave(port, contexts)
        del eng._finish_slot
        return records, [r[0] if r else None for r in results], wall

    parts = (ref.params, ref.cfg, ref.tokenizer, ref.template_kind)
    one = ContinuousEngine.from_parts(*parts, **kw)
    one.warmup()
    want, _, _ = drive(one)
    one_spec = one.scheduler_stats()["spec"]
    one.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    zero_counters(counters)
    t0 = time.time()
    eng = ContinuousEngine.from_parts(*parts, tp=2, devices=["cuda:0"] * 2, **kw)
    eng.warmup()
    load_s = time.time() - t0
    spec0 = dict(eng.scheduler_stats()["spec"])
    vreplays0 = eng._lane_graphs.verify_replays
    got, statuses, wall = drive(eng)
    launches = {name: fn.launches for name, fn in counters.items()}
    spec = {k: v - spec0.get(k, 0) for k, v in eng.scheduler_stats()["spec"].items()}
    vreplays = eng._lane_graphs.verify_replays - vreplays0
    refs_by_prompt = {tuple(r["prompt"]): r for r in want}
    held = held_tokens(got, [refs_by_prompt.get(tuple(r["prompt"]), {"prompt": None, "ids": []})
                             for r in got], ref, served_sampling(settings))
    tokens = sum(len(r["ids"]) for r in got)
    out = {"file": "q4km", "mesh": eng.mesh.describe(), "draft": SPEC_DRAFT, "load_s": load_s,
           "seconds": wall, "statuses": statuses, "tokens": tokens,
           "tokens_per_s": tokens / wall, "spec": spec, "one_card_spec": one_spec,
           "verify_replays": vreplays, "verify_capture_s": eng._lane_graphs.verify_capture_s,
           "verify_launches": eng._lane_graphs.verify_launches(), "turns": held}
    say("mesh_spec", **out)
    say("launches", file="mesh_spec", **launches)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    silent = [n for n in MESH_KERNELS["mesh_spec"] if not launches[n]]
    if (silent or any(s != 200 for s in statuses) or not spec["verify_steps"]
            or not spec["drafted"] or not spec["accepted"] or not vreplays
            or len(held) != 2 or not all(h["held"] for h in held)):
        raise AssertionError(f"mesh_spec: silent kernels {silent}, no verify round, no "
                             f"accepted draft, no verify replay, or turns parting from the "
                             f"one-card engine's: {out}")
    return launches


def looped_parts(path: str) -> tuple:
    """The Q8_0 file loaded as :data:`MESH_LOOPED_SOURCE` loads it (bf16
    weights, n_ctx 1024): its parts, for the ``mesh_looped`` arm run alone
    (``tools/port_mesh.py``); the full run hands the lane engine's on."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

    t0 = time.time()
    eng = Engine(path, n_ctx=1024, weight_format="bf16", kv_dtype="int8")
    parts = (eng.params, eng.cfg, eng.tokenizer, eng.template_kind)
    eng.close()
    say("mesh_looped_load", file="q8_0", seconds=round(time.time() - t0, 1))
    return parts


def phase_mesh_looped(parts: tuple, counters: dict) -> dict:
    """``mesh_looped``: a ``ContinuousEngine`` with tp = 2 and two lanes
    over ``[cuda:0, cuda:0]`` on the Q8_0 file's bf16 weights as
    :data:`MESH_LOOPED_SOURCE` loaded them (``parts``: sharded at
    construction, not loaded again), over the int8 ring with
    ``decode_layer_unroll`` = :data:`MESH_LOOPED_UNROLL`: every decode token
    of a lane 32/8 launches of kernel 11, each reading both shards, inside
    the lane graph.  Served through ``create_app(engine=...)`` as
    ``mesh_tp`` is (two concurrent clients, a stream, a follow-up turn);
    each turn's first :data:`MESH_TOKENS` ids against the one-card looped
    lane engine's on the same weights, held by :func:`held_tokens`
    (teacher-forced through a one-card serial looped engine, every id its
    choice or within :data:`MESH_TIE_STEPS` bf16 steps of it).  Returns the
    served path's launches."""
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine
    from llama_fastapi_k8s_gpu_tpu_torch.ops.decode_loop import effective_unroll
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import create_app
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    settings = Settings(temperature=0.0, timeout_seconds=600.0, max_queue_size=8,
                        batch_size=2, scheduler="continuous")
    kw = dict(batch_size=2, max_gen_tokens=MESH_TOKENS, prefix_cache=False, kv_dtype="int8",
              decode_layer_unroll=MESH_LOOPED_UNROLL)

    def drive(eng) -> tuple[list, list, float]:
        records: list = []
        lane_record(eng, records)
        with serving(create_app(engine=eng, settings=settings)) as (port, _):
            t0 = time.time()
            wave, stream, _ = lane_wave(port, [SHORT_CTX, LONG_CTX], SHORT_CTX)
            long_reply = wave[1][1].get("response", "") if wave[1][0] == 200 else ""
            follow = LONG_CTX + [("assistant", long_reply[:40]), ("user", MISTRAL_FOLLOW_UP)]
            st, _ = _http(port, "POST", "/response", body(follow), timeout=900)
            wall = time.time() - t0
        return records, [w[0] for w in wave] + [st, (stream or {}).get("status")], wall

    one = ContinuousEngine.from_parts(*parts, **kw)
    one.warmup()
    want, _, _ = drive(one)
    one.close()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    zero_counters(counters)
    t0 = time.time()
    eng = ContinuousEngine.from_parts(*parts, tp=2, devices=["cuda:0"] * 2, **kw)
    eng.warmup()
    load_s = time.time() - t0
    replays0 = eng._lane_graphs.replays
    got, statuses, wall = drive(eng)
    launches = {name: fn.launches for name, fn in counters.items()}
    replays = eng._lane_graphs.replays - replays0
    step = eng._lane_graphs.step_launches()
    key = lambda r: (tuple(r["prompt"]), r["stream"])   # noqa: E731
    refs = {key(r): r for r in want}
    serial = Engine.from_parts(*parts, kv_dtype="int8", prefix_cache=False,
                               decode_layer_unroll=MESH_LOOPED_UNROLL, max_gen_tokens=MESH_TOKENS)
    held = held_tokens(got, [refs.get(key(r), {"prompt": None, "ids": []}) for r in got], serial,
                       served_sampling(settings))
    serial.close()
    del serial
    tokens = sum(len(r["ids"]) for r in got)
    per_lane = eng.cfg.n_layers // effective_unroll(eng.cfg)
    out = {"file": "q8_0", "mesh": eng.mesh.describe(), "weights": eng.params.formats(),
           "kv_dtype": eng.cfg.kv_dtype, "decode_layer_unroll": eng.cfg.decode_layer_unroll,
           "layout": eng.params.layout, "shard_s": load_s, "seconds": wall, "tokens": tokens,
           "tokens_per_s": tokens / wall, "statuses": statuses, "graph_replays": replays,
           "lane_capture_s": eng._lane_graphs.capture_s,
           "lane_launches": {"per_replay": step, "expected": {"decode_loop": 2 * per_lane}},
           "decode_loop_launches": launches["decode_loop"], "turns": held}
    say("mesh_looped", **out)
    say("launches", file="mesh_looped", **launches)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    silent = [n for n in MESH_KERNELS["mesh_looped"] if not launches[n]]
    if (silent or any(s != 200 for s in statuses) or len(held) < 4
            or not all(h["held"] for h in held) or not replays
            or step.get("decode_loop") != 2 * per_lane or "kv_quantize" in step):
        raise AssertionError(f"mesh_looped: silent kernels {silent}, a lane graph that is not "
                             f"the looped path's, or turns parting from the one-card "
                             f"engine's: {out}")
    return launches


def phase_mesh(paths: dict, counters: dict, parts: tuple | None = None) -> dict:
    """The mesh phase: the kernels at a tp = 2 shard's shapes and the ring
    ops (off the served paths), then, on the Q4_K_M file, the ``mesh_tp``,
    ``mesh_sp``, ``mesh_paged`` and ``mesh_spec`` arms against the
    one-card engine at n_ctx 4096 (loaded once; closed last), and the
    ``mesh_looped`` arm on ``parts``, the Q8_0 file's bf16 weights (loaded
    from ``paths["q8_0"]`` when not given).  Returns each kernel's launches
    summed over the arms' served paths."""
    import numpy as np
    import torch

    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

    t0 = time.time()
    rng = np.random.default_rng(21)
    check_mesh_kernels(rng)
    check_ring_ops(rng)
    say("phase_seconds", name="mesh_kernels", seconds=round(time.time() - t0, 1))
    launches = dict.fromkeys(counters, 0)
    t0 = time.time()
    for name, n in phase_mesh_looped(parts or looped_parts(paths["q8_0"]), counters).items():
        launches[name] += n
    parts = None
    gc.collect()
    torch.cuda.empty_cache()
    say("phase_seconds", name="phase_mesh_looped", seconds=round(time.time() - t0, 1))
    ref = Engine(paths["q4km"], n_ctx=MESH_N_CTX, prefix_cache=False, max_gen_tokens=MESH_TOKENS)
    ref.warmup()
    try:
        for arm in (phase_mesh_tp, phase_mesh_sp, phase_mesh_paged, phase_mesh_spec):
            t0 = time.time()
            for name, n in arm(paths["q4km"], counters, ref).items():
                launches[name] += n
            say("phase_seconds", name=arm.__name__, seconds=round(time.time() - t0, 1))
    finally:
        ref.close()
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "llama_fastapi_k8s_gpu_tpu_torch")):
        print("chip_smoke: run from the root of a checkout of the repository "
              "(llama_fastapi_k8s_gpu_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from llama_fastapi_k8s_gpu_tpu_torch.obs.devtime import DEVTIME
    from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

    # full-f32 products in the plain versions' matmuls (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = lap = time.time()

    def timed(name: str) -> None:
        # the seconds since the last top-level phase ended
        nonlocal lap
        say("phase_seconds", name=name, seconds=round(time.time() - lap, 1))
        lap = time.time()

    info = phase_device()
    devtime_at_start = DEVTIME.counters()
    # the files are written beside the kernels' build, and are all on disk
    # before any kernel is timed
    jobs = start_ggufs()
    phase_build()
    timed("build")
    # the image's runtime stage on the Q4_K_M file, the first one written,
    # while the card waits for the others
    image = phase_image(jobs["q4km"].result())
    timed("image")
    paths = {key: job.result() for key, job in jobs.items()}
    say("ggufs", waited_s=round(time.time() - lap, 1), workers=GGUF_WORKERS)
    timed("ggufs")
    kernels, deq_lines = phase_kernels(KERNELS)
    timed("kernels")
    launches = dict.fromkeys(KERNELS, 0)
    # an earlier run's replies (CHIP_SMOKE_REPLIES), to print where each
    # greedy reply of this run parts from it
    earlier = []
    if os.environ.get("CHIP_SMOKE_REPLIES"):
        with open(os.environ["CHIP_SMOKE_REPLIES"]) as fh:
            earlier = json.load(fh)
    engines = [(layout, dict(follow_up=layout in ("q4km", "q6_k"),
                             kv_dtype=KV_DTYPES.get(layout, "bf16"),
                             deadline_request=layout == "q4km",
                             http_phase=layout == "q4km",
                             devtime_at_start=devtime_at_start))
               for layout in LAYOUTS]
    # the prefix-reuse follow-up rides on the Q4_K_M file and, over the
    # int8 ring, on the Q6_K file; the request at the reference's 25 s
    # timeout and the rest of the HTTP surface on the default Q4_K_M file
    engines += [(layout, dict(follow_up=False, kv_dtype=kv_dtype, weight_format=fmt,
                              unroll=unroll, label=label, expect_unroll=expect))
                for label, layout, fmt, kv_dtype, unroll, expect in LOOPED]
    # the Mistral-7B file at n_ctx 8192 (its window bites): fused over the
    # bf16 ring with the follow-up, /v1 and the 25 s request, and int8
    # weights looped over the int8 ring; then the mixed-type file under auto
    # (every linear bf16) and int8, its load timed by type
    engines += [("mistral", dict(layout="q4km", label=label, weight_format=fmt,
                                 kv_dtype=kv_dtype, unroll=unroll, expect_unroll=expect,
                                 follow_up=label == "mistral_q4km",
                                 deadline_request=label == "mistral_q4km",
                                 n_ctx=MISTRAL_N_CTX, mistral=True))
                for label, fmt, kv_dtype, unroll, expect in MISTRAL]
    engines += [("mixed", dict(layout="mixed", label=f"mixed_{fmt}", weight_format=fmt,
                               follow_up=False, load_probe=True))
                for fmt in ("auto", "int8")]
    six = None
    for ordinal, (key, kw) in enumerate(engines):
        if ordinal == len(ENGINES):
            six = dict(launches)       # the dequant plan covers the first six
        kw.setdefault("layout", key)
        served = phase_serve(path=paths[key], counters=KERNELS, ordinal=ordinal,
                             earlier=earlier, **kw)
        for name, n in served.items():
            launches[name] += n
    timed("serve")
    # the image pod's reply, held to the Q4_K_M engine's
    image_verdict(image, SERVED[("q4km", "short")])
    # the lane engines: batched serving from lanes of the card
    keep: dict = {}
    for name, n in phase_all_lanes(paths, KERNELS, keep=keep).items():
        launches[name] += n
    timed("lanes")
    # the mesh: tensor parallelism in the lane engines and the
    # sequence-parallel engine, every shard on this card; its looped arm
    # shards the looped lane engine's weights, so it runs before they are
    # held through the later phases
    for name, n in phase_mesh(paths, KERNELS, keep.pop("looped")).items():
        launches[name] += n
    timed("mesh")
    # the paged KV pool and prompt-lookup speculation on the Q4_K_M weights
    for name, n in phase_paged_spec(keep.pop("parts"), KERNELS).items():
        launches[name] += n
    timed("paged_spec")
    # multi-model serving and the disaggregated prefill/decode tier
    for name, n in phase_tier(paths, KERNELS).items():
        launches[name] += n
    timed("tier")
    # the fleet tier: the router over replicas and warm-page migration
    for name, n in phase_fleet_tier(paths, KERNELS).items():
        launches[name] += n
    timed("fleet_tier")
    # the chaos drill's wire and reload scenarios on replica processes
    phase_drills(paths)
    timed("drills")
    if os.environ.get("CHIP_SMOKE_REPLIES_OUT"):
        with open(os.environ["CHIP_SMOKE_REPLIES_OUT"], "w") as fh:
            json.dump(REPLIES, fh)
    say("dequant_rank", **dequant_rank(deq_lines, six))
    for name, n in launches.items():
        kernels[name]["launches"] = n
    missing = [n for n, c in launches.items() if c <= 0]
    summary = {"kernels": [{k: v for k, v in row.items() if k != "shapes"}
                           for row in kernels.values()]}
    print(json.dumps(summary), flush=True)
    if missing:
        raise AssertionError(f"kernels never launched on the served paths: {missing}")
    say("done", seconds=round(time.time() - t0, 1))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves on the GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one line each (a failing phase ends the run with a non-zero exit
and no result line):

1. device: the card's name and power limit (``nvidia-smi``) and CUDA;
2. build: the kernels of ``llama_fastapi_k8s_gpu_tpu_torch/csrc`` with
   ``nvcc``, timed;
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
   torch it absorbed (``absorbed_graph_ms``: the table and k's rotation);
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
   the port's own writer into ``.cache/chip_smoke/`` and reused when
   present (about 33 GB);
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
   bit for bit (``planes``);
6. a ``dequant_rank`` line: each dequant's launches × (time − bound)
   over the first six engines' loads, shape by shape (launches from the
   load plan, checked against the wrappers' counters of phase 5), largest
   first; then a ``kernels`` JSON line with every kernel's launches summed
   over the ten engines of phase 5 beside its phase-3 numbers.

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
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache", "chip_smoke")

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


def phase_build() -> None:
    from llama_fastapi_k8s_gpu_tpu_torch.ops import _kernels

    t0 = time.time()
    _kernels.library()
    log = _kernels.build_info.get("log", "").splitlines()
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
    say("build", seconds=round(time.time() - t0, 2),
        built=_kernels.build_info.get("built"), ptxas=ptxas, qmma=qmma)


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
    y = kern(x, w, n_out, k_in)
    y_ref = plain(x, w, n_out, k_in)
    deq = dequant_f32(w.reshape(-1)).reshape(n_out, k_in).to(torch.bfloat16)
    y_lib = torch.matmul(x, deq.t())
    torch.cuda.synchronize()
    err = (y.float() - y_ref.float()).abs().max().item()
    scale = y_ref.float().abs().max().item()
    if not (torch.isfinite(y).all() and err <= tol_rel * scale):
        raise AssertionError(f"{name} ({n_out},{k_in}) B={B}: max |kernel-plain| "
                             f"{err} > {tol_rel} * {scale}")
    reps = 20 if B == 1 else 5
    out = {
        "shape": [n_out, k_in], "B": B, "path": _fused.route(name, B, k_in),
        "max_abs_err": err, "tol": tol_rel * scale,
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
        else:
            shapes[name] = [check_matmul(name, rng, n, k, B) for B in MATMUL_BATCHES
                            for n, k in MATMUL_SHAPES[name]]
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
MISTRAL = (("mistral_q4km", "auto", "bf16", 0, 0),
           ("mistral_int8_loop", "int8", "int8", -1, 32))
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
    """Mistral-7B-v0.1's published config (vocab 32000, dim 4096, 32
    layers, 32/8 heads of 128, ffn 14336, rope_theta 10000, rms_eps 1e-5,
    sliding_window 4096), served at :data:`MISTRAL_N_CTX`."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import MISTRAL_7B

    return dataclasses.replace(MISTRAL_7B, n_layers=DEPTH, rope_theta=10000.0,
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


def body(context: list[tuple[str, str]]) -> dict:
    return {"bot_profile": BOT, "user_profile": {"name": "Bob"},
            "context": [{"turn": t, "message": m} for t, m in context]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, path: str, payload=None, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if payload is None else json.dumps(payload)
        conn.request(method, path, body=data,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _request(port: int, method: str, path: str, payload=None, timeout=300):
    """(status, lower-cased headers, body bytes) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if payload is None else json.dumps(payload)
        conn.request(method, path, body=data,
                     headers={"content-type": "application/json"})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _sse(port: int, path: str, payload, timeout=300) -> dict:
    """One streamed request: its status, headers, the ``data:`` payloads
    (JSON decoded, ``[DONE]`` kept) and the seconds from sending it to the
    first event and to the first content delta."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.time()
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"content-type": "application/json"})
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
def serving(app):
    """The in-tree httpd serving ``app`` on its own event loop in a thread,
    at 127.0.0.1; yields (port, the thread)."""
    import asyncio

    from llama_fastapi_k8s_gpu_tpu_torch.server import httpd

    port = _free_port()
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
    first ``at`` tokens on a scratch ring (the reply's own steps were
    decode steps, so this reads the same logits to ~10⁻² rel-dev)."""
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
    return {"top2": top.indices.tolist(), "margin": (top.values[0] - top.values[1]).item(),
            "margin_rel": ((top.values[0] - top.values[1]) / pen.abs().max()).item()}


def check_graph(label: str, eng, ids: list, steps: int = 64) -> dict:
    """Decode by graph replay against the eager step: prefill ``ids`` into
    the engine's ring, clone it, then ``steps`` greedy tokens by replays of
    the engine's captured step (chunks of the engine's size) and by the
    eager step on the clone, from the same first sample.  Tokens and every
    cache leaf must be bit-identical; reports the first differing token and
    ring slot, the capture times, the keys held and replays per token."""
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
    with eng._lock, torch.inference_mode():
        cache = eng._cache
        logits = prefill(eng.params, eng.cfg, torch.tensor(ids, device=eng.device), len(ids),
                         cache)
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
           "steps": steps, "positions": [len(ids), len(ids) + steps - 1],
           "replays_per_token": replays / steps,
           "tokens_identical": diff_tok is None and len(got) == len(want),
           "first_token_diff": diff_tok, "cache_identical": not diff_slot,
           "first_cache_diff": diff_slot or None}
    say("graph", **out)
    if not (out["tokens_identical"] and out["cache_identical"]):
        raise AssertionError(f"{label}: graph replay is not bit-identical to the eager step: "
                             f"{out}")
    return out


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
    if (warm.get("decode_chunk", {}).get("compiles") != 1 or build.get("compiles", 0) > 1
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



def check_profile(label, eng, port, short_ctx) -> None:
    """The ``profile`` line: ``/debug/profile`` refused (403) on this app,
    whose startup ran without ``LFKT_PROFILE_DIR`` and prepared no
    profiler; then a second app over the engine, started with the
    directory set, whose startup pays the profiler's one-time set-up
    (``prepare_s``); on it one capture is requested, and a single stream
    starts after the request: the capture opens within a second
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
    sink = eng.metrics_sink
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
        eng.metrics_sink = sink
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
    if (st != 200 or not need <= families or rendered_outside
            or not set(missing) <= set(EVENT_FAMILIES)):
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
    short = [("user", "hi"), ("assistant", "hey"), ("user", "how are you?")]
    story = ("I spent the morning walking by the river, watching the boats "
             "and thinking about the trip we planned last summer. ")
    # a different opening than the short one, so the long prompt shares
    # no reusable prefix with it and prefills from slot 0 in slices
    long_ctx = [("user", "hello, I have a long story to tell you.")]
    for i in range(2):
        long_ctx += [("assistant", f"tell me more, part {i}."),
                     ("user", story[:100])]
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
    t0 = time.time()
    info = phase_device()
    devtime_at_start = DEVTIME.counters()
    phase_build()
    kernels, deq_lines = phase_kernels(KERNELS)
    paths = {layout: phase_gguf(layout) for layout in LAYOUTS}
    mistral_path, mixed_path = phase_gguf_mistral(), phase_gguf_mixed()
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
    paths["mistral"], paths["mixed"] = mistral_path, mixed_path
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

"""Fused Q8_0 dequant-matmul: ``y = x · Wᵀ`` with W kept as GGUF Q8_0 blocks.

``q8_matmul`` launches the CUDA kernel in ``csrc/q8_matmul.cu`` for CUDA
tensors — the tensor-core template of ``csrc/qmma.cuh`` for a prompt pass
where K is a multiple of 256, the CUDA-core path of ``csrc/qgemv.cuh``
for a decode step and for any other K (``_fused.route``) — and runs
:func:`q8_matmul_plain` for CPU tensors.  The weight is the file's own
bytes, ``(N, K/32 · 34)`` uint8 — per 32-element block an
f16 ``d`` and 32 int8 — one row of blocks per output feature.  A Q8_0 file
keeps every linear and the output head in this format.

Replaces the Pallas kernel llama_fastapi_k8s_gpu_tpu/ops/pallas/q8matmul.py::
_q8_matmul_kernel (``q8_matmul`` / ``q8_matmul_stacked``).  That kernel
folds ``d`` to bf16 on an element-major TPU layout; this one multiplies by
the exact f16 ``d`` in f32 (on the tensor cores, rounding each ``d·q`` once
to bf16).
"""

from __future__ import annotations

import torch

from ._fused import fused_matmul, matmul_plain
from .dequant import QK8_0, Q8_0_BLOCK, dequant_q8_0_f32


def q8_matmul_plain(x: torch.Tensor, w: torch.Tensor, n_out: int,
                    k_in: int) -> torch.Tensor:
    """Plain PyTorch version: dequantize W to f32 (``d·q``), multiply in
    f32, round the result to ``x.dtype``."""
    return matmul_plain(dequant_q8_0_f32, x, w, n_out, k_in)


def q8_matmul(x: torch.Tensor, w: torch.Tensor, n_out: int,
              k_in: int) -> torch.Tensor:
    """x (..., K) bf16 → (..., N) bf16 against the Q8_0 block rows ``w``
    (N, K/32·34) uint8."""
    return fused_matmul(q8_matmul, q8_matmul_plain, "lfkt_q8_matmul", x, w,
                        n_out, k_in, QK8_0, Q8_0_BLOCK, align=2)


q8_matmul.launches = 0

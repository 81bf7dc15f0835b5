"""Fused Q4_K dequant-matmul: ``y = x · Wᵀ`` with W kept as GGUF Q4_K blocks.

``q4k_matmul`` launches the CUDA kernel in ``csrc/q4k_matmul.cu`` for CUDA
tensors — the tensor-core template of ``csrc/qmma.cuh`` for a prompt pass,
the CUDA-core path of ``csrc/qgemv.cuh`` for a decode step
(``_fused.route``) — and runs :func:`q4k_matmul_plain` for CPU tensors.
The weight is the file's own bytes, ``(N, K/256 · 144)`` uint8 — one row of super-blocks
per output feature — so loading a Q4_K tensor is an upload with no repack.

Replaces the Pallas kernel llama_fastapi_k8s_gpu_tpu/ops/pallas/qmatmul.py::
_q4k_matmul_kernel (``q4k_matmul`` / ``q4k_matmul_stacked``).  That kernel
folds the scales to bf16 and rounds ``x`` to bf16 on a TPU-specific layout;
this one keeps the scales exact in f32 (on the tensor cores, each weight is
the f32 codec's value rounded once to bf16), so the two agree to
bf16-rounding scale (rel-dev ≤ 5·10⁻³), not bit for bit.
"""

from __future__ import annotations

import torch

from ._fused import fused_matmul, matmul_plain
from .dequant import QK_K, Q4K_BLOCK, dequant_q4_k_f32


def q4k_matmul_plain(x: torch.Tensor, w: torch.Tensor, n_out: int,
                     k_in: int) -> torch.Tensor:
    """Plain PyTorch version: dequantize W to f32 with the codec's
    arithmetic, multiply in f32, round the result to ``x.dtype``."""
    return matmul_plain(dequant_q4_k_f32, x, w, n_out, k_in)


def q4k_matmul(x: torch.Tensor, w: torch.Tensor, n_out: int,
               k_in: int) -> torch.Tensor:
    """x (..., K) bf16 → (..., N) bf16 against the Q4_K block rows ``w``
    (N, K/256·144) uint8."""
    return fused_matmul(q4k_matmul, q4k_matmul_plain, "lfkt_q4k_matmul", x, w,
                        n_out, k_in, QK_K, Q4K_BLOCK, align=8)


q4k_matmul.launches = 0

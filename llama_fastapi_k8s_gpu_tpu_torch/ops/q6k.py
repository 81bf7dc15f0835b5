"""Fused Q6_K dequant-matmul: ``y = x · Wᵀ`` with W kept as GGUF Q6_K blocks.

``q6k_matmul`` launches the CUDA kernel in ``csrc/q6k_matmul.cu`` for CUDA
tensors — the tensor-core template of ``csrc/qmma.cuh`` for a prompt pass,
the matrix-vector template of ``csrc/qgemv.cuh`` for a decode step
(``_fused.route``) — and runs :func:`q6k_matmul_plain` for CPU tensors.
The weight is the file's own bytes, ``(N, K/256 · 210)`` uint8, one row of
super-blocks per output feature.  Q4_K_M and Q5_K_M files keep ``attn_v``,
``ffn_down`` and ``output`` in this format.

Replaces the Pallas kernels llama_fastapi_k8s_gpu_tpu/ops/pallas/q6matmul.py::
_q6k_matmul_kernel (``q6k_matmul`` / ``q6k_matmul_stacked``, default
``cur``) and _q6k_pre_kernel (the ``LFKT_Q6K_KERNEL=pre`` layout): the two
compute one function from two TPU repacks of the same blocks, and this
kernel computes it from the blocks themselves.  ``w = d · sc[16-element
sub-block] · (q6 − 32)`` with the scale exact in f32, where the Pallas
kernels fold it to bf16.
"""

from __future__ import annotations

import torch

from ._fused import fused_matmul, matmul_plain
from .dequant import Q6K_BLOCK, QK_K, dequant_q6_k_f32


def q6k_matmul_plain(x: torch.Tensor, w: torch.Tensor, n_out: int,
                     k_in: int) -> torch.Tensor:
    """Plain PyTorch version: dequantize W to f32, multiply in f32, round
    the result to ``x.dtype``."""
    return matmul_plain(dequant_q6_k_f32, x, w, n_out, k_in)


def q6k_matmul(x: torch.Tensor, w: torch.Tensor, n_out: int,
               k_in: int) -> torch.Tensor:
    """x (..., K) bf16 → (..., N) bf16 against the Q6_K block rows ``w``
    (N, K/256·210) uint8."""
    return fused_matmul(q6k_matmul, q6k_matmul_plain, "lfkt_q6k_matmul", x, w,
                        n_out, k_in, QK_K, Q6K_BLOCK, align=2)


q6k_matmul.launches = 0

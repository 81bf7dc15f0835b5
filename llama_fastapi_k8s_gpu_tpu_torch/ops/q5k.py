"""Fused Q5_K dequant-matmul: ``y = x · Wᵀ`` with W kept as GGUF Q5_K blocks.

``q5k_matmul`` launches the CUDA kernel in ``csrc/q5k_matmul.cu`` for CUDA
tensors — the tensor-core template of ``csrc/qmma.cuh`` for a prompt pass,
the matrix-vector template of ``csrc/qgemv.cuh`` for a decode step
(``_fused.route``) — and runs :func:`q5k_matmul_plain` for CPU tensors.
The weight is the file's own bytes, ``(N, K/256 · 176)`` uint8, one row of
super-blocks per output feature.  Q5_K_M files keep attn_q/k/output and
ffn_gate/up in this format.

Replaces the Pallas kernels llama_fastapi_k8s_gpu_tpu/ops/pallas/q5matmul.py::
_q5k_pre_kernel (the JAX default layout) and _q5k_matmul_kernel (the
``cur`` split layout).  Those two differ only in their TPU repack of the
blocks; this kernel decodes the blocks themselves —
``w = d·sc[j]·(nibble + 16·hibit) − dmin·mn[j]`` with the scales exact in
f32, where the Pallas kernels fold them to bf16.
"""

from __future__ import annotations

import torch

from ._fused import fused_matmul, matmul_plain
from .dequant import QK_K, Q5K_BLOCK, dequant_q5_k_f32


def q5k_matmul_plain(x: torch.Tensor, w: torch.Tensor, n_out: int,
                     k_in: int) -> torch.Tensor:
    """Plain PyTorch version: dequantize W to f32 with the codec's
    arithmetic, multiply in f32, round the result to ``x.dtype``."""
    return matmul_plain(dequant_q5_k_f32, x, w, n_out, k_in)


def q5k_matmul(x: torch.Tensor, w: torch.Tensor, n_out: int,
               k_in: int) -> torch.Tensor:
    """x (..., K) bf16 → (..., N) bf16 against the Q5_K block rows ``w``
    (N, K/256·176) uint8."""
    return fused_matmul(q5k_matmul, q5k_matmul_plain, "lfkt_q5k_matmul", x, w,
                        n_out, k_in, QK_K, Q5K_BLOCK, align=8)


q5k_matmul.launches = 0

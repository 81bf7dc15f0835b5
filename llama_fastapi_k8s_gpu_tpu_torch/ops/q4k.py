"""Fused Q4_K dequant-matmul: ``y = x · Wᵀ`` with W kept as GGUF Q4_K blocks.

``q4k_matmul`` launches the CUDA kernel in ``csrc/q4k_matmul.cu`` for CUDA
tensors and runs :func:`q4k_matmul_plain` for CPU tensors.  The weight is
the file's own bytes, ``(N, K/256 · 144)`` uint8 — one row of super-blocks
per output feature — so loading a Q4_K tensor is an upload with no repack.

Replaces the Pallas kernel llama_fastapi_k8s_gpu_tpu/ops/pallas/qmatmul.py::
_q4k_matmul_kernel (``q4k_matmul`` / ``q4k_matmul_stacked``).  That kernel
folds the scales to bf16 and rounds ``x`` to bf16 on a TPU-specific layout;
this one keeps the scales exact in f32, so the two agree to bf16-rounding
scale (rel-dev ≤ 5·10⁻³), not bit for bit.
"""

from __future__ import annotations

import torch

from ._kernels import check, library, require_cuda, stream_ptr
from .dequant import QK_K, Q4K_BLOCK, dequant_q4_k_f32


def q4k_matmul_plain(x: torch.Tensor, w: torch.Tensor, n_out: int,
                     k_in: int) -> torch.Tensor:
    """Plain PyTorch version: dequantize W to f32 with the codec's
    arithmetic, multiply in f32, round the result to ``x.dtype``."""
    wf = dequant_q4_k_f32(w.reshape(-1)).reshape(n_out, k_in)
    return torch.matmul(x.float(), wf.t()).to(x.dtype)


def q4k_matmul(x: torch.Tensor, w: torch.Tensor, n_out: int,
               k_in: int) -> torch.Tensor:
    """x (..., K) bf16 → (..., N) bf16 against the Q4_K block rows ``w``
    (N, K/256·144) uint8."""
    if k_in % QK_K or w.shape != (n_out, k_in // QK_K * Q4K_BLOCK):
        raise ValueError(f"q4k_matmul: weight {tuple(w.shape)} is not ({n_out}, "
                         f"{k_in}) in Q4_K blocks")
    if x.shape[-1] != k_in:
        raise ValueError(f"q4k_matmul: x has K={x.shape[-1]}, weight {k_in}")
    if x.device.type == "cpu":
        return q4k_matmul_plain(x, w, n_out, k_in)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_in).contiguous()
    require_cuda("q4k_matmul", x2, w, dtypes=(torch.bfloat16, torch.uint8))
    y = torch.empty(x2.shape[0], n_out, dtype=torch.bfloat16, device=x.device)
    check(library().lfkt_q4k_matmul(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                                    x2.shape[0], n_out, k_in, stream_ptr(x)),
          "q4k_matmul")
    q4k_matmul.launches += 1
    return y.reshape(*lead, n_out)


q4k_matmul.launches = 0

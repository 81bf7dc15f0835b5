"""The port's hand-written Hopper kernels and the linear dispatch.

:mod:`.linear` dispatches a layer's matmul onto them by weight format.
Each kernel module pairs a wrapper that launches the CUDA kernel (for CUDA
tensors) with its plain PyTorch version (for CPU tensors) and counts its
launches in ``<wrapper>.launches``:

- :mod:`.dequant` — load-time Q4_K → bf16 (``token_embd``);
- :mod:`.q4k` / :mod:`.q6k` — fused Q4_K / Q6_K dequant-matmuls;
- :mod:`.attention` — causal GQA flash attention for prompt passes.

Kernels are built from ``csrc/`` at first use (:mod:`._kernels`).
"""

from .attention import flash_attention
from .dequant import dequant_q4_k
from .q4k import q4k_matmul
from .q6k import q6k_matmul

#: every kernel wrapper of the serving path, by the name chip runs report
KERNELS = {
    "dequant_q4_k": dequant_q4_k,
    "q4k_matmul": q4k_matmul,
    "q6k_matmul": q6k_matmul,
    "flash_attention": flash_attention,
}

__all__ = ["KERNELS", "dequant_q4_k", "flash_attention", "q4k_matmul",
           "q6k_matmul"]

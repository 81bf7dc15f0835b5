"""Load-time Q4_K → bf16 dequantization (``token_embd`` of a Q4_K_M file).

``dequant_q4_k`` launches the CUDA kernel in ``csrc/dequant_q4k.cu`` for a
CUDA tensor of raw GGUF block bytes, and runs its plain PyTorch version,
:func:`dequant_q4_k_plain`, for a CPU tensor.  Both are bit-identical to the
numpy codec (gguf/quants.py::dequant_q4_k) cast to bf16.

Replaces the Pallas kernel llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py::
_q4_k_kernel.  Unlike the JAX ``device_dequant`` there is no latch that
falls back to the host codec: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from ._kernels import check, library, require_cuda, stream_ptr

QK_K = 256
Q4K_BLOCK = 144


def _q4k_parts(blocks: torch.Tensor):
    """(nb, 144) uint8 → (q (nb, 8, 32) f32, scale (nb, 8) f32, min (nb, 8)
    f32): the decoded nibbles and the per-sub-block d*sc and dmin*mn."""
    nb = blocks.shape[0]
    d = blocks[:, 0:2].contiguous().view(torch.float16).float()      # (nb, 1)
    dmin = blocks[:, 2:4].contiguous().view(torch.float16).float()
    s = blocks[:, 4:16].to(torch.int32)
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0x0F) | ((s[:, 0:4] >> 6) << 4)], 1)
    mn = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], 1)
    qs = blocks[:, 16:].reshape(nb, 4, 1, 32)
    q = torch.cat([qs & 0x0F, qs >> 4], dim=2).reshape(nb, 8, 32).float()
    return q, d * sc.float(), dmin * mn.float()


def dequant_q4_k_f32(raw: torch.Tensor) -> torch.Tensor:
    """Flat Q4_K block bytes → flat f32, the numpy codec's arithmetic
    (d*sc, then scale*q, then minus dmin*mn, each rounded in f32)."""
    blocks = raw.reshape(-1, Q4K_BLOCK)
    q, scale, minv = _q4k_parts(blocks)
    return (scale[:, :, None] * q - minv[:, :, None]).reshape(-1)


def dequant_q4_k_plain(raw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: flat bytes → flat bf16."""
    return dequant_q4_k_f32(raw).to(torch.bfloat16)


def dequant_q4_k(raw: torch.Tensor) -> torch.Tensor:
    """Raw Q4_K bytes (any shape, ``numel % 144 == 0``) → flat bf16 of
    ``numel / 144 * 256`` elements.  CUDA tensors launch the kernel; CPU
    tensors take :func:`dequant_q4_k_plain`."""
    if raw.dtype != torch.uint8 or raw.numel() % Q4K_BLOCK:
        raise ValueError(f"dequant_q4_k: need uint8 bytes in whole {Q4K_BLOCK}-byte "
                         f"blocks, got {raw.dtype} x {raw.numel()}")
    if raw.device.type == "cpu":
        return dequant_q4_k_plain(raw)
    raw = raw.contiguous()
    require_cuda("dequant_q4_k", raw)
    nb = raw.numel() // Q4K_BLOCK
    out = torch.empty(nb * QK_K, dtype=torch.bfloat16, device=raw.device)
    check(library().lfkt_dequant_q4k(raw.data_ptr(), out.data_ptr(), nb,
                                     stream_ptr(raw)), "dequant_q4_k")
    dequant_q4_k.launches += 1
    return out


dequant_q4_k.launches = 0

"""Load-time dequantization: Q4_K, Q5_K, Q6_K and Q8_0 → bf16 or f32.

Each wrapper (``dequant_q4_k``, ``dequant_q5_k``, ``dequant_q6_k``,
``dequant_q8_0``) launches its CUDA kernel (``csrc/dequant_q4k.cu``,
``csrc/dequant_q5k.cu``, ``csrc/dequant_q6k.cu``, ``csrc/dequant_q8_0.cu``)
for a CUDA tensor of raw GGUF block bytes, and runs its plain PyTorch
version (``*_plain``) for a CPU tensor.  Both are bit-identical to the
numpy codec (gguf/quants.py), in f32 or cast to bf16.  The bf16 output
expands ``token_embd`` and, under ``weight_format="bf16"``, every linear;
the f32 output feeds the int8 requantization of ``weight_format="int8"``
(models/params.py), as the reference's ``on_device`` load does.

Replace the Pallas kernels llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py::
_q4_k_kernel, _q5_k_kernel, _q6_k_kernel and _q8_0_kernel.  Unlike the JAX
``device_dequant`` there is no latch that falls back to the host codec: a
kernel that fails to build or launch raises, and so does a CUDA tensor
whose bytes start off the kernel's load alignment (16 bytes for Q4_K and
Q5_K, 2 for Q6_K and Q8_0; a fresh upload is 256-byte aligned).

The ``*_f32`` helpers are the codecs' arithmetic in PyTorch (each step
rounded in f32 as numpy rounds it); the fused matmuls' plain versions
dequantize with them too.
"""

from __future__ import annotations

import torch

from ._kernels import check, library, require_cuda, stream_ptr

QK_K = 256
Q4K_BLOCK = 144
Q5K_BLOCK = 176
Q6K_BLOCK = 210
QK8_0 = 32
Q8_0_BLOCK = 34


def _f16(blocks: torch.Tensor, at: int) -> torch.Tensor:
    """(nb, size) uint8 → (nb, 1) f32 of the f16 at byte ``at`` of each block."""
    return blocks[:, at:at + 2].contiguous().view(torch.float16).float()


def _k4_scales(blocks: torch.Tensor):
    """The per-sub-block d*sc and dmin*mn (nb, 8) f32 of Q4_K/Q5_K blocks."""
    s = blocks[:, 4:16].to(torch.int32)
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0x0F) | ((s[:, 0:4] >> 6) << 4)], 1)
    mn = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], 1)
    return _f16(blocks, 0) * sc.float(), _f16(blocks, 2) * mn.float()


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """(nb, 128) packed nibbles → (nb, 8, 32): byte g*32+i holds element i
    of sub-block 2g (low nibble) and 2g+1 (high)."""
    q = qs.reshape(-1, 4, 1, 32)
    return torch.cat([q & 0x0F, q >> 4], dim=2).reshape(-1, 8, 32)


def dequant_q4_k_f32(raw: torch.Tensor) -> torch.Tensor:
    """Flat Q4_K block bytes → flat f32 (d*sc, then scale*q, then minus
    dmin*mn, each rounded in f32)."""
    blocks = raw.reshape(-1, Q4K_BLOCK)
    scale, minv = _k4_scales(blocks)
    q = _nibbles(blocks[:, 16:]).float()
    return (scale[:, :, None] * q - minv[:, :, None]).reshape(-1)


def dequant_q5_k_f32(raw: torch.Tensor) -> torch.Tensor:
    """Flat Q5_K block bytes → flat f32: Q4_K's arithmetic on
    ``q = nibble + 16·((qh >> j) & 1)`` for sub-block ``j``."""
    blocks = raw.reshape(-1, Q5K_BLOCK)
    scale, minv = _k4_scales(blocks)
    shifts = torch.arange(8, dtype=torch.uint8, device=raw.device)
    hb = (blocks[:, None, 16:48] >> shifts[None, :, None]) & 1      # (nb, 8, 32)
    q = (_nibbles(blocks[:, 48:]) + 16 * hb).float()
    return (scale[:, :, None] * q - minv[:, :, None]).reshape(-1)


def dequant_q6_k_f32(raw: torch.Tensor) -> torch.Tensor:
    """Flat Q6_K block bytes → flat f32, the numpy codec's arithmetic
    (gguf/quants.py::dequant_q6_k: d·sc, then times q−32)."""
    blocks = raw.reshape(-1, Q6K_BLOCK)
    nb = blocks.shape[0]
    ql = blocks[:, 0:128].reshape(nb, 2, 64)
    qh = blocks[:, 128:192].reshape(nb, 2, 32)
    sc = blocks[:, 192:208].contiguous().view(torch.int8).float()       # (nb, 16)
    d = _f16(blocks, 208)                                               # (nb, 1)
    low = torch.cat([ql & 0x0F, ql >> 4], dim=2)                        # (nb, 2, 128)
    hi = torch.cat([(qh >> s) & 3 for s in (0, 2, 4, 6)], dim=2)        # (nb, 2, 128)
    q = (low | (hi << 4)).float() - 32.0
    return ((d * sc)[:, :, None] * q.reshape(nb, 16, 16)).reshape(-1)


def dequant_q8_0_f32(raw: torch.Tensor) -> torch.Tensor:
    """Flat Q8_0 block bytes → flat f32, ``d·q`` per 32-element block."""
    blocks = raw.reshape(-1, Q8_0_BLOCK)
    q = blocks[:, 2:].contiguous().view(torch.int8).float()
    return (_f16(blocks, 0) * q).reshape(-1)


def dequant_q4_k_plain(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the Q4_K kernel: flat bytes → flat ``dtype``."""
    return dequant_q4_k_f32(raw).to(dtype)


def dequant_q5_k_plain(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the Q5_K kernel: flat bytes → flat ``dtype``."""
    return dequant_q5_k_f32(raw).to(dtype)


def dequant_q6_k_plain(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the Q6_K kernel: flat bytes → flat ``dtype``."""
    return dequant_q6_k_f32(raw).to(dtype)


def dequant_q8_0_plain(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the Q8_0 kernel: flat bytes → flat ``dtype``."""
    return dequant_q8_0_f32(raw).to(dtype)


def _dequant(wrapper, plain, launcher: str, raw: torch.Tensor, block_bytes: int,
             block_elems: int, dtype, align: int) -> torch.Tensor:
    """Raw bytes (any shape, whole blocks) → flat ``dtype`` (bf16 or f32):
    the kernel for a CUDA tensor (counted on ``wrapper.launches``), whose
    bytes must start at an ``align``-byte boundary (the kernel's widest
    load), ``plain`` for a CPU one."""
    name = wrapper.__name__
    if raw.dtype != torch.uint8 or raw.numel() % block_bytes:
        raise ValueError(f"{name}: need uint8 bytes in whole {block_bytes}-byte "
                         f"blocks, got {raw.dtype} x {raw.numel()}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype must be bfloat16 or float32, got {dtype}")
    if raw.device.type == "cpu":
        return plain(raw, dtype)
    raw = raw.contiguous()
    require_cuda(name, raw)
    if raw.data_ptr() % align:
        raise ValueError(f"{name}: raw bytes not {align}-byte aligned "
                         f"(the kernel loads {align} bytes at a time)")
    nb = raw.numel() // block_bytes
    out = torch.empty(nb * block_elems, dtype=dtype, device=raw.device)
    check(getattr(library(), launcher)(raw.data_ptr(), out.data_ptr(), nb,
                                       int(dtype == torch.float32), stream_ptr(raw)),
          name)
    wrapper.launches += 1
    return out


def dequant_q4_k(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Raw Q4_K bytes (``numel % 144 == 0``) → flat ``dtype`` (bf16 or f32)
    of ``numel / 144 · 256`` elements."""
    return _dequant(dequant_q4_k, dequant_q4_k_plain, "lfkt_dequant_q4k", raw,
                    Q4K_BLOCK, QK_K, dtype, 16)


def dequant_q5_k(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Raw Q5_K bytes (``numel % 176 == 0``) → flat ``dtype`` (bf16 or f32)
    of ``numel / 176 · 256`` elements."""
    return _dequant(dequant_q5_k, dequant_q5_k_plain, "lfkt_dequant_q5k", raw,
                    Q5K_BLOCK, QK_K, dtype, 16)


def dequant_q6_k(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Raw Q6_K bytes (``numel % 210 == 0``) → flat ``dtype`` (bf16 or f32)
    of ``numel / 210 · 256`` elements."""
    return _dequant(dequant_q6_k, dequant_q6_k_plain, "lfkt_dequant_q6k", raw,
                    Q6K_BLOCK, QK_K, dtype, 2)


def dequant_q8_0(raw: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Raw Q8_0 bytes (``numel % 34 == 0``) → flat ``dtype`` (bf16 or f32)
    of ``numel / 34 · 32`` elements."""
    return _dequant(dequant_q8_0, dequant_q8_0_plain, "lfkt_dequant_q8_0", raw,
                    Q8_0_BLOCK, QK8_0, dtype, 2)


dequant_q4_k.launches = 0
dequant_q5_k.launches = 0
dequant_q6_k.launches = 0
dequant_q8_0.launches = 0

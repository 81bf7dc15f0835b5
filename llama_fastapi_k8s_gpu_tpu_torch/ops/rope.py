"""Interleaved RoPE in plain PyTorch: a pass's rotation table and the
rotation that reads it.

The reference (llama_fastapi_k8s_gpu_tpu/models/llama.py::rope_interleaved)
computes the angles in every call.  The port computes the table — cos and
sin of the angles, (S, hd/2) f32 — once a forward pass from the positions
(:func:`rope_cos_sin`), and rotates q and k from it (:func:`rope_rotate`);
over the int8 ring the KV write kernel rotates k itself from the same
table (ops/kvquant.py).  The two steps are the reference's arithmetic, so
table plus rotation is ``rope_interleaved`` op for op.
"""

from __future__ import annotations

import torch

#: rotation frequencies by (head_dim, theta, device): computed once
_FREQS: dict = {}


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    """(hd/2,) f32 rotation frequencies ``theta^(-2i/hd)``: the exponent in
    f32, the power in f64 rounded once to f32 — the reference's frequencies
    bit for bit (an f32 pow is off by an ulp for some i, and the angle error
    grows with the position)."""
    key = (hd, float(theta), torch.device(device))
    freqs = _FREQS.get(key)
    if freqs is None:
        half = hd // 2
        expo = -torch.arange(half, dtype=torch.float32, device=device) / half
        freqs = _FREQS[key] = (theta ** expo.double()).float()
    return freqs


def rope_cos_sin(positions: torch.Tensor, hd: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation table at ``positions`` (S,): (S, hd/2) f32 cos and sin
    of the angles ``pos · theta^(-2i/hd)``."""
    ang = positions[:, None].float() * rope_freqs(hd, theta, positions.device)[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (S, H, hd), rotated by the table ``cos``/``sin`` (S, hd/2): pairs
    (2i, 2i+1) of token t turn by angle i of row t — the ggml "NORM"
    rotation GGUF Q/K weights are permuted for — in f32, cast back to
    ``x.dtype``."""
    cos, sin = cos[:, None, :], sin[:, None, :]
    xf = x.float()
    x1 = xf[..., 0::2]
    x2 = xf[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)

"""Int8 KV cache: the write-quantize kernel and its plain version.

Under ``ModelConfig.kv_dtype == "int8"`` each layer's ring holds int8
values ``k_q``/``v_q`` (n_kv, n_ctx, hd) and per-head, per-token symmetric
f32 scales ``k_s``/``v_s`` (n_kv, n_ctx): ``x ≈ q · s`` with ``s = max|x| /
127`` over one token's head vector, ``q = clip(round(x / s), -127, 127)``
(round half to even), and an all-zero vector stored as ``s = 0``, ``q = 0``.
Only the S new tokens of a pass are quantized; every read of the ring
moves int8.

``kv_quantize`` launches the CUDA kernel in ``csrc/kv_quantize.cu`` for
CUDA tensors — one launch per layer rotates the new K by the pass's RoPE
table, quantizes it and the new V, and writes values and scales into the
ring slots named by the pass's ``positions`` in place — and runs
:func:`kv_quantize_plain` for CPU tensors.  The slots are a device tensor,
read by the kernel, so a decode step captured in a CUDA graph writes at
the position the step's state holds at replay; the range is the caller's
to check, on its host mirror of the position (models/llama.py).  Both are bit-identical to the
JAX package's ``rope_interleaved`` on k followed by ``quantize_kv_xla``.

A lane step (parallel/batched.py) writes one token into each of B lanes'
rings with the same single launch: the ring arguments are then the
layer's slice of the lane-major cache, ``(B, n_kv, n_ctx, hd)`` and ``(B,
n_kv, n_ctx)`` views strided by one lane's ring, token ``t`` goes to lane
``t`` at ``positions[t]``, and the kernel takes the lanes' stride in slots
(``lane_stride``; 0 for the one-ring call).

Replaces the Pallas kernel llama_fastapi_k8s_gpu_tpu/ops/pallas/kvquant.py::
_kvq_kernel (``quantize_kv_pallas``) together with k's rotation before it
and the ring writes after it in the JAX model.  Unlike the JAX engine there
is no startup probe that pins a fallback: a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import torch

from ._kernels import check, library, require_cuda, stream_ptr
from .rope import rope_rotate

#: head sizes the CUDA kernel is compiled for
HEAD_DIMS = (64, 128)


def quantize_kv_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) → (q int8 (..., hd), s f32 (...)), the reference's f32
    arithmetic step for step.  Both divisions are tensor by tensor:
    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, an ulp off the IEEE division that the reference and the
    kernel do."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, 127.0)
    inv = torch.where(s > 0, torch.ones_like(s) / s, torch.zeros_like(s))
    q = torch.round(x32 * inv[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """q (..., C, hd) int8 × s (..., C) f32 → ``dtype``.  The attention
    paths fold the scales into their products instead; ``chip_smoke.py``
    feeds this to SDPA for the int8 flash kernel's library time."""
    return (q.float() * s[..., None].float()).to(dtype)


def kv_quantize_plain(k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, positions: torch.Tensor, kq: torch.Tensor,
                      vq: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor) -> None:
    """Plain PyTorch version: rotate ``k`` by the table (``rope_rotate``),
    then quantize the head-major slabs of k and v and copy them into the
    ring slots ``positions`` (``index_copy_``).  A slot outside the ring
    keeps the ring as it was, as the kernel skips it (one chunk of the
    sequence-parallel ring takes a decode row that falls in another)."""
    n_ctx = kq.shape[1]
    valid = (positions >= 0) & (positions < n_ctx)
    slot = positions.clamp(0, n_ctx - 1)
    for x, q_ring, s_ring in ((rope_rotate(k, cos, sin), kq, ks), (v, vq, vs)):
        q, s = quantize_kv_plain(x.transpose(0, 1))          # (n_kv, S, hd)
        q_ring.index_copy_(1, slot, torch.where(valid[None, :, None], q,
                                                q_ring.index_select(1, slot)))
        s_ring.index_copy_(1, slot, torch.where(valid[None, :], s,
                                                s_ring.index_select(1, slot)))


def kv_quantize_lanes_plain(k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                            sin: torch.Tensor, positions: torch.Tensor, kq: torch.Tensor,
                            vq: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor) -> None:
    """Plain PyTorch version of the lane write: token ``t`` of ``k``/``v``
    (B, n_kv, hd) into lane ``t`` of the rings ``kq``/``vq`` (B, n_kv,
    n_ctx, hd) and ``ks``/``vs`` (B, n_kv, n_ctx) at slot ``positions[t]``,
    by indexed writes.  A lane whose slot lies outside the ring keeps its
    ring as it was, as the kernel skips it; nothing is read on the host."""
    B, n_ctx = k.shape[0], kq.shape[2]
    lanes = torch.arange(B, device=k.device)
    valid = (positions >= 0) & (positions < n_ctx)
    slot = positions.clamp(0, n_ctx - 1)
    for x, q_ring, s_ring in ((rope_rotate(k, cos, sin), kq, ks), (v, vq, vs)):
        q, s = quantize_kv_plain(x)                           # (B, n_kv, hd), (B, n_kv)
        q_ring[lanes, :, slot] = torch.where(valid[:, None, None], q, q_ring[lanes, :, slot])
        s_ring[lanes, :, slot] = torch.where(valid[:, None], s, s_ring[lanes, :, slot])


def kv_quantize(k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                positions: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                ks: torch.Tensor, vs: torch.Tensor) -> None:
    """k, v (S, n_kv, hd) bf16, one layer's new keys (before RoPE) and
    values, and the pass's rotation table ``cos``/``sin`` (S, hd/2) f32 (row
    t: the angles at ``positions[t]``) → k rotated, then both written in
    place into that layer's ring: ``kq``/``vq`` (n_kv, n_ctx, hd) int8 and
    ``ks``/``vs`` (n_kv, n_ctx) f32 at slots ``positions`` (S,) int64, a
    tensor on k's device that is never read on the host.

    With lane rings — ``kq``/``vq`` (S, n_kv, n_ctx, hd) and ``ks``/``vs``
    (S, n_kv, n_ctx), one lane a token, each lane's ring contiguous and the
    lanes a common stride apart — token ``t`` is written into lane ``t``
    (:func:`kv_quantize_lanes_plain` on the CPU)."""
    S, n_kv, hd = k.shape
    lanes = kq.dim() == 4
    n_ctx = kq.shape[-2]
    ring = (S, n_kv, n_ctx, hd) if lanes else (n_kv, n_ctx, hd)
    if (v.shape != k.shape or kq.shape != ring or vq.shape != kq.shape
            or ks.shape != ring[:-1] or vs.shape != ks.shape):
        raise ValueError(f"kv_quantize: k {tuple(k.shape)} / v {tuple(v.shape)} do "
                         f"not fit the ring {tuple(kq.shape)} / {tuple(ks.shape)}")
    lane_stride = 0
    if lanes:
        lane_stride = ks.stride(0)
        for q_ring, s_ring in ((kq, ks), (vq, vs)):
            if (q_ring.stride()[1:] != (n_ctx * hd, hd, 1) or s_ring.stride()[1:] != (n_ctx, 1)
                    or s_ring.stride(0) != lane_stride
                    or q_ring.stride(0) != lane_stride * hd):
                raise ValueError(
                    f"kv_quantize: lane rings {tuple(q_ring.stride())} / "
                    f"{tuple(s_ring.stride())} are not contiguous lanes one stride apart")
    if hd % 2 or cos.shape != (S, hd // 2) or sin.shape != cos.shape:
        raise ValueError(f"kv_quantize: the RoPE table {tuple(cos.shape)} / "
                         f"{tuple(sin.shape)} does not fit k {tuple(k.shape)}")
    if positions.shape != (S,) or positions.dtype != torch.int64:
        raise ValueError(f"kv_quantize: positions {tuple(positions.shape)} "
                         f"{positions.dtype}, expected ({S},) int64")
    if k.device.type == "cpu":
        plain = kv_quantize_lanes_plain if lanes else kv_quantize_plain
        return plain(k, v, cos, sin, positions, kq, vq, ks, vs)
    if hd not in HEAD_DIMS:
        raise ValueError(f"kv_quantize: the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    k, v, cos, sin = k.contiguous(), v.contiguous(), cos.contiguous(), sin.contiguous()
    positions = positions.contiguous()
    require_cuda("kv_quantize", k, v, cos, sin, positions,
                 dtypes=(torch.bfloat16, torch.bfloat16, torch.float32, torch.float32,
                         torch.int64))
    for t, dtype in zip((kq, vq, ks, vs), (torch.int8, torch.int8, torch.float32, torch.float32)):
        # lane rings are strided views (checked above); one ring is contiguous
        if t.device != k.device or t.dtype != dtype or not (lanes or t.is_contiguous()):
            raise ValueError(f"kv_quantize: ring {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected contiguous {dtype} on {k.device}")
    if any(t.data_ptr() % 8 for t in (k, v, cos, sin, kq, vq)):
        raise ValueError("kv_quantize: k, v, the table and the rings must be 8-byte "
                         "aligned (a lane loads a row's elements and angles as one word)")
    check(library().lfkt_kv_quantize(
        k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(), positions.data_ptr(),
        kq.data_ptr(), vq.data_ptr(), ks.data_ptr(), vs.data_ptr(), S, n_kv, n_ctx, hd,
        lane_stride, stream_ptr(k)), "kv_quantize")
    kv_quantize.launches += 1


kv_quantize.launches = 0

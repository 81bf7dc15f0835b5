"""Causal (+ sliding-window) GQA flash attention over the head-major KV ring.

``flash_attention`` launches the CUDA kernel in ``csrc/flash_attention.cu``
(both products on the tensor cores, the probability tile rounded to bf16
before P·V as the reference rounds it) for CUDA tensors and runs
:func:`flash_attention_plain`, the same arithmetic without the tiling, for
CPU tensors.
It serves prompt passes (S > 1): whole-bucket prefill, the 256-token
prefill slices at ``pos_offset`` 0, 256, … and the prefix-reuse suffix.
The ring slots past ``pos_offset + S`` may hold stale keys from an earlier
request; the causal mask ``key_pos <= q_pos`` is what hides them, exactly.

``flash_attention_int8`` is the same kernel over the int8 KV cache
(ops/kvquant.py): int8 K/V rings with per-token f32 scales, folded in the
reference's scale-last form — ``score = (q·k_int8)·sm_scale·ks[key]`` and
``vs[key]`` multiplied into the key's probability before P·V — so no bf16
ring is ever materialized.  It has a launch counter of its own, and its
plain version is :func:`flash_attention_int8_plain`.

Replaces the Pallas kernel llama_fastapi_k8s_gpu_tpu/ops/pallas/attention.py::
_attn_kernel (``flash_attention``), its bf16 branch and its int8 branch
(``k_scale``/``v_scale``).  As everywhere in the port, a kernel that fails
to build or launch raises: there is no compile probe that degrades to the
score-matrix path.
"""

from __future__ import annotations

import torch

from ._kernels import check, library, require_cuda, stream_ptr

#: head sizes the CUDA kernel is compiled for
HEAD_DIMS = (64, 128)
#: the reference's masked score (its flash kernel's value): finite, so a
#: block or ring chunk with no visible key keeps a finite running maximum
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: query rows per CUDA block (64/group tokens × the group heads of one KV
#: head); the GQA group must divide it
_ROWS = 64


def flash_takes(head_dim: int, group: int) -> bool:
    """Whether the flash kernel takes this head size and GQA group."""
    return head_dim in HEAD_DIMS and _ROWS % group == 0


def attention_mask(q_pos: torch.Tensor, key_end: int,
                   sliding_window: int) -> torch.Tensor:
    """(S, key_end) bool: key ``c`` is visible to the query at ``q_pos``."""
    key_pos = torch.arange(key_end, device=q_pos.device)
    mask = key_pos[None, :] <= q_pos[:, None]
    if sliding_window:
        mask &= key_pos[None, :] > q_pos[:, None] - sliding_window
    return mask


def _softmax_pv(scores: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                vs: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """The reference's arithmetic after the scores, without its tiling:
    ``p = exp(s - m)`` and ``l = sum(p)`` in f32, ``p`` (times ``vs``) rounded
    to bf16 and multiplied by bf16 V with f32 accumulation, divided by
    ``l``, rounded to ``out_dtype`` once.  A row with no visible key is
    zero.  ``scores`` (n_kv, g, S, c) f32, ``v`` (n_kv, c, hd) bf16 or int8."""
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m.masked_fill(m == float("-inf"), 0.0))   # all masked: p = 0
    l = p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * vs[:, None, None, :]
    pb = p.to(torch.bfloat16).float()
    ctx = torch.matmul(pb, v[:, None].to(torch.bfloat16).float())  # (n_kv, g, S, hd)
    ctx = ctx / l.masked_fill(l == 0, 1.0)                          # p = 0: ctx = 0
    S, hd = ctx.shape[2], ctx.shape[3]
    return ctx.permute(2, 0, 1, 3).reshape(S, -1, hd).to(out_dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos_offset: int, sm_scale: float,
                          sliding_window: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the reference's arithmetic without its tiling
    — f32 scores, ``p = exp(s - max)`` and its row sum in f32, bf16 ``p``
    times bf16 V with f32 accumulation, divided by the sum and rounded to
    ``q.dtype`` once.  A row with no visible key is zero."""
    S, H, hd = q.shape
    n_kv = k.shape[0]
    group = H // n_kv
    key_end = min(k.shape[1], pos_offset + S)
    qg = q.reshape(S, n_kv, group, hd).permute(1, 2, 0, 3).float()
    scores = torch.matmul(qg, k[:, None, :key_end].float().transpose(-1, -2)) * sm_scale
    q_pos = pos_offset + torch.arange(S, device=q.device)
    mask = attention_mask(q_pos, key_end, sliding_window)
    return _softmax_pv(scores, mask, v[:, :key_end], None, q.dtype)


def flash_attention_int8_plain(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                               ks: torch.Tensor, vs: torch.Tensor, pos_offset: int,
                               sm_scale: float, sliding_window: int = 0) -> torch.Tensor:
    """Plain PyTorch version over the int8 ring, in the reference's
    scale-last form without its tiling: f32 scores ``(q·k_int8)·sm_scale·
    ks``, ``p = exp(s - max)`` and its row sum in f32, ``p·vs`` rounded to
    bf16 times the int8 values (exact in bf16) with f32 accumulation,
    divided by the sum and rounded to ``q.dtype`` once.  A row with no
    visible key is zero."""
    S, H, hd = q.shape
    n_kv = kq.shape[0]
    group = H // n_kv
    key_end = min(kq.shape[1], pos_offset + S)
    qg = q.reshape(S, n_kv, group, hd).permute(1, 2, 0, 3).float()
    scores = torch.matmul(qg, kq[:, None, :key_end].float().transpose(-1, -2)) * sm_scale
    scores = scores * ks[:, None, None, :key_end]
    q_pos = pos_offset + torch.arange(S, device=q.device)
    mask = attention_mask(q_pos, key_end, sliding_window)
    return _softmax_pv(scores, mask, vq[:, :key_end], vs[:, :key_end], q.dtype)


def _check_geometry(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_offset: int) -> None:
    S, H, hd = q.shape
    n_kv, n_ctx, _ = k.shape
    if H % n_kv or k.shape != v.shape or k.shape[2] != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if pos_offset < 0 or pos_offset + S > n_ctx:
        raise ValueError(f"{name}: positions {pos_offset}..{pos_offset + S} "
                         f"outside the {n_ctx}-slot ring")


def _launch(wrapper, launcher: str, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, scales: tuple, pos_offset: int, sm_scale: float,
            sliding_window: int) -> torch.Tensor:
    """Launch the kernel (``scales`` = (ks, vs) for the int8 ring, () for
    bf16) and count it on ``wrapper``."""
    name = wrapper.__name__
    S, H, hd = q.shape
    n_kv, n_ctx, _ = k.shape
    if not flash_takes(hd, H // n_kv):
        raise ValueError(f"{name}: kernel takes head_dim in {HEAD_DIMS} "
                         f"and a GQA group dividing {_ROWS}, got hd={hd}, "
                         f"group={H // n_kv}")
    q = q.contiguous()
    kv_dtype = torch.int8 if scales else torch.bfloat16
    require_cuda(name, q, k, v, *scales,
                 dtypes=(torch.bfloat16, kv_dtype, kv_dtype) + (torch.float32,) * len(scales))
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError(f"{name}: q, k, v and out must be 16-byte aligned "
                         f"(the kernel copies 16-byte chunks)")
    check(getattr(library(), launcher)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in scales),
        out.data_ptr(), S, H, n_kv, n_ctx, hd, pos_offset, float(sm_scale),
        int(sliding_window), stream_ptr(q)), name)
    wrapper.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_offset: int, sm_scale: float,
                    sliding_window: int = 0) -> torch.Tensor:
    """q (S, H, hd) bf16 queries at cache positions ``pos_offset ..
    pos_offset+S-1``; k, v (n_kv, n_ctx, hd) bf16, one layer's ring.
    Returns (S, H, hd) bf16."""
    _check_geometry("flash_attention", q, k, v, pos_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, pos_offset, sm_scale, sliding_window)
    return _launch(flash_attention, "lfkt_flash_attention", q, k, v, (), pos_offset,
                   sm_scale, sliding_window)


def flash_attention_int8(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                         ks: torch.Tensor, vs: torch.Tensor, pos_offset: int,
                         sm_scale: float, sliding_window: int = 0) -> torch.Tensor:
    """As :func:`flash_attention` over one layer's int8 ring: ``kq``, ``vq``
    (n_kv, n_ctx, hd) int8 and their scales ``ks``, ``vs`` (n_kv, n_ctx)
    f32.  Returns (S, H, hd) bf16."""
    _check_geometry("flash_attention_int8", q, kq, vq, pos_offset)
    if ks.shape != kq.shape[:2] or vs.shape != ks.shape:
        raise ValueError(f"flash_attention_int8: scales {tuple(ks.shape)} / "
                         f"{tuple(vs.shape)} do not fit the ring {tuple(kq.shape)}")
    if q.device.type == "cpu":
        return flash_attention_int8_plain(q, kq, vq, ks, vs, pos_offset, sm_scale,
                                          sliding_window)
    return _launch(flash_attention_int8, "lfkt_flash_attention_int8", q, kq, vq,
                   (ks, vs), pos_offset, sm_scale, sliding_window)


flash_attention.launches = 0
flash_attention_int8.launches = 0

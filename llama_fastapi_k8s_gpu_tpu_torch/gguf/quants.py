"""Numpy reference codecs for the GGML formats of Llama-3 Q4_K_M, Q5_K_M
and Q8_0 files.

These are the host-side bit oracle for the port's CUDA kernels
(``ops/dequant.py``, ``ops/q4k.py``, ``ops/q5k.py``, ``ops/q6k.py``,
``ops/q8.py``): each kernel decodes the same block bytes and is held against
these functions.  Only the formats the serving path meets are kept: F32 and
F16 (norms, small test files), Q4_K / Q5_K (most linears and ``token_embd``
of Q4_K_M / Q5_K_M files), Q6_K (``attn_v``/``ffn_down``/``output`` in
those files) and Q8_0 (every tensor of a Q8_0 file).  Quantizers exist so
tests and model synthesis can build valid GGUF files; they use
straightforward affine fits per sub-block (not llama.cpp's iterative
search) — only the *decode* layout is contractual.

Layout notes (all little-endian):

- ``Q8_0``  block=32:   f16 d | 32×i8            y = d*q
- ``Q4_K``  block=256:  f16 d | f16 dmin | 12B 6-bit scales/mins | 128B nibbles
                        y = d*sc[j]*q - dmin*m[j], 8 sub-blocks of 32
- ``Q5_K``  block=256:  Q4_K's header | 32B qh | 128B nibbles
                        q = nibble + 16*((qh >> j) & 1), then as Q4_K
- ``Q6_K``  block=256:  128B ql | 64B qh | 16×i8 scales | f16 d
                        y = d*sc[j]*(q-32), 16 sub-blocks of 16, q 6-bit
"""

from __future__ import annotations

import functools

import numpy as np

from .constants import GGML_BLOCK_SIZES, GGMLType, QK_K


def _garbage_tolerant(fn):
    """Silence numpy's invalid/overflow warnings inside a dequant codec:
    random-byte inputs decode f16 scale fields to inf/NaN, and the resulting
    0·inf → NaN is the correct value for garbage."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with np.errstate(invalid="ignore", over="ignore"):
            return fn(*args, **kwargs)
    return wrapped


def _f16(buf: np.ndarray) -> np.ndarray:
    return buf.view(np.float16).astype(np.float32)


def dequant_f32(buf: np.ndarray, n: int) -> np.ndarray:
    return buf[: n * 4].view(np.float32).copy()


def dequant_f16(buf: np.ndarray, n: int) -> np.ndarray:
    return buf[: n * 2].view(np.float16).astype(np.float32)


# ---------------------------------------------------------------------------
# Q8_0
# ---------------------------------------------------------------------------

@_garbage_tolerant
def dequant_q8_0(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // 32
    blocks = buf[: nb * 34].reshape(nb, 34)
    d = _f16(blocks[:, :2].reshape(-1))  # (nb,)
    q = blocks[:, 2:].view(np.int8).astype(np.float32)  # (nb, 32)
    return (d[:, None] * q).reshape(-1)


def quant_q8_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float16)
    inv = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    q = np.clip(np.round(x * inv[:, None]), -128, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), dtype=np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# K-quants: shared 6-bit scale/min unpacking (get_scale_min_k4)
# ---------------------------------------------------------------------------

def unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nb, 12) uint8 → ((nb, 8) scales, (nb, 8) mins), both uint8 6-bit."""
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), dtype=np.uint8)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = s[..., j] & 63
        mn[..., j] = s[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (s[..., j + 4] & 0x0F) | ((s[..., j - 4] >> 6) << 4)
        mn[..., j] = (s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)
    return sc, mn


def pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of :func:`unpack_scale_min_k4`; inputs 6-bit (nb, 8)."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros(sc.shape[:-1] + (12,), dtype=np.uint8)
    for j in range(4):
        out[..., j] = (sc[..., j] & 63) | ((sc[..., j + 4] >> 4) << 6)
        out[..., j + 4] = (mn[..., j] & 63) | ((mn[..., j + 4] >> 4) << 6)
        out[..., j + 8] = (sc[..., j + 4] & 0x0F) | ((mn[..., j + 4] & 0x0F) << 4)
    return out


# ---------------------------------------------------------------------------
# Q4_K
# ---------------------------------------------------------------------------

@_garbage_tolerant
def dequant_q4_k(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // QK_K
    bs = GGML_BLOCK_SIZES[GGMLType.Q4_K][1]  # 144
    blocks = buf[: nb * bs].reshape(nb, bs)
    d = _f16(blocks[:, 0:2].reshape(-1))
    dmin = _f16(blocks[:, 2:4].reshape(-1))
    sc, mn = unpack_scale_min_k4(blocks[:, 4:16])  # (nb, 8)
    qs = blocks[:, 16:].reshape(nb, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)  # sub-blocks 0,2,4,6
    hi = (qs >> 4).astype(np.float32)    # sub-blocks 1,3,5,7
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32)
    scale = d[:, None] * sc.astype(np.float32)       # (nb, 8)
    minv = dmin[:, None] * mn.astype(np.float32)     # (nb, 8)
    y = scale[:, :, None] * q - minv[:, :, None]
    return y.reshape(-1)


def quant_q4_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 8, 32)
    nb = x.shape[0]
    vmin = np.minimum(x.min(axis=2), 0.0)           # (nb, 8) — mins are ≥0 offsets
    vmax = x.max(axis=2)
    sub_scale = np.maximum((vmax - vmin) / 15.0, 0.0)
    d = (sub_scale.max(axis=1) / 63.0).astype(np.float16)
    dmin = ((-vmin).max(axis=1) / 63.0).astype(np.float16)
    df = d.astype(np.float32)
    dminf = dmin.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = np.where(df[:, None] > 0, np.round(sub_scale / df[:, None]), 0)
        mn = np.where(dminf[:, None] > 0, np.round(-vmin / dminf[:, None]), 0)
    sc = np.clip(sc, 0, 63).astype(np.uint8)
    mn = np.clip(mn, 0, 63).astype(np.uint8)
    eff_scale = df[:, None] * sc                      # (nb, 8)
    eff_min = dminf[:, None] * mn
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(
            eff_scale[:, :, None] > 0,
            np.round((x + eff_min[:, :, None]) / eff_scale[:, :, None]),
            0,
        )
    q = np.clip(q, 0, 15).astype(np.uint8)            # (nb, 8, 32)
    pairs = q.reshape(nb, 4, 2, 32)
    packed = pairs[:, :, 0, :] | (pairs[:, :, 1, :] << 4)  # (nb, 4, 32)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = pack_scale_min_k4(sc, mn)
    out[:, 16:] = packed.reshape(nb, 128)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q5_K
# ---------------------------------------------------------------------------

@_garbage_tolerant
def dequant_q5_k(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // QK_K
    bs = GGML_BLOCK_SIZES[GGMLType.Q5_K][1]  # 176
    blocks = buf[: nb * bs].reshape(nb, bs)
    d = _f16(blocks[:, 0:2].reshape(-1))
    dmin = _f16(blocks[:, 2:4].reshape(-1))
    sc, mn = unpack_scale_min_k4(blocks[:, 4:16])
    qh = blocks[:, 16:48]                      # (nb, 32)
    qs = blocks[:, 48:].reshape(nb, 4, 32)
    lo = (qs & 0x0F).astype(np.uint8)
    hi = (qs >> 4).astype(np.uint8)
    # sub-block j (0..7) gets high bit (qh >> j) & 1; even j from low nibble,
    # odd j from high nibble (u1=1,u2=2 doubling per 64-group in llama.cpp).
    shifts = np.arange(8, dtype=np.uint8)
    hibits = ((qh[:, None, :] >> shifts[None, :, None]) & 1).astype(np.uint8)  # (nb, 8, 32)
    q = np.empty((nb, 8, 32), dtype=np.float32)
    q[:, 0::2, :] = lo
    q[:, 1::2, :] = hi
    q += hibits.astype(np.float32) * 16.0
    scale = d[:, None] * sc.astype(np.float32)
    minv = dmin[:, None] * mn.astype(np.float32)
    y = scale[:, :, None] * q - minv[:, :, None]
    return y.reshape(-1)


def quant_q5_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 8, 32)
    nb = x.shape[0]
    vmin = np.minimum(x.min(axis=2), 0.0)
    vmax = x.max(axis=2)
    sub_scale = np.maximum((vmax - vmin) / 31.0, 0.0)
    d = (sub_scale.max(axis=1) / 63.0).astype(np.float16)
    dmin = ((-vmin).max(axis=1) / 63.0).astype(np.float16)
    df = d.astype(np.float32)
    dminf = dmin.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = np.where(df[:, None] > 0, np.round(sub_scale / df[:, None]), 0)
        mn = np.where(dminf[:, None] > 0, np.round(-vmin / dminf[:, None]), 0)
    sc = np.clip(sc, 0, 63).astype(np.uint8)
    mn = np.clip(mn, 0, 63).astype(np.uint8)
    eff_scale = df[:, None] * sc
    eff_min = dminf[:, None] * mn
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(
            eff_scale[:, :, None] > 0,
            np.round((x + eff_min[:, :, None]) / eff_scale[:, :, None]),
            0,
        )
    q = np.clip(q, 0, 31).astype(np.uint8)            # (nb, 8, 32), 5-bit
    lo = q & 0x0F
    hb = (q >> 4) & 1
    shifts = np.arange(8, dtype=np.uint8)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for j in range(8):
        qh |= (hb[:, j, :] << shifts[j])
    packed = lo[:, 0::2, :] | (lo[:, 1::2, :] << 4)   # (nb, 4, 32)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = pack_scale_min_k4(sc, mn)
    out[:, 16:48] = qh
    out[:, 48:] = packed.reshape(nb, 128)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q6_K
# ---------------------------------------------------------------------------

@_garbage_tolerant
def dequant_q6_k(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // QK_K
    bs = GGML_BLOCK_SIZES[GGMLType.Q6_K][1]  # 210
    blocks = buf[: nb * bs].reshape(nb, bs)
    ql = blocks[:, 0:128].reshape(nb, 2, 64)       # two 128-element halves
    qh = blocks[:, 128:192].reshape(nb, 2, 32)
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)  # (nb, 16)
    d = _f16(blocks[:, 208:210].reshape(-1))
    low = np.empty((nb, 2, 128), dtype=np.uint8)
    low[:, :, 0:64] = ql[:, :, :] & 0x0F           # l, l+32 from ql[0:64] & 0xF
    low[:, :, 64:128] = ql[:, :, :] >> 4           # l+64, l+96 from ql >> 4
    hi = np.empty((nb, 2, 128), dtype=np.uint8)
    hi[:, :, 0:32] = (qh >> 0) & 3
    hi[:, :, 32:64] = (qh >> 2) & 3
    hi[:, :, 64:96] = (qh >> 4) & 3
    hi[:, :, 96:128] = (qh >> 6) & 3
    q = (low | (hi << 4)).astype(np.float32) - 32.0  # (nb, 2, 128)
    q = q.reshape(nb, 16, 16)                        # 16 sub-blocks of 16
    y = d[:, None, None] * sc[:, :, None] * q
    return y.reshape(-1)


def quant_q6_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 16, 16)
    nb = x.shape[0]
    amax = np.abs(x).max(axis=2)                    # (nb, 16)
    sub_scale = amax / 31.0                         # q-32 ∈ [-32, 31]
    d = (sub_scale.max(axis=1) / 127.0).astype(np.float16)
    df = d.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = np.where(df[:, None] > 0, np.round(sub_scale / df[:, None]), 0)
    sc = np.clip(sc, -128, 127).astype(np.int8)
    eff = df[:, None] * sc.astype(np.float32)       # (nb, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(np.abs(eff[:, :, None]) > 0, np.round(x / eff[:, :, None]), 0)
    q = (np.clip(q, -32, 31) + 32).astype(np.uint8)  # (nb, 16, 16) 6-bit
    q = q.reshape(nb, 2, 128)
    low = q & 0x0F
    hi = q >> 4                                      # 2 bits
    ql = np.empty((nb, 2, 64), dtype=np.uint8)
    ql[:, :, :] = low[:, :, 0:64] | (low[:, :, 64:128] << 4)
    qh = (
        hi[:, :, 0:32]
        | (hi[:, :, 32:64] << 2)
        | (hi[:, :, 64:96] << 4)
        | (hi[:, :, 96:128] << 6)
    )
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

DEQUANT = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
}

QUANT = {
    GGMLType.F32: lambda x: np.ascontiguousarray(x, dtype=np.float32).view(np.uint8),
    GGMLType.F16: lambda x: np.ascontiguousarray(x, dtype=np.float32).astype(np.float16).view(np.uint8),
    GGMLType.Q8_0: quant_q8_0,
    GGMLType.Q4_K: quant_q4_k,
    GGMLType.Q5_K: quant_q5_k,
    GGMLType.Q6_K: quant_q6_k,
}


def _type_name(ggml_type) -> str:
    try:
        return GGMLType(ggml_type).name
    except ValueError:
        return f"ggml type code {int(ggml_type)}"


def dequantize(buf: np.ndarray, ggml_type: GGMLType, n_elements: int) -> np.ndarray:
    """Flat uint8 buffer → float32 array of ``n_elements``."""
    try:
        fn = DEQUANT[GGMLType(ggml_type)]
    except (KeyError, ValueError):
        raise NotImplementedError(f"dequant for {_type_name(ggml_type)}") from None
    return fn(np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1), n_elements)


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """float array → flat uint8 buffer in ``ggml_type`` layout."""
    try:
        fn = QUANT[GGMLType(ggml_type)]
    except (KeyError, ValueError):
        raise NotImplementedError(f"quant for {_type_name(ggml_type)}") from None
    x = np.asarray(x).reshape(-1)
    block = GGML_BLOCK_SIZES[GGMLType(ggml_type)][0]
    if x.size % block != 0:
        raise ValueError(
            f"{_type_name(ggml_type)}: element count {x.size} not divisible by block {block}"
        )
    return fn(x)

"""Numpy reference codecs for every GGML tensor type the JAX package loads.

These are the host-side bit oracle for the port's CUDA kernels
(``ops/dequant.py``, ``ops/q4k.py``, ``ops/q5k.py``, ``ops/q6k.py``,
``ops/q8.py``): each kernel decodes the same block bytes and is held against
these functions.  The types without a kernel (BF16, Q4_0, Q4_1, Q5_0, Q5_1,
Q2_K, Q3_K, IQ4_NL, IQ4_XS) load through these codecs on the host, as they
do in the reference (its host path for any type without a device dequant).
Q8_1, Q8_K and the other IQ types raise ``NotImplementedError``, as in the
reference.  Quantizers exist so tests and model synthesis can build valid
GGUF files; they use straightforward affine fits per sub-block (not
llama.cpp's iterative search) — only the *decode* layout is contractual.
Every codec is byte-equal with the JAX package's (tests/test_torch_gguf.py).

Layout notes (all little-endian):

- ``Q8_0``   block=32:  f16 d | 32×i8;               y = d*q
- ``Q4_0``   block=32:  f16 d | 16B nibbles;         y = d*(q-8)
- ``Q4_1``   block=32:  f16 d | f16 m | 16B nibbles; y = d*q + m
- ``Q5_0``   block=32:  f16 d | u32 qh | 16B nibbles; y = d*(q-16),
                        q = nibble | (qh-bit << 4); element j gets qh bit j,
                        element j+16 gets qh bit j+16
- ``Q5_1``   block=32:  f16 d | f16 m | u32 qh | 16B nibbles; y = d*q + m
- ``Q2_K``   block=256: 16B 4-bit scale/min pairs | 64B 2-bit qs | f16 d | f16 dmin
                        y = d*sc[j]*q - dmin*m[j], 16 sub-blocks of 16
- ``Q3_K``   block=256: 32B hmask | 64B 2-bit qs | 12B 6-bit signed scales | f16 d
                        q = 2 low bits + hmask high bit (clear ⇒ −4)
- ``Q4_K``   block=256: f16 d | f16 dmin | 12B 6-bit scales/mins | 128B nibbles
                        y = d*sc[j]*q - dmin*m[j], 8 sub-blocks of 32
- ``Q5_K``   block=256: Q4_K's header | 32B qh | 128B nibbles
                        q = nibble + 16*((qh >> j) & 1), then as Q4_K
- ``Q6_K``   block=256: 128B ql | 64B qh | 16×i8 scales | f16 d
                        y = d*sc[j]*(q-32), 16 sub-blocks of 16, q 6-bit
- ``IQ4_NL`` block=32:  f16 d | 16B indices into a 16-value table
- ``IQ4_XS`` block=256: f16 d | u16 scales_h | 4B scales_l | 128B indices
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


def dequant_bf16(buf: np.ndarray, n: int) -> np.ndarray:
    u16 = buf[: n * 2].view(np.uint16).astype(np.uint32)
    return (u16 << 16).view(np.float32).copy()


def quant_bf16(x: np.ndarray) -> np.ndarray:
    # round-to-nearest-even on the mantissa boundary
    u32 = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16
    return rounded.astype(np.uint16).view(np.uint8)


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
# Q4_0
# ---------------------------------------------------------------------------

@_garbage_tolerant
def dequant_q4_0(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // 32
    blocks = buf[: nb * 18].reshape(nb, 18)
    d = _f16(blocks[:, :2].reshape(-1))
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.float32) - 8.0  # elements 0..15
    hi = (qs >> 4).astype(np.float32) - 8.0    # elements 16..31
    q = np.concatenate([lo, hi], axis=1)       # (nb, 32)
    return (d[:, None] * q).reshape(-1)


def quant_q4_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    # llama.cpp picks d from the max-|x| element so that it maps to -8
    idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), idx]
    d = (maxv / -8.0).astype(np.float16)
    inv = np.where(d != 0, 1.0 / d.astype(np.float32), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 18), dtype=np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q4_1 / Q5_0 / Q5_1 (legacy affine/5-bit formats, still common in the wild)
# ---------------------------------------------------------------------------

@_garbage_tolerant
def dequant_q4_1(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // 32
    blocks = buf[: nb * 20].reshape(nb, 20)
    d = _f16(blocks[:, 0:2].reshape(-1))
    m = _f16(blocks[:, 2:4].reshape(-1))
    qs = blocks[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)   # elements 0..15
    hi = (qs >> 4).astype(np.float32)     # elements 16..31
    q = np.concatenate([lo, hi], axis=1)
    return (d[:, None] * q + m[:, None]).reshape(-1)


def quant_q4_1(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = ((mx - mn) / 15.0).astype(np.float16)
    m = mn.astype(np.float16)
    inv = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv[:, None]), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 20), dtype=np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = m.view(np.uint8).reshape(-1, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def _q5_high_bits(qh_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nb, 4) uint8 → ((nb, 16), (nb, 16)) fifth-bit planes already shifted
    to bit 4: element j takes qh bit j, element j+16 takes qh bit j+16."""
    qh = qh_bytes.copy().view(np.uint32).reshape(-1)  # (nb,)
    j = np.arange(16, dtype=np.uint32)
    lo = (((qh[:, None] >> j) & 1) << 4).astype(np.uint8)
    hi = (((qh[:, None] >> (j + 16)) & 1) << 4).astype(np.uint8)
    return lo, hi


@_garbage_tolerant
def dequant_q5_0(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // 32
    blocks = buf[: nb * 22].reshape(nb, 22)
    d = _f16(blocks[:, 0:2].reshape(-1))
    xh0, xh1 = _q5_high_bits(blocks[:, 2:6])
    qs = blocks[:, 6:]
    lo = ((qs & 0x0F) | xh0).astype(np.float32) - 16.0
    hi = ((qs >> 4) | xh1).astype(np.float32) - 16.0
    return (d[:, None] * np.concatenate([lo, hi], axis=1)).reshape(-1)


def quant_q5_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    # like Q4_0: d from the max-|x| element so it maps to -16
    idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), idx]
    d = (maxv / -16.0).astype(np.float16)
    inv = np.where(d != 0, 1.0 / d.astype(np.float32), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 16, 0, 31).astype(np.uint8)
    return _pack_q5(q, d.view(np.uint8).reshape(-1, 2), None)


@_garbage_tolerant
def dequant_q5_1(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // 32
    blocks = buf[: nb * 24].reshape(nb, 24)
    d = _f16(blocks[:, 0:2].reshape(-1))
    m = _f16(blocks[:, 2:4].reshape(-1))
    xh0, xh1 = _q5_high_bits(blocks[:, 4:8])
    qs = blocks[:, 8:]
    lo = ((qs & 0x0F) | xh0).astype(np.float32)
    hi = ((qs >> 4) | xh1).astype(np.float32)
    q = np.concatenate([lo, hi], axis=1)
    return (d[:, None] * q + m[:, None]).reshape(-1)


def quant_q5_1(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = ((mx - mn) / 31.0).astype(np.float16)
    m = mn.astype(np.float16)
    inv = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv[:, None]), 0, 31).astype(np.uint8)
    return _pack_q5(q, d.view(np.uint8).reshape(-1, 2),
                    m.view(np.uint8).reshape(-1, 2))


def _pack_q5(q: np.ndarray, d_bytes: np.ndarray,
             m_bytes: np.ndarray | None) -> np.ndarray:
    """(nb, 32) 5-bit values + scale (+min) bytes → Q5_0/Q5_1 raw blocks."""
    nb = q.shape[0]
    j = np.arange(16, dtype=np.uint32)
    qh = (((q[:, :16] >> 4).astype(np.uint32) << j).sum(axis=1)
          | ((q[:, 16:] >> 4).astype(np.uint32) << (j + 16)).sum(axis=1))
    qs = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    head = 2 if m_bytes is None else 4
    out = np.empty((nb, head + 4 + 16), dtype=np.uint8)
    out[:, 0:2] = d_bytes
    if m_bytes is not None:
        out[:, 2:4] = m_bytes
    out[:, head:head + 4] = qh.astype(np.uint32).view(np.uint8).reshape(nb, 4)
    out[:, head + 4:] = qs
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
# IQ4_NL / IQ4_XS — non-linear 4-bit: indices into a fixed 16-value LUT
# (llama.cpp kvalues_iq4nl).  IQ4_NL: block 32 = f16 d | 16B nibble
# indices.  IQ4_XS: super-block 256 = f16 d | u16 scales_h | 4B scales_l |
# 128B qs; 8 sub-blocks of 32 with 6-bit scales (ls − 32), low nibbles →
# elements 0..15 of the sub-block, high → 16..31.
# ---------------------------------------------------------------------------

KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10,
     1, 13, 25, 38, 53, 69, 89, 113], dtype=np.float32)


@_garbage_tolerant
def dequant_iq4_nl(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // 32
    blocks = buf[: nb * 18].reshape(nb, 18)
    d = _f16(blocks[:, 0:2].reshape(-1))
    qs = blocks[:, 2:]
    lo = KVALUES_IQ4NL[qs & 0x0F]
    hi = KVALUES_IQ4NL[qs >> 4]
    return (d[:, None] * np.concatenate([lo, hi], axis=1)).reshape(-1)


def _nearest_iq4nl(x: np.ndarray) -> np.ndarray:
    """Values → nearest-LUT 4-bit indices (any shape)."""
    return np.abs(x[..., None] - KVALUES_IQ4NL).argmin(axis=-1).astype(np.uint8)


def quant_iq4_nl(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1)
    d = (amax / 113.0).astype(np.float16)    # map the peak onto ±113
    inv = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    q = _nearest_iq4nl(x * inv[:, None])
    out = np.empty((x.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


@_garbage_tolerant
def dequant_iq4_xs(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // QK_K
    bs = GGML_BLOCK_SIZES[GGMLType.IQ4_XS][1]  # 136
    blocks = buf[: nb * bs].reshape(nb, bs)
    d = _f16(blocks[:, 0:2].reshape(-1))
    scales_h = blocks[:, 2:4].copy().view(np.uint16).reshape(-1)  # (nb,)
    scales_l = blocks[:, 4:8]
    qs = blocks[:, 8:].reshape(nb, 8, 16)
    ib = np.arange(8)
    ls = (((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F)
          | (((scales_h[:, None] >> (2 * ib)) & 3) << 4)).astype(np.float32)
    dl = d[:, None] * (ls - 32.0)                               # (nb, 8)
    lo = KVALUES_IQ4NL[qs & 0x0F]                               # (nb, 8, 16)
    hi = KVALUES_IQ4NL[qs >> 4]
    y = dl[:, :, None] * np.concatenate([lo, hi], axis=2)       # (nb, 8, 32)
    return y.reshape(-1)


def quant_iq4_xs(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 8, 32)
    # signed fit against the max-magnitude element (as quant_q3_k does):
    # map it onto the kvalue table's wider −127 end, so sub-block scales
    # carry its sign and use the full −32..31 range instead of only 32..63
    idx = np.abs(sub).argmax(axis=2)
    maxv = np.take_along_axis(sub, idx[:, :, None], axis=2)[:, :, 0]
    dl_sub = maxv / -127.0                                      # signed
    amax = np.abs(dl_sub).max(axis=1)
    d = np.where(amax > 0, amax / 31.0, 0.0).astype(np.float16)  # |ls−32| ≤ 31
    invd = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    ls = np.clip(np.round(dl_sub * invd[:, None]) + 32, 0, 63).astype(np.uint8)
    dl_q = d.astype(np.float32)[:, None] * (ls.astype(np.float32) - 32.0)
    inv_dl = np.where(dl_q != 0, 1.0 / dl_q, 0.0)
    q = _nearest_iq4nl(sub * inv_dl[:, :, None])                # (nb, 8, 32)
    out = np.empty((nb, 136), dtype=np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    ib = np.arange(8)
    sh = ((ls >> 4).astype(np.uint32) << (2 * ib)).sum(axis=1).astype(np.uint16)
    out[:, 2:4] = sh.view(np.uint8).reshape(nb, 2)
    low = ls & 0x0F
    out[:, 4:8] = low[:, 0::2] | (low[:, 1::2] << 4)
    out[:, 8:] = (q[:, :, :16] | (q[:, :, 16:] << 4)).reshape(nb, 128)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q2_K — 16 sub-blocks of 16; 4-bit scale + 4-bit min per sub-block,
# superblock f16 d/dmin; 2-bit quants.  Layout per llama.cpp block_q2_K:
# scales[16] | qs[64] | d | dmin (84 B).  Element order: two 128-halves;
# within a half, shift ∈ {0,2,4,6} over qs bytes [0:16] then [16:32].
# ---------------------------------------------------------------------------

@_garbage_tolerant
def dequant_q2_k(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // QK_K
    bs = GGML_BLOCK_SIZES[GGMLType.Q2_K][1]  # 84
    blocks = buf[: nb * bs].reshape(nb, bs)
    scales = blocks[:, :16]
    qs = blocks[:, 16:80].reshape(nb, 2, 32)
    d = _f16(blocks[:, 80:82].reshape(-1))
    dmin = _f16(blocks[:, 82:84].reshape(-1))
    dl = d[:, None] * (scales & 0x0F).astype(np.float32)    # (nb, 16)
    ml = dmin[:, None] * (scales >> 4).astype(np.float32)   # (nb, 16)
    parts = []
    for h in range(2):
        for s in range(0, 8, 2):
            parts.append((qs[:, h, :16] >> s) & 3)
            parts.append((qs[:, h, 16:] >> s) & 3)
    qv = np.stack(parts, axis=1).astype(np.float32)          # (nb, 16, 16)
    return (dl[:, :, None] * qv - ml[:, :, None]).reshape(-1)


def quant_q2_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    mn = sub.min(axis=2)
    mx = sub.max(axis=2)
    ml_sub = np.maximum(-mn, 0.0)                 # y = dl*q - ml, q ∈ 0..3
    dl_sub = np.maximum(mx + ml_sub, 0.0) / 3.0
    d = (dl_sub.max(axis=1) / 15.0).astype(np.float16)
    dmin = (ml_sub.max(axis=1) / 15.0).astype(np.float16)
    invd = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    invm = np.where(dmin > 0, 1.0 / dmin.astype(np.float32), 0.0)
    sc4 = np.clip(np.round(dl_sub * invd[:, None]), 0, 15).astype(np.uint8)
    mn4 = np.clip(np.round(ml_sub * invm[:, None]), 0, 15).astype(np.uint8)
    dl_q = d.astype(np.float32)[:, None] * sc4
    ml_q = dmin.astype(np.float32)[:, None] * mn4
    inv_dl = np.where(dl_q > 0, 1.0 / dl_q, 0.0)
    q = np.clip(np.round((sub + ml_q[:, :, None]) * inv_dl[:, :, None]),
                0, 3).astype(np.uint8)            # (nb, 16, 16)
    out = np.empty((nb, 84), dtype=np.uint8)
    out[:, :16] = sc4 | (mn4 << 4)
    # invert the element order: sub-block k = (half, shift, lo/hi 16)
    qs = np.zeros((nb, 2, 32), dtype=np.uint8)
    k = 0
    for h in range(2):
        for s in range(0, 8, 2):
            qs[:, h, :16] |= q[:, k] << s
            qs[:, h, 16:] |= q[:, k + 1] << s
            k += 2
    out[:, 16:80] = qs.reshape(nb, 64)
    out[:, 80:82] = d.view(np.uint8).reshape(-1, 2)
    out[:, 82:84] = dmin.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Q3_K — 16 sub-blocks of 16; 6-bit signed scales (−32..31) packed in 12 B,
# superblock f16 d; 3-bit quants = 2 low bits in qs + 1 high bit in hmask
# (bit clear ⇒ −4 offset).  Layout per llama.cpp block_q3_K:
# hmask[32] | qs[64] | scales[12] | d (110 B).  Same two-half/shift element
# order as Q2_K; the hmask bit index runs 0..7 ACROSS both halves.
# ---------------------------------------------------------------------------

def _q3k_unpack_scales(sb: np.ndarray) -> np.ndarray:
    """(nb, 12) uint8 → (nb, 16) float32 scales in −32..31 (bias removed),
    mirroring llama.cpp's kmask aux munging bytewise."""
    k = np.arange(4)
    a0 = (sb[:, k] & 0x0F) | ((sb[:, 8 + k] & 3) << 4)
    a1 = (sb[:, 4 + k] & 0x0F) | (((sb[:, 8 + k] >> 2) & 3) << 4)
    a2 = (sb[:, k] >> 4) | (((sb[:, 8 + k] >> 4) & 3) << 4)
    a3 = (sb[:, 4 + k] >> 4) | (((sb[:, 8 + k] >> 6) & 3) << 4)
    return np.concatenate([a0, a1, a2, a3], axis=1).astype(np.float32) - 32.0


def _q3k_pack_scales(sc6: np.ndarray) -> np.ndarray:
    """(nb, 16) uint8 6-bit (bias-32 applied by caller) → (nb, 12) bytes."""
    sc6 = sc6.astype(np.uint8)
    nb = sc6.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    k = np.arange(4)
    out[:, k] = (sc6[:, k] & 0x0F) | ((sc6[:, 8 + k] & 0x0F) << 4)
    out[:, 4 + k] = (sc6[:, 4 + k] & 0x0F) | ((sc6[:, 12 + k] & 0x0F) << 4)
    out[:, 8 + k] = (((sc6[:, k] >> 4) & 3)
                     | (((sc6[:, 4 + k] >> 4) & 3) << 2)
                     | (((sc6[:, 8 + k] >> 4) & 3) << 4)
                     | (((sc6[:, 12 + k] >> 4) & 3) << 6))
    return out


@_garbage_tolerant
def dequant_q3_k(buf: np.ndarray, n: int) -> np.ndarray:
    nb = n // QK_K
    bs = GGML_BLOCK_SIZES[GGMLType.Q3_K][1]  # 110
    blocks = buf[: nb * bs].reshape(nb, bs)
    hm = blocks[:, :32]
    qs = blocks[:, 32:96].reshape(nb, 2, 32)
    d = _f16(blocks[:, 108:110].reshape(-1))
    dl = d[:, None] * _q3k_unpack_scales(blocks[:, 96:108])  # (nb, 16)
    parts = []
    for h in range(2):
        for j in range(4):
            m = 1 << (4 * h + j)
            s = 2 * j
            lo = ((qs[:, h, :16] >> s) & 3).astype(np.float32) \
                - np.where(hm[:, :16] & m, 0.0, 4.0)
            hi = ((qs[:, h, 16:] >> s) & 3).astype(np.float32) \
                - np.where(hm[:, 16:] & m, 0.0, 4.0)
            parts.append(lo)
            parts.append(hi)
    qv = np.stack(parts, axis=1)                             # (nb, 16, 16)
    return (dl[:, :, None] * qv).reshape(-1)


def quant_q3_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK_K)
    nb = x.shape[0]
    sub = x.reshape(nb, 16, 16)
    # symmetric per-sub-block fit onto −4..3 (like Q4_0's max-|x|→−end)
    idx = np.abs(sub).argmax(axis=2)
    maxv = np.take_along_axis(sub, idx[:, :, None], axis=2)[:, :, 0]
    dl_sub = maxv / -4.0
    amax = np.abs(dl_sub).max(axis=1)
    d = np.where(amax > 0, amax / 31.0, 0.0).astype(np.float16)
    invd = np.where(d > 0, 1.0 / d.astype(np.float32), 0.0)
    sc = np.clip(np.round(dl_sub * invd[:, None]), -32, 31)  # (nb, 16)
    dl_q = d.astype(np.float32)[:, None] * sc
    inv_dl = np.where(dl_q != 0, 1.0 / dl_q, 0.0)
    q = np.clip(np.round(sub * inv_dl[:, :, None]), -4, 3).astype(np.int8)
    qplus = (q + 4).astype(np.uint8)            # 0..7: 2 low bits + hm bit
    out = np.empty((nb, 110), dtype=np.uint8)
    hm = np.zeros((nb, 32), dtype=np.uint8)
    qs = np.zeros((nb, 2, 32), dtype=np.uint8)
    k = 0
    for h in range(2):
        for j in range(4):
            m = 1 << (4 * h + j)
            s = 2 * j
            qs[:, h, :16] |= (qplus[:, k] & 3) << s
            qs[:, h, 16:] |= (qplus[:, k + 1] & 3) << s
            hm[:, :16] |= np.where(qplus[:, k] & 4, m, 0).astype(np.uint8)
            hm[:, 16:] |= np.where(qplus[:, k + 1] & 4, m, 0).astype(np.uint8)
            k += 2
    out[:, :32] = hm
    out[:, 32:96] = qs.reshape(nb, 64)
    out[:, 96:108] = _q3k_pack_scales((sc + 32).astype(np.uint8))
    out[:, 108:110] = d.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


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
    GGMLType.BF16: dequant_bf16,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q2_K: dequant_q2_k,
    GGMLType.Q3_K: dequant_q3_k,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
    GGMLType.IQ4_NL: dequant_iq4_nl,
    GGMLType.IQ4_XS: dequant_iq4_xs,
}

QUANT = {
    GGMLType.F32: lambda x: np.ascontiguousarray(x, dtype=np.float32).view(np.uint8),
    GGMLType.F16: lambda x: np.ascontiguousarray(x, dtype=np.float32).astype(np.float16).view(np.uint8),
    GGMLType.BF16: quant_bf16,
    GGMLType.Q4_0: quant_q4_0,
    GGMLType.Q4_1: quant_q4_1,
    GGMLType.Q5_0: quant_q5_0,
    GGMLType.Q5_1: quant_q5_1,
    GGMLType.Q8_0: quant_q8_0,
    GGMLType.Q2_K: quant_q2_k,
    GGMLType.Q3_K: quant_q3_k,
    GGMLType.Q4_K: quant_q4_k,
    GGMLType.Q5_K: quant_q5_k,
    GGMLType.Q6_K: quant_q6_k,
    GGMLType.IQ4_NL: quant_iq4_nl,
    GGMLType.IQ4_XS: quant_iq4_xs,
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

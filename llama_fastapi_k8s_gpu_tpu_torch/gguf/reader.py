"""GGUF v2/v3 container reader: mmap'd, zero-copy tensor views.

Replaces the file-loading half of the native engine the reference constructs
at import time (``Llama(model_path=...)``, reference api.py:24-28): header,
metadata KV store (architecture, hparams, tokenizer vocab/merges, chat
template), tensor index, and aligned data section exposed as ``np.memmap``
slices so multi-GB weights are paged in lazily.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_SCALAR_FMT as _SCALAR_FMT,
    GGMLType,
    GGUFValueType,
    align_up,
    tensor_nbytes,
)

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


class _Cursor:
    """Sequential little-endian decoder over a buffer."""

    def __init__(self, buf: memoryview, offset: int = 0):
        self.buf = buf
        self.off = offset

    def scalar(self, vtype: GGUFValueType):
        fmt = _SCALAR_FMT[vtype]
        size = struct.calcsize(fmt)
        (val,) = struct.unpack_from(fmt, self.buf, self.off)
        self.off += size
        return val

    def u32(self) -> int:
        return self.scalar(GGUFValueType.UINT32)

    def u64(self) -> int:
        return self.scalar(GGUFValueType.UINT64)

    def string(self, len_type: GGUFValueType = GGUFValueType.UINT64) -> str:
        n = self.scalar(len_type)
        raw = bytes(self.buf[self.off : self.off + n])
        self.off += n
        return raw.decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType, len_type: GGUFValueType):
        vtype = GGUFValueType(vtype)
        if vtype == GGUFValueType.STRING:
            return self.string(len_type)
        if vtype == GGUFValueType.BOOL:
            return bool(self.scalar(GGUFValueType.INT8))
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self.u32())
            count = self.scalar(len_type)
            if elem_type in _SCALAR_NP and elem_type != GGUFValueType.BOOL:
                dt = np.dtype(_SCALAR_NP[elem_type]).newbyteorder("<")
                arr = np.frombuffer(self.buf, dtype=dt, count=count, offset=self.off)
                self.off += arr.nbytes
                return arr.tolist()
            return [self.value(elem_type, len_type) for _ in range(count)]
        return self.scalar(vtype)


@dataclasses.dataclass
class GGUFTensor:
    name: str
    shape: tuple[int, ...]  # ggml order: shape[0] is fastest-varying (row length)
    ggml_type: GGMLType
    offset: int             # relative to data-section start
    _file: "GGUFFile" = dataclasses.field(repr=False, default=None)

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.ggml_type, self.n_elements)

    def raw(self) -> np.ndarray:
        """Zero-copy uint8 view of the on-disk block data."""
        start = self._file.data_offset + self.offset
        return self._file.mmap[start : start + self.nbytes]

    def astype_f32(self) -> np.ndarray:
        """Dequantize to float32, shaped (shape[-1], ..., shape[0]).

        GGUF stores dims innermost-first; numpy is outermost-first, so a 2-D
        weight with ggml shape (n_in, n_out) comes back as (n_out, n_in) —
        i.e. rows are output features, matching `x @ w.T` usage.
        """
        from . import quants

        flat = quants.dequantize(self.raw(), self.ggml_type, self.n_elements)
        return flat.reshape(tuple(reversed(self.shape)))


class GGUFFile:
    """Parsed GGUF container. ``metadata`` dict + named tensor index."""

    def __init__(self, path: str):
        self.path = path
        self.mmap = np.memmap(path, dtype=np.uint8, mode="r")
        cur = _Cursor(memoryview(self.mmap))
        try:
            self._parse(path, cur)
        except (struct.error, IndexError) as e:
            raise ValueError(f"{path}: truncated or corrupt GGUF file ({e})") from e

    def _parse(self, path: str, cur: "_Cursor"):
        magic = cur.u32()
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        self.version = cur.u32()
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        len_type = GGUFValueType.UINT64 if self.version >= 2 else GGUFValueType.UINT32
        n_tensors = cur.scalar(len_type)
        n_kv = cur.scalar(len_type)

        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.string(len_type)
            vtype = GGUFValueType(cur.u32())
            self.metadata[key] = cur.value(vtype, len_type)

        self.tensors: dict[str, GGUFTensor] = {}
        for _ in range(n_tensors):
            name = cur.string(len_type)
            n_dims = cur.u32()
            shape = tuple(cur.u64() for _ in range(n_dims))
            ggml_type = GGMLType(cur.u32())
            offset = cur.u64()
            self.tensors[name] = GGUFTensor(name, shape, ggml_type, offset, self)

        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        self.data_offset = align_up(cur.off, self.alignment)

    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "llama")

    def hparam(self, key: str, default=None):
        """Look up ``<arch>.<key>`` with a plain-key fallback."""
        arch = self.architecture
        if f"{arch}.{key}" in self.metadata:
            return self.metadata[f"{arch}.{key}"]
        return self.metadata.get(key, default)

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def __getitem__(self, name: str) -> GGUFTensor:
        return self.tensors[name]

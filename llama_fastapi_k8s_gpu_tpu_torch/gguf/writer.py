"""GGUF v3 writer.

The reference never writes GGUF (artifacts come from S3,
helm/templates/deployment.yaml:26-49); this writer exists so the framework can
(a) build tiny hand-made GGUF files for golden tests (SURVEY.md §4) and
(b) synthesize full-size quantized models for benchmarking without network
egress.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_SCALAR_FMT,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    align_up,
    tensor_nbytes,
)
from . import quants


def _pack_string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<Q", len(raw)) + raw


def _normalize(v: Any) -> Any:
    """numpy scalars/arrays → plain Python so type inference and struct.pack work."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_normalize(it) for it in v]
    return v


def _infer_type(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        if v < 0:
            return GGUFValueType.INT32 if v >= -(2**31) else GGUFValueType.INT64
        return GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


def _infer_array_elem_type(items: list) -> GGUFValueType:
    """Widest element type across the whole array, not just items[0]."""
    if not items:
        return GGUFValueType.STRING
    types = {_infer_type(it) for it in items}
    if types == {GGUFValueType.UINT32}:
        return GGUFValueType.UINT32
    int_types = {GGUFValueType.UINT32, GGUFValueType.INT32,
                 GGUFValueType.UINT64, GGUFValueType.INT64}
    if types <= int_types:
        if GGUFValueType.UINT64 in types and GGUFValueType.INT32 not in types \
                and GGUFValueType.INT64 not in types:
            return GGUFValueType.UINT64
        return GGUFValueType.INT64 if (
            GGUFValueType.UINT64 in types or GGUFValueType.INT64 in types
        ) else GGUFValueType.INT32
    if len(types) == 1:
        return next(iter(types))
    raise TypeError(f"mixed array element types {types}")


def _pack_value(v: Any, vtype: GGUFValueType) -> bytes:
    if vtype == GGUFValueType.STRING:
        return _pack_string(v)
    if vtype == GGUFValueType.BOOL:
        return struct.pack("<b", 1 if v else 0)
    if vtype == GGUFValueType.ARRAY:
        items = list(v)
        etype = _infer_array_elem_type(items)
        out = struct.pack("<IQ", int(etype), len(items))
        return out + b"".join(_pack_value(it, etype) for it in items)
    return struct.pack(GGUF_SCALAR_FMT[vtype], v)


class GGUFWriter:
    def __init__(self, path: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self.metadata: list[tuple[str, Any, GGUFValueType]] = []
        # (name, ggml shape innermost-first, type, raw bytes)
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []

    def add_metadata(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        value = _normalize(value)
        self.metadata.append((key, value, vtype or _infer_type(value)))

    def add_tensor(self, name: str, array: np.ndarray, ggml_type: GGMLType):
        """``array`` in numpy orientation (outermost-first); quantized here."""
        array = np.asarray(array)
        ggml_shape = tuple(reversed(array.shape))
        raw = quants.quantize(array.astype(np.float32), ggml_type)
        expect = tensor_nbytes(ggml_type, array.size)
        if raw.nbytes != expect:
            raise AssertionError(f"{name}: {raw.nbytes} != {expect}")
        self._tensors.append((name, ggml_shape, ggml_type, raw))

    def add_raw_tensor(self, name: str, ggml_shape: tuple[int, ...],
                       ggml_type: GGMLType, raw: np.ndarray):
        self._tensors.append((name, tuple(ggml_shape), ggml_type, np.ascontiguousarray(raw, dtype=np.uint8)))

    def write(self):
        if self.alignment != GGUF_DEFAULT_ALIGNMENT and not any(
            k == "general.alignment" for k, _, _ in self.metadata
        ):
            # the reader derives data_offset from this key; omitting it would
            # silently corrupt every tensor view
            self.add_metadata("general.alignment", self.alignment)
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                                len(self._tensors), len(self.metadata)))
            for key, value, vtype in self.metadata:
                f.write(_pack_string(key))
                f.write(struct.pack("<I", int(vtype)))
                f.write(_pack_value(value, vtype))
            offset = 0
            for name, shape, ggml_type, raw in self._tensors:
                f.write(_pack_string(name))
                f.write(struct.pack("<I", len(shape)))
                for d in shape:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", int(ggml_type), offset))
                offset += align_up(raw.nbytes, self.alignment)
            pos = f.tell()
            f.write(b"\x00" * (align_up(pos, self.alignment) - pos))
            for _, _, _, raw in self._tensors:
                f.write(raw.tobytes())
                f.write(b"\x00" * (align_up(raw.nbytes, self.alignment) - raw.nbytes))

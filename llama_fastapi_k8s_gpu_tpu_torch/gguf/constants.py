"""GGUF container + GGML quant-type constants.

The reference consumes GGUF files through the opaque native engine
(``llama_cpp.Llama(model_path=...)``, reference api.py:24-28, pulling
``*Q4_K_M.gguf`` artifacts — reference api.py:14,
helm/templates/deployment.yaml:32).  This module pins the file-format contract
that the in-tree PyTorch engine implements instead.

Layouts follow the public GGUF spec (ggml-org/ggml docs/gguf.md) and the GGML
quantization block formats; values are the on-disk wire constants.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

QK_K = 256  # K-quant super-block size
QK8_0 = 32
QK4_0 = 32
QK5_0 = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


# struct format for each scalar metadata value type (shared by reader/writer)
GGUF_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ4_NL = 20
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (elements per block, bytes per block)
GGML_BLOCK_SIZES: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.F64: (1, 8),
    GGMLType.Q4_0: (QK4_0, 2 + 16),
    GGMLType.Q4_1: (QK4_0, 2 + 2 + 16),
    GGMLType.Q5_0: (QK5_0, 2 + 4 + 16),
    GGMLType.Q5_1: (QK5_0, 2 + 2 + 4 + 16),
    GGMLType.Q8_0: (QK8_0, 2 + 32),
    GGMLType.Q2_K: (QK_K, QK_K // 16 + QK_K // 4 + 2 + 2),
    GGMLType.Q3_K: (QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLType.Q4_K: (QK_K, 2 + 2 + 12 + QK_K // 2),
    GGMLType.Q5_K: (QK_K, 2 + 2 + 12 + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLType.IQ4_NL: (32, 2 + 16),
    GGMLType.IQ4_XS: (QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
}


def align_up(n: int, alignment: int) -> int:
    return (n + alignment - 1) // alignment * alignment


def tensor_nbytes(ggml_type: GGMLType, n_elements: int) -> int:
    block, nbytes = GGML_BLOCK_SIZES[ggml_type]
    if n_elements % block != 0:
        raise ValueError(
            f"{ggml_type.name}: element count {n_elements} not divisible by block {block}"
        )
    return (n_elements // block) * nbytes

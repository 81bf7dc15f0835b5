"""Linear-layer formats and the matmul dispatch.

A :class:`Linear` holds one weight in one format, named by ``kind``:

- ``"bf16"`` — a (out, in) bf16 plane, multiplied with ``torch.matmul``;
- ``"q4k"`` / ``"q5k"`` / ``"q6k"`` / ``"q8"`` — the GGUF Q4_K / Q5_K /
  Q6_K / Q8_0 block bytes, (out, in/block · block bytes) uint8, multiplied
  by the fused kernels of :mod:`.q4k` / :mod:`.q5k` / :mod:`.q6k` /
  :mod:`.q8`.

Each layer keeps its own weights (models/params.py holds them in an
``nn.ModuleList``), so there is no stacked-layer indexing.  The int8 format
is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from .q4k import q4k_matmul
from .q5k import q5k_matmul
from .q6k import q6k_matmul
from .q8 import q8_matmul

_FUSED = {"q4k": q4k_matmul, "q5k": q5k_matmul, "q6k": q6k_matmul,
          "q8": q8_matmul}


class Linear(nn.Module):
    """One weight of an attention or FFN projection (or the output head)."""

    def __init__(self, kind: str, weight: torch.Tensor, n_out: int, k_in: int):
        super().__init__()
        if kind != "bf16" and kind not in _FUSED:
            raise ValueError(f"linear kind must be bf16|{'|'.join(_FUSED)}, got {kind!r}")
        self.kind = kind
        self.n_out = n_out
        self.k_in = k_in
        self.register_buffer("weight", weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self)

    def extra_repr(self) -> str:
        return f"kind={self.kind}, n_out={self.n_out}, k_in={self.k_in}"


def linear(x: torch.Tensor, w: Linear) -> torch.Tensor:
    """x (..., in) bf16 → (..., out) bf16."""
    if w.kind == "bf16":
        return torch.matmul(x, w.weight.t())
    return _FUSED[w.kind](x, w.weight, w.n_out, w.k_in)

"""Linear-layer formats and the matmul dispatch.

A :class:`Linear` holds one weight in one format, named by ``kind``:

- ``"bf16"`` — a (out, in) bf16 plane, multiplied with ``torch.matmul``;
- ``"int8"`` — symmetric per-output-row int8: ``weight`` (out, in) int8 and
  ``scale`` (out,) f32, ``w ≈ weight · scale``.  The activations are
  quantized per row on the fly, the product accumulates in int32
  (``torch._int_mm`` on the card, an int32 ``matmul`` on the CPU) and is
  rescaled in f32 — the JAX reference's ``{"q", "s"}`` format, which it
  too computes outside any Pallas kernel;
- ``"q4k"`` / ``"q5k"`` / ``"q6k"`` / ``"q8"`` — the GGUF Q4_K / Q5_K /
  Q6_K / Q8_0 block bytes, (out, in/block · block bytes) uint8, multiplied
  by the fused kernels of :mod:`.q4k` / :mod:`.q5k` / :mod:`.q6k` /
  :mod:`.q8`.

Each layer keeps its own weights (models/params.py holds them in an
``nn.ModuleList``), so there is no stacked-layer indexing.

Every division that must be bit-exact with the reference divides a tensor
by a tensor: PyTorch's CUDA division by a Python scalar multiplies by the
scalar's reciprocal, an ulp off IEEE division (ops/kvquant.py).
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
KINDS = ("bf16", "int8", *_FUSED)
#: ``torch._int_mm`` on the card takes more than this many rows
_INT_MM_MIN_ROWS = 17


class Linear(nn.Module):
    """One weight of an attention or FFN projection (or the output head).
    ``scale`` is the per-row f32 scale of an ``int8`` weight (None for the
    other kinds)."""

    def __init__(self, kind: str, weight: torch.Tensor, n_out: int, k_in: int,
                 scale: torch.Tensor | None = None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"linear kind must be {'|'.join(KINDS)}, got {kind!r}")
        if (kind == "int8") != (scale is not None):
            raise ValueError("an int8 linear needs its per-row scale, no other kind has one")
        self.kind = kind
        self.n_out = n_out
        self.k_in = k_in
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self)

    def extra_repr(self) -> str:
        return f"kind={self.kind}, n_out={self.n_out}, k_in={self.k_in}"


def _row_scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` where ``amax > 0``, else 1.0, in IEEE f32."""
    s = amax / torch.full_like(amax, 127.0)
    return torch.where(amax > 0, s, torch.ones_like(s))


def make_linear_int8(w: torch.Tensor) -> Linear:
    """(out, in) float weights → an ``int8`` :class:`Linear`: per row
    ``s = max|w| / 127`` (1.0 for an all-zero row) and ``q = clip(round(w /
    s), -127, 127)``, rounding half to even — the reference's
    ``make_linear_int8`` bit for bit, on whatever device ``w`` lies."""
    w = w.float()
    s = _row_scale(w.abs().amax(dim=1))
    q = torch.round(w / s[:, None]).clamp_(-127, 127).to(torch.int8)
    return Linear("int8", q, w.shape[0], w.shape[1], scale=s)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) → (xq int8 (..., K), xs f32 (..., 1)): the int8 linear's
    dynamic per-row activation quantization, ``xq = round(x / xs)`` with
    ``xs = max|x| / 127`` (1.0 for an all-zero row)."""
    xf = x.float()
    xs = _row_scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / xs).to(torch.int8), xs


def _int8_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 × (N, K) int8 → (M, N) int32, exact."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.to(torch.int32), q.to(torch.int32).t())
    M = xq.shape[0]
    if M < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(_INT_MM_MIN_ROWS - M, xq.shape[1])])
    return torch._int_mm(xq, q.t())[:M]


def _bf16_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 × (N, K) bf16 → (M, N) f32: on the card one bf16 GEMM
    with an f32 output, so the weight is never copied to f32; the CPU has
    no such product and multiplies f32 copies."""
    if x.device.type == "cpu":
        return torch.matmul(x.float(), w.float().t())
    return torch.mm(x, w.t(), out_dtype=torch.float32)


def linear_int8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x (..., K) bf16 against int8 rows ``q`` (N, K) with scales ``s`` (N,)
    → (..., N) in ``x.dtype``: ``(acc · xs) · s`` in f32 over the exact int32
    ``acc``, the reference's order."""
    lead = x.shape[:-1]
    xq, xs = quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = _int8_matmul(xq, q)
    y = acc.float() * xs * s
    return y.to(x.dtype).reshape(*lead, q.shape[0])


def linear(x: torch.Tensor, w: Linear) -> torch.Tensor:
    """x (..., in) bf16 → (..., out) bf16."""
    if w.kind == "bf16":
        return torch.matmul(x, w.weight.t())
    if w.kind == "int8":
        return linear_int8(x, w.weight, w.scale)
    return _FUSED[w.kind](x, w.weight, w.n_out, w.k_in)

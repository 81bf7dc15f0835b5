"""The shared wrapper of the fused dequant-matmuls (``q4k``, ``q5k``,
``q6k``, ``q8``).

Each format keeps its weight as the file's own block bytes, one row of
blocks per output feature: ``(N, K / block_elems · block_bytes)`` uint8.
:func:`fused_matmul` checks the shapes, runs the format's plain version for
a CPU tensor, and otherwise launches the format's CUDA kernel and counts
the launch on the public wrapper it was given.

Every launcher takes one of two paths by the number of activation rows:
the tensor-core template (``csrc/qmma.cuh``) from its format's threshold on
— every prompt pass — and below it the matrix-vector template
(``csrc/qgemv.cuh``) with its format's unit decoder.  The tensor-core
template takes whole 256-element groups only, so a Q8_0 weight whose K is
not a multiple of 256 takes the matrix-vector path at every B, and an x
16-byte aligned only, so the wrapper copies any other x it sends there;
:func:`route` says which path a call takes.
"""

from __future__ import annotations

import torch

from ._kernels import check, library, require_cuda, stream_ptr
from .dequant import QK_K


def matmul_plain(dequant_f32, x: torch.Tensor, w: torch.Tensor, n_out: int,
                 k_in: int) -> torch.Tensor:
    """The plain version of every fused matmul: dequantize W to f32 with
    the codec's arithmetic, multiply in f32, round the result to
    ``x.dtype``."""
    wf = dequant_f32(w.reshape(-1)).reshape(n_out, k_in)
    return torch.matmul(x.float(), wf.t()).to(x.dtype)


#: the fused matmuls whose launchers take the tensor cores at large B, in
#: the order of csrc/qmma.cuh's ``Format`` (the index of a format's threshold)
TC_KERNELS = ("q4k_matmul", "q5k_matmul", "q6k_matmul", "q8_matmul")


def route(name: str, batch: int, k_in: int) -> str:
    """The path the launcher of fused matmul ``name`` takes on the card for
    ``batch`` activation rows of depth ``k_in``: ``"tc"`` (tensor cores) or
    ``"cuda_core"``.  The library, whose launchers make the choice,
    answers."""
    if name in TC_KERNELS and library().lfkt_fused_tc_route(TC_KERNELS.index(name),
                                                             batch, k_in):
        return "tc"
    return "cuda_core"


def tc_min_batch(name: str) -> int:
    """The smallest B the launcher of ``name`` sends to the tensor cores."""
    return next(b for b in range(1, 1 << 16) if route(name, b, QK_K) == "tc")


def tc_config(name: str, min_batch: int) -> None:
    """For measurement: make the launcher of ``name`` take the tensor cores
    from ``min_batch`` rows on."""
    check(library().lfkt_fused_tc_config(TC_KERNELS.index(name), min_batch), "tc_config")


def aligned_rows(x: torch.Tensor, align: int) -> torch.Tensor:
    """``x`` itself where its address is a multiple of ``align`` bytes, else
    a fresh copy of it: a new tensor's storage starts far more aligned
    (64 bytes on the CPU, 512 on the card)."""
    return x if x.data_ptr() % align == 0 else x.clone()


def fused_matmul(wrapper, plain, launcher: str, x: torch.Tensor, w: torch.Tensor,
                 n_out: int, k_in: int, block_elems: int, block_bytes: int,
                 align: int) -> torch.Tensor:
    """x (..., K) bf16 → (..., N) bf16 against the block rows ``w``.

    ``align`` is the byte alignment the kernel's widest weight load needs
    of ``w``'s base address (the row stride keeps it for every row)."""
    name = wrapper.__name__
    if k_in % block_elems or w.shape != (n_out, k_in // block_elems * block_bytes):
        raise ValueError(f"{name}: weight {tuple(w.shape)} is not ({n_out}, {k_in}) "
                         f"in {block_bytes}-byte blocks of {block_elems}")
    if x.shape[-1] != k_in:
        raise ValueError(f"{name}: x has K={x.shape[-1]}, weight {k_in}")
    if x.device.type == "cpu":
        return plain(x, w, n_out, k_in)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_in).contiguous()
    require_cuda(name, x2, w, dtypes=(torch.bfloat16, torch.uint8))
    if w.data_ptr() % align:
        raise ValueError(f"{name}: weight address not {align}-byte aligned")
    # the tensor cores copy x in 16-byte units (csrc/qmma.cuh); the decode
    # path reads any x, 16 bytes wide where it is aligned.  The route (a
    # library call) is asked only for an x off a 16-byte boundary
    if x2.data_ptr() % 16 and route(name, x2.shape[0], k_in) == "tc":
        x2 = aligned_rows(x2, 16)
    y = torch.empty(x2.shape[0], n_out, dtype=torch.bfloat16, device=x.device)
    check(getattr(library(), launcher)(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                                       x2.shape[0], n_out, k_in, stream_ptr(x)),
          name)
    wrapper.launches += 1
    return y.reshape(*lead, n_out)

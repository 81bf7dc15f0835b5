"""Load the port's CUDA kernels (``csrc/*.cu``) and bind them.

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds, not minutes.  Where the library lives, how it is found and how it
is built is ``utils/kernelcache.py``'s: under ``LFKT_COMPILE_CACHE_DIR``
(an image bakes it there at build time) or the package's ``_build/``, keyed
by a digest of the sources and flags, built at first use where no library
is found and ``nvcc`` is, never at import: the CPU test hosts have no
``nvcc``.

There is no fallback.  No library and no toolkit, a compile error or a
refused launch raises; the wrappers in ``ops/`` take their plain PyTorch
version only for tensors that live on the CPU.
"""

from __future__ import annotations

import ctypes
import threading

from ..utils import kernelcache

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every exported launcher (all return the cudaError_t)
SIGNATURES = {
    "lfkt_dequant_q4k": [_P, _P, ctypes.c_longlong, _I, _P],
    "lfkt_dequant_q5k": [_P, _P, ctypes.c_longlong, _I, _P],
    "lfkt_dequant_q6k": [_P, _P, ctypes.c_longlong, _I, _P],
    "lfkt_dequant_q8_0": [_P, _P, ctypes.c_longlong, _I, _P],
    "lfkt_q4k_matmul": [_P, _P, _P, _I, _I, _I, _P],
    "lfkt_q5k_matmul": [_P, _P, _P, _I, _I, _I, _P],
    "lfkt_q6k_matmul": [_P, _P, _P, _I, _I, _I, _P],
    "lfkt_q8_matmul": [_P, _P, _P, _I, _I, _I, _P],
    "lfkt_fused_tc_route": [_I, _I, _I],
    "lfkt_fused_tc_config": [_I, _I],
    "lfkt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             ctypes.c_float, _I, _P],
    "lfkt_flash_attention_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  ctypes.c_float, _I, _P],
    "lfkt_kv_quantize": [_P] * 9 + [_I] * 4 + [ctypes.c_longlong, _P],
    "lfkt_decode_loop": [_P] * 12 + [_I] * 13 + [ctypes.c_float] * 2 + [_I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:  # lfkt: blocks-under[_lock] -- one-time lazy library find/build and dlopen: concurrent callers must block until the handle exists, then every call is a cached read  # lfkt: noqa[GRAPH002] -- _lib is set once, at the first load, which capture_step's eager warm-up step runs before the capture; a capture only reads it
    """The loaded kernel library, found, else built (utils/kernelcache.py)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(kernelcache.library_path())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lfkt_error_string.argtypes = [_I]
        lib.lfkt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t from a launcher."""
    if status != 0:
        msg = library().lfkt_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}: {msg}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors, dtypes=None) -> None:
    """The wrappers' argument check for the kernel path: every tensor on one
    CUDA device, contiguous, and (optionally) of the expected dtype."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} on {t.device}, expected {dev} (cuda)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and dtypes[i] is not None and t.dtype != dtypes[i]:
            raise ValueError(f"{name}: argument {i} is {t.dtype}, expected {dtypes[i]}")

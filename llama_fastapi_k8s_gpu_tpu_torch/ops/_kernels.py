"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  Each ``.cu`` file compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects.  The library
lands in ``_build/<digest>/`` inside the package (git-ignored), keyed by a
digest of the sources and flags, so an edited kernel rebuilds and an
unchanged one loads at once.  Building happens at first use, never at
import: the CPU test hosts have no ``nvcc``.

A build is one compile of the ``kernel_build`` program on the compile
registry (obs/devtime.py), its signature the digest, its wall the build's;
a library found built records none.

There is no fallback.  A missing toolkit, a compile error or a refused
launch raises; the wrappers in ``ops/`` take their plain PyTorch version
only for tensors that live on the CPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..obs.devtime import ENTRY, record_compile, register_program

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS]

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
    "lfkt_kv_quantize": [_P] * 9 + [_I] * 4 + [_P],
    "lfkt_decode_loop": [_P] * 15 + [_I] * 10 + [ctypes.c_float] * 2 + [_I, _I, _P],
}

_lock = threading.Lock()
_lib = None
register_program("kernel_build", ENTRY, site="ops._kernels")
#: wall seconds and ptxas report of the build this process loaded (its
#: log also when another process built it)
build_info: dict = {}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _build(out_dir: str, digest: str) -> str:
    """Compile every source in parallel, link, return the library path."""
    nvcc = nvcc_path()
    t0 = time.time()
    procs = []
    for src in _sources():
        obj = os.path.join(out_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(os.path.basename(src))
    log_text = "\n".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        fh.write(log_text)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log_text}")
    lib = os.path.join(out_dir, "liblfkt_kernels.so")
    tmp = lib + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                           *(obj for _, obj, _ in procs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    build_info.update(seconds=time.time() - t0, log=log_text, built=True)
    record_compile("kernel_build", digest, build_info["seconds"])
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this digest has none."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = _digest()
        out_dir = os.path.join(BUILD_ROOT, digest)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "liblfkt_kernels.so")
        with open(os.path.join(out_dir, ".lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)   # one builder per digest
            if not os.path.exists(path):
                _build(out_dir, digest)
            else:
                build_info.setdefault("built", False)
                build_info.setdefault("seconds", 0.0)
                log = os.path.join(out_dir, "build.log")
                if os.path.exists(log):
                    with open(log) as fh:
                        build_info.setdefault("log", fh.read())
        lib = ctypes.CDLL(path)
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

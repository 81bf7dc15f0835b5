"""Build and find the port's kernel library: the counterpart of the JAX
package's ``utils/jaxcache.py``.

The JAX package keeps XLA's compiled programs in ``LFKT_COMPILE_CACHE_DIR``
so that a restart skips recompiling.  What the port compiles is one shared
library of ``csrc/*.cu`` (plain C interface, loaded by ``ops/_kernels.py``
with ``ctypes``), and the same knob says where it lives:

- ``<LFKT_COMPILE_CACHE_DIR>/lfkt-kernels/<digest>/`` when the knob is set,
  else the package's own ``_build/<digest>/``.  The digest covers the
  sources and the nvcc flags, not the toolkit, so an image's build stage
  and the pods that run the image agree on it; the toolkit's
  ``nvcc --version`` is kept beside the library (``nvcc.txt``).
- A library found there is loaded with nothing written: no directory made,
  no lock taken, no log.  A read-only image or cache serves.
- Else it is built: every source by its own ``nvcc``, all started together,
  then one link, into a temporary directory under the same root that is
  renamed to ``<digest>/`` whole and readable by every user.  A reader
  never sees half a library, and two processes building on one volume
  build once (an ``flock`` around the build).  A build is one compile of the ``kernel_build`` program on the
  compile registry (obs/devtime.py); a library found records none.
- No library and no ``nvcc`` (``CUDA_HOME``, ``CUDA_PATH``, ``PATH``)
  raises, naming the digest, the directory and the command that builds it.
  There is no fallback.

This module imports no ``torch``: an image's build stage has the CUDA
toolkit and Python alone.  ``nvcc`` for ``sm_90a`` needs no card::

    LFKT_COMPILE_CACHE_DIR=/opt/lfkt/kernels \\
        python3 -m llama_fastapi_k8s_gpu_tpu_torch.utils.kernelcache

builds (or finds) the library and prints one JSON line: the digest, the
library's path, whether it was built, the seconds and the nvcc version.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from ..obs.devtime import ENTRY, record_compile, register_program
from .config import knob

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
LIBRARY = "liblfkt_kernels.so"
#: the command that builds the library into the knob's directory
BUILD_COMMAND = "python3 -m llama_fastapi_k8s_gpu_tpu_torch.utils.kernelcache"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS]

register_program("kernel_build", ENTRY, site="utils.kernelcache")
#: the library this process found or built: ``built``, ``seconds`` (of the
#: build; 0 when found), ``digest``, ``path``, ``nvcc`` (the toolkit's
#: release line) and ``log`` (the ``ptxas -v`` report), each where known
build_info: dict = {}


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def digest() -> str:
    """The library's key: the nvcc flags and every ``.cu``/``.cuh`` source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def cache_root() -> str:  # lfkt: noqa[GRAPH001] -- the kernel library's first load: capture_step's eager warm-up step runs the captured callable first, so a capture finds the library cached (ops/_kernels.library) and never reaches this
    """Where the digests' directories live: under the knob, else the
    package's ``_build/``."""
    d = knob("LFKT_COMPILE_CACHE_DIR")
    return os.path.join(d, "lfkt-kernels") if d else os.path.join(PKG, "_build")


def cache_dir() -> str:
    return os.path.join(cache_root(), digest())


def find_nvcc() -> str | None:  # lfkt: noqa[GRAPH001] -- the kernel library's first load: capture_step's eager warm-up step runs the captured callable first, so a capture finds the library cached (ops/_kernels.library) and never reaches this
    """``nvcc`` under ``CUDA_HOME`` or ``CUDA_PATH``, else on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return shutil.which("nvcc")


def _read(path: str) -> str | None:
    if not os.path.isfile(path):
        return None
    with open(path, errors="replace") as fh:
        return fh.read()


def _release(version_text: str | None) -> str | None:
    """The ``release`` line of ``nvcc --version``."""
    lines = (version_text or "").strip().splitlines()
    return next((ln.strip() for ln in lines if "release" in ln),
                lines[-1].strip() if lines else None)


def _describe(out_dir: str, built: bool, seconds: float) -> None:
    build_info.clear()
    build_info.update(built=built, seconds=seconds, digest=os.path.basename(out_dir),
                      path=os.path.join(out_dir, LIBRARY),
                      nvcc=_release(_read(os.path.join(out_dir, "nvcc.txt"))))
    log = _read(os.path.join(out_dir, "build.log"))
    if log is not None:
        build_info["log"] = log


def library_path() -> str:  # lfkt: noqa[GRAPH001] -- the kernel library's first load: capture_step's eager warm-up step runs the captured callable first, so a capture finds the library cached (ops/_kernels.library) and never reaches this
    """The library's path: found as it is, else built."""
    out_dir = cache_dir()
    lib = os.path.join(out_dir, LIBRARY)
    if os.path.isfile(lib):
        _describe(out_dir, built=False, seconds=0.0)
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        where = knob("LFKT_COMPILE_CACHE_DIR")
        raise RuntimeError(
            f"no kernel library for digest {os.path.basename(out_dir)} in "
            f"{out_dir}, and no nvcc to build it (CUDA_HOME, CUDA_PATH, PATH): "
            f"build it where the CUDA toolkit is, with "
            f"{'LFKT_COMPILE_CACHE_DIR=' + where + ' ' if where else ''}"
            f"{BUILD_COMMAND}")
    return _build(nvcc, out_dir)


def _build(nvcc: str, out_dir: str) -> str:  # lfkt: noqa[GRAPH001] -- the kernel library's first load: capture_step's eager warm-up step runs the captured callable first, so a capture finds the library cached (ops/_kernels.library) and never reaches this
    root, key = os.path.split(out_dir)
    lib = os.path.join(out_dir, LIBRARY)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f".{key}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)       # one builder per digest and root
        if os.path.isfile(lib):              # another process built it meanwhile
            _describe(out_dir, built=False, seconds=0.0)
            return lib
        if os.path.isdir(out_dir):           # a directory without its library
            shutil.rmtree(out_dir)
        t0 = time.time()
        tmp = tempfile.mkdtemp(prefix=f".{key}.", suffix=".tmp", dir=root)
        try:
            _compile(nvcc, tmp)
            _open_to_all(tmp)
            os.rename(tmp, out_dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    seconds = time.time() - t0
    _describe(out_dir, built=True, seconds=seconds)
    record_compile("kernel_build", key, seconds)
    return lib


def _open_to_all(out_dir: str) -> None:
    """Let every user read the build: ``mkdtemp`` makes its directory 0700,
    and a pod may run as another user than the one that built the image
    (``runAsNonRoot``, a random UID)."""
    os.chmod(out_dir, 0o755)
    for name in os.listdir(out_dir):
        f = os.path.join(out_dir, name)
        os.chmod(f, os.stat(f).st_mode | 0o444)


def _compile(nvcc: str, out_dir: str) -> None:
    """Every source by its own nvcc, all at once, then the link; the
    ``ptxas -v`` report to ``build.log``, the toolkit's version to
    ``nvcc.txt``; the objects removed."""
    procs = []
    for src in sources():
        obj = os.path.join(out_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(os.path.basename(src))
    log_text = "\n".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        fh.write(log_text)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log_text}")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                           os.path.join(out_dir, LIBRARY), *(o for _, o, _ in procs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    with open(os.path.join(out_dir, "nvcc.txt"), "w") as fh:
        fh.write(version.stdout)
    for _, obj, _ in procs:
        os.remove(obj)


def main() -> int:
    t0 = time.time()
    path = library_path()
    print(json.dumps({"digest": build_info["digest"], "path": path,
                      "built": build_info["built"],
                      "seconds": round(time.time() - t0, 3),
                      "nvcc": build_info["nvcc"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's kernel library cache (utils/kernelcache.py) on the CPU.

A fake ``nvcc`` (a small script put first on ``PATH``) writes each ``-o``
target and logs its call, so the build's bookkeeping runs here:

- ``LFKT_COMPILE_CACHE_DIR`` moves the root to ``<dir>/lfkt-kernels``; with
  no knob it is the package's ``_build/``;
- the digest ignores the knob and follows every ``.cu``/``.cuh``;
- a build publishes one whole ``<digest>/`` (library, ``build.log``,
  ``nvcc.txt``), readable by every user, and leaves no temporary
  directory; a second call runs no
  ``nvcc``; two processes building at once build once and load one path;
- a library found is loaded with no write-mode ``open``, no directory made,
  no lock; no library and no ``nvcc`` raises, naming the digest, the
  directory and the build command, and writes nothing;
- the module imports no ``torch``; every serving engine loads the library
  in its constructor, before any weight.
"""

from __future__ import annotations

import builtins
import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import engine as engine_mod
from llama_fastapi_k8s_gpu_tpu_torch.obs.devtime import DEVTIME
from llama_fastapi_k8s_gpu_tpu_torch.ops import _kernels
from llama_fastapi_k8s_gpu_tpu_torch.server.app import _default_engine_factory
from llama_fastapi_k8s_gpu_tpu_torch.utils import kernelcache
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import KNOBS, Settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE = "Cuda compilation tools, release 12.9, V12.9.86"

FAKE_NVCC = f'''#!{sys.executable}
import os, sys, time
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as fh:
    fh.write(" ".join(args) + "\\n")
if "--version" in args:
    print("nvcc: NVIDIA (R) Cuda compiler driver")
    print("{RELEASE}")
    sys.exit(0)
time.sleep(float(os.environ.get("FAKE_NVCC_SLEEP", "0")))
if os.environ.get("FAKE_NVCC_FAIL") and os.environ["FAKE_NVCC_FAIL"] in " ".join(args):
    print("error: fake failure")
    sys.exit(2)
print("ptxas info    : Used 32 registers")
with open(args[args.index("-o") + 1], "wb") as fh:
    fh.write(b"\\x7fELF fake")
'''


@pytest.fixture
def toolkit(tmp_path, monkeypatch):
    """A fake nvcc first on PATH (CUDA_HOME and CUDA_PATH unset), the knob
    pointed at an empty cache; yields (cache, log path)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setenv("LFKT_COMPILE_CACHE_DIR", str(cache))
    return cache, log


def _calls(log) -> list:
    return [ln for ln in log.read_text().splitlines() if ln]


def _builds() -> int:
    return DEVTIME.counters().get("kernel_build", {}).get("compiles", 0)


def _no_nvcc(monkeypatch, tmp_path):
    empty = tmp_path / "nobin"
    empty.mkdir(exist_ok=True)
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)


def test_the_knob_is_the_reference_registrys():
    k = KNOBS["LFKT_COMPILE_CACHE_DIR"]
    assert (k.cast, k.default, k.serving) == (str, "", True)


def test_the_knob_moves_the_root(monkeypatch, tmp_path):
    monkeypatch.delenv("LFKT_COMPILE_CACHE_DIR", raising=False)
    assert kernelcache.cache_root() == os.path.join(kernelcache.PKG, "_build")
    monkeypatch.setenv("LFKT_COMPILE_CACHE_DIR", str(tmp_path))
    assert kernelcache.cache_root() == os.path.join(str(tmp_path), "lfkt-kernels")
    assert kernelcache.cache_dir() == os.path.join(str(tmp_path), "lfkt-kernels",
                                                   kernelcache.digest())


def test_the_digest_ignores_the_knob_and_follows_a_header(monkeypatch, tmp_path):
    monkeypatch.delenv("LFKT_COMPILE_CACHE_DIR", raising=False)
    plain = kernelcache.digest()
    monkeypatch.setenv("LFKT_COMPILE_CACHE_DIR", str(tmp_path))
    assert kernelcache.digest() == plain
    csrc = tmp_path / "csrc"
    shutil.copytree(kernelcache.CSRC, csrc)
    monkeypatch.setattr(kernelcache, "CSRC", str(csrc))
    assert kernelcache.digest() == plain
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    assert kernelcache.digest() != plain


def test_a_build_publishes_one_whole_directory(toolkit):
    cache, log = toolkit
    before = _builds()
    path = kernelcache.library_path()
    key = kernelcache.digest()
    root = cache / "lfkt-kernels"
    assert path == str(root / key / kernelcache.LIBRARY)
    assert sorted(os.listdir(root)) == sorted([key, f".{key}.lock"])
    assert sorted(os.listdir(root / key)) == sorted([kernelcache.LIBRARY, "build.log",
                                                     "nvcc.txt"])
    n = len(kernelcache.sources())
    calls = _calls(log)
    assert sum(" -c " in c for c in calls) == n and sum("-shared" in c for c in calls) == 1
    assert calls[-1] == "--version"
    info = kernelcache.build_info
    assert info["built"] is True and info["digest"] == key and info["path"] == path
    assert info["nvcc"] == RELEASE and info["log"].count("Used 32 registers") == n
    assert _builds() - before == 1


def test_a_build_is_readable_by_every_user(toolkit):
    """The published directory and its files are open to group and others
    whatever the builder's umask (a pod may run as another user than the
    image's build stage); read from the mode bits, since root ignores them."""
    cache, _ = toolkit
    old = os.umask(0o077)
    try:
        path = kernelcache.library_path()
    finally:
        os.umask(old)
    out_dir = os.path.dirname(path)
    assert os.stat(out_dir).st_mode & 0o777 == 0o755
    for name in os.listdir(out_dir):
        assert os.stat(os.path.join(out_dir, name)).st_mode & 0o044 == 0o044, name


def test_a_second_call_runs_no_nvcc(toolkit):
    cache, log = toolkit
    first = kernelcache.library_path()
    log.write_text("")
    before = _builds()
    assert kernelcache.library_path() == first
    assert _calls(log) == []
    info = kernelcache.build_info
    assert (info["built"], info["seconds"], info["nvcc"]) == (False, 0.0, RELEASE)
    assert "registers" in info["log"] and _builds() == before


def test_two_processes_building_at_once_build_once(toolkit):
    cache, log = toolkit
    env = dict(os.environ, FAKE_NVCC_SLEEP="1.0",
               PYTHONPATH=os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH")))))
    cmd = [sys.executable, "-m", "llama_fastapi_k8s_gpu_tpu_torch.utils.kernelcache"]
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    docs = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert {d["path"] for d in docs} == {kernelcache.library_path()}
    assert sorted(d["built"] for d in docs) == [False, True]
    assert {d["digest"] for d in docs} == {kernelcache.digest()}
    assert {d["nvcc"] for d in docs} == {RELEASE}
    assert sum(" -c " in c for c in _calls(log)) == len(kernelcache.sources())
    root = cache / "lfkt-kernels"
    assert not [n for n in os.listdir(root) if n.endswith(".tmp")]


def test_a_found_library_loads_without_writing(toolkit, monkeypatch):
    kernelcache.library_path()
    writes = []
    real_open = builtins.open

    def spy_open(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+"):
            writes.append(("open", file, mode))
        return real_open(file, mode, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy_open)
    for name in ("makedirs", "mkdir", "rename", "replace", "remove"):
        monkeypatch.setattr(os, name, lambda *a, _n=name, **kw: writes.append((_n, a)))
    monkeypatch.setattr(tempfile, "mkdtemp", lambda *a, **kw: writes.append(("mkdtemp",)))
    monkeypatch.setattr(kernelcache.fcntl, "flock", lambda *a: writes.append(("flock",)))

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.lfkt_error_string = type("F", (), {})()

        def __getattr__(self, name):
            fn = type("F", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_kernels.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_kernels, "_lib", None)
    lib = _kernels.library()
    assert lib.path == kernelcache.cache_dir() + "/" + kernelcache.LIBRARY
    assert set(_kernels.SIGNATURES) <= set(vars(lib))
    assert writes == []
    assert kernelcache.build_info["built"] is False


def test_no_library_and_no_nvcc_raises_and_writes_nothing(toolkit, monkeypatch, tmp_path):
    cache, _ = toolkit
    _no_nvcc(monkeypatch, tmp_path)
    assert kernelcache.find_nvcc() is None
    key, where = kernelcache.digest(), kernelcache.cache_dir()
    with pytest.raises(RuntimeError) as e:
        kernelcache.library_path()
    msg = str(e.value)
    assert key in msg and where in msg
    assert f"LFKT_COMPILE_CACHE_DIR={cache} {kernelcache.BUILD_COMMAND}" in msg
    monkeypatch.setattr(_kernels, "_lib", None)
    with pytest.raises(RuntimeError, match=key):
        _kernels.library()
    assert os.listdir(cache) == []


def test_nvcc_under_cuda_home_comes_first(toolkit, monkeypatch, tmp_path):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    shutil.copy(shutil.which("nvcc"), home / "bin" / "nvcc")
    monkeypatch.setenv("CUDA_HOME", str(home))
    assert kernelcache.find_nvcc() == str(home / "bin" / "nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "missing"))
    assert kernelcache.find_nvcc() == shutil.which("nvcc")


def test_a_failed_build_raises_and_publishes_nothing(toolkit, monkeypatch):
    cache, _ = toolkit
    monkeypatch.setenv("FAKE_NVCC_FAIL", "flash_attention.cu")
    with pytest.raises(RuntimeError, match=r"nvcc failed for \['flash_attention.cu'\]"):
        kernelcache.library_path()
    assert os.listdir(cache / "lfkt-kernels") == [f".{kernelcache.digest()}.lock"]


def test_a_directory_without_its_library_is_rebuilt(toolkit):
    cache, log = toolkit
    stale = cache / "lfkt-kernels" / kernelcache.digest()
    stale.mkdir(parents=True)
    (stale / "q4k_matmul.o").write_bytes(b"old")
    path = kernelcache.library_path()
    assert os.path.isfile(path) and not (stale / "q4k_matmul.o").exists()
    assert kernelcache.build_info["built"] is True


def test_the_module_imports_no_torch_and_its_entry_prints_one_line(toolkit):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (REPO, os.environ.get("PYTHONPATH")))))
    probe = subprocess.run(
        [sys.executable, "-c", "import sys; import llama_fastapi_k8s_gpu_tpu_torch.utils."
         "kernelcache; print('torch' in sys.modules, 'numpy' in sys.modules)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert probe.stdout.split() == ["False", "False"], probe.stderr
    run = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "llama_fastapi_k8s_gpu_tpu_torch.utils.kernelcache"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert set(doc) == {"digest", "path", "built", "seconds", "nvcc"}
    assert (doc["digest"], doc["built"], doc["nvcc"]) == (kernelcache.digest(), True, RELEASE)
    imported = {ln.split("|")[-1].strip() for ln in run.stderr.splitlines()
                if ln.startswith("import time:")}
    assert "llama_fastapi_k8s_gpu_tpu_torch.utils.config" in imported
    assert not {m for m in imported if m.split(".")[0] == "torch"}


class _Loaded(Exception):
    """The kernel library was asked for."""


@pytest.mark.parametrize("shape", [
    dict(), dict(batch_size=2), dict(batch_size=2, scheduler="cycle"),
    dict(mesh_sp=2), dict(models="a=tiny.gguf", kv_paged=True),
    dict(disagg_role="prefill", kv_paged=True)])
def test_every_serving_engine_loads_the_library_before_its_weights(shape, tmp_path,
                                                                   monkeypatch):
    """Serial, lanes (both schedulers), sequence-parallel, the registry and
    the disagg prefill tier all build through ``Engine.__init__``: on the
    card it asks for the library before it opens the GGUF."""
    write_tiny_llama_gguf(str(tmp_path / "tiny.gguf"))
    opened = []

    def ask():
        raise _Loaded(list(opened))

    monkeypatch.setattr(engine_mod, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(engine_mod, "library", ask)
    monkeypatch.setattr(engine_mod, "GGUFFile", lambda p: opened.append(p))
    settings = Settings(model_dir=str(tmp_path), model_name="tiny.gguf", **shape)
    with pytest.raises(_Loaded) as e:
        _default_engine_factory(settings)()
    assert e.value.args == ([],)

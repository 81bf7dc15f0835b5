"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the GPU unless told otherwise."""

from __future__ import annotations

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import llama_fastapi_k8s_gpu_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "jaxlib", "llama_fastapi_k8s_gpu_tpu")


def _port_modules() -> list[str]:
    return [m.name for m in pkgutil.walk_packages([PORT_DIR], port.__name__ + ".")]


def _port_sources() -> list[str]:
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_jax_or_the_jax_package():
    found = []
    for path in _port_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not found


def test_entry_points_without_a_device_need_cuda(tmp_path, monkeypatch):
    from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
    from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
    from llama_fastapi_k8s_gpu_tpu_torch.models.params import load_params
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import _default_engine_factory
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings
    from llama_fastapi_k8s_gpu_tpu_torch.utils.device import resolve_device

    from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType
    from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama_gguf(path, quant=GGMLType.F16)
    for call in (lambda: Engine(path),
                 lambda: load_params(GGUFFile(path), ModelConfig.from_gguf(GGUFFile(path))),
                 _default_engine_factory(Settings(model_dir=str(tmp_path),
                                                  model_name="tiny.gguf")),
                 resolve_device):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_the_card_or_the_checkout(tmp_path):
    """Without CUDA, and alone in a directory without the repository, the
    script exits non-zero and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and '"ok": true' not in r.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout

"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the GPU unless told otherwise."""

from __future__ import annotations

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys
import tempfile

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


def test_the_lint_imports_no_torch_no_jax():
    """The port's lint is stdlib only: no module under ``lint/`` imports
    torch, JAX or the JAX package, and running it loads none of them."""
    lint_dir = os.path.join(PORT_DIR, "lint")
    found = []
    for name in sorted(os.listdir(lint_dir)):
        if not name.endswith(".py"):
            continue
        path = os.path.join(lint_dir, name)
        for node in ast.walk(ast.parse(open(path, encoding="utf-8").read(), path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(name, n) for n in names if n.split(".")[0] in FORBIDDEN + ("torch",)]
    assert not found
    code = ("import sys\n"
            "from llama_fastapi_k8s_gpu_tpu_torch.lint.__main__ import main\n"
            "main(['--rule', 'KER001', '--json'])\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('torch',)!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


TOOLS = ("incident_report", "fleet_trace", "lint_report", "ci_gate", "fault_drill",
         "chaos_drill")
#: the operator tools an operator runs beside a wedged engine: no torch
STDLIB_TOOLS = TOOLS[:4]


def test_the_scan_walks_the_operator_tools():
    sources = {os.path.relpath(p, PORT_DIR) for p in _port_sources()}
    assert {os.path.join("tools", f"{t}.py") for t in TOOLS} <= sources
    assert {f"{port.__name__}.tools.{t}" for t in TOOLS} <= set(_port_modules())


_HELP = r"""
import json, runpy, sys
sys.argv = [{name!r}, "--help"]
try:
    runpy.run_module("llama_fastapi_k8s_gpu_tpu_torch.tools." + {name!r}, run_name="__main__")
except SystemExit as e:
    code = e.code
print(json.dumps({{"code": code, "loaded": sorted(m for m in ("torch", "jax", "jaxlib",
                 "llama_fastapi_k8s_gpu_tpu") if m in sys.modules)}}))
"""


@pytest.mark.parametrize("name", TOOLS)
def test_tool_help_loads_no_jax_and_the_stdlib_tools_no_torch(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _HELP.format(name=name)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"usage: {name}" in r.stdout
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["code"] == 0
    assert not {"jax", "jaxlib", "llama_fastapi_k8s_gpu_tpu"} & set(doc["loaded"])
    if name in STDLIB_TOOLS:
        assert doc["loaded"] == []


@pytest.mark.parametrize("name", ["fault_drill", "chaos_drill"])
def test_model_loading_drills_need_cuda_without_device_cpu(name, monkeypatch, tmp_path):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    drill = importlib.import_module(f"{port.__name__}.tools.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drill.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drill.main(["--device", "cuda"])

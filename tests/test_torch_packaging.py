"""Packaging of the port: the GPU image (docker/Dockerfile.gpu) and the GPU
chart (helm-gpu/), held to the port's registry as tests/test_packaging.py
holds the TPU image and chart (helm/) to the JAX package's.

- the image has two stages: the build stage runs the kernel cache's entry
  into ``/opt/lfkt/kernels`` with no torch; the runtime stage has no devel
  base and no nvcc, sets ``LFKT_COMPILE_CACHE_DIR`` to that directory, runs
  the port's server and exposes 8000; nothing names jax;
- its requirements hold none of the JAX package's serving dependencies;
- the chart: every ``.Values`` reference exists, every ``LFKT_*`` name is a
  knob of the port and every serving knob is named; GPU scheduling on the
  replica and the prefill tier, none on the router; no TPU scheduling;
  three ``/health`` probes; the reference's defaults; no volume over the
  baked library.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

import yaml

from llama_fastapi_k8s_gpu_tpu_torch.utils.config import KNOBS, Settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHART = os.path.join(REPO, "helm-gpu")
BUILD_CMD = ("LFKT_COMPILE_CACHE_DIR=/opt/lfkt/kernels python3 -m "
             "llama_fastapi_k8s_gpu_tpu_torch.utils.kernelcache")


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts)) as fh:
        return fh.read()


def _code(text: str) -> list[str]:
    """The non-comment, non-blank lines."""
    return [ln for ln in text.splitlines()
            if ln.strip() and not ln.strip().startswith("#")]


def _stages() -> list[list[str]]:
    """The Dockerfile's stages, each its code lines from its ``FROM`` on."""
    stages: list[list[str]] = []
    for ln in _code(_read("docker", "Dockerfile.gpu")):
        if ln.startswith("FROM "):
            stages.append([])
        stages[-1].append(ln)
    return stages


def _port_knobs() -> set[str]:
    return set(KNOBS) | {f"LFKT_{f.name.upper()}" for f in dataclasses.fields(Settings)}


def _templates() -> dict[str, str]:
    return {os.path.basename(p): open(p).read()
            for p in sorted(glob.glob(os.path.join(CHART, "templates", "*.yaml")))}


def _values() -> dict:
    with open(os.path.join(CHART, "values.yaml")) as fh:
        return yaml.safe_load(fh)


def test_image_build_stage_bakes_the_kernels_without_torch():
    stages = _stages()
    assert len(stages) == 2
    build = stages[0]
    assert re.match(r"FROM nvidia/cuda:[0-9.]+-devel-ubuntu24\.04 AS kernels$", build[0])
    assert f"RUN {BUILD_CMD}" in build
    assert not [ln for ln in build if "torch" in ln.replace(
        "llama_fastapi_k8s_gpu_tpu_torch", "") or "pip" in ln]
    assert any(ln.startswith("COPY llama_fastapi_k8s_gpu_tpu_torch ") for ln in build)
    assert not [ln for ln in build if re.match(r"COPY (?!llama_fastapi_k8s_gpu_tpu_torch )", ln)]


def test_image_runtime_stage_has_no_toolkit_and_runs_the_port():
    runtime = _stages()[1]
    text = "\n".join(runtime)
    assert "devel" not in text and "nvcc" not in text
    assert "COPY --from=kernels /opt/lfkt/kernels /opt/lfkt/kernels" in runtime
    assert "ENV LFKT_COMPILE_CACHE_DIR=/opt/lfkt/kernels" in runtime
    assert any(ln.startswith("COPY llama_fastapi_k8s_gpu_tpu_torch ") for ln in runtime)
    assert "EXPOSE 8000" in runtime
    assert runtime[-1] == 'CMD ["python3", "-m", "llama_fastapi_k8s_gpu_tpu_torch.server"]'
    assert "docker/requirements-gpu.txt" in text
    code = "\n".join(_code(_read("docker", "Dockerfile.gpu"))).lower()
    assert "jax" not in code


def test_gpu_requirements_hold_no_jax_serving_dependencies():
    names = {re.split(r"[=<>\[ ]", ln.strip())[0].lower()
             for ln in _code(_read("docker", "requirements-gpu.txt"))
             if not ln.startswith("-")}
    assert names == {"torch", "numpy"}
    assert not names & {"jax", "jaxlib", "pydantic", "uvicorn", "regex", "httpx"}


def test_chart_values_references_exist():
    values = _values()
    missing = []
    for name, text in _templates().items():
        for ref in set(re.findall(r"\.Values\.([A-Za-z0-9_.]+)", text)):
            node = values
            for part in ref.split("."):
                if not isinstance(node, dict) or part not in node:
                    missing.append((name, ref))
                    break
                node = node[part]
    assert not missing


def test_chart_names_only_port_knobs_and_every_serving_knob():
    text = "".join(open(p).read() for p in glob.glob(
        os.path.join(CHART, "**", "*.yaml"), recursive=True))
    names = set(re.findall(r"LFKT_[A-Z0-9_]+", text))
    assert names and not names - _port_knobs(), names - _port_knobs()
    serving = {k.name for k in KNOBS.values() if k.serving}
    # the kernel cache is the image's to set (docker/Dockerfile.gpu's ENV,
    # where its build stage baked the library); the chart leaves it alone
    assert "LFKT_COMPILE_CACHE_DIR" in serving
    assert serving - {"LFKT_COMPILE_CACHE_DIR"} <= names
    assert "name: LFKT_COMPILE_CACHE_DIR" not in "".join(_templates().values())


def test_chart_schedules_gpus_on_the_replicas_only():
    text = "".join(open(p).read() for p in glob.glob(
        os.path.join(CHART, "**", "*"), recursive=True) if os.path.isfile(p))
    assert "google.com/tpu" not in text and "gke-tpu" not in text
    t = _templates()
    for name in ("deployment.yaml", "deployment-prefill.yaml"):
        res = t[name][t[name].index("resources:"):]
        assert res.count("nvidia.com/gpu: {{ .Values.gpu.count }}") == 2, name
        assert "nvidia.com/gpu.product: {{ .Values.gpu.product | quote }}" in t[name]
        assert re.search(r"- key: nvidia\.com/gpu\n\s+operator: Exists\n\s+effect: NoSchedule",
                         t[name]), name
    assert "nvidia.com/gpu" not in t["deployment-router.yaml"]
    assert "value: router" in t["deployment-router.yaml"]
    v = _values()
    assert v["gpu"] == {"product": "NVIDIA-H100-80GB-HBM3", "count": 1}


def test_chart_mounts_nothing_over_the_baked_library():
    t = _templates()
    for name in ("deployment.yaml", "deployment-prefill.yaml"):
        mounts = re.findall(r"mountPath: (\S+)", t[name])
        baked = "/opt/lfkt/kernels/"
        assert not [m for m in mounts if baked.startswith(m.rstrip("/") + "/")
                    or m.startswith(baked)], mounts
        assert "compileCache" not in t[name]
    assert "compileCache" not in _values() and "kernels" not in _values()


def test_chart_keeps_the_probes_and_the_reference_defaults():
    t = _templates()
    dep = t["deployment.yaml"]
    for probe in ("startupProbe", "readinessProbe", "livenessProbe"):
        assert probe in dep and probe in t["deployment-prefill.yaml"]
    assert dep.count("path: /health") == 3
    assert t["deployment-prefill.yaml"].count("path: /health") == 3
    assert "init-s3-copy" in dep and "init-s3-copy" in t["deployment-prefill.yaml"]
    v = _values()
    assert (v["app"]["maxContextTokens"], v["app"]["timeoutSeconds"],
            v["app"]["maxQueueSize"], v["replicaCount"]) == (1024, 25, 5, 4)
    assert isinstance(v["probes"]["startupFailureThreshold"], int)
    assert v["probes"]["startupPeriodSeconds"] == 10
    assert {"hpa.yaml", "ingress.yaml", "service.yaml", "service-router.yaml",
            "service-prefill.yaml", "deployment-router.yaml"} <= set(t)
    assert "extraEnv" in v["app"]

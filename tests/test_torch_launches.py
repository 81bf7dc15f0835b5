"""The port's launch audit of one decode step against the JAX package's.

The reference's pins (tests/test_perf_pins.py) on its own config — 8
layers of width 64 — hold for the port's audit (obs/launches.py): 9
launches a layer in the loop (7 linears, the decode attention's 2
products), 1 outside (the head), and ≤ ⌈8/K⌉ launches of the looped
kernel a token.  Beyond the pins, the counts equal the reference's jaxpr
audit case by case, but for two differences by design: the port's int8
KV write is a kernel launch a layer where the reference's per-layer step
writes the ring in XLA, and a stack that runs as one looped launch is
still the port's layer loop (one trip), where the reference's trace has
no scan left.
"""

from __future__ import annotations

import math

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.models.params import synth_params as j_synth_params
from llama_fastapi_k8s_gpu_tpu.obs.launches import decode_step_launches as j_launches
from llama_fastapi_k8s_gpu_tpu_torch.models import llama
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.params import load_params, synth_params
from llama_fastapi_k8s_gpu_tpu_torch.obs.launches import count_launches, decode_step_launches
from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS, decode_loop, linear

torch.set_num_threads(1)

#: the reference pins' config (tests/test_perf_pins.py::_launch_audit)
PIN_CFG = dict(vocab_size=64, dim=64, n_layers=8, n_heads=4, n_kv_heads=2,
               ffn_dim=96, n_ctx=32)


def _audit(unroll: int, kv_dtype: str = "bf16") -> dict:
    cfg = ModelConfig(**PIN_CFG, kv_dtype=kv_dtype, decode_layer_unroll=unroll)
    return decode_step_launches(synth_params(cfg, device="cpu"), cfg)


def _ref_audit(unroll: int, kv_dtype: str = "bf16") -> dict:
    cfg = JModelConfig(**PIN_CFG, kv_dtype=kv_dtype, decode_layer_unroll=unroll)
    return j_launches(j_synth_params(cfg), cfg)


def test_per_layer_decode_step_launch_pin():
    audit = _audit(0)
    assert audit["loop_trips"] == [8]
    assert audit["in_loop"] == 8 * 9
    assert audit["outside"] == 1          # the output head
    assert audit["while_loops"] == 0
    assert audit["by_prim"] == {"mm": 8 * 7, "bmm": 8 * 2, "mm(flat)": 1}


def test_looped_decode_step_launch_pin():
    base = _audit(0)
    for K in (4, 8, -1):
        audit = _audit(K)
        eff = 8 if K == -1 else K
        in_step = audit["total"] - base["outside"]
        assert in_step <= math.ceil(8 / eff), (K, audit)
        assert audit["total"] * 3 <= base["total"], (K, audit, base)
    a4 = _audit(4)
    assert a4["by_prim"].get("decode_loop") == 2
    assert not {"mm", "bmm"} & set(a4["by_prim"])     # no product left in the loop


def test_looped_launch_pin_int8_kv():
    audit = _audit(4, kv_dtype="int8")
    assert audit["total"] - 1 <= 2, audit


@pytest.mark.parametrize("unroll,kv_dtype", [(0, "bf16"), (0, "int8"), (4, "bf16"),
                                             (4, "int8"), (2, "bf16"), (8, "bf16"),
                                             (-1, "int8")])
def test_audit_counts_equal_the_references(unroll, kv_dtype):
    """total, in-loop, outside and trip counts equal the reference's jaxpr
    audit, but for the two differences by design of the module docstring;
    the products equal its ``dot_general`` count, the looped launches its
    ``pallas_call`` count."""
    got, ref = _audit(unroll, kv_dtype), _ref_audit(unroll, kv_dtype)
    keys = ("total", "in_loop", "outside", "loop_trips", "while_loops")
    want = {k: ref[k] for k in keys}
    if unroll == 0 and kv_dtype == "int8":
        # the port's int8 KV write: one kernel launch a layer
        assert got["by_prim"]["kv_quantize"] == 8
        want["total"] += 8
        want["in_loop"] += 8
    if ref["loop_trips"] == []:
        # one looped launch for the whole stack: no scan in the reference
        assert got["by_prim"].get("decode_loop") == ref["by_prim"]["pallas_call(flat)"] == 1
        want.update(in_loop=1, outside=ref["outside"] - 1, loop_trips=[1])
    assert {k: got[k] for k in keys} == want
    products = sum(v for k, v in got["by_prim"].items() if k.split("(")[0] in ("mm", "bmm"))
    assert products == sum(v for k, v in ref["by_prim"].items() if k.startswith("dot_general"))
    assert got["by_prim"].get("decode_loop", 0) == sum(
        v for k, v in ref["by_prim"].items() if k.startswith("pallas_call"))


def test_a_wrapper_counts_once_whichever_version_runs(tmp_path):
    """A fused linear is one launch though its plain version (the CPU's)
    runs a dequant and a product: the audit reads what the card runs."""
    from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
    from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile

    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama_gguf(path)                  # Q8_0 linears
    cfg = ModelConfig.from_gguf(GGUFFile(path), n_ctx=64)
    params = load_params(GGUFFile(path), cfg, "q4k", torch.device("cpu"))
    audit = decode_step_launches(params, cfg)
    L = cfg.n_layers
    assert audit["by_prim"] == {"q8_matmul": 7 * L, "bmm": 2 * L,
                                **({"q8_matmul(flat)": 1}
                                   if params.output.kind == "q8" else {"mm(flat)": 1})}
    assert audit["loop_trips"] == [L]


def test_the_audit_leaves_no_hook_and_no_count_behind():
    """The call sites and the kernel counters are as before the audit, and
    a call outside an audit counts nothing."""
    fused = dict(linear._FUSED)
    sites = (llama._layer, llama.kv_quantize, llama.flash_attention,
             decode_loop.decode_loop_step, decode_loop.forward_layers_looped)
    counts = {n: fn.launches for n, fn in KERNELS.items()}
    _audit(0, "int8")
    _audit(4)
    assert linear._FUSED == fused
    assert (llama._layer, llama.kv_quantize, llama.flash_attention,
            decode_loop.decode_loop_step, decode_loop.forward_layers_looped) == sites
    assert {n: fn.launches for n, fn in KERNELS.items()} == counts
    assert count_launches(lambda: torch.ones(2, 2) @ torch.ones(2, 2))["by_prim"] == \
        {"mm(flat)": 1}

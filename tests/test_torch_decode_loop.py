"""The port's layer-looped decode against its per-layer path and the JAX
reference's looped path.

- ``effective_unroll`` clamps as the reference's does;
- ``decode_loop_plan`` refuses each fused layout and names the linear;
- on the CPU the looped forward (the wrapper's plain version) is
  **bit-identical** to the per-layer forward, logits and every cache leaf,
  on the reference's eight combinations (bf16/int8 weights × bf16/int8 KV
  × sliding window × K, tests/test_decode_loop.py) — the reference's own
  gate;
- the kernel's attention decomposition (``split_attention_plain``: key
  chunks aligned to multiples of C, each chunk's (max, sum) gathered into
  the head's softmax max and sum, the normalised probabilities rounded to
  bf16, the chunks' P·V summed once a query head) agrees with the JAX
  package's ``xla_attention`` on both rings, GQA groups 1, 2 and 4, at
  slots 0, C − 1, C, C + 1 and n_ctx − 1 and under a sliding window whose
  edge falls inside a chunk, within 10⁻³ rel-dev (see the test);
- the looped forward agrees with the JAX forward under the same
  ``decode_layer_unroll`` (its Pallas kernel in interpret mode), teacher
  forced on the reference's tokens, within logits rel-dev 2e-2 over bf16
  weights and 4e-2 over int8 ones.  On this model (4 layers of random
  N(0, 1/dim) weights, a 64-token vocabulary) the port's per-layer path
  already sits 0.8–1.7% (bf16) and 2.2–3.0% (int8) from the reference's
  per-layer path — bf16 rounded at the same steps, sums in another order —
  and looping changes neither side.  Int8 is farther because the int8
  linear quantizes its activations per row: a one-bf16-step difference in
  an activation can move its int8 code a whole quantization step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.models.llama import decode_step as j_decode_step
from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
from llama_fastapi_k8s_gpu_tpu.models.llama import xla_attention as j_xla_attention
from llama_fastapi_k8s_gpu_tpu.models.llama import prefill as j_prefill
from llama_fastapi_k8s_gpu_tpu.models.params import synth_params
from llama_fastapi_k8s_gpu_tpu.ops.pallas.decode_loop import (
    effective_unroll as j_effective_unroll,
)
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward, init_cache
from llama_fastapi_k8s_gpu_tpu_torch.models.params import (
    LOOP_LINEARS,
    decode_loop_plan,
    from_jax_params,
)
from llama_fastapi_k8s_gpu_tpu_torch.ops import decode_loop
from llama_fastapi_k8s_gpu_tpu_torch.ops.kvquant import quantize_kv_plain
from llama_fastapi_k8s_gpu_tpu_torch.ops.linear import Linear

torch.set_num_threads(1)
CPU = torch.device("cpu")
#: the reference's looped-decode test model (tests/test_decode_loop.py)
SHAPE = dict(vocab_size=64, dim=64, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=96,
             n_ctx=64)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _models(fmt: str, kv_dtype: str = "bf16", window: int = 0):
    """The reference's ``synth_params`` and the port's params built from
    them, with their configs."""
    jcfg = JModelConfig(**SHAPE, kv_dtype=kv_dtype, sliding_window=window)
    jparams = synth_params(jcfg, fmt=fmt)
    cfg = ModelConfig(**SHAPE, kv_dtype=kv_dtype, sliding_window=window)
    return jcfg, jparams, cfg, from_jax_params(_numpy_tree(jparams), cfg, device="cpu")


def _greedy_trace(params, cfg, steps: int = 4):
    """Prefill 8 tokens, then ``steps`` greedy decode steps: (logits per
    step, final cache)."""
    cache = init_cache(cfg, CPU)
    outs = []
    with torch.inference_mode():
        logits = forward(params, cfg, torch.arange(8), 0, cache)
        for step in range(steps):
            tok = int(logits.argmax()) % cfg.vocab_size
            logits = forward(params, cfg, torch.tensor([tok]), 8 + step, cache)
            outs.append(logits)
    return outs, cache


@pytest.mark.parametrize("L", [1, 4, 32])
def test_effective_unroll_matches_reference(L):
    cfg = ModelConfig(**{**SHAPE, "n_layers": L})
    jcfg = JModelConfig(**{**SHAPE, "n_layers": L})
    for K in (-2, -1, 0, 1, 2, 3, 5, 32, 40):
        c, jc = (dataclasses.replace(x, decode_layer_unroll=K) for x in (cfg, jcfg))
        if K < -1:
            for fn, arg in ((decode_loop.effective_unroll, c), (j_effective_unroll, jc)):
                with pytest.raises(ValueError, match="decode_layer_unroll"):
                    fn(arg)
        else:
            assert decode_loop.effective_unroll(c) == j_effective_unroll(jc), (L, K)


@pytest.mark.parametrize("kind", ["q4k", "q5k", "q6k", "q8"])
def test_plan_refuses_each_fused_kind_and_names_the_linear(kind):
    _, _, cfg, params = _models("bf16")
    assert decode_loop_plan(params, cfg) == (dict.fromkeys(LOOP_LINEARS, "bf16"), None)
    for layer in params.layers:
        layer.w_up = Linear(kind, torch.zeros(cfg.ffn_dim, 8, dtype=torch.uint8),
                            cfg.ffn_dim, cfg.dim)
    fmts, reason = decode_loop_plan(params, cfg)
    assert fmts is None
    assert "'w_up'" in reason and "fused" in reason and kind in reason


def test_plan_accepts_int8_and_refuses_a_mix():
    _, _, cfg, params = _models("int8")
    assert decode_loop_plan(params, cfg) == (dict.fromkeys(LOOP_LINEARS, "int8"), None)
    _, _, _, bf16 = _models("bf16")
    params.layers[1].wo = bf16.layers[1].wo
    fmts, reason = decode_loop_plan(params, cfg)
    assert fmts is None and "'wo'" in reason


@pytest.mark.parametrize("fmt,kv_dtype,window,unroll", [
    ("bf16", "bf16", 0, 2),
    ("bf16", "bf16", 0, -1),
    ("bf16", "int8", 0, 2),
    ("bf16", "int8", 0, -1),
    ("int8", "bf16", 0, 2),
    ("int8", "int8", 0, -1),
    ("bf16", "bf16", 16, 2),      # sliding-window (Mistral) masking
    ("bf16", "bf16", 0, 3),       # a non-divisor K clamps to 2
])
def test_looped_forward_bit_identical_to_per_layer(fmt, kv_dtype, window, unroll):
    _, _, cfg, params = _models(fmt, kv_dtype, window)
    before = decode_loop.decode_loop_step.launches
    ref_logits, ref_cache = _greedy_trace(params, cfg)
    got_logits, got_cache = _greedy_trace(
        params, dataclasses.replace(cfg, decode_layer_unroll=unroll))
    for step, (a, b) in enumerate(zip(ref_logits, got_logits)):
        assert torch.equal(a, b), f"logits diverged at step {step}"
    assert set(got_cache) == set(ref_cache)
    for name in ref_cache:
        assert torch.equal(got_cache[name], ref_cache[name]), f"cache leaf {name} diverged"
    # the CPU runs the plain version: no kernel launch is counted
    assert decode_loop.decode_loop_step.launches == before


@pytest.mark.parametrize("fmt,kv_dtype,window,unroll", [
    ("bf16", "bf16", 0, 2),
    ("int8", "int8", 0, -1),
    ("int8", "bf16", 16, 2),
    ("bf16", "int8", 0, -1),
])
def test_looped_forward_matches_reference_looped(fmt, kv_dtype, window, unroll):
    """Teacher forced: both sides decode the reference's greedy tokens with
    the loop armed; the reference's looped kernel runs in interpret mode."""
    jcfg, jparams, cfg, params = _models(fmt, kv_dtype, window)
    jcfg = dataclasses.replace(jcfg, decode_layer_unroll=unroll)
    cfg = dataclasses.replace(cfg, decode_layer_unroll=unroll)
    jcache = j_init_cache(jcfg)
    jl, jcache = j_prefill(jparams, jcfg, jnp.arange(8, dtype=jnp.int32), jnp.int32(8),
                           jcache)
    cache = init_cache(cfg, CPU)
    tol = 2e-2 if fmt == "bf16" else 4e-2
    with torch.inference_mode():
        forward(params, cfg, torch.arange(8), 0, cache)
        for step in range(4):
            tok = int(np.asarray(jl).argmax())
            jl, jcache = j_decode_step(jparams, jcfg, jnp.int32(tok), jnp.int32(8 + step),
                                       jcache)
            got = forward(params, cfg, torch.tensor([tok]), 8 + step, cache).numpy()
            ref = np.asarray(jl)
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= tol, (step, rel)


#: the decomposition's chunk and ring in the split-attention test
CHUNK, N_CTX = 16, 64


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("pos,window", [
    (0, 0), (CHUNK - 1, 0), (CHUNK, 0), (CHUNK + 1, 0), (N_CTX - 1, 0),
    (40, 20),                     # keys 21..40: the window's edge inside chunk 16..31
])
def test_split_attention_matches_reference(kv_dtype, group, pos, window):
    """The kernel's attention decomposition against the reference's
    score-matrix attention on the same ring (slot ``pos`` written).  Both
    round the normalised probabilities (times the V scale over the int8
    ring) to bf16 and the context once; the decomposition only sums in
    another order (per chunk, then over chunks; its softmax sum from the
    chunks' (m, l)), which can move an output by one bf16 step: ~2·10⁻⁴
    rel-dev an element that moves, at 512 outputs.  So 10⁻³, tighter than
    the flash kernel's 4·10⁻³ gate; here the two agree bit for bit in every
    case.  Probabilities rounded from each chunk's own max instead (the
    flash kernel's rounding point) measured 2.6–3.6·10⁻³ on these inputs,
    and a chunk counted twice or dropped 10⁻¹ or more."""
    n_heads, hd = 8, 64
    shape = dict(vocab_size=64, dim=n_heads * hd, n_layers=1, n_heads=n_heads,
                 n_kv_heads=n_heads // group, ffn_dim=64, n_ctx=N_CTX, sliding_window=window,
                 kv_dtype=kv_dtype)
    cfg, jcfg = ModelConfig(**shape), JModelConfig(**shape)
    rng = np.random.default_rng(1000 * group + pos)
    q = torch.from_numpy(rng.standard_normal((1, n_heads, hd), dtype=np.float32)).bfloat16()
    kk, vv = (torch.from_numpy(rng.standard_normal((n_heads // group, N_CTX, hd),
                                                   dtype=np.float32) * scale).bfloat16()
              for scale in (2.0, 1.0))

    def jx(t, dtype=jnp.bfloat16):
        return jnp.asarray(t.float().numpy(), dtype)

    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = quantize_kv_plain(kk), quantize_kv_plain(vv)
        got = decode_loop.split_attention_plain(q, kq, vq, pos, cfg, CHUNK, ks, vs)
        ref = j_xla_attention(jx(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
                              jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()),
                              jnp.array([pos]), jcfg, jnp.bfloat16)
    else:
        got = decode_loop.split_attention_plain(q, kk, vv, pos, cfg, CHUNK)
        ref = j_xla_attention(jx(q), jx(kk), jx(vv), None, None, jnp.array([pos]), jcfg,
                              jnp.bfloat16)
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(1, -1)
    assert got.dtype == torch.bfloat16 and got.shape == (1, n_heads * hd)
    rel = np.linalg.norm(got.float().numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 1e-3, rel


def test_decode_loop_step_checks_its_arguments():
    _, _, cfg, params = _models("bf16")
    fmts = dict.fromkeys(LOOP_LINEARS, "bf16")
    cache = init_cache(cfg, CPU)
    h = torch.zeros(1, cfg.dim, dtype=torch.bfloat16)
    at = torch.zeros(1, dtype=torch.int64)
    for layer0, K, pos, hh in ((3, 2, at, h), (0, 0, at, h), (0, 4, at.reshape(()), h),
                               (0, 4, at.int(), h), (0, 4, at, h.reshape(-1))):
        with pytest.raises(ValueError, match="decode_loop"):
            decode_loop.decode_loop_step(params, cache, hh, pos, layer0, cfg, fmts, K)
    # a slot outside the ring: the host mirror's check, in forward
    with pytest.raises(ValueError, match="do not fit"):
        forward(params, dataclasses.replace(cfg, decode_layer_unroll=-1),
                torch.tensor([1]), cfg.n_ctx, cache)

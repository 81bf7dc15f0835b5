"""The port's ring attention (parallel/ring.py) against the JAX package's,
on the CPU: test_ring.py's cases on both.

The JAX side runs on its virtual CPU devices (tp = 2 × sp = 4), the port on
``[cpu] * 8`` with the same mesh shape; the inputs come from one numpy seed.
Tolerances: the attention ops in f32, 2·10⁻⁵ of JAX's (test_ring.py's
tolerance against its single-device oracle: the same online softmax, summed
in another order); the model passes over bf16 weights, logits within
rel-dev 1·10⁻² of JAX's sequence-parallel pass (the port's model parity
tolerance, tests/test_torch_model.py), and within test_ring.py's 3·10⁻² of
the port's single-device pass (ring and score-matrix attention round P to
bf16 at other points); the ring's keys within 3·10⁻² of JAX's ring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
from llama_fastapi_k8s_gpu_tpu.models.llama import prefill as j_prefill
from llama_fastapi_k8s_gpu_tpu.models.params import synth_params as j_synth_params
from llama_fastapi_k8s_gpu_tpu.parallel import mesh as jmesh
from llama_fastapi_k8s_gpu_tpu.parallel import ring as jring
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward, init_cache
from llama_fastapi_k8s_gpu_tpu_torch.models.params import from_jax_params
from llama_fastapi_k8s_gpu_tpu_torch.parallel import mesh as pmesh
from llama_fastapi_k8s_gpu_tpu_torch.parallel import ring as pring

torch.set_num_threads(1)
CPU = torch.device("cpu")
JCFG = JModelConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                    ffn_dim=128, n_ctx=64, rope_theta=10000.0)
CFG = ModelConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(ModelConfig)})


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def meshes():
    """(JAX's tp = 2 × sp = 4 mesh, the port's over ``[cpu] * 8``)."""
    return (jmesh.make_mesh(dp=1, tp=2, sp=4),
            pmesh.make_mesh(dp=1, tp=2, sp=4, devices=[CPU] * 8))


@pytest.fixture(scope="module")
def weights():
    jp = j_synth_params(JCFG, fmt="bf16", seed=0)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jp)
    return jp, from_jax_params(tree, CFG, device=CPU)


def _qkv(seed: int, S: int):
    rng = np.random.default_rng(seed)
    H, n_kv, hd, n_ctx = 4, 2, 32, 64
    return (rng.standard_normal((S, H, hd)).astype(np.float32),
            rng.standard_normal((n_kv, n_ctx, hd)).astype(np.float32),
            rng.standard_normal((n_kv, n_ctx, hd)).astype(np.float32))


@pytest.mark.parametrize("offset,window", [(0, 0), (16, 0), (8, 24)])
def test_ring_attention_matches_jax(meshes, offset, window):
    """32 queries over the 64-slot ring, rows and slots over sp = 4, heads
    over tp = 2: the port's ring against JAX's ``ring_attention``."""
    jm, pm = meshes
    q, k, v = _qkv(7 + offset, 32)
    sm = 32 ** -0.5
    with jring.ring_context(jm):
        want = jring.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.int32(offset), sm_scale=sm, sliding_window=window)
    got = pring.ring_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               offset, sm, window, mesh=pm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("pos", [37, 0, 63])
def test_sharded_decode_attention_matches_jax(meshes, pos):
    """One query over the slot-sharded ring, the partial softmaxes met by a
    global log-sum-exp (shards with no visible key among them at pos 0)."""
    jm, pm = meshes
    q, k, v = _qkv(11 + pos, 1)
    sm = 32 ** -0.5
    with jring.ring_context(jm):
        want = jring.sharded_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jnp.int32(pos), sm_scale=sm)
    got = pring.sharded_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), torch.tensor(pos), sm, mesh=pm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def _gathered(ring: pmesh.ShardedRing, key: str) -> torch.Tensor:
    """A sharded ring's leaf put back together: (L, n_kv, n_ctx, hd)."""
    tp = len({c[1] for c in ring.coords})
    sp = len({c[2] for c in ring.coords})
    heads = [torch.cat([ring[key][ring.index(0, t, s)] for s in range(sp)], dim=2)
             for t in range(tp)]
    return torch.cat(heads, dim=1)


def test_sp_prefill_and_decode_step_match_jax(meshes, weights):
    """``sp_prefill`` of 32 tokens (8 rows a shard) and one
    ``sp_decode_step`` after it, over the tp = 2 × sp = 4 ring: logits
    against JAX's ``sp_prefill`` / ``sp_decode_step`` on its mesh, the
    ring's keys against JAX's ring, and the port's single-device pass (the
    first layer's keys bit for bit: they come before any attention)."""
    jm, pm = meshes
    jp, pp = weights
    tokens = np.arange(1, 33)
    jcache = jax.device_put(j_init_cache(JCFG), jring.sp_state_shardings(JCFG, jm))
    jsharded = jmesh.shard_params(jp, jm)
    j_logits, j_cache = jring.sp_prefill(jsharded, JCFG, jnp.asarray(tokens, jnp.int32),
                                         jnp.int32(32), jcache, jm)
    j_keys = np.asarray(j_cache["k"][:, :, :32], np.float32)
    # the cache is donated to the step
    j_step, _ = jring.sp_decode_step(jsharded, JCFG, jnp.int32(5), jnp.int32(32), j_cache, jm)

    mp = pmesh.shard_params(pp, pm, CFG)
    ring = pring.sp_state_shardings(CFG, pm, tp_split=mp.tp_heads)
    assert ring.coords == [(0, t, s) for t in range(2) for s in range(4)]
    assert tuple(ring["k"][0].shape) == (2, 1, 16, 16)
    got = pring.sp_prefill(mp, CFG, torch.from_numpy(tokens), 32, ring)
    assert _rel(got.numpy(), np.asarray(j_logits)) <= 1e-2
    np.testing.assert_allclose(_gathered(ring, "k")[:, :, :32].float().numpy(), j_keys,
                               rtol=3e-2, atol=3e-2)
    step = pring.sp_decode_step(mp, CFG, torch.tensor(5), torch.tensor(32), ring)
    assert _rel(step.numpy(), np.asarray(j_step)) <= 1e-2
    one = init_cache(CFG, CPU)
    ref = forward(pp, CFG, torch.from_numpy(tokens), 0, one)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=3e-2, atol=3e-2)
    assert torch.equal(_gathered(ring, "k")[:1, :, :32], one["k"][:1, :, :32])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sp_ring_writes_each_slot_to_its_owner(meshes, weights, kv_dtype):
    """A prompt pass from slot 0, then decode rows at slots on each side of
    the shard boundary (15, 16): every slot lands in the shard that owns it,
    and no other shard changes; the first layer's slots (written before any
    attention) equal the single-device ring's, the int8 scale planes
    alike."""
    _, pm = meshes
    _, pp = weights
    cfg = dataclasses.replace(CFG, kv_dtype=kv_dtype)
    rcfg = dataclasses.replace(cfg, attn_impl="ring")
    mp = pmesh.shard_params(pp, pm, cfg)
    ring = pring.sp_state_shardings(cfg, pm, tp_split=mp.tp_heads)
    one = init_cache(cfg, CPU)
    tokens = torch.arange(1, 15)
    pring.sp_prefill(mp, cfg, torch.cat([tokens, tokens.new_zeros(2)]), 14, ring)
    forward(pp, cfg, tokens, 0, one)
    for pos, tok in ((14, 3), (15, 4), (16, 5)):
        before = {k: [t.clone() for t in v] for k, v in ring.items()}
        forward(mp, rcfg, torch.tensor([tok]), torch.tensor(pos), ring)
        forward(pp, cfg, torch.tensor([tok]), pos, one)
        for key, parts in ring.items():
            for i, (t, was) in enumerate(zip(parts, before[key])):
                s = ring.coords[i][2]
                if not (s * 16 <= pos < (s + 1) * 16):
                    assert torch.equal(t, was), (key, i)
        for key in ring:
            assert torch.equal(_gathered(ring, key)[:1, :, :pos + 1], one[key][:1, :, :pos + 1])

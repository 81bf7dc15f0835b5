"""The port's mesh (parallel/mesh.py) against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's mesh is a list of ``[cpu] * n`` (a device may repeat), one shard a
device, the collectives plain functions over the shards.  The tiny config
is test_parallel.py's (8 heads over 4 kv heads, so tp = 4 leaves one kv
head a shard).  Tolerances:

- the shard layout: each leaf's shard ``i`` holds what JAX's shard on tp
  device ``i`` holds, bit for bit (bf16 and int8 weights; the fused
  layouts: the JAX planes packed from the port shard's GGUF rows equal
  JAX's shard, so both dequantize alike);
- the fused matmuls: the port's tp shards put back together equal the
  port's unsharded product exactly (each output row is computed alone), and
  agree with JAX's N-sharded product to test_parallel.py's 2·10⁻² ×
  max|y|;
- prefill and the lane step: logits within rel-dev 1·10⁻² of JAX's on the
  same mesh over bf16 weights (the port's model parity tolerance,
  tests/test_torch_model.py), 2.5·10⁻² over int8 ones (the int8 linear
  quantizes each activation row, so a bf16 step moves a code by one: the
  port's single-device pass is 1.85·10⁻² from JAX's single-device pass on
  these weights, and JAX's tp pass equals its own single-device one), and
  equal to the port's single-device logits (the shards compute each head
  and each output row alone; row-parallel products are summed in f32, the
  int8 ones exactly in int32); greedy tokens equal JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
from llama_fastapi_k8s_gpu_tpu.models.llama import prefill as j_prefill
from llama_fastapi_k8s_gpu_tpu.models.params import synth_params as j_synth_params
from llama_fastapi_k8s_gpu_tpu.parallel import batched_generate_chunk_jit, batched_prefill_jit
from llama_fastapi_k8s_gpu_tpu.parallel import init_batched_state as j_init_batched_state
from llama_fastapi_k8s_gpu_tpu.parallel import mesh as jmesh
from llama_fastapi_k8s_gpu_tpu.sampling.sample import SamplingParams as JSamplingParams
from llama_fastapi_k8s_gpu_tpu.sampling.sample import sampling_tensors as j_sampling_tensors
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGMLType, quants
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward, init_cache, init_lane_cache
from llama_fastapi_k8s_gpu_tpu_torch.models.params import from_jax_params
from llama_fastapi_k8s_gpu_tpu_torch.ops.linear import Linear, linear
from llama_fastapi_k8s_gpu_tpu_torch.parallel import mesh as pmesh
from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import (
    batched_prefill,
    generate_chunk_lanes,
    init_batched_state,
)
from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams, lane_tensors

torch.set_num_threads(1)
CPU = torch.device("cpu")
JCFG = JModelConfig(vocab_size=256, dim=64, n_layers=2, n_heads=8, n_kv_heads=4,
                    ffn_dim=128, n_ctx=32, rope_theta=10000.0)
CFG = ModelConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(ModelConfig)})
LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _jshard(arr, dev) -> np.ndarray:
    """JAX's shard of ``arr`` on ``dev``, as f32 numpy."""
    return np.asarray(jnp.asarray(
        next(s.data for s in arr.addressable_shards if s.device == dev), jnp.float32))


#: logits rel-dev from JAX's, by weight format (module docstring)
LOGIT_TOL = {"bf16": 1e-2, "int8": 2.5e-2}


def _pmesh(dp=1, tp=1, sp=1):
    return pmesh.make_mesh(dp, tp, sp, devices=[CPU] * (dp * tp * sp))


@pytest.fixture(scope="module", params=["bf16", "int8"])
def weights(request):
    """(format, JAX params, the port's params on the same weights)."""
    jp = j_synth_params(JCFG, fmt=request.param, seed=0)
    return request.param, jp, from_jax_params(_numpy_tree(jp), CFG, device=CPU)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_layout_matches_the_jax_shards(weights, tp):
    """Every leaf: the port's shard ``t`` equals JAX's shard on tp device
    ``t`` bit for bit — column-parallel linears split N, bf16 and int8
    row-parallel ones K (int8 scales whole), the head the vocabulary;
    ``tok_emb`` and the norms whole."""
    fmt, jp, pp = weights
    jm = jmesh.make_mesh(dp=1, tp=tp)
    js = jmesh.shard_params(jp, jm)
    mp = pmesh.shard_params(pp, _pmesh(tp=tp), CFG)
    assert mp.layout == {
        **{n: "col" for n in ("wq", "wk", "wv", "w_gate", "w_up", "output")},
        "wo": "row", "w_down": "row"}
    for t in range(tp):
        dev, shard = jm.devices[0, t, 0], mp.shard(0, t, 0)
        for name in LINEARS:
            leaf = js["layers"][name]
            for i, layer in enumerate(shard.layers):
                lin = getattr(layer, name)
                w = "w" if fmt == "bf16" else "q"
                assert np.array_equal(lin.weight.float().numpy(), _jshard(leaf[w], dev)[i])
                if fmt == "int8":
                    assert np.array_equal(lin.scale.numpy(), _jshard(leaf["s"], dev)[i])
        head = js["output"]["w" if fmt == "bf16" else "q"]
        assert np.array_equal(shard.output.weight.float().numpy(), _jshard(head, dev))
        assert np.array_equal(shard.tok_emb.float().numpy(), _jshard(js["tok_emb"], dev))
        assert np.array_equal(shard.out_norm.numpy(), _jshard(js["out_norm"], dev))
        for i, layer in enumerate(shard.layers):
            assert np.array_equal(layer.attn_norm.numpy(),
                                  _jshard(js["layers"]["attn_norm"], dev)[i])


def _fused(fmt, n, k, seed):
    """(JAX fused layout, the port's Linear of the same GGUF rows, the
    float weights)."""
    from llama_fastapi_k8s_gpu_tpu.ops import (
        make_linear_q4k,
        make_linear_q5k,
        make_linear_q6k,
        make_linear_q8,
    )

    jmake = {"q4k": make_linear_q4k, "q5k": make_linear_q5k, "q6k": make_linear_q6k,
             "q8": make_linear_q8}[fmt]
    gtype = {"q4k": GGMLType.Q4_K, "q5k": GGMLType.Q5_K, "q6k": GGMLType.Q6_K,
             "q8": GGMLType.Q8_0}[fmt]
    rng = np.random.default_rng(seed)
    wf = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    raw = np.asarray(quants.quantize(wf, gtype), np.uint8)
    return jmake(wf), Linear(fmt, torch.from_numpy(raw.reshape(n, -1).copy()), n, k), gtype


def _jprep(fmt, rows: np.ndarray, n: int, k: int) -> dict:
    from llama_fastapi_k8s_gpu_tpu.ops.pallas.q5matmul import prep_q5k
    from llama_fastapi_k8s_gpu_tpu.ops.pallas.q6matmul import prep_q6k
    from llama_fastapi_k8s_gpu_tpu.ops.pallas.q8matmul import prep_q8_0
    from llama_fastapi_k8s_gpu_tpu.ops.pallas.qmatmul import prep_q4k

    prep = {"q4k": prep_q4k, "q5k": prep_q5k, "q6k": prep_q6k, "q8": prep_q8_0}[fmt]
    return prep(rows.reshape(-1), n, k)


@pytest.mark.parametrize("fmt", ["q4k", "q5k", "q6k", "q8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_fused_layout_shards_match_the_jax_shards(fmt, tp):
    """A fused weight shards N whole: the JAX planes packed from the port
    shard ``t``'s GGUF rows equal, plane for plane and bit for bit, JAX's
    shard on tp device ``t`` (``shard_fused_linear``), so the two
    dequantize alike."""
    n, k = 512, 2048
    jw, lin, _ = _fused(fmt, n, k, seed=5)
    jm = jmesh.make_mesh(dp=1, tp=tp)
    js = jax.device_put(jw, jmesh.shard_fused_linear(jw, jm))
    for t in range(tp):
        shard = pmesh.shard_linear(lin, "col", tp, t, CPU)
        assert (shard.n_out, shard.k_in) == (n // tp, k)
        mine = _jprep(fmt, shard.weight.numpy(), n // tp, k)
        for key, arr in js.items():
            theirs = next(s.data for s in arr.addressable_shards
                          if s.device == jm.devices[0, t, 0])
            assert np.array_equal(np.asarray(mine[key]), np.asarray(theirs)), key


@pytest.mark.parametrize("fmt", ["q4k", "q5k", "q6k", "q8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_fused_matmul_partitioned_matches_unsharded(fmt, tp):
    """The fused matmul N-sharded over tp: the port's shards put back
    together equal its unsharded product exactly, and agree with JAX's
    sharded product (test_parallel.py's
    ``test_fused_matmul_partitioned_matches_unsharded``) to 2·10⁻²·max|y|."""
    from llama_fastapi_k8s_gpu_tpu.ops.linear import linear as j_linear

    jw, lin, _ = _fused(fmt, 256, 2048, seed=5)
    xf = np.random.default_rng(5).standard_normal((3, 2048)).astype(np.float32)
    x = torch.from_numpy(xf).to(torch.bfloat16)
    whole = linear(x, lin).float()
    parts = [linear(x, pmesh.shard_linear(lin, "col", tp, t, CPU)) for t in range(tp)]
    got = torch.cat(parts, dim=-1).float()
    assert torch.equal(got, whole)
    jm = jmesh.make_mesh(dp=1, tp=tp)
    ws = jax.device_put(jw, jmesh.shard_fused_linear(jw, jm))
    want = np.asarray(jax.jit(j_linear)(jnp.asarray(xf, jnp.bfloat16), ws).astype(jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tp_prefill_matches_jax_and_the_single_device(weights, tp, kv_dtype):
    """A prompt pass over tp-sharded weights and a kv-head-sharded ring
    (bf16, or int8 with its scale planes): logits within rel-dev 1·10⁻² of
    JAX's tp prefill on its mesh, and equal to the port's single-device
    pass; the ring's shards hold the single-device ring's kv heads."""
    fmt, jp, pp = weights
    jcfg = dataclasses.replace(JCFG, kv_dtype=kv_dtype)
    cfg = dataclasses.replace(CFG, kv_dtype=kv_dtype)
    tokens = np.arange(8)
    jm = jmesh.make_mesh(dp=1, tp=tp)
    jcache = jax.device_put(j_init_cache(jcfg), jmesh.cache_shardings(jcfg, jm))
    j_logits, _ = jax.jit(j_prefill, static_argnums=1)(
        jmesh.shard_params(jp, jm), jcfg, jnp.asarray(tokens, jnp.int32), jnp.int32(8), jcache)
    mp = pmesh.shard_params(pp, _pmesh(tp=tp), cfg)
    ring = pmesh.init_sharded_cache(cfg, mp.mesh, tp_split=mp.tp_heads)
    got = forward(mp, cfg, torch.from_numpy(tokens), 0, ring)
    one = init_cache(cfg, CPU)
    want = forward(pp, cfg, torch.from_numpy(tokens), 0, one)
    assert torch.equal(got, want)
    assert _rel(got.numpy(), np.asarray(j_logits, np.float32)) <= LOGIT_TOL[fmt]
    nk = cfg.n_kv_heads // tp
    for t in range(tp):
        for key, parts in ring.items():
            assert torch.equal(parts[ring.index(0, t, 0)], one[key][:, t * nk:(t + 1) * nk])


def test_dp_tp_lane_step_matches_jax(weights):
    """test_parallel.py's ``test_dp_tp_batched_serving_step`` on both: four
    lanes over dp = 2 × tp = 4, one prompt a lane, then three greedy lane
    steps.  The prompt logits agree with JAX's (:data:`LOGIT_TOL`) and equal
    the port's single-device lanes; every lane samples JAX's tokens."""
    fmt, jp, pp = weights
    batch, S = 4, 8
    jm = jmesh.make_mesh(dp=2, tp=4)
    sp_ = jmesh.shard_params(jp, jm)
    jstate = jax.device_put(j_init_batched_state(JCFG, batch),
                            jmesh.state_shardings(JCFG, jm, batched=True))
    jtok = jax.device_put(jnp.tile(jnp.arange(S, dtype=jnp.int32), (batch, 1)),
                          NamedSharding(jm, P("dp", None)))
    jlen = jax.device_put(jnp.full((batch,), S, jnp.int32), NamedSharding(jm, P("dp")))
    j_logits, caches = batched_prefill_jit(sp_, JCFG, jtok, jlen, jstate["cache"])
    jstate["cache"] = caches
    jstate["pos"] = jnp.full((batch,), S, jnp.int32)
    jst = j_sampling_tensors(JSamplingParams(temperature=0.0))
    _, j_toks = batched_generate_chunk_jit(sp_, JCFG, jstate, jst, n_steps=3)

    mesh = _pmesh(dp=2, tp=4)
    mp = pmesh.shard_params(pp, mesh, CFG)
    state = init_batched_state(CFG, batch, CPU, mesh=mesh, tp_split=mp.tp_heads)
    assert [c[:2] for c in state["cache"].coords] == [(d, t) for d in range(2) for t in range(4)]
    tokens = torch.arange(S).repeat(batch, 1)
    logits = batched_prefill(mp, CFG, tokens, [S] * batch, state["cache"])
    one = init_lane_cache(CFG, batch, CPU)
    assert torch.equal(logits, batched_prefill(pp, CFG, tokens, [S] * batch, one))
    assert _rel(logits.numpy(), np.asarray(j_logits, np.float32)) <= LOGIT_TOL[fmt]
    state["pos"].fill_(S)
    state["slots"] = [S] * batch
    st = lane_tensors([SamplingParams(temperature=0.0)] * batch, CPU)
    toks = generate_chunk_lanes(mp, CFG, state, st, 3).rows()
    assert toks.shape == (3, batch)
    assert (toks == toks[:, :1]).all()
    assert np.array_equal(toks, np.asarray(j_toks))


def test_make_mesh_refuses_too_few_devices_as_jax_does():
    """Too few devices: the same ``ValueError`` text from both packages."""
    with pytest.raises(ValueError) as theirs:
        jmesh.make_mesh(dp=2, tp=4, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as mine:
        pmesh.make_mesh(dp=2, tp=4, devices=[CPU] * 4)
    assert str(mine.value) == str(theirs.value) == "mesh 2x4x1 needs 8 devices, have 4"
    m = pmesh.make_mesh(dp=1, tp=2, sp=2, devices=[CPU] * 5)
    assert m.shape == {"dp": 1, "tp": 2, "sp": 2} and m.size == 4


@pytest.mark.parametrize("knobs,needs", [(dict(mesh_tp=2, batch_size=2), "1x2x1"),
                                         (dict(mesh_tp=2, batch_size=2, scheduler="cycle"),
                                          "1x2x1"),
                                         (dict(mesh_sp=2), "1x1x2")])
def test_server_on_a_one_device_host_refuses_a_mesh(monkeypatch, tmp_path, knobs, needs):
    """``LFKT_MESH_TP=2`` (the lane engines) or ``LFKT_MESH_SP=2`` on a host
    with one device: the server's engine factory raises, as the JAX package
    does on one chip; nothing falls back to a single device."""
    from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
    from llama_fastapi_k8s_gpu_tpu_torch.engine import engine as engine_mod
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import _default_engine_factory
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings

    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama_gguf(path)
    monkeypatch.setattr(engine_mod, "resolve_device", lambda device=None: CPU)
    factory = _default_engine_factory(Settings(model_dir=str(tmp_path), model_name="tiny.gguf",
                                               max_context_tokens=128, **knobs))
    with pytest.raises(ValueError, match=f"mesh {needs} needs 2 devices, have 1"):
        factory()


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf

    path = str(tmp_path_factory.mktemp("mesh") / "tiny.gguf")
    write_tiny_llama_gguf(path)
    return path


def test_lane_engines_over_a_mesh_reply_as_jax(tiny_path):
    """The cycle engine at dp = 2 × tp = 2 and the continuous engine at
    tp = 2 (dp the devices left over) reply to a wave as JAX's ``MeshEngine``
    at dp = 2 × tp = 2 does, byte for byte; their serial path (a stream)
    too; the continuous engine's follow-up turn reuses its lane's sharded
    ring; recovery zeroes every lane shard in place; the ``kv_lanes`` ledger
    row is per shard."""
    from llama_fastapi_k8s_gpu_tpu.engine import MeshEngine as JMeshEngine
    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, MeshEngine
    from llama_fastapi_k8s_gpu_tpu_torch.engine.batched import _ledger_lane_bytes

    kw = dict(n_ctx=128, max_gen_tokens=8, decode_chunk=4, prefill_buckets=(32, 64, 128))
    prompts = [[{"role": "user", "content": f"lane {i} " * (1 + 2 * i)}] for i in range(4)]
    ref = JMeshEngine(tiny_path, dp=2, tp=2, batch_size=4, **kw)
    want = [o["choices"][0]["message"]["content"]
            for o in ref.create_chat_completions(prompts, temperature=0.0)]
    cyc = MeshEngine(tiny_path, tp=2, batch_size=4, devices=[CPU] * 4, device="cpu", **kw)
    assert cyc.mesh.shape == {"dp": 2, "tp": 2, "sp": 1}
    got = [o["choices"][0]["message"]["content"]
           for o in cyc.create_chat_completions(prompts, temperature=0.0)]
    assert got == want
    stream = "".join(c["choices"][0]["delta"].get("content", "") for c in
                     cyc.create_chat_completion(prompts[1], stream=True, temperature=0.0))
    assert stream == want[1]
    rows = _ledger_lane_bytes(cyc)
    assert sorted(rows) == [f"{cyc.model_name}@dp{d}.tp{t}.sp0:cpu"
                            for d in range(2) for t in range(2)]
    lanes = cyc._bstate["cache"]
    ptrs = [t.data_ptr() for v in lanes.values() for t in v]
    assert cyc.recover() is True
    assert [t.data_ptr() for v in lanes.values() for t in v] == ptrs
    assert all(not t.any() for v in lanes.values() for t in v)

    cont = ContinuousEngine(tiny_path, tp=2, batch_size=2, devices=[CPU] * 4, device="cpu",
                            prefill_chunk=32, **kw)
    try:
        assert cont.mesh.shape == {"dp": 2, "tp": 2, "sp": 1}
        futs = [cont.submit(p, temperature=0.0) for p in prompts]
        assert [f.result(timeout=60)["choices"][0]["message"]["content"] for f in futs] == want
        follow = prompts[3] + [{"role": "assistant", "content": want[3][:4]},
                               {"role": "user", "content": "go on"}]
        out = cont.submit(follow, temperature=0.0).result(timeout=60)
        assert out["lfkt_timings"]["prefix_reused_tokens"] > 0
        alone = MeshEngine(tiny_path, batch_size=1, device="cpu", **kw)
        assert out["choices"][0]["message"]["content"] == \
            alone.create_chat_completion(follow, temperature=0.0)["choices"][0]["message"]["content"]
    finally:
        cont.shutdown()


@pytest.mark.parametrize("knob,match", [(dict(weight_format="bf16", decode_layer_unroll=-1),
                                         "decode_layer_unroll=-1.*slot-sharded KV ring")])
def test_lane_engines_over_a_mesh_refuse_what_they_do_not_serve(tiny_path, knob, match):
    """What a mesh still does not serve raises before any shard is made:
    the layer-looped decode over the sequence-parallel engine's slot-sharded
    ring (here: the reference degrades there, the port's degrade raises),
    and a mesh over distinct cards (only on the card: a CPU list is one
    device; ROADMAP A.1).  Nothing serves them quietly on one device.  The
    paged pool, lane speculation and the looped decode serve over a tp mesh
    (tests/test_torch_mesh_paged.py, tests/test_torch_mesh_spec.py,
    tests/test_torch_mesh_loop.py)."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import SPEngine

    with pytest.raises(ValueError, match=match):
        SPEngine(tiny_path, sp=2, tp=2, devices=[CPU] * 4, device="cpu", n_ctx=128, **knob)


@pytest.mark.parametrize("scheduler", ["cycle", "continuous"])
def test_lane_engines_on_a_pod_of_two_cards_keep_their_lanes_on_one(monkeypatch, tiny_path,
                                                                    scheduler):
    """With no device list a lane engine at tp = 1 builds no mesh, however
    many cards the pod shows: ``dp`` defaults to 1 there (a mesh over
    distinct cards is not served yet), so a batch_size = 4 pod with two
    cards serves its lanes on one card as before.  The pod's cards are
    faked as two devices."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, MeshEngine
    from llama_fastapi_k8s_gpu_tpu_torch.engine import engine as engine_mod

    monkeypatch.setattr(engine_mod, "default_devices", lambda device: [device, device])
    cls = MeshEngine if scheduler == "cycle" else ContinuousEngine
    eng = cls(tiny_path, batch_size=4, device="cpu", n_ctx=128, max_gen_tokens=4)
    try:
        assert eng.mesh is None
        assert eng.batch_size == 4
        out = eng.create_chat_completion([{"role": "user", "content": "hi"}], temperature=0.0)
        assert out["usage"]["completion_tokens"] > 0
    finally:
        getattr(eng, "shutdown", eng.close)()

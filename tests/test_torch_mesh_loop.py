"""The layer-looped decode over a tp mesh (ops/decode_loop.py
``forward_layers_looped_mesh``: kernel 11 reading each layer's weights and
kv heads from their tp shards), on the CPU, where the wrapper runs its
plain mesh version (``decode_loop_mesh_plain``: the per-layer mesh source
with the plain KV quantize).

- **The engines.**  The port's ``MeshEngine(tp=2)`` over ``[cpu] * 4``
  (dp = 2) with ``decode_layer_unroll=2`` replies as the JAX package's
  ``MeshEngine(dp=2, tp=2, decode_layer_unroll=2)`` (the setup of
  tests/test_decode_loop.py ``test_mesh_parity``), greedy text for text,
  on the serial path and on the batched cycle; the port's
  ``ContinuousEngine(tp=2)`` with ``decode_layer_unroll=-1`` as the JAX
  ``ContinuousEngine(dp=2, tp=2)`` over the bf16 and the int8 ring.  Both
  go through the looped mesh path (its plain version is counted).
- **The shard description.**  At tp = 2 and 4, over bf16 and int8
  weights, its plain reader (``read_shards_plain``: each element read
  where the kernel reads it) gives back the unsharded weights, scales and
  norms, and the whole-head ring, bit for bit — split heads, and heads tp
  does not divide (replicated: every replica written, shard 0 read) with
  ``rep`` q/k/v linears.  Its head map is the paged pool's
  (``ShardedRing.head_shards``).
- **The forward.**  Over 8 decode steps at tp = 2 and 4, bf16 and int8
  weights × bf16 and int8 rings, the looped mesh forward is bit-identical
  to ``forward_mesh`` with the loop off, in logits and in every ring leaf;
  so is the lane forward (``forward_lanes_mesh``) over dp × tp.
"""

from __future__ import annotations

import dataclasses
import gc

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import ContinuousEngine as JContinuousEngine
from llama_fastapi_k8s_gpu_tpu.engine import MeshEngine as JMeshEngine
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, MeshEngine
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import forward, forward_lanes
from llama_fastapi_k8s_gpu_tpu_torch.models.params import LOOP_LINEARS, synth_params
from llama_fastapi_k8s_gpu_tpu_torch.ops import decode_loop
from llama_fastapi_k8s_gpu_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)
CPU = torch.device("cpu")
T = 120     # seconds any future may take
#: tests/test_decode_loop.py's engine knobs and prompts
BASE_KW = dict(n_ctx=128, decode_chunk=4, max_gen_tokens=16, prefill_buckets=(32, 64, 128))
PROMPTS = [
    [{"role": "user", "content": "Say something."}],
    [{"role": "user", "content": "alpha bravo charlie delta echo " * 3}],
]
#: tests/test_torch_mesh.py's geometry (8 heads over 4 kv heads: tp = 4
#: leaves one kv head a shard) and one whose 2 kv heads tp = 4 does not
#: divide (replicated heads, q/k/v ``rep``)
SPLIT = dict(vocab_size=64, dim=64, n_layers=4, n_heads=8, n_kv_heads=4, ffn_dim=128, n_ctx=32)
REPLICATED = dict(SPLIT, n_heads=4, n_kv_heads=2)


def _text(r) -> str:
    return r["choices"][0]["message"]["content"]


@pytest.fixture(autouse=True)
def _collect_engines():
    yield
    gc.collect()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_loop") / "tiny.gguf")
    write_tiny_llama_gguf(path)
    return path


@pytest.fixture
def looped(monkeypatch):
    """Counts the looped mesh path's plain launches (the wrapper's CPU
    branch over a ``ShardedRing``)."""
    calls = []
    plain = decode_loop.decode_loop_mesh_plain

    def counted(*a, **kw):
        calls.append(a[4])                # layer0
        return plain(*a, **kw)

    monkeypatch.setattr(decode_loop, "decode_loop_mesh_plain", counted)
    return calls


def test_mesh_engine_looped_replies_as_the_jax_mesh_engine(tiny, looped):
    """The reference's ``test_mesh_parity`` setup on both packages: greedy
    texts equal on the serial (streaming) path and on the batched cycle,
    every decode token through the looped mesh path (one launch of the
    tiny model's two layers); ``/health``'s ``decode_layer_unroll`` is
    the effective K."""
    from llama_fastapi_k8s_gpu_tpu_torch.server.app import _effective_unroll

    eng = MeshEngine(tiny, tp=2, batch_size=2, devices=[CPU] * 4, device="cpu",
                     decode_layer_unroll=2, **BASE_KW)
    ref = JMeshEngine(tiny, dp=2, tp=2, batch_size=2, decode_layer_unroll=2, **BASE_KW)
    assert eng.mesh.shape == {"dp": 2, "tp": 2, "sp": 1}
    assert eng.cfg.decode_layer_unroll == 2 and _effective_unroll(eng.cfg) == 2
    texts = [([_text(e.create_chat_completion(p, temperature=0.0, max_tokens=10))
               for p in PROMPTS],
              [_text(e.create_chat_completions([p], temperature=0.0, max_tokens=10)[0])
               for p in PROMPTS]) for e in (eng, ref)]
    assert texts[0] == texts[1]
    assert looped and set(looped) == {0}
    both = [_text(r) for r in eng.create_chat_completions(PROMPTS, temperature=0.0,
                                                          max_tokens=10)]
    assert both == texts[0][0]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_continuous_tp_looped_replies_as_the_jax_engine_on_the_same_mesh(tiny, looped,
                                                                          kv_dtype):
    """``ContinuousEngine(tp=2)`` over ``[cpu] * 4`` with one looped launch
    a token against the JAX ``ContinuousEngine(dp=2, tp=2)`` with the same
    knob: four concurrent requests, greedy texts equal."""
    kw = dict(batch_size=2, kv_dtype=kv_dtype, decode_layer_unroll=-1, **BASE_KW)
    eng = ContinuousEngine(tiny, tp=2, devices=[CPU] * 4, device="cpu", **kw)
    ref = JContinuousEngine(tiny, dp=2, tp=2, **kw)
    try:
        assert eng.mesh.shape == {"dp": 2, "tp": 2, "sp": 1}
        got = [[_text(f.result(T)) for f in [e.submit(p, temperature=0.0, max_tokens=10)
                                             for p in PROMPTS * 2]]
               for e in (eng, ref)]
        assert got[0] == got[1]
        assert looped and set(looped) == {0}
    finally:
        eng.shutdown()
        ref.shutdown()


def _mesh_model(shape: dict, tp: int, fmt: str, kv_dtype: str = "bf16", dp: int = 1,
                window: int = 0):
    cfg = ModelConfig(**shape, kv_dtype=kv_dtype, sliding_window=window)
    params = synth_params(cfg, fmt, seed=3, device=CPU)
    mesh = pmesh.make_mesh(dp=dp, tp=tp, devices=[CPU] * (dp * tp))
    return cfg, params, mesh, pmesh.shard_params(params, mesh, cfg)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("tp,shape", [(2, SPLIT), (4, SPLIT), (4, REPLICATED)])
def test_shard_description_reads_back_the_whole_weights_and_ring(fmt, tp, shape):
    """The plain reader over the description gives the unsharded layer
    stack and the whole-head ring back bit for bit; each head's write set
    holds every shard the paged pool's map writes it to."""
    cfg, params, mesh, mp = _mesh_model(shape, tp, fmt, "int8")
    ring = pmesh.init_sharded_cache(cfg, mesh, tp_split=mp.tp_heads)
    desc = decode_loop.describe_shards(mp, cfg, ring)
    split = shape is SPLIT
    assert desc["tp"] == tp and desc["kv_split"] == split
    assert desc["modes"] == {n: ("rep" if n in ("wq", "wk", "wv") and not split else
                                 "row" if n in ("wo", "w_down") else "col")
                             for n in LOOP_LINEARS}
    # a random whole-head ring, written to the shards by the pool's map
    g = torch.Generator().manual_seed(tp)
    whole = {}
    for name, shards in ring.items():
        full = (cfg.n_layers, cfg.n_kv_heads, *shards[0].shape[2:])
        whole[name] = (torch.randint(-127, 128, full, generator=g, dtype=torch.int8)
                       if shards[0].dtype == torch.int8 else torch.rand(full, generator=g))
    writes = set()
    for i, heads in ring.head_shards(write=True):
        for name in ring:
            ring[name][i].copy_(whole[name][:, heads])
        writes |= {(j, i) for j in range(cfg.n_kv_heads)[heads]}
    assert writes == {(j, t) for j, (_, _, ws) in enumerate(desc["heads"]) for t in ws}
    reads = {j: i for i, heads in ring.head_shards(write=False)
             for j in range(cfg.n_kv_heads)[heads]}
    assert reads == {j: t for j, (t, _, _) in enumerate(desc["heads"])}
    layers, got = decode_loop.read_shards_plain(desc, [ring.part(i) for i in range(tp)])
    for name in whole:
        assert torch.equal(got[name], whole[name]), name
    for i, layer in enumerate(params.layers):
        for n in LOOP_LINEARS:
            w, s = layers[i][n]
            lin = getattr(layer, n)
            assert w.dtype == lin.weight.dtype and torch.equal(w, lin.weight), (i, n)
            assert (s is None) == (lin.scale is None), (i, n)
            if s is not None:
                assert torch.equal(s, lin.scale), (i, n)
        assert torch.equal(desc["layers"][i]["attn_norm"], layer.attn_norm)
        assert torch.equal(desc["layers"][i]["ffn_norm"], layer.ffn_norm)


def test_one_device_description_is_the_one_card_table():
    """tp = 1: one shard, every linear ``rep``, every head on shard 0 —
    the one-device table and launch."""
    cfg = ModelConfig(**SPLIT)
    params = synth_params(cfg, "int8", seed=3, device=CPU)
    desc = decode_loop.describe_shards(params, cfg)
    assert desc["tp"] == 1 and desc["group"] == 0 and not desc["kv_split"]
    assert set(desc["modes"].values()) == {"rep"} and decode_loop._modes(desc) == 0
    assert desc["heads"] == [(0, j, (0,)) for j in range(cfg.n_kv_heads)]
    assert all(layer["linears"][n] == [getattr(params.layers[i], n)]
               for i, layer in enumerate(desc["layers"]) for n in LOOP_LINEARS)


def _decode_trace(mp, cfg, mesh, unroll: int, steps: int = 8):
    """Prefill 8 tokens over a fresh sharded ring, then ``steps`` greedy
    decode steps at device positions: (logits of every pass, the ring)."""
    c = dataclasses.replace(cfg, decode_layer_unroll=unroll)
    ring = pmesh.init_sharded_cache(c, mesh, tp_split=mp.tp_heads)
    with torch.inference_mode():
        out = [forward(mp, c, torch.arange(8), 0, ring)]
        for s in range(steps):
            tok = int(out[-1].argmax())
            out.append(forward(mp, c, torch.tensor([tok]), torch.tensor(8 + s), ring))
    return out, ring


def _lane_trace(mp, cfg, mesh, unroll: int, steps: int = 4):
    """Four lanes of a lane ring over dp × tp filled with random K/V, then
    ``steps`` lane steps at per-lane slots."""
    c = dataclasses.replace(cfg, decode_layer_unroll=unroll)
    ring = pmesh.init_sharded_cache(c, mesh, tp_split=mp.tp_heads, lanes=4)
    g = torch.Generator().manual_seed(0)
    for shards in ring.values():
        for x in shards:
            x.copy_(torch.randint(-127, 128, x.shape, generator=g, dtype=torch.int8)
                    if x.dtype == torch.int8 else torch.rand(x.shape, generator=g).to(x.dtype))
    toks, slots = torch.tensor([1, 2, 3, 4]), torch.tensor([3, 7, 11, 5])
    out = []
    with torch.inference_mode():
        for s in range(steps):
            out.append(forward_lanes(mp, c, toks, slots + s, ring))
            toks = out[-1].argmax(-1)
    return out, ring


def _assert_bitwise(a, b):
    (la, ra), (lb, rb) = a, b
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"logits of pass {i}"
    for name in ra:
        for t, (x, y) in enumerate(zip(ra[name], rb[name])):
            assert torch.equal(x, y), f"ring leaf {name} shard {t}"


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp,shape,window", [(2, SPLIT, 0), (4, SPLIT, 0),
                                             (4, REPLICATED, 0), (2, SPLIT, 6)])
def test_looped_mesh_forward_is_the_per_layer_mesh_forward(looped, fmt, kv_dtype, tp, shape,
                                                           window):
    """8 decode steps (K = 2: two looped launches a token) against
    ``forward_mesh`` with the loop off: logits and every ring leaf
    bit-identical; a window that bites at these slots too."""
    cfg, _, mesh, mp = _mesh_model(shape, tp, fmt, kv_dtype, window=window)
    want = _decode_trace(mp, cfg, mesh, 0)
    assert not looped
    _assert_bitwise(_decode_trace(mp, cfg, mesh, 2), want)
    assert looped == [0, 2] * 8


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("dp,tp,shape", [(2, 2, SPLIT), (1, 4, REPLICATED)])
def test_looped_lane_mesh_forward_is_the_per_layer_lane_forward(looped, fmt, kv_dtype, dp, tp,
                                                                shape):
    """The lane step over dp × tp, each lane's stack one looped launch on
    its own ring (``cache.lane(b)``), against the per-layer lane step:
    logits and every lane ring leaf bit-identical."""
    cfg, _, mesh, mp = _mesh_model(shape, tp, fmt, kv_dtype, dp=dp)
    want = _lane_trace(mp, cfg, mesh, 0)
    _assert_bitwise(_lane_trace(mp, cfg, mesh, -1), want)
    assert looped == [0] * 16

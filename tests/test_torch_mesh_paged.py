"""The paged KV pool over a tp mesh (parallel/kvpool.py through
``ShardedRing.head_shards``), on the CPU, held to the one-device pool and
to the JAX package's paged mesh engines.

- **Page identity, bit for bit.**  A whole ring split over tp = 2 and
  tp = 4 shards (kv heads split, or replicated where tp does not divide
  them), bf16 and int8 (the per-token scales split by head too), on the
  serial ring and on a lane of dp group 1: the pages committed from the
  shards equal the pages the one-device pool commits from the whole ring,
  and a restore into the shards, gathered, equals a restore into the
  whole ring, every shard written in place.
- **The engines.**  The port's ``MeshEngine(tp=2)`` over ``[cpu] * 4``
  (dp = 2) under paging, its serial path and its cycles, replies as the
  JAX ``MeshEngine(dp=2, tp=2)`` under paging (the setup of
  tests/test_kv_paged_engines.py's ``test_mesh_paged_matches_dense``);
  the port's ``ContinuousEngine(tp=2)`` resumes a follow-up from its
  pages and a second conversation from the shared system prompt, with the
  reuse and the replies of the port's one-device paged engine and of the
  JAX ``ContinuousEngine(dp=2, tp=2, kv_paged=True)``, over the bf16 and
  the int8 ring; the pages a tp engine commits are the one-device
  engine's, byte for byte.
- **Pages cross the wire unchanged.**  Pages a tp = 2 engine exports
  import into a one-device engine over the disagg wire and serve its
  local hit's reply, and the reverse; a migration pull from a tp engine's
  page service does too; a two-model registry with one tp engine shares
  one arena.

The tiny Llama has 4 query heads over 2 kv heads: the engines' tp = 2
splits them.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import ContinuousEngine as JContinuousEngine
from llama_fastapi_k8s_gpu_tpu.engine import MeshEngine as JMeshEngine
from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.testing import TINY_CFG, write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine, MeshEngine
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import init_cache
from llama_fastapi_k8s_gpu_tpu_torch.parallel import mesh as pmesh
from llama_fastapi_k8s_gpu_tpu_torch.parallel.kvpool import KVPool
from llama_fastapi_k8s_gpu_tpu_torch.serving import ModelRegistry, parse_manifest
from llama_fastapi_k8s_gpu_tpu_torch.serving.disagg.decoder import DisaggClient
from llama_fastapi_k8s_gpu_tpu_torch.serving.disagg.prefiller import PrefillServer
from llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.migrate import (
    MigrationManager,
    MigrationServer,
)
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings
from tests.test_torch_kvpool import _bits

torch.set_num_threads(1)
CPU = torch.device("cpu")
T = 120          # seconds any future may take
PAGE = 8         # page tokens of the I/O cases


@pytest.fixture(autouse=True)
def _collect_engines():
    """Engines, page services and registries may sit in reference cycles:
    collect them as each test ends, so no later test finds their
    memory-ledger rows."""
    yield
    gc.collect()


# ---------------------------------------------------------------------------
# page identity: the pool's page I/O over a sharded ring
# ---------------------------------------------------------------------------

def _cfg(tp: int, heads: str, kv_dtype: str) -> ModelConfig:
    """8 query heads over 4 kv heads (tp splits them), or over tp // 2
    (tp does not divide them: replicated)."""
    n_kv = 4 if heads == "split" else tp // 2
    return ModelConfig(vocab_size=64, dim=64, n_layers=2, n_heads=8, n_kv_heads=n_kv,
                       ffn_dim=128, n_ctx=64, rope_theta=10000.0, kv_dtype=kv_dtype)


def _random_ring(cfg, seed: int) -> dict:
    """A whole ring of random contents (int8 codes and f32 scales, or bf16)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, leaf in init_cache(cfg, CPU).items():
        if leaf.dtype == torch.int8:
            out[name] = torch.randint(-127, 128, leaf.shape, generator=g, dtype=torch.int8)
        else:
            out[name] = torch.randn(leaf.shape, generator=g).to(leaf.dtype)
    return out


def _heads(t: int, tp: int, n_kv: int, split: bool) -> slice:
    """The kv heads tp shard ``t`` holds: its n_kv/tp, or all (replicated)."""
    return slice(t * n_kv // tp, (t + 1) * n_kv // tp) if split else slice(None)


def _fill(shards: list, coords: list, whole: dict, name: str, tp: int, split: bool,
          lane=None) -> None:
    """Each shard (of a serial ring, or lane ``lane`` of a lane-major one)
    set to its heads of ``whole``."""
    n_kv = whole[name].shape[1]
    for shard, (_, t, _) in zip(shards, coords):
        dst = shard if lane is None else shard[lane]
        dst.copy_(whole[name][:, _heads(t, tp, n_kv, split)])


def _sharded(cfg, tp: int, whole: dict, lanes: bool):
    """``whole`` laid over a tp mesh: the serial ring of dp group 0, or lane
    2 of a 4-lane ring over dp = 2 (dp group 1's first lane; the other
    lanes hold other contents).  Returns (the ring handed to the pool, the
    lane-major ring or None, the lane)."""
    split = cfg.n_kv_heads % tp == 0
    if not lanes:
        mesh = pmesh.make_mesh(tp=tp, devices=[CPU] * tp)
        ring = pmesh.init_sharded_cache(cfg, mesh, tp_split=split)
        for name in ring:
            _fill(ring[name], ring.coords, whole, name, tp, split)
        return ring, None, None
    mesh = pmesh.make_mesh(dp=2, tp=tp, devices=[CPU] * (2 * tp))
    bring = pmesh.init_sharded_cache(cfg, mesh, tp_split=split, lanes=4)
    for b in range(4):
        src = whole if b == 2 else _random_ring(cfg, 100 + b)
        d, local = divmod(b, 2)
        idx = [i for i, c in enumerate(bring.coords) if c[0] == d]
        for name in bring:
            _fill([bring[name][i] for i in idx], [bring.coords[i] for i in idx], src,
                  name, tp, split, lane=local)
    return bring.lane(2), bring, 2


def _arena_bits(pool) -> dict:
    return {name: _bits(leaf) for name, leaf in pool.arena.items()}


@pytest.mark.parametrize("where", ["serial", "lane"])
@pytest.mark.parametrize("heads", ["split", "replicated"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_pages_from_sharded_rings_equal_the_one_device_pools(tp, kv_dtype, heads, where):
    cfg = _cfg(tp, heads, kv_dtype)
    assert (cfg.n_kv_heads % tp == 0) == (heads == "split")
    whole = _random_ring(cfg, 7)
    ids = list(range(1, 42))                       # five whole pages and a tail
    one = KVPool(cfg, page_tokens=PAGE, n_pages=16, device=CPU)
    assert one.commit(ids, whole) == 5
    ring, bring, lane = _sharded(cfg, tp, whole, where == "lane")
    mine = KVPool(cfg, page_tokens=PAGE, n_pages=16, device=CPU)
    stored = mine.commit(ids, ring) if bring is None else mine.commit_lane(ids, bring, lane)
    assert stored == 5
    want, got = _arena_bits(one), _arena_bits(mine)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert mine.stats() == one.stats()
    assert mine.page_spec() == one.page_spec() and mine.compatible(cfg, PAGE)


@pytest.mark.parametrize("where", ["serial", "lane"])
@pytest.mark.parametrize("heads", ["split", "replicated"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_restore_into_a_sharded_ring_gathers_to_the_whole_restore(tp, kv_dtype, heads, where):
    """The lease's pages restored into zeroed shards, gathered over tp, equal
    the same pages restored into a zeroed whole ring; a replicated head is
    written to every shard; every shard keeps its storage."""
    cfg = _cfg(tp, heads, kv_dtype)
    split = heads == "split"
    ids = list(range(1, 42))
    pool = KVPool(cfg, page_tokens=PAGE, n_pages=16, device=CPU)
    pool.commit(ids, _random_ring(cfg, 3))
    lease = pool.acquire(ids, 40)
    try:
        whole = pool.restore(lease, init_cache(cfg, CPU))
        zeros = {k: torch.zeros_like(v) for k, v in whole.items()}
        ring, bring, _ = _sharded(cfg, tp, zeros, where == "lane")
        ptrs = [t.data_ptr() for v in ring.values() for t in v]
        assert pool.restore(lease, ring) is ring
        assert [t.data_ptr() for v in ring.values() for t in v] == ptrs
    finally:
        pool.release(lease)
    for name, leaf in whole.items():
        parts = ring[name]
        gathered = torch.cat(parts, 1) if split else parts[0]
        assert torch.equal(gathered, leaf), name
        if not split:
            assert all(torch.equal(p, leaf) for p in parts), name
        assert not gathered[:, :, 40:].any()
    if bring is not None:
        # the other lanes of the lane-major ring are untouched
        for b in (0, 1, 3):
            lane = bring.lane(b)
            for name in lane:
                src = _random_ring(cfg, 100 + b)[name]
                got = torch.cat(lane[name], 1) if split else lane[name][0]
                assert torch.equal(got, src), (b, name)
    assert pool.occupancy()["pages_pinned"] == 0


def test_head_shards_refuse_what_is_not_one_groups_serial_ring():
    cfg = _cfg(2, "split", "bf16")
    mesh = pmesh.make_mesh(dp=2, tp=2, devices=[CPU] * 4)
    lanes = pmesh.init_sharded_cache(cfg, mesh, lanes=2)
    with pytest.raises(ValueError, match="serial ring"):
        lanes.head_shards(write=False)
    assert lanes.lane(1).head_shards(write=True) == [(0, slice(0, 2)), (1, slice(2, 4))]
    sp = pmesh.init_sharded_cache(cfg, pmesh.make_mesh(tp=2, sp=2, devices=[CPU] * 4))
    with pytest.raises(ValueError, match="one dp group"):
        sp.head_shards(write=False)


# ---------------------------------------------------------------------------
# the engines, held to the JAX package's paged mesh engines
# ---------------------------------------------------------------------------

BUCKETS = (32, 64, 128)
#: distinct prompts (only the template header is shared: under a full page)
PROMPTS = [
    [{"role": "user", "content": "Say something."}],
    [{"role": "user", "content": "alpha bravo charlie delta echo " * 4}],
    [{"role": "user", "content": "one two three four five six seven " * 8}],
]
PAGED_KW = dict(kv_paged=True, kv_page_tokens=16, kv_pool_pages=64, kv_spill_pages=16,
                prefix_min=16)
BASE_KW = dict(n_ctx=512, decode_chunk=4, max_gen_tokens=16, prefill_buckets=BUCKETS,
               prefill_chunk=16)
J_BASE_KW = dict(BASE_KW, prefill_overlap=2)


def _text(r) -> str:
    return r["choices"][0]["message"]["content"]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_paged") / "tiny.gguf")
    write_tiny_llama_gguf(path, cfg=JModelConfig(**{**TINY_CFG.__dict__, "n_ctx": 512}))
    return path


def _convo():
    return [{"role": "system", "content": "You answer carefully. " * 8},
            {"role": "user", "content": "Tell me something interesting."}]


def _turn2(msgs, reply, turn2="And another one."):
    return msgs + [{"role": "assistant", "content": reply}, {"role": "user", "content": turn2}]


def _serial(eng, msgs):
    return eng.create_chat_completion(msgs, temperature=0.0, max_tokens=8)


def _submit(eng, msgs):
    return eng.submit(msgs, temperature=0.0, max_tokens=8).result(T)


def _pages(pool, ids, tokens: int, namespace: str = "") -> list:
    """The pool's page stacks for ``ids[:tokens]``, as numpy bits."""
    lease = pool.acquire(ids, tokens, namespace=namespace)
    assert lease is not None
    try:
        return [_bits(leaf) for leaf in pool.export_pages(lease)]
    finally:
        pool.release(lease)


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_mesh_engine_paged_replies_as_the_jax_mesh_engine(model_path):
    """Port ``MeshEngine(tp=2)`` over ``[cpu] * 4`` (dp = 2) and JAX
    ``MeshEngine(dp=2, tp=2)``, both paged: the serial path (it consults
    the index; distinct prompts miss) and the cycles (their lane rings
    untouched) reply alike, and a follow-up on the serial path resumes
    from its pages with the JAX engine's reuse and reply."""
    eng = MeshEngine(model_path, tp=2, batch_size=2, devices=[CPU] * 4, device="cpu",
                     **BASE_KW, **PAGED_KW)
    ref = JMeshEngine(model_path, dp=2, tp=2, batch_size=2, **J_BASE_KW, **PAGED_KW)
    assert eng.mesh.shape == {"dp": 2, "tp": 2, "sp": 1} and eng._kv_paged
    assert isinstance(eng._cache, pmesh.ShardedRing)
    for p in PROMPTS:
        got, want = _serial(eng, p), _serial(ref, p)
        assert _text(got) == _text(want)
        assert got["lfkt_timings"]["prefix_reused_tokens"] == 0
    cycles = [[_text(e.create_chat_completions([p], temperature=0.0, max_tokens=8)[0])
               for p in PROMPTS] for e in (eng, ref)]
    assert cycles[0] == cycles[1]
    msgs = _convo()
    t1 = [_serial(e, msgs) for e in (eng, ref)]
    t2 = [_serial(e, _turn2(msgs, _text(t1[0]))) for e in (eng, ref)]
    assert _text(t1[0]) == _text(t1[1]) and _text(t2[0]) == _text(t2[1])
    reused = [t["lfkt_timings"]["prefix_reused_tokens"] for t in t2]
    assert reused[0] == reused[1] > 0
    assert eng._kvpool.stats()["hits"] >= 1
    assert eng._kvpool.occupancy()["pages_pinned"] == 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_continuous_tp_paged_reuses_as_one_device_and_the_reference(model_path, kv_dtype):
    """Port ``ContinuousEngine(tp=2)`` over ``[cpu] * 4`` under paging: a
    two-turn conversation resumes from its pages, a second conversation
    reuses the shared system prompt; reuse and replies equal the port's
    one-device paged engine's and the JAX ``ContinuousEngine(dp=2, tp=2)``'s,
    and the pages the tp engine commits are the one-device engine's."""
    kw = dict(batch_size=2, kv_dtype=kv_dtype, **BASE_KW, **PAGED_KW)
    eng = ContinuousEngine(model_path, tp=2, devices=[CPU] * 4, device="cpu", **kw)
    one = ContinuousEngine(model_path, device="cpu", **kw)
    ref = JContinuousEngine(model_path, dp=2, tp=2, **{**kw, "prefill_overlap": 2})
    try:
        assert eng.mesh.shape == {"dp": 2, "tp": 2, "sp": 1}
        assert isinstance(eng._scratch_cache, pmesh.ShardedRing)
        msgs = _convo()
        t1 = [_submit(e, msgs) for e in (eng, one, ref)]
        assert len({_text(t) for t in t1}) == 1
        follow = _turn2(msgs, _text(t1[0]))
        t2 = [_submit(e, follow) for e in (eng, one, ref)]
        assert len({_text(t) for t in t2}) == 1
        reused = {t["lfkt_timings"]["prefix_reused_tokens"] for t in t2}
        assert len(reused) == 1 and reused.pop() > 0
        other = [msgs[0], {"role": "user", "content": "A different question, please."}]
        t3 = [_submit(e, other) for e in (eng, one, ref)]
        assert len({_text(t) for t in t3}) == 1
        assert t3[0]["lfkt_timings"]["prefix_reused_tokens"] > 0
        assert eng._kvpool.stats() == one._kvpool.stats()
        ids = eng.tokenize_messages(msgs)
        n = (len(ids) // 16) * 16
        assert _equal(_pages(eng._kvpool, ids, n), _pages(one._kvpool, ids, n))
        assert eng._kvpool.occupancy()["pages_pinned"] == 0
    finally:
        for e in (eng, one, ref):
            e.shutdown()


# ---------------------------------------------------------------------------
# pages cross the wire unchanged
# ---------------------------------------------------------------------------

#: long enough that its whole-page prefix clears the serial paged reuse at
#: 16-token pages and buckets (64, 128)
MSG_A = ("The quick brown fox jumps over the lazy dog near the old riverbank while "
         "autumn leaves drift slowly down, and then some more words to pad this out "
         "nicely ok.")
WIRE_KW = dict(n_ctx=256, prefill_buckets=(64, 128), max_gen_tokens=8, decode_chunk=4,
               kv_paged=True, kv_page_tokens=16)


def _wire_engine(path, tp: int):
    if tp == 1:
        return Engine(path, device="cpu", **WIRE_KW)
    return MeshEngine(path, tp=tp, batch_size=1, devices=[CPU] * tp, device="cpu", **WIRE_KW)


def _greedy(eng, text=MSG_A):
    return eng.create_chat_completion([{"role": "user", "content": text}], temperature=0.0)


@pytest.mark.parametrize("direction", ["tp_to_one", "one_to_tp"])
def test_pages_cross_the_disagg_wire_between_tp_and_one_device(model_path, direction):
    """A decode engine fed over the unchanged disagg wire by a prefill
    engine of the other kind (tp = 2 ↔ one device) imports byte-equal pages
    and replies as a local radix hit of the same pages."""
    tps = (2, 1) if direction == "tp_to_one" else (1, 2)
    local = _wire_engine(model_path, tps[1])
    cold = _text(_greedy(local))
    hit = _greedy(local)
    assert hit["lfkt_timings"]["prefix_reused_tokens"] > 0
    eng_p, eng_d = _wire_engine(model_path, tps[0]), _wire_engine(model_path, tps[1])
    srv = PrefillServer(eng_p, host="127.0.0.1", port=0)
    cli = DisaggClient(f"127.0.0.1:{srv.port}", eng_d._kvpool, timeout_s=60.0)
    eng_d.install_disagg(cli)
    try:
        out = _greedy(eng_d)
        assert _text(out) == _text(hit) == cold
        assert out["lfkt_timings"]["prefix_reused_tokens"] == \
            hit["lfkt_timings"]["prefix_reused_tokens"]
        assert cli.counters["remote_prefills"] == 1
        ids = eng_d.tokenize_messages([{"role": "user", "content": MSG_A}])
        n = cli.counters["remote_tokens"]
        assert n > 0
        sent = _pages(eng_p._kvpool, ids, n)
        assert _equal(_pages(eng_d._kvpool, ids, n), sent)
        assert _equal(_pages(local._kvpool, ids, n), sent)
    finally:
        cli.close()
        srv.stop()


def test_a_migration_pull_from_a_tp_engines_pool_serves_the_same_reply(model_path):
    """A one-device engine pulls a tp = 2 engine's warm pages through the
    migration page service and answers as the tp engine's local hit."""
    src, dst = _wire_engine(model_path, 2), _wire_engine(model_path, 1)
    want = _text(_greedy(src))
    assert _greedy(src)["lfkt_timings"]["prefix_reused_tokens"] > 0
    server = MigrationServer(src._kvpool, host="127.0.0.1", port=0)
    mgr = MigrationManager(dst._kvpool, Settings(migrate_timeout_seconds=30.0), server=None)
    try:
        ids = src.tokenize_messages([{"role": "user", "content": MSG_A}])
        got = mgr.pull(f"127.0.0.1:{server.port}", ids)
        assert got > 0 and got % 16 == 0
        assert _equal(_pages(dst._kvpool, ids, got), _pages(src._kvpool, ids, got))
        out = _greedy(dst)
        assert out["lfkt_timings"]["prefix_reused_tokens"] == got
        assert _text(out) == want
    finally:
        mgr.close()
        server.stop()


def test_a_registry_with_a_tp_engine_shares_one_arena(model_path, tmp_path):
    """Two models of one geometry, one served over tp = 2: both engines
    join one arena (namespaces keep their prefixes apart) and each replies
    as it does alone."""
    path_b = str(tmp_path / "b.gguf")
    write_tiny_llama_gguf(path_b, cfg=JModelConfig(**{**TINY_CFG.__dict__, "n_ctx": 512}),
                          seed=7)
    alone = {"alpha": _text(_greedy(_wire_engine(model_path, 1))),
             "beta": _text(_greedy(_wire_engine(path_b, 2)))}

    def build(spec, path, shared_pool):
        tp = 2 if spec.name == "beta" else 1
        kw = dict(WIRE_KW, kv_pool=shared_pool, kv_namespace=spec.name)
        if tp == 1:
            return Engine(path, device="cpu", **kw)
        return MeshEngine(path, tp=2, batch_size=1, devices=[CPU] * 2, device="cpu", **kw)

    specs = parse_manifest(f"alpha={model_path},beta={path_b}")
    reg = ModelRegistry.from_specs(specs, build, default_model="alpha",
                                   model_dir=str(tmp_path))
    try:
        a, b = reg.resolve("alpha"), reg.resolve("beta")
        assert b.mesh is not None and a.mesh is None
        assert b._kvpool is a._kvpool and len(reg._pools()) == 1
        for step, model in enumerate(("alpha", "beta", "alpha", "beta")):
            out = reg.create_chat_completion([{"role": "user", "content": MSG_A}],
                                             temperature=0.0, model=model)
            assert _text(out) == alone[model], step
            if step == 1:
                assert a._kvpool.stats()["hits"] == 0
                assert a._kvpool.occupancy()["namespaces"] == 2
        assert a._kvpool.stats()["hits"] == 2
    finally:
        reg.shutdown()


def test_the_pool_of_a_tp_engine_is_built_on_the_meshs_first_device(model_path):
    eng = MeshEngine(model_path, tp=2, batch_size=1, devices=[CPU] * 2, device="cpu",
                     **WIRE_KW)
    assert eng._kvpool.device == pmesh.ring_device(eng._cache) == CPU
    assert eng._kvpool.compatible(eng.cfg, 16)
    # the arena holds whole-head pages, as a one-device engine's does
    assert eng._kvpool.page_spec() == _wire_engine(model_path, 1)._kvpool.page_spec()

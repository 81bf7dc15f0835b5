"""``kv_paged`` serving (parallel/kvpool.py in the engines) on the CPU, held
to the JAX package's engines.

The cases of ``tests/test_kv_paged_engines.py`` on the tiny Llama: with no
cache hit the paged engines run the dense ring's passes, so greedy
``/response`` bytes equal the dense serial engine's on the serial, mesh
and continuous engines — and the JAX paged engines'.  On top: a
multi-turn follow-up resumes from its pages, a second conversation
sharing the system prompt reuses it (reused tokens equal the JAX
engine's, and the replies too), explicit seeds bypass the index,
``recover`` resets the pool, a traced reuse carries its pages and a
``kv_restore`` event, a failed restore drops the lease and zeroes the
ring in place before it raises, the continuous scheduler reuses across
lanes and takes exhaustion as back-pressure.  Every exit of a lease is
driven: a finished request, an abandoned admission, a failed dispatch
and a raising span setter leave no page pinned.
"""

from __future__ import annotations

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import ContinuousEngine as JContinuousEngine
from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.testing import TINY_CFG, write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine, MeshEngine
from llama_fastapi_k8s_gpu_tpu_torch.obs.trace import Tracer
from llama_fastapi_k8s_gpu_tpu_torch.parallel import kvpool
from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS

torch.set_num_threads(1)
BUCKETS = (32, 64, 128)
#: distinct prompts (only the few-token template header is shared: under a
#: full page, so the index grants them no reuse)
PROMPTS = [
    [{"role": "user", "content": "Say something."}],
    [{"role": "user", "content": "alpha bravo charlie delta echo " * 4}],
    [{"role": "user", "content": "one two three four five six seven " * 8}],
]
#: 16-token pages, a 64-page pool, a 16-page spill tier
PAGED_KW = dict(kv_paged=True, kv_page_tokens=16, kv_pool_pages=64, kv_spill_pages=16,
                prefix_min=16)
BASE_KW = dict(n_ctx=512, decode_chunk=4, max_gen_tokens=16, prefill_buckets=BUCKETS,
               prefill_chunk=16)
J_BASE_KW = dict(BASE_KW, prefill_overlap=2)
T = 120   # seconds any future may take


def _text(r) -> str:
    return r["choices"][0]["message"]["content"]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("paged") / "tiny.gguf")
    write_tiny_llama_gguf(path, cfg=JModelConfig(**{**TINY_CFG.__dict__, "n_ctx": 512}))
    return path


def _texts(eng, prompts=PROMPTS, max_tokens=8, submit=False):
    out = []
    for p in prompts:
        r = (eng.submit(p, temperature=0.0, max_tokens=max_tokens).result(T) if submit
             else eng.create_chat_completion(p, temperature=0.0, max_tokens=max_tokens))
        assert r["lfkt_timings"]["prefix_reused_tokens"] == 0
        out.append(_text(r))
    return out


@pytest.fixture(scope="module")
def dense_texts(model_path):
    """The reference outputs: the port's serial engine, dense ring, no reuse
    — equal to the JAX engine's."""
    texts = _texts(Engine(model_path, prefix_cache=False, device="cpu", **BASE_KW))
    assert texts == _texts(JEngine(model_path, prefix_cache=False, **J_BASE_KW))
    return texts


def _convo(turn2: str = "And another one."):
    msgs = [{"role": "system", "content": "You answer carefully. " * 8},
            {"role": "user", "content": "Tell me something interesting."}]
    return msgs, turn2


def _turn2(msgs, reply, turn2):
    return msgs + [{"role": "assistant", "content": reply}, {"role": "user", "content": turn2}]


def _pinned(eng) -> int:
    return eng._kvpool.occupancy()["pages_pinned"]


# ---------------------------------------------------------------------------
# paged against dense and against the JAX engines, greedy bytes
# ---------------------------------------------------------------------------

def test_serial_paged_matches_dense_and_the_reference(model_path, dense_texts):
    eng = Engine(model_path, device="cpu", **BASE_KW, **PAGED_KW)
    ref = JEngine(model_path, **J_BASE_KW, **PAGED_KW)
    assert eng._kv_paged and eng._prefix_cache is False
    assert _texts(eng) == dense_texts == _texts(ref)
    assert eng._kvpool.stats() == ref._kvpool.stats()
    assert eng._kvpool.stats()["stored_pages"] > 0
    assert eng.kv_cache_bytes == ref.kv_cache_bytes


def test_mesh_paged_matches_dense(model_path, dense_texts):
    """MeshEngine under paging: its serial path consults the index, its
    cycles keep their lane rings; both greedy-equal to the dense serial
    engine."""
    eng = MeshEngine(model_path, batch_size=2, device="cpu", **BASE_KW, **PAGED_KW)
    assert eng._kv_paged
    assert _texts(eng) == dense_texts
    got = [_text(eng.create_chat_completions([p], temperature=0.0, max_tokens=8)[0])
           for p in PROMPTS]
    assert got == dense_texts


def test_continuous_paged_matches_dense(model_path, dense_texts):
    eng = ContinuousEngine(model_path, batch_size=2, device="cpu", **BASE_KW, **PAGED_KW)
    try:
        assert eng._lane_prefix is False and eng._paged_align == 16
        assert _texts(eng, submit=True) == dense_texts
        assert _pinned(eng) == 0
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# radix reuse (serial), each against the JAX paged engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paged_pair(model_path):
    return (Engine(model_path, device="cpu", **BASE_KW, **PAGED_KW),
            JEngine(model_path, **J_BASE_KW, **PAGED_KW))


def _both(pair, msgs, **kw):
    got = [e.create_chat_completion(msgs, temperature=0.0, max_tokens=8, **kw) for e in pair]
    assert _text(got[0]) == _text(got[1])
    assert (got[0]["lfkt_timings"]["prefix_reused_tokens"]
            == got[1]["lfkt_timings"]["prefix_reused_tokens"])
    return got[0]


def test_serial_multi_turn_resumes_from_pages(paged_pair):
    eng = paged_pair[0]
    msgs, turn2 = _convo()
    t1 = _both(paged_pair, msgs)
    assert t1["lfkt_timings"]["prefix_reused_tokens"] == 0
    t2 = _both(paged_pair, _turn2(msgs, _text(t1), turn2))
    reused = t2["lfkt_timings"]["prefix_reused_tokens"]
    assert reused > 0 and reused % eng._kvpool.page_tokens == 0
    assert eng._kvpool.stats()["hits"] >= 1 and _pinned(eng) == 0


def test_shared_system_prompt_across_conversations(paged_pair):
    sys_msg = {"role": "system", "content": "Be brief and precise. " * 10}
    ra = _both(paged_pair, [sys_msg, {"role": "user", "content": "First question here."}])
    rb = _both(paged_pair, [sys_msg, {"role": "user", "content": "Unrelated other ask."}])
    assert ra["lfkt_timings"]["prefix_reused_tokens"] == 0
    assert rb["lfkt_timings"]["prefix_reused_tokens"] > 0


def test_explicit_seed_bypasses_radix(paged_pair):
    msgs = [{"role": "user", "content": "Deterministic seeds please. " * 6}]
    r1 = _both(paged_pair, msgs, seed=7)
    r2 = _both(paged_pair, msgs, seed=7)
    assert r1["lfkt_timings"]["prefix_reused_tokens"] == 0
    assert r2["lfkt_timings"]["prefix_reused_tokens"] == 0
    assert _text(r1) == _text(r2)


def test_paged_prefill_span_attribution(paged_pair):
    eng = paged_pair[0]
    msgs = [{"role": "system", "content": "Trace me carefully now. " * 10},
            {"role": "user", "content": "warm the cache"}]
    eng.create_chat_completion(msgs, temperature=0.0, max_tokens=8)
    tracer = Tracer(sample=1.0, ring=4)
    tr = tracer.start()
    r = eng.create_chat_completion([msgs[0], {"role": "user", "content": "different follow-up"}],
                                   temperature=0.0, max_tokens=8, trace=tr)
    tracer.finish(tr)
    assert r["lfkt_timings"]["prefix_reused_tokens"] > 0
    stack, prefill = [tr.to_dict()["root"]], None
    while stack:
        s = stack.pop()
        if s["name"] == "prefill":
            prefill = s
        stack.extend(s["children"])
    assert prefill["attrs"]["reused"] > 0 and prefill["attrs"]["reused_pages"] >= 1
    assert prefill["attrs"]["matched_tokens"] >= prefill["attrs"]["reused"]
    assert "kv_restore" in [e["name"] for e in prefill["events"]]


def test_recover_resets_pool(paged_pair):
    eng = paged_pair[0]
    assert eng._kvpool.occupancy()["pages_used"] > 0
    ring = {k: v.data_ptr() for k, v in eng._cache.items()}
    assert eng.recover()
    occ = eng._kvpool.occupancy()
    assert occ["pages_used"] == 0 and occ["pages_pinned"] == 0
    assert {k: v.data_ptr() for k, v in eng._cache.items()} == ring


def test_serial_restore_failure_zeroes_the_ring_and_releases(model_path, monkeypatch):
    """A failed copy into the ring: the lease released, the ring zeroed in
    place (its storage kept: the graphs hold it), the request raises; the
    next request serves and reuses normally."""
    eng = Engine(model_path, device="cpu", **BASE_KW, **PAGED_KW)
    msgs, turn2 = _convo()
    t1 = eng.create_chat_completion(msgs, temperature=0.0, max_tokens=8)
    msgs2 = _turn2(msgs, _text(t1), turn2)
    ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}

    def boom(*_a, **_k):
        raise RuntimeError("injected restore failure")

    monkeypatch.setattr(kvpool, "_restore_pages", boom)
    with pytest.raises(RuntimeError, match="injected restore"):
        eng.create_chat_completion(msgs2, temperature=0.0, max_tokens=8)
    assert _pinned(eng) == 0 and eng._paged_lease is None
    assert all(not bool(v.any()) for v in eng._cache.values())
    assert {k: v.data_ptr() for k, v in eng._cache.items()} == ptrs
    monkeypatch.undo()
    r = eng.create_chat_completion(msgs2, temperature=0.0, max_tokens=8)
    assert _text(r) and r["lfkt_timings"]["prefix_reused_tokens"] > 0
    assert _pinned(eng) == 0


def test_a_failed_decode_releases_the_lease(model_path):
    eng = Engine(model_path, device="cpu", **BASE_KW, **PAGED_KW)
    msgs, turn2 = _convo()
    t1 = eng.create_chat_completion(msgs, temperature=0.0, max_tokens=8)
    FAULTS.arm("decode_step:error:times=1")
    try:
        with pytest.raises(Exception):
            eng.create_chat_completion(_turn2(msgs, _text(t1), turn2), temperature=0.0,
                                       max_tokens=8)
    finally:
        FAULTS.disarm()
    assert _pinned(eng) == 0 and eng._paged_lease is None


def test_paged_int8_ring_matches_the_reference(model_path):
    """The int8 ring's four leaves through the pool: the follow-up's reuse
    and reply equal the JAX int8 paged engine's."""
    pair = (Engine(model_path, device="cpu", kv_dtype="int8", **BASE_KW, **PAGED_KW),
            JEngine(model_path, kv_dtype="int8", **J_BASE_KW, **PAGED_KW))
    msgs, turn2 = _convo()
    t1 = _both(pair, msgs)
    t2 = _both(pair, _turn2(msgs, _text(t1), turn2))
    assert t2["lfkt_timings"]["prefix_reused_tokens"] > 0
    assert pair[0]._kvpool.stats() == pair[1]._kvpool.stats()


def test_spec_and_pool_gating_in_the_constructor(model_path):
    """Speculation turns off the paged pool and the serial claim, as in the
    reference; the pool knobs are validated by the pool."""
    eng = Engine(model_path, device="cpu", spec_decode="lookup", spec_draft=4,
                 **BASE_KW, **PAGED_KW)
    assert eng._spec_draft == 4 and not eng._kv_paged and eng._kvpool is None
    assert not eng._prefix_cache
    with pytest.raises(ValueError):
        Engine(model_path, device="cpu", **{**BASE_KW, **PAGED_KW, "kv_page_tokens": 512})


# ---------------------------------------------------------------------------
# the continuous scheduler
# ---------------------------------------------------------------------------

def test_continuous_cross_lane_reuse_and_exhaustion(model_path):
    kw = dict(PAGED_KW, kv_pool_pages=4, kv_spill_pages=0)
    eng = ContinuousEngine(model_path, batch_size=2, device="cpu", **BASE_KW, **kw)
    ref = JContinuousEngine(model_path, dp=1, tp=1, batch_size=2, **J_BASE_KW, **kw)
    try:
        msgs, turn2 = _convo()
        r1 = [e.submit(msgs, temperature=0.0, max_tokens=8).result(T) for e in (eng, ref)]
        assert _text(r1[0]) == _text(r1[1])
        msgs2 = _turn2(msgs, _text(r1[0]), turn2)
        r2 = [e.submit(msgs2, temperature=0.0, max_tokens=8).result(T) for e in (eng, ref)]
        assert _text(r2[0]) == _text(r2[1])
        reused = [r["lfkt_timings"]["prefix_reused_tokens"] for r in r2]
        assert reused[0] == reused[1] > 0
        sstats = eng.scheduler_stats()
        assert sstats["radix_prefix_hits"] >= 1 and "lane_prefix_hits" not in sstats
        assert {k: v for k, v in sstats.items() if k.startswith("radix_")} == {
            k: v for k, v in ref.scheduler_stats().items() if k.startswith("radix_")}
        futs = [eng.submit([{"role": "user", "content": f"burst number {i} " * 6}],
                           temperature=0.0, max_tokens=8) for i in range(6)]
        for f in futs:
            assert _text(f.result(T))
        stats = eng._kvpool.stats()
        assert stats["store_skips"] + stats["evictions"] > 0
        assert _pinned(eng) == 0
    finally:
        eng.shutdown()
        ref.shutdown()


@pytest.fixture
def paged_lanes(model_path):
    eng = ContinuousEngine(model_path, batch_size=2, device="cpu", **BASE_KW, **PAGED_KW)
    msgs, _ = _convo()
    eng.submit(msgs, temperature=0.0, max_tokens=8).result(T)
    yield eng, msgs
    FAULTS.disarm()
    eng.shutdown()


def test_continuous_reuse_survives_poisoned_span(paged_lanes):
    eng, msgs = paged_lanes
    ids = eng.tokenize_messages(msgs)
    assert eng._kvpool.match_len(ids) >= eng._paged_align

    class PoisonedSpan:
        def set(self, **kw):
            raise RuntimeError("poisoned span setter")

    r, lease = eng._paged_admission_reuse(ids, PoisonedSpan())
    assert r > 0 and lease is not None
    eng._kvpool.release(lease)
    assert _pinned(eng) == 0


def test_continuous_abandoned_admission_releases(paged_lanes):
    """An admission abandoned mid-prefill gives its lease back (driven by
    hand on a stopped scheduler, so the abandon lands between slices)."""
    from concurrent.futures import CancelledError, Future

    from llama_fastapi_k8s_gpu_tpu_torch.engine.continuous import _Item
    from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import SamplingParams

    eng, msgs = paged_lanes
    eng.shutdown()
    item = _Item(Future(), _turn2(msgs, "x " * 40, "and then?"), SamplingParams(), 8, [], None)
    adm = eng._begin_admission(item)
    assert adm["lease"] is not None and adm["reused"] > 0 and _pinned(eng) > 0
    eng._adm = adm
    slots = [None] * eng.batch_size
    assert eng._admit_step(slots) > 0 and eng._adm is adm      # one slice, not done
    item.abandoned.set()
    assert eng._admit_step(slots) == 0 and eng._adm is None
    assert _pinned(eng) == 0 and "lease" not in adm
    assert isinstance(item.future.exception(timeout=0), CancelledError)


def test_continuous_failed_dispatch_releases(paged_lanes):
    """A prefill slice that raises after the restore: that request fails
    alone, its pages unpinned, the next one served."""
    eng, msgs = paged_lanes
    FAULTS.arm("prefill:error:times=1")
    with pytest.raises(Exception):
        eng.submit(msgs, temperature=0.0, max_tokens=8).result(T)
    FAULTS.disarm()
    assert _pinned(eng) == 0
    r = eng.submit(msgs, temperature=0.0, max_tokens=8).result(T)
    assert r["lfkt_timings"]["prefix_reused_tokens"] > 0 and _pinned(eng) == 0


def test_continuous_restore_failure_fails_the_request_alone(paged_lanes, monkeypatch):
    eng, msgs = paged_lanes

    def boom(*_a, **_k):
        raise RuntimeError("injected restore failure")

    monkeypatch.setattr(kvpool, "_restore_pages", boom)
    with pytest.raises(RuntimeError, match="injected restore"):
        eng.submit(msgs, temperature=0.0, max_tokens=8).result(T)
    assert _pinned(eng) == 0
    assert all(not bool(v.any()) for v in eng._scratch_cache.values())
    monkeypatch.undo()
    assert _text(eng.submit(msgs, temperature=0.0, max_tokens=8).result(T))
    assert _pinned(eng) == 0


def test_continuous_recover_resets_pool(paged_lanes):
    eng, _ = paged_lanes
    assert eng._kvpool.occupancy()["pages_used"] > 0
    eng.shutdown()
    eng._shutdown = False          # a dead scheduler, not a deliberate stop
    eng._loop_error = RuntimeError("died")
    assert eng.recover()
    occ = eng._kvpool.occupancy()
    assert occ["pages_used"] == 0 and occ["pages_pinned"] == 0

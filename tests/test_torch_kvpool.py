"""The port's paged KV pool (parallel/kvpool.py) against the JAX package's.

Every case of ``tests/test_kvpool.py`` runs here on a twin: one tiny
config, the same operation sequence on the JAX ``KVPool`` and on the
port's (on the CPU), and after every operation the same results (page
ids, leases, match lengths, stored counts), the same ``counters``,
``occupancy()``, ``hot_prefixes()``, free list, refcounts and spill
tier, and arenas equal bit for bit (bf16 as its 16-bit words, int8 and
f32 as they are).  Restored rings are compared with each other and with
the source ring, bit for bit.  Then what only the port has: restores in
place (the ring's storage never rebound), lane commits, namespaces drained
one at a time, the memory-ledger rows against a tree walk, and an import
racing commits and acquires on its own threads.
"""

from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.models.config import ModelConfig as JModelConfig
from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
from llama_fastapi_k8s_gpu_tpu.parallel import kvpool as jkvpool
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import init_cache
from llama_fastapi_k8s_gpu_tpu_torch.parallel import kvpool

DIMS = dict(vocab_size=263, dim=16, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=32, n_ctx=64)
T = 8   # page size throughout (8 tokens a page, 8 pages a full ring)
CPU = torch.device("cpu")


def _cfgs(kv_dtype: str = "bf16", n_ctx: int = 64):
    kw = {**DIMS, "n_ctx": n_ctx, "kv_dtype": kv_dtype}
    return JModelConfig(**kw), ModelConfig(**kw)


def _bits(x) -> np.ndarray:
    """A leaf's bits as numpy (bf16 as int16 words)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def marked(cfg: ModelConfig, base: float = 100.0) -> dict:
    """The reference test's marked ring as numpy (float32 values before the
    leaf's cast): every token slot recognizable (base + position, int8
    leaves position % 100)."""
    ring = init_cache(cfg, torch.device("meta"))
    out = {}
    for i, (k, v) in enumerate(sorted(ring.items())):
        pos = np.arange(cfg.n_ctx, dtype=np.float32).reshape((1, 1, cfg.n_ctx) + (1,) * (v.dim() - 3))
        if v.dtype == torch.int8:
            out[k] = np.broadcast_to(pos % 100, tuple(v.shape)).astype(np.int8)
        else:
            out[k] = np.broadcast_to(pos + base + 10 * i, tuple(v.shape)).astype(np.float32)
    return out


def j_ring(npring: dict, cfg: JModelConfig) -> dict:
    ref = j_init_cache(cfg)
    return {k: jnp.asarray(v).astype(ref[k].dtype) for k, v in npring.items()}


def p_ring(npring: dict, cfg: ModelConfig) -> dict:
    ref = init_cache(cfg, torch.device("meta"))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(ref[k].dtype)
            for k, v in npring.items()}


class Twin:
    """A JAX pool and a port pool fed the same operations."""

    def __init__(self, kv_dtype: str = "bf16", n_ctx: int = 64, sink_host=None, **kw):
        self.jcfg, self.cfg = _cfgs(kv_dtype, n_ctx)
        self.j = jkvpool.KVPool(self.jcfg, page_tokens=T, sink_host=sink_host, **kw)
        self.p = kvpool.KVPool(self.cfg, page_tokens=T, sink_host=sink_host, device=CPU, **kw)
        self.np_ring = marked(self.cfg)
        self.jring, self.pring = j_ring(self.np_ring, self.jcfg), p_ring(self.np_ring, self.cfg)

    def check(self) -> None:
        """Both pools in the same state, arenas bit for bit."""
        j, p = self.j, self.p
        assert p.counters == j.counters
        assert p.occupancy() == j.occupancy()
        assert p.hot_prefixes(64) == j.hot_prefixes(64)
        assert p._free == j._free and p._page_refs == j._page_refs
        assert p._spill_used == j._spill_used and p._ns_pages == j._ns_pages
        for name, leaf in p.arena.items():
            assert np.array_equal(_bits(leaf), _bits(j.arena[name])), name

    def commit(self, ids, **kw) -> int:
        a = self.j.commit(ids, self.jring, **kw)
        b = self.p.commit(ids, self.pring, **kw)
        assert a == b
        self.check()
        return b

    def match_len(self, ids, **kw) -> int:
        a, b = self.j.match_len(ids, **kw), self.p.match_len(ids, **kw)
        assert a == b
        return b

    def acquire(self, ids, tokens, **kw):
        a, b = self.j.acquire(ids, tokens, **kw), self.p.acquire(ids, tokens, **kw)
        assert (a is None) == (b is None)
        if b is not None:
            assert (a.tokens, a.page_ids) == (b.tokens, b.page_ids)
        self.check()
        return (a, b) if b is not None else None

    def release(self, lease) -> None:
        if lease is not None:
            self.j.release(lease[0])
            self.p.release(lease[1])
        self.check()

    def restore(self, lease, tokens: int) -> None:
        """Restore into fresh rings on both sides: equal to each other and
        to the source ring over ``tokens`` slots."""
        jout = self.j.restore(lease[0], j_init_cache(self.jcfg))
        pout = init_cache(self.cfg, CPU)
        assert self.p.restore(lease[1], pout) is pout
        for k in self.np_ring:
            got = _bits(pout[k])[:, :, :tokens]
            assert np.array_equal(got, _bits(jout[k])[:, :, :tokens]), k
            assert np.array_equal(got, _bits(self.pring[k])[:, :, :tokens]), k

    def both(self, fn) -> None:
        """``fn(pool)`` on both pools, under each one's lock (white-box)."""
        for pool in (self.j, self.p):
            with pool._lock:
                fn(pool)
        self.check()


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_commit_acquire_restore_round_trip_bitwise(kv_dtype):
    tw = Twin(kv_dtype, n_pages=8)
    ids = list(range(1, 25))                       # 3 full pages
    assert tw.commit(ids) == 3
    assert tw.match_len(ids) == 24
    lease = tw.acquire(ids, 16)
    assert lease is not None and lease[1].tokens == 16
    tw.restore(lease, 16)
    tw.release(lease)
    assert tw.p.occupancy()["pages_pinned"] == 0


def test_multi_group_dispatch_round_trip():
    """More pages than the reference's copy group: the port's runs of page
    ids tile the copy without gaps or reordering."""
    tw = Twin(n_ctx=128, n_pages=jkvpool._GROUP * 2 + 4)
    n_tok = (jkvpool._GROUP + 3) * T
    ids = list(range(1, n_tok + 1))
    assert tw.commit(ids) == jkvpool._GROUP + 3
    lease = tw.acquire(ids + [999], n_tok)
    assert lease is not None
    tw.restore(lease, n_tok)
    tw.release(lease)


def test_commit_dedupes_and_extends():
    tw = Twin(n_pages=8)
    ids = list(range(1, 17))
    assert tw.commit(ids) == 2
    assert tw.commit(ids) == 0
    longer = ids + list(range(30, 38))
    assert tw.commit(longer) == 1
    assert tw.match_len(longer) == 24


# ---------------------------------------------------------------------------
# radix structure
# ---------------------------------------------------------------------------

def test_match_is_page_granular():
    tw = Twin(n_pages=8)
    ids = list(range(1, 17))
    tw.commit(ids)
    assert tw.match_len(ids[:12]) == T
    assert tw.match_len(ids[:6]) == 0
    assert tw.match_len(ids[:10] + [77, 78, 79, 80, 81, 82]) == T


def test_radix_split_on_divergence():
    tw = Twin(n_pages=8)
    a = list(range(1, 25))
    b = list(range(1, 17)) + list(range(50, 58))
    assert tw.commit(a) == 3
    assert tw.commit(b) == 1
    assert tw.match_len(a) == 24 and tw.match_len(b) == 24
    for pool in (tw.j, tw.p):
        children = list(pool._root.children.values())
        assert len(children) == 1 and len(children[0].edge) == 2
        assert len(children[0].children) == 2
    lease = tw.acquire(b + [999], 24)
    tw.restore(lease, 16)
    tw.release(lease)


# ---------------------------------------------------------------------------
# refcounts, LRU eviction, spill tier
# ---------------------------------------------------------------------------

def test_pinned_pages_cannot_be_evicted():
    tw = Twin(n_pages=4)
    a = list(range(1, 17))
    tw.commit(a)
    lease = tw.acquire(a + [999], 16)
    assert tw.p.occupancy()["pages_pinned"] == 2
    assert tw.commit([100 + i for i in range(32)]) == 2
    assert tw.commit([200 + i for i in range(16)]) == 2
    assert tw.p.counters["evictions"] >= 1
    tw.restore(lease, 16)
    tw.release(lease)


def test_lru_eviction_discards_without_spill():
    tw = Twin(n_pages=4, spill_pages=0)
    a, b = list(range(1, 17)), list(range(100, 116))
    tw.commit(a)
    tw.commit(b)
    assert tw.match_len(b) == 16
    tw.release(tw.acquire(b + [999], 16))
    tw.commit([200 + i for i in range(16)])
    assert tw.p.counters["evictions"] >= 1 and tw.p.counters["spills"] == 0
    assert tw.match_len(a) == 0 and tw.match_len(b) == 16


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spill_and_restore_round_trip_bitwise(kv_dtype):
    tw = Twin(kv_dtype, n_pages=4, spill_pages=8)
    a = list(range(1, 17))
    tw.commit(a)
    tw.commit([100 + i for i in range(16)])
    tw.commit([200 + i for i in range(16)])
    assert tw.p.counters["spills"] >= 1
    assert tw.match_len(a) == 16
    assert tw.p.occupancy()["spill_pages_used"] >= 2
    lease = tw.acquire(a + [999], 16)
    assert lease is not None and tw.p.counters["restores"] >= 1
    tw.restore(lease, 16)
    tw.release(lease)
    before = tw.p.counters["restores"]
    lease2 = tw.acquire(a + [999], 16)
    assert lease2 is not None and tw.p.counters["restores"] == before
    tw.release(lease2)


def test_spill_tier_ages_lru_when_full():
    tw = Twin(n_pages=4, spill_pages=2)
    for k in range(1, 5):
        tw.commit([100 * k + i for i in range(16)])
    assert tw.p.occupancy()["spill_pages_used"] <= 2


def test_oversized_victim_does_not_drain_spill_tier():
    tw = Twin(n_pages=4, spill_pages=1)
    b, a = list(range(1, 9)), list(range(100, 116))
    tw.commit(b)
    tw.commit(a)
    tw.commit(list(range(200, 216)))
    assert tw.p.occupancy()["spill_pages_used"] == 1
    tw.commit(list(range(300, 332)))
    assert tw.match_len(a) == 0 and tw.match_len(b) == 8
    assert tw.p.occupancy()["spill_pages_used"] == 1


def test_aging_skipped_when_unageable_spill_blocks_fit():
    tw = Twin(n_pages=6, spill_pages=3)
    a = list(range(1, 17))
    ab = a + list(range(50, 58))
    lf = [200 + i for i in range(8)]
    assert tw.commit(a) == 2 and tw.commit(ab) == 1 and tw.commit(lf) == 1

    def stamp_and_spill(pool):
        upper = pool._root.children[tuple(a[:T])]
        child = next(iter(upper.children.values()))
        leafn = pool._root.children[tuple(lf[:T])]
        upper.stamp, leafn.stamp, child.stamp = 1, 2, 3
        pool._clock = 10
        assert pool._evict_one() and upper.pages is None and upper.host is not None
        assert pool._evict_one() and leafn.pages is None
        assert pool._spill_used == 3

    tw.both(stamp_and_spill)
    v = [300 + i for i in range(16)]
    assert tw.commit(v) == 2

    def victim(pool):
        pool._root.children[tuple(v[:T])].stamp = 4
        upper = pool._root.children[tuple(a[:T])]
        next(iter(upper.children.values())).stamp = 9
        assert pool._evict_one()

    tw.both(victim)
    assert tw.match_len(v) == 0 and tw.match_len(lf) == 8
    assert tw.p.occupancy()["spill_pages_used"] == 3


def test_exhaustion_is_backpressure_not_failure():
    tw = Twin(n_pages=2)
    a = list(range(1, 17))
    tw.commit(a)
    lease = tw.acquire(a + [999], 16)
    assert tw.commit([300 + i for i in range(16)]) == 0
    assert tw.acquire([300 + i for i in range(17)], 16) is None
    assert tw.p.counters["misses"] >= 1 and tw.p.counters["store_skips"] >= 1
    tw.release(lease)
    assert tw.commit([300 + i for i in range(16)]) == 2


def test_reset_frees_everything():
    tw = Twin(n_pages=4, spill_pages=4)
    tw.commit(list(range(1, 17)))
    tw.both(lambda pool: None)
    tw.j.reset()
    tw.p.reset()
    tw.check()
    occ = tw.p.occupancy()
    assert occ["pages_free"] == 4 and occ["pages_used"] == 0 and occ["spill_pages_used"] == 0
    assert tw.match_len(list(range(1, 17))) == 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_arena_bytes_and_page_geometry(kv_dtype):
    tw = Twin(kv_dtype, n_pages=4)
    occ = tw.p.occupancy()
    hd = tw.cfg.head_dim
    per_tok_head = 2 * hd if kv_dtype == "bf16" else hd + 4
    assert occ["page_bytes"] == 2 * DIMS["n_layers"] * DIMS["n_kv_heads"] * T * per_tok_head
    assert occ["arena_bytes"] == 4 * occ["page_bytes"] == tw.p.arena_nbytes == tw.j.arena_nbytes
    assert tw.p.page_spec() == tw.j.page_spec()
    for other in ("bf16", "int8"):
        jc, pc = _cfgs(other)
        assert tw.p.compatible(pc) == tw.j.compatible(jc) == (other == kv_dtype)
    assert not tw.p.compatible(tw.cfg, page_tokens=2 * T)


def test_page_tokens_validation():
    _, cfg = _cfgs()
    for bad in (0, cfg.n_ctx):
        with pytest.raises(ValueError):
            kvpool.KVPool(cfg, page_tokens=bad, device=CPU)


def test_metrics_sink_emission():
    class Sink:
        def __init__(self):
            self.incs, self.obs = [], []

        def inc(self, name, value=1.0, **kw):
            self.incs.append(name)

        def observe(self, name, value, **kw):
            self.obs.append((name, value))

    class Host:
        metrics_sink = None

    hosts = [Host(), Host()]
    pools = [jkvpool.KVPool(_cfgs()[0], page_tokens=T, n_pages=2, sink_host=hosts[0]),
             kvpool.KVPool(_cfgs()[1], page_tokens=T, n_pages=2, sink_host=hosts[1], device=CPU)]
    rings = [j_ring(marked(_cfgs()[1]), _cfgs()[0]), p_ring(marked(_cfgs()[1]), _cfgs()[1])]
    for pool, host, ring in zip(pools, hosts, rings):
        pool.commit(list(range(1, 17)), ring)
        pool.note_miss()
        host.metrics_sink = Sink()
        pool.note_miss()
        pool.release(pool.acquire(list(range(1, 18)), 16))
        pool.commit([300 + i for i in range(16)], ring)
    assert hosts[0].metrics_sink.incs == hosts[1].metrics_sink.incs
    assert hosts[0].metrics_sink.obs == hosts[1].metrics_sink.obs
    assert {"prefix_cache_misses_total", "prefix_cache_evictions_total"} <= set(
        hosts[1].metrics_sink.incs)
    assert ("prefix_reuse_tokens", 16) in hosts[1].metrics_sink.obs


# ---------------------------------------------------------------------------
# error paths: a failed copy never leaks pages or pins
# ---------------------------------------------------------------------------

def _boom(*_a, **_k):
    raise RuntimeError("injected page-copy failure")


def _spill_child(tw: Twin, a, ab) -> None:
    assert tw.commit(a) == 2 and tw.commit(ab) == 1

    def spill(pool):
        upper = pool._root.children[tuple(a[:T])]
        child = next(iter(upper.children.values()))
        child.stamp, upper.stamp = 1, 5
        pool._clock = 10
        assert pool._evict_one() and child.pages is None and child.host is not None

    tw.both(spill)


def test_store_failure_skips_commit_and_frees_pages(monkeypatch):
    tw = Twin(n_pages=8)
    free0 = tw.p.occupancy()["pages_free"]
    monkeypatch.setattr(jkvpool, "_store_pages_jit", _boom)
    monkeypatch.setattr(kvpool, "_store_pages", _boom)
    assert tw.commit(list(range(1, 17))) == 0
    assert tw.p.counters["store_skips"] == 1 and tw.p.occupancy()["pages_free"] == free0
    monkeypatch.undo()
    assert tw.commit(list(range(1, 17))) == 2


def test_spill_restore_failure_degrades_to_miss_without_leaks(monkeypatch):
    tw = Twin(n_pages=8, spill_pages=4)
    a = list(range(1, 17))
    ab = a + list(range(50, 58))
    _spill_child(tw, a, ab)
    free0, misses0 = tw.p.occupancy()["pages_free"], tw.p.counters["misses"]
    monkeypatch.setattr(jkvpool, "_upload_pages_jit", _boom)
    monkeypatch.setattr(kvpool, "_upload_pages", _boom)
    assert tw.acquire(ab, 24) is None
    occ = tw.p.occupancy()
    assert occ["pages_pinned"] == 0 and occ["pages_free"] == free0
    assert tw.p.counters["misses"] == misses0 + 1
    monkeypatch.undo()
    lease = tw.acquire(ab, 24)
    assert lease is not None and lease[1].tokens == 24
    tw.restore(lease, 24)
    tw.release(lease)


def test_acquire_walk_exception_unpins(monkeypatch):
    tw = Twin(n_pages=8, spill_pages=4)
    a = list(range(1, 17))
    ab = a + list(range(50, 58))
    _spill_child(tw, a, ab)
    monkeypatch.setattr(jkvpool.KVPool, "_restore_node", _boom)
    monkeypatch.setattr(kvpool.KVPool, "_restore_node", _boom)
    assert tw.acquire(ab, 24) is None
    assert tw.p.occupancy()["pages_pinned"] == 0


def test_restore_failure_raises(monkeypatch):
    """A failed copy into the ring raises (the engine owns the ring's
    recovery); the lease stays the caller's to release."""
    tw = Twin(n_pages=8)
    ids = list(range(1, 17))
    tw.commit(ids)
    lease = tw.acquire(ids + [1], 16)
    monkeypatch.setattr(kvpool, "_restore_pages", _boom)
    with pytest.raises(RuntimeError, match="injected"):
        tw.p.restore(lease[1], init_cache(tw.cfg, CPU))
    tw.release(lease)
    assert tw.p.occupancy()["pages_pinned"] == 0


# ---------------------------------------------------------------------------
# export / import, namespaces, hot prefixes
# ---------------------------------------------------------------------------

def _exported(pool, ids, tokens):
    lease = pool.acquire(ids, tokens)
    try:
        return pool.export_pages(lease)
    finally:
        pool.release(lease)


def test_export_import_round_trip_bitwise():
    src, dst = Twin(n_pages=8), Twin(n_pages=8)
    ids = list(range(1, 25))
    assert src.commit(ids) == 3
    jl, pl = _exported(src.j, ids, 24), _exported(src.p, ids, 24)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert np.array_equal(_bits(a), _bits(b))
    for _ in range(2):   # the second import deduplicates
        assert dst.j.import_pages(ids, jl, namespace="m") == 24
        assert dst.p.import_pages(ids, pl, namespace="m") == 24
        dst.check()
        assert dst.p.counters["imported_pages"] == 3
    lease = dst.acquire(ids, 24, namespace="m")
    dst.restore(lease, 24)
    dst.release(lease)


def test_import_pages_geometry_mismatch_raises():
    src, dst = Twin(n_pages=8), Twin(n_pages=8)
    ids = list(range(1, 25))
    src.commit(ids)
    jl, pl = _exported(src.j, ids, 24), _exported(src.p, ids, 24)
    for pool, leaves in ((dst.j, jl), (dst.p, pl)):
        with pytest.raises(ValueError):
            pool.import_pages(ids + list(range(90, 98)), leaves)
    dst.check()


def test_import_degrades_when_pool_pinned_solid():
    src, dst = Twin(n_pages=8), Twin(n_pages=2)
    ids = list(range(1, 25))
    src.commit(ids)
    jl, pl = _exported(src.j, ids, 24), _exported(src.p, ids, 24)
    blocker = list(range(100, 117))
    assert dst.commit(blocker) == 2
    pin = dst.acquire(blocker, 16)
    assert dst.j.import_pages(ids, jl) == dst.p.import_pages(ids, pl) == 0
    dst.check()
    dst.release(pin)
    got = dst.p.import_pages(ids, pl)
    assert dst.j.import_pages(ids, jl) == got >= T
    dst.check()


def test_hot_prefixes_ranks_by_recency():
    tw = Twin(n_pages=8)
    a, b = list(range(1, 17)), list(range(100, 117))
    tw.commit(a, namespace="x")
    tw.commit(b, namespace="y")
    assert tw.match_len(a, namespace="x") == 16
    tw.release(tw.acquire(a, 16, namespace="x"))
    rows = tw.p.hot_prefixes(8)
    assert [r["namespace"] for r in rows] == ["x", "y"]
    assert rows[0]["ids"] == a and rows[1]["ids"] == b[:16]
    assert tw.p.hot_prefixes(1) == rows[:1] and tw.p.hot_prefixes(0) == []


def test_namespaces_never_match_across_and_drain_alone():
    """Two namespaces over one arena: no cross match; draining one frees its
    pages only (a pinned page stays until its lease goes), and an emptied
    namespace loses its root and ledger row."""
    tw = Twin(n_pages=8)
    a = list(range(1, 17))
    tw.commit(a, namespace="x")
    tw.commit(a, namespace="y")
    assert tw.match_len(a, namespace="x") == 16 and tw.match_len(a, namespace="z") == 0
    lease = tw.acquire(a + [0], 16, namespace="x")
    assert tw.j.drain_namespace("x") == tw.p.drain_namespace("x") == 2
    tw.check()
    tw.release(lease)
    assert tw.j.drain_namespace("x") == tw.p.drain_namespace("x") == 0
    tw.check()
    assert tw.match_len(a, namespace="y") == 16
    assert tw.p.counters["drained_pages"] == 2
    assert "x" not in tw.p._roots and tw.p.occupancy()["namespaces"] == 1
    assert tw.j.drain_namespace("never") == tw.p.drain_namespace("never") == 0


def test_ledger_rows_match_the_tree_walk():
    tw = Twin(n_pages=4, spill_pages=4)
    tw.commit(list(range(1, 17)), namespace="m")
    tw.commit(list(range(100, 124)), namespace="n")
    for pool in (tw.j, tw.p):
        assert pool._ledger_used() == pool._ledger_used_slow()
    assert tw.p._ledger_used() == tw.j._ledger_used()
    assert tw.p._ledger_free() == tw.j._ledger_free()
    assert tw.p._ledger_spill() == tw.j._ledger_spill() > 0


# ---------------------------------------------------------------------------
# what only the port has
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_restore_writes_the_ring_in_place(kv_dtype):
    """The engines' rings are held by their CUDA graphs: a restore copies
    into the storage it is given, and leaves every slot past the lease."""
    tw = Twin(kv_dtype, n_pages=8)
    ids = list(range(1, 25))
    tw.commit(ids)
    ring = {k: torch.full_like(v, 7) for k, v in init_cache(tw.cfg, CPU).items()}
    ptrs = {k: v.data_ptr() for k, v in ring.items()}
    lease = tw.p.acquire(ids + [0], 16)
    tw.p.restore(lease, ring)
    tw.p.release(lease)
    for k, v in ring.items():
        assert v.data_ptr() == ptrs[k]
        assert torch.equal(v[:, :, :16], tw.pring[k][:, :, :16])
        assert bool((v[:, :, 16:] == 7).all())


def test_lane_commit_reads_the_lane_and_matches_a_ring_commit():
    _, cfg = _cfgs()
    lanes = {k: torch.stack([torch.zeros_like(v), v, torch.ones_like(v)])
             for k, v in p_ring(marked(cfg), cfg).items()}
    a = kvpool.KVPool(cfg, page_tokens=T, n_pages=8, device=CPU)
    b = kvpool.KVPool(cfg, page_tokens=T, n_pages=8, device=CPU)
    ids = list(range(1, 25))
    assert a.commit_lane(ids, lanes, 1) == b.commit(ids, {k: v[1] for k, v in lanes.items()}) == 3
    for k in a.arena:
        assert torch.equal(a.arena[k], b.arena[k])


def test_runs_group_consecutive_ids():
    assert kvpool._runs([]) == []
    assert kvpool._runs([3, 4, 5, 9, 10, 2]) == [(3, 0, 3), (9, 3, 2), (2, 5, 1)]


def test_import_racing_commits_stays_coherent():
    """The reference's race of an import against commits and acquires that
    evict it, on the port's pool alone: only dedup or degrade, no pin left,
    and a final import restores bit for bit."""
    _, cfg = _cfgs()
    ring = p_ring(marked(cfg), cfg)
    pool = kvpool.KVPool(cfg, page_tokens=T, n_pages=4, device=CPU)
    donor = kvpool.KVPool(cfg, page_tokens=T, n_pages=8, device=CPU)
    ids = list(range(1, 25))
    donor.commit(ids, ring)
    leaves = _exported(donor, ids, 24)
    stop, errors = threading.Event(), []

    def importer():
        try:
            while not stop.is_set():
                assert pool.import_pages(ids, leaves, namespace="m") in (0, 8, 16, 24)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def churner():
        try:
            rounds = 0
            while not stop.is_set():
                other = list(range(200 + rounds % 7 * 32, 200 + rounds % 7 * 32 + 17))
                pool.commit(other, ring)
                pool.release(pool.acquire(other, 16))
                rounds += 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=importer), threading.Thread(target=churner)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(10)
    assert not errors, errors
    assert pool.occupancy()["pages_pinned"] == 0
    covered = pool.import_pages(ids, leaves, namespace="m")
    assert covered >= T
    final = pool.acquire(ids[:covered], covered, namespace="m")
    out = pool.restore(final, init_cache(cfg, CPU))
    pool.release(final)
    for k in out:
        assert torch.equal(out[k][:, :, :covered], ring[k][:, :, :covered])
    assert pool.occupancy()["pages_pinned"] == 0

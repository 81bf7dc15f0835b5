"""Block-paged KV pool with a shared radix-tree prefix index.

The port of the JAX package's pool (llama_fastapi_k8s_gpu_tpu/parallel/
kvpool.py): a preallocated device arena of fixed-size token **pages**,
fronted by a radix tree keyed on token prefixes, so

- a shared system prompt prefills once per process and every later
  request restores its pages instead of recomputing them;
- a multi-turn conversation resumes from its last committed page,
  whichever lane it lands on;
- warm but idle conversations spill to host memory and restore on their
  next hit.

Layout: a page is ``page_tokens`` consecutive token slots across every
layer and head of the ring.  The token axis is axis 2 of every leaf of
``models.llama.init_cache`` — the bf16 ``{k, v}`` ring and the int8
four-leaf ring (its ``(L, n_kv, n_ctx)`` scales included) — so the arena
holds one tensor a ring leaf, page-major: ``(n_pages, L, n_kv, T[, hd])``.
On a prefix hit the matched pages are copied contiguously into the front
of an ordinary ring and the suffix prefills from there: the prompt pass,
the decode step and their kernels see the dense ring they always see.

Over a tp mesh (parallel/mesh.py) the ring is a ``ShardedRing`` whose
shards hold the kv heads split (or replicated, where tp does not divide
them); the arena keeps the whole-head layout on the mesh's first device.
A store fills each page's heads from the shard that holds them and a
restore writes every shard in place (``ShardedRing.head_shards``), so a
page committed over a mesh is byte for byte the page one device commits
for the same ids: export, import, the disagg wire and a shared arena take
it unchanged.

The page moves are plain tensor copies on the arena's device, **in
place** both ways: a restore writes into the ring the caller passes (the
engines' rings, whose addresses their CUDA graphs hold, are never
rebound), a store into the arena.  Each run of consecutive page ids moves
as one strided copy between the ring's token block and the arena's page
block (a view on either side, so no transient is made); a fresh pool hands
out consecutive ids, so a restore of n pages is one copy a leaf.  A page
copy is not a compile: nothing here registers on the compile registry.

The host spill tier keeps a spilled node's pages as host tensors, pinned
when the arena lives on the card.  Device↔host copies run synchronously
under the pool's lock, as in the reference.

Concurrency: one ``threading.Lock`` guards the tree, the free list, the
refcounts and the counters; the serial engines call under their
generation lock, the continuous scheduler from its own thread.  Pages a
request has acquired are pinned (per-page refcounts) and never evicted;
eviction is LRU over unpinned nodes.  Every ``acquire`` must be paired
with exactly one ``release`` on every path — the reference checks that
statically (its lint rule RES001); the port's tests drive each exit.

Namespaces: every index operation takes a ``namespace``, one radix root
each, so models sharing one arena never match each other's prefixes; the
arena, the free list and the LRU clock stay shared.
"""

from __future__ import annotations

import logging
import math
import threading
import time
import weakref

import torch

from ..models.config import ModelConfig
from ..models.llama import init_cache, lane_view
from ..obs.memledger import register_component
from ..utils.device import resolve_device
from .mesh import ShardedRing

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# page movement (leaf-generic: the token axis is 2 in every ring leaf)
# ---------------------------------------------------------------------------

def _runs(page_ids: list) -> list:
    """``page_ids`` as runs of consecutive ids: ``[(first id, index in
    page_ids, length)]``."""
    runs: list = []
    for j, pid in enumerate(page_ids):
        if runs and pid == runs[-1][0] + runs[-1][2]:
            runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((pid, j, 1))
    return runs


def _token_block(leaf: torch.Tensor, start: int, n: int, T: int) -> torch.Tensor:
    """Ring slots [start, start + n·T) of ``leaf`` (L, n_kv, n_ctx[, hd]) as
    a page-major view (n, L, n_kv, T[, hd])."""
    return leaf[:, :, start:start + n * T].unflatten(2, (n, T)).movedim(2, 0)


def _head_parts(ring: dict, name: str, write: bool) -> list:
    """Leaf ``name`` of ``ring`` as ``[(tensor, heads)]``: a plain ring is
    its one tensor holding every head; a ``ShardedRing`` is its tp shards,
    each with the slice of the whole ring's kv heads it holds
    (``ShardedRing.head_shards``: a write reaches every replica, a read
    comes from one)."""
    if isinstance(ring, ShardedRing):
        return [(ring[name][i], heads) for i, heads in ring.head_shards(write)]
    return [(ring[name], slice(None))]


@torch.inference_mode()
def _store_pages(arena: dict, ring: dict, page_ids: list, offset: int) -> None:
    """Copy ring token slots [offset, offset + n·T) into arena pages
    ``page_ids``, in place.  A sharded ring's shards each fill their heads
    of the whole-head pages, so a page is the same bytes whatever mesh
    committed it."""
    for name, al in arena.items():
        T = al.shape[3]
        for leaf, heads in _head_parts(ring, name, write=False):
            for pid, j, r in _runs(page_ids):
                al[pid:pid + r, :, heads].copy_(_token_block(leaf, offset + j * T, r, T))


@torch.inference_mode()
def _store_lane_pages(arena: dict, bcache: dict, lane: int, page_ids: list,
                      offset: int) -> None:
    """As :func:`_store_pages`, reading lane ``lane`` of a lane-major cache
    (parallel/batched.py; over a mesh, the lane's dp group's shards): its
    ring is a view, nothing is gathered."""
    _store_pages(arena, lane_view(bcache, lane), page_ids, offset)


@torch.inference_mode()
def _restore_pages(arena: dict, ring: dict, page_ids: list, offset: int) -> None:
    """Copy arena pages ``page_ids`` into ring token slots [offset, offset
    + n·T), contiguously and in place (every shard of a sharded ring)."""
    for name, al in arena.items():
        T = al.shape[3]
        for leaf, heads in _head_parts(ring, name, write=True):
            for pid, j, r in _runs(page_ids):
                _token_block(leaf, offset + j * T, r, T).copy_(al[pid:pid + r, :, heads])


@torch.inference_mode()
def _upload_pages(arena: dict, pages: dict, page_ids: list) -> None:
    """Write host page stacks (one per arena leaf, leading axis = page, in
    ``page_ids`` order) into the arena slots ``page_ids``."""
    for name, al in arena.items():
        for pid, j, r in _runs(page_ids):
            al[pid:pid + r].copy_(pages[name][j:j + r])


@torch.inference_mode()
def _download_pages(arena: dict, page_ids: list) -> dict:
    """Host copies of arena pages ``page_ids`` (one stack a leaf, leading
    axis = page, pinned when the arena is on the card), synchronously."""
    out = {}
    for name, al in arena.items():
        host = torch.empty((len(page_ids),) + tuple(al.shape[1:]), dtype=al.dtype,
                           pin_memory=al.device.type == "cuda")
        for pid, j, r in _runs(page_ids):
            host[j:j + r].copy_(al[pid:pid + r])
        out[name] = host
    return out


def _leaf_specs(cfg: ModelConfig, T: int) -> dict:
    """Each ring leaf's page geometry under ``cfg``: name → (page shape,
    dtype), in sorted leaf order (the reference's pytree order)."""
    ring = init_cache(cfg, torch.device("meta"))
    return {name: ((*ring[name].shape[:2], T, *ring[name].shape[3:]), ring[name].dtype)
            for name in sorted(ring)}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# radix tree (page-granular: every edge is a run of whole pages)
# ---------------------------------------------------------------------------

class _Node:
    """One radix edge: a run of whole pages.  ``edge`` holds the token
    content as page tuples; ``pages`` the arena page ids (None when the
    node is spilled — ``host`` then holds its page stacks on the host).
    Children are keyed by their edge's first page tuple, so two sequences
    diverging mid-page land under different keys.  ``ns`` is the namespace
    the node lives under (the memory ledger's attribution key)."""

    __slots__ = ("edge", "pages", "host", "children", "parent", "stamp", "ns")

    def __init__(self, edge, pages, parent, ns: str = ""):
        self.edge: list[tuple] = edge
        self.pages: list[int] | None = pages
        self.host: dict | None = None
        self.children: dict[tuple, _Node] = {}
        self.parent: _Node | None = parent
        self.stamp = 0
        self.ns = ns


class _Lease:
    """Pinned pages backing one in-flight request's prefix reuse."""

    __slots__ = ("tokens", "page_ids")

    def __init__(self, tokens: int, page_ids: list[int]):
        self.tokens = tokens
        self.page_ids = page_ids


class KVPool:
    """The process-wide paged KV arena and radix prefix index, on
    ``device`` (the card unless the caller asks for the CPU).

    ``sink_host`` is the owning engine (any object with a ``metrics_sink``
    attribute): hit, miss, eviction, spill and restore events go into its
    metrics registry when the server installed one, and are dropped
    otherwise — telemetry never fails serving.  It is held weakly: a
    shared pool (the multi-model registry's) outlives a removed owner,
    whose weights must not stay alive through it."""

    # -- lock discipline (machine-checked: lfkt-lint LOCK001-004) ----------
    # one mutex guards every mutable: tree, free list, refcounts, arena
    # reference, counters.  Device copies dispatch under the lock (they
    # are async enqueues); callers on any thread.
    _GUARDED_BY = {
        "arena": "_lock",
        "_free": "_lock",
        "_page_refs": "_lock",
        "_roots": "_lock",
        "_clock": "_lock",
        "_spill_used": "_lock",
        "_busy": "_lock",
        "counters": "_lock",
        "_ns_pages": "_lock",
    }

    def __init__(self, cfg: ModelConfig, page_tokens: int = 128, n_pages: int = 0,
                 spill_pages: int = 0, sink_host=None,
                 device: str | torch.device | None = None):
        T = int(page_tokens)
        if T < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        if T >= cfg.n_ctx:
            raise ValueError(
                f"page_tokens {T} must be smaller than n_ctx {cfg.n_ctx} "
                "(a usable prefix must leave >= 1 token to prefill)")
        self.page_tokens = T
        if n_pages <= 0:
            # auto: four full contexts' worth of pages, the reference's size
            n_pages = 4 * max(1, cfg.n_ctx // T)
        self.n_pages = int(n_pages)
        self.spill_pages = max(0, int(spill_pages))
        self._sink_host = weakref.ref(sink_host) if sink_host is not None else None
        self.device = resolve_device(device)
        specs = _leaf_specs(cfg, T)
        #: the arena: one tensor a ring leaf, page-major (n_pages, L, n_kv,
        #: T[, hd]), allocated once and updated in place
        self.arena = {name: torch.zeros((self.n_pages, *shape), dtype=dtype, device=self.device)
                      for name, (shape, dtype) in specs.items()}
        self.page_nbytes = sum(math.prod(shape) * dtype.itemsize
                               for shape, dtype in specs.values())
        #: the per-leaf page geometry another model must reproduce to share
        #: this arena (:meth:`compatible`)
        self._page_spec = tuple((shape, _dtype_name(dtype)) for shape, dtype in specs.values())
        self._lock = threading.Lock()
        self._free: list[int] = list(range(self.n_pages))
        self._page_refs: dict[int, int] = {}
        #: one radix root per namespace
        self._roots: dict[str, _Node] = {}
        #: device-resident indexed pages per namespace, kept at the mutation
        #: sites so the memory ledger reads O(namespaces) under the lock
        self._ns_pages: dict[str, int] = {}
        self._clock = 0
        self._spill_used = 0
        #: node ids an in-progress walk depends on: eviction skips them
        self._busy: set[int] = set()
        #: monotonic event counters (tests and /health; the Prometheus
        #: families are incremented at event time through the sink)
        self.counters = {
            "hits": 0, "misses": 0, "reused_tokens": 0, "commits": 0,
            "stored_pages": 0, "evictions": 0, "spills": 0, "restores": 0,
            "store_skips": 0, "exported_pages": 0, "imported_pages": 0,
            "drained_pages": 0,
        }
        # the arena in the process memory ledger: indexed pages per
        # namespace, the free list, and the host spill tier
        register_component("kv_arena_used", self, KVPool._ledger_used)
        register_component("kv_arena_free", self, KVPool._ledger_free)
        register_component("host_spill", self, KVPool._ledger_spill)

    @property
    def _root(self) -> _Node:
        """The default namespace's radix root (white-box tests)."""
        root = self._roots.get("")
        if root is None:
            root = self._roots.setdefault("", _Node([], [], None, ""))  # lfkt: noqa[LOCK001] -- GIL-atomic setdefault (a losing racer's node is discarded); taking _lock here would deadlock the white-box callers that already hold it
        return root

    # -- telemetry (never fails serving) -----------------------------------
    def _emit(self, kind: str, name: str, value: float = 1.0) -> None:
        host = self._sink_host() if self._sink_host is not None else None
        m = getattr(host, "metrics_sink", None) if host is not None else None
        if m is None:
            return
        try:
            getattr(m, kind)(name, value)
        except Exception:  # noqa: BLE001 — telemetry must never fail serving
            pass

    @property
    def arena_nbytes(self) -> int:
        """Device bytes of the page arena."""
        return sum(t.numel() * t.element_size() for t in self.arena.values())

    def compatible(self, cfg: ModelConfig, page_tokens: int | None = None) -> bool:
        """Whether a model with ``cfg``'s ring geometry can share this arena:
        the same page size and the same per-leaf page shapes and dtypes."""
        if page_tokens is not None and int(page_tokens) != self.page_tokens:
            return False
        theirs = tuple((shape, _dtype_name(dtype))
                       for shape, dtype in _leaf_specs(cfg, self.page_tokens).values())
        return theirs == self._page_spec

    def page_spec(self) -> tuple:
        """The per-leaf page geometry ((shape, dtype name), ...), in sorted
        leaf order: what a peer pool must reproduce to exchange pages."""
        return self._page_spec

    # ------------------------------------------------------------------
    # public surface (each entry point takes the lock once)
    # ------------------------------------------------------------------
    def match_len(self, ids, *, namespace: str = "") -> int:
        """Tokens of ``ids`` covered by cached whole pages (on the device or
        spilled) in ``namespace``: a peek — no pin, no counters, no restore."""
        with self._lock:
            return self._match(list(ids), namespace)[0] * self.page_tokens

    def note_miss(self) -> None:
        """Count one miss: the engine consulted the index and could not use
        it (no match, too short, or no bucket fits)."""
        with self._lock:
            self.counters["misses"] += 1
        self._emit("inc", "prefix_cache_misses_total")

    def acquire(self, ids, tokens: int, span=None, *, namespace: str = "") -> _Lease | None:  # lfkt: blocks-under[_lock] -- spill-tier restore/evict moves pages device<->host: the radix+refcount walk and the copy must be atomic (bounded by page-group size)
        """Pin the pages covering ``ids[:tokens]`` (``tokens`` a multiple of
        the page size, at most :meth:`match_len`).  Spilled pages on the path
        are uploaded into freshly allocated arena slots first; if that cannot
        be had (the pool pinned solid) or the upload fails, the acquire
        degrades to a miss (None) — the request takes a full prefill.  On
        success the matched region is LRU-touched and counted as a hit."""
        T = self.page_tokens
        want = tokens // T
        if want < 1:
            return None
        with self._lock:
            matched, path = self._match(list(ids), namespace)
            ok = matched >= want
            page_ids: list[int] = []
            if ok:
                # pin as the walk goes, the whole path busy: a later node's
                # spill restore may evict, and never a page (or node) this
                # lease is about to reference
                self._busy.update(id(node) for node, _n in path)
                self._clock += 1
                try:
                    for node, n_pages in path:
                        if len(page_ids) >= want:
                            break
                        if node.pages is None and not self._restore_node(node, span=span):
                            ok = False
                            break
                        node.stamp = self._clock
                        take = min(n_pages, want - len(page_ids))
                        for pid in node.pages[:take]:
                            self._page_refs[pid] = self._page_refs.get(pid, 0) + 1
                            page_ids.append(pid)
                except Exception as e:  # noqa: BLE001 — degrade to a miss
                    logger.warning("paged acquire failed; degrading to a full prefill: %s", e)
                    ok = False
                finally:
                    self._busy.clear()
            if not ok:
                for pid in page_ids:
                    self._unref(pid)
                self.counters["misses"] += 1
                self._emit("inc", "prefix_cache_misses_total")
                return None
            self.counters["hits"] += 1
            self.counters["reused_tokens"] += want * T
        self._emit("observe", "prefix_reuse_tokens", want * T)
        return _Lease(want * T, page_ids)

    def release(self, lease: _Lease | None) -> None:
        """Unpin a lease's pages (exactly once per lease)."""
        if lease is None:
            return
        with self._lock:
            for pid in lease.page_ids:
                self._unref(pid)

    def restore(self, lease: _Lease, ring: dict, span=None) -> dict:
        """Copy the lease's pages contiguously into ring slots [0,
        lease.tokens) **in place** and return ``ring``.  The ring then serves
        the suffix prefill as if those slots had been prefilled locally.  A
        failed copy raises; the caller owns the ring's recovery."""
        t0 = time.time()
        with self._lock:
            _restore_pages(self.arena, ring, lease.page_ids, 0)
        if span is not None:
            span.event("kv_restore", pages=len(lease.page_ids), tokens=lease.tokens,
                       bytes=len(lease.page_ids) * self.page_nbytes,
                       host_s=round(time.time() - t0, 6))
        return ring

    def export_pages(self, lease: _Lease) -> list:  # lfkt: blocks-under[_lock] -- the export gather is a synchronous DMA exactly like the spill path's; the pin+copy must be atomic against eviction
        """Host copies of the lease's pages, one stack a ring leaf in sorted
        leaf order (leading axis = page, in lease order): the unit a peer's
        :meth:`import_pages` takes.  The lease pins the pages, so the copy
        never races an eviction."""
        with self._lock:
            host = _download_pages(self.arena, lease.page_ids)
            self.counters["exported_pages"] += len(lease.page_ids)
        return [host[name] for name in self.arena]

    def import_pages(self, ids, leaves, *, namespace: str = "", span=None) -> int:  # lfkt: blocks-under[_lock] -- wire-page upload indexes into the radix as it copies: the index+arena move must be atomic (bounded by page-group size)
        """Index externally produced pages: the whole-page prefix of ``ids``
        arrives as host page stacks (one per ring leaf in sorted leaf order,
        leading axis = page, :meth:`export_pages`'s layout).  Pages already
        cached deduplicate; the new tail uploads into fresh arena pages and
        joins the tree through the same machinery as :meth:`commit`, with
        the same degrade.  Returns the tokens the tree now covers for this
        prefix."""
        ids = list(ids)
        T = self.page_tokens
        with self._lock:
            n_want = len(ids) // T
            if n_want < 1:
                return 0
            if len(leaves) != len(self.arena) or any(leaf.shape[0] != n_want for leaf in leaves):
                raise ValueError(
                    f"page stacks cover {[leaf.shape[0] for leaf in leaves]} pages, ids "
                    f"cover {n_want} (geometry drift on the wire?)")
            stacks = dict(zip(self.arena, leaves))

            # the stacks are pageable host memory (a wire payload): each copy
            # returns only once the bytes are on the card, and the nodes join
            # the index after it, so a hit on another thread never reads a
            # page still in flight
            def upload(pids: list, matched: int, n_tail: int) -> None:
                _upload_pages(self.arena, {k: torch.as_tensor(v)[matched:matched + n_tail]
                                           for k, v in stacks.items()}, pids)

            matched, stored = self._index_tail(ids, namespace, span, upload)
            if stored:
                self.counters["imported_pages"] += stored
            return (matched + stored) * T

    def commit(self, ids, ring: dict, span=None, *, namespace: str = "") -> int:
        """Index the whole-page prefix of ``ids`` whose KV sits in ring slots
        [0, len(ids)): cached pages deduplicate (LRU touch only), the new
        tail is copied into fresh arena pages and inserted into the tree.
        When the whole tail cannot be had the commit degrades to the leading
        portion that fits, and skips only when not one page can be had.
        Returns the number of new pages stored."""
        return self._commit_impl(list(ids), ring=ring, span=span, namespace=namespace)

    def commit_lane(self, ids, bcache: dict, lane: int, span=None, *,
                    namespace: str = "") -> int:
        """As :meth:`commit`, reading lane ``lane`` of a lane-major cache —
        the continuous scheduler's freed-lane path."""
        return self._commit_impl(list(ids), bcache=bcache, lane=lane, span=span,
                                 namespace=namespace)

    def drain_namespace(self, namespace: str) -> int:
        """Retire one namespace's index: drop every droppable node of it
        (device pages to the free list, spilled stacks released) and return
        the device pages it still holds (pinned by in-flight leases, or
        busy); the caller polls until 0.  Only this namespace is touched.
        When it empties, its root goes; a namespace never committed to is a
        no-op."""
        with self._lock:
            root = self._roots.get(namespace)
            if root is None:
                self._ns_pages.pop(namespace, None)
                return 0
            order: list[_Node] = []
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                order.append(n)
                stack.extend(n.children.values())
            drained = 0
            # children first: dropping a subtree's leaves turns its interior
            # nodes into droppable leaves within the same pass
            for node in reversed(order):
                if node.children or id(node) in self._busy:
                    continue
                if node.pages is not None:
                    if any(p in self._page_refs for p in node.pages):
                        continue        # pinned by an in-flight lease
                    n = len(node.pages)
                    self._free.extend(node.pages)
                    node.pages = None
                    self._ns_pages[namespace] = max(0, self._ns_pages.get(namespace, 0) - n)
                    drained += n
                else:
                    self._spill_used -= len(node.edge)
                    node.host = None
                self._unlink(node)
            if drained:
                self.counters["drained_pages"] += drained
            if not root.children:
                self._roots.pop(namespace, None)
                self._ns_pages.pop(namespace, None)
                return 0
            return self._ns_pages.get(namespace, 0)

    def reset(self) -> None:
        """Drop the index of every namespace and free every page (watchdog
        recovery: nothing resident is trustworthy).  The arena needs no
        zeroing: unindexed pages are unreachable."""
        with self._lock:
            self._roots = {}
            self._free = list(range(self.n_pages))
            self._page_refs = {}
            self._spill_used = 0
            self._ns_pages = {}
            self._busy.clear()

    # -- memory-ledger providers (obs/memledger.py, at snapshot time) ------
    def _ledger_used(self) -> dict:
        """Indexed device pages per namespace, in bytes; pages allocated but
        not (yet) in a tree land under ``(unindexed)``, so used and free sum
        to the whole arena."""
        with self._lock:
            per_ns = {ns: pages * self.page_nbytes
                      for ns, pages in self._ns_pages.items() if pages}
            inflight = (self.n_pages - len(self._free)) - sum(self._ns_pages.values())
        if inflight > 0:
            per_ns["(unindexed)"] = inflight * self.page_nbytes
        return per_ns

    def _ledger_used_slow(self) -> dict:
        """The tree walk :meth:`_ledger_used` must agree with (tests)."""
        with self._lock:
            per_ns: dict[str, int] = {}
            for ns, root in self._roots.items():
                pages = 0
                stack = list(root.children.values())
                while stack:
                    n = stack.pop()
                    stack.extend(n.children.values())
                    if n.pages is not None:
                        pages += len(n.pages)
                if pages:
                    per_ns[ns] = pages * self.page_nbytes
        return per_ns

    def _ledger_free(self) -> int:
        with self._lock:
            return len(self._free) * self.page_nbytes

    def _ledger_spill(self) -> int:
        with self._lock:
            return self._spill_used * self.page_nbytes

    def occupancy(self) -> dict:
        """Point-in-time occupancy for /health, the ``kv_pool_pages_*``
        gauges and /debug/memory's fragmentation line (the largest run of
        consecutive free page ids against the free count)."""
        with self._lock:
            free_ids = list(self._free)
            pinned = len(self._page_refs)
            spill = self._spill_used
            namespaces = len(self._roots)
        # the run scan outside the lock: a scrape never stalls an allocation
        free = len(free_ids)
        run = best = 0
        prev = None
        for pid in sorted(free_ids):
            run = run + 1 if prev is not None and pid == prev + 1 else 1
            best = max(best, run)
            prev = pid
        return {
            "largest_free_run": best,
            "page_tokens": self.page_tokens,
            "page_bytes": self.page_nbytes,
            "pages_total": self.n_pages,
            "pages_used": self.n_pages - free,
            "pages_free": free,
            "pages_pinned": pinned,
            "spill_pages_total": self.spill_pages,
            "spill_pages_used": spill,
            "arena_bytes": self.arena_nbytes,
            "namespaces": namespaces,
        }

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def hot_prefixes(self, k: int = 8) -> list[dict]:
        """The ``k`` most recently used cached prefixes across every
        namespace, hottest first: ``{"namespace", "ids", "tokens"}`` with
        ``ids`` the whole root→leaf token run (leaf chains only; spilled
        leaves count)."""
        rows: list[tuple[int, str, list[int]]] = []
        with self._lock:
            for node in self._nodes():
                if node.children:
                    continue
                ids: list[int] = []
                chain: list[_Node] = []
                n: _Node | None = node
                while n is not None and n.parent is not None:
                    chain.append(n)
                    n = n.parent
                for n in reversed(chain):
                    for page in n.edge:
                        ids.extend(int(t) for t in page)
                if ids:
                    rows.append((node.stamp, node.ns, ids))
        rows.sort(key=lambda r: r[0], reverse=True)
        return [{"namespace": ns, "ids": ids, "tokens": len(ids)}
                for _, ns, ids in rows[:max(0, int(k))]]

    # ------------------------------------------------------------------
    # internals (lock held)
    # ------------------------------------------------------------------
    def _pages_of(self, ids: list) -> list[tuple]:
        T = self.page_tokens
        return [tuple(ids[i * T:(i + 1) * T]) for i in range(len(ids) // T)]

    def _root_for(self, ns: str) -> _Node:  # lfkt: holds[_lock]
        root = self._roots.get(ns)
        if root is None:
            root = self._roots[ns] = _Node([], [], None, ns)
        return root

    def _match(self, ids: list, ns: str = ""):  # lfkt: holds[_lock]
        """Greedy page-wise walk of ``ns``'s tree: (matched_pages, path),
        path = [(node, pages matched in it), ...] root first."""
        want = self._pages_of(ids)
        node = self._roots.get(ns)
        if node is None:
            return 0, []
        i = 0
        path: list[tuple[_Node, int]] = []
        while i < len(want):
            child = node.children.get(want[i])
            if child is None:
                break
            j = 0
            while j < len(child.edge) and i + j < len(want) and child.edge[j] == want[i + j]:
                j += 1
            path.append((child, j))
            i += j
            if j < len(child.edge):
                break
            node = child
        return i, path

    def _unref(self, pid: int) -> None:  # lfkt: holds[_lock]
        left = self._page_refs.get(pid, 0) - 1
        if left > 0:
            self._page_refs[pid] = left
        else:
            self._page_refs.pop(pid, None)

    def _restore_node(self, node: _Node, span=None) -> bool:  # lfkt: holds[_lock]
        """Bring a spilled node's pages back into the arena (allocating,
        which may evict).  False when the allocation cannot be had or the
        upload fails — the caller degrades to a miss."""
        n = len(node.edge)
        pids = self._alloc(n)
        if pids is None:
            return False
        t0 = time.time()
        try:
            _upload_pages(self.arena, node.host, pids)
        except Exception as e:  # noqa: BLE001 — degrade to a miss; the slots
            # just allocated go back on the free list
            self._free.extend(pids)
            logger.warning("spill restore failed; degrading to a full prefill: %s", e)
            return False
        node.pages = pids
        node.host = None
        self._spill_used -= n
        self._ns_pages[node.ns] = self._ns_pages.get(node.ns, 0) + n
        self.counters["restores"] += 1
        self._emit("inc", "prefix_cache_restores_total")
        if span is not None:
            span.event("kv_spill_restore", pages=n, bytes=n * self.page_nbytes,
                       host_s=round(time.time() - t0, 6))
        return True

    def _commit_impl(self, ids: list, ring=None, bcache=None, lane=None, span=None,  # lfkt: blocks-under[_lock] -- commit indexes the tail into the radix as it stores: spill-tier evictions on the alloc path are part of the atomic move
                     namespace: str = "") -> int:
        with self._lock:
            if len(ids) < self.page_tokens:
                return 0
            self.counters["commits"] += 1
            T = self.page_tokens

            def store(pids: list, matched: int, n_tail: int) -> None:
                if ring is not None:
                    _store_pages(self.arena, ring, pids, matched * T)
                else:
                    _store_lane_pages(self.arena, bcache, lane, pids, matched * T)

            return self._index_tail(ids, namespace, span, store)[1]

    def _index_tail(self, ids: list, namespace: str, span, store) -> tuple:  # lfkt: holds[_lock]
        """The index-attach skeleton of :meth:`commit`, :meth:`commit_lane`
        and :meth:`import_pages`: match and LRU-touch, busy-pin the match
        path, allocate the tail (halving on failure), split or attach, run
        ``store(pids, matched_pages, n_tail)`` (the device copies), insert.
        Returns ``(matched_pages, stored_pages)``.  A raising ``store``
        returns its pages to the free list and reports 0 stored: the cache
        must never fail a finished request."""
        want = self._pages_of(ids)
        if not want:
            return 0, 0
        matched, path = self._match(ids, namespace)
        self._clock += 1
        for node, _n in path:
            node.stamp = self._clock
        if matched >= len(want):
            return matched, 0
        tail = want[matched:]
        self._busy.update(id(node) for node, _n in path)
        try:
            n = len(tail)
            pids = self._alloc(n, span=span)
            while pids is None and n > 1:
                n //= 2
                pids = self._alloc(n, span=span)
        finally:
            self._busy.clear()
        if pids is None:
            self.counters["store_skips"] += 1
            return matched, 0
        tail = tail[:n]
        if path and path[-1][1] < len(path[-1][0].edge):
            parent = self._split(path[-1][0], path[-1][1])
        elif path:
            parent = path[-1][0]
        else:
            parent = self._root_for(namespace)
        try:
            store(pids, matched, len(tail))
        except Exception as e:  # noqa: BLE001 — skip the store (docstring)
            self._free.extend(pids)
            self.counters["store_skips"] += 1
            logger.warning("page store failed; commit skipped: %s", e)
            return matched, 0
        child = _Node(tail, pids, parent, namespace)
        child.stamp = self._clock
        parent.children[tail[0]] = child
        self._ns_pages[namespace] = self._ns_pages.get(namespace, 0) + len(tail)
        self.counters["stored_pages"] += len(tail)
        return matched, len(tail)

    def _split(self, node: _Node, at: int) -> _Node:  # lfkt: holds[_lock]
        """Split ``node``'s edge after ``at`` pages; returns the new upper
        node."""
        upper = _Node(node.edge[:at], node.pages[:at] if node.pages is not None else None,
                      node.parent, node.ns)
        upper.stamp = node.stamp
        if node.pages is None:
            upper.host = {k: h[:at] for k, h in node.host.items()}
            node.host = {k: h[at:] for k, h in node.host.items()}
        else:
            node.pages = node.pages[at:]
        node.edge = node.edge[at:]
        node.parent.children[upper.edge[0]] = upper
        upper.children[node.edge[0]] = node
        node.parent = upper
        return upper

    def _nodes(self) -> list:  # lfkt: holds[_lock]
        """Every node across every namespace (one LRU clock pool-wide)."""
        out = []
        stack = [c for root in self._roots.values() for c in root.children.values()]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            out.append(n)
        return out

    def _evictable(self) -> list:  # lfkt: holds[_lock]
        """Non-busy device-resident nodes with every page unpinned."""
        return [n for n in self._nodes()
                if n.pages is not None and id(n) not in self._busy
                and not any(p in self._page_refs for p in n.pages)]

    def _spilled_leaves(self) -> list:  # lfkt: holds[_lock]
        return [n for n in self._nodes()
                if n.pages is None and not n.children and id(n) not in self._busy]

    def _unlink(self, node: _Node) -> None:  # lfkt: holds[_lock]
        node.parent.children.pop(node.edge[0], None)
        node.parent = None

    def _evict_one(self, span=None) -> bool:  # lfkt: holds[_lock]
        """Evict one node, LRU first: spill its pages to the host when the
        tier has room (aging out the LRU spilled leaf when it does not, but
        only when aging can make the victim fit), otherwise drop it —
        interior nodes can only spill, so under a full tier the LRU
        droppable leaf goes instead.  False when nothing is evictable."""
        cands = sorted(self._evictable(), key=lambda n: n.stamp)
        if not cands:
            return False
        for victim in cands:
            n = len(victim.pages)
            if self.spill_pages:
                unageable = self._spill_used - sum(len(s.edge) for s in self._spilled_leaves())
                while n + unageable <= self.spill_pages \
                        and self._spill_used + n > self.spill_pages:
                    spilled = self._spilled_leaves()
                    if not spilled:
                        break
                    aged = min(spilled, key=lambda s: s.stamp)
                    self._spill_used -= len(aged.edge)
                    aged.host = None
                    self._unlink(aged)
            if self.spill_pages and self._spill_used + n <= self.spill_pages:
                t0 = time.time()
                # copy the victim's pages to the host, then free the slots;
                # the node stays matchable and restores on its next hit
                victim.host = _download_pages(self.arena, victim.pages)
                self._spill_used += n
                self.counters["spills"] += 1
                self._emit("inc", "prefix_cache_spills_total")
                if span is not None:
                    span.event("kv_spill", pages=n, bytes=n * self.page_nbytes,
                               host_s=round(time.time() - t0, 6))
                self._free.extend(victim.pages)
                victim.pages = None
                self._ns_pages[victim.ns] = max(0, self._ns_pages.get(victim.ns, 0) - n)
            elif not victim.children:
                self._free.extend(victim.pages)
                victim.pages = None
                self._ns_pages[victim.ns] = max(0, self._ns_pages.get(victim.ns, 0) - n)
                self._unlink(victim)
            else:
                continue        # interior, no spill room: the next LRU
            self.counters["evictions"] += 1
            self._emit("inc", "prefix_cache_evictions_total")
            return True
        return False

    def _alloc(self, n: int, span=None):  # lfkt: holds[_lock]
        """``n`` free page ids, evicting LRU unpinned nodes as needed; None
        when the demand cannot be met (pinned solid)."""
        if n > self.n_pages:
            return None
        while len(self._free) < n:
            if not self._evict_one(span=span):
                return None
        out = self._free[:n]
        del self._free[:n]
        return out

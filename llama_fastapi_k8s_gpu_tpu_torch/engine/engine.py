"""The serial engine: the in-tree replacement for ``llama_cpp.Llama``.

The same contract as the JAX reference's serial ``Engine``
(llama_fastapi_k8s_gpu_tpu/engine/engine.py): eager load, blocking
thread-safe generation one request at a time, OpenAI-shaped responses and
streaming chunks — on PyTorch and one GPU:

- load: on the card, the kernel library first (found under
  ``LFKT_COMPILE_CACHE_DIR``, else built: utils/kernelcache.py); then GGUF
  mmap → weights on the device (``q4k``: fused Q4_K/Q5_K/Q6_K/Q8_0 block
  bytes for an 8B model on the GPU; ``bf16`` for small models and the
  CPU; ``int8`` on request);
- KV cache: a head-major ring in bf16, or int8 with per-token scales
  (``kv_dtype="int8"``, ops/kvquant.py);
- prefill: the prompt padded to a bucket; a bucket larger than
  ``prefill_chunk`` runs as slices at growing cache offsets, stopping at
  the slice that holds the last real token;
- prefix reuse: when a prompt extends the previous request's tokens, only
  the suffix is prefilled (the reference's ``_prefix_reuse_len`` rule);
  under ``kv_paged`` the process-wide radix index of the paged KV pool
  (parallel/kvpool.py) takes its place: the longest cached whole-page
  prefix is copied into the ring in place and pinned for the request, and
  the finished conversation's pages are committed back.  A multi-model
  registry (serving/registry.py) hands every compatible engine one shared
  pool (``kv_pool=``) and each its own radix namespace (``kv_namespace=``);
- disaggregated prefill/decode (serving/disagg/): with a client installed
  (:meth:`Engine.install_disagg`) a prompt first hops to the prefill tier,
  whose pages import into the pool, so the reuse above restores them; the
  tier's own side is :meth:`Engine.prefill_to_pages`;
- speculative decoding (``spec_decode="lookup"``, or ``"auto"`` decided
  from the measured dispatch round trip, engine/spec_auto.py): a
  prompt-lookup draft of ``spec_draft`` tokens verified in one D+1-row
  forward (models/generate.py ``spec_verify``), on the card one replay of
  its captured graph a round; greedy output equals the vanilla path's;
- decode: chunks of ``decode_chunk`` steps with on-device sampling; chunk
  k+1 is queued on the device before chunk k's tokens are read, so the
  host's reading and text emission overlap the device's work.  On the
  card a step is one CUDA-graph replay (models/generate.py
  ``DecodeGraphs``: captured at :meth:`Engine.warmup` for the default
  ``top_k``, on first use for another; there is no eager decode on the
  card); on the CPU the same step runs eagerly.  Under
  ``decode_layer_unroll`` a step's layer stack is L/K launches of the
  layer-looped kernel (ops/decode_loop.py) over bf16 or int8 weights;
- sampling: the llama.cpp-parity chain (sampling/sample.py);
- observability: each call of a host program (``prefill``,
  ``prefill_chunk``, ``first_sample``, ``decode_chunk``) is one dispatch
  on the compile registry (obs/devtime.py; a graph capture is its
  compile); the weights and the ring are the memory ledger's ``weights``
  and ``kv_ring`` (obs/memledger.py); a non-streamed generation runs
  under ``maybe_profile`` (utils/tracing.py, ``LFKT_PROFILE_DIR``);
- resilience: a :class:`~..utils.health.Heartbeat` the watchdog samples
  (``enter``/``leave`` around a generation, a ``beat`` once a decode chunk
  after its tokens are read), the ``prefill`` and ``decode_step`` fault
  points, and :meth:`Engine.recover`, which zeroes the ring in place (the
  captured graphs hold its addresses);
- traces: a request's ``trace`` grows an ``engine`` span with a
  ``prefill`` child and one ``decode_chunk`` child a chunk.  Every hook
  runs in the host loop between replays, never inside the captured step.

There is no compile-probe and no fallback: a kernel that fails to build or
launch raises, and the request fails with it.
"""

from __future__ import annotations

import codecs
import dataclasses
import logging
import threading
import time
import uuid
from typing import Iterator, Sequence

import torch

from ..gguf import GGUFFile
from ..models.config import ModelConfig
from ..models.generate import (
    DecodeGraphs,
    first_sample,
    generate_chunk,
    init_state,
    prefill,
    prefill_chunk,
    verify_round,
)
from ..models.llama import cache_nbytes, init_cache
from ..models.params import decode_loop_plan, load_params
from ..obs.devtime import record_dispatch
from ..obs.memledger import register_component
from ..ops._kernels import library
from ..ops.attention import flash_takes
from ..parallel.mesh import (
    Mesh,
    default_devices,
    init_sharded_cache,
    ring_device,
    ring_nbytes_by_device,
    ring_zero_,
    shard_params,
)
from ..sampling.sample import SamplingParams, sampling_tensors
from ..tokenizer import apply_chat_template, detect_chat_template, tokenizer_from_gguf
from ..utils.device import resolve_device
from ..utils.faults import FAULTS
from ..utils.health import DeadlineExceeded, EngineUnavailable, Heartbeat
from ..utils.tracing import maybe_profile

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (128, 256, 512, 1024)


class _TextEmitter:
    """Incremental text emission over the append-only token list: an
    incremental UTF-8 decoder with stop-string prefix holdback, plus the
    final flush (the reference's emitter, unchanged)."""

    def __init__(self, engine: "Engine", stops):
        self._eng = engine
        self._stops = stops
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
        self._sent_bytes = 0
        self._held = ""        # withheld text (possible stop-string prefix)
        self._n_emitted = 0    # characters already yielded

    def process(self, gen: list, live: bool) -> tuple[str, bool]:
        """One decode of the token stream → (ready_text, stop_hit).  On a
        stop hit nothing is emitted; with ``live`` False only the stop check
        runs."""
        eng = self._eng
        bts = eng.tokenizer.decode_bytes(gen)
        text = bts.decode("utf-8", errors="replace")
        if eng._find_stop_str(text, self._stops) != -1:
            return "", True
        if not live:
            return "", False
        self._held += self._dec.decode(bts[self._sent_bytes:])
        self._sent_bytes = len(bts)
        hold = eng._stop_prefix_holdback(self._held, self._stops)
        ready = self._held[:len(self._held) - hold]
        self._held = self._held[len(self._held) - hold:]
        self._n_emitted += len(ready)
        return ready, False

    def step(self, gen: list, done: bool, finish: str) -> tuple[str, str, bool]:
        """(ready_text, finish, done); a stop hit forces ("", "stop", True)."""
        ready, hit = self.process(gen, live=not done)
        if hit:
            return "", "stop", True
        return ready, finish, done

    def final(self, gen: list, finish: str) -> tuple[str, str]:
        """(text_tail, finish) once generation has ended."""
        text = self._eng._decode_text(gen)
        cut = self._eng._find_stop_str(text, self._stops)
        if cut != -1:
            text = text[:cut]
            finish = "stop"
        tail = text[self._n_emitted:] if len(text) > self._n_emitted else ""
        return tail, finish


#: prompt attention by name: the reference's ``xla`` and ``pallas``, and
#: ``flash``, the port's name of the kernel path that ``pallas`` selects
ATTN_IMPLS = {"xla": "xla", "pallas": "flash", "flash": "flash"}


def resolve_attn_impl(attn_impl: str, cfg: ModelConfig, device: torch.device) -> str:
    """``cfg.attn_impl`` for a requested ``attn_impl`` (``auto`` or a key of
    :data:`ATTN_IMPLS`): ``auto`` takes the flash kernel on the GPU where
    it takes the model's head size and GQA group, else the score matrix."""
    if attn_impl == "auto":
        return ("flash" if device.type == "cuda"
                and flash_takes(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) else "xla")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be auto|{'|'.join(ATTN_IMPLS)}, got {attn_impl!r}")
    return ATTN_IMPLS[attn_impl]


def ledger_by_shard(eng, nbytes: dict) -> dict:
    """Memory-ledger rows of a mesh engine: one a shard, the model labelled
    ``<model>@<shard>`` (``Mesh.label``: ``dp0.tp1.sp0:cuda:0``)."""
    return {f"{eng.model_name}@{k}": b for k, b in nbytes.items()}


def _ledger_ring(eng) -> int | dict:
    if eng.mesh is None:
        return cache_nbytes(eng.cfg)
    return ledger_by_shard(eng, ring_nbytes_by_device(eng._cache))


def _ledger_weights(eng) -> int | dict:
    if eng.mesh is None:
        return eng.weight_bytes
    return ledger_by_shard(eng, eng.params.nbytes_by_device())


class Engine:
    """Loads a GGUF model and serves chat completions on one device.

    ``device`` defaults to the GPU and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch path (tests).

    A subclass that serves over a mesh (engine/batched.py's tp/dp lane
    engines, engine/sp.py) returns it from :meth:`_make_mesh`: the weights
    are then laid over it (``parallel.mesh.shard_params``) and the serial
    ring is a ``ShardedRing`` (:meth:`_new_ring`) before anything is built
    over them.  The class flags say what such a ring cannot serve."""

    #: prompts prefill as ``prefill_chunk`` slices past one slice (off:
    #: one :meth:`_prefill_call` a bucket, as the sequence-parallel ring
    #: prefills)
    _SLICE_PREFILL = True
    #: the paged KV pool can serve this engine (off: ``kv_paged`` is
    #: logged and the dense ring serves, as in the reference)
    _KV_PAGED = True
    #: the layer-looped decode can serve this engine (off: the knob raises)
    _DECODE_LOOP = True
    #: the compile-registry program a decode chunk dispatches
    _DECODE_PROGRAM = "decode_chunk"
    #: the attention this engine serves, whatever ``attn_impl`` asks (None:
    #: :func:`resolve_attn_impl`'s choice; the sequence-parallel engine's
    #: ring)
    _ATTN_IMPL: str | None = None

    # -- lock discipline (machine-checked: lfkt-lint LOCK001-004) ------------
    # _lock is the single-generator mutex: the KV ring and its prefix
    # claim may only change under it.  _id_lock is the tiny counter lock
    # shared with scheduler threads (seed sequence, last-timings swap).
    _GUARDED_BY = {
        "_cache": "_lock",
        "_prefix_ids": "_lock",
        "_paged_lease": "_lock",
        "recoveries": "_lock",
        "_requests": "_id_lock",
        "last_timings": "_id_lock",
    }
    # the KV ring the decode graphs read and write by address (lfkt-lint
    # PIN001): recovery zeroes it in place, never reallocates it
    _GRAPH_PINNED = ("_cache",)

    def __init__(
        self,
        model_path: str | None,
        n_ctx: int = 1024,
        weight_format: str = "auto",
        decode_chunk: int = 8,
        prefill_buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_gen_tokens: int = 512,
        seed: int = 0,
        attn_impl: str = "auto",   # auto | xla | pallas (= flash) (prompt passes)
        kv_dtype: str | None = None,  # bf16 | int8 KV cache; None keeps the cfg's
        decode_layer_unroll: int | None = None,  # layers per decode launch; None: settings
        spec_decode: str = "off",  # off | lookup | auto (prompt-lookup speculation)
        spec_draft: int = 8,        # draft tokens a verify round
        prefix_cache: bool = True,  # reuse the previous request's KV prefix
        prefix_min: int = 32,       # shortest common prefix worth reusing
        prefill_chunk: int = 256,   # prompt slice size for large buckets
        kv_paged: bool = False,     # the paged KV pool + radix prefix cache
        kv_page_tokens: int = 128,  # token slots per pool page
        kv_pool_pages: int = 0,     # pool size in pages (0 = auto)
        kv_spill_pages: int = 0,    # host spill tier in pages (0 = off)
        device: str | torch.device | None = None,
        *,
        kv_pool=None,               # adopt a shared KVPool (the multi-model
        #                             registry) instead of building a private one
        kv_namespace: str | None = None,  # this engine's radix namespace in
        #                             the pool: prefixes never match across them
        _parts: tuple | None = None,  # (params, cfg, tokenizer, template_kind)
    ):
        FAULTS.fire("load")   # injection point: a load that fails
        # validated before the file is read: a wrong LFKT_KV_DTYPE fails at
        # once, not after a multi-GB load
        if spec_decode not in ("off", "lookup", "auto"):
            raise ValueError(f"spec_decode must be off|lookup|auto, got {spec_decode!r}")
        if kv_dtype is not None and kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
        if spec_decode != "off" and not 1 <= spec_draft < n_ctx - 1:
            raise ValueError(f"spec_draft must be in [1, n_ctx-2], got {spec_draft}")
        # "auto" resolves after the load: it needs the weights' bytes
        self._spec_request = spec_decode
        self._spec_draft_request = spec_draft
        #: spec_decode="auto"'s decision record (engine/spec_auto.py)
        self.spec_auto_decision: dict | None = None
        self._spec_draft = spec_draft if spec_decode == "lookup" else 0
        self._warn_spec_unserved("spec_decode='lookup'")
        if decode_layer_unroll is None:
            from ..utils.config import get_settings

            decode_layer_unroll = get_settings().decode_layer_unroll
        decode_layer_unroll = int(decode_layer_unroll)
        if decode_layer_unroll < -1:
            raise ValueError(
                f"decode_layer_unroll must be >= -1 (0 = off, -1 = all layers "
                f"per launch), got {decode_layer_unroll}")
        self.n_ctx = n_ctx
        self.decode_chunk = decode_chunk
        self.max_gen_tokens = max_gen_tokens
        self._prefill_chunk = max(1, int(prefill_chunk))
        self._lock = threading.Lock()    # one generation at a time
        self._base_seed = seed
        self._id_lock = threading.Lock()
        self._requests = 0
        #: per-phase timings of the most recent completed request
        self.last_timings: dict | None = None
        #: the progress pulse the watchdog samples (engine/watchdog.py)
        self.heartbeat = Heartbeat()
        #: a utils.metrics.Metrics the server installs: prefill slices
        #: observe ``prefill_slice_seconds`` into it
        self.metrics_sink = None
        #: the sticky CUDA error that poisoned the context, once recover()
        #: found one: the engine then refuses every request
        self._poisoned: BaseException | None = None
        #: successful recover() calls (the fault drill reads it)
        self.recoveries = 0
        if _parts is not None:
            self.params, self.cfg, self.tokenizer, self.template_kind = _parts
            self.device = self.params.tok_emb.device
            self.model_name = "in-memory"
        else:
            self.device = resolve_device(device)
            if self.device.type == "cuda":
                # the kernel library before any weight: found (an image's
                # baked one) or built, so a pod without it fails here and
                # not at a request, and READY never waits on a build
                library()
            t0 = time.time()
            gf = GGUFFile(model_path)
            self.model_name = gf.metadata.get("general.name", model_path)
            self.cfg = ModelConfig.from_gguf(gf, n_ctx=n_ctx)
            self.tokenizer = tokenizer_from_gguf(gf)
            if weight_format == "auto":
                # small models keep exact bf16; an 8B model serves its
                # Q4_K/Q5_K/Q6_K/Q8_0 blocks fused on the GPU ("q4k" names
                # the fused formats, as in the reference).  The CPU has only the
                # plain versions of the fused kernels, which dequantize on
                # every call, so it keeps bf16 at any size.
                n_lin = self.cfg.n_layers * (
                    4 * self.cfg.dim * self.cfg.dim
                    + 3 * self.cfg.dim * self.cfg.ffn_dim)
                weight_format = ("q4k" if n_lin * 2 > 4e9
                                 and self.device.type == "cuda" else "bf16")
            self.params = load_params(gf, self.cfg, weight_format, self.device)
            self.template_kind = detect_chat_template(
                gf.metadata.get("tokenizer.chat_template"), self.tokenizer)
            logger.info("loaded %s (%s, %d layers, fmt=%s, %s) in %.1fs",
                        model_path, gf.architecture, self.cfg.n_layers,
                        weight_format, self.device, time.time() - t0)
        if kv_dtype is not None and kv_dtype != self.cfg.kv_dtype:
            self.cfg = dataclasses.replace(self.cfg, kv_dtype=kv_dtype)
        attn_impl = self._ATTN_IMPL or resolve_attn_impl(attn_impl, self.cfg, self.device)
        if attn_impl != self.cfg.attn_impl:
            self.cfg = dataclasses.replace(self.cfg, attn_impl=attn_impl)
        if decode_layer_unroll and not self._DECODE_LOOP:
            # the reference degrades here with an attribution record; the
            # port's record_degrade raises, so the knob does (ROADMAP C.3)
            raise ValueError(
                f"decode_layer_unroll={decode_layer_unroll}: {type(self).__name__} "
                "serves ring attention over a slot-sharded KV ring, which one "
                "looped kernel cannot — set LFKT_DECODE_LAYER_UNROLL=0")
        if decode_layer_unroll:
            # the reference's plan decision: fused layouts serve per-layer
            # decode (logged with the reason); a kernel that then fails to
            # build or launch raises, as every kernel of the port does
            fmts, reason = decode_loop_plan(self.params, self.cfg)
            if reason is not None:
                logger.warning("layer-looped decode unavailable (%s); serving "
                               "per-layer decode", reason)
                decode_layer_unroll = 0
        if decode_layer_unroll != self.cfg.decode_layer_unroll:
            self.cfg = dataclasses.replace(self.cfg,
                                           decode_layer_unroll=decode_layer_unroll)
        if self._spec_request == "auto":
            from .spec_auto import resolve_auto

            mode, self.spec_auto_decision = resolve_auto(self.params)
            self._spec_draft = self._spec_draft_request if mode == "lookup" else 0
            logger.info("spec_decode=auto resolved to %r: %s", mode, self.spec_auto_decision)
            if mode == "lookup":
                self._warn_spec_unserved("spec_decode=auto resolved to lookup, but")
        self.prefill_buckets = sorted(b for b in prefill_buckets if b <= self.cfg.n_ctx)
        if not self.prefill_buckets or self.prefill_buckets[-1] < self.cfg.n_ctx:
            self.prefill_buckets.append(self.cfg.n_ctx)
        self.mesh = self._make_mesh()
        if self.mesh is not None:
            self._check_mesh()
            self.params = shard_params(self.params, self.mesh, self.cfg)
        self._cache = self._new_ring()
        # the decode step as CUDA graphs over this ring (the card only)
        self._graphs = (DecodeGraphs(self.params, self.cfg, self._cache,
                                     draft_len=self._spec_draft if self._spec_enabled() else 0,
                                     program=self._DECODE_PROGRAM)
                        if self.device.type == "cuda" else None)
        # prompt-prefix KV reuse: the token ids whose KV occupy ring slots
        # [0, len) — read and written only under self._lock.  Speculation
        # excludes every reuse path, as in the reference: verify rounds
        # leave rejected drafts in ring slots
        self._prefix_cache = bool(prefix_cache) and not self._spec_draft
        self._prefix_min = max(1, int(prefix_min))
        self._prefix_ids: list[int] = []
        # the paged KV pool and its radix index (parallel/kvpool.py): one
        # reuse implementation per mode, so paging replaces the claim above
        paged = bool(kv_paged) and not self._spec_draft
        if paged and not self._KV_PAGED:
            logger.warning("LFKT_KV_PAGED=1 requested but %s shards the ring's n_ctx "
                           "dim; the paged pool needs it whole — serving the dense "
                           "ring", type(self).__name__)
            paged = False
        self._kv_paged = paged
        #: the in-flight request's pinned pool pages (one live lease: one
        #: request at a time); acquired in _paged_reuse, released by
        #: _drop_lease on every exit
        self._paged_lease = None
        #: the prefix-cache namespace every pool call carries: co-resident
        #: models sharing one arena never match each other's prefixes (the
        #: registry passes the manifest alias; a lone engine uses "")
        self._kv_ns = kv_namespace or ""
        self._kvpool = None
        if paged:
            from ..parallel.kvpool import KVPool

            self._prefix_cache = False
            # the arena lives on the ring's (first) device, an indexed one:
            # over a mesh it keeps whole-head pages there (parallel/kvpool.py)
            pool_device = ring_device(self._cache)
            if kv_pool is not None and (kv_pool.device != pool_device or
                                        not kv_pool.compatible(self.cfg, kv_page_tokens)):
                # only an identical per-page geometry can share the arena:
                # this model serves from a private pool instead of failing
                # the whole fleet
                logger.warning(
                    "model %r (n_layers=%d, n_kv_heads=%d, head_dim=%d, "
                    "kv_dtype=%s) cannot share the KV page arena: cache "
                    "page geometry differs from the pool's — serving it "
                    "from a private pool (docs/MULTIMODEL.md)",
                    self.model_name, self.cfg.n_layers,
                    self.cfg.n_kv_heads, self.cfg.head_dim,
                    self.cfg.kv_dtype)
                kv_pool = None
            if kv_pool is not None:
                self._kvpool = kv_pool
            else:
                self._kvpool = KVPool(self.cfg, page_tokens=kv_page_tokens,
                                      n_pages=kv_pool_pages, spill_pages=kv_spill_pages,
                                      sink_host=self, device=pool_device)
        #: the decode side's remote-prefill client (serving/disagg/), set by
        #: install_disagg; None is the off state — the serving paths read
        #: this one attribute
        self._disagg = None
        # weakly held (a closed engine's rows vanish with it); the providers
        # read sizes only, at snapshot time.  The pool registers its own rows
        register_component("weights", self, _ledger_weights)
        register_component("kv_ring", self, _ledger_ring)

    # -- the mesh (subclasses that shard return one) -----------------------
    def _make_mesh(self) -> Mesh | None:
        """The mesh this engine serves over; None: one device, unsharded."""
        return None

    def _mesh_devices(self, devices) -> list:
        """The device list a mesh is built from: the caller's, else every
        card (the CPU alone for a CPU engine)."""
        return list(devices) if devices is not None else default_devices(self.device)

    def _check_mesh(self) -> None:
        """What a mesh engine cannot serve raises here, before the shards
        are made: a mesh over distinct cards (ROADMAP A.1).  The paged pool,
        lane speculation and the layer-looped decode serve over a tp mesh
        (the looped kernel reads every shard of a layer in one launch, all
        of them on the one card)."""
        distinct = self.mesh.distinct
        if self.device.type == "cuda" and len(distinct) > 1:
            raise ValueError(
                f"{self.mesh}: the decode step is one CUDA graph on one card; a mesh "
                f"over {len(distinct)} cards is not served yet (ROADMAP A.1)")

    def _new_ring(self) -> dict:
        """A fresh serial ring: on the engine's device, or over its mesh
        (dp group 0's tp × sp shards)."""
        if self.mesh is None:
            return init_cache(self.cfg, self.device)
        return init_sharded_cache(self.cfg, self.mesh, tp_split=self.params.tp_heads)

    def _trace_attrs(self) -> dict:
        """The ``engine`` span's and /debug/requests' identity of this
        engine, with the mesh geometry when it serves over one."""
        who = {"engine": type(self).__name__, "model": self.model_name}
        if self.mesh is not None:
            m = self.mesh.describe()
            who.update(dp=m["dp"], tp=m["tp"], sp=m["sp"], devices=m["devices"])
        return who

    def _warn_spec_unserved(self, what: str) -> None:
        """Speculation is served by the serial Engine and the continuous
        scheduler; any other engine logs that it serves vanilla decode."""
        if self._spec_draft and type(self) is not Engine \
                and not getattr(self, "_SPEC_LANES", False):
            logger.warning("%s %s serves vanilla decode (see _spec_enabled)",
                           what, type(self).__name__)

    @property
    def kv_cache_bytes(self) -> int:
        """Device bytes of the KV ring (bf16 or int8, as ``cfg.kv_dtype``)
        and of the paged pool's arena when it serves."""
        pool = getattr(self, "_kvpool", None)
        return cache_nbytes(self.cfg) + (pool.arena_nbytes if pool is not None else 0)

    def kv_pool_occupancy(self) -> dict | None:
        """The paged pool's occupancy and event counters (/health
        ``engine.kv_pool``, the ``kv_pool_pages_*`` gauges); None when the
        pool is off."""
        pool = getattr(self, "_kvpool", None)
        if pool is None:
            return None
        return {**pool.occupancy(), **pool.stats()}

    @property
    def weight_bytes(self) -> int:
        """Device bytes of the weights."""
        return self.params.nbytes()

    @classmethod
    def from_parts(cls, params, cfg: ModelConfig, tokenizer,
                   template_kind: str = "llama3", **kw) -> "Engine":
        """Build from in-memory parts (tests); the device is the params'."""
        return cls(None, n_ctx=cfg.n_ctx,
                   _parts=(params, cfg, tokenizer, template_kind), **kw)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release the decode graphs and their memory pool; the engine
        takes no request after this."""
        with self._lock:
            if self._graphs is not None:
                self._graphs.close()
                self._graphs = None

    def warmup(self):  # lfkt: blocks-under[_lock] -- warmup compiles and syncs under the engine lock by design: a request must never race a half-warmed cache
        """Build the kernels and size the allocator before the first
        request: on the card, capture the decode step for the default
        ``top_k`` (before any request can run, so nothing else uses the
        card during the capture); then one short greedy completion, then
        one prompt pass at the largest bucket (the most activation memory a
        request can take)."""
        t0 = time.time()
        if self._graphs is not None:
            with self._lock:
                self._graphs.capture(SamplingParams().top_k)
                if self._spec_enabled():
                    self._graphs.capture_verify(SamplingParams().top_k)
                # the capture's warm-up step wrote a ring slot
                self._prefix_ids = []
        self.create_chat_completion(
            [{"role": "user", "content": "hi hi hi hi hi hi hi hi"}],
            max_tokens=2 * self.decode_chunk + 1, temperature=0.0)
        with self._lock:
            b = self.prefill_buckets[-1]
            self._prefix_ids = []
            logits = self._prefill_padded([0] * (b - 1), b - 1, b)
            logits.cpu()
        logger.info("warmup done in %.1fs", time.time() - t0)

    def _prefill_padded(self, ids: list, n_prompt: int, bucket: int, pspan=None):  # lfkt: holds[_lock]
        """Bucket prefill, whole or sliced; returns the last real token's
        logits.  Slicing stops at the slice holding the last real token:
        later slices would only write padding that is never attended.  Each
        slice's host time goes to ``prefill_slice_seconds`` and, traced, to
        a ``prefill_slice`` event on ``pspan``."""
        padded = torch.zeros(bucket, dtype=torch.int64)
        padded[:n_prompt] = torch.tensor(ids, dtype=torch.int64)
        padded = padded.to(self.device)
        if bucket <= self._prefill_chunk or not self._SLICE_PREFILL:
            return self._prefill_call(padded, n_prompt)
        C = self._prefill_chunk
        logits = None
        off = 0
        last = n_prompt - 1
        while off <= last:
            t_s = time.time()
            n = min(C, bucket - off)
            li = min(max(last - off, 0), n - 1)
            record_dispatch("prefill_chunk")
            lg = prefill_chunk(self.params, self.cfg, padded[off:off + n], off,
                               li, self._cache)
            if off <= last < off + n:
                logits = lg
            dt = time.time() - t_s
            if self.metrics_sink is not None:
                self.metrics_sink.observe("prefill_slice_seconds", dt)
            if pspan is not None:
                pspan.event("prefill_slice", offset=off, tokens=n,
                            host_s=round(dt, 6))
            off += n
        return logits

    def _prefill_call(self, tokens: torch.Tensor, length: int) -> torch.Tensor:
        """One whole-bucket prompt pass from slot 0 into the ring (the
        sequence-parallel engine reroutes it onto its ring)."""
        record_dispatch("prefill")
        return prefill(self.params, self.cfg, tokens, length, self._cache)

    def _decode_chunk_call(self, state: dict, st: dict, n_steps: int,
                           top_k: int) -> torch.Tensor:
        """Queue ``n_steps`` decode steps over ``state`` (rerouted likewise)."""
        return generate_chunk(self.params, self.cfg, state, st, n_steps, top_k=top_k)

    def _next_seed(self) -> int:
        with self._id_lock:
            s = self._base_seed + self._requests
            self._requests += 1
            return s

    def _record_timings(self, timings: dict) -> None:
        with self._id_lock:
            self.last_timings = timings

    def _note_error(self, exc: BaseException) -> None:
        """Record an engine-side failure on the heartbeat for the watchdog's
        burst detector.  A ``ValueError`` is the client's fault (an
        oversized prompt, a bad parameter) and never counts; a
        ``torch.OutOfMemoryError`` (or an injected ``SimulatedOOM``) is the
        engine's and does."""
        if isinstance(exc, ValueError):
            return
        self.heartbeat.record_error(exc)

    def failure(self) -> BaseException | None:
        """The fault the engine cannot serve through (the watchdog's
        ``failure()`` hook): the sticky CUDA error :meth:`recover` found."""
        return self._poisoned

    def recover(self) -> bool:
        """Re-initialize the serving state after a watchdog trip.  Refuses
        (False) while a generation holds the lock, and when the CUDA
        context is poisoned: a sticky error (an illegal address, a failed
        launch) makes every later call fail, so only a restart (DEAD)
        clears it."""
        FAULTS.fire("recover")   # injection point: a recovery that fails
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self._poisoned is None and self.device.type == "cuda":
                try:
                    torch.cuda.synchronize(self.device)
                except Exception as e:  # noqa: BLE001 — a sticky error
                    logger.error("CUDA context poisoned: %s", e)
                    self._poisoned = e
            if self._poisoned is not None:
                return False
            self._recover_locked()
            self.heartbeat.reset()
            self.recoveries += 1
            return True
        finally:
            self._lock.release()

    def _recover_locked(self) -> None:  # lfkt: holds[_lock]
        """Zero the ring in place and drop its prefix claim, with the lock
        held; under the paged pool also drop the lease and reset the pool
        (nothing resident is trustworthy after a trip).  The ring is never
        reallocated: the captured decode graphs read and write these very
        tensors, and a new ring would be one the replays never see."""
        self._zero_ring()
        self._prefix_ids = []
        if self._kvpool is not None:
            self._drop_lease()
            self._kvpool.reset()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _zero_ring(self) -> None:
        """The ring zeroed in place: the port's counterpart of the
        reference's cold ring."""
        ring_zero_(self._cache)

    @staticmethod
    def _deadline_hit(ctx) -> bool:
        """True when the caller's deadline passed or its abort callback
        fired; the decode loop checks once per chunk, so a timed-out or
        abandoned request frees the device within one chunk."""
        abort = ctx.get("abort")
        if abort is not None and abort():
            return True
        deadline = ctx.get("deadline")
        return deadline is not None and time.time() > deadline

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.cfg.n_ctx

    def tokenize_messages(self, messages: Sequence[dict]) -> list[int]:
        return apply_chat_template(self.tokenizer, messages, kind=self.template_kind)

    # ------------------------------------------------------------------
    def create_chat_completion(
        self,
        messages: Sequence[dict],
        stream: bool = False,
        temperature: float = 0.2,
        top_p: float = 0.95,
        top_k: int = 40,
        min_p: float = 0.05,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        repeat_penalty: float = 1.1,
        max_tokens: int | None = None,
        stop: Sequence[str] | str | None = None,
        seed: int | None = None,
        deadline: float | None = None,
        abort=None,
        trace=None,
    ):
        """OpenAI-chat-shaped completion (dict), or an iterator of chunks
        when ``stream=True``.  Safe to call from a worker thread.
        ``deadline`` (absolute ``time.time()``) and ``abort`` (a callable
        that returns True when the caller gave up) end the generation
        within one decode chunk with ``finish_reason="deadline"``.
        ``trace`` (an obs.trace.Trace, or None when the request is sampled
        out) receives the engine's spans."""
        if stop is None:
            stop = []
        elif isinstance(stop, str):
            stop = [stop]
        sp = SamplingParams(
            temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p,
            frequency_penalty=frequency_penalty, presence_penalty=presence_penalty,
            repeat_penalty=repeat_penalty,
        )
        if stream:
            return self._generate_stream(messages, sp, max_tokens, stop, seed,
                                         deadline=deadline, abort=abort,
                                         trace=trace)
        return self._generate(messages, sp, max_tokens, stop, seed,
                              deadline=deadline, abort=abort, trace=trace)

    # ------------------------------------------------------------------
    def _start(self, messages, sp: SamplingParams, seed, espan=None, pre_ids=None):  # lfkt: holds[_lock]
        """Prefill + first token.  Returns the mutable generation context.
        ``espan`` (the traced request's ``engine`` span, or None) grows a
        ``prefill`` child covering tokenize → first sampled token.
        ``pre_ids`` is the prompt the pre-lock disagg hop already
        tokenized."""
        t0 = time.time()
        self.heartbeat.beat()
        FAULTS.fire("prefill")
        ids = pre_ids if pre_ids is not None else self.tokenize_messages(messages)
        n_prompt = len(ids)
        if n_prompt >= self.cfg.n_ctx:
            raise ValueError(
                f"Requested tokens ({n_prompt}) exceed context window of {self.cfg.n_ctx}")
        bucket = self._bucket_for(n_prompt)
        st = sampling_tensors(sp, self.device)
        explicit_seed = seed is not None
        if seed is None:
            seed = self._next_seed()
        else:
            self._next_seed()  # keep the auto-seed sequence advancing
        # an explicit seed asks for reproducibility: the reuse pass scores
        # bf16-rounded cached K/V where a full prefill scores fresh ones,
        # so same-seed calls always take the full prefill
        reuse = 0 if explicit_seed else self._prefix_reuse_len(ids, n_prompt, bucket)
        pspan = None
        if espan is not None:
            pspan = espan.child("prefill", t0=t0)
        if self._kv_paged and not explicit_seed:
            # the radix index replaces the claim: matched pages are copied
            # into the ring in place and pinned for this request
            reuse = self._paged_reuse(ids, n_prompt, bucket, pspan)
        if pspan is not None:
            pspan.set(n_prompt=n_prompt, bucket=bucket, reused=reuse)
        # claim nothing while this request is in flight: an exception past
        # here must not leave a claim over a ring of unknown contents
        self._prefix_ids = []
        if reuse:
            suffix = ids[reuse:]
            s = len(suffix)
            sbucket = self._bucket_for(s)
            tokens = torch.tensor(suffix + [0] * (sbucket - s), dtype=torch.int64,
                                  device=self.device)
            record_dispatch("prefill_chunk")
            logits = prefill_chunk(self.params, self.cfg, tokens, reuse, s - 1,
                                   self._cache)
        else:
            logits = self._prefill_padded(ids, n_prompt, bucket, pspan=pspan)
        if self.device.type == "cpu":
            state = init_state(self._cache, ids, seed, self.device)
        elif self._graphs is None:
            raise RuntimeError("the engine is closed")
        else:
            st = self._graphs.knobs(st)
            state = self._graphs.state(ids, seed)
        record_dispatch("first_sample")
        first = int(first_sample(logits, state, st, top_k=sp.top_k))  # host sync
        ttft_s = time.time() - t0
        if pspan is not None:
            pspan.set(ttft_s=round(ttft_s, 6))
            pspan.end()
        return {
            "state": state, "st": st, "sp": sp, "n_prompt": n_prompt,
            "ids": [], "prompt_ids": ids, "first": first, "t0": t0,
            "reused": reuse, "ttft_s": ttft_s, "bucket": bucket, "span": espan,
        }

    def _prefix_reuse_len(self, ids: list, n_prompt: int, bucket: int) -> int:
        """Longest usable common prefix of ``ids`` and the KV resident in
        the ring, or 0 when reuse is off, too short, or would not shrink the
        prefill bucket.  Always leaves ≥ 1 token to prefill, and keeps the
        padded suffix inside the ring (shortening the reuse near n_ctx)."""
        if not self._prefix_cache:
            return 0
        prev = self._prefix_ids
        lim = min(len(prev), n_prompt - 1)
        i = 0
        while i < lim and prev[i] == ids[i]:
            i += 1
        if i < self._prefix_min:
            return 0
        for b in self.prefill_buckets:
            if b >= bucket:
                break  # the suffix pads into as large a pass: nothing saved
            r = min(i, self.cfg.n_ctx - b)
            if r >= self._prefix_min and n_prompt - r <= b:
                return r
        return 0

    def _drop_lease(self) -> None:  # lfkt: holds[_lock]
        """Unpin the current request's pool pages (idempotent)."""
        if self._paged_lease is not None:
            self._kvpool.release(self._paged_lease)
            self._paged_lease = None

    def _paged_reuse(self, ids: list, n_prompt: int, bucket: int, pspan=None) -> int:  # lfkt: holds[_lock]
        """Radix prefix reuse: the longest cached whole-page prefix that
        fits :meth:`_prefix_reuse_len`'s constraints, page-aligned, copied
        into the ring in place and pinned for the request.  Returns the
        reused token count (0 = full prefill).  A failed copy drops the
        lease, zeroes the ring (its contents are unknown) and raises."""
        self._drop_lease()   # a prior request's failure may have left one
        pool = self._kvpool
        T = pool.page_tokens
        i = min(pool.match_len(ids, namespace=self._kv_ns), n_prompt - 1)
        r_fit = 0
        # the suffix's padded slice must stay inside the ring and land in a
        # strictly smaller bucket; pages are the restore grain
        for b in self.prefill_buckets:
            if b >= bucket:
                break
            r = (min(i, self.cfg.n_ctx - b) // T) * T
            if r >= max(self._prefix_min, T) and n_prompt - r <= b:
                r_fit = r
                break
        if r_fit == 0:
            pool.note_miss()
            return 0
        lease = pool.acquire(ids, r_fit, span=pspan, namespace=self._kv_ns)
        if lease is None:    # raced an eviction, or a spill restore failed
            return 0
        self._paged_lease = lease
        try:
            pool.restore(lease, self._cache, span=pspan)
        except BaseException:
            self._drop_lease()
            try:
                self._zero_ring()
            except Exception as e:  # noqa: BLE001 — the restore's error wins
                logger.error("zeroing the ring after a failed restore failed: %s", e)
            raise
        if pspan is not None:
            pspan.set(reused_pages=len(lease.page_ids), matched_tokens=i)
        return lease.tokens

    # -- disaggregated prefill/decode (serving/disagg/) ---------------------
    def install_disagg(self, client) -> None:
        """Arm remote prefill (``LFKT_DISAGG_ROLE`` decode or both): admitted
        prompts hop to the prefill tier, whose pages import into the local
        pool's radix, so :meth:`_paged_reuse` (and the continuous
        scheduler's admission reuse) restores them like any local commit.
        Requires the paged pool — pages are the wire format."""
        if self._kvpool is None:
            raise ValueError(
                "install_disagg requires LFKT_KV_PAGED=1: the disagg "
                "wire ships KV pool pages (docs/RUNBOOK.md 'Operating a "
                "split prefill/decode fleet')")
        self._disagg = client

    def _remote_prefill(self, messages, deadline, trace) -> list | None:
        """One bounded remote-prefill hop for the serial path, *before* the
        generation lock (in ``both`` mode the loopback page service takes
        that lock to prefill: holding it here would deadlock).  Never
        raises: the client degrades every wire failure to the local prefill
        itself.  Returns the tokenized prompt, so :meth:`_start` does not
        tokenize again (None when tokenizing failed: :meth:`_start` then
        raises the real error)."""
        try:
            ids = self.tokenize_messages(messages)
        except Exception:  # noqa: BLE001 — _start re-raises the real error
            return None
        try:
            if len(ids) >= self.cfg.n_ctx:
                return ids              # _start's oversized-prompt error
            span = trace.span("disagg") if trace is not None else None
            try:
                self._disagg.prefetch(ids, namespace=self._kv_ns,
                                      deadline=deadline, span=span)
            finally:
                if span is not None:
                    span.end()
        except Exception:  # noqa: BLE001 — the hop is an optimization: any
            # failure degrades to the local prefill _start runs anyway
            logger.exception("disagg prefetch failed; serving local prefill")
        return ids

    def _remote_prefill_ids(self, ids, deadline, span=None) -> None:
        """The tokenized hop (the continuous scheduler's admission path);
        the same never-raise contract as :meth:`_remote_prefill`."""
        try:
            self._disagg.prefetch(ids, namespace=self._kv_ns,
                                  deadline=deadline, span=span)
        except Exception:  # noqa: BLE001 — degrade to local prefill
            logger.exception("disagg prefetch failed; serving local prefill")

    def prefill_to_pages(self, ids, *, namespace: str = "", deadline=None):  # lfkt: blocks-under[_lock] -- the serial engine's lock IS the request serialization: prefill syncs and pool spills run under it by design
        """The prefill tier's page service (serving/disagg/prefiller.py):
        make sure the whole-page prefix of ``ids`` is committed in the local
        pool — the tier's own radix first, so a system prompt hot across
        many decode replicas prefills once a tier, else a prompt pass into
        the serial ring, in place (its graphs hold its addresses) — then pin
        it, export host page stacks and release.  Returns ``(leaves, tokens,
        first_token)``, or None when no whole page is exportable;
        ``first_token`` is the prompt's greedy continuation when this call
        ran the prompt pass (advisory: the decode side samples its own), else
        None."""
        pool = self._kvpool
        if pool is None:
            raise ValueError(
                "prefill_to_pages requires LFKT_KV_PAGED=1 (pages are "
                "the disagg wire format)")
        T = pool.page_tokens
        ids = [int(t) for t in ids]
        n_prompt = len(ids)
        if n_prompt >= self.cfg.n_ctx:
            raise ValueError(
                f"Requested tokens ({n_prompt}) exceed context window "
                f"of {self.cfg.n_ctx}")
        keep = (n_prompt // T) * T
        if keep < T:
            return None                  # prompt shorter than one page
        first_token = None
        with self._lock:
            self._check_usable()
            self.heartbeat.enter()
            try:
                have = pool.match_len(ids[:keep], namespace=namespace)
                if have < keep:
                    if deadline is not None and time.time() > deadline:
                        # the decode side already abandoned this request
                        raise DeadlineExceeded("deadline expired before remote prefill")
                    self.heartbeat.beat()
                    FAULTS.fire("prefill")
                    self._drop_lease()
                    self._prefix_ids = []
                    logits = self._prefill_padded(ids, n_prompt, self._bucket_for(n_prompt))
                    first_token = int(torch.argmax(logits.reshape(-1)))   # host sync
                    pool.commit(ids[:keep], self._cache, namespace=namespace)
                # a squeezed pool may have committed only the leading pages
                # that fit: export what the index truly holds
                have = min(pool.match_len(ids[:keep], namespace=namespace), keep)
                if have < T:
                    return None
                lease = pool.acquire(ids[:keep], have, namespace=namespace)
                if lease is None:        # raced an eviction: a miss, not an
                    return None          # error — the peer falls back
                try:
                    leaves = pool.export_pages(lease)
                    tokens = lease.tokens
                finally:
                    pool.release(lease)
                return leaves, tokens, first_token
            finally:
                self.heartbeat.leave()

    def _finish(self, ctx) -> dict:  # lfkt: holds[_lock]
        """Record the ring's new prefix claim — under the paged pool, commit
        the conversation's whole pages and unpin the lease — and the
        request's timings (on the traced request's ``engine`` span too,
        which it closes)."""
        decode_s = time.time() - ctx["t0"] - ctx["ttft_s"]
        n = len(ctx["ids"])
        if self._kv_paged:
            # ring slots [0, n_prompt + n - 1) hold the prompt and every
            # generated token but the last; cached pages deduplicate, so a
            # follow-up turn stores only its delta
            keep = ctx["n_prompt"] + max(n - 1, 0)
            self._kvpool.commit((ctx["prompt_ids"] + ctx["ids"])[:keep], self._cache,
                                span=ctx.get("span"), namespace=self._kv_ns)
            self._drop_lease()
        elif self._prefix_cache:
            # ring slots [0, n_prompt + n - 1) hold the prompt and every
            # generated token but the last (it is never fed)
            keep = ctx["n_prompt"] + max(n - 1, 0)
            self._prefix_ids = (ctx["prompt_ids"] + ctx["ids"])[:keep]
        timings = {
            "ttft_s": ctx["ttft_s"],
            "decode_s": decode_s,
            "prompt_tokens": ctx["n_prompt"],
            "completion_tokens": n,
            "prefix_reused_tokens": ctx.get("reused", 0),
            "bucket": ctx.get("bucket", 0),
            "model": self.model_name,
            # the first token came out of prefill; decode produced n-1
            "tokens_per_sec": (n - 1) / decode_s if n > 1 and decode_s > 0 else 0.0,
        }
        if "spec" in ctx:      # speculative decoding: acceptance telemetry
            timings["spec"] = ctx["spec"]
        self._record_timings(timings)
        espan = ctx.get("span")
        if espan is not None:
            espan.set(**{k: round(v, 6) if isinstance(v, float) else v
                         for k, v in timings.items() if not isinstance(v, dict)})
            espan.end()
        return timings

    def _token_budget(self, max_tokens, n_prompt):
        budget = self.max_gen_tokens if max_tokens is None else max_tokens
        return max(0, min(budget, self.cfg.n_ctx - n_prompt - 1))

    def _decode_text(self, all_ids):
        return self.tokenizer.decode(all_ids, skip_special=True)

    @staticmethod
    def _find_stop_str(text: str, stops) -> int:
        cut = -1
        for s in stops:
            i = text.find(s)
            if i != -1 and (cut == -1 or i < cut):
                cut = i
        return cut

    @staticmethod
    def _stop_prefix_holdback(text: str, stops) -> int:
        """Length of the longest suffix of ``text`` that is a proper prefix
        of a stop string; streaming withholds it until the next chunk shows
        whether the stop completes."""
        best = 0
        for s in stops:
            for k in range(min(len(s) - 1, len(text)), best, -1):
                if text.endswith(s[:k]):
                    best = k
                    break
        return best

    def _next_steps(self, produced: int, pos: int, budget: int) -> int:
        """Size of the next decode chunk from host-tracked progress."""
        n = min(self.decode_chunk, budget - produced)
        n = min(n, self.cfg.n_ctx - pos - 1)  # cache slots n_prompt..n_ctx-1
        return max(0, n)

    def _decode_chunk(self, ctx, n_steps: int) -> tuple:
        """Queue ``n_steps`` decode steps; returns what :meth:`_read_chunk`
        takes.  On the card the chunk's tokens are copied, behind its
        replays, into pinned host memory and an event is recorded after
        the copy: the read then waits for this chunk only, not for the next
        one, which the loop queues before it reads this one."""
        record_dispatch(self._DECODE_PROGRAM)
        toks = self._decode_chunk_call(ctx["state"], ctx["st"], n_steps, ctx["sp"].top_k)
        if toks.device.type != "cuda":
            return toks, None
        host = torch.empty(n_steps, dtype=torch.int64, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    @staticmethod
    def _read_chunk(pending: tuple) -> list:
        """A queued chunk's tokens on the host (the chunk's sync)."""
        toks, copied = pending
        if copied is not None:
            copied.synchronize()
        return toks.tolist()

    # -- speculative decoding (prompt-lookup drafts) ----------------------
    def _spec_enabled(self) -> bool:
        """Lookup speculation is the serial Engine's (the continuous
        scheduler serves its own); other engines serve vanilla decode."""
        return self._spec_draft > 0 and type(self) is Engine

    @staticmethod
    def _lookup_draft(history: list, D: int, max_ngram: int = 3):
        """Prompt-lookup draft: the most recent earlier occurrence of the
        last n-gram (n = max_ngram..1) in ``history``, its continuation
        zero-padded to exactly ``D`` tokens; None when no n-gram recurs (the
        caller decodes plainly).  The reference's heuristic, unchanged."""
        n_hist = len(history)
        for n in range(max_ngram, 0, -1):
            if n_hist < n + 1:
                continue
            pat = history[-n:]
            for j in range(n_hist - n - 1, -1, -1):
                if history[j:j + n] == pat:
                    cont = history[j + n:j + n + D]
                    if cont:
                        return cont + [0] * (D - len(cont))
        return None

    def _run_spec(self, ctx, max_tokens, stops):
        """:meth:`_run` under speculation: each round drafts up to
        ``spec_draft`` tokens from n-gram repetition in prompt and
        generation, verifies them in one D+1-row forward (on the card one
        replay of the verify graph) and emits the agreeing prefix and one
        true sample; a round without a draft decodes one plain chunk.  Not
        pipelined: the next draft needs this round's tokens on the host."""
        stop_ids = self.tokenizer.stop_ids
        budget = self._token_budget(max_tokens, ctx["n_prompt"])
        gen: list[int] = []
        em = _TextEmitter(self, stops)
        finish = "length"
        first = ctx["first"]
        if budget <= 0:
            yield "", True, "length"
            return
        if first in stop_ids:
            yield "", True, "stop"
            return
        gen.append(first)
        history = list(ctx["prompt_ids"]) + gen
        pos = ctx["n_prompt"]
        D = self._spec_draft
        done = len(gen) >= budget
        # accepted / drafted is the number that says whether speculation pays
        stats = ctx.setdefault("spec", {"verify_steps": 0, "drafted": 0, "accepted": 0,
                                        "fallback_steps": 0})
        ready, finish, done = em.step(gen, done, finish)
        if ready:
            yield ready, False, finish
        espan = ctx.get("span")
        while not done:
            if self._deadline_hit(ctx):
                finish = "deadline"
                break
            self.heartbeat.beat()
            FAULTS.fire("decode_step")
            cspan = espan.child("decode_chunk") if espan is not None else None
            remaining = budget - len(gen)
            capacity = self.cfg.n_ctx - pos - 1   # ring slots left to write
            draft = (self._lookup_draft(history, D)
                     if remaining > 1 and capacity > D else None)
            if draft is not None:
                record_dispatch("spec_verify")
                toks, cnt = verify_round(self.params, self.cfg, ctx["state"], ctx["st"],
                                         draft, top_k=ctx["sp"].top_k)   # host sync
                toks = toks[:min(cnt, remaining)]
                pos += cnt
                stats["verify_steps"] += 1
                stats["drafted"] += D
                stats["accepted"] += cnt - 1      # beyond the always-free one
            else:
                n = self._next_steps(len(gen), pos, budget)
                if n <= 0:
                    break
                toks = self._read_chunk(self._decode_chunk(ctx, n))
                pos += n
                stats["fallback_steps"] += 1
            for t in toks:
                if t in stop_ids:
                    finish = "stop"
                    done = True
                    break
                gen.append(t)
                history.append(t)
            if not done and len(gen) >= budget:
                done = True
            self.heartbeat.beat()
            if cspan is not None:
                cspan.set(tokens=len(gen), kind="verify" if draft is not None else "chunk")
                cspan.end()
                ctx["trace"].note(tokens=len(gen))
            ready, finish, done = em.step(gen, done, finish)
            if ready:
                yield ready, False, finish

        ctx["ids"] = gen
        tail, finish = em.final(gen, finish)
        yield tail, True, finish

    def _run(self, ctx, max_tokens, stops):
        """Generate; yields (new_text, done, finish_reason) increments.

        Pipelined: chunk k+1 is queued on the device before chunk k's
        tokens are read, and the read waits for chunk k alone, so a cancel,
        stop or deadline found after it ends the generation while chunk k+1
        still runs.  If a stop lands mid-chunk, the extra chunk's cache
        writes are harmless: attention masks by position and the next
        request prefills over them."""
        if self._spec_enabled():
            yield from self._run_spec(ctx, max_tokens, stops)
            return
        stop_ids = self.tokenizer.stop_ids
        budget = self._token_budget(max_tokens, ctx["n_prompt"])
        gen: list[int] = []
        em = _TextEmitter(self, stops)
        finish = "length"
        first = ctx["first"]
        if budget <= 0:
            yield "", True, "length"
            return
        if first in stop_ids:
            yield "", True, "stop"
            return
        gen.append(first)

        pos = ctx["n_prompt"]
        n_cur = self._next_steps(len(gen), pos, budget)
        pending = self._decode_chunk(ctx, n_cur) if n_cur > 0 else None
        done = pending is None
        # emit the first token's text now, while chunk 1 runs
        ready, finish, done = em.step(gen, done, finish)
        if ready:
            yield ready, False, finish
        espan = ctx.get("span")   # None when untraced: no span, no trace lock
        while not done:
            if self._deadline_hit(ctx):
                finish = "deadline"
                break
            FAULTS.fire("decode_step")
            cspan = espan.child("decode_chunk") if espan is not None else None
            pos += n_cur
            n_nxt = self._next_steps(len(gen) + n_cur, pos, budget)
            nxt = self._decode_chunk(ctx, n_nxt) if n_nxt > 0 else None
            for t in self._read_chunk(pending):  # host sync, overlapped
                if t in stop_ids:
                    finish = "stop"
                    done = True
                    break
                gen.append(t)
            self.heartbeat.beat()                # the chunk's tokens are in
            pending, n_cur = nxt, n_nxt
            if pending is None:
                done = True
            if cspan is not None:
                cspan.set(tokens=len(gen))
                cspan.end()
                ctx["trace"].note(tokens=len(gen))
            ready, finish, done = em.step(gen, done, finish)
            if ready:
                yield ready, False, finish

        ctx["ids"] = gen
        tail, finish = em.final(gen, finish)
        yield tail, True, finish

    # ------------------------------------------------------------------
    def _engine_span(self, trace, deadline):
        """Open the traced request's ``engine`` span (None passthrough)."""
        if trace is None:
            return None
        who = self._trace_attrs()
        trace.note(deadline=deadline, tokens=0, **who)
        return trace.span("engine").set(**who)

    def _check_usable(self) -> None:
        if self._poisoned is not None:
            raise EngineUnavailable(
                f"CUDA context poisoned: {type(self._poisoned).__name__}: "
                f"{self._poisoned}")

    def _generate(self, messages, sp, max_tokens, stops, seed,  # lfkt: blocks-under[_lock] -- the serial engine's lock IS the request serialization: the whole generation (device syncs, drill sleeps, incident capture) runs under it by design
                  deadline=None, abort=None, trace=None) -> dict:
        # disagg decode role: one bounded remote-prefill hop before the
        # lock (the loopback page service needs it); off, this is one
        # attribute read.  Explicit seeds bypass it like every reuse path
        pre_ids = None
        if self._disagg is not None and seed is None:
            pre_ids = self._remote_prefill(messages, deadline, trace)
        with self._lock, maybe_profile("generate"):
            self._check_usable()
            self.heartbeat.enter()
            try:
                t0 = time.time()
                ctx = self._start(messages, sp, seed,
                                  espan=self._engine_span(trace, deadline),
                                  pre_ids=pre_ids)
                ctx["trace"] = trace
                ctx["deadline"] = deadline
                ctx["abort"] = abort
                parts = []
                finish = "stop"
                for text, _done, fr in self._run(ctx, max_tokens, stops):
                    parts.append(text)
                    finish = fr
                timings = self._finish(ctx)
            except Exception as e:  # noqa: BLE001 — burst detection, re-raised
                self._drop_lease()
                self._note_error(e)
                raise
            finally:
                self.heartbeat.leave()
        completion_tokens = len(ctx["ids"])
        logger.info("generation: %.2fs, finish=%s", time.time() - t0, finish)
        return {
            "lfkt_timings": timings,
            "id": f"chatcmpl-{uuid.uuid4().hex}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": "".join(parts)},
                "finish_reason": finish,
            }],
            "usage": {
                "prompt_tokens": ctx["n_prompt"],
                "completion_tokens": completion_tokens,
                "total_tokens": ctx["n_prompt"] + completion_tokens,
            },
        }

    def _generate_stream(self, messages, sp, max_tokens, stops, seed,  # lfkt: blocks-under[_lock] -- the serial engine's lock IS the request serialization: the whole generation (device syncs, drill sleeps, incident capture) runs under it by design
                         deadline=None, abort=None, trace=None) -> Iterator[dict]:
        # the same pre-lock remote-prefill hop as _generate
        pre_ids = None
        if self._disagg is not None and seed is None:
            pre_ids = self._remote_prefill(messages, deadline, trace)
        with self._lock:
            self._check_usable()
            self.heartbeat.enter()
            try:
                ctx = self._start(messages, sp, seed,
                                  espan=self._engine_span(trace, deadline),
                                  pre_ids=pre_ids)
            except Exception as e:  # noqa: BLE001 — burst detection, re-raised
                self._drop_lease()
                self.heartbeat.leave()
                self._note_error(e)
                raise
            ctx["trace"] = trace
            ctx["deadline"] = deadline
            ctx["abort"] = abort
            cid = f"chatcmpl-{uuid.uuid4().hex}"
            created = int(time.time())

            def chunk(delta: dict, finish=None):
                return {
                    "id": cid,
                    "object": "chat.completion.chunk",
                    "created": created,
                    "model": self.model_name,
                    "choices": [{
                        "index": 0, "delta": delta, "finish_reason": finish,
                    }],
                }

            finished = False
            try:
                yield chunk({"role": "assistant"})
                finish = "stop"
                for text, _done, fr in self._run(ctx, max_tokens, stops):
                    finish = fr
                    if text:
                        yield chunk({"content": text})
                timings = self._finish(ctx)
                finished = True
                final = chunk({}, finish=finish)
                final["lfkt_timings"] = timings
                yield final
            except Exception as e:  # noqa: BLE001 — burst detection, re-raised
                self._drop_lease()
                self._note_error(e)
                raise
            finally:
                self.heartbeat.leave()
                if not finished:
                    # closed early (client gone): still record the claim
                    # and timings so the next request sees a consistent ring
                    self._finish(ctx)

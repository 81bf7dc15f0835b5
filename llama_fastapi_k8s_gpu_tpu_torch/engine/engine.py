"""The serial engine: the in-tree replacement for ``llama_cpp.Llama``.

The same contract as the JAX reference's serial ``Engine``
(llama_fastapi_k8s_gpu_tpu/engine/engine.py): eager load, blocking
thread-safe generation one request at a time, OpenAI-shaped responses and
streaming chunks — on PyTorch and one GPU:

- load: GGUF mmap → weights on the device (``q4k``: fused Q4_K/Q5_K/Q6_K/
  Q8_0 block bytes for an 8B model on the GPU; ``bf16`` for small models
  and the CPU; ``int8`` on request);
- KV cache: a head-major ring in bf16, or int8 with per-token scales
  (``kv_dtype="int8"``, ops/kvquant.py);
- prefill: the prompt padded to a bucket; a bucket larger than
  ``prefill_chunk`` runs as slices at growing cache offsets, stopping at
  the slice that holds the last real token;
- prefix reuse: when a prompt extends the previous request's tokens, only
  the suffix is prefilled (the reference's ``_prefix_reuse_len`` rule);
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
)
from ..models.llama import cache_nbytes, init_cache
from ..models.params import decode_loop_plan, load_params
from ..obs.devtime import record_dispatch
from ..obs.memledger import register_component
from ..ops.attention import flash_takes
from ..sampling.sample import SamplingParams, sampling_tensors
from ..tokenizer import apply_chat_template, detect_chat_template, tokenizer_from_gguf
from ..utils.device import resolve_device
from ..utils.faults import FAULTS
from ..utils.health import EngineUnavailable, Heartbeat
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


class Engine:
    """Loads a GGUF model and serves chat completions on one device.

    ``device`` defaults to the GPU and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch path (tests)."""

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
        prefix_cache: bool = True,  # reuse the previous request's KV prefix
        prefix_min: int = 32,       # shortest common prefix worth reusing
        prefill_chunk: int = 256,   # prompt slice size for large buckets
        device: str | torch.device | None = None,
        *,
        _parts: tuple | None = None,  # (params, cfg, tokenizer, template_kind)
    ):
        FAULTS.fire("load")   # injection point: a load that fails
        # validated before the file is read: a wrong LFKT_KV_DTYPE fails at
        # once, not after a multi-GB load
        if kv_dtype is not None and kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
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
        if _parts is not None:
            self.params, self.cfg, self.tokenizer, self.template_kind = _parts
            self.device = self.params.tok_emb.device
            self.model_name = "in-memory"
        else:
            self.device = resolve_device(device)
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
        attn_impl = resolve_attn_impl(attn_impl, self.cfg, self.device)
        if attn_impl != self.cfg.attn_impl:
            self.cfg = dataclasses.replace(self.cfg, attn_impl=attn_impl)
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
        self.prefill_buckets = sorted(b for b in prefill_buckets if b <= self.cfg.n_ctx)
        if not self.prefill_buckets or self.prefill_buckets[-1] < self.cfg.n_ctx:
            self.prefill_buckets.append(self.cfg.n_ctx)
        self._cache = init_cache(self.cfg, self.device)
        # the decode step as CUDA graphs over this ring (the card only)
        self._graphs = (DecodeGraphs(self.params, self.cfg, self._cache)
                        if self.device.type == "cuda" else None)
        # prompt-prefix KV reuse: the token ids whose KV occupy ring slots
        # [0, len) — read and written only under self._lock
        self._prefix_cache = bool(prefix_cache)
        self._prefix_min = max(1, int(prefix_min))
        self._prefix_ids: list[int] = []
        # weakly held (a closed engine's rows vanish with it); the providers
        # read sizes only, at snapshot time
        register_component("weights", self, lambda eng: eng.weight_bytes)
        register_component("kv_ring", self, lambda eng: eng.kv_cache_bytes)

    @property
    def kv_cache_bytes(self) -> int:
        """Device bytes of the KV ring (bf16 or int8, as ``cfg.kv_dtype``)."""
        return cache_nbytes(self.cfg)

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

    def warmup(self):
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

    def _prefill_padded(self, ids: list, n_prompt: int, bucket: int, pspan=None):
        """Bucket prefill, whole or sliced; returns the last real token's
        logits.  Slicing stops at the slice holding the last real token:
        later slices would only write padding that is never attended.  Each
        slice's host time goes to ``prefill_slice_seconds`` and, traced, to
        a ``prefill_slice`` event on ``pspan``."""
        padded = torch.zeros(bucket, dtype=torch.int64)
        padded[:n_prompt] = torch.tensor(ids, dtype=torch.int64)
        padded = padded.to(self.device)
        if bucket <= self._prefill_chunk:
            record_dispatch("prefill")
            return prefill(self.params, self.cfg, padded, n_prompt, self._cache)
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
            return True
        finally:
            self._lock.release()

    def _recover_locked(self) -> None:
        """Zero the ring in place and drop its prefix claim, with the lock
        held.  The ring is never reallocated: the captured decode graphs
        read and write these very tensors, and a new ring would be one the
        replays never see."""
        for t in self._cache.values():
            t.zero_()
        self._prefix_ids = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
    def _start(self, messages, sp: SamplingParams, seed, espan=None):
        """Prefill + first token.  Returns the mutable generation context.
        ``espan`` (the traced request's ``engine`` span, or None) grows a
        ``prefill`` child covering tokenize → first sampled token."""
        t0 = time.time()
        self.heartbeat.beat()
        FAULTS.fire("prefill")
        ids = self.tokenize_messages(messages)
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

    def _finish(self, ctx) -> dict:
        """Record the ring's new prefix claim and the request's timings (on
        the traced request's ``engine`` span too, which it closes)."""
        decode_s = time.time() - ctx["t0"] - ctx["ttft_s"]
        n = len(ctx["ids"])
        if self._prefix_cache:
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
        self._record_timings(timings)
        espan = ctx.get("span")
        if espan is not None:
            espan.set(**{k: round(v, 6) if isinstance(v, float) else v
                         for k, v in timings.items()})
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
        record_dispatch("decode_chunk")
        toks = generate_chunk(self.params, self.cfg, ctx["state"], ctx["st"],
                              n_steps, top_k=ctx["sp"].top_k)
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

    def _run(self, ctx, max_tokens, stops):
        """Generate; yields (new_text, done, finish_reason) increments.

        Pipelined: chunk k+1 is queued on the device before chunk k's
        tokens are read, and the read waits for chunk k alone, so a cancel,
        stop or deadline found after it ends the generation while chunk k+1
        still runs.  If a stop lands mid-chunk, the extra chunk's cache
        writes are harmless: attention masks by position and the next
        request prefills over them."""
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
        who = {"engine": type(self).__name__, "model": self.model_name}
        trace.note(deadline=deadline, tokens=0, **who)
        return trace.span("engine").set(**who)

    def _check_usable(self) -> None:
        if self._poisoned is not None:
            raise EngineUnavailable(
                f"CUDA context poisoned: {type(self._poisoned).__name__}: "
                f"{self._poisoned}")

    def _generate(self, messages, sp, max_tokens, stops, seed,
                  deadline=None, abort=None, trace=None) -> dict:
        with self._lock, maybe_profile("generate"):
            self._check_usable()
            self.heartbeat.enter()
            try:
                t0 = time.time()
                ctx = self._start(messages, sp, seed,
                                  espan=self._engine_span(trace, deadline))
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

    def _generate_stream(self, messages, sp, max_tokens, stops, seed,
                         deadline=None, abort=None, trace=None) -> Iterator[dict]:
        with self._lock:
            self._check_usable()
            self.heartbeat.enter()
            try:
                ctx = self._start(messages, sp, seed,
                                  espan=self._engine_span(trace, deadline))
            except Exception as e:  # noqa: BLE001 — burst detection, re-raised
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
                self._note_error(e)
                raise
            finally:
                self.heartbeat.leave()
                if not finished:
                    # closed early (client gone): still record the claim
                    # and timings so the next request sees a consistent ring
                    self._finish(ctx)

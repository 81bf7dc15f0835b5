"""Continuous batching: slot-based scheduling over the lanes of one card.

The port of the reference's ``ContinuousEngine`` (llama_fastapi_k8s_gpu_tpu/
engine/continuous.py) with its paged and speculative branches, without
its disaggregated one.  :class:`~.batched.MeshEngine` coalesces requests into cycles;
here the B lanes are **slots**: at every decode-chunk boundary finished
lanes are freed and waiting requests admitted into them — a prompt
prefilled slice by slice into a scratch ring between chunks, its first
token sampled, and the ring copied into the lane (:func:`_write_lane`).
Decode keeps running for whatever lanes are live, so short requests leave
early and long ones never block admission.

Everything the device runs for this engine runs on its scheduler thread
(``lfkt-scheduler``), which owns the lane state, the knobs, the scratch
ring and the lane claims; other threads only queue work, flag it
abandoned, or — after the thread is proven dead — rebuild it
(:meth:`ContinuousEngine.recover`).  On the card a chunk is replays of
the lane step's CUDA graph (parallel/batched.py ``LaneGraphs``), captured
at :meth:`ContinuousEngine.warmup` through the scheduler; every admission
write is an in-place copy into the captured buffers.  The loop is
pipelined one chunk deep: chunk k+1 is queued before chunk k's tokens are
read, and the read waits for chunk k alone (a pinned copy behind it and an
event), so the host's admissions and harvest overlap the device.

Under ``kv_paged`` the lane claims give way to the pool's radix index
(parallel/kvpool.py): an admission restores its longest cached prefix,
aligned to lcm(prefill_chunk, page_tokens), into the scratch ring in
place and prefills only the suffix slices; a finished lane commits its
conversation's whole pages straight from the lane.  Under
``spec_decode="lookup"`` a wave whose live lanes have n-gram drafts runs
verify rounds (parallel/batched.py ``lane_verify``, on the card one
replay of the lane verify graph) instead of the pipelined chunk, after
flushing it: a verify's drafts need the lanes' current histories.  Both
serve over a tp mesh: the scratch ring and the lane ring are then
``ShardedRing`` s, a restore writes every shard in place, a freed lane
commits from its dp group's shards, and a verify round runs each lane's
D+1 rows over its shards (``models.llama.forward_mesh``).

The reference's concurrency model (one generation at a time behind a
queue of 5 and a semaphore of 1) is the B = 1 case; back-pressure (503)
and per-request timeouts stay at the server.
"""

from __future__ import annotations

import codecs
import logging
import math
import queue as queue_mod
import threading
import time
import uuid
from concurrent.futures import CancelledError, Future
from typing import Sequence

import numpy as np
import torch

from ..models.generate import prefill_chunk
from ..models.llama import cache_nbytes
from ..obs import memledger as _memledger
from ..obs.devtime import ENTRY, record_dispatch, register_program
from ..obs.memledger import register_component
from ..obs.trace import annotate_all_inflight
from ..parallel.mesh import ring_zero_
from ..parallel.batched import generate_chunk_lanes, lane_cache_copy, lane_verify, write_lane
from ..sampling.sample import SamplingParams, sample_chain, sampling_tensors, seed_window
from ..utils.faults import FAULTS
from ..utils.health import DeadlineExceeded, EngineUnavailable
from .batched import MeshEngine
from .engine import Engine

logger = logging.getLogger(__name__)

for _name in ("lane_write", "lane_cache_copy"):
    register_program(_name, ENTRY, site="engine.continuous")
del _name


def _ledger_scratch_bytes(eng: "ContinuousEngine") -> int:
    """Memory-ledger provider: the admission scratch ring's device bytes."""
    return cache_nbytes(eng.cfg) if getattr(eng, "_scratch_cache", None) is not None else 0


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without a host sync: through pinned
    memory and a non-blocking copy on the card (a pageable copy would wait
    for the queued chunk)."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _HostValue:
    """A device scalar on its way to the host: a pinned non-blocking copy
    and an event behind it, so reading it waits for that copy alone, not
    for the chunk queued after it."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty((), dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t.clone(), None

    def __int__(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._host)


def _write_lane(state: dict, lane: int, cache1: dict, n_prompt: int, token: torch.Tensor,
                wpos: int) -> None:
    """Install a prefilled sequence into lane ``lane`` (parallel/batched.py
    ``write_lane``; its penalty ring and knobs are already in the lane's
    row).  ``cache1`` is not consumed: it stays the next admission's
    prefill scratch."""
    record_dispatch("lane_write")
    write_lane(state, lane, cache1, n_prompt, token, wpos)


_STREAM_END = object()   # scheduler → stream-consumer sentinel


class AdmissionController:
    """The scheduler's per-wave admission prefill-token budget, derived from
    *measured* decode slack instead of the static ``LFKT_ADM_BUDGET`` (the
    reference's controller, unchanged).

    Two signals, both free on the scheduler thread: the **lane-idle
    fraction** (free lanes are lost throughput: grow the budget) and the
    **decode pressure**, the share of the wave the scheduler spent blocked
    reading the previous chunk (a long wait means the device was still
    busy, so slices queued between chunks delay live lanes: shrink).
    Both are EMA-smoothed (``alpha``; seeded from the first observation)
    and drive an AIMD update where the cut wins: pressure (or memory
    pressure) halves the budget, idle lanes or slack grow it by one slice.
    The floor is one slice a wave, so an admission always progresses.
    Single-threaded: owned by the scheduler loop."""

    #: ema_pressure below this means the device had idle headroom → grow
    SLACK_PRESSURE = 0.25
    #: ema_pressure above this means decode waits on the host's wave → cut
    HIGH_PRESSURE = 0.5

    def __init__(self, chunk: int, lanes: int, base: int,
                 alpha: float = 0.25, max_factor: int = 8):
        self.chunk = max(1, int(chunk))
        self.lanes = max(1, int(lanes))
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self.min_budget = self.chunk              # ≥ one slice: no starvation
        self.max_budget = max(int(base), self.chunk) * max(1, int(max_factor))
        self.budget = min(max(int(base), self.min_budget), self.max_budget)
        self.ema_idle = 0.0       # seeded from the first observation
        self.ema_pressure = 0.0
        self.waves = 0

    def observe_wave(self, lanes_live: int, fetch_wait_s: float,
                     wave_s: float, mem_pressure: bool = False) -> int:
        """Fold one wave's measurements in; returns the next wave's budget.
        ``mem_pressure`` (the memory ledger's headroom verdict) forces the
        cut."""
        a = self.alpha
        idle = 1.0 - min(lanes_live, self.lanes) / self.lanes
        pressure = min(1.0, fetch_wait_s / wave_s) if wave_s > 0 else 0.0
        if self.waves == 0:
            # seed, don't smooth: a controller born into saturation must cut
            # from wave one
            self.ema_idle, self.ema_pressure = idle, pressure
        else:
            self.ema_idle += a * (idle - self.ema_idle)
            self.ema_pressure += a * (pressure - self.ema_pressure)
        self.waves += 1
        if mem_pressure or self.ema_pressure > self.HIGH_PRESSURE:
            self.budget = max(self.budget // 2, self.min_budget)
        elif self.ema_idle > 0.01 or self.ema_pressure < self.SLACK_PRESSURE:
            self.budget = min(self.budget + self.chunk, self.max_budget)
        return self.budget

    def stats(self) -> dict:
        """Point-in-time introspection for scheduler_stats()/metrics."""
        return {
            "adm_budget_tokens": self.budget,
            "adm_ema_idle": round(self.ema_idle, 4),
            "adm_ema_pressure": round(self.ema_pressure, 4),
        }


class _Item:
    """One queued request: a future (non-stream) or a chunk sink (stream)."""
    __slots__ = ("future", "messages", "sp", "max_tokens", "stops", "seed",
                 "sink", "abandoned", "deadline", "abort", "rid", "trace",
                 "t_enq")

    def __init__(self, future, messages, sp, max_tokens, stops, seed,
                 sink=None, deadline=None, abort=None, trace=None):
        self.future = future
        self.messages = messages
        self.sp = sp
        self.max_tokens = max_tokens
        self.stops = stops
        self.seed = seed
        self.sink = sink                    # queue.Queue for stream chunks
        self.abandoned = threading.Event()  # caller gave up: free the lane
        self.deadline = deadline            # absolute time.time() budget
        self.abort = abort                  # callable: caller gave up?
        self.rid = 0                        # registry key (abandon/fail_inflight)
        self.trace = trace                  # obs.trace.Trace | None (sampled out)
        self.t_enq = time.time()            # pending-span start


class _Slot:
    __slots__ = ("future", "gens", "budget", "n_prompt", "ids",
                 "first_token", "stops", "sp", "t_admit", "ttft_s",
                 "sink", "abandoned", "dec", "n_emitted", "sent_bytes",
                 "held", "cid", "created", "finished", "pending_first",
                 "reused", "deadline", "abort", "trace", "pspan", "dspan",
                 "t_chunk")

    def __init__(self, item: _Item, budget, n_prompt, ids):
        self.future = item.future
        self.sink = item.sink
        self.abandoned = item.abandoned
        self.deadline = item.deadline
        self.abort = item.abort
        self.trace = item.trace
        self.pspan = None         # the admission's "prefill" span
        self.dspan = None         # this slot's lane-occupancy "decode" span
        self.t_chunk = 0.0        # previous harvest time (chunk-span starts)
        self.finished = False     # resolved; an in-flight chunk's lane
        #                           snapshot may still hold it: harvest skips
        self.pending_first = False  # first token still on the device
        self.gens: list[int] = []
        self.budget = budget
        self.n_prompt = n_prompt
        self.ids = ids
        self.reused = 0           # prompt tokens served from a lane claim
        # stream emission: an incremental UTF-8 decoder over the token bytes
        self.dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
        self.n_emitted = 0
        self.sent_bytes = 0
        self.held = ""            # withheld text (a possible stop-string prefix)
        self.cid = f"chatcmpl-{uuid.uuid4().hex}"
        self.created = int(time.time())


class ContinuousEngine(MeshEngine):
    """MeshEngine + a scheduler thread with per-lane admission.

    :meth:`submit` returns a ``concurrent.futures.Future`` of the
    OpenAI-shaped dict; :meth:`submit_stream` an iterator of chunks; the
    blocking ``create_chat_completion(s)`` facades route through them."""

    _LANE_PROGRAM = "lane_decode_chunk"
    #: serves spec_decode="lookup" through lane verify rounds
    _SPEC_LANES = True

    # -- thread discipline (machine-checked: lfkt-lint LOCK001-004) ------------
    # The scheduler thread OWNS the device state: unlike MeshEngine (whose
    # callers mutate _bstate under _lock), every serving-path write to the
    # state below happens on the lfkt-scheduler thread, so the parent's
    # lock mapping is replaced by thread confinement.  The only
    # cross-thread writes are in recover(), which runs strictly after the
    # thread is proven dead (join + alive/_loop_error guards).
    _GUARDED_BY = {
        "_bstate": None,            # scheduler-confined here (see above)
        "_cache": None,             # serial ring unused on the submit path
        "_prefix_ids": None,
        "_req_counter": "_id_lock",
    }
    _THREAD_ENTRIES = ("_loop",)
    _THREAD_CONFINED = (
        "_bstate", "_lane_st", "_scratch_cache", "_adm", "_lane_claims",
        "_prefix_stats", "_spec_stats", "_stats", "_loop_error",
        "_adm_budget", "_lane_idle_s", "_mem_hot_prev",
    )
    # cross-thread by design; individual operations are GIL-atomic
    # (dict/Queue/Event ops) or single reference stores
    _SHARED_ATOMIC = ("_items", "_pending", "_wake", "_stop", "_shutdown",
                      "_thread")

    def __init__(self, model_path: str | None, *, prefill_chunk: int = 256, adm_budget: int = 512,
                 adm_controller: bool = True, adm_ema_alpha: float = 0.25,
                 lane_prefix_cache: bool = True, **kw):
        super().__init__(model_path, prefill_chunk=prefill_chunk, **kw)
        #: prefill tokens a scheduler wave: static with the controller off,
        #: rewritten every wave by it when on
        self._adm_budget = max(self._prefill_chunk, adm_budget)
        self._adm_base = self._adm_budget
        self._adm_alpha = adm_ema_alpha
        self._adm_ctl = AdmissionController(
            self._prefill_chunk, self.batch_size, self._adm_budget,
            alpha=adm_ema_alpha) if adm_controller else None
        #: cumulative idle lane-seconds (free lanes × wave wall)
        self._lane_idle_s = 0.0
        self._adm: dict | None = None   # the in-flight chunked admission
        # lane-prefix reuse: a freed lane's ring still holds its finished
        # conversation; an admission whose prompt shares it snapshots the
        # lane into the scratch ring and prefills only the suffix slices.
        # Chunk-aligned, skipped for explicit-seed requests, claims capped
        # at n_ctx-1 (a freed lane keeps decoding past its claim, its slot
        # clamped to n_ctx-1 once it overruns)
        self._lane_prefix = bool(lane_prefix_cache) and not self._spec_draft
        # the paged pool folds the lane claims behind its radix index; an
        # admission's reuse is aligned to the prefill slice and the page
        if self._kv_paged:
            self._lane_prefix = False
            self._paged_align = math.lcm(self._prefill_chunk, self._kvpool.page_tokens)
        self._lane_claims: list[list | None] = [None] * self.batch_size
        #: realized admission reuse, named for the implementation that
        #: served it: lane claims or the paged pool's radix index
        self._reuse_stat = "radix_prefix" if self._kv_paged else "lane_prefix"
        self._prefix_stats = {f"{self._reuse_stat}_hits": 0,
                              f"{self._reuse_stat}_reused_tokens": 0}
        #: lane speculation: verify rounds, drafted and accepted tokens,
        #: and the plain chunks beside them
        self._spec_stats = {"verify_steps": 0, "drafted": 0, "accepted": 0, "chunk_steps": 0}
        self._scratch_cache = self._new_ring()
        register_component("kv_scratch", self, _ledger_scratch_bytes)
        #: the previous wave's memory-pressure verdict (rising-edge events)
        self._mem_hot_prev = False
        self._req_counter = 0                # monotonic request id (abandon key)
        self._stats = {"lanes_live": 0, "pending": 0, "admission_inflight": 0}
        self._items: dict[int, _Item] = {}   # live request id → item
        self._pending: queue_mod.Queue = queue_mod.Queue()
        self._wake = threading.Event()
        self._stop = False
        self._shutdown = False   # deliberate stop: recovery refuses
        self._loop_error: BaseException | None = None
        self._thread = threading.Thread(target=self._loop, name="lfkt-scheduler",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, messages: Sequence[dict], *, temperature: float = 0.2,
               top_p: float = 0.95, top_k: int = 40, min_p: float = 0.05,
               frequency_penalty: float = 0.0, presence_penalty: float = 0.0,
               repeat_penalty: float = 1.1, max_tokens: int | None = None,
               stop: Sequence[str] | str | None = None,
               seed: int | None = None,
               deadline: float | None = None, abort=None,
               trace=None) -> Future:
        """Queue one request; the scheduler admits it into a free lane.

        ``top_k`` is served per request up to the engine's ``max_top_k``
        ceiling.  ``deadline`` (absolute ``time.time()``) frees the lane
        within one decode chunk of expiry, resolving the future with
        :class:`DeadlineExceeded`.  ``trace`` collects the request's spans
        (pending wait, chunked prefill, lane occupancy, decode chunks)."""
        item = self._enqueue(
            messages, temperature=temperature, top_p=top_p, top_k=top_k,
            min_p=min_p, frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty, repeat_penalty=repeat_penalty,
            max_tokens=max_tokens, stop=stop, seed=seed, deadline=deadline,
            abort=abort, trace=trace)
        fut = item.future
        fut._lfkt_req_id = item.rid
        fut.add_done_callback(lambda f, rid=item.rid: self._items.pop(rid, None))
        return fut

    def _enqueue(self, messages, *, temperature, top_p, top_k, min_p,
                 frequency_penalty, presence_penalty, repeat_penalty,
                 max_tokens, stop, seed, sink=None, deadline=None,
                 abort=None, trace=None) -> _Item:
        """The submit/submit_stream path: guards, item, registry, queue."""
        if self._loop_error is not None:
            raise EngineUnavailable("scheduler died") from self._loop_error
        if self._stop:
            raise EngineUnavailable("engine has been shut down")
        self._check_usable()
        sp = SamplingParams(
            temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p,
            frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty, repeat_penalty=repeat_penalty,
        )
        if isinstance(stop, str):
            stop = [stop]
        item = _Item(None if sink is not None else Future(), list(messages),
                     sp, max_tokens, list(stop or []), seed, sink=sink,
                     deadline=deadline, abort=abort, trace=trace)
        if trace is not None:
            trace.note(deadline=deadline, tokens=0, **self._trace_attrs())
        with self._id_lock:
            self._req_counter += 1
            item.rid = self._req_counter
        # the live-request registry: abandon() routes through it, and a
        # watchdog trip fails everything in it (fail_inflight)
        self._items[item.rid] = item
        self._pending.put(item)
        self._wake.set()
        return item

    def abandon(self, fut: Future) -> None:
        """The caller no longer wants ``fut``'s result: its lane frees at the
        next chunk boundary instead of decoding to budget."""
        rid = getattr(fut, "_lfkt_req_id", None)
        item = self._items.get(rid) if rid is not None else None
        if item is not None:
            item.abandoned.set()

    def submit_stream(self, messages: Sequence[dict], *,
                      temperature: float = 0.2, top_p: float = 0.95,
                      top_k: int = 40, min_p: float = 0.05,
                      frequency_penalty: float = 0.0,
                      presence_penalty: float = 0.0,
                      repeat_penalty: float = 1.1,
                      max_tokens: int | None = None,
                      stop: Sequence[str] | str | None = None,
                      seed: int | None = None,
                      deadline: float | None = None, abort=None,
                      trace=None):
        """Queue one streaming request; returns an iterator of OpenAI chunk
        dicts produced as its lane decodes.  Closing the iterator abandons
        the request (its lane frees at the next chunk boundary)."""
        sink: queue_mod.Queue = queue_mod.Queue()
        item = self._enqueue(
            messages, temperature=temperature, top_p=top_p, top_k=top_k,
            min_p=min_p, frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty, repeat_penalty=repeat_penalty,
            max_tokens=max_tokens, stop=stop, seed=seed, sink=sink,
            deadline=deadline, abort=abort, trace=trace)

        def gen():
            try:
                while True:
                    chunk = sink.get()
                    if chunk is _STREAM_END:
                        return
                    if isinstance(chunk, BaseException):
                        raise chunk
                    yield chunk
            finally:
                item.abandoned.set()   # no-op if the stream finished
                self._items.pop(item.rid, None)
        return gen()

    def create_chat_completion(self, messages, stream: bool = False, **kw):
        if stream:
            return self.submit_stream(messages, **kw)
        return self.submit(messages, **kw).result()

    def failure(self) -> BaseException | None:
        """Watchdog hook: the exception that killed the scheduler loop (or
        the poisoned CUDA context), or None."""
        return self._loop_error or self._poisoned

    def fail_inflight(self, exc: BaseException) -> None:
        """Resolve every registered live request with ``exc`` (a watchdog
        trip); items are marked abandoned so a still-running loop drops
        their lanes instead of resolving twice."""
        for item in list(self._items.values()):
            item.abandoned.set()
            if item.future is not None:
                if not item.future.done():
                    try:
                        item.future.set_exception(exc)
                    except Exception:  # noqa: BLE001 — lost race with the loop
                        pass
            elif item.sink is not None:
                item.sink.put(exc)

    def recover(self) -> bool:  # lfkt: noqa[LOCK002] -- writes scheduler-confined state only after the owning thread is proven dead (join + alive/_loop_error refusal guards above each write)
        """Restart a *dead* scheduler on zeroed lane state (watchdog
        recovery).  Refuses while the loop thread is alive and unfailed (a
        wedged thread may still be using the card), after a deliberate
        :meth:`shutdown`, and on a poisoned CUDA context."""
        FAULTS.fire("recover")
        if self._shutdown:
            return False
        if self._thread.is_alive() and self._loop_error is None:
            return False
        self._thread.join(timeout=2)
        if self._thread.is_alive():
            return False
        if self._poisoned is None and self.device.type == "cuda":
            try:
                torch.cuda.synchronize(self.device)
            except Exception as e:  # noqa: BLE001 — a sticky error
                logger.error("CUDA context poisoned: %s", e)
                self._poisoned = e
        if self._poisoned is not None:
            return False
        # the fallible device work first: if it raises, _loop_error stays
        # set, the watchdog keeps seeing a dead engine and submit refuses
        with self._lock:
            self._recover_locked()  # lfkt: blocks-under[_lock] -- recovery zeroes the rings in place and drains the card under the engine lock by design: the scheduler is proven dead, and no request may race a half-recovered ring
        with torch.inference_mode():
            if self._scratch_cache is None:
                self._scratch_cache = self._new_ring()
            ring_zero_(self._scratch_cache)
        self._loop_error = None
        self._stop = False
        self._adm = None
        self._items.clear()
        self._lane_claims = [None] * self.batch_size
        self._lane_idle_s = 0.0
        if self._adm_ctl is not None:
            # a fresh controller: no pre-crash EMAs
            self._adm_ctl = AdmissionController(
                self._prefill_chunk, self.batch_size, self._adm_base,
                alpha=self._adm_alpha)
            self._adm_budget = self._adm_ctl.budget
        else:
            self._adm_budget = self._adm_base
        self._stats = {"lanes_live": 0, "pending": 0, "admission_inflight": 0}
        self.heartbeat.reset()
        self._thread = threading.Thread(target=self._loop, name="lfkt-scheduler",
                                        daemon=True)
        self._thread.start()
        return True

    def create_chat_completions(self, batch_messages, **kw) -> list[dict]:
        futs = [self.submit(m, **kw) for m in batch_messages]
        out = []
        for f in futs:
            try:
                out.append(f.result())
            except ValueError as e:  # a request's own input error
                out.append({"error": {"message": str(e),
                                      "type": "invalid_request_error"}})
        return out

    def shutdown(self):
        self._shutdown = True
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)

    def close(self) -> None:
        """Stop the scheduler, then release the graphs."""
        self.shutdown()
        super().close()

    def warmup(self):
        """Through the scheduler: a full wave of short greedy requests (on
        the card its first chunk captures the lane step for the ``top_k``
        ceiling, and under speculation the lane verify round, on the
        scheduler thread), then a stream."""
        t0 = time.time()
        msgs = [{"role": "user", "content": "hi"}]
        futs = [self.submit(msgs, max_tokens=self.decode_chunk + 1, temperature=0.0)
                for _ in range(self.batch_size)]
        for f in futs:
            f.result()
        list(self.submit_stream(msgs, max_tokens=self.decode_chunk + 1, temperature=0.0))
        logger.info("continuous warmup done in %.1fs (%d lanes)",
                    time.time() - t0, self.batch_size)

    # ------------------------------------------------------------------
    # scheduler internals (every device call on the scheduler thread)
    # ------------------------------------------------------------------

    # -- admission: a chunked-prefill state machine.  At most one admission
    # is in flight; its prompt prefills in ``prefill_chunk``-token slices
    # into the scratch ring, interleaved with decode chunks.

    def _free_lane(self, lane: int, slot: _Slot, slots: list,
                   claim: bool = True) -> None:
        """Release ``slot``'s lane and record which token ids' KV stay valid
        there for lane-prefix reuse: ring slots [0, n_prompt + len(gens) -
        1), capped at n_ctx-1.  Every path that finishes a slot comes
        through here.  ``claim=False`` for error finishes."""
        if slots[lane] is slot:
            slots[lane] = None
        keep = min(slot.n_prompt + max(len(slot.gens) - 1, 0), self.cfg.n_ctx - 1)
        if self._kv_paged:
            if claim:
                # the finished conversation's whole pages, straight from the
                # lane (stream-ordered after every queued chunk, which
                # writes only past the claim); cached pages deduplicate
                self._kvpool.commit_lane((list(slot.ids) + slot.gens)[:keep],
                                         self._bstate["cache"], lane,
                                         namespace=self._kv_ns)
            return
        if not self._lane_prefix:
            return
        if not claim:
            self._lane_claims[lane] = None
            return
        self._lane_claims[lane] = (list(slot.ids) + slot.gens)[:keep]

    def _find_lane_reuse(self, ids: list, n_prompt: int):
        """(reuse_len, source_lane): the longest chunk-aligned usable claim
        prefix across freed lanes, or (0, None)."""
        best, src = 0, None
        cap = n_prompt - 1   # ≥ 1 real token must prefill (last-token logits)
        for lane, claim in enumerate(self._lane_claims):
            if claim is None:
                continue
            lim = min(len(claim), cap)
            i = 0
            while i < lim and claim[i] == ids[i]:
                i += 1
            i = (i // self._prefill_chunk) * self._prefill_chunk
            if i > best:
                best, src = i, lane
        if best < self._prefill_chunk:
            return 0, None
        return best, src

    def _resolve_skipped(self, item: _Item, exc: BaseException | None = None) -> None:
        """Resolve an item the scheduler will never serve (abandoned,
        cancelled, or expired while queued)."""
        if item.future is not None and not item.future.done():
            if exc is not None:
                try:
                    item.future.set_exception(exc)
                except Exception:  # noqa: BLE001 — lost race: already resolved
                    pass
            elif not item.future.cancel():
                item.future.set_exception(CancelledError())
        elif item.sink is not None:
            item.sink.put(exc if exc is not None else _STREAM_END)

    def _begin_admission(self, item: _Item) -> dict | None:
        """Guards, tokenize, reuse lookup and the admission's setup."""
        if item.abandoned.is_set():
            self._resolve_skipped(item)
            return None
        if item.abort is not None and item.abort():
            self._resolve_skipped(item)
            return None
        if item.deadline is not None and time.time() > item.deadline:
            self._resolve_skipped(item, DeadlineExceeded(
                "request deadline expired before admission"))
            return None
        if item.future is not None and not item.future.set_running_or_notify_cancel():
            return None                                # cancelled while queued
        t0 = time.time()
        pspan = None
        if item.trace is not None:
            item.trace.span("pending", t0=item.t_enq).end(t0)
            pspan = item.trace.span("prefill", t0=t0)
        lease = None
        try:
            ids = self.tokenize_messages(item.messages)
            if len(ids) >= self.cfg.n_ctx:
                raise ValueError(
                    f"Requested tokens ({len(ids)}) exceed context window "
                    f"of {self.cfg.n_ctx}")
            bucket = self._bucket_for(len(ids))
            # disagg decode role (serving/disagg/): one bounded remote-
            # prefill hop an admission — the peer's pages import into the
            # pool, so the paged reuse below restores them and only the
            # suffix slices prefill here.  Off, this is one attribute read;
            # the client bounds the hop by the item's deadline and degrades
            # every failure to local prefill
            if self._disagg is not None and item.seed is None:
                self._remote_prefill_ids(ids, item.deadline, pspan)
            reuse, src = 0, None
            if item.seed is None:
                # explicit seeds take the full prefill (the serial engine's
                # reproducibility contract)
                if self._kv_paged:
                    reuse, lease = self._paged_admission_reuse(ids, pspan)
                elif self._lane_prefix:
                    reuse, src = self._find_lane_reuse(ids, len(ids))
            if lease is not None:
                # the matched pages into the scratch ring, in place; the
                # suffix slices then prefill from offset `reuse`
                if self._scratch_cache is None:
                    self._scratch_cache = self._new_ring()
                try:
                    self._kvpool.restore(lease, self._scratch_cache, span=pspan)
                except BaseException:
                    # a ring of unknown contents: zeroed in place (a cold
                    # ring); the lease is released below
                    ring_zero_(self._scratch_cache)
                    raise
            elif reuse:
                # snapshot the source lane's ring into the scratch, in place;
                # stream order puts the copy after every queued chunk, and
                # the claim region is never written by a freed lane
                if self._scratch_cache is None:
                    self._scratch_cache = self._new_ring()
                record_dispatch("lane_cache_copy")
                lane_cache_copy(self._bstate["cache"], src, self._scratch_cache)
            if pspan is not None:
                pspan.set(n_prompt=len(ids), bucket=bucket, reused=reuse)
            padded = np.zeros((bucket,), np.int64)
            padded[:len(ids)] = ids
            return {
                "item": item, "ids": ids, "n_prompt": len(ids),
                "bucket": bucket, "padded": padded,
                "seed": item.seed if item.seed is not None else self._next_seed(),
                "t0": t0, "offset": reuse, "reused": reuse, "logits": None,
                "span": pspan, "lease": lease,
            }
        except Exception as e:  # noqa: BLE001 — per-request isolation
            self._note_error(e)
            if lease is not None:
                self._kvpool.release(lease)
            if item.future is not None:
                item.future.set_exception(e)
            elif item.sink is not None:
                item.sink.put(e)
            return None

    def _paged_admission_reuse(self, ids: list, pspan=None):
        """(reuse_tokens, lease | None): the longest cached whole-page prefix
        aligned to ``_paged_align``, pinned.  No bucket constraint
        (admissions prefill in slices from the reuse offset): the cap and
        alignment of :meth:`_find_lane_reuse`, against the radix index."""
        pool = self._kvpool
        i = min(pool.match_len(ids, namespace=self._kv_ns), len(ids) - 1)
        r = (i // self._paged_align) * self._paged_align
        if r < self._paged_align:
            pool.note_miss()
            return 0, None
        lease = pool.acquire(ids, r, span=pspan, namespace=self._kv_ns)
        if lease is None:      # raced an eviction, or a spill restore failed
            return 0, None
        if pspan is not None:
            # between the acquire and the handoff a raising span setter is
            # the one thing that could leak the pinned pages
            try:
                pspan.set(reused_pages=len(lease.page_ids), matched_tokens=i)
            except Exception:  # noqa: BLE001 — telemetry must never pin pages
                pass
        return r, lease

    def _release_adm_lease(self, adm) -> None:
        """Unpin an admission's pool pages (idempotent: the lease is taken
        out of the admission) — every admission exit calls it: finish,
        abandon, a dispatch failure, the loop's end."""
        lease = adm.pop("lease", None) if adm else None
        if lease is not None:
            self._kvpool.release(lease)

    def _observe_slice(self, dt: float) -> None:
        if self.metrics_sink is not None:
            self.metrics_sink.observe("prefill_slice_seconds", dt)

    def _dispatch_prefill_chunk(self, adm: dict) -> None:
        """One prompt slice into the scratch ring; keeps the logits of the
        slice that holds the last real token.  The host wall (slice prep +
        queueing) goes to ``prefill_slice_seconds`` and the span."""
        t_s = time.time()
        self.heartbeat.beat()
        FAULTS.fire("prefill")
        if self._scratch_cache is None:
            self._scratch_cache = self._new_ring()
        off = adm["offset"]
        C = min(self._prefill_chunk, adm["bucket"] - off)
        sl = _to_device(torch.from_numpy(adm["padded"][off:off + C]), self.device)
        li = min(max(adm["n_prompt"] - 1 - off, 0), C - 1)
        record_dispatch("prefill_chunk")
        logits = prefill_chunk(self.params, self.cfg, sl, off, li, self._scratch_cache)
        if off <= adm["n_prompt"] - 1 < off + C:
            adm["logits"] = logits
        adm["offset"] = off + C
        dt = time.time() - t_s
        self._observe_slice(dt)
        if adm.get("span") is not None:
            adm["span"].event("prefill_slice", offset=off, tokens=C, host_s=round(dt, 6))

    @torch.inference_mode()
    def _first_token(self, adm: dict, lane: int, sp: SamplingParams) -> tuple:
        """The admission's knobs and penalty ring into ``lane``'s row, its
        generator seeded from the request's seed, and the first token
        sampled from the prompt's logits (the one-sequence chain at the
        lane step's ``top_k`` ceiling, on the lane's own generator).
        Returns the token (0-d, on the device) and the ring's next slot."""
        st = self._bstate
        for k, v in sampling_tensors(sp, "cpu").items():
            self._lane_st[k][lane].fill_(v.item())
        window, wpos = seed_window(adm["ids"], "cpu")
        st["window"][lane].copy_(_to_device(window, self.device))
        gen = st["gens"][lane]
        gen.manual_seed(adm["seed"])
        knobs = {k: t[lane] for k, t in self._lane_st.items()}
        record_dispatch("first_sample")
        token = sample_chain(adm["logits"], st["window"][lane], gen, knobs,
                             top_k=self._max_top_k)
        st["window"][lane][wpos % len(window)].copy_(token)
        return token, wpos + 1

    def _finish_admission(self, adm: dict, lane: int, slots: list) -> None:
        """Prefill complete: sample the first token, write the lane, install.

        With other lanes decoding, the first token's read is deferred to
        the slot's first harvest (a pinned copy now): reading it here would
        wait for the chunk queued before it and starve the live lanes.  With
        no live lane the read is immediate: the tightest TTFT."""
        item = adm["item"]
        try:
            ids, n_prompt = adm["ids"], adm["n_prompt"]
            self._lane_claims[lane] = None   # the lane is overwritten below
            token, wpos = self._first_token(adm, lane, item.sp)
            _write_lane(self._bstate, lane, self._scratch_cache, n_prompt, token, wpos)

            budget = min(self._token_budget(item.max_tokens, n_prompt),
                         max(0, self.cfg.n_ctx - 1 - n_prompt))
            slot = _Slot(item, budget, n_prompt, ids)
            slot.stops = item.stops
            slot.sp = item.sp
            slot.t_admit = adm["t0"]
            slot.pspan = adm.get("span")
            slot.reused = adm.get("reused", 0)
            if slot.reused:     # count only realized reuse (the lane written)
                self._prefix_stats[f"{self._reuse_stat}_hits"] += 1
                self._prefix_stats[f"{self._reuse_stat}_reused_tokens"] += slot.reused
            if any(s is not None for s in slots):
                slot.first_token = _HostValue(token)
                slot.ttft_s = None              # set when read
                slot.pending_first = True
                self._open_decode_span(lane, slot)
                slots[lane] = slot
                return
            slot.first_token = int(token)   # host sync: prefill done = TTFT
            slot.ttft_s = time.time() - adm["t0"]
            self._end_prefill_span(slot)
            if slot.sink is not None:
                slot.sink.put(self._chunk(slot, {"role": "assistant"}))
            self._install(lane, slots, slot)
        except Exception as e:  # noqa: BLE001 — per-request isolation
            self._note_error(e)
            if adm.get("span") is not None:
                adm["span"].set(error=str(e)).end()
            if item.future is not None and not item.future.done():
                item.future.set_exception(e)
            elif item.sink is not None:
                item.sink.put(e)
        finally:
            # the restored scratch is in the lane (or the admission failed):
            # the pages become evictable again
            self._release_adm_lease(adm)

    def _end_prefill_span(self, slot: _Slot) -> None:
        """Close the admission's ``prefill`` span at TTFT (idempotent)."""
        if slot.pspan is not None:
            if slot.ttft_s is not None:
                slot.pspan.set(ttft_s=round(slot.ttft_s, 6))
            slot.pspan.end()
            slot.pspan = None
            slot.trace.note(tokens=1)

    def _materialize_first(self, lane: int, slot: _Slot, slots: list) -> None:
        """A deferred admission's first harvest: read the first token, TTFT,
        open the stream, and the first stop/budget checks."""
        slot.pending_first = False
        try:
            slot.first_token = int(slot.first_token)
        except Exception as e:  # noqa: BLE001 — per-request isolation
            self._note_error(e)
            slot.finished = True
            self._end_prefill_span(slot)
            self._free_lane(lane, slot, slots, claim=False)
            if slot.sink is not None:
                slot.sink.put(e)
            elif not slot.future.done():
                slot.future.set_exception(e)
            return
        slot.ttft_s = time.time() - slot.t_admit
        self._end_prefill_span(slot)
        if slot.sink is not None:
            slot.sink.put(self._chunk(slot, {"role": "assistant"}))
        self._install(lane, slots, slot)

    def _open_decode_span(self, lane: int, slot: _Slot) -> None:
        """The slot's lane-occupancy ``decode`` span (idempotent)."""
        if slot.trace is not None and slot.dspan is None:
            slot.trace.note(lane=lane)
            slot.dspan = slot.trace.span("decode").set(lane=lane)
            slot.t_chunk = time.time()

    def _close_decode_span(self, slot: _Slot, finish: str) -> None:
        if slot.dspan is not None:
            slot.dspan.set(finish=finish, tokens=len(slot.gens))
            slot.dspan.end()
            slot.dspan = None

    def _chunk(self, slot: _Slot, delta: dict, finish=None) -> dict:
        return {
            "id": slot.cid,
            "object": "chat.completion.chunk",
            "created": slot.created,
            "model": self.model_name,
            "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
        }

    def _emit_stream(self, slot: _Slot, done: bool) -> str | None:
        """Push the newly decoded text to the stream's sink; "stop" when a
        stop string was hit (the caller finishes the slot)."""
        bts = self.tokenizer.decode_bytes(slot.gens)
        text = bts.decode("utf-8", errors="replace")
        cut = self._find_stop_str(text, slot.stops)
        hit = cut != -1
        if hit:
            text = text[:cut]
        if done or hit:             # flush: exactly up to the final text
            if len(text) > slot.n_emitted:
                slot.sink.put(self._chunk(slot, {"content": text[slot.n_emitted:]}))
                slot.n_emitted = len(text)
        else:
            slot.held += slot.dec.decode(bts[slot.sent_bytes:])
            slot.sent_bytes = len(bts)
            hold = self._stop_prefix_holdback(slot.held, slot.stops)
            ready = slot.held[:len(slot.held) - hold]
            slot.held = slot.held[len(slot.held) - hold:]
            if ready:
                slot.sink.put(self._chunk(slot, {"content": ready}))
                slot.n_emitted += len(ready)
        return "stop" if hit else None

    def _slot_timings(self, slot: _Slot) -> dict:
        decode_s = time.time() - slot.t_admit - slot.ttft_s
        n = len(slot.gens)
        return {
            "ttft_s": slot.ttft_s, "decode_s": decode_s,
            "prompt_tokens": slot.n_prompt, "completion_tokens": n,
            "prefix_reused_tokens": slot.reused,
            "bucket": self._bucket_for(slot.n_prompt),
            "model": self.model_name,
            "tokens_per_sec": (n - 1) / decode_s if n > 1 and decode_s > 0 else 0.0,
        }

    def _finish_slot(self, slot: _Slot, finish: str):
        slot.finished = True
        timings = self._slot_timings(slot)
        self._record_timings(timings)
        self._close_decode_span(slot, finish)
        if slot.sink is not None:
            hit = self._emit_stream(slot, done=True)
            final = self._chunk(slot, {}, finish=hit or finish)
            final["lfkt_timings"] = timings
            slot.sink.put(final)
            slot.sink.put(_STREAM_END)
            return
        text = self._decode_text(slot.gens)
        cut = self._find_stop_str(text, slot.stops)
        if cut != -1:
            text = text[:cut]
            finish = "stop"
        if slot.future.done():
            # resolved elsewhere (a watchdog trip) while the chunk ran
            return
        slot.future.set_result({
            "lfkt_timings": timings,
            "id": slot.cid,
            "object": "chat.completion",
            "created": slot.created,
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish,
            }],
            "usage": {
                "prompt_tokens": slot.n_prompt,
                "completion_tokens": len(slot.gens),
                "total_tokens": slot.n_prompt + len(slot.gens),
            },
        })

    def _install(self, lane: int, slots: list, slot: _Slot) -> None:
        """A freshly admitted slot: first-token stop/budget checks, stream
        open, lane assignment."""
        stop_ids = self.tokenizer.stop_ids
        first = slot.first_token
        if slot.budget <= 0:
            self._finish_slot(slot, "length")
        elif first in stop_ids:
            self._finish_slot(slot, "stop")
        else:
            slot.gens.append(first)
            if len(slot.gens) >= slot.budget:
                self._finish_slot(slot, "length")
            elif slot.sink is not None and self._emit_stream(slot, done=False) == "stop":
                self._finish_slot(slot, "stop")
            else:
                self._open_decode_span(lane, slot)
                slots[lane] = slot
        if slot.finished:
            # its prompt KV is a valid claim (the first token was never fed)
            self._free_lane(lane, slot, slots)

    def _admit_step(self, slots: list) -> int | None:
        """One unit of admission progress: begin the next queued item (and
        its first slice), or the in-flight admission's next slice —
        finishing it when the last real token's slice lands.  Returns the
        prefill tokens dispatched (0 for bookkeeping-only progress), or
        None when there is nothing to do."""
        if self._adm is None:
            if not any(s is None for s in slots):
                return None                     # no free lane
            try:
                item = self._pending.get_nowait()
            except queue_mod.Empty:
                return None
            self._adm = self._begin_admission(item)
            if self._adm is None:
                return 0
        adm = self._adm
        if adm["item"].abandoned.is_set():       # the caller gave up mid-prefill
            if adm.get("span") is not None:
                adm["span"].set(abandoned=True).end()
            self._release_adm_lease(adm)
            self._resolve_skipped(adm["item"])
            self._adm = None
            return 0
        off_before = adm["offset"]
        try:
            self._dispatch_prefill_chunk(adm)
        except Exception as e:  # noqa: BLE001 — a failed admission fails alone
            item = adm["item"]
            self._adm = None
            self._release_adm_lease(adm)
            self._note_error(e)
            if adm.get("span") is not None:
                adm["span"].set(error=str(e)).end()
            if item.future is not None:
                item.future.set_exception(e)
            elif item.sink is not None:
                item.sink.put(e)
            return 0
        # stop at the slice holding the last real token
        if adm["offset"] >= adm["n_prompt"]:
            self._adm = None
            lane = next(i for i, s in enumerate(slots) if s is None)
            self._finish_admission(adm, lane, slots)
        return adm["offset"] - off_before

    def _admit_round(self, slots: list) -> bool:
        """One wave's admissions: progress until the wave's prefill-token
        budget runs out or the lanes or the queue are exhausted.  At most one
        admission is mid-prompt, so the single scratch ring is safe: a
        finished admission's lane write is queued before the next one's
        first slice.  With the controller off a mid-prompt admission yields
        after one slice (the static mode).  True if anything progressed."""
        budget = self._adm_budget
        progressed = False
        while budget > 0:
            spent = self._admit_step(slots)
            if spent is None:
                break
            progressed = True
            budget -= spent
            if self._adm is not None and self._adm_ctl is None:
                break
        return progressed

    def _note_mem_pressure(self) -> None:
        """The rising edge of memory pressure: a counter and an event on
        every in-flight trace."""
        hr = _memledger.MEMLEDGER.last_headroom
        attrs = {}
        if hr is not None:
            attrs = {"headroom_bytes": hr[0], "limit_bytes": hr[1]}
        logger.warning("device memory pressure: admission budget cut (headroom %s of %s "
                       "bytes)", attrs.get("headroom_bytes", "?"),
                       attrs.get("limit_bytes", "?"))
        annotate_all_inflight("mem_pressure", **attrs)
        m = self.metrics_sink
        if m is not None:
            try:
                m.inc("mem_pressure_events_total")
            except Exception:  # noqa: BLE001 — telemetry never fails serving
                pass

    def scheduler_stats(self) -> dict:
        """Scheduler occupancy for ``/metrics``: lanes live, queue depth,
        admission in flight, the live admission budget and its EMAs, idle
        lane-seconds, and the lane-prefix counters."""
        out = {"batch_size": self.batch_size, **self._stats}
        if self._lane_prefix or self._kv_paged:
            out.update(self._prefix_stats)
        if self._spec_draft:
            out["spec"] = dict(self._spec_stats)
        return out

    def _harvest(self, pre: list, chunk: np.ndarray, slots: list,
                 counts: np.ndarray | None = None) -> None:
        """Fold one read chunk (n_steps, B) into its lanes' slots.  ``pre`` is
        the lane snapshot taken when the chunk was queued; a slot finished
        meanwhile is skipped.  An abandoned, aborted, cancelled or expired
        request frees its lane here.  ``counts`` (a verify round): lane
        ``l`` emitted only ``chunk[:counts[l], l]``; later rows were sampled
        after a rejected draft token and are dropped."""
        stop_ids = self.tokenizer.stop_ids
        now = time.time()
        for lane in range(len(pre)):
            slot = pre[lane]
            if slot is None or slot.finished:
                continue
            expired = slot.deadline is not None and now > slot.deadline
            if expired or slot.abandoned.is_set() or (
                    slot.abort is not None and slot.abort()) or (
                    slot.future is not None and slot.future.cancelled()):
                slot.finished = True
                exc = DeadlineExceeded(
                    "request deadline expired mid-generation") if expired else None
                self._end_prefill_span(slot)
                self._close_decode_span(slot, "deadline" if expired else "abandoned")
                if slot.sink is not None:
                    slot.sink.put(exc if exc is not None else _STREAM_END)
                elif not slot.future.done():
                    if exc is not None:
                        slot.future.set_exception(exc)
                    else:
                        slot.future.set_exception(CancelledError())
                self._free_lane(lane, slot, slots)
                continue
            if slot.pending_first:
                # a deferred admission: its first token was sampled before
                # this chunk; read it, then fold in the chunk's rows
                self._materialize_first(lane, slot, slots)
                if slot.finished:
                    continue
            finish = None
            col = chunk[:, lane]
            if counts is not None:
                col = col[:int(counts[lane])]
            for t in col.tolist():
                if t in stop_ids:
                    finish = "stop"
                    break
                slot.gens.append(t)
                if len(slot.gens) >= slot.budget:
                    finish = "length"
                    break
            if slot.dspan is not None:
                slot.dspan.child("decode_chunk", t0=slot.t_chunk).set(
                    tokens=len(slot.gens),
                    kind="verify" if counts is not None else "chunk").end(now)
                slot.t_chunk = now
                slot.trace.note(tokens=len(slot.gens))
            if finish is not None:
                self._finish_slot(slot, finish)
                self._free_lane(lane, slot, slots)
            elif slot.sink is not None:
                if self._emit_stream(slot, done=False) == "stop":
                    self._finish_slot(slot, "stop")
                    self._free_lane(lane, slot, slots)

    def _spec_drafts(self, slots: list):
        """(drafts (B, D), hit lanes): zero rows for lanes with no n-gram
        hit, no budget, a first token still on the device, or no slot (they
        advance by one true sample).  None when no lane has a hit — the
        pipelined chunk is better then — and when any live lane lacks the
        ring room for D+1 slots (+2 for a deferred first token): a verify
        writes D+1 slots at every lane, and the chunk path serves that lane
        safely."""
        D = self._spec_draft
        drafts = np.zeros((self.batch_size, D), np.int64)
        hits = []
        for lane, slot in enumerate(slots):
            if slot is None or slot.finished:
                continue
            pos = slot.n_prompt + len(slot.gens)
            if pos + D + 2 >= self.cfg.n_ctx:
                return None
            if slot.pending_first or slot.budget - len(slot.gens) <= 1:
                continue
            d = Engine._lookup_draft(list(slot.ids) + slot.gens, D)
            if d is not None:
                drafts[lane] = d
                hits.append(lane)
        return (drafts, hits) if hits else None

    def _spec_round(self, slots: list, got: tuple) -> None:
        """One verify round of every lane (the pipeline flushed by the
        caller; ``got`` the drafts): queue it, overlap admissions, read the
        lanes' emitted prefixes and advance the host mirrors of the lanes
        it served (a lane admitted meanwhile had its mirror rewritten)."""
        drafts, hits = got
        pre = list(slots)
        FAULTS.fire("decode_step")
        record_dispatch("lane_spec_verify")
        queued = lane_verify(self.params, self.cfg, self._bstate, self._lane_st, drafts,
                             top_k=self._max_top_k)
        self._admit_round(slots)         # admissions overlap the verify
        toks, cnts = queued.read()
        mirror = self._bstate["slots"]
        for lane, slot in enumerate(pre):
            if slot is not None:
                mirror[lane] += int(cnts[lane])
        self._harvest(pre, toks.T, slots, counts=cnts)
        self._spec_stats["verify_steps"] += 1
        self._spec_stats["drafted"] += self._spec_draft * len(hits)
        self._spec_stats["accepted"] += int(sum(max(0, int(cnts[l]) - 1) for l in hits))

    def _loop(self):
        B = self.batch_size
        slots: list[_Slot | None] = [None] * B
        pending = None   # (lane snapshot, LaneChunk not yet read)
        t_prev_wave = time.time()
        try:
            while not self._stop:
                if not any(s is not None for s in slots) and pending is None:
                    # nothing decoding: admissions stall nobody, so run them
                    # at full speed until a lane fills
                    progressed = False
                    while not any(s is not None for s in slots):
                        if self._admit_step(slots) is None:
                            break
                        progressed = True
                    if not any(s is not None for s in slots):
                        if not progressed:
                            self._wake.wait(timeout=0.05)
                            self._wake.clear()
                        continue
                    t_prev_wave = time.time()

                # ---- speculation: when a live lane's history has an n-gram
                # hit, flush the pipeline (drafts need the current
                # histories) and run verify rounds while drafts hit; not
                # pipelined, the next drafts need this round's tokens
                if self._spec_draft and any(s is not None for s in slots):
                    if self._lane_graphs is not None:
                        # on the card the verify round is a graph: captured
                        # here, on the scheduler, at the first wave (0 s
                        # once held)
                        self._lane_graphs.capture_verify()
                    got = self._spec_drafts(slots)
                    if got is not None and pending is not None:
                        self._harvest(pending[0], pending[1].rows(), slots)
                        pending = None
                        got = self._spec_drafts(slots)  # histories advanced
                    while not self._stop and got is not None:
                        self._spec_round(slots, got)
                        got = self._spec_drafts(slots)

                # ---- one decode chunk of every lane, queued before the
                # previous chunk is read (pipelined one chunk deep): a lane
                # whose request finished in the previous chunk decodes one
                # extra chunk before it frees, its rows dropped
                if any(s is not None for s in slots):
                    pre = list(slots)
                    FAULTS.fire("decode_step")
                    record_dispatch(self._lane_program)
                    toks = generate_chunk_lanes(self.params, self.cfg, self._bstate,
                                                self._lane_st, self.decode_chunk,
                                                top_k=self._max_top_k)
                    self._spec_stats["chunk_steps"] += 1
                    dispatched = (pre, toks)
                else:
                    dispatched = None

                # ---- admissions overlap the chunk, up to the wave's budget
                self._admit_round(slots)

                # ---- read the previous chunk: the wait is the decode-
                # pressure signal of the admission controller
                fetch_wait = 0.0
                if pending is not None:
                    t_f = time.time()
                    chunk_np = pending[1].rows()
                    fetch_wait = time.time() - t_f
                    self._harvest(pending[0], chunk_np, slots)
                now = time.time()
                wave_s = max(now - t_prev_wave, 0.0)
                t_prev_wave = now
                mem_hot = False
                if dispatched is not None:
                    live_wave = sum(s is not None for s in dispatched[0])
                    self._lane_idle_s += (B - live_wave) * wave_s
                    if self._adm_ctl is not None:
                        mem_hot = _memledger.MEMLEDGER.pressure()
                        self._adm_budget = self._adm_ctl.observe_wave(
                            live_wave, fetch_wait, wave_s, mem_pressure=mem_hot)
                        if mem_hot and not self._mem_hot_prev:
                            self._note_mem_pressure()
                        self._mem_hot_prev = mem_hot
                pending = dispatched
                stats = {
                    "lanes_live": sum(s is not None for s in slots),
                    "pending": self._pending.qsize(),
                    "admission_inflight": int(self._adm is not None),
                    "adm_budget_tokens": self._adm_budget,
                    "lane_idle_seconds": round(self._lane_idle_s, 3),
                    "mem_pressure": int(mem_hot),
                }
                if self._adm_ctl is not None:
                    stats.update(self._adm_ctl.stats())
                self._stats = stats
                # the watchdog's pulse: a beat a pass, busy = queued + live
                self.heartbeat.beat()
                self.heartbeat.set_busy(self._stats["lanes_live"] + self._stats["pending"]
                                        + self._stats["admission_inflight"])
        except BaseException as e:  # noqa: BLE001 — fail all, loudly
            self._loop_error = e
            self.heartbeat.record_error(e)
            logger.exception("scheduler loop died")
        finally:
            # a stop and a crash both resolve every outstanding request
            err = self._loop_error or RuntimeError("engine has been shut down")
            if self._adm is not None:
                item = self._adm["item"]
                self._release_adm_lease(self._adm)
                self._adm = None
                if item.sink is not None:
                    item.sink.put(err if self._loop_error else _STREAM_END)
                elif not item.future.done():
                    item.future.set_exception(err)
            for s in slots:
                if s is None:
                    continue
                if s.sink is not None:
                    s.sink.put(err if self._loop_error else _STREAM_END)
                elif not s.future.done():
                    s.future.set_exception(err)
            while True:
                try:
                    item = self._pending.get_nowait()
                except queue_mod.Empty:
                    break
                if item.sink is not None:
                    item.sink.put(err if self._loop_error else _STREAM_END)
                elif not item.future.done() and not item.future.cancel():
                    item.future.set_exception(err)
            # the occupancy gauges zeroed last: a dead loop must not keep
            # reporting pre-crash lanes
            self._stats = {"lanes_live": 0, "pending": 0, "admission_inflight": 0}
            self.heartbeat.set_busy(0)

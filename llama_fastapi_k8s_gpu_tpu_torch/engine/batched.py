"""The cycle scheduler's engine: up to ``batch_size`` chat completions in
one batched generation.

The port of the reference's ``MeshEngine`` (llama_fastapi_k8s_gpu_tpu/
engine/batched.py): the server's consumer coalesces up to
``batch_size`` queued requests into one cycle, each request takes a lane
of the lane state (parallel/batched.py), the lanes prefill one after
another on their own ring views, sample their first tokens together, and
decode together — a lane batch is B rows for every linear, so a decode
step reads the weights once for B tokens.  On the card a decode chunk is
replays of one CUDA graph of the lane step (``LaneGraphs``); on the CPU
the same step runs eagerly.

``create_chat_completion`` stays the serial engine's (the server streams
through it, one stream at a time in its FIFO slot).

Over a dp × tp mesh (``tp`` > 1 or ``dp`` > 1; parallel/mesh.py) the
weights are tensor-parallel shards, the serial ring a ``ShardedRing`` over
tp and the lane ring one over dp × tp.  Over an explicit device list
(which may repeat a device: tests, ``chip_smoke.py``) ``dp`` defaults to
the devices over ``tp`` that divide ``batch_size``, as the reference's
does.  With no list ``dp`` defaults to 1 and a ``tp`` > 1 mesh takes the
pod's cards: too few raise, and several distinct cards raise too (one
CUDA graph a decode step; ROADMAP A.1).  Under ``kv_paged`` the serial
and stream paths consult the radix index over the sharded serial ring
(whole-head pages, parallel/kvpool.py); the cycles leave their lane rings
alone, as the reference's do.  Under ``decode_layer_unroll`` a decode
step over the mesh is the layer-looped kernel once per lane (the serial
path: once a token), each launch reading every tp shard of its dp group
(ops/decode_loop.py).
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Sequence

import torch

from ..obs.devtime import ENTRY, record_dispatch, register_program
from ..obs.memledger import register_component
from ..parallel.mesh import Mesh, make_mesh, ring_nbytes_by_device, ring_zero_
from ..parallel.batched import (
    LaneGraphs,
    batched_prefill,
    generate_chunk_lanes,
    init_batched_state,
    state_nbytes,
)
from ..sampling.sample import (
    PENALTY_WINDOW,
    SamplingParams,
    lane_tensors,
    sample_chain_lanes,
    sampling_tensors,
    seed_window,
)
from ..utils.faults import FAULTS
from .engine import Engine, ledger_by_shard

logger = logging.getLogger(__name__)

register_program("batched_first_sample", ENTRY, site="engine.batched")


def _ledger_lane_bytes(eng: "MeshEngine") -> int | dict:
    """Memory-ledger provider: the lane state's device bytes — over a mesh,
    the lane ring a shard (``engine.ledger_by_shard``), the bookkeeping on
    the first."""
    state = getattr(eng, "_bstate", None)
    if state is None or eng.mesh is None:
        return state_nbytes(state)
    rows = ledger_by_shard(eng, ring_nbytes_by_device(state["cache"]))
    rows[next(iter(rows))] += state_nbytes({**state, "cache": {}})
    return rows


@torch.inference_mode()
def _batched_first_sample(logits: torch.Tensor, state: dict, st: dict, windows: torch.Tensor,
                          wposes: list, top_k: int = 40) -> torch.Tensor:
    """Sample every lane's first token from its prompt logits (B, V) into
    the lane state: the penalty rings set to ``windows`` (B, 64), each
    lane's token pushed at its ``wposes`` slot, ``token`` set.  Returns the
    tokens (B,)."""
    state["window"].copy_(windows)
    tok = sample_chain_lanes(logits, state["window"], state["gens"], st, top_k)
    B = tok.shape[0]
    wpos = torch.tensor(wposes, dtype=torch.int64)
    state["window"][torch.arange(B, device=tok.device),
                    (wpos % PENALTY_WINDOW).to(tok.device)] = tok
    state["wpos"].copy_(wpos + 1)
    state["token"].copy_(tok)
    return tok


class MeshEngine(Engine):
    """An :class:`Engine` that also serves batches of up to ``batch_size``
    requests in lanes (:meth:`create_chat_completions`), on one device or
    over a dp × tp mesh of ``devices``."""

    #: the compile-registry program of this engine's lane chunk
    _LANE_PROGRAM = "batched_decode_chunk"

    # the batched state joins the serial ring under the generation mutex
    # (lfkt-lint LOCK001)
    _GUARDED_BY = {"_bstate": "_lock"}
    # the lane state and knobs the lane graph holds by address (lfkt-lint
    # PIN001): reset in place, never rebound
    _GRAPH_PINNED = ("_bstate", "_lane_st")

    def __init__(self, model_path: str | None, *, dp: int | None = None, tp: int = 1,
                 batch_size: int | None = None, max_top_k: int = 64, devices=None, **kw):
        if batch_size is not None and int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._mesh_request = (dp, int(tp), batch_size, devices)
        super().__init__(model_path, **kw)
        # static top_k ceiling of the lane step; a request's own k masks
        # below it (effectively min(requested, ceiling))
        self._max_top_k = max(max_top_k, SamplingParams().top_k)
        if self.device.type == "cuda":
            self._lane_graphs = LaneGraphs(self.params, self.cfg, self.batch_size,
                                           self.device, top_k=self._max_top_k,
                                           program=self._lane_program,
                                           draft_len=self._spec_draft
                                           if getattr(self, "_SPEC_LANES", False) else 0,
                                           mesh=self.mesh)
            self._bstate = self._lane_graphs.state
            self._lane_st = self._lane_graphs.knobs
        else:
            self._lane_graphs = None
            with torch.inference_mode():
                self._bstate = init_batched_state(
                    self.cfg, self.batch_size, self.device, mesh=self.mesh,
                    tp_split=getattr(self.params, "tp_heads", True))
                self._lane_st = lane_tensors([SamplingParams()] * self.batch_size,
                                             self.device)
        register_component("kv_lanes", self, _ledger_lane_bytes)

    def _make_mesh(self) -> Mesh | None:
        """The reference's geometry over an explicit device list: ``dp``
        defaults to the largest count of ``len(devices) // tp`` groups that
        divides ``batch_size`` (all of them without one), and ``batch_size``
        to ``dp``.  With no list ``dp`` defaults to 1: a mesh over the pod's
        distinct cards is not served yet (ROADMAP A.1), so the lanes of a
        pod with several cards stay on the engine's card.  A 1 × 1 mesh is
        no mesh: the one-device path.  Over the mesh the paged pool, the
        layer-looped decode and (in the continuous engine) lane
        speculation serve; a mesh over distinct cards raises
        (``Engine._check_mesh``)."""
        dp, tp, batch_size, devices = self._mesh_request
        if devices is None and dp is None:
            dp = 1
        devs = self._mesh_devices(devices)
        avail = max(1, len(devs) // tp)
        if dp is None:
            dp = (avail if batch_size is None
                  else max(d for d in range(1, avail + 1) if int(batch_size) % d == 0))
        self.batch_size = int(batch_size or dp)
        if self.batch_size % dp:
            raise ValueError(f"batch_size {self.batch_size} must be divisible by dp={dp}")
        if dp == 1 and tp == 1:
            return None
        return make_mesh(dp=dp, tp=tp, devices=devs)

    @property
    def _lane_program(self) -> str:
        """The lane chunk's compile-registry program (``mesh_…`` over a mesh)."""
        return self._LANE_PROGRAM if self.mesh is None else f"mesh_{self._LANE_PROGRAM}"

    def close(self) -> None:  # lfkt: blocks-under[_lock] -- close waits for the replays queued on the card before it drops the graphs' memory pool; the lock keeps a generation from replaying a graph being released
        """Release the lane graphs and the serial engine's."""
        super().close()
        with self._lock:
            if self._lane_graphs is not None:
                self._lane_graphs.close()
                self._lane_graphs = None

    @torch.inference_mode()
    def _reset_lanes(self) -> None:
        """Zero the lane state in place (the lane graphs hold its
        addresses) and put every lane's knobs back to the defaults."""
        s = self._bstate
        ring_zero_(s["cache"])
        for k in ("pos", "token", "wpos", "out"):
            s[k].zero_()
        s["window"].fill_(-1)
        s["slots"] = [0] * self.batch_size
        self._set_knobs(SamplingParams())

    def _recover_locked(self) -> None:  # lfkt: holds[_lock]
        """The serial ring and the lane state zeroed in place."""
        super()._recover_locked()
        self._reset_lanes()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _set_knobs(self, sp: SamplingParams) -> None:
        """Every lane's knobs set to ``sp``, in place, by host-scalar fills."""
        for k, v in sampling_tensors(sp, "cpu").items():
            self._lane_st[k].fill_(v.item())

    # ------------------------------------------------------------------
    def warmup(self):  # lfkt: blocks-under[_lock] -- warmup captures and syncs under the engine lock by design: a request must never race a half-warmed cache
        """On the card, capture the lane step (at the ``top_k`` ceiling)
        first; then a full batch of short greedy completions, one batched
        prompt pass at the largest bucket (the most activation memory a
        cycle takes), and the serial engine's warmup (streams take the
        serial path)."""
        t0 = time.time()
        if self._lane_graphs is not None:
            with self._lock:
                self._lane_graphs.capture()
        msgs = [{"role": "user", "content": "hi"}]
        self.create_chat_completions([msgs] * self.batch_size,
                                     max_tokens=2 * self.decode_chunk + 1, temperature=0.0)
        with self._lock:
            b = self.prefill_buckets[-1]
            tokens = torch.zeros((self.batch_size, b), dtype=torch.int64, device=self.device)
            batched_prefill(self.params, self.cfg, tokens, [b] * self.batch_size,
                            self._bstate["cache"]).cpu()
        super().warmup()
        logger.info("mesh warmup done in %.1fs (batch=%d)", time.time() - t0,
                    self.batch_size)

    # ------------------------------------------------------------------
    def create_chat_completions(  # lfkt: blocks-under[_lock] -- the mesh engine serializes whole batches under its lock by design: drill sleeps and incident capture ride the generation path, and _set_knobs' .item() reads a host tensor, not the card
        self,
        batch_messages: Sequence[Sequence[dict]],
        *,
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
        deadlines: Sequence[float | None] | None = None,
        aborts: Sequence | None = None,
        traces: Sequence | None = None,
    ) -> list[dict]:
        """Generate up to ``batch_size`` completions in one batched cycle;
        one OpenAI-shaped dict per input, in order (an entry's own input
        error is a ``{"error": ...}`` dict).  ``deadlines``/``aborts`` are
        per entry: an expired entry stops taking tokens
        (``finish_reason="deadline"``) within one decode chunk, and the
        cycle ends once every live entry is done.  ``top_k`` is served up
        to the engine's ``max_top_k`` ceiling, as the continuous engine
        serves it."""
        if not batch_messages:
            return []
        if len(batch_messages) > self.batch_size:
            raise ValueError(
                f"batch of {len(batch_messages)} exceeds batch_size {self.batch_size}")
        if stop is None:
            stop = []
        elif isinstance(stop, str):
            stop = [stop]
        sp = SamplingParams(
            temperature=temperature, top_p=top_p, top_k=top_k, min_p=min_p,
            frequency_penalty=frequency_penalty, presence_penalty=presence_penalty,
            repeat_penalty=repeat_penalty,
        )
        with self._lock:
            self._check_usable()
            self.heartbeat.enter()
            try:
                return self._generate_batch(list(batch_messages), sp, max_tokens, stop, seed,
                                            deadlines=deadlines, aborts=aborts, traces=traces)
            except Exception as e:  # noqa: BLE001 — burst detection, re-raised
                self._note_error(e)
                raise
            finally:
                self.heartbeat.leave()

    @staticmethod
    def _lane_expired(b: int, deadlines, aborts, now: float) -> bool:
        if aborts is not None and b < len(aborts) and aborts[b] is not None and aborts[b]():
            return True
        return (deadlines is not None and b < len(deadlines)
                and deadlines[b] is not None and now > deadlines[b])

    def _generate_batch(self, batch_messages, sp, max_tokens, stops, seed,  # lfkt: holds[_lock]
                        deadlines=None, aborts=None, traces=None):
        B = self.batch_size
        n_real = len(batch_messages)
        espans: list = [None] * B
        if traces is not None:
            for b, tr in enumerate(traces[:B]):
                if tr is not None:
                    tr.note(lane=b, tokens=0, **self._trace_attrs())
                    espans[b] = tr.span("engine").set(lane=b, shared_cycle=True,
                                                      **self._trace_attrs())
        dummy = [self.tokenizer.bos_id or 0]
        # an oversized prompt is its own request's error: a dummy lane, and
        # the neighbours are served
        ids_list, errors = [], {}
        for i, m in enumerate(batch_messages):
            ids = self.tokenize_messages(m)
            if len(ids) >= self.cfg.n_ctx:
                errors[i] = (f"Requested tokens ({len(ids)}) exceed context "
                             f"window of {self.cfg.n_ctx}")
                ids = dummy
            ids_list.append(ids)
        ids_list += [dummy] * (B - n_real)
        if seed is None:
            seed = self._next_seed()
        else:
            self._next_seed()
        with self._id_lock:  # advance past the whole batch
            self._requests += n_real - 1

        bucket = self._bucket_for(max(len(i) for i in ids_list))
        lengths = [len(i) for i in ids_list]
        tokens = torch.tensor([i + [0] * (bucket - len(i)) for i in ids_list],
                              dtype=torch.int64).to(self.device)
        self._set_knobs(sp)
        state = self._bstate

        t0 = time.time()
        FAULTS.fire("prefill")
        self.heartbeat.beat()
        record_dispatch("batched_prefill")
        logits = batched_prefill(self.params, self.cfg, tokens, lengths, state["cache"])
        windows, wposes = zip(*(seed_window(i, "cpu") for i in ids_list))
        for b, g in enumerate(state["gens"]):
            g.manual_seed(seed + b)
        with torch.inference_mode():
            state["pos"].copy_(torch.tensor(lengths, dtype=torch.int64))
        state["slots"] = list(lengths)
        record_dispatch("batched_first_sample")
        toks = _batched_first_sample(logits, state, self._lane_st,
                                     torch.stack(windows).to(self.device), list(wposes),
                                     top_k=self._max_top_k)
        first = toks.tolist()                     # host sync: the batch's TTFT
        ttft = time.time() - t0
        for b, es in enumerate(espans):
            if es is not None:
                es.child("prefill", t0=t0).set(n_prompt=len(ids_list[b]), bucket=bucket,
                                               ttft_s=round(ttft, 6)).end()

        stop_ids = self.tokenizer.stop_ids
        # per-lane budget and capacity: lane b may store n_ctx-1-len_b new
        # tokens whatever its neighbours' prompts; a lane past its capacity
        # keeps decoding on the card at its clamped slot, its tokens dropped
        budgets = [min(self._token_budget(max_tokens, len(i)),
                       max(0, self.cfg.n_ctx - 1 - len(i))) for i in ids_list]
        gens: list[list[int]] = []
        done = [False] * B
        finishes = ["length"] * B
        for b, tok in enumerate(first):
            if b >= n_real or b in errors or budgets[b] <= 0:
                gens.append([])
                done[b] = True
            elif tok in stop_ids:
                gens.append([])
                done[b] = True
                finishes[b] = "stop"
            else:
                gens.append([tok])

        while not all(done):
            now = time.time()
            for b in range(B):
                if not done[b] and self._lane_expired(b, deadlines, aborts, now):
                    done[b] = True
                    finishes[b] = "deadline"
            if all(done):
                break
            self.heartbeat.beat()
            FAULTS.fire("decode_step")
            remaining = max(budgets[b] - len(gens[b]) for b in range(B) if not done[b])
            n_steps = min(self.decode_chunk, remaining)
            if n_steps <= 0:
                break
            t_chunk = time.time()
            record_dispatch(self._lane_program)
            chunk = generate_chunk_lanes(self.params, self.cfg, state, self._lane_st,
                                         n_steps, top_k=self._max_top_k).rows()  # host sync
            for b in range(B):
                if done[b]:
                    continue
                for t in chunk[:, b].tolist():
                    if t in stop_ids:
                        done[b] = True
                        finishes[b] = "stop"
                        break
                    if len(gens[b]) >= budgets[b]:
                        done[b] = True
                        break
                    gens[b].append(t)
                if len(gens[b]) >= budgets[b]:
                    done[b] = True
                if espans[b] is not None:
                    espans[b].child("decode_chunk", t0=t_chunk).set(tokens=len(gens[b])).end()
                    traces[b].note(tokens=len(gens[b]))

        for b, es in enumerate(espans):
            if es is not None:
                es.set(finish=finishes[b], completion_tokens=len(gens[b]))
                es.end()
        decode_s = time.time() - t0 - ttft
        total_new = sum(len(g) for g in gens[:n_real])
        timings = {
            "ttft_s": ttft, "decode_s": decode_s,
            "prompt_tokens": int(sum(len(i) for i in ids_list[:n_real])),
            "bucket": bucket,
            "model": self.model_name,
            "completion_tokens": total_new,
            "tokens_per_sec": (total_new - n_real) / decode_s
            if decode_s > 0 and total_new > n_real else 0.0,
        }
        self._record_timings(timings)

        out = []
        for b in range(n_real):
            if b in errors:
                out.append({"error": {"message": errors[b],
                                      "type": "invalid_request_error"}})
                continue
            text = self._decode_text(gens[b])
            cut = self._find_stop_str(text, stops)
            finish = finishes[b]
            if cut != -1:
                text = text[:cut]
                finish = "stop"
            out.append({
                "lfkt_timings": timings,  # batch-level: one shared cycle
                "id": f"chatcmpl-{uuid.uuid4().hex}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [{
                    "index": 0,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": finish,
                }],
                "usage": {
                    "prompt_tokens": len(ids_list[b]),
                    "completion_tokens": len(gens[b]),
                    "total_tokens": len(ids_list[b]) + len(gens[b]),
                },
            })
        return out

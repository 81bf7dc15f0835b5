"""Autoregressive generation: prompt passes, first sample, decode chunks.

The reference runs a decode chunk as one jitted ``lax.scan`` over a
donated state (llama_fastapi_k8s_gpu_tpu/models/generate.py,
``generate_chunk_jit``).  Here one decode+sample step is one function,
:func:`decode_step`, over a state that lives on the device and is updated
**in place**.  The step reads no device value on the host, and no shape
or launch argument in it depends on the position, so:

- on the card, :class:`DecodeGraphs` captures the step once in a CUDA
  graph (one graph per ``top_k``, a static shape as in the reference) and
  a chunk of n steps is n replays of it: one host launch a token, where
  the eager step issues some 2,000;
- on the CPU, a chunk runs the same step eagerly, with the plain versions
  of the kernels.

State keys: ``cache`` (the KV ring dict), ``pos`` (the next cache slot,
0-d int64), ``token`` (0-d int64: the last sampled, not yet fed token),
``window`` (the penalty ring), ``wpos`` (0-d int64), ``out`` ((n_ctx,)
int64: ``out[p]`` is the token sampled after feeding slot ``p``, so a
chunk's tokens stay where no later step writes), ``gen`` (the
``torch.Generator``) and ``slot``, the host's mirror of ``pos``: it
advances by exactly the steps queued, so it never needs a device read.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

from ..obs.devtime import ENTRY, record_compile, register_program
from ..parallel.mesh import ring_device, ring_n_ctx
from ..sampling.sample import (PENALTY_WINDOW, SamplingParams, sample_chain, sampling_tensors,
                               seed_window)
from . import llama
from .config import ModelConfig
from .llama import forward


# the host programs of the compile registry: the engine counts a call of
# each as a dispatch (a decode chunk is one, whatever its replays)
for _name in ("prefill", "prefill_chunk", "first_sample", "decode_chunk", "spec_verify"):
    register_program(_name, ENTRY, site="models.generate")
del _name


def init_state(cache: dict, prompt_ids, seed: int,
               device: torch.device) -> dict:
    """Fresh generation state over ``cache`` for a prompt of ``prompt_ids``."""
    window, wpos = seed_window(prompt_ids, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = len(prompt_ids)
    n_ctx = ring_n_ctx(cache)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return {"cache": cache, "pos": scalar(n), "token": scalar(0), "window": window,
            "wpos": scalar(wpos), "out": torch.zeros(n_ctx, dtype=torch.int64, device=device),
            "gen": gen, "slot": n}


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, length: int,
            cache: dict) -> torch.Tensor:
    """Bucketed prompt pass from slot 0: ``tokens`` (S,) padded, ``length``
    real.  Returns the logits at the last real token; ``cache`` is
    written in place."""
    return llama.prefill(params, cfg, tokens, length, cache)


@torch.inference_mode()
def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                  pos_offset: int, last_idx: int, cache: dict) -> torch.Tensor:
    """One slice of a prompt pass: ``tokens`` (C,) enter the ring at
    ``pos_offset``; returns the logits at ``last_idx`` within the slice."""
    return forward(params, cfg, tokens, pos_offset, cache, last_idx=last_idx)


def _push(state: dict, token: torch.Tensor) -> None:
    """``token`` (0-d) into the penalty ring at ``wpos`` and into ``token``,
    by tensor-indexed writes."""
    slot = torch.remainder(state["wpos"], PENALTY_WINDOW).reshape(1)
    state["window"].index_copy_(0, slot, token.reshape(1))
    state["wpos"].add_(1)
    state["token"].copy_(token)


@torch.inference_mode()
def first_sample(logits: torch.Tensor, state: dict, st: dict,
                 top_k: int = 40) -> torch.Tensor:
    """Sample the first token from the prompt's logits into ``state``."""
    token = sample_chain(logits, state["window"], state["gen"], st, top_k=top_k)
    _push(state, token)
    return token


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, state: dict, st: dict,
                top_k: int = 40) -> torch.Tensor:
    """One decode+sample step, in place: feed ``state["token"]`` at slot
    ``state["pos"]``, sample the next token into ``out[pos]``, the penalty
    ring and ``token``, and advance ``pos`` and ``wpos``.  The same code on
    both devices; on the card it is what :class:`DecodeGraphs` captures.
    Returns the sampled token (0-d)."""
    logits = forward(params, cfg, state["token"].reshape(1), state["pos"], state["cache"])
    token = sample_chain(logits, state["window"], state["gen"], st, top_k=top_k)
    state["out"].index_copy_(0, state["pos"].reshape(1), token.reshape(1))
    state["pos"].add_(1)
    _push(state, token)
    return token


@torch.inference_mode()
def spec_verify(params, cfg: ModelConfig, state: dict, st: dict, draft: torch.Tensor,
                top_k: int = 40) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative-decoding verify step (prompt-lookup drafts), in place.

    Feeds ``[state["token"], draft...]`` — D+1 tokens — through one forward
    at slots pos..pos+D (the linears read their weights once for D+1
    rows), then replays the sampling chain over the D+1 logits in order.
    Position ``i``'s sample is *emitted* while every earlier sample matched
    its draft token, so the emitted prefix — including the first mismatch,
    which is the true sample — is what sequential decoding emits: each
    emitted token is sampled from the same logits' row under the penalty
    ring and ``wpos`` that sequential decoding would have, and the ring
    and ``wpos`` advance only for emitted positions (``alive`` is a device
    mask; nothing is read on the host).

    The generator is the one difference from the reference, whose PRNG key
    advances only for emitted positions: here every position draws its
    noise from ``state["gen"]``, so a round advances the generator by D+1
    draws whatever it emits, and a rejected position consumes draws.  Each
    emitted token still takes fresh noise, so sampled output is correct in
    distribution and, per seed, deterministic; greedy output (temperature
    0, no draw used) equals the vanilla path's.

    The rows score the whole ring under the mask, as a decode step does
    (the ``flash`` prompt path is swapped for the score matrix, as the
    reference swaps its Pallas kernel at S = D+1).  Rejected positions leave
    stale K/V in ring slots past the new ``pos``; the mask is positional,
    so they are never read and later steps overwrite them.  The caller
    keeps pos + D inside the ring (the engines' capacity veto).

    Returns ``(tokens (D+1,), count)`` on the device: ``tokens[:count]``
    are emitted (1 ≤ count ≤ D+1); ``pos`` advanced by ``count``, ``token``
    is the last emitted token."""
    D = draft.shape[0]
    if cfg.attn_impl == "flash":
        cfg = dataclasses.replace(cfg, attn_impl="xla")
    seq = torch.cat([state["token"].reshape(1), draft])
    logits = forward(params, cfg, seq, state["pos"], state["cache"], return_all=True)
    # position D has no guess to match: it never extends `alive`
    dpad = torch.cat([draft, draft.new_full((1,), -1)])
    window, wpos = state["window"], state["wpos"]
    alive = torch.ones((), dtype=torch.bool, device=seq.device)
    last, count = state["token"], torch.zeros_like(state["pos"])
    toks = []
    for i in range(D + 1):
        s = sample_chain(logits[i], window, state["gen"], st, top_k=top_k)
        emit = alive
        slot = torch.remainder(wpos, PENALTY_WINDOW).reshape(1)
        window = torch.where(emit, window.index_copy(0, slot, s.reshape(1)), window)
        wpos = wpos + emit.long()
        alive = alive & (s == dpad[i])
        last = torch.where(emit, s, last)
        count = count + emit.long()
        toks.append(s)
    state["window"].copy_(window)
    state["wpos"].copy_(wpos)
    state["token"].copy_(last)
    state["pos"].add_(count)
    return torch.stack(toks), count


def _take_steps(state: dict, n_steps: int) -> int:
    """Advance the host mirror by ``n_steps``; returns the first slot fed.
    The range check of the whole chunk happens here, on the host."""
    slot = state["slot"]
    n_ctx = state["out"].shape[0]
    if n_steps < 0 or slot + n_steps > n_ctx:
        raise ValueError(f"{n_steps} decode steps from slot {slot} do not fit the "
                         f"{n_ctx}-slot KV ring")
    state["slot"] = slot + n_steps
    return slot


@torch.inference_mode()
def generate_chunk(params, cfg: ModelConfig, state: dict, st: dict,
                   n_steps: int, top_k: int = 40) -> torch.Tensor:
    """``n_steps`` decode+sample steps, updating ``state`` in place.
    ``state["token"]`` is fed first.  Returns the sampled tokens (n_steps,)
    on the device — reading them is the chunk's host sync.

    A state of :class:`DecodeGraphs` (the card) replays its captured step;
    any other state runs the step eagerly, which only the CPU does."""
    graphs = state.get("graphs")
    if graphs is not None:
        return graphs.chunk(state, st, n_steps, top_k)
    if state["pos"].device.type != "cpu":
        raise ValueError("a decode chunk on the card is graph replays: take the "
                         "state from DecodeGraphs.state")
    slot = _take_steps(state, n_steps)
    for _ in range(n_steps):
        decode_step(params, cfg, state, st, top_k)
    return state["out"][slot:slot + n_steps]


def _check_verify(state: dict, D: int) -> None:
    """The host-side range check of a verify round: its D+1 slots from the
    host mirror must fit the ring."""
    n_ctx = state["out"].shape[0]
    if D < 1 or state["slot"] + D + 1 > n_ctx:
        raise ValueError(f"a {D}-token verify from slot {state['slot']} does not fit "
                         f"the {n_ctx}-slot KV ring")


@torch.inference_mode()
def verify_round(params, cfg: ModelConfig, state: dict, st: dict, draft: list,
                 top_k: int = 40) -> tuple[list, int]:
    """One verify round of ``draft`` (host ids) over ``state`` in place:
    :func:`spec_verify`, then its tokens and count read on the host (the
    round's sync) and the host mirror advanced by the count.  A state of
    :class:`DecodeGraphs` (the card) replays its captured verify step; any
    other runs it eagerly, which only the CPU does.  Returns ``(emitted
    tokens, count)``."""
    graphs = state.get("graphs")
    if graphs is not None:
        return graphs.verify(state, st, draft, top_k)
    if state["pos"].device.type != "cpu":
        raise ValueError("a verify round on the card is a graph replay: take the "
                         "state from DecodeGraphs.state")
    _check_verify(state, len(draft))
    toks, count = spec_verify(params, cfg, state, st,
                              torch.tensor(draft, dtype=torch.int64), top_k)
    n = int(count)
    state["slot"] += n
    return toks[:n].tolist(), n


#: graphs one engine keeps (one per ``top_k``); the first, the default's, is
#: never dropped
MAX_GRAPHS = 4


def _counters() -> dict:
    from ..ops import KERNELS

    return {name: fn.launches for name, fn in KERNELS.items()}


def capture_step(step, state: dict, gens, stream, pool) -> tuple:
    """Capture ``step()`` — one decode+sample step over ``state`` in place —
    as a CUDA graph on ``stream`` in the memory pool ``pool``.

    One eager step on the stream first (it builds the kernels and sizes the
    allocator), undone on the bookkeeping leaves and the generators
    ``gens``: the ring and ``out`` slots it writes are those the next
    replay writes with the same inputs.  ``gens`` are registered with the
    graph, so a replay draws what the eager step draws from the same seed.
    The kernels' launch counters keep counting on the device: the capture
    records each counter's increment and takes it back (capturing runs
    nothing).  Returns ``(graph, increments)``, ``increments`` the
    counters a replay adds (:func:`replay_step`)."""
    from ..ops import KERNELS

    saved = {k: state[k].clone() for k in ("pos", "token", "window", "wpos")}
    rngs = [g.get_state() for g in gens]
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        step()
    current.wait_stream(stream)
    for k, t in saved.items():
        state[k].copy_(t)
    for g, r in zip(gens, rngs):
        g.set_state(r)
    graph = torch.cuda.CUDAGraph()
    for g in gens:
        graph.register_generator_state(g)
    before = _counters()
    # thread_local: another engine's thread may use the card meanwhile
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        step()
    increments = {}
    for name, n in _counters().items():
        if n != before[name]:
            increments[name] = n - before[name]
            KERNELS[name].launches = before[name]
    current.synchronize()
    return graph, increments


def replay_step(graph, increments: dict, n_steps: int) -> None:
    """``n_steps`` replays of ``graph``, each kernel counter advanced by its
    ``increments`` (:func:`capture_step`) a replay."""
    from ..ops import KERNELS

    for _ in range(n_steps):
        graph.replay()
    for name, n in increments.items():
        KERNELS[name].launches += n * n_steps


class DecodeGraphs:
    """The decode step as CUDA graphs over one engine's KV ring.

    The state (:func:`init_state`'s keys over the engine's ``cache``) and
    the sampling knobs are allocated once; :meth:`state` and :meth:`knobs`
    refill them for each request with ``copy_``/``fill_``, so every
    captured step reads and writes the same addresses.  One graph per
    ``top_k`` (the candidates' static shape), captured by :meth:`capture` —
    the engine's warmup takes the default — or on first use; at most
    :data:`MAX_GRAPHS` are kept: beyond that the oldest but the first (the
    default's) is dropped.  All graphs share one memory pool: a step's intermediates
    die inside the step, and replays run one after another on one stream.

    The generator is registered with every graph and reseeded per request
    between replays, so a replay draws what the eager step draws from the
    same seed (Philox offsets advance alike).

    The kernels' launch counters (``ops.KERNELS``) keep counting launches
    on the device: a capture records each counter's increment and takes it
    back (capturing runs nothing), and every replay adds it.

    Each capture is one compile of the ``decode_chunk`` program on the
    compile registry (obs/devtime.py), signature ``top_k=<k>``, with its
    seconds; a re-capture after an eviction is one more.

    Under speculative decoding the verify step (:func:`spec_verify`, D+1
    rows) is captured beside the decode step over the same state, one graph
    per ``top_k`` (:meth:`capture_verify`, at most :data:`MAX_GRAPHS`),
    each a compile of ``spec_verify``: the draft, of the ``draft_len``
    fixed when the graphs are built, goes into a static (D,) buffer, the step writes its tokens and count into a static (D+2,) one,
    and :meth:`verify` reads that behind an event.

    There is no eager fallback: a failed capture or replay raises."""

    # -- buffers the graphs hold by address (lfkt-lint PIN001-002): the
    # state over the engine's ring, the sampling knobs, and the verify
    # step's static draft and output; refilled in place, never rebound
    _GRAPH_PINNED = ("_state", "_st", "_draft", "_vout")

    def __init__(self, params, cfg: ModelConfig, cache: dict, draft_len: int = 0,
                 program: str = "decode_chunk"):
        device = ring_device(cache)
        if device.type != "cuda":
            raise ValueError(f"DecodeGraphs: CUDA graphs need the card, the ring is on {device}")
        self.params, self.cfg, self.draft_len = params, cfg, draft_len
        #: the compile-registry program a capture is a compile of
        self.program = program
        self._state = init_state(cache, [], 0, device)
        self._state["graphs"] = self
        self.gen = self._state["gen"]
        #: the sampling knobs, the defaults until :meth:`knobs` refills them
        self._st = sampling_tensors(SamplingParams(), device)
        #: top_k → (graph, each counter's increment a replay)
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        #: top_k → seconds its capture took (warm-up step included)
        self.captures: dict = {}
        #: replays issued since the engine was built
        self.replays = 0
        #: the verify step's graphs (top_k → (graph, increments)), its
        #: static draft of ``draft_len`` tokens (0: no speculation), its
        #: output (tokens, then the count) and that output's pinned host copy
        self._verify: collections.OrderedDict = collections.OrderedDict()
        self._draft = self._vout = self._vhost = None
        if draft_len:
            self._draft = torch.zeros(draft_len, dtype=torch.int64, device=device)
            self._vout = torch.zeros(draft_len + 2, dtype=torch.int64, device=device)
            self._vhost = torch.empty(draft_len + 2, dtype=torch.int64, pin_memory=True)
        #: top_k → seconds the verify capture took
        self.verify_captures: dict = {}
        #: verify replays issued since the engine was built
        self.verify_replays = 0

    @property
    def keys(self) -> list:
        """The ``top_k`` values whose graphs are held, oldest first."""
        return list(self._graphs)

    @torch.inference_mode()
    def knobs(self, st: dict) -> dict:
        """The graphs' sampling knobs, refilled from ``st``
        (``sampling_tensors``)."""
        for k, v in st.items():
            self._st[k].copy_(v)
        return self._st

    @torch.inference_mode()
    def state(self, prompt_ids, seed: int) -> dict:
        """The graphs' state, refilled for a request over ``prompt_ids``
        whose ring the caller has prefilled; the generator reseeded."""
        s = self._state
        window, wpos = seed_window(prompt_ids, "cpu")
        n = len(prompt_ids)
        s["window"].copy_(window)
        s["wpos"].fill_(wpos)
        s["pos"].fill_(n)
        s["token"].zero_()
        s["slot"] = n
        self.gen.manual_seed(seed)
        return s

    @torch.inference_mode()
    def capture(self, top_k: int = SamplingParams.top_k) -> float:
        """Capture the step for ``top_k`` (:func:`capture_step`) if it is not
        held; returns the seconds taken (0 when held)."""
        if top_k in self._graphs:
            return 0.0
        t0 = time.time()
        self._graphs[top_k] = capture_step(
            lambda: decode_step(self.params, self.cfg, self._state, self._st, top_k),
            self._state, [self.gen], self._stream, self._pool)
        while len(self._graphs) > MAX_GRAPHS:
            oldest = list(self._graphs)[1]                 # keep the first (the default)
            del self._graphs[oldest]
        self.captures[top_k] = time.time() - t0
        record_compile(self.program, f"top_k={top_k}", self.captures[top_k])
        return self.captures[top_k]

    def step_launches(self, top_k: int) -> dict:
        """Each kernel counter's increment in one replay of ``top_k``'s graph."""
        return dict(self._graphs[top_k][1])

    def _verify_step(self, top_k: int) -> None:
        toks, count = spec_verify(self.params, self.cfg, self._state, self._st,
                                  self._draft, top_k)
        self._vout[:-1].copy_(toks)
        self._vout[-1].copy_(count)

    @torch.inference_mode()
    def capture_verify(self, top_k: int = SamplingParams.top_k) -> float:
        """Capture the verify step of the graphs' ``draft_len`` draft tokens
        for ``top_k`` if it is not held; returns the seconds taken (0 when
        held)."""
        if not self.draft_len:
            raise ValueError("DecodeGraphs: built without a draft length (draft_len=0)")
        if top_k in self._verify:
            return 0.0
        t0 = time.time()
        self._verify[top_k] = capture_step(lambda: self._verify_step(top_k), self._state,
                                           [self.gen], self._stream, self._pool)
        while len(self._verify) > MAX_GRAPHS:
            del self._verify[list(self._verify)[1]]
        self.verify_captures[top_k] = time.time() - t0
        record_compile("spec_verify", f"top_k={top_k}", self.verify_captures[top_k])
        return self.verify_captures[top_k]

    def verify_launches(self, top_k: int) -> dict:
        """Each kernel counter's increment in one replay of ``top_k``'s
        verify graph."""
        return dict(self._verify[top_k][1])

    def verify(self, state: dict, st: dict, draft: list, top_k: int) -> tuple[list, int]:
        """One replay of ``top_k``'s verify graph (captured now if it is not
        held) over ``draft``; returns the emitted tokens and their count,
        read behind an event, and advances the host mirror by the count."""
        if state is not self._state or st is not self._st:
            raise ValueError("DecodeGraphs.verify takes the graphs' own state and knobs")
        if len(draft) != self.draft_len:
            raise ValueError(f"DecodeGraphs: a draft of {len(draft)} tokens, the graphs "
                             f"take {self.draft_len}")
        _check_verify(state, len(draft))
        with torch.inference_mode():
            self.capture_verify(top_k)
            self._draft.copy_(torch.tensor(draft, dtype=torch.int64))
            replay_step(*self._verify[top_k], 1)
            self._vhost.copy_(self._vout, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        self.verify_replays += 1
        done.synchronize()
        vals = self._vhost.tolist()
        n = vals[-1]
        state["slot"] += n
        return vals[:n], n

    def chunk(self, state: dict, st: dict, n_steps: int, top_k: int) -> torch.Tensor:
        """``n_steps`` replays of ``top_k``'s graph (captured now if it is not
        held); returns the chunk's tokens, a view of ``out`` that no later
        replay of this request writes."""
        if state is not self._state or st is not self._st:
            raise ValueError("DecodeGraphs.chunk takes the graphs' own state and knobs "
                             "(DecodeGraphs.state, DecodeGraphs.knobs)")
        self.capture(top_k)
        slot = _take_steps(state, n_steps)
        replay_step(*self._graphs[top_k], n_steps)
        self.replays += n_steps
        return state["out"][slot:slot + n_steps]

    def close(self) -> None:
        """Release the graphs and their memory pool (after the card has run
        every replay queued)."""
        if self._graphs or self._verify:
            torch.cuda.current_stream(self.gen.device).synchronize()
        self._graphs.clear()
        self._verify.clear()
        self._pool = None

"""Lane programs: B sequences decoded together on one card.

The reference (llama_fastapi_k8s_gpu_tpu/parallel/batched.py) ``vmap``s
its single-sequence model over a batch axis and lays the batch on a mesh.
Here a lane batch is simply more rows for the linears; over a dp × tp
mesh (parallel/mesh.py) the lane ring is a ``ShardedRing`` — dp group
``d``'s lanes on its tp shards, kv heads split — and the lane step runs
each group's lanes on its shards (``models.llama.forward_lanes_mesh``),
while the lanes' bookkeeping stays on the mesh's first device:

- the state: a lane-major cache (``models.llama.init_lane_cache``, each
  leaf ``(B, L, n_kv, n_ctx, hd)``) and per-lane ``pos``, ``token``,
  ``window``, ``wpos`` and ``out`` ((B, n_ctx): ``out[b, p]`` is the token
  lane ``b`` sampled after feeding slot ``p``), one ``torch.Generator`` a
  lane and the host's mirror of every lane's slot (``slots``);
- :func:`batched_prefill`: the prompt pass of each lane, one after
  another, on the lane's own ring view (flash on the card);
- :func:`lane_step`: one decode+sample step for every lane, in place, with
  per-lane sampling knobs (each leaf a leading B dim) under one static
  ``top_k`` ceiling.  Every lane advances: a lane that holds no request
  keeps decoding into its own ring, its slot clamped on the device to
  ``n_ctx - 1``, so no write ever leaves the ring (the reference's scatter
  clamps alike);
- :func:`generate_chunk_lanes`: ``n_steps`` lane steps — on the card
  replays of one CUDA graph of the step (:class:`LaneGraphs`, captured as
  ``models.generate.DecodeGraphs`` captures), on the CPU the step run
  eagerly.  It
  returns a :class:`LaneChunk`, whose :meth:`LaneChunk.rows` reads the
  chunk's tokens;
- :func:`batched_spec_verify_perlane`: one speculative verify round of
  every lane (the continuous scheduler's spec rounds): lane ``b``'s draft
  verified by ``models.generate.spec_verify`` on the lane's own ring view,
  a D+1-row pass a lane — the reference's vmapped verify, lane by lane.
  On the card one replay of a second graph of :class:`LaneGraphs`.

The reference's shared-knob chunk and its per-lane-knob chunk are one
program here: shared knobs are per-lane knobs that hold the same values.
The chunk is the ``batched_decode_chunk`` program of the compile registry
for the cycle scheduler and ``lane_decode_chunk`` for the continuous one;
a graph capture is one compile of it, a chunk one dispatch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.generate import capture_step, replay_step, spec_verify
from ..models.llama import forward, forward_lanes, init_lane_cache, lane_view
from ..obs.devtime import ENTRY, record_compile, register_program
from .mesh import init_sharded_cache, ring_copy_, ring_tensors
from ..sampling.sample import PENALTY_WINDOW, SamplingParams, lane_tensors, sample_chain_lanes

for _name in ("batched_prefill", "batched_decode_chunk", "lane_decode_chunk",
              "lane_spec_verify", "mesh_batched_decode_chunk", "mesh_lane_decode_chunk"):
    register_program(_name, ENTRY, site="parallel.batched")
del _name

#: the lane state's device leaves besides the cache
STATE_LEAVES = ("pos", "token", "window", "wpos", "out")


def init_batched_state(cfg, batch: int, device, seed: int = 0, mesh=None,
                       tp_split: bool = True) -> dict:
    """A fresh lane state of ``batch`` lanes on ``device``: lane ``b``'s
    generator seeded with ``seed + b``.  Over a ``mesh`` the lane ring is
    sharded over its dp × tp devices (the reference's
    ``state_shardings(batched=True)``; kv heads split when ``tp_split``)."""
    device = torch.device(device)
    gens = []
    for b in range(batch):
        g = torch.Generator(device=device)
        g.manual_seed(seed + b)
        gens.append(g)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    cache = (init_lane_cache(cfg, batch, device) if mesh is None
             else init_sharded_cache(cfg, mesh, tp_split=tp_split, lanes=batch))
    return {"cache": cache, "pos": zeros(batch),
            "token": zeros(batch),
            "window": torch.full((batch, PENALTY_WINDOW), -1, dtype=torch.int64,
                                 device=device),
            "wpos": zeros(batch), "out": zeros(batch, cfg.n_ctx), "gens": gens,
            "slots": [0] * batch}


def state_nbytes(state: dict | None) -> int:
    """Device bytes of a lane state (its cache and bookkeeping): the
    memory ledger's ``kv_lanes`` row."""
    if state is None:
        return 0
    leaves = ring_tensors(state["cache"]) + [state[k] for k in STATE_LEAVES]
    return sum(t.numel() * t.element_size() for t in leaves)


@torch.inference_mode()
def batched_prefill(params, cfg, tokens: torch.Tensor, lengths, cache: dict) -> torch.Tensor:
    """``tokens`` (B, S) padded, ``lengths`` B host ints: each lane's prompt
    pass from slot 0 on its own ring view.  Returns the logits at each
    lane's last real token, (B, vocab) f32."""
    return torch.stack([forward(params, cfg, tokens[b], 0, lane_view(cache, b),
                                last_idx=int(lengths[b]) - 1)
                        for b in range(tokens.shape[0])])


@torch.inference_mode()
def lane_step(params, cfg, state: dict, st: dict, top_k: int = 40) -> torch.Tensor:
    """One decode+sample step of every lane, in place: feed ``token[b]`` at
    lane ``b``'s slot (``pos[b]`` clamped to the ring), sample into
    ``out[b, slot]``, the lane's penalty ring and ``token``, advance
    ``pos`` and ``wpos``.  Reads no device value on the host.  Returns the
    sampled tokens (B,)."""
    slots = state["pos"].clamp(max=cfg.n_ctx - 1)
    logits = forward_lanes(params, cfg, state["token"], slots, state["cache"])
    tok = sample_chain_lanes(logits, state["window"], state["gens"], st, top_k)
    lanes = torch.arange(tok.shape[0], device=tok.device)
    state["out"][lanes, slots] = tok
    state["pos"].add_(1)
    state["window"][lanes, torch.remainder(state["wpos"], PENALTY_WINDOW)] = tok
    state["wpos"].add_(1)
    state["token"].copy_(tok)
    return tok


@torch.inference_mode()
def batched_spec_verify_perlane(params, cfg, state: dict, st: dict, drafts: torch.Tensor,
                                top_k: int = 40) -> tuple[torch.Tensor, torch.Tensor]:
    """One verify round of every lane, in place: ``drafts`` (B, D) int64 on
    the device, one prompt-lookup draft a lane (zeros for a lane without
    one: it still advances by its one true sample).  Lane ``b`` runs
    ``spec_verify`` over its ring view, its ``pos``/``token``/``window``/
    ``wpos`` rows and its own generator, under its own knobs and the static
    ``top_k`` ceiling.  A lane that holds no request verifies too, its
    slots clamped to the ring's last (``models.llama.forward``).  Returns
    ``(tokens (B, D+1), counts (B,))``: lane ``b`` emits ``tokens[b,
    :counts[b]]``."""
    toks, counts = [], []
    for b in range(drafts.shape[0]):
        lane = {"cache": lane_view(state["cache"], b), "pos": state["pos"][b],
                "token": state["token"][b], "window": state["window"][b],
                "wpos": state["wpos"][b], "gen": state["gens"][b]}
        t, n = spec_verify(params, cfg, lane, {k: v[b] for k, v in st.items()},
                           drafts[b], top_k)
        toks.append(t)
        counts.append(n)
    return torch.stack(toks), torch.stack(counts)


class LaneVerify:
    """A queued lane verify round: ``read()`` waits for it and returns
    ``(tokens (B, D+1), counts (B,))`` as numpy.  On the card the round's
    output is copied into pinned host memory behind it and an event
    recorded after the copy."""

    def __init__(self, toks: torch.Tensor, counts: torch.Tensor):
        out = torch.cat([toks, counts[:, None]], dim=1)
        if out.device.type == "cuda":
            self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = out.clone(), None

    def read(self) -> tuple[np.ndarray, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out[:, :-1], out[:, -1]


@torch.inference_mode()
def lane_verify(params, cfg, state: dict, st: dict, drafts, top_k: int = 40) -> LaneVerify:
    """:func:`batched_spec_verify_perlane` over ``drafts`` (B, D) host ids:
    one replay of its :class:`LaneGraphs` verify graph on the card, eager on
    the CPU.  Returns the queued round; the caller advances the host
    mirrors of the lanes it serves once the counts are read."""
    graphs = state.get("graphs")
    if graphs is not None:
        return graphs.verify(state, st, drafts, top_k)
    if state["pos"].device.type != "cpu":
        raise ValueError("a lane verify on the card is a graph replay: take the state "
                         "from LaneGraphs.state")
    d = torch.as_tensor(np.asarray(drafts, dtype=np.int64))
    return LaneVerify(*batched_spec_verify_perlane(params, cfg, state, st, d, top_k))


class LaneChunk:
    """A queued chunk of lane steps: ``rows()`` waits for it and returns its
    tokens (n_steps, B) as numpy, row ``j`` lane ``b`` the token lane ``b``
    sampled at its ``j``-th step of the chunk.  On the card the state's
    ``out`` is copied into pinned host memory behind the chunk and an event
    recorded after the copy, so the read waits for this chunk alone."""

    def __init__(self, out: torch.Tensor, starts: list, n_steps: int):
        self.starts = list(starts)
        self.n_steps = n_steps
        if out.device.type == "cuda":
            self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = out.clone(), None

    def rows(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        n_ctx = out.shape[1]
        idx = np.minimum(np.asarray(self.starts)[:, None] + np.arange(self.n_steps)[None, :],
                         n_ctx - 1)
        return np.take_along_axis(out, idx, axis=1).T


def _advance(state: dict, n_steps: int) -> list:
    """Advance every lane's host mirror by ``n_steps``; returns the slots
    each lane feeds first (a lane past the ring keeps its clamped slot)."""
    starts = list(state["slots"])
    state["slots"] = [s + n_steps for s in starts]
    return starts


@torch.inference_mode()
def generate_chunk_lanes(params, cfg, state: dict, st: dict, n_steps: int,
                         top_k: int = 40) -> LaneChunk:
    """``n_steps`` lane steps over ``state`` in place: replays of its
    :class:`LaneGraphs` on the card, eager steps on the CPU."""
    if n_steps < 1:
        raise ValueError(f"a lane chunk takes at least one step, got {n_steps}")
    graphs = state.get("graphs")
    if graphs is not None:
        return graphs.chunk(state, st, n_steps, top_k)
    if state["pos"].device.type != "cpu":
        raise ValueError("a lane chunk on the card is graph replays: take the state "
                         "from LaneGraphs.state")
    starts = _advance(state, n_steps)
    for _ in range(n_steps):
        lane_step(params, cfg, state, st, top_k)
    return LaneChunk(state["out"], starts, n_steps)


class LaneGraphs:
    """The lane step as one CUDA graph over one engine's lane state.

    The state (:func:`init_batched_state`) and the per-lane knobs are
    allocated once, and every later change — an admission's lane write, a
    lane-prefix snapshot, new knobs — is an in-place copy into them between
    chunks, so every replay reads and writes the captured addresses.  The
    step is captured once, at the engine's static ``top_k`` ceiling (each
    lane's own ``top_k`` a mask below it), with the B generators registered
    and reseeded between replays (``models.generate.capture_step``).  Its
    replays run one after another on one stream: that single stream is
    what the looped kernel's per-device barrier and scratch require
    (ops/decode_loop.py).

    Kernel launch counters count on the device: every replay adds what the
    capture recorded.  The capture is one compile of ``program`` on the
    compile registry, signature ``top_k=<k>``.  There is no eager
    fallback."""

    # -- buffers the graph holds by address (lfkt-lint PIN001-002): the lane
    # state, the per-lane knobs, and the verify round's static drafts and
    # output; refilled in place, never rebound
    _GRAPH_PINNED = ("_state", "_st", "_drafts", "_vout")
    # the graphs and their memory pool: set by a capture and dropped by
    # close(), both on the owning engine's discipline (its lock, or its
    # scheduler thread) — single reference stores
    _SHARED_ATOMIC = ("_graph", "_verify", "_pool")

    def __init__(self, params, cfg, batch: int, device, top_k: int = 64,
                 program: str = "lane_decode_chunk", draft_len: int = 0, mesh=None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"LaneGraphs: CUDA graphs need the card, got {device}")
        self.params, self.cfg, self.top_k, self.program = params, cfg, top_k, program
        self.draft_len = draft_len
        with torch.inference_mode():
            self._state = init_batched_state(cfg, batch, device, mesh=mesh,
                                             tp_split=getattr(params, "tp_heads", True))
            self._st = lane_tensors([SamplingParams()] * batch, device)
        self._state["graphs"] = self
        self._graph = None              # (graph, each counter's increment a replay)
        #: the verify round's graph, its static drafts (B, D) of
        #: ``draft_len`` tokens a lane (0: no speculation) and output
        #: (B, D+2): each lane's tokens, then its count
        self._verify = None
        self._drafts = self._vout = None
        if draft_len:
            self._drafts = torch.zeros(batch, draft_len, dtype=torch.int64, device=device)
            self._vout = torch.zeros(batch, draft_len + 2, dtype=torch.int64, device=device)
        #: seconds the verify capture took, None before it
        self.verify_capture_s: float | None = None
        #: verify replays issued since the engine was built
        self.verify_replays = 0
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        #: seconds the capture took (warm-up step included), None before it
        self.capture_s: float | None = None
        #: replays issued since the engine was built
        self.replays = 0

    @property
    def state(self) -> dict:
        return self._state

    @property
    def knobs(self) -> dict:
        return self._st

    @torch.inference_mode()
    def capture(self) -> float:
        """Capture the lane step if it is not held; returns the seconds
        taken (0 when held)."""
        if self._graph is not None:
            return 0.0
        t0 = time.time()
        self._graph = capture_step(
            lambda: lane_step(self.params, self.cfg, self._state, self._st, self.top_k),
            self._state, self._state["gens"], self._stream, self._pool)
        self.capture_s = time.time() - t0
        record_compile(self.program, f"top_k={self.top_k}", self.capture_s)
        return self.capture_s

    def step_launches(self) -> dict:
        """Each kernel counter's increment in one replay."""
        return dict(self._graph[1])

    def _verify_step(self) -> None:
        toks, counts = batched_spec_verify_perlane(self.params, self.cfg, self._state,
                                                   self._st, self._drafts, self.top_k)
        self._vout[:, :-1].copy_(toks)
        self._vout[:, -1].copy_(counts)

    @torch.inference_mode()
    def capture_verify(self) -> float:
        """Capture the lane verify round of the graphs' ``draft_len`` draft
        tokens a lane if it is not held; returns the seconds taken (0 when
        held).  One compile of ``lane_spec_verify``."""
        if not self.draft_len:
            raise ValueError("LaneGraphs: built without a draft length (draft_len=0)")
        if self._verify is not None:
            return 0.0
        t0 = time.time()
        self._verify = capture_step(self._verify_step, self._state, self._state["gens"],
                                    self._stream, self._pool)
        self.verify_capture_s = time.time() - t0
        record_compile("lane_spec_verify", f"top_k={self.top_k}", self.verify_capture_s)
        return self.verify_capture_s

    def verify_launches(self) -> dict:
        """Each kernel counter's increment in one replay of the verify graph."""
        return dict(self._verify[1])

    def verify(self, state: dict, st: dict, drafts, top_k: int) -> LaneVerify:
        """One replay of the verify graph over ``drafts`` (B, D) host ids."""
        if state is not self._state or st is not self._st:
            raise ValueError("LaneGraphs.verify takes the graphs' own state and knobs")
        if top_k != self.top_k:
            raise ValueError(f"the lane graph samples under top_k ceiling {self.top_k}, "
                             f"asked for {top_k}")
        d = torch.as_tensor(np.asarray(drafts, dtype=np.int64))
        if d.shape[1] != self.draft_len:
            raise ValueError(f"LaneGraphs: drafts of {d.shape[1]} tokens, the graph "
                             f"takes {self.draft_len}")
        self.capture_verify()
        self._drafts.copy_(d)
        replay_step(*self._verify, 1)
        self.verify_replays += 1
        return LaneVerify(self._vout[:, :-1], self._vout[:, -1])

    def chunk(self, state: dict, st: dict, n_steps: int, top_k: int) -> LaneChunk:
        """``n_steps`` replays of the lane step (captured now if not held)."""
        if state is not self._state or st is not self._st:
            raise ValueError("LaneGraphs.chunk takes the graphs' own state and knobs")
        if top_k != self.top_k:
            raise ValueError(f"the lane graph samples under top_k ceiling {self.top_k}, "
                             f"asked for {top_k}")
        self.capture()
        starts = _advance(state, n_steps)
        replay_step(*self._graph, n_steps)
        self.replays += n_steps
        return LaneChunk(state["out"], starts, n_steps)

    def close(self) -> None:
        """Release the graph and its memory pool."""
        if self._graph is not None or self._verify is not None:
            torch.cuda.current_stream(self._stream.device).synchronize()
        self._graph = None
        self._verify = None
        self._pool = None


@torch.inference_mode()
def write_lane(state: dict, lane: int, cache1: dict, pos: int, token: torch.Tensor,
               wpos: int) -> None:
    """Install a prefilled sequence into lane ``lane`` in place: its ring
    copied from ``cache1`` (a serial ring, not consumed), ``pos`` and the
    host mirror at ``pos``, the first sampled ``token`` and ``wpos``.  The
    lane's penalty ring, knobs and generator are the caller's to set."""
    ring_copy_(lane_view(state["cache"], lane), cache1)
    state["pos"][lane].fill_(pos)
    state["token"][lane].copy_(token)
    state["wpos"][lane].fill_(wpos)
    state["slots"][lane] = pos


@torch.inference_mode()
def lane_cache_copy(cache: dict, lane: int, out: dict) -> dict:
    """Snapshot lane ``lane``'s ring into the serial-shaped ``out`` in place
    (lane-prefix reuse: the copy is the next admission's prefill scratch)."""
    ring_copy_(out, lane_view(cache, lane))
    return out

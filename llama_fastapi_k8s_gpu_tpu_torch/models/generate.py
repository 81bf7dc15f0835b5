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
import time

import torch

from ..obs.devtime import ENTRY, record_compile, register_program
from ..sampling.sample import PENALTY_WINDOW, SamplingParams, sample_chain, seed_window
from . import llama
from .config import ModelConfig
from .llama import forward


# the host programs of the compile registry: the engine counts a call of
# each as a dispatch (a decode chunk is one, whatever its replays)
for _name in ("prefill", "prefill_chunk", "first_sample", "decode_chunk"):
    register_program(_name, ENTRY, site="models.generate")
del _name


def init_state(cache: dict, prompt_ids, seed: int,
               device: torch.device) -> dict:
    """Fresh generation state over ``cache`` for a prompt of ``prompt_ids``."""
    window, wpos = seed_window(prompt_ids, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = len(prompt_ids)
    n_ctx = next(iter(cache.values())).shape[2]

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


#: graphs one engine keeps (one per ``top_k``); the first, the default's, is
#: never dropped
MAX_GRAPHS = 4


def _counters() -> dict:
    from ..ops import KERNELS

    return {name: fn.launches for name, fn in KERNELS.items()}


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

    There is no eager fallback: a failed capture or replay raises."""

    def __init__(self, params, cfg: ModelConfig, cache: dict):
        device = next(iter(cache.values())).device
        if device.type != "cuda":
            raise ValueError(f"DecodeGraphs: CUDA graphs need the card, the ring is on {device}")
        self.params, self.cfg = params, cfg
        self._state = init_state(cache, [], 0, device)
        self._state["graphs"] = self
        self.gen = self._state["gen"]
        self._st = None
        #: top_k → (graph, each counter's increment a replay)
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        #: top_k → seconds its capture took (warm-up step included)
        self.captures: dict = {}
        #: replays issued since the engine was built
        self.replays = 0

    @property
    def keys(self) -> list:
        """The ``top_k`` values whose graphs are held, oldest first."""
        return list(self._graphs)

    @torch.inference_mode()
    def knobs(self, st: dict) -> dict:
        """The graphs' sampling knobs, refilled from ``st``
        (``sampling_tensors``)."""
        if self._st is None:
            self._st = {k: v.clone() for k, v in st.items()}
        else:
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
        """Capture the step for ``top_k`` if it is not held; returns the
        seconds taken (0 when held).  One eager step on the capture stream
        first (it builds the kernels and sizes the allocator), undone on the
        state and the generator: the ring slot it writes is the one the next
        replay writes with the same inputs."""
        if top_k in self._graphs:
            return 0.0
        if self._st is None:
            from ..sampling.sample import sampling_tensors

            self.knobs(sampling_tensors(SamplingParams(), self.gen.device))
        t0 = time.time()
        s = self._state
        saved = {k: s[k].clone() for k in ("pos", "token", "window", "wpos")}
        rng = self.gen.get_state()
        current = torch.cuda.current_stream(self.gen.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            decode_step(self.params, self.cfg, s, self._st, top_k)
        current.wait_stream(self._stream)
        for k, t in saved.items():
            s[k].copy_(t)
        self.gen.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        before = _counters()
        # thread_local: another engine's thread may use the card meanwhile
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            decode_step(self.params, self.cfg, s, self._st, top_k)
        from ..ops import KERNELS

        step = {}
        for name, n in _counters().items():
            if n != before[name]:
                step[name] = n - before[name]
                KERNELS[name].launches = before[name]    # the capture ran nothing
        self._graphs[top_k] = (graph, step)
        while len(self._graphs) > MAX_GRAPHS:
            oldest = list(self._graphs)[1]                 # keep the first (the default)
            del self._graphs[oldest]
        torch.cuda.current_stream(self.gen.device).synchronize()
        self.captures[top_k] = time.time() - t0
        record_compile("decode_chunk", f"top_k={top_k}", self.captures[top_k])
        return self.captures[top_k]

    def step_launches(self, top_k: int) -> dict:
        """Each kernel counter's increment in one replay of ``top_k``'s graph."""
        return dict(self._graphs[top_k][1])

    def chunk(self, state: dict, st: dict, n_steps: int, top_k: int) -> torch.Tensor:
        """``n_steps`` replays of ``top_k``'s graph (captured now if it is not
        held); returns the chunk's tokens, a view of ``out`` that no later
        replay of this request writes."""
        if state is not self._state or st is not self._st:
            raise ValueError("DecodeGraphs.chunk takes the graphs' own state and knobs "
                             "(DecodeGraphs.state, DecodeGraphs.knobs)")
        self.capture(top_k)
        graph, step = self._graphs[top_k]
        slot = _take_steps(state, n_steps)
        for _ in range(n_steps):
            graph.replay()
        from ..ops import KERNELS

        for name, n in step.items():
            KERNELS[name].launches += n * n_steps
        self.replays += n_steps
        return state["out"][slot:slot + n_steps]

    def close(self) -> None:
        """Release the graphs and their memory pool (after the card has run
        every replay queued)."""
        if self._graphs:
            torch.cuda.current_stream(self.gen.device).synchronize()
        self._graphs.clear()
        self._pool = None

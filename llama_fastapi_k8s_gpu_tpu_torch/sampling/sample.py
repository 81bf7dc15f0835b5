"""llama.cpp-parity sampling chain on the device, in PyTorch.

The same chain and order as the JAX reference (llama_fastapi_k8s_gpu_tpu/
sampling/sample.py), which follows llama-cpp-python 0.2.77's defaults:

1. repetition + frequency/presence penalties over a 64-token ring buffer
   (prompt tail included, as llama.cpp seeds last_tokens with the prompt);
2. top-k (k=40 ceiling, per-request k masks down);
3. softmax over the k candidates, top-p on those *untempered*
   probabilities;
4. min-p relative to the max candidate probability;
5. temperature, then a categorical draw from a ``torch.Generator`` — or
   argmax when temperature ≤ 0.

Every step is a tensor op that reads no device value on the host, so a
decode step samples without a host sync and can be captured in a CUDA
graph (models/generate.py): the draw is ``argmax(p / e)`` over
exponential noise ``e`` from the generator — what ``torch.multinomial``
does for one sample, without its host-side checks of ``p``.  The draws
come from PyTorch's generator, not JAX's, so sampled tokens differ from
the reference's; the filtered distribution does not.

The lane form (:func:`sample_chain_lanes`, for the batched engines) runs
the same chain over B rows of logits with per-lane knobs (each leaf a
leading B dim) under one static ``top_k`` ceiling, the per-lane ``top_k``
a mask below it, as the reference's continuous scheduler does.  Row ``b``
equals the one-sequence chain on lane ``b``'s inputs, and each lane draws
its noise from its own generator, so a seeded request's tokens do not
depend on its lane or its neighbours.
"""

from __future__ import annotations

import dataclasses

import torch

PENALTY_WINDOW = 64  # llama.cpp repeat_last_n default


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.2
    top_p: float = 0.9
    top_k: int = 40                  # the candidate ceiling of sample_chain
    min_p: float = 0.05
    frequency_penalty: float = 0.7
    presence_penalty: float = 0.8
    repeat_penalty: float = 1.1


def sampling_tensors(sp: SamplingParams, device: torch.device) -> dict:
    """The per-request knobs as 0-d device tensors (f32, ``top_k`` int64;
    k ≤ 0 disables the truncation, as in llama.cpp)."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return {
        "temperature": f32(sp.temperature),
        "top_p": f32(sp.top_p),
        "top_k": torch.tensor(sp.top_k if sp.top_k > 0 else 1 << 30,
                              dtype=torch.int64, device=device),
        "min_p": f32(sp.min_p),
        "frequency_penalty": f32(sp.frequency_penalty),
        "presence_penalty": f32(sp.presence_penalty),
        "repeat_penalty": f32(sp.repeat_penalty),
    }


def lane_tensors(sps, device: torch.device) -> dict:
    """The knobs of B lanes, one :class:`SamplingParams` each, as (B,)
    device tensors: the leaves of :func:`sampling_tensors` stacked."""
    per = [sampling_tensors(sp, "cpu") for sp in sps]
    return {k: torch.stack([t[k] for t in per]).to(device) for k in per[0]}


def apply_penalties(logits: torch.Tensor, window: torch.Tensor,
                    st: dict) -> torch.Tensor:
    """window: (PENALTY_WINDOW,) int64, -1 = empty slot."""
    vocab = logits.shape[0]
    valid = window >= 0
    idx = window.clamp(0, vocab - 1)
    counts = torch.zeros(vocab, dtype=torch.float32, device=logits.device
                         ).index_add_(0, idx, valid.float())
    present = counts > 0
    rp = st["repeat_penalty"]
    logits = torch.where(present,
                         torch.where(logits > 0, logits / rp, logits * rp),
                         logits)
    return (logits - counts * st["frequency_penalty"]
            - present.float() * st["presence_penalty"])


def candidates(logits: torch.Tensor, window: torch.Tensor, st: dict,
               top_k: int = 40) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-4: (candidate ids (top_k,), their filtered logits (top_k,)
    with dropped candidates at -inf), sorted by logit, best first."""
    logits = apply_penalties(logits.float(), window, st)
    # a stable sort, not topk: logits out of a bf16 head tie often, and the
    # reference's top_k ranks equal values by the lower token id
    vals, idx = torch.sort(logits, descending=True, stable=True)
    vals, idx = vals[:top_k], idx[:top_k]
    vals = torch.where(torch.arange(top_k, device=logits.device) < st["top_k"],
                       vals, float("-inf"))
    probs = torch.softmax(vals, dim=-1)                 # untempered
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep = cum_excl < st["top_p"]                       # keeps the crossing token
    keep &= probs >= st["min_p"] * probs[0]
    keep[0].fill_(True)                                 # min_keep = 1
    return idx, torch.where(keep, vals, float("-inf"))


def sample_chain(logits: torch.Tensor, window: torch.Tensor,
                 gen: torch.Generator, st: dict,
                 top_k: int = 40) -> torch.Tensor:
    """One sampled token id (0-d int64 tensor on the logits' device)."""
    idx, masked = candidates(logits, window, st, top_k)
    temp = st["temperature"]
    probs = torch.softmax(masked / torch.clamp(temp, min=1e-6), dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=gen)
    sampled = torch.argmax(probs / noise, dim=-1, keepdim=True)
    choice = torch.where(temp <= 0, torch.zeros_like(sampled), sampled)
    return idx.index_select(0, choice)[0]


def apply_penalties_lanes(logits: torch.Tensor, windows: torch.Tensor,
                          st: dict) -> torch.Tensor:
    """:func:`apply_penalties` over B rows: logits (B, V) f32, windows (B,
    PENALTY_WINDOW), knobs (B,)."""
    B, vocab = logits.shape
    valid = windows >= 0
    idx = windows.clamp(0, vocab - 1)
    counts = torch.zeros(B, vocab, dtype=torch.float32, device=logits.device
                         ).scatter_add_(1, idx, valid.float())
    present = counts > 0
    rp = st["repeat_penalty"][:, None]
    logits = torch.where(present,
                         torch.where(logits > 0, logits / rp, logits * rp),
                         logits)
    return (logits - counts * st["frequency_penalty"][:, None]
            - present.float() * st["presence_penalty"][:, None])


def candidates_lanes(logits: torch.Tensor, windows: torch.Tensor, st: dict,
                     top_k: int = 40) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`candidates` over B rows: (ids (B, top_k), filtered logits (B,
    top_k)); lane ``b``'s own ``top_k`` masks below the static ceiling."""
    logits = apply_penalties_lanes(logits.float(), windows, st)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    vals = torch.where(torch.arange(top_k, device=logits.device)[None, :]
                       < st["top_k"][:, None], vals, float("-inf"))
    probs = torch.softmax(vals, dim=-1)                 # untempered
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep = cum_excl < st["top_p"][:, None]              # keeps the crossing token
    keep &= probs >= st["min_p"][:, None] * probs[:, :1]
    keep[:, 0].fill_(True)                              # min_keep = 1
    return idx, torch.where(keep, vals, float("-inf"))


def sample_chain_lanes(logits: torch.Tensor, windows: torch.Tensor, gens, st: dict,
                       top_k: int = 40) -> torch.Tensor:
    """One sampled token id a lane, (B,) int64: :func:`sample_chain` row by
    row, lane ``b``'s noise drawn from ``gens[b]``."""
    idx, masked = candidates_lanes(logits, windows, st, top_k)
    temp = st["temperature"][:, None]
    probs = torch.softmax(masked / torch.clamp(temp, min=1e-6), dim=-1)
    noise = torch.stack([torch.empty(top_k, dtype=probs.dtype, device=probs.device)
                         .exponential_(1, generator=g) for g in gens])
    sampled = torch.argmax(probs / noise, dim=-1, keepdim=True)
    choice = torch.where(temp <= 0, torch.zeros_like(sampled), sampled)
    return idx.gather(1, choice)[:, 0]


def seed_window(prompt_ids, device: torch.device) -> tuple[torch.Tensor, int]:
    """Ring buffer seeded with the prompt tail, as llama.cpp seeds
    last_tokens; returns (window, next write position)."""
    window = [-1] * PENALTY_WINDOW
    tail = list(prompt_ids)[-PENALTY_WINDOW:]
    for j, t in enumerate(tail):
        window[j % PENALTY_WINDOW] = t
    wpos = 0 if len(tail) == PENALTY_WINDOW else len(tail)
    return torch.tensor(window, dtype=torch.int64, device=device), wpos

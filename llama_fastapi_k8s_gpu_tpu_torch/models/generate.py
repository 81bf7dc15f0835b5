"""Autoregressive generation: prompt passes, first sample, decode chunks.

The reference runs a decode chunk as one jitted ``lax.scan`` over a
donated state (llama_fastapi_k8s_gpu_tpu/models/generate.py).  Here the
chunk is a Python loop of eager device calls over a state that is updated
**in place** — the KV ring, the token to feed next and the penalty
window are the same tensors before and after — so steady-state decode
allocates no new cache.  Sampling stays on the device; the host sees the
chunk's tokens once, when it reads them.

State keys: ``cache`` (the KV ring dict), ``pos`` (next cache slot, a
host int), ``token`` (0-d device tensor: the last sampled, not yet fed
token), ``window`` (penalty ring, device), ``wpos`` (host int) and ``gen``
(the request's ``torch.Generator``).
"""

from __future__ import annotations

import torch

from ..sampling.sample import PENALTY_WINDOW, sample_chain, seed_window
from . import llama
from .config import ModelConfig
from .llama import forward


def init_state(cache: dict, prompt_ids, seed: int,
               device: torch.device) -> dict:
    """Fresh generation state over ``cache`` for a prompt of ``prompt_ids``."""
    window, wpos = seed_window(prompt_ids, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"cache": cache, "pos": len(prompt_ids),
            "token": torch.zeros((), dtype=torch.int64, device=device),
            "window": window, "wpos": wpos, "gen": gen}


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
    state["window"][state["wpos"] % PENALTY_WINDOW] = token
    state["wpos"] += 1
    state["token"] = token


@torch.inference_mode()
def first_sample(logits: torch.Tensor, state: dict, st: dict,
                 top_k: int = 40) -> torch.Tensor:
    """Sample the first token from the prompt's logits into ``state``."""
    token = sample_chain(logits, state["window"], state["gen"], st, top_k=top_k)
    _push(state, token)
    return token


@torch.inference_mode()
def generate_chunk(params, cfg: ModelConfig, state: dict, st: dict,
                   n_steps: int, top_k: int = 40) -> torch.Tensor:
    """``n_steps`` decode+sample steps, updating ``state`` in place.
    ``state["token"]`` is fed first.  Returns the sampled tokens
    (n_steps,) on the device — reading them is the chunk's host sync."""
    out = []
    for _ in range(n_steps):
        logits = forward(params, cfg, state["token"].reshape(1), state["pos"],
                         state["cache"])
        state["pos"] += 1
        token = sample_chain(logits, state["window"], state["gen"], st,
                             top_k=top_k)
        _push(state, token)
        out.append(token)
    return torch.stack(out)

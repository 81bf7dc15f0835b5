"""Ring attention: sequence parallelism over the ``sp`` mesh axis.

The port of the JAX package's ``parallel/ring.py``.  The KV ring's slots
shard over ``sp``: shard ``s`` holds slots ``[s·C, (s+1)·C)``, C = n_ctx /
sp, so no device holds more than 1/sp of the KV and the longest context
grows with the ring.  Heads stay sharded over ``tp`` inside the ring.
There is no Pallas kernel behind it in the JAX package, and none here:
each shard runs plain torch, and the collectives are the mesh's
(parallel/mesh.py).

- :func:`ring_attention_shards` — the prompt pass: query block ``s`` (its
  S/sp rows) against every KV chunk in turn, ``sp`` steps of online
  softmax, the chunks passed one device on around the ring (the JAX
  ``ppermute``) after each step;
- :func:`sharded_decode_attention_shards` — decode: the query, replicated
  over sp, against each shard's chunk, the partial softmaxes combined
  with a global log-sum-exp (``pmax``, then ``psum``).

Both score a chunk through :func:`_masked_chunk_scores`, so their masks
cannot drift apart; a masked score is :data:`DEFAULT_MASK_VALUE`, as in
the reference, so a chunk with no visible key adds nothing once the
running maximum meets a visible one.

:func:`ring_attention` and :func:`sharded_decode_attention` take whole
tensors and a mesh, shard them, and put the result back together (the
reference's signatures with the mesh explicit: there is no trace-time
context here).  The model integration is ``attn_impl="ring"``
(``models/llama.py``); :func:`sp_prefill`, :func:`sp_decode_step` and
:func:`sp_generate_chunk` are the engine's entry points over a ring from
:func:`sp_state_shardings`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..obs.devtime import ENTRY, register_program
from ..ops.attention import DEFAULT_MASK_VALUE
from .mesh import Mesh, ShardedRing, all_max, all_sum, init_sharded_cache, ring_pass

for _name in ("sp_prefill", "sp_decode_chunk"):
    register_program(_name, ENTRY, site="parallel.ring")
del _name


def _group_queries(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(S, H, hd) → (n_kv, group, S, hd) grouped-query layout."""
    S, H, hd = q.shape
    return q.reshape(S, n_kv, H // n_kv, hd).permute(1, 2, 0, 3)


def _masked_chunk_scores(qg: torch.Tensor, k_chunk: torch.Tensor, q_pos: torch.Tensor,
                         key_offset, sm_scale: float, sliding_window: int) -> torch.Tensor:
    """Scores (n_kv, group, S, C) f32 of grouped queries ``qg`` against one
    head-major chunk ``k_chunk`` (n_kv, C, hd) whose slots start at global
    position ``key_offset`` (a host int or a 0-d tensor); causal (and
    sliding-window) masked to :data:`DEFAULT_MASK_VALUE`.  ``q_pos`` (S, 1)."""
    C = k_chunk.shape[1]
    scores = torch.matmul(qg.float(), k_chunk[:, None].float().transpose(-1, -2)) * sm_scale
    key_pos = (key_offset + torch.arange(C, device=qg.device))[None, :]
    mask = key_pos <= q_pos
    if sliding_window:
        mask &= key_pos > q_pos - sliding_window
    return scores.masked_fill(~mask[None, None], DEFAULT_MASK_VALUE)


def _at(pos_offset, dev):
    """``pos_offset`` on ``dev`` (a host int as it is)."""
    return pos_offset.to(dev) if isinstance(pos_offset, torch.Tensor) else pos_offset


def _pv(p: torch.Tensor, v_chunk: torch.Tensor) -> torch.Tensor:
    """P·V with P rounded to V's dtype first, accumulated in f32."""
    return torch.matmul(p.to(v_chunk.dtype).float(), v_chunk[:, None].float())


def ring_attention_shards(q: list, k: list, v: list, pos_offset, sm_scale: float,
                          sliding_window: int, devices: list) -> list:
    """One tp index's ring: ``q[s]`` (S_loc, H, hd) the queries of row block
    ``s`` (global rows s·S_loc …), ``k[s]``/``v[s]`` (n_kv, C, hd) the chunk
    shard ``s`` holds (slots s·C …), on ``devices[s]``.  ``pos_offset``: the
    ring slot of global row 0.  Returns each block's context (S_loc, H, hd)
    in q's dtype."""
    n = len(q)
    S_loc, H, hd = q[0].shape
    n_kv, C, _ = k[0].shape
    group = H // n_kv
    qg = [_group_queries(x, n_kv) for x in q]
    q_pos = [(_at(pos_offset, devices[s]) + s * S_loc + torch.arange(S_loc, device=devices[s]))[:, None]
             for s in range(n)]
    m = [torch.full((n_kv, group, S_loc, 1), float("-inf"), device=d) for d in devices]
    l = [torch.zeros((n_kv, group, S_loc, 1), device=d) for d in devices]
    acc = [torch.zeros((n_kv, group, S_loc, hd), device=d) for d in devices]
    k_cur, v_cur = list(k), list(v)
    for i in range(n):
        for s in range(n):
            src = (s - i) % n                                   # the chunk's owner
            scores = _masked_chunk_scores(qg[s], k_cur[s], q_pos[s], src * C, sm_scale,
                                          sliding_window)
            m_new = torch.maximum(m[s], scores.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m[s] - m_new)
            p = torch.exp(scores - m_new)
            l[s] = alpha * l[s] + p.sum(dim=-1, keepdim=True)
            acc[s] = acc[s] * alpha + _pv(p, v_cur[s])
            m[s] = m_new
        if i + 1 < n:
            k_cur, v_cur = ring_pass(k_cur, devices), ring_pass(v_cur, devices)
    out = []
    for s in range(n):
        ls = torch.where(l[s] == 0.0, torch.ones_like(l[s]), l[s])
        o = (acc[s] / ls).to(q[s].dtype)                         # (n_kv, g, S_loc, hd)
        out.append(o.permute(2, 0, 1, 3).reshape(S_loc, H, hd))
    return out


def sharded_decode_attention_shards(q: list, k: list, v: list, pos_offset,
                                    sm_scale: float, sliding_window: int,
                                    devices: list) -> list:
    """One tp index's decode: ``q[s]`` (S, H, hd) the same queries on every
    shard, ``k[s]``/``v[s]`` (n_kv, C, hd) shard ``s``'s chunk.  Each shard
    scores its chunk, and the partial softmaxes meet through a global
    log-sum-exp (``pmax`` of the maxima, ``psum`` of the rescaled sums).
    Returns the context (S, H, hd) on every shard."""
    S, H, hd = q[0].shape
    n_kv, C, _ = k[0].shape
    m_loc, l_loc, acc = [], [], []
    for s, dev in enumerate(devices):
        qg = _group_queries(q[s], n_kv)
        q_pos = (_at(pos_offset, dev) + torch.arange(S, device=dev))[:, None]
        scores = _masked_chunk_scores(qg, k[s], q_pos, s * C, sm_scale, sliding_window)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        m_loc.append(m)
        l_loc.append(p.sum(dim=-1, keepdim=True))
        acc.append(_pv(p, v[s]))
    m_glb = all_max(m_loc, devices)
    corr = [torch.exp(m_loc[s] - m_glb[s]) for s in range(len(devices))]
    l_glb = all_sum([l_loc[s] * corr[s] for s in range(len(devices))], devices)
    a_glb = all_sum([acc[s] * corr[s] for s in range(len(devices))], devices)
    out = []
    for s in range(len(devices)):
        ls = torch.where(l_glb[s] == 0.0, torch.ones_like(l_glb[s]), l_glb[s])
        o = (a_glb[s] / ls).to(q[s].dtype)
        out.append(o.permute(2, 0, 1, 3).reshape(S, H, hd))
    return out


def _shard_qkv(q, k, v, mesh: Mesh, seq_q: bool):
    """Whole q (S, H, hd) and k/v (n_kv, n_ctx, hd) → per (t, s) shards:
    heads over tp, slots over sp, q's rows over sp when ``seq_q``."""
    tp, sp = mesh.shape["tp"], mesh.shape["sp"]
    qh = torch.chunk(q, tp, dim=1)
    kh, vh = torch.chunk(k, tp, dim=0), torch.chunk(v, tp, dim=0)
    out = []
    for t in range(tp):
        devs = [mesh.device(0, t, s) for s in range(sp)]
        qs = torch.chunk(qh[t], sp, dim=0) if seq_q else [qh[t]] * sp
        out.append((devs, [x.to(d) for x, d in zip(qs, devs)],
                    [x.to(d) for x, d in zip(torch.chunk(kh[t], sp, dim=1), devs)],
                    [x.to(d) for x, d in zip(torch.chunk(vh[t], sp, dim=1), devs)]))
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_offset,
                   sm_scale: float, sliding_window: int = 0, *, mesh: Mesh) -> torch.Tensor:
    """q (S, H, hd), S % sp == 0, over the whole head-major ring k/v
    (n_kv, n_ctx, hd): the rows and slots sharded over ``mesh``'s sp axis,
    heads over its tp axis, :func:`ring_attention_shards` per tp index.
    Returns (S, H, hd) on q's device."""
    outs = []
    for devs, qs, ks, vs in _shard_qkv(q, k, v, mesh, seq_q=True):
        parts = ring_attention_shards(qs, ks, vs, pos_offset, sm_scale, sliding_window, devs)
        outs.append(torch.cat([p.to(q.device) for p in parts], dim=0))
    return torch.cat(outs, dim=1)


def sharded_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos_offset,
                             sm_scale: float, sliding_window: int = 0, *,
                             mesh: Mesh) -> torch.Tensor:
    """q (S, H, hd) replicated over sp against the slot-sharded ring k/v
    (n_kv, n_ctx, hd): :func:`sharded_decode_attention_shards` per tp
    index.  Returns (S, H, hd) on q's device."""
    outs = []
    for devs, qs, ks, vs in _shard_qkv(q, k, v, mesh, seq_q=False):
        parts = sharded_decode_attention_shards(qs, ks, vs, pos_offset, sm_scale,
                                                sliding_window, devs)
        outs.append(parts[0].to(q.device))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# model-level entry points
# ---------------------------------------------------------------------------

def sp_state_shardings(cfg: ModelConfig, mesh: Mesh, tp_split: bool = True) -> ShardedRing:
    """A fresh ring (L, n_kv, n_ctx, hd) laid over ``mesh``: slots over sp,
    kv heads over tp (``tp_split``), the int8 scale planes alike.  The
    reference returns the shardings and ``device_put`` s the ring; here the
    sharded ring itself."""
    return init_sharded_cache(cfg, mesh, tp_split=tp_split)


def _ring_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg if cfg.attn_impl == "ring" else dataclasses.replace(cfg, attn_impl="ring")


@torch.inference_mode()
def sp_prefill(params, cfg: ModelConfig, tokens: torch.Tensor, length: int,
               cache: ShardedRing) -> torch.Tensor:
    """Sequence-parallel prompt pass from slot 0: ``tokens`` (S,), S % sp
    == 0, ``length`` real, over a ring from :func:`sp_state_shardings`
    (written in place).  Every per-token op runs on its row block; the
    attention runs the ring.  Returns the logits at the last real token."""
    from ..models.llama import forward

    return forward(params, _ring_cfg(cfg), tokens, 0, cache, last_idx=length - 1)


@torch.inference_mode()
def sp_decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos,
                   cache: ShardedRing) -> torch.Tensor:
    """One decode step against the slot-sharded ring (sharded log-sum-exp
    attention), the ring written in place.  Returns the logits."""
    from ..models.llama import forward

    return forward(params, _ring_cfg(cfg), token.reshape(1), pos, cache)


def sp_generate_chunk(params, cfg: ModelConfig, state: dict, st: dict, n_steps: int,
                      top_k: int = 40) -> torch.Tensor:
    """``n_steps`` decode+sample steps against the slot-sharded ring: the
    sequence-parallel engine's decode loop (``models.generate.
    generate_chunk`` over a state whose ``cache`` is the sharded ring; on
    the card replays of its graph).  Returns the tokens (n_steps,)."""
    from ..models.generate import generate_chunk

    return generate_chunk(params, _ring_cfg(cfg), state, st, n_steps, top_k=top_k)

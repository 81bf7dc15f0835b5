"""Llama-family transformer in PyTorch: the per-layer path.

The same graph as the JAX reference (llama_fastapi_k8s_gpu_tpu/models/
llama.py): RMSNorm → GQA attention with interleaved RoPE → SwiGLU, over a
preallocated KV ring laid out head-major, ``(L, n_kv, n_ctx, hd)`` bf16 —
or, under ``cfg.kv_dtype == "int8"``, int8 values with per-head, per-token
f32 scales (ops/kvquant.py).  The dtype flow follows the reference step
for step (bf16 activations, norms and RoPE in f32, f32 attention scores),
so the two agree at the bf16-rounding scale.

The KV ring is updated **in place**: a forward pass writes the S new
tokens' slots of every layer into the ``cache`` tensors it was given —
where JAX donated the cache and got a new one back.  The slots are the
pass's ``positions``, a device tensor (``index_copy_`` over the bf16 ring,
the int8 write kernel over the int8 one), and a decode step may take its
position as a 0-d device tensor: then nothing the step launches depends
on the position's value on the host, and the step can be captured once
in a CUDA graph and replayed at every position (models/generate.py).
Prompt passes run eagerly, so no prompt needs padding for a graph's sake;
the engine still pads to buckets to keep its prefix-reuse decisions those
of the reference.

Prompt passes (S > 1) go through the flash kernel when ``cfg.attn_impl ==
"flash"`` (its int8 variant over an int8 ring); decode (S = 1) and
``"xla"`` prompt passes use the plain score matrix of :func:`xla_attention`,
which folds an int8 ring's scales into its products as the reference does.
Decode scores the whole ring under the mask, as the reference does: a
shape that does not depend on the position.
A decode step under ``cfg.decode_layer_unroll`` runs the whole layer stack
through the layer-looped kernel instead (ops/decode_loop.py), K layers a
launch.
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from ..ops.attention import attention_mask, flash_attention, flash_attention_int8
from ..ops.kvquant import kv_quantize
from ..ops.linear import linear
from ..ops.rope import rope_cos_sin, rope_rotate
from .config import ModelConfig

logger = logging.getLogger(__name__)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return ((x32 * inv) * w.float()).to(x.dtype)


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """x: (S, H, hd); rotate pairs (2i, 2i+1) by pos · theta^(-2i/hd) — the
    reference's ``rope_interleaved``: the table at ``positions``, then the
    rotation that reads it (ops/rope.py)."""
    return rope_rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def init_cache(cfg: ModelConfig, device: torch.device,
               dtype=torch.bfloat16) -> dict:
    """KV ring, head-major: ``{"k", "v"}`` each (L, n_kv, n_ctx, hd) — or,
    under ``cfg.kv_dtype == "int8"``, ``{"k_q", "v_q"}`` int8 (L, n_kv,
    n_ctx, hd) and ``{"k_s", "v_s"}`` f32 (L, n_kv, n_ctx), the reference's
    four-leaf layout."""
    shape = (cfg.n_layers, cfg.n_kv_heads, cfg.n_ctx, cfg.head_dim)
    if cfg.kv_dtype == "int8":
        return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    if cfg.kv_dtype != "bf16":
        raise ValueError(f"kv_dtype must be bf16|int8, got {cfg.kv_dtype!r}")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_nbytes(cfg: ModelConfig) -> int:
    """Device bytes of one cache ring under ``cfg``: ``2·hd`` bytes per
    token-head in bf16, ``hd + 4`` in int8 (the reference's formula)."""
    int8 = cfg.kv_dtype == "int8"
    per_tok_head = cfg.head_dim * (1 if int8 else 2) + (4 if int8 else 0)
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.n_ctx * per_tok_head


def xla_attention(q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, out_dtype,
                  key_end: int | None = None, cks: torch.Tensor | None = None,
                  cvs: torch.Tensor | None = None) -> torch.Tensor:
    """The score-matrix attention (the reference's XLA path, in plain
    torch): q (S, H, hd); kk, vv (n_kv, n_ctx, hd) one layer's ring.
    Scores and softmax in f32, probabilities rounded to bf16 before P·V as
    the reference does.  ``key_end`` (default: the whole ring) is one past
    the last query position: every key from there on is masked, so the
    score matrix stops there.

    With ``cks``/``cvs`` (n_kv, n_ctx), the int8 ring's scales: scores are
    ``(q·k_int8)·hd^-0.5·cks`` and the probabilities are multiplied by
    ``cvs`` before they are rounded to bf16, so no dequantized ring is
    materialized."""
    S = q.shape[0]
    n_kv, group, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    if key_end is None:
        key_end = kk.shape[1]
    qg = q.reshape(S, n_kv, group, hd).permute(1, 2, 0, 3)         # (n_kv, g, S, hd)
    scores = torch.matmul(qg.float(), kk[:, None, :key_end].float().transpose(-1, -2)
                          ) * (hd ** -0.5)                          # (n_kv, g, S, c)
    if cks is not None:
        scores = scores * cks[:, None, None, :key_end]
    mask = attention_mask(positions, key_end, cfg.sliding_window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if cvs is not None:
        probs = probs * cvs[:, None, None, :key_end]
    probs = probs.to(q.dtype)
    ctx = torch.matmul(probs.float(), vv[:, None, :key_end].float()).to(q.dtype)
    return ctx.permute(2, 0, 1, 3).reshape(S, cfg.n_heads * hd).to(out_dtype)


def _layer(h: torch.Tensor, layer, i: int, cache: dict,
           positions: torch.Tensor, pos_offset: int | None,
           cfg: ModelConfig, rope: tuple, quantize=None) -> torch.Tensor:
    """One transformer block over S tokens; writes the S new K/V slots of
    layer ``i`` — ring slots ``positions`` (S,), a device tensor — into
    ``cache`` in place.  ``pos_offset`` is the first slot as a host int,
    which only a prompt pass (S > 1) reads (flash, and the score matrix's
    key range); a decode step passes None.  ``rope`` is the pass's rotation
    table (cos, sin) at ``positions`` (ops/rope.py): q is rotated by it, and
    k too over the bf16 ring; over the int8 ring ``quantize`` rotates k as
    it writes it (by default the kernel's wrapper, looked up at the call;
    the layer-looped decode's plain version passes ``kv_quantize_plain``)."""
    S = h.shape[0]
    n_kv, hd = cfg.n_kv_heads, cfg.head_dim

    hn = rms_norm(h, layer.attn_norm, cfg.rms_eps)
    q = linear(hn, layer.wq).reshape(S, cfg.n_heads, hd)
    k = linear(hn, layer.wk).reshape(S, n_kv, hd)
    v = linear(hn, layer.wv).reshape(S, n_kv, hd)
    q = rope_rotate(q, *rope)

    if cfg.kv_dtype == "int8":
        # rotate k, quantize the S new tokens' K and V straight into the ring
        ck, cv = cache["k_q"][i], cache["v_q"][i]                  # (n_kv, n_ctx, hd)
        cks, cvs = cache["k_s"][i], cache["v_s"][i]                # (n_kv, n_ctx)
        (quantize or kv_quantize)(k, v, *rope, positions, ck, cv, cks, cvs)
    else:
        k = rope_rotate(k, *rope)
        ck, cv = cache["k"][i], cache["v"][i]                      # (n_kv, n_ctx, hd)
        cks = cvs = None
        ck.index_copy_(1, positions, k.transpose(0, 1).to(ck.dtype))
        cv.index_copy_(1, positions, v.transpose(0, 1).to(cv.dtype))

    if cfg.attn_impl == "flash" and S > 1:
        if cks is None:
            ctx = flash_attention(q, ck, cv, pos_offset, sm_scale=hd ** -0.5,
                                  sliding_window=cfg.sliding_window)
        else:
            ctx = flash_attention_int8(q, ck, cv, cks, cvs, pos_offset,
                                       sm_scale=hd ** -0.5,
                                       sliding_window=cfg.sliding_window)
        ctx = ctx.reshape(S, cfg.n_heads * hd).to(h.dtype)
    else:
        # decode scores the whole ring under the mask (the reference's
        # shapes); a prompt pass stops at its last key
        ctx = xla_attention(q, ck, cv, positions, cfg, h.dtype,
                            key_end=None if S == 1 else pos_offset + S, cks=cks, cvs=cvs)
    h = h + linear(ctx, layer.wo)

    hn = rms_norm(h, layer.ffn_norm, cfg.rms_eps)
    gated = F.silu(linear(hn, layer.w_gate).float()).to(h.dtype)
    return h + linear(gated * linear(hn, layer.w_up), layer.w_down)


#: loop-plan refusals already logged by this process
_REFUSALS: set = set()


def _loop_unroll(params, cfg: ModelConfig, S: int) -> tuple[int, dict | None]:
    """(layers per looped launch, weight plan) for a pass of S tokens —
    (0, None) selects the per-layer path: the loop is off, the pass is a
    prompt pass (S > 1), or the weights refuse it (a fused layout; the
    reason is logged once)."""
    if not cfg.decode_layer_unroll or S != 1:
        return 0, None
    from ..ops.decode_loop import effective_unroll, loop_plan

    fmts, reason = loop_plan(params, cfg)
    if reason is not None:
        if reason not in _REFUSALS:
            _REFUSALS.add(reason)
            logger.warning("layer-looped decode unavailable (%s): serving "
                           "per-layer decode", reason)
        return 0, None
    return effective_unroll(cfg), fmts


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            pos_offset: int | torch.Tensor, cache: dict, last_idx: int | None = None,
            return_all: bool = False) -> torch.Tensor:
    """Run S tokens through the stack from ring slot ``pos_offset``, writing
    their K/V into ``cache`` in place.  Returns f32 logits: (vocab,) at
    ``last_idx`` (default S-1), or (S, vocab) with ``return_all``.

    ``pos_offset`` is a host int, range-checked here, or — for one decode
    token — a 0-d int64 device tensor that is never read on the host (the
    caller checks the range on its host mirror), so the step can be
    captured in a CUDA graph.

    A decode step (S == 1) under ``cfg.decode_layer_unroll`` runs the layer
    stack as L/K launches of the layer-looped kernel (ops/decode_loop.py);
    the output norm and head stay outside the loop, as in the reference."""
    S = tokens.shape[0]
    if isinstance(pos_offset, torch.Tensor):
        if S != 1 or pos_offset.shape != () or pos_offset.dtype != torch.int64:
            raise ValueError(f"a device position takes one token at a 0-d int64 "
                             f"slot, got {S} tokens at {tuple(pos_offset.shape)} "
                             f"{pos_offset.dtype}")
    elif pos_offset < 0 or pos_offset + S > cfg.n_ctx:
        raise ValueError(f"tokens at {pos_offset}..{pos_offset + S} do not fit "
                         f"the {cfg.n_ctx}-slot KV ring")
    if len(params.layers) != cfg.n_layers:
        raise ValueError(f"params have {len(params.layers)} layers but "
                         f"cfg.n_layers={cfg.n_layers}")
    h = params.tok_emb[tokens].to(torch.bfloat16)
    positions = pos_offset + torch.arange(S, device=h.device)
    host_offset = None if isinstance(pos_offset, torch.Tensor) else pos_offset
    K, fmts = _loop_unroll(params, cfg, S)
    if K:
        from ..ops.decode_loop import forward_layers_looped

        h = forward_layers_looped(params, cfg, h, positions, cache, K, fmts)
    else:
        rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        for i, layer in enumerate(params.layers):
            h = _layer(h, layer, i, cache, positions, host_offset, cfg, rope)
    if return_all:
        hn = rms_norm(h, params.out_norm, cfg.rms_eps)
        return linear(hn, params.output).float()
    if last_idx is None:
        last_idx = S - 1
    hn = rms_norm(h[last_idx:last_idx + 1], params.out_norm, cfg.rms_eps)
    return linear(hn, params.output).float()[0]


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, length: int,
            cache: dict) -> torch.Tensor:
    """Prompt pass from cache slot 0: ``tokens`` padded, ``length`` real.
    Returns the logits at the last real token."""
    return forward(params, cfg, tokens, 0, cache, last_idx=length - 1)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: int | torch.Tensor,
                cache: dict) -> torch.Tensor:
    """One autoregressive step: ``token`` (0-d) at cache position ``pos`` (a
    host int, or a 0-d device tensor as :func:`forward` takes it)."""
    return forward(params, cfg, token.reshape(1), pos, cache)

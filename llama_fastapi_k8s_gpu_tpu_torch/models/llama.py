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

The batched engines keep B lanes' rings in one lane-major cache, each leaf
``(B, L, n_kv, n_ctx, hd)`` (:func:`init_lane_cache`): lane ``b``'s view
``leaf[b]`` is exactly a serial ring, so prompt passes and the looped
kernel run on it unchanged.  :func:`forward_lanes` feeds one token in each
lane at per-lane slots (a (B,) device tensor): the linears take the (B,
dim) rows as they are, the bf16 ring write is one indexed write at (lane,
slot) a layer, the int8 one a single launch of the int8 write kernel over
the lanes (its lane stride), decode attention is :func:`lane_attention`
with per-lane masks, and under ``decode_layer_unroll`` the stack is the
looped kernel once per lane over the lane's own view.
"""

from __future__ import annotations

import dataclasses
import logging

import torch
import torch.nn.functional as F

from ..ops.attention import attention_mask, flash_attention, flash_attention_int8
from ..ops.kvquant import dequantize_kv, kv_quantize
from ..ops.linear import _bf16_matmul_f32, _int8_matmul, _row_scale, linear
from ..ops.rope import rope_cos_sin, rope_rotate
from ..parallel.mesh import ShardedRing, all_gather, all_max, all_sum
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


def init_lane_cache(cfg: ModelConfig, batch: int, device: torch.device) -> dict:
    """B lanes' rings, lane-major: every leaf of :func:`init_cache` with a
    leading ``batch`` dim, so ``leaf[b]`` is lane ``b``'s contiguous ring."""
    return {k: torch.zeros((batch, *t.shape), dtype=t.dtype, device=device)
            for k, t in init_cache(cfg, torch.device("meta")).items()}


def lane_view(cache: dict, lane: int) -> dict:
    """Lane ``lane``'s ring of a lane-major cache: contiguous views shaped
    as :func:`init_cache`'s leaves (over a mesh, the lane's dp group's
    shards: ``parallel.mesh.ShardedRing.lane``)."""
    if isinstance(cache, ShardedRing):
        return cache.lane(lane)
    return {k: t[lane] for k, t in cache.items()}


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


def lane_attention(q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor,
                   slots: torch.Tensor, cfg: ModelConfig, out_dtype,
                   cks: torch.Tensor | None = None,
                   cvs: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`xla_attention` of one decode query a lane: q (B, H, hd) over
    one layer's lane rings ``kk``/``vv`` (B, n_kv, n_ctx, hd) (int8 with
    ``cks``/``cvs`` (B, n_kv, n_ctx)), lane ``b`` masked at ``slots[b]``.
    The same arithmetic as the one-sequence path, batched over the lanes:
    every lane scores its whole ring in f32."""
    B = q.shape[0]
    n_kv, group, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    n_ctx = kk.shape[2]
    qg = q.reshape(B, n_kv, group, 1, hd)
    scores = torch.matmul(qg.float(), kk[:, :, None].float().transpose(-1, -2)
                          ) * (hd ** -0.5)                          # (B, n_kv, g, 1, c)
    if cks is not None:
        scores = scores * cks[:, :, None, None, :]
    mask = attention_mask(slots, n_ctx, cfg.sliding_window)        # (B, c)
    scores = scores.masked_fill(~mask[:, None, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if cvs is not None:
        probs = probs * cvs[:, :, None, None, :]
    probs = probs.to(q.dtype)
    ctx = torch.matmul(probs.float(), vv[:, :, None].float()).to(q.dtype)
    return ctx.reshape(B, cfg.n_heads * hd).to(out_dtype)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i: int, cache: dict,
               positions: torch.Tensor, pos_offset: int | None, cfg: ModelConfig,
               rope: tuple, out_dtype, quantize=None) -> torch.Tensor:
    """Layer ``i``'s attention over S tokens: q (S, n_heads, hd) already
    rotated, k and v (S, n_kv, hd) with k before RoPE; writes the new K/V
    at ring slots ``positions`` into ``cache`` in place (k rotated there)
    and returns the context (S, n_heads·hd) in ``out_dtype``.  The head
    counts are ``cfg``'s — a tensor-parallel shard passes its local ones."""
    S, hd = q.shape[0], cfg.head_dim
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
        return ctx.reshape(S, cfg.n_heads * hd).to(out_dtype)
    # decode scores the whole ring under the mask (the reference's
    # shapes); a prompt pass stops at its last key
    return xla_attention(q, ck, cv, positions, cfg, out_dtype,
                         key_end=None if S == 1 or pos_offset is None else pos_offset + S,
                         cks=cks, cvs=cvs)


def _row_linear(xs: list, ws: list, devs: list) -> list:
    """A row-parallel linear: ``xs[t]`` the t-th slice of the input's
    columns, ``ws[t]`` the weight's matching K slice (bf16, or int8 with the
    whole per-row scale).  The partial products are summed (``psum``) and
    every shard gets the whole output.  bf16 partials are f32 products of
    the bf16 shards, summed in f32 and rounded once; int8 quantizes the activations with the row's global
    maximum, so the int32 partials sum to the unsharded product exactly."""
    if ws[0].kind == "int8":
        lead, N = xs[0].shape[:-1], ws[0].n_out
        xf = [x.reshape(-1, x.shape[-1]).float() for x in xs]
        amax = all_max([x.abs().amax(dim=-1, keepdim=True) for x in xf], devs)
        scale = [_row_scale(a) for a in amax]
        accs = all_sum([_int8_matmul(torch.round(x / s).to(torch.int8), w.weight)
                        for x, s, w in zip(xf, scale, ws)], devs)
        return [(a.float() * s * w.scale).to(x.dtype).reshape(*lead, N)
                for a, s, w, x in zip(accs, scale, ws, xs)]
    if ws[0].kind != "bf16":
        raise ValueError(f"a row-parallel linear is bf16 or int8, got {ws[0].kind!r}")
    lead, N = xs[0].shape[:-1], ws[0].n_out
    return [y.reshape(*lead, N) for y in all_sum(
        [_bf16_matmul_f32(x.reshape(-1, x.shape[-1]), w.weight) for x, w in zip(xs, ws)],
        devs, dtype=xs[0].dtype)]


class _Shards:
    """The tp shards that run one row block, and the transformer block's
    steps over them: :func:`_layer` and :func:`_lane_layer` (one device,
    :data:`_ONE`) and the forwards over a mesh all run these, so the block
    is written once.  Activations are lists over the shards, each split
    over tp along its last dim or replicated; a step that needs one whole
    gathers it (``all_gather``), and a row-parallel linear sums its partial
    products.  Over one device the lists hold one tensor and every step is
    the identity around that device's :func:`linear`."""

    def __init__(self, ps: list, devs: list, layout: dict | None = None):
        self.ps, self.devs, self.layout, self.tp = ps, devs, layout, len(devs)

    @classmethod
    def of(cls, mp, d: int, s: int) -> "_Shards":
        """Row block (d, ·, s) of weights laid over a mesh
        (``parallel.mesh.MeshParams``)."""
        tp = mp.mesh.shape["tp"]
        return cls([mp.shard(d, t, s) for t in range(tp)],
                   [mp.mesh.device(d, t, s) for t in range(tp)], mp.layout)

    def layers(self, i: int) -> list:
        return [p.layers[i] for p in self.ps]

    def rep(self, x: list, split: bool) -> list:
        return all_gather(x, -1, self.devs) if split and self.tp > 1 else x

    def split(self, x: list, split: bool) -> list:
        if split or self.tp == 1:
            return x
        return [torch.chunk(x[t], self.tp, dim=-1)[t] for t in range(self.tp)]

    def lin(self, x: list, split: bool, ws: list, name: str) -> tuple:
        """Linear ``name`` (its shards ``ws``) over ``x``; returns ``(y,
        y_split)``: ``col`` gives N-split rows, ``row`` and ``rep`` whole
        ones."""
        if self.tp == 1:
            return [linear(x[0], ws[0])], False
        mode = self.layout[name]
        if mode == "row":
            return _row_linear(self.split(x, split), ws, self.devs), False
        x = self.rep(x, split)
        return [linear(a, w) for a, w in zip(x, ws)], mode == "col"

    def qkv(self, h: list, layers: list, cfg: ModelConfig, heads_split: bool) -> tuple:
        """The block's q, k, v per shard, (R, heads, hd) with ``cfg``'s head
        counts (a shard's local ones when the heads split), before RoPE."""
        hn = [rms_norm(x, layer.attn_norm, cfg.rms_eps) for x, layer in zip(h, layers)]
        out = []
        for name, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)):
            y, ys = self.lin(hn, False, [getattr(layer, name) for layer in layers], name)
            y = self.split(y, ys) if heads_split else self.rep(y, ys)
            out.append([x.reshape(x.shape[0], heads, cfg.head_dim) for x in y])
        return out

    def post(self, h: list, ctx: list, ctx_split: bool, layers: list, eps: float) -> list:
        """The rest of the block after attention: wo, the residual, the
        SwiGLU FFN and its residual; returns h replicated."""
        def lin(x, split, name):
            return self.lin(x, split, [getattr(layer, name) for layer in layers], name)

        o, os_ = lin(ctx, ctx_split, "wo")
        h = [a + b for a, b in zip(h, self.rep(o, os_))]
        hn = [rms_norm(x, layer.ffn_norm, eps) for x, layer in zip(h, layers)]
        g, gs = lin(hn, False, "w_gate")
        u, us = lin(hn, False, "w_up")
        if gs != us:
            g, u, gs = self.rep(g, gs), self.rep(u, us), False
        gated = [F.silu(a.float()).to(a.dtype) * b for a, b in zip(g, u)]
        dn, ds = lin(gated, gs, "w_down")
        return [a + b for a, b in zip(h, self.rep(dn, ds))]

    def head(self, h: list, ps: list, eps: float) -> torch.Tensor:
        """f32 logits of rows ``h`` (the output norm and head of each
        shard's weights ``ps``), gathered over the vocabulary."""
        hn = [rms_norm(x, p.out_norm, eps) for x, p in zip(h, ps)]
        logits, ls = self.lin(hn, False, [p.output for p in ps], "output")
        return self.rep(logits, ls)[0].float()


#: the block's steps on one device
_ONE = _Shards([], [None])


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
    q, k, v = (x[0] for x in _ONE.qkv([h], [layer], cfg, True))
    ctx = _attention(rope_rotate(q, *rope), k, v, i, cache, positions, pos_offset, cfg,
                     rope, h.dtype, quantize=quantize)
    return _ONE.post([h], [ctx], True, [layer], cfg.rms_eps)[0]


def _lane_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i: int,
                    cache: dict, slots: torch.Tensor, cfg: ModelConfig, rope: tuple,
                    out_dtype) -> torch.Tensor:
    """Layer ``i``'s decode attention of one token a lane: q (B, n_heads,
    hd) rotated, k and v (B, n_kv, hd) with k before RoPE; writes each
    lane's K/V at its slot into the lane-major ``cache`` in place and
    returns the context (B, n_heads·hd)."""
    B = q.shape[0]
    if cfg.kv_dtype == "int8":
        ck, cv = cache["k_q"][:, i], cache["v_q"][:, i]            # (B, n_kv, n_ctx, hd)
        cks, cvs = cache["k_s"][:, i], cache["v_s"][:, i]          # (B, n_kv, n_ctx)
        kv_quantize(k, v, *rope, slots, ck, cv, cks, cvs)
    else:
        k = rope_rotate(k, *rope)
        ck, cv = cache["k"][:, i], cache["v"][:, i]
        cks = cvs = None
        lanes = torch.arange(B, device=q.device)
        ck[lanes, :, slots] = k.to(ck.dtype)
        cv[lanes, :, slots] = v.to(cv.dtype)
    return lane_attention(q, ck, cv, slots, cfg, out_dtype, cks=cks, cvs=cvs)


def _lane_layer(h: torch.Tensor, layer, i: int, cache: dict, slots: torch.Tensor,
                cfg: ModelConfig, rope: tuple) -> torch.Tensor:
    """One transformer block over one token a lane: h (B, dim); writes each
    lane's K/V of layer ``i`` at its slot (``slots`` (B,), in range) into
    the lane-major ``cache`` in place."""
    q, k, v = (x[0] for x in _ONE.qkv([h], [layer], cfg, True))
    ctx = _lane_attention(rope_rotate(q, *rope), k, v, i, cache, slots, cfg, rope, h.dtype)
    return _ONE.post([h], [ctx], True, [layer], cfg.rms_eps)[0]


#: loop-plan refusals already logged by this process
_REFUSALS: set = set()


def _loop_unroll(params, cfg: ModelConfig, S: int) -> tuple[int, dict | None]:
    """(layers per looped launch, weight plan) for a pass of S tokens —
    (0, None) selects the per-layer path: the loop is off, the pass is a
    prompt pass (S > 1), or the weights refuse it (a fused layout; the
    reason is logged once).  ``params`` may be laid over a mesh."""
    if not cfg.decode_layer_unroll or S != 1:
        return 0, None
    from ..ops.decode_loop import effective_unroll, loop_plan
    from ..parallel.mesh import MeshParams

    # a mesh's shards share its kinds: the plan of shard 0
    fmts, reason = loop_plan(params.shard() if isinstance(params, MeshParams) else params, cfg)
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

    ``pos_offset`` is a host int, range-checked here, or a 0-d int64 device
    tensor that is never read on the host (the caller checks the range on
    its host mirror), so the step can be captured in a CUDA graph.  A
    device position takes one decode token, or the S rows of a speculative
    verify pass (models/generate.py ``spec_verify``): those score the whole
    ring under the mask, as decode does, which the ``flash`` prompt path
    cannot (it takes a host offset), and their slots are clamped to the
    ring's last, so a lane whose slot ran past the ring writes nothing
    outside it.

    A decode step (S == 1) under ``cfg.decode_layer_unroll`` runs the layer
    stack as L/K launches of the layer-looped kernel (ops/decode_loop.py);
    the output norm and head stay outside the loop, as in the reference.

    Weights laid over a mesh (``parallel.mesh.MeshParams``) run
    :func:`forward_mesh` over their sharded ring."""
    if isinstance(cache, ShardedRing):
        return forward_mesh(params, cfg, tokens, pos_offset, cache, last_idx, return_all)
    S = tokens.shape[0]
    if isinstance(pos_offset, torch.Tensor):
        if pos_offset.shape != () or pos_offset.dtype != torch.int64:
            raise ValueError(f"a device position is a 0-d int64 slot, got "
                             f"{tuple(pos_offset.shape)} {pos_offset.dtype}")
        if S > 1 and cfg.attn_impl == "flash":
            raise ValueError("a device position takes the score-matrix attention "
                             "(attn_impl 'xla'): the flash kernel takes a host offset")
    elif pos_offset < 0 or pos_offset + S > cfg.n_ctx:
        raise ValueError(f"tokens at {pos_offset}..{pos_offset + S} do not fit "
                         f"the {cfg.n_ctx}-slot KV ring")
    if len(params.layers) != cfg.n_layers:
        raise ValueError(f"params have {len(params.layers)} layers but "
                         f"cfg.n_layers={cfg.n_layers}")
    h = params.tok_emb[tokens].to(torch.bfloat16)
    positions = pos_offset + torch.arange(S, device=h.device)
    if S > 1 and isinstance(pos_offset, torch.Tensor):
        positions = positions.clamp(max=cfg.n_ctx - 1)
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
        return _ONE.head([h], [params], cfg.rms_eps)
    if last_idx is None:
        last_idx = S - 1
    return _ONE.head([h[last_idx:last_idx + 1]], [params], cfg.rms_eps)[0]


def forward_lanes(params, cfg: ModelConfig, tokens: torch.Tensor, slots: torch.Tensor,
                  cache: dict) -> torch.Tensor:
    """One decode token in each of B lanes: ``tokens`` (B,) int64 at ring
    slots ``slots`` (B,) int64, a device tensor never read on the host and
    in range (the lane step clamps it), over the lane-major ``cache``
    (:func:`init_lane_cache`), written in place.  Returns f32 logits (B,
    vocab).

    Under ``cfg.decode_layer_unroll`` each lane's layer stack is L/K
    launches of the looped kernel over the lane's own ring view, the lanes
    one after another on one stream.  A lane ring sharded over a mesh runs
    :func:`forward_lanes_mesh`."""
    if isinstance(cache, ShardedRing):
        return forward_lanes_mesh(params, cfg, tokens, slots, cache)
    B = tokens.shape[0]
    if slots.shape != (B,) or slots.dtype != torch.int64:
        raise ValueError(f"forward_lanes: slots {tuple(slots.shape)} {slots.dtype}, "
                         f"expected ({B},) int64")
    if len(params.layers) != cfg.n_layers:
        raise ValueError(f"params have {len(params.layers)} layers but "
                         f"cfg.n_layers={cfg.n_layers}")
    h = params.tok_emb[tokens].to(torch.bfloat16)                  # (B, dim)
    K, fmts = _loop_unroll(params, cfg, 1)
    if K:
        from ..ops.decode_loop import forward_layers_looped

        h = torch.cat([forward_layers_looped(params, cfg, h[b:b + 1], slots[b:b + 1],
                                             lane_view(cache, b), K, fmts)
                       for b in range(B)])
    else:
        rope = rope_cos_sin(slots, cfg.head_dim, cfg.rope_theta)
        for i, layer in enumerate(params.layers):
            h = _lane_layer(h, layer, i, cache, slots, cfg, rope)
    return _ONE.head([h], [params], cfg.rms_eps)


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


# ---------------------------------------------------------------------------
# the forward over a mesh (parallel/mesh.py): tensor-parallel shards within
# a row block, the sequence-parallel ring across row blocks
# ---------------------------------------------------------------------------

def _local_cfg(cfg: ModelConfig, tp: int, heads_split: bool) -> ModelConfig:
    """``cfg`` with one tp shard's head counts (the head size kept)."""
    if tp == 1 or not heads_split:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp, dim=cfg.dim // tp)


class _PerDevice:
    """One pass's positions and RoPE tables, made once per device."""

    def __init__(self, positions: torch.Tensor, cfg: ModelConfig):
        self.positions, self.cfg, self._at = positions, cfg, {}

    def __call__(self, dev) -> tuple:
        if dev not in self._at:
            pos = self.positions.to(dev)
            self._at[dev] = (pos, rope_cos_sin(pos, self.cfg.head_dim, self.cfg.rope_theta))
        return self._at[dev]


def _sp_write(k: torch.Tensor, v: torch.Tensor, part: dict, i: int, positions: torch.Tensor,
              rope: tuple, host_offset: int | None, lo: int, C: int,
              cfg: ModelConfig) -> tuple:
    """Write the new rows (k before RoPE, v; (S, n_kv, hd)) whose slots fall
    in this shard's range [lo, lo + C) into its chunk of layer ``i``, and
    return the layer's chunk (n_kv, C, hd) as bf16 for the ring.  A host
    offset selects the rows on the host; a device position (one decode
    row) writes where it falls and leaves the other shards as they were."""
    if host_offset is not None:
        j0 = min(max(lo - host_offset, 0), k.shape[0])
        j1 = min(max(lo + C - host_offset, 0), k.shape[0])
        rows = slice(j0, j1)
        local = positions[rows] - lo
        k, v, rope = k[rows], v[rows], (rope[0][rows], rope[1][rows])
        valid = None
    else:
        if k.shape[0] != 1:
            raise ValueError("a device position over the sp ring takes one decode row")
        local = positions - lo
        valid = (local >= 0) & (local < C)
    if cfg.kv_dtype == "int8":
        ck, cv, cks, cvs = part["k_q"][i], part["v_q"][i], part["k_s"][i], part["v_s"][i]
        if k.shape[0]:
            # the kernel (and its plain version) skips a slot outside the chunk
            kv_quantize(k, v, *rope, local, ck, cv, cks, cvs)
        return dequantize_kv(ck, cks, torch.bfloat16), dequantize_kv(cv, cvs, torch.bfloat16)
    ck, cv = part["k"][i], part["v"][i]
    if k.shape[0]:
        kh = rope_rotate(k, *rope).transpose(0, 1).to(ck.dtype)       # (n_kv, S, hd)
        vh = v.transpose(0, 1).to(cv.dtype)
        if valid is not None:
            local = local.clamp(0, C - 1)
            kh = torch.where(valid[None, :, None], kh, ck.index_select(1, local))
            vh = torch.where(valid[None, :, None], vh, cv.index_select(1, local))
        ck.index_copy_(1, local, kh)
        cv.index_copy_(1, local, vh)
    return ck, cv


def _tp_layers(g: _Shards, h: list, layers, parts: list, at: _PerDevice,
               host_offset: int | None, lcfg: ModelConfig, heads_split: bool, eps: float,
               quantize=None) -> list:
    """The blocks ``layers`` of one row block over its tp shards ``g`` (an
    sp = 1 ring): each shard's local heads (``lcfg``) attend over its ring
    ``parts[t]``, written in place at the pass's positions (``at``); h is
    replicated over the shards.  ``quantize`` as :func:`_layer` takes it."""
    for i in layers:
        q, k, v = g.qkv(h, g.layers(i), lcfg, heads_split)
        ctx = []
        for t, dev in enumerate(g.devs):
            pos, rope = at(dev)
            ctx.append(_attention(rope_rotate(q[t], *rope), k[t], v[t], i, parts[t], pos,
                                  host_offset, lcfg, rope, torch.bfloat16, quantize=quantize))
        h = g.post(h, ctx, heads_split, g.layers(i), eps)
    return h


def forward_mesh(mp, cfg: ModelConfig, tokens: torch.Tensor, pos_offset,
                 cache, last_idx: int | None = None, return_all: bool = False) -> torch.Tensor:
    """:func:`forward` over tensor-parallel weights (``parallel.mesh.
    MeshParams``) and a sharded ring (``parallel.mesh.ShardedRing``) of one
    dp group.  Within a row block the tp shards run their local heads and
    meet where the sharding rules say (gathers of split activations, sums of
    row-parallel products, the vocabulary gathered before sampling).  A
    ring sharded over sp needs ``cfg.attn_impl == "ring"``: a prompt pass
    splits its S rows over sp (S % sp == 0) and attends through
    :func:`parallel.ring.ring_attention_shards`; a decode row is replicated
    over sp and attends through the sharded log-sum-exp.  Under
    ``cfg.decode_layer_unroll`` a decode row over an sp = 1 ring runs the
    layer stack as L/K looped launches that read every tp shard
    (``ops.decode_loop.forward_layers_looped_mesh``); prompt passes and
    verify rows stay per-layer.  Returns f32 logits on the ring's first
    device."""
    from ..parallel.ring import ring_attention_shards, sharded_decode_attention_shards

    S = tokens.shape[0]
    d = cache.coords[0][0]
    sp = len({c[2] for c in cache.coords})
    tp = mp.mesh.shape["tp"]
    K, fmts = _loop_unroll(mp, cfg, S)
    if K and sp > 1:
        raise ValueError(f"the layer-looped decode reads whole rings; a ring sharded over "
                         f"sp={sp} attends by ring attention")
    if sp > 1 and cfg.attn_impl != "ring":
        raise ValueError(f"a ring sharded over sp={sp} takes attn_impl 'ring', "
                         f"got {cfg.attn_impl!r}")
    ring = cfg.attn_impl == "ring"
    device_pos = isinstance(pos_offset, torch.Tensor)
    if not device_pos and (pos_offset < 0 or pos_offset + S > cfg.n_ctx):
        raise ValueError(f"tokens at {pos_offset}..{pos_offset + S} do not fit "
                         f"the {cfg.n_ctx}-slot KV ring")
    row_split = ring and sp > 1 and S > 1
    if row_split and S % sp:
        raise ValueError(f"a prompt pass over the sp={sp} ring takes S % sp == 0, got {S}")
    heads_split = mp.tp_heads and cache.tp_split
    lcfg = _local_cfg(cfg, tp, heads_split)
    groups = [_Shards.of(mp, d, s) for s in range(sp)]
    R = S // sp if row_split else S
    out_dev = cache.device
    positions = pos_offset + torch.arange(S, device=out_dev)
    if S > 1 and device_pos:
        positions = positions.clamp(max=cfg.n_ctx - 1)
    host_offset = None if device_pos else pos_offset
    at = _PerDevice(positions, cfg)

    def rows(x, s):
        return x[s * R:(s + 1) * R] if row_split else x

    h = [[p.tok_emb[rows(tokens, s).to(dev)].to(torch.bfloat16)
          for p, dev in zip(g.ps, g.devs)] for s, g in enumerate(groups)]
    C = cfg.n_ctx // sp
    if K:
        from ..ops.decode_loop import forward_layers_looped_mesh

        h[0] = forward_layers_looped_mesh(mp, cfg, h[0], positions, cache, K, fmts)
    elif not ring:
        h[0] = _tp_layers(groups[0], h[0], range(cfg.n_layers),
                          [cache.part(cache.index(d, t, 0)) for t in range(tp)], at,
                          host_offset, lcfg, heads_split, cfg.rms_eps)
    else:
        for i in range(cfg.n_layers):
            qkv = [g.qkv(h[s], g.layers(i), lcfg, heads_split) for s, g in enumerate(groups)]
            ctx = [[None] * tp for _ in range(sp)]
            for t in range(tp):
                devs = [g.devs[t] for g in groups]
                ks = [qkv[s][1][t] for s in range(sp)]
                vs = [qkv[s][2][t] for s in range(sp)]
                if row_split:                  # every shard sees every new row
                    ks, vs = all_gather(ks, 0, devs), all_gather(vs, 0, devs)
                kc, vc, qs = [], [], []
                for s, dev in enumerate(devs):
                    pos, rope = at(dev)
                    ck, cv = _sp_write(ks[s], vs[s], cache.part(cache.index(d, t, s)), i, pos,
                                       rope, host_offset, s * C, C, lcfg)
                    kc.append(ck)
                    vc.append(cv)
                    qs.append(rope_rotate(qkv[s][0][t], *(rows(r, s) for r in rope)))
                attend = ring_attention_shards if row_split else sharded_decode_attention_shards
                out = attend(qs, kc, vc, pos_offset, cfg.head_dim ** -0.5, cfg.sliding_window, devs)
                for s in range(sp):
                    ctx[s][t] = out[s].reshape(out[s].shape[0], -1).to(torch.bfloat16)
            h = [g.post(h[s], ctx[s], heads_split, g.layers(i), cfg.rms_eps)
                 for s, g in enumerate(groups)]
    if return_all:
        return torch.cat([g.head(h[s], g.ps, cfg.rms_eps).to(out_dev)
                          for s, g in enumerate(groups)])
    li = S - 1 if last_idx is None else last_idx
    s, j = divmod(li, R) if row_split else (0, li)
    return groups[s].head([x[j:j + 1] for x in h[s]], groups[s].ps, cfg.rms_eps)[0].to(out_dev)


def forward_lanes_mesh(mp, cfg: ModelConfig, tokens: torch.Tensor, slots: torch.Tensor,
                       cache) -> torch.Tensor:
    """:func:`forward_lanes` over a lane ring sharded over dp × tp: dp group
    ``d`` runs its B/dp lanes on its tp shards (local heads, the rules'
    gathers and sums), and the groups' logits are stacked on the ring's
    first device.  Under ``cfg.decode_layer_unroll`` each lane's stack is
    L/K looped launches over its own ring (``cache.lane(b)``), the lanes
    and the groups one after another."""
    K, fmts = _loop_unroll(mp, cfg, 1)
    tp = mp.mesh.shape["tp"]
    heads_split = mp.tp_heads and cache.tp_split
    lcfg = _local_cfg(cfg, tp, heads_split)
    groups = cache.dp_groups
    per = tokens.shape[0] // len(groups)
    out = []
    for d in groups:
        g = _Shards.of(mp, d, 0)
        lanes = slice(d * per, (d + 1) * per)
        at = _PerDevice(slots[lanes], cfg)
        h = [p.tok_emb[tokens[lanes].to(dev)].to(torch.bfloat16) for p, dev in zip(g.ps, g.devs)]
        if K:
            from ..ops.decode_loop import forward_layers_looped_mesh

            rows = [forward_layers_looped_mesh(mp, cfg, [x[j:j + 1] for x in h],
                                               slots[b:b + 1].to(g.devs[0]), cache.lane(b),
                                               K, fmts)
                    for j, b in enumerate(range(lanes.start, lanes.stop))]
            h = [torch.cat([r[t] for r in rows]) for t in range(tp)]
        else:
            for i in range(cfg.n_layers):
                q, k, v = g.qkv(h, g.layers(i), lcfg, heads_split)
                ctx = []
                for t, dev in enumerate(g.devs):
                    pos, rope = at(dev)
                    ctx.append(_lane_attention(rope_rotate(q[t], *rope), k[t], v[t], i,
                                               cache.part(cache.index(d, t, 0)), pos, lcfg, rope,
                                               torch.bfloat16))
                h = g.post(h, ctx, heads_split, g.layers(i), cfg.rms_eps)
        out.append(g.head(h, g.ps, cfg.rms_eps).to(cache.device))
    return torch.cat(out)

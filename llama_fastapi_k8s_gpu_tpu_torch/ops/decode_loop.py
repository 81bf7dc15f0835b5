"""Layer-looped decode: K transformer layers of one decode token per launch.

The per-layer decode step launches every linear, norm, RoPE, ring write and
attention op of every layer on its own — some 2,000 kernels a token at 32
layers, each costing the host tens of microseconds.  Under
``cfg.decode_layer_unroll`` (``LFKT_DECODE_LAYER_UNROLL``) a decode step
(S == 1) runs the layer stack instead as L/K launches of one kernel
(``csrc/decode_loop.cu``): ``-1`` (or K ≥ L) is one launch a token, any
other K is clamped to a divisor of L.  Prompt passes never loop, and the
output norm, head and sampling stay outside the loop, as in the reference.
Only bf16 and int8 linears can loop (``models.params.decode_loop_plan``);
the fused formats serve per-layer.

- :func:`decode_loop_step` — the wrapper: launches the kernel for CUDA
  tensors (counted on ``decode_loop_step.launches``) and runs
  :func:`decode_loop_plain` for CPU tensors;
- :func:`decode_loop_plain` — the per-layer arithmetic of layers
  ``[layer0, layer0 + K)``, through the plain functions only (the linears,
  ``kv_quantize_plain``, ``xla_attention``), never a kernel: on the CPU the
  looped forward is therefore bit-identical to the per-layer forward;
- :func:`split_attention_plain` — the kernel's attention split over key
  chunks, in plain PyTorch, for the tests;
- :func:`forward_layers_looped` — the L/K launches of a decode step.

The token's ring slot is a (1,) int64 device tensor, ``positions``, which
the kernel reads at entry: no launch argument depends on the position, so
a decode step captured in a CUDA graph replays at the slot its state holds
(models/generate.py).  The range is the caller's to check, on its host
mirror of the position.

Replaces the Pallas kernel llama_fastapi_k8s_gpu_tpu/ops/pallas/
decode_loop.py::_loop_kernel.  The reference's compile probe and its
degrade-to-per-layer pin (``disable_decode_loop``) are not ported: a kernel
that fails to build or launch raises.  The plan refusal of a fused layout
is the reference's own decision and is kept (the engine logs it and serves
per-layer).
"""

from __future__ import annotations

import weakref

import torch

from ._kernels import check, library, require_cuda, stream_ptr
from .rope import rope_cos_sin

#: per params object: its loop plan and, on the card, its weight table
_PARAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: per params object (one engine's weights): the grid barrier's counter
#: (zero before the first launch) and, per geometry, the attention's
#: scratch and per-KV-head arrival counters (zero between launches).  Two
#: co-resident models each own a set, so their launches may overlap on two
#: streams; the set dies with the weights
_SCRATCH: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: the smallest key chunk of an attention item (csrc/decode_loop.cu
#: CHUNK_MIN): the partials hold ⌈n_ctx / CHUNK_MIN⌉ chunks a query head
CHUNK_MIN = 8
#: pointers a layer has in the kernel's weight table (csrc/decode_loop.cu)
_TABLE = 16
#: head sizes the kernel takes
HEAD_DIMS = (32, 64, 128, 256)


def effective_unroll(cfg) -> int:
    """``cfg.decode_layer_unroll`` clamped to a divisor of ``n_layers``:
    ``-1`` (or K ≥ L) puts all layers in one launch; any other K walks down
    to the nearest divisor, so the launches cover every layer once.  0 stays
    0; K < -1 raises ``ValueError`` (the reference's clamp)."""
    K = int(cfg.decode_layer_unroll)
    L = int(cfg.n_layers)
    if K == 0:
        return 0
    if K < -1:
        raise ValueError(
            f"decode_layer_unroll must be >= -1, got {K} "
            "(0 = off, -1 = all layers per launch)")
    if K < 0 or K >= L:
        return L
    while K > 1 and L % K:
        K -= 1
    return K


def _entry(params) -> dict:
    entry = _PARAMS.get(params)
    if entry is None:
        entry = _PARAMS[params] = {}
    return entry


def loop_plan(params, cfg):
    """:func:`models.params.decode_loop_plan` of ``params``, computed once
    per params object (and layer count)."""
    from ..models.params import decode_loop_plan

    entry = _entry(params)
    key = ("plan", cfg.n_layers)
    if key not in entry:
        entry[key] = decode_loop_plan(params, cfg)
    return entry[key]


def _weight_table(params, cfg, int8: bool) -> torch.Tensor:
    """(L, 16) int64 on the card: each layer's seven weight planes, their
    seven int8 scale vectors (0 for bf16) and its two norms, by address —
    built once per params object, checked as it is built."""
    from ..models.params import LOOP_LINEARS

    entry = _entry(params)
    table = entry.get("table")
    if table is not None:
        return table
    kvd = cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (cfg.dim, cfg.dim), "wk": (kvd, cfg.dim), "wv": (kvd, cfg.dim),
              "wo": (cfg.dim, cfg.dim), "w_gate": (cfg.ffn_dim, cfg.dim),
              "w_up": (cfg.ffn_dim, cfg.dim), "w_down": (cfg.dim, cfg.ffn_dim)}
    wdtype = torch.int8 if int8 else torch.bfloat16
    rows = []
    for i, layer in enumerate(params.layers):
        lins = [getattr(layer, n) for n in LOOP_LINEARS]
        for n, lin in zip(LOOP_LINEARS, lins):
            if tuple(lin.weight.shape) != shapes[n]:
                raise ValueError(f"decode_loop: layer {i} {n} is {tuple(lin.weight.shape)}, "
                                 f"expected {shapes[n]}")
            require_cuda(f"decode_loop: layer {i} {n}", lin.weight, dtypes=(wdtype,))
            if int8:
                require_cuda(f"decode_loop: layer {i} {n} scale", lin.scale,
                             dtypes=(torch.float32,))
        norms = (layer.attn_norm, layer.ffn_norm)
        require_cuda(f"decode_loop: layer {i} norms", *norms,
                     dtypes=(torch.float32, torch.float32))
        rows.append([lin.weight.data_ptr() for lin in lins]
                    + [lin.scale.data_ptr() if int8 else 0 for lin in lins]
                    + [t.data_ptr() for t in norms])
    device = params.layers[0].wq.weight.device
    table = torch.tensor(rows, dtype=torch.int64).to(device)
    entry["table"] = table
    return table


def _scratch(params) -> dict:
    entry = _SCRATCH.get(params)
    if entry is None:
        entry = _SCRATCH[params] = {}
    return entry


def _barrier(params, device: torch.device) -> torch.Tensor:
    scratch = _scratch(params)
    bar = scratch.get(device)
    if bar is None:
        bar = scratch[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return bar


def _attention_scratch(params, device: torch.device, cfg) -> tuple:
    """(partials, counters, max_chunks) of the kernel's attention phase:
    per query head and key chunk the chunk's P·V sums (hd f32) and its
    (max, sum), then per query head its scores over the ring — f32,
    n_heads × (max_chunks × (hd + 2) + n_ctx) — and two arrival counters
    per KV head, which every launch returns to zero.

    One set per weights object, device and geometry, shared by every launch
    of that engine — the per-lane launches of a lane step included — so an
    engine's launches must run one after another on one stream
    (:func:`decode_loop_step`): two at once would share the counters and a
    block could wait forever.  Another engine's launches use their own."""
    max_chunks = (cfg.n_ctx - 1) // CHUNK_MIN + 1
    key = (device, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ctx)
    scratch = _scratch(params)
    entry = scratch.get(key)
    if entry is None:
        part = torch.empty(cfg.n_heads * (max_chunks * (cfg.head_dim + 2) + cfg.n_ctx),
                           dtype=torch.float32, device=device)
        cnt = torch.zeros(2 * cfg.n_kv_heads, dtype=torch.int32, device=device)
        entry = scratch[key] = (part, cnt, max_chunks)
    return entry


def split_attention_plain(q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor, pos: int,
                          cfg, chunk: int, cks: torch.Tensor | None = None,
                          cvs: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's attention decomposition in plain PyTorch, for the tests
    (the main path never calls it): one decode query at ring slot ``pos``
    over the keys [lo, pos] of a layer's ring, split into chunks of
    ``chunk`` slots aligned to multiples of ``chunk``.  q (1, H, hd) bf16
    after RoPE; kk, vv (n_kv, n_ctx, hd) the layer's ring with slot ``pos``
    written (bf16, or int8 with ``cks``/``cvs`` (n_kv, n_ctx) scales).

    Step 1, per chunk and query head: scores s = (q·k)·hd^-0.5 [· k_s] in
    f32, the chunk's max m and sum l = Σ exp(s − m).  Step 2: the head's
    M = max m and L = Σ l·exp(m − M); per chunk p = bf16(exp(s − M) / L
    [· v_s]) and o = p·v in f32; ctx = bf16(Σ o) over the chunks.
    → (1, H·hd) bf16."""
    n_kv, hd = cfg.n_kv_heads, cfg.head_dim
    group = cfg.n_heads // n_kv
    lo = max(0, pos - cfg.sliding_window + 1) if cfg.sliding_window else 0
    qg = q.reshape(n_kv, group, hd).float()
    chunks = [(max(lo, c * chunk), min(pos + 1, (c + 1) * chunk))
              for c in range(lo // chunk, pos // chunk + 1)]
    scores, ms, ls = [], [], []
    for c0, c1 in chunks:
        s = torch.matmul(qg, kk[:, c0:c1].float().transpose(-1, -2)) * hd ** -0.5
        if cks is not None:
            s = s * cks[:, None, c0:c1]
        m = s.amax(-1, keepdim=True)                                # (n_kv, g, 1)
        scores.append(s)
        ms.append(m)
        ls.append(torch.exp(s - m).sum(-1, keepdim=True))
    m = torch.stack(ms)                                             # (chunks, n_kv, g, 1)
    M = m.amax(0)
    L = (torch.stack(ls) * torch.exp(m - M)).sum(0)
    ctx = torch.zeros(n_kv, group, hd, device=q.device)
    for s, (c0, c1) in zip(scores, chunks):
        p = torch.exp(s - M) / L
        if cvs is not None:
            p = p * cvs[:, None, c0:c1]
        ctx = ctx + torch.matmul(p.to(torch.bfloat16).float(), vv[:, c0:c1].float())
    return ctx.to(torch.bfloat16).reshape(1, cfg.n_heads * hd)


def decode_loop_plain(params, cache: dict, h: torch.Tensor, positions: torch.Tensor,
                      layer0: int, cfg, fmts: dict, K: int) -> torch.Tensor:
    """Plain PyTorch version: layers ``[layer0, layer0 + K)`` of one decode
    token, one after the other, through the per-layer source with the
    plain KV quantize.  h (1, dim) bf16 → h; the ring slots at
    ``positions`` (1,) are written in place."""
    from ..models.llama import _layer
    from .kvquant import kv_quantize_plain

    rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(layer0, layer0 + K):
        h = _layer(h, params.layers[i], i, cache, positions, None, cfg, rope,
                   quantize=kv_quantize_plain)
    return h


def decode_loop_step(params, cache: dict, h: torch.Tensor, positions: torch.Tensor,
                     layer0: int, cfg, fmts: dict, K: int) -> torch.Tensor:
    """Layers ``[layer0, layer0 + K)`` of one decode token at the ring slot
    ``positions`` ((1,) int64 on h's device, read by the kernel, never on
    the host): h (1, dim) bf16 → the new h; each layer's K/V slot there is
    written into ``cache`` in place.  ``fmts`` is the weight plan
    (:func:`models.params.decode_loop_plan`).  One kernel launch for CUDA
    tensors, the plain version for CPU ones.

    The grid barrier's counter and the attention's scratch and counters are
    one set per weights object (and device and geometry), not per stream,
    so every launch of one engine must follow its last on one stream —
    never two streams at once; two engines (a multi-model registry) hold
    two sets.  The engines keep that rule: a serial engine runs under its lock
    on the current stream; a lane step runs this kernel once per lane, the
    lanes one after another inside one graph replayed on that stream (the
    capture stream is joined to it before and after); a cycle engine's
    batch and its serial streams both hold the engine's lock; and a
    continuous engine makes every device call on its one scheduler
    thread."""
    L = cfg.n_layers
    if not (K >= 1 and 0 <= layer0 and layer0 + K <= L):
        raise ValueError(f"decode_loop: layers {layer0}..{layer0 + K} outside 0..{L}")
    if positions.shape != (1,) or positions.dtype != torch.int64:
        raise ValueError(f"decode_loop: positions {tuple(positions.shape)} "
                         f"{positions.dtype}, expected (1,) int64")
    if tuple(h.shape) != (1, cfg.dim):
        raise ValueError(f"decode_loop: h is {tuple(h.shape)}, expected (1, {cfg.dim})")
    if h.device.type == "cpu":
        return decode_loop_plain(params, cache, h, positions, layer0, cfg, fmts, K)
    kinds = set(fmts.values())
    if len(kinds) != 1 or not kinds <= {"bf16", "int8"}:
        raise ValueError(f"decode_loop: the kernel takes one weight kind, bf16 or "
                         f"int8, for every linear; got {fmts}")
    hd = cfg.head_dim
    if (hd not in HEAD_DIMS or cfg.n_heads * hd != cfg.dim or cfg.n_heads % cfg.n_kv_heads
            or cfg.dim % 16 or cfg.ffn_dim % 16):
        raise ValueError(f"decode_loop: unsupported geometry dim {cfg.dim}, ffn "
                         f"{cfg.ffn_dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {hd}")
    w_int8 = kinds == {"int8"}
    kv_int8 = cfg.kv_dtype == "int8"
    ring_shape = (L, cfg.n_kv_heads, cfg.n_ctx, hd)
    if kv_int8:
        ring = (cache["k_q"], cache["v_q"], cache["k_s"], cache["v_s"])
        dtypes = (torch.int8, torch.int8, torch.float32, torch.float32)
        shapes = (ring_shape, ring_shape, ring_shape[:-1], ring_shape[:-1])
    else:
        ring = (cache["k"], cache["v"])
        dtypes = (torch.bfloat16, torch.bfloat16)
        shapes = (ring_shape, ring_shape)
    for t, shape in zip(ring, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_loop: ring leaf {tuple(t.shape)}, expected {shape}")
    h = h.reshape(-1).clone()
    positions = positions.contiguous()
    require_cuda("decode_loop", h, positions, *ring,
                 dtypes=(torch.bfloat16, torch.int64, *dtypes))
    table = _weight_table(params, cfg, w_int8)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    kvd = cfg.n_kv_heads * hd
    qkv = torch.empty(cfg.dim + 2 * kvd, dtype=torch.bfloat16, device=h.device)
    ctx = torch.empty(cfg.dim, dtype=torch.bfloat16, device=h.device)
    act = torch.empty(cfg.ffn_dim, dtype=torch.bfloat16, device=h.device)
    ks, vs = (ring[2].data_ptr(), ring[3].data_ptr()) if kv_int8 else (None, None)
    part, cnt, max_chunks = _attention_scratch(params, h.device, cfg)
    check(library().lfkt_decode_loop(
        table.data_ptr(), h.data_ptr(), ring[0].data_ptr(), ring[1].data_ptr(), ks, vs,
        qkv.data_ptr(), ctx.data_ptr(), act.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        positions.data_ptr(), _barrier(params, h.device).data_ptr(), part.data_ptr(), cnt.data_ptr(),
        layer0, K, cfg.dim, cfg.ffn_dim, cfg.n_heads, cfg.n_kv_heads, hd, cfg.n_ctx,
        cfg.sliding_window,
        max_chunks, cfg.rms_eps, hd ** -0.5, int(w_int8), int(kv_int8), stream_ptr(h)),
        "decode_loop")
    decode_loop_step.launches += 1
    return h.reshape(1, cfg.dim)


decode_loop_step.launches = 0


def forward_layers_looped(params, cfg, h: torch.Tensor, positions: torch.Tensor,
                          cache: dict, K: int, fmts: dict) -> torch.Tensor:
    """The layer stack of one decode token at the ring slot ``positions``
    (1,) as L/K launches of :func:`decode_loop_step`, in order.  ``K``
    divides ``n_layers`` (:func:`effective_unroll`) and ``fmts`` is the
    weight plan."""
    for layer0 in range(0, cfg.n_layers, K):
        h = decode_loop_step(params, cache, h, positions, layer0, cfg, fmts, K)
    return h

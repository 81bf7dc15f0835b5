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
- :func:`forward_layers_looped` — the L/K launches of a decode step;
- :func:`forward_layers_looped_mesh` — the same over one dp group's tp
  shards (``parallel.mesh.MeshParams`` and a ``ShardedRing``), every shard
  on the launching card: the kernel reads each layer's weights and kv
  heads from their shards in one launch (:func:`describe_shards` says
  where each lies; :func:`read_shards_plain` reads them back whole, as the
  kernel indexes them, for the tests).  A shard on another device raises:
  a mesh over distinct cards is not served.

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
#: tp shards one launch reads, at most (csrc/decode_loop.cu MAX_TP)
MAX_TP = 8
#: the kernel's code of each sharding mode (csrc/decode_loop.cu M_*)
_MODE_CODES = {"rep": 0, "col": 1, "row": 2}


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


def describe_shards(params, cfg, ring=None) -> dict:
    """Where the looped kernel finds one dp group's layer stack: a pure
    description of the shards, no device work.

    ``params`` is a ``LlamaParams`` (one device: tp = 1, every linear
    ``rep``) or a ``parallel.mesh.MeshParams`` with ``ring`` a serial
    ``ShardedRing`` of one dp group (sp = 1).  Returns

    - ``tp``, ``group`` (the dp group) and ``modes``: each of
      :data:`models.params.LOOP_LINEARS`' layout over tp (``col``: its N
      rows split, ``row``: its K columns split, ``rep``: whole on every
      shard; ``MeshParams.layout``);
    - ``layers``: per layer, ``linears`` (name → its ``Linear`` on each
      shard, in tp order) and the two norms, read from shard 0;
    - ``kv_split`` and ``heads``: for each whole kv head j, ``(shard,
      local, writes)``: the shard it is read from, its index there, and
      every shard whose ring holds it and must be written (split heads:
      shard ``j // (n_kv/tp)`` alone; heads tp does not divide: read from
      shard 0, written to all)."""
    from ..models.params import LOOP_LINEARS
    from ..parallel.mesh import MeshParams

    if not isinstance(params, MeshParams):
        shards, tp, group, split = [params], 1, 0, False
        modes = dict.fromkeys(LOOP_LINEARS, "rep")
    else:
        if ring is None or ring.lanes or len(ring.dp_groups) != 1 \
                or any(c[2] for c in ring.coords):
            raise ValueError("decode_loop: a mesh's looped decode takes one dp group's "
                             "serial tp ring (sp = 1); take a lane's with lane(b)")
        tp = params.mesh.shape["tp"]
        group = ring.coords[0][0]
        if [c[1] for c in ring.coords] != list(range(tp)):
            raise ValueError(f"decode_loop: ring shards {ring.coords}, expected tp 0..{tp - 1}")
        shards = [params.shard(group, t, 0) for t in range(tp)]
        split = bool(params.tp_heads and ring.tp_split)
        modes = {n: params.layout[n] for n in LOOP_LINEARS}
    layers = [{"linears": {n: [getattr(p.layers[i], n) for p in shards] for n in LOOP_LINEARS},
               "attn_norm": shards[0].layers[i].attn_norm,
               "ffn_norm": shards[0].layers[i].ffn_norm}
              for i in range(len(shards[0].layers))]
    n_kv = cfg.n_kv_heads
    if split:
        per = n_kv // tp
        heads = [(j // per, j % per, (j // per,)) for j in range(n_kv)]
    else:
        heads = [(0, j, tuple(range(tp))) for j in range(n_kv)]
    return {"tp": tp, "group": group, "modes": modes, "layers": layers,
            "kv_split": split, "heads": heads}


def read_shards_plain(desc: dict, parts: list) -> tuple[list, dict]:
    """The plain reader of a shard description, for the tests (the main
    path never calls it): each layer's whole weights, name → ``(weight,
    scale)``, and the whole-head ring (every leaf of ``parts``, the
    shards' ring dicts, back to ``(L, n_kv, n_ctx, hd)``), each element
    read where the kernel reads it — output row r of a ``col`` linear from
    shard ``r // (N/tp)`` at row ``r % (N/tp)``, input column c of a
    ``row`` linear from shard ``c // (K/tp)`` at column ``c % (K/tp)`` (an
    int8 row's scale whole on shard 0), a ``rep`` linear and the norms
    from shard 0, kv head j from ``desc["heads"][j]``'s read shard."""
    def whole(mode, xs, scale):
        if mode == "col":
            nt = xs[0].shape[0]
            r = torch.arange(nt * len(xs))
            return torch.stack(xs)[r // nt, r % nt]
        if mode == "row" and not scale:
            kt = xs[0].shape[1]
            c = torch.arange(kt * len(xs))
            return torch.stack(xs)[c // kt, :, c % kt].transpose(0, 1).contiguous()
        return xs[0]

    layers = []
    for layer in desc["layers"]:
        out = {}
        for name, lins in layer["linears"].items():
            mode = desc["modes"][name]
            scales = [lin.scale for lin in lins]
            out[name] = (whole(mode, [lin.weight for lin in lins], False),
                         None if scales[0] is None else whole(mode, scales, True))
        layers.append(out)
    ring = {leaf: torch.stack([parts[t][leaf][:, jl] for t, jl, _ in desc["heads"]], dim=1)
            for leaf in parts[0]}
    return layers, ring


def _description(params, cfg, ring) -> dict:
    """:func:`describe_shards`, kept per params object and dp group."""
    from ..parallel.mesh import ShardedRing

    key = ("shards", ring.coords[0][0], ring.tp_split) if isinstance(ring, ShardedRing) \
        else ("shards",)
    entry = _entry(params)
    if key not in entry:
        entry[key] = describe_shards(params, cfg,
                                     ring if isinstance(ring, ShardedRing) else None)
    return entry[key]


def _shard_table(params, desc: dict, cfg, int8: bool, device: torch.device) -> torch.Tensor:
    """(L, tp, 16) int64 on ``device``, the launching card: for each layer
    and shard its seven weight planes, their seven int8 scale vectors (0
    for bf16) and its two norms, by address — at tp = 1 the one-device
    table, (L, 16).  Built once per params object and dp group, each
    shard's shape, dtype and device checked as it is built: a shard on
    another device raises."""
    from ..models.params import LOOP_LINEARS

    entry = _entry(params)
    key = ("table", desc["group"])
    table = entry.get(key)
    if table is not None:
        if table.device != device:
            raise ValueError(f"decode_loop: the weight table is on {table.device}, the "
                             f"launch on {device}")
        return table
    tp = desc["tp"]
    kvd = cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (cfg.dim, cfg.dim), "wk": (kvd, cfg.dim), "wv": (kvd, cfg.dim),
              "wo": (cfg.dim, cfg.dim), "w_gate": (cfg.ffn_dim, cfg.dim),
              "w_up": (cfg.ffn_dim, cfg.dim), "w_down": (cfg.dim, cfg.ffn_dim)}
    wdtype = torch.int8 if int8 else torch.bfloat16
    probe = torch.empty(0, device=device)
    rows = []
    for i, layer in enumerate(desc["layers"]):
        per_shard = []
        for t in range(tp):
            lins = [layer["linears"][n][t] for n in LOOP_LINEARS]
            for n, lin in zip(LOOP_LINEARS, lins):
                mode = desc["modes"][n]
                N, K = shapes[n]
                want = {"col": (N // tp, K), "row": (N, K // tp), "rep": (N, K)}[mode]
                if tuple(lin.weight.shape) != want:
                    raise ValueError(f"decode_loop: layer {i} {n} shard {t} ({mode}) is "
                                     f"{tuple(lin.weight.shape)}, expected {want}")
                require_cuda(f"decode_loop: layer {i} {n} shard {t}", probe, lin.weight,
                             dtypes=(None, wdtype))
                if int8:
                    rows_n = N // tp if mode == "col" else N
                    if tuple(lin.scale.shape) != (rows_n,):
                        raise ValueError(f"decode_loop: layer {i} {n} shard {t} scale is "
                                         f"{tuple(lin.scale.shape)}, expected ({rows_n},)")
                    require_cuda(f"decode_loop: layer {i} {n} shard {t} scale", probe,
                                 lin.scale, dtypes=(None, torch.float32))
            norms = (layer["attn_norm"], layer["ffn_norm"])
            require_cuda(f"decode_loop: layer {i} norms", probe, *norms,
                         dtypes=(None, torch.float32, torch.float32))
            per_shard.append([lin.weight.data_ptr() for lin in lins]
                             + [lin.scale.data_ptr() if int8 else 0 for lin in lins]
                             + [x.data_ptr() for x in norms])
        rows.append(per_shard)
    table = torch.tensor(rows, dtype=torch.int64).to(device)
    entry[key] = table
    return table


def _modes(desc: dict) -> int:
    """The kernel's ``modes`` word: linear w's code at bits 2w, 2w + 1."""
    from ..models.params import LOOP_LINEARS

    if desc["tp"] > 1 and any(desc["modes"][n] == "row" for n in LOOP_LINEARS
                              if n not in ("wo", "w_down")):
        raise ValueError(f"decode_loop: only wo and w_down split K, got {desc['modes']}")
    return sum(_MODE_CODES[desc["modes"][n]] << (2 * w) for w, n in enumerate(LOOP_LINEARS))


def _scratch(params) -> dict:
    entry = _SCRATCH.get(params)
    if entry is None:
        entry = _SCRATCH[params] = {}
    return entry


def _barrier(params, device: torch.device, group: int) -> torch.Tensor:
    scratch = _scratch(params)
    key = ("bar", device, group)
    bar = scratch.get(key)
    if bar is None:
        bar = scratch[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return bar


def _attention_scratch(params, device: torch.device, group: int, cfg) -> tuple:
    """(partials, counters, max_chunks) of the kernel's attention phase:
    per query head and key chunk the chunk's P·V sums (hd f32) and its
    (max, sum), then per query head its scores over the ring — f32,
    n_heads × (max_chunks × (hd + 2) + n_ctx) — and two arrival counters
    per KV head, which every launch returns to zero.

    One set per weights object (a mesh's: per dp group), device and
    geometry, shared by every launch of that engine — the per-lane launches
    of a lane step included — so an engine's launches must run one after
    another on one stream (:func:`decode_loop_step`): two at once would
    share the counters and a block could wait forever.  Another engine's
    launches use their own."""
    max_chunks = (cfg.n_ctx - 1) // CHUNK_MIN + 1
    key = (device, group, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ctx)
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
    ``positions`` (1,) are written in place.  Over a mesh (``cache`` a
    ``ShardedRing``) :func:`decode_loop_mesh_plain`."""
    from ..models.llama import _layer
    from ..parallel.mesh import ShardedRing
    from .kvquant import kv_quantize_plain

    if isinstance(cache, ShardedRing):
        return decode_loop_mesh_plain(params, cache, h, positions, layer0, cfg, K)
    rope = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(layer0, layer0 + K):
        h = _layer(h, params.layers[i], i, cache, positions, None, cfg, rope,
                   quantize=kv_quantize_plain)
    return h


def decode_loop_mesh_plain(mp, ring, h: torch.Tensor, positions: torch.Tensor, layer0: int,
                           cfg, K: int) -> torch.Tensor:
    """Plain PyTorch version over a mesh: layers ``[layer0, layer0 + K)`` of
    one decode token through the per-layer mesh source
    (``models.llama._tp_layers``: each shard's local heads, the gathers and
    the row-parallel sums of ``_Shards``) with the plain KV quantize, over
    ``ring``, one dp group's serial tp ring, written in place.  h (1, dim)
    bf16 → h.  On the CPU it is the per-layer ``forward_mesh`` bit for
    bit."""
    from ..models.llama import _local_cfg, _PerDevice, _Shards, _tp_layers
    from .kvquant import kv_quantize_plain

    d = ring.coords[0][0]
    g = _Shards.of(mp, d, 0)
    heads_split = mp.tp_heads and ring.tp_split
    parts = [ring.part(ring.index(d, t, 0)) for t in range(g.tp)]
    hs = _tp_layers(g, [h.to(dev) for dev in g.devs], range(layer0, layer0 + K), parts,
                    _PerDevice(positions, cfg), None, _local_cfg(cfg, g.tp, heads_split),
                    heads_split, cfg.rms_eps, quantize=kv_quantize_plain)
    return hs[0]


def decode_loop_step(params, cache: dict, h: torch.Tensor, positions: torch.Tensor,
                     layer0: int, cfg, fmts: dict, K: int) -> torch.Tensor:
    """Layers ``[layer0, layer0 + K)`` of one decode token at the ring slot
    ``positions`` ((1,) int64 on h's device, read by the kernel, never on
    the host): h (1, dim) bf16 → the new h; each layer's K/V slot there is
    written into ``cache`` in place.  ``fmts`` is the weight plan
    (:func:`models.params.decode_loop_plan`).  One kernel launch for CUDA
    tensors, the plain version for CPU ones.

    ``params`` and ``cache`` are one device's weights and ring, or a
    ``MeshParams`` and one dp group's serial ``ShardedRing``: the launch
    then reads each layer and kv head from its tp shard
    (:func:`describe_shards`), every shard on h's card — a shard elsewhere
    raises.  The one-device launch is the tp = 1 case of the same launch.

    The grid barrier's counter and the attention's scratch and counters are
    one set per weights object (a mesh's: per dp group; and device and
    geometry), not per stream, so every launch of one engine must follow
    its last on one stream — never two streams at once; two engines (a
    multi-model registry) hold two sets.  The engines keep that rule: a
    serial engine runs under its lock on the current stream; a lane step
    runs this kernel once per lane, the lanes (and a mesh's dp groups) one
    after another inside one graph replayed on that stream (the capture
    stream is joined to it before and after); a cycle engine's batch and
    its serial streams both hold the engine's lock; and a continuous engine
    makes every device call on its one scheduler thread."""
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
    from ..parallel.mesh import ShardedRing

    desc = _description(params, cfg, cache)
    tp = desc["tp"]
    if tp > MAX_TP:
        raise ValueError(f"decode_loop: tp={tp} over {MAX_TP} shards")
    w_int8 = kinds == {"int8"}
    kv_int8 = cfg.kv_dtype == "int8"
    n_kv = cfg.n_kv_heads // tp if desc["kv_split"] else cfg.n_kv_heads
    ring_shape = (L, n_kv, cfg.n_ctx, hd)
    names = ("k_q", "v_q", "k_s", "v_s") if kv_int8 else ("k", "v")
    dtypes = ((torch.int8, torch.int8, torch.float32, torch.float32) if kv_int8
              else (torch.bfloat16, torch.bfloat16))
    shapes = ((ring_shape, ring_shape, ring_shape[:-1], ring_shape[:-1]) if kv_int8
              else (ring_shape, ring_shape))
    parts = ([{n: cache[n][t] for n in names} for t in range(tp)]
             if isinstance(cache, ShardedRing) else [cache])
    h = h.reshape(-1).clone()
    rows = []
    for t, part in enumerate(parts):
        ring = [part[n] for n in names]
        for x, shape in zip(ring, shapes):
            if tuple(x.shape) != shape:
                raise ValueError(f"decode_loop: ring shard {t} leaf {tuple(x.shape)}, "
                                 f"expected {shape}")
        require_cuda(f"decode_loop: ring shard {t}", h, *ring,
                     dtypes=(torch.bfloat16, *dtypes))
        rows.append([x.data_ptr() for x in ring] + [0] * (4 - len(ring)))
    # the shards' ring leaves by address: read by the launcher on the host
    ring_table = torch.tensor(rows, dtype=torch.int64)
    positions = positions.contiguous()
    require_cuda("decode_loop", h, positions, dtypes=(torch.bfloat16, torch.int64))
    table = _shard_table(params, desc, cfg, w_int8, h.device)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    kvd = cfg.n_kv_heads * hd
    qkv = torch.empty(cfg.dim + 2 * kvd, dtype=torch.bfloat16, device=h.device)
    ctx = torch.empty(cfg.dim, dtype=torch.bfloat16, device=h.device)
    act = torch.empty(cfg.ffn_dim, dtype=torch.bfloat16, device=h.device)
    group = desc["group"]
    part, cnt, max_chunks = _attention_scratch(params, h.device, group, cfg)
    check(library().lfkt_decode_loop(
        table.data_ptr(), h.data_ptr(), ring_table.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
        act.data_ptr(), cos.data_ptr(), sin.data_ptr(), positions.data_ptr(),
        _barrier(params, h.device, group).data_ptr(), part.data_ptr(), cnt.data_ptr(),
        layer0, K, cfg.dim, cfg.ffn_dim, cfg.n_heads, cfg.n_kv_heads, hd, cfg.n_ctx,
        cfg.sliding_window, max_chunks, tp, _modes(desc), int(desc["kv_split"]),
        cfg.rms_eps, hd ** -0.5, int(w_int8), int(kv_int8), stream_ptr(h)),
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


def forward_layers_looped_mesh(mp, cfg, h: list, positions: torch.Tensor, ring, K: int,
                               fmts: dict) -> list:
    """:func:`forward_layers_looped` over one dp group's tp shards: ``h``
    the token's (1, dim) rows replicated over the shards, ``ring`` the
    group's serial ``ShardedRing`` (sp = 1), ``positions`` (1,) on the
    first shard's device.  The L/K launches read every shard (every shard
    on that card); the new h is replicated over the shards again."""
    x = forward_layers_looped(mp, cfg, h[0], positions, ring, K, fmts)
    return [x.to(ring.mesh.device(*c)) for c in ring.coords]

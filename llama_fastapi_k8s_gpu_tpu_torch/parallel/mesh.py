"""Device meshes, sharding rules and the collectives between shards.

The port of the JAX package's ``parallel/mesh.py``.  There a ``Mesh`` of
chips and ``NamedSharding`` annotations were enough: XLA inserted the
collectives.  Here one controller drives every shard itself:

- a :class:`Mesh` is a (dp, tp, sp) grid of ``torch.device`` s with the
  axis names ``("dp", "tp", "sp")``.  :func:`make_mesh` takes the cards
  by default and raises when there are too few; an explicit device list
  may repeat a device (tests pass ``[cpu] * n``, ``chip_smoke.py``
  ``[cuda:0] * n``), which is the counterpart of the JAX tests' virtual
  CPU devices;
- a sharded value is the list of its per-device shards, each a tensor of
  its own on its device;
- the collectives are plain functions over such lists: :func:`all_gather`
  (an all-gather over an axis), :func:`all_sum` (``psum``),
  :func:`all_max` (``pmax``) and :func:`ring_pass` (the ring's neighbour
  pass, ``ppermute``).

The sharding rules are the JAX package's, over the port's layouts (a
linear is one (N, ·) plane of bf16, int8 or GGUF block rows,
``ops/linear.py``):

- column-parallel ``wq``/``wk``/``wv``/``w_gate``/``w_up`` shard their
  output rows N over ``tp``;
- row-parallel ``wo``/``w_down`` shard their input columns K in bf16 and
  int8 (an int8 weight's per-row scales stay whole); the partial products
  are summed;
- the fused layouts (Q4_K/Q5_K/Q6_K/Q8_0 block rows) shard N in both
  cases, with the activations gathered: the kernels never split K, and
  at decode gathering a few KB of activations beats gathering the weights;
- the LM head shards over the vocabulary; ``tok_emb`` and the norms are
  replicated;
- an axis that does not divide its dim is dropped (:func:`fit_shardings`);
  a fused weight keeps its N sharding whenever N divides, since the
  port's kernels take any whole number of rows.

The KV ring shards its kv heads over ``tp`` (a lane ring its lanes over
``dp`` too, the sequence-parallel ring its slots over ``sp``): a
:class:`ShardedRing` holds each leaf as its list of shards, and
:meth:`ShardedRing.head_shards` maps a whole-head slice of it onto one dp
group's tp shards and back (the paged pool keeps whole-head pages).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch import nn

from ..models.config import ModelConfig
from ..ops.linear import Linear

AXES = ("dp", "tp", "sp")

#: column-parallel and row-parallel linears, by the port's layer names
COL_LINEARS = ("wq", "wk", "wv", "w_gate", "w_up")
ROW_LINEARS = ("wo", "w_down")
#: the kinds whose weight is GGUF block rows: they shard N only
FUSED = ("q4k", "q5k", "q6k", "q8")


class Mesh:
    """A (dp, tp, sp) grid of devices.  ``devices[d, t, s]`` is the
    device of coordinate (d, t, s); a device may appear more than once."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError(f"a mesh is a (dp, tp, sp) grid, got shape {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, d: int = 0, t: int = 0, s: int = 0) -> torch.device:
        return self.devices[d, t, s]

    @property
    def distinct(self) -> list:
        """The mesh's devices, each once, in mesh order."""
        out = []
        for dev in self.devices.flat:
            if dev not in out:
                out.append(dev)
        return out

    def label(self, coord: tuple) -> str:
        """A shard's name in per-device accounting: ``dp0.tp1.sp0:cuda:0``."""
        d, t, s = coord
        return f"dp{d}.tp{t}.sp{s}:{self.device(d, t, s)}"

    def describe(self) -> dict:
        """The geometry for /debug/requests, traces and /health."""
        return {**self.shape, "devices": self.size,
                "distinct_devices": len(self.distinct),
                "device_list": [str(d) for d in self.devices.flat]}

    def __repr__(self) -> str:
        dp, tp, sp = self.devices.shape
        return f"Mesh(dp={dp}, tp={tp}, sp={sp}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, devices=None) -> Mesh:
    """dp × tp × sp device mesh over the first dp·tp·sp of ``devices``.
    With no list it takes every card (``torch.cuda.device_count()``); an
    explicit list may repeat a device.  Too few devices raise
    ``ValueError``, as the JAX package's ``make_mesh`` does."""
    if min(dp, tp, sp) < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp} tp={tp} sp={sp}")
    if devices is None:
        devices = default_devices(torch.device("cuda"))
    devices = [torch.device(d) for d in devices]
    n = dp * tp * sp
    if n > len(devices):
        raise ValueError(f"mesh {dp}x{tp}x{sp} needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(dp, tp, sp))


def default_devices(device: torch.device) -> list:
    """The devices an engine's mesh takes when it is given none: every
    card for a CUDA engine, the CPU alone for a CPU one."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


# ---------------------------------------------------------------------------
# collectives over a list of shards (one per device of an axis)
# ---------------------------------------------------------------------------

def all_gather(parts: list, dim: int, devices: list) -> list:
    """Concatenate ``parts`` along ``dim`` and give every device a copy."""
    full = torch.cat([p.to(devices[0]) for p in parts], dim)
    return [full.to(dev) for dev in devices]


def all_sum(parts: list, devices: list, dtype=None) -> list:
    """The elementwise sum of ``parts`` (``psum``) on every device.  Float
    shards are summed in f32 and rounded once to ``dtype`` (default: the
    shards' dtype); integer shards sum exactly."""
    dtype = dtype or parts[0].dtype
    acc_dtype = torch.float32 if parts[0].is_floating_point() else parts[0].dtype
    acc = parts[0].to(devices[0], acc_dtype)
    for p in parts[1:]:
        acc = acc + p.to(devices[0], acc_dtype)
    acc = acc.to(dtype)
    return [acc.to(dev) for dev in devices]


def all_max(parts: list, devices: list) -> list:
    """The elementwise maximum of ``parts`` (``pmax``) on every device."""
    acc = parts[0].to(devices[0])
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(devices[0]))
    return [acc.to(dev) for dev in devices]


def ring_pass(parts: list, devices: list) -> list:
    """One neighbour pass around the ring: shard ``j`` moves to device
    ``j + 1`` (mod n), the JAX ring's ``ppermute``."""
    n = len(parts)
    return [parts[(j - 1) % n].to(devices[j]) for j in range(n)]


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def _spec(name: str, kind: str) -> str:
    """The rule before fitting: the fused kinds shard N in both cases."""
    if name in ROW_LINEARS and kind not in FUSED:
        return "row"
    return "col"


def param_shardings(params) -> dict:
    """Linear name (the layer names and ``output``) → how it lays out over
    tp before fitting: ``"col"`` (its output rows N split), ``"row"`` (its
    input columns K split, the products summed) or ``"rep"`` (whole on
    every device); ``tok_emb`` and the norms are replicated."""
    out = {}
    for name in (*COL_LINEARS, *ROW_LINEARS):
        kinds = {getattr(layer, name).kind for layer in params.layers}
        if len(kinds) != 1:
            raise ValueError(f"linear {name!r} mixes kinds {sorted(kinds)} across layers")
        kind = kinds.pop()
        out[name] = _spec(name, kind)
    out["output"] = "col"
    return out


def _fits(lin: Linear, mode: str, tp: int) -> bool:
    if mode == "col":
        return lin.n_out % tp == 0
    if mode == "row":
        return lin.k_in % tp == 0
    return True


def fit_shardings(params, shardings: dict, tp: int) -> dict:
    """Drop a split that a linear's dim cannot honour (``"rep"`` instead):
    N % tp for ``col``, K % tp for ``row``, over every layer.  A fused
    weight is sharded whole or replicated whole; its rows are its only
    split, and the port's kernels take any whole number of them."""
    out = {}
    for name, mode in shardings.items():
        lins = ([params.output] if name == "output"
                else [getattr(layer, name) for layer in params.layers])
        out[name] = mode if tp > 1 and all(_fits(lin, mode, tp) for lin in lins) else "rep"
    return out


def shard_linear(lin: Linear, mode: str, tp: int, t: int, device) -> Linear:
    """Shard ``t`` of ``lin`` under ``mode``, copied onto ``device`` (each
    shard owns its storage, even where devices repeat)."""
    def own(x):
        return None if x is None else x.to(device, copy=True).contiguous()

    if mode == "rep":
        return Linear(lin.kind, own(lin.weight), lin.n_out, lin.k_in, scale=own(lin.scale))
    if mode == "col":
        n = lin.n_out // tp
        sl = slice(t * n, (t + 1) * n)
        scale = None if lin.scale is None else lin.scale[sl]
        return Linear(lin.kind, own(lin.weight[sl]), n, lin.k_in, scale=own(scale))
    if mode == "row":
        if lin.kind in FUSED:
            raise ValueError(f"a fused {lin.kind} weight never splits K")
        k = lin.k_in // tp
        return Linear(lin.kind, own(lin.weight[:, t * k:(t + 1) * k]), lin.n_out, k,
                      scale=own(lin.scale))
    raise ValueError(f"sharding mode must be col|row|rep, got {mode!r}")


class MeshParams(nn.Module):
    """A model's weights over a mesh: ``shards[(d, t, s)]`` is the
    ``LlamaParams`` that device (d, t, s) holds — tp-shard ``t``, the same
    on every dp and sp coordinate — and ``layout`` the fitted
    mode (:func:`param_shardings`) of each linear name."""

    def __init__(self, mesh: Mesh, shards: dict, layout: dict, tp_heads: bool):
        super().__init__()
        self.mesh = mesh
        self.layout = layout
        #: whether the attention heads shard over tp (n_heads and n_kv_heads
        #: divide it); the KV ring shards its kv heads exactly then
        self.tp_heads = tp_heads
        self.coords = list(shards)
        self.shard_list = nn.ModuleList([shards[c] for c in self.coords])

    def shard(self, d: int = 0, t: int = 0, s: int = 0):
        return self.shard_list[self.coords.index((d, t, s))]

    def nbytes(self) -> int:
        """Device bytes of every shard's weights, over the whole mesh."""
        return sum(p.nbytes() for p in self.shard_list)

    def whole_nbytes(self) -> int:
        """Bytes of the model the shards hold, each weight once: a split
        buffer summed over one row block's tp shards, a replicated one (the
        norms, ``tok_emb``, a ``rep`` linear, a row-parallel int8 weight's
        whole scale) counted from shard 0."""
        tp = self.mesh.shape["tp"]
        block = [dict(self.shard(0, t, 0).named_buffers()) for t in range(tp)]
        total = 0
        for name, buf in block[0].items():
            parts = name.split(".")
            lin = parts[-2] if parts[-1] in ("weight", "scale") else None
            mode = self.layout.get(lin, "rep")
            split = mode == "col" or (mode == "row" and parts[-1] == "weight")
            for b in (block if split else block[:1]):
                total += b[name].numel() * b[name].element_size()
        return total

    def nbytes_by_device(self) -> dict:
        """Weight bytes a shard, by :meth:`Mesh.label`."""
        return {self.mesh.label(c): p.nbytes() for c, p in zip(self.coords, self.shard_list)}

    def formats(self) -> dict:
        return self.shard_list[0].formats()


def shard_params(params, mesh: Mesh, cfg: ModelConfig | None = None) -> MeshParams:
    """``params`` (``LlamaParams``) laid over ``mesh`` by the fitted rules:
    one shard per device, each a copy on its device.  Attention heads shard
    over tp when ``cfg`` says ``n_heads`` and ``n_kv_heads`` divide it;
    otherwise the q/k/v projections are replicated too."""
    from ..models.params import Layer, LlamaParams

    tp = mesh.shape["tp"]
    layout = fit_shardings(params, param_shardings(params), tp)
    heads = cfg is None or (cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0)
    if not heads:
        for name in ("wq", "wk", "wv"):
            layout[name] = "rep"
    shards = {}
    for d, t, s in itertools.product(*(range(mesh.shape[a]) for a in AXES)):
        dev = mesh.device(d, t, s)

        def own(x):
            return x.to(dev, copy=True)

        layers = [Layer(attn_norm=own(layer.attn_norm), ffn_norm=own(layer.ffn_norm),
                        **{n: shard_linear(getattr(layer, n), layout[n], tp, t, dev)
                           for n in (*COL_LINEARS, *ROW_LINEARS)})
                  for layer in params.layers]
        out = shard_linear(params.output, layout["output"], tp, t, dev)
        shards[(d, t, s)] = LlamaParams(own(params.tok_emb), layers,
                                        own(params.out_norm), out)
    return MeshParams(mesh, shards, layout, heads)


# ---------------------------------------------------------------------------
# the KV ring over the mesh
# ---------------------------------------------------------------------------

class ShardedRing(dict):
    """A KV ring laid out over mesh devices: each leaf (``k``/``v``, or
    ``k_q``/``v_q``/``k_s``/``v_s``) maps to the list of its shards, shard
    ``i`` at mesh coordinate ``coords[i]`` = (d, t, s).  The shards of one
    dp group hold its kv heads split over tp (``tp_split``) and its slots
    split over sp; a lane ring (``lanes`` > 0) keeps the lanes of dp group
    ``d`` on that group's shards.  ``n_ctx`` is the logical ring length."""

    def __init__(self, leaves: dict, coords: list, mesh: Mesh, n_ctx: int,
                 tp_split: bool, lanes: int = 0):
        super().__init__(leaves)
        self.coords = list(coords)
        self.mesh = mesh
        self.n_ctx = n_ctx
        self.tp_split = tp_split
        self.lanes = lanes

    def index(self, d: int, t: int, s: int) -> int:
        return self.coords.index((d, t, s))

    def part(self, i: int) -> dict:
        """Shard ``i``'s ring: an ordinary ring dict on its device."""
        return {k: v[i] for k, v in self.items()}

    @property
    def dp_groups(self) -> list:
        return sorted({c[0] for c in self.coords})

    @property
    def device(self) -> torch.device:
        return self.mesh.device(*self.coords[0])

    def lane(self, b: int) -> "ShardedRing":
        """Lane ``b``'s ring: a serial ring over its dp group's shards,
        each shard a view of the lane-major shard."""
        if not self.lanes:
            raise ValueError("not a lane ring")
        per = self.lanes // len(self.dp_groups)
        d, local = divmod(b, per)
        idx = [i for i, c in enumerate(self.coords) if c[0] == d]
        return ShardedRing({k: [v[i][local] for i in idx] for k, v in self.items()},
                           [self.coords[i] for i in idx], self.mesh, self.n_ctx,
                           self.tp_split)

    def head_shards(self, write: bool) -> list:
        """Where the whole-head ring lives on this serial ring's tp shards:
        ``[(shard index, heads)]``, ``heads`` the slice of the whole ring's
        kv heads (dim 1 of every leaf, the int8 scales' too) that the shard
        holds.  Split heads: shard ``t`` holds ``[t·n_kv/tp, (t+1)·n_kv/tp)``.
        Heads that tp does not divide are replicated: a write goes to every
        shard, a read comes from shard 0.  The paged pool moves whole-head
        pages through this map (parallel/kvpool.py)."""
        if self.lanes:
            raise ValueError("head_shards takes a serial ring: take a lane's with lane(b)")
        if len({c[0] for c in self.coords}) != 1 or any(c[2] for c in self.coords):
            raise ValueError(f"head_shards takes one dp group's tp shards, got {self.coords}")
        if not self.tp_split:
            return [(i, slice(None)) for i in range(len(self.coords) if write else 1)]
        out = []
        for i, (_, t, _) in enumerate(self.coords):
            h = next(iter(self.values()))[i].shape[1]
            out.append((i, slice(t * h, (t + 1) * h)))
        return out


def _local_ring_shape(cfg: ModelConfig, mesh: Mesh, tp_split: bool) -> tuple:
    tp, sp = mesh.shape["tp"], mesh.shape["sp"]
    n_kv = cfg.n_kv_heads // tp if tp_split else cfg.n_kv_heads
    if cfg.n_ctx % sp:
        raise ValueError(f"n_ctx {cfg.n_ctx} must divide sp={sp}")
    return cfg.n_layers, n_kv, cfg.n_ctx // sp, cfg.head_dim


def _ring_leaves(cfg: ModelConfig, shape: tuple, device) -> dict:
    if cfg.kv_dtype == "int8":
        return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    if cfg.kv_dtype != "bf16":
        raise ValueError(f"kv_dtype must be bf16|int8, got {cfg.kv_dtype!r}")
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def init_sharded_cache(cfg: ModelConfig, mesh: Mesh, tp_split: bool = True,
                       lanes: int = 0) -> ShardedRing:
    """A fresh ring over the mesh.  Serial (``lanes`` = 0): dp group 0's
    tp × sp shards, each (L, n_kv/tp, n_ctx/sp, hd) — the JAX package's
    ``cache_shardings`` (tp) and ``sp_state_shardings`` (sp).  Lane-major
    (``lanes`` = B): every dp group's tp shards, each (B/dp, L, n_kv/tp,
    n_ctx, hd) — ``cache_shardings(batched=True)``."""
    shape = _local_ring_shape(cfg, mesh, tp_split)
    if lanes:
        dp = mesh.shape["dp"]
        if lanes % dp:
            raise ValueError(f"batch_size {lanes} must be divisible by dp={dp}")
        if mesh.shape["sp"] != 1:
            raise ValueError("lane rings do not shard over sp")
        shape = (lanes // dp, *shape)
        coords = [(dd, t, 0) for dd in range(dp) for t in range(mesh.shape["tp"])]
    else:
        coords = [(0, t, s) for t in range(mesh.shape["tp"]) for s in range(mesh.shape["sp"])]
    parts = [_ring_leaves(cfg, shape, mesh.device(*c)) for c in coords]
    return ShardedRing({k: [p[k] for p in parts] for k in parts[0]}, coords, mesh,
                       cfg.n_ctx, tp_split, lanes=lanes)


# ---------------------------------------------------------------------------
# ring helpers shared by plain rings (dict of tensors) and sharded ones
# ---------------------------------------------------------------------------

def ring_tensors(cache: dict) -> list:
    """Every tensor of a ring, shards flattened."""
    out = []
    for v in cache.values():
        out.extend(v if isinstance(v, list) else [v])
    return out


def ring_nbytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in ring_tensors(cache))


def ring_nbytes_by_device(cache: "ShardedRing") -> dict:
    """A sharded ring's bytes a shard, by :meth:`Mesh.label`."""
    return {cache.mesh.label(c): ring_nbytes(cache.part(i)) for i, c in enumerate(cache.coords)}


@torch.inference_mode()
def ring_zero_(cache: dict) -> None:
    for t in ring_tensors(cache):
        t.zero_()


def ring_n_ctx(cache: dict) -> int:
    """The ring's slot count (a serial ring's logical length)."""
    if isinstance(cache, ShardedRing):
        return cache.n_ctx
    return next(iter(cache.values())).shape[2]


def ring_device(cache: dict) -> torch.device:
    if isinstance(cache, ShardedRing):
        return cache.device
    return next(iter(cache.values())).device


@torch.inference_mode()
def ring_copy_(dst: dict, src: dict) -> None:
    """Copy ``src`` into ``dst`` in place, shard by shard (same layout)."""
    for k, v in dst.items():
        if isinstance(v, list):
            for a, b in zip(v, src[k]):
                a.copy_(b)
        else:
            v.copy_(src[k])

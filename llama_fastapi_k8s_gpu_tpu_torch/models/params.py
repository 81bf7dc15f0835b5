"""Parameter loading: GGUF tensors → per-layer PyTorch modules.

Formats (``ops.linear.Linear.kind``):

- ``bf16`` — every linear expanded once and held as a bf16 plane;
  2 B/weight (16 GB at 8B: fits the card).  Small models and the CPU
  tests;
- ``int8`` — every linear expanded to f32 and requantized per output row
  (``ops.linear.make_linear_int8``); 1 B/weight, ~8.5 GB at 8B with the
  bf16 embedding table;
- ``q4k`` — fused serving: Q4_K, Q5_K, Q6_K and Q8_0 tensors stay in their
  GGUF block bytes on the device (4.5 / 5.5 / 6.6 / 8.5 bit/weight) and run
  through the fused kernels (kinds ``q4k`` / ``q5k`` / ``q6k`` / ``q8``);
  any other linear takes the bf16 path.  Because a name's layers share one
  kernel, the choice is per tensor *name*: a name fuses when all its layers
  hold one fusable type, and a name that mixes K-quants (llama.cpp's
  Q4_K_M / Q5_K_M put some layers of attn_v and ffn_down on Q6_K) is
  promoted to the highest of them (Q4_K < Q5_K < Q6_K) — the other layers
  are requantized onto that grid.  A name mixing Q8_0 with anything else
  takes bf16 (the reference gives it int8: ROADMAP, "envelope
  difference").

Expansion happens on the device, as the reference's ``on_device`` load: a
Q4_K, Q5_K, Q6_K or Q8_0 tensor (``token_embd``, and every linear under
``bf16``/``int8``) is uploaded as its block bytes and expanded by that
format's dequant kernel — to bf16, or to f32 for the int8 requantization;
F16/F32 tensors are uploaded as they are and converted by torch; a BF16
tensor is uploaded as its raw 16-bit words and viewed as bf16 (bit-exact
with the reference's host decode, and no f32 plane on the host).  The
types with no kernel — Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, IQ4_NL, IQ4_XS —
go through the host codec (``gguf/quants.py``) to f32, as in the
reference, and are uploaded from there.  They are never fusable: under
``q4k`` a name holding one of them takes bf16 (the reference gives it
int8: ROADMAP, "envelope difference"), and under ``int8`` it requantizes
from the codec's f32.

:func:`decode_loop_plan` says whether loaded weights can serve the
layer-looped decode kernel (ops/decode_loop.py): only bf16 and int8
linears can.

GGUF tensor names follow llama.cpp: ``token_embd.weight``,
``blk.{i}.attn_{q,k,v,output}.weight``, ``blk.{i}.ffn_{gate,up,down}.weight``,
``blk.{i}.{attn,ffn}_norm.weight``, ``output_norm.weight``,
``output.weight`` (absent when embeddings are tied).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from ..gguf import GGMLType, GGUFFile
from ..gguf.constants import GGML_BLOCK_SIZES
from ..gguf.quants import quantize
from ..ops.dequant import dequant_q4_k, dequant_q5_k, dequant_q6_k, dequant_q8_0
from ..ops.linear import Linear, make_linear_int8
from ..utils.device import resolve_device
from .config import ModelConfig

logger = logging.getLogger(__name__)

#: GGML types with a fused kernel, and their Linear kinds
FUSED_KINDS = {GGMLType.Q4_K: "q4k", GGMLType.Q5_K: "q5k",
               GGMLType.Q6_K: "q6k", GGMLType.Q8_0: "q8"}
#: the K-quants a mixed name promotes among, coarsest first (the JAX
#: reference's ranking)
_K_RANK = {GGMLType.Q4_K: 0, GGMLType.Q5_K: 1, GGMLType.Q6_K: 2}
#: GGML types that expand on the device, by dequant kernel
_DEQUANT = {GGMLType.Q4_K: dequant_q4_k, GGMLType.Q5_K: dequant_q5_k,
            GGMLType.Q6_K: dequant_q6_k, GGMLType.Q8_0: dequant_q8_0}
#: GGML float types uploaded as they are
_FLOAT = {GGMLType.F16: np.float16, GGMLType.F32: np.float32}
#: the load formats
FORMATS = ("bf16", "int8", "q4k")

_LINEARS = {"attn_q": "wq", "attn_k": "wk", "attn_v": "wv",
            "attn_output": "wo", "ffn_gate": "w_gate", "ffn_up": "w_up",
            "ffn_down": "w_down"}
#: a layer's linear names, in the order the layer-looped decode kernel's
#: weight table lists them
LOOP_LINEARS = tuple(_LINEARS.values())


class Layer(nn.Module):
    """One transformer block's weights."""

    def __init__(self, attn_norm: torch.Tensor, ffn_norm: torch.Tensor,
                 **linears: Linear):
        super().__init__()
        self.register_buffer("attn_norm", attn_norm)
        self.register_buffer("ffn_norm", ffn_norm)
        for name in _LINEARS.values():
            setattr(self, name, linears[name])


class LlamaParams(nn.Module):
    """All weights of a Llama model: embedding table (bf16), per-layer
    blocks in an ``nn.ModuleList``, final norm and output head."""

    def __init__(self, tok_emb: torch.Tensor, layers: list[Layer],
                 out_norm: torch.Tensor, output: Linear):
        super().__init__()
        self.register_buffer("tok_emb", tok_emb)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("out_norm", out_norm)
        self.output = output

    def nbytes(self) -> int:
        """Device bytes of every weight."""
        return sum(b.numel() * b.element_size() for b in self.buffers())

    def formats(self) -> dict[str, str]:
        """Linear name → kind, as served (the /health ``weight_formats``)."""
        first = self.layers[0]
        out = {name: getattr(first, name).kind for name in _LINEARS.values()}
        out["output"] = self.output.kind
        return out


def fusable(ggml_type: GGMLType, n_out: int, k_in: int) -> bool:
    """Whether an (n_out, k_in) weight of ``ggml_type`` can run a fused
    kernel: a type with one, and whole blocks along each row (256-element
    super-blocks for the K-quants, 32-element blocks for Q8_0)."""
    return (ggml_type in FUSED_KINDS and n_out > 0
            and k_in % GGML_BLOCK_SIZES[ggml_type][0] == 0)


def _fused_names(gf: GGUFFile, cfg: ModelConfig) -> dict[str, GGMLType]:
    """Linear name → the one GGML type all its layers serve with.  Names
    with one fusable type keep it; names mixing K-quants promote to the
    highest ranked; anything else is absent (bf16)."""
    ok: dict[str, GGMLType] = {}
    for n in _LINEARS:
        ts = [gf[f"blk.{i}.{n}.weight"] for i in range(cfg.n_layers)]
        if not all(fusable(t.ggml_type, *reversed(t.shape)) for t in ts):
            continue
        types = {t.ggml_type for t in ts}
        if len(types) == 1:
            ok[n] = types.pop()
        elif types <= set(_K_RANK):
            ok[n] = max(types, key=_K_RANK.get)
    t = gf.tensors.get("output.weight")
    if t is not None and fusable(t.ggml_type, *reversed(t.shape)):
        ok["output"] = t.ggml_type
    return ok


def _expand(t, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One GGUF tensor → ``dtype`` on ``device``, shaped (out, in): block
    types through their dequant kernel, F16/F32 converted by torch, BF16 by
    a view of its raw words, any other type through the host codec."""
    shape = tuple(reversed(t.shape))
    if t.ggml_type in _DEQUANT:
        raw = torch.from_numpy(np.array(t.raw(), np.uint8)).to(device)
        return _DEQUANT[t.ggml_type](raw, dtype).reshape(shape)
    if t.ggml_type == GGMLType.BF16:
        words = torch.from_numpy(np.array(t.raw(), np.uint8).view(np.int16))
        return words.to(device).view(torch.bfloat16).to(dtype).reshape(shape)
    if t.ggml_type in _FLOAT:
        a = np.array(t.raw(), np.uint8).view(_FLOAT[t.ggml_type])
    else:
        a = np.ascontiguousarray(t.astype_f32(), np.float32)
    return torch.from_numpy(a).to(device).to(dtype).reshape(shape)


def load_params(gf: GGUFFile, cfg: ModelConfig, fmt: str = "bf16",
                device: str | torch.device | None = None) -> LlamaParams:
    """Load every tensor of ``gf`` onto ``device`` (default: the GPU; raises
    without one) in format ``fmt``: ``bf16``, ``int8``, or ``q4k`` (the
    fused formats — named, as in the JAX reference, after the first of
    them)."""
    if fmt not in FORMATS:
        raise ValueError(f"fmt must be {'|'.join(FORMATS)}, got {fmt!r}")
    device = resolve_device(device)
    fused = _fused_names(gf, cfg) if fmt == "q4k" else {}

    def lin(name: str) -> Linear:
        t = gf[name]
        n_out, k_in = tuple(reversed(t.shape))
        short = name.split(".")[-2] if name.startswith("blk.") else name.split(".")[0]
        target = fused.get(short)
        if target is None:
            if fmt == "int8":
                return make_linear_int8(_expand(t, device, torch.float32))
            return Linear("bf16", _expand(t, device, torch.bfloat16), n_out, k_in)
        raw = np.asarray(t.raw())
        if t.ggml_type != target:
            # K-quant promotion: requantize this layer onto the name's grid
            raw = quantize(t.astype_f32(), target)
        rows = torch.from_numpy(np.array(raw, np.uint8)).reshape(n_out, -1)
        return Linear(FUSED_KINDS[target], rows.to(device), n_out, k_in)

    def norm(name: str) -> torch.Tensor:
        return torch.from_numpy(np.array(gf[name].astype_f32(), np.float32)).to(device)

    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layers.append(Layer(
            attn_norm=norm(p + "attn_norm.weight"),
            ffn_norm=norm(p + "ffn_norm.weight"),
            **{short: lin(p + long + ".weight") for long, short in _LINEARS.items()}))
        logger.debug("loaded layer %d/%d", i + 1, cfg.n_layers)

    emb = _expand(gf["token_embd.weight"], device, torch.bfloat16)
    if cfg.tie_embeddings or "output.weight" not in gf.tensors:
        output = Linear("bf16", emb, cfg.vocab_size, cfg.dim)
    else:
        output = lin("output.weight")
    return LlamaParams(emb, layers, norm("output_norm.weight"), output)


def from_jax_params(tree: dict, cfg: ModelConfig,
                    device: str | torch.device | None = None) -> LlamaParams:
    """The JAX reference's param pytree, as numpy arrays, → the port's
    modules: stacked ``(L, …)`` leaves are split per layer, ``{"w"}``
    linears become bf16 :class:`Linear` s and ``{"q", "s"}`` linears int8
    ones, norms stay f32.  Tests use it to run both frameworks on the same
    weights.  A linear in one of the reference's fused TPU layouts raises
    ``ValueError`` naming it — load the GGUF file with :func:`load_params`
    instead."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                              dtype=dtype)

    def lin(leaf: dict, name: str, i: int | None = None) -> Linear:
        def at(a):
            return a if i is None else a[i]

        if "w" in leaf:
            w = np.asarray(at(leaf["w"]), np.float32)
            return Linear("bf16", t(w, torch.bfloat16), w.shape[0], w.shape[1])
        if set(leaf) == {"q", "s"}:
            q = np.asarray(at(leaf["q"]), np.float32)
            return Linear("int8", t(q, torch.int8), q.shape[0], q.shape[1],
                          scale=t(at(leaf["s"]), torch.float32))
        raise ValueError(f"from_jax_params: linear {name!r} holds {sorted(leaf)}, "
                         f"not a bf16 'w' or an int8 'q'/'s' (fused layouts do "
                         f"not cross; load the GGUF file with load_params)")

    st = tree["layers"]
    layers = [
        Layer(attn_norm=t(st["attn_norm"][i], torch.float32),
              ffn_norm=t(st["ffn_norm"][i], torch.float32),
              **{k: lin(st[k], f"layers.{k}", i) for k in LOOP_LINEARS})
        for i in range(cfg.n_layers)
    ]
    return LlamaParams(t(tree["tok_emb"], torch.bfloat16), layers,
                       t(tree["out_norm"], torch.float32),
                       lin(tree["output"], "output"))


def synth_params(cfg: ModelConfig, fmt: str = "bf16", seed: int = 0,
                 device: str | torch.device | None = None) -> LlamaParams:
    """Random weights with the structure :func:`load_params` gives in
    ``fmt`` (``bf16`` or ``int8``), drawn on ``device`` from ``seed``:
    linears N(0, 1/in), norms 1 + N(0, 0.1²), embedding N(0, 1/dim).  For
    kernel checks at real widths without a file (chip_smoke.py, the CUDA
    tests); its numbers are not the reference's ``synth_params``'."""
    if fmt not in ("bf16", "int8"):
        raise ValueError(f"fmt must be bf16|int8, got {fmt!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std

    def lin(n_out: int, k_in: int) -> Linear:
        w = randn(n_out, k_in, std=k_in ** -0.5)
        if fmt == "int8":
            return make_linear_int8(w)
        return Linear("bf16", w.to(torch.bfloat16), n_out, k_in)

    kvd = cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (cfg.dim, cfg.dim), "wk": (kvd, cfg.dim), "wv": (kvd, cfg.dim),
              "wo": (cfg.dim, cfg.dim), "w_gate": (cfg.ffn_dim, cfg.dim),
              "w_up": (cfg.ffn_dim, cfg.dim), "w_down": (cfg.dim, cfg.ffn_dim)}
    layers = [Layer(attn_norm=1 + randn(cfg.dim, std=0.1),
                    ffn_norm=1 + randn(cfg.dim, std=0.1),
                    **{n: lin(*shape) for n, shape in shapes.items()})
              for _ in range(cfg.n_layers)]
    emb = randn(cfg.vocab_size, cfg.dim, std=cfg.dim ** -0.5).to(torch.bfloat16)
    return LlamaParams(emb, layers, 1 + randn(cfg.dim, std=0.1), lin(cfg.vocab_size, cfg.dim))


def decode_loop_plan(params, cfg: ModelConfig):
    """The weight plan of the layer-looped decode kernel
    (ops/decode_loop.py): ``(fmts, None)`` — ``fmts`` maps each
    :data:`LOOP_LINEARS` name to ``"bf16"`` or ``"int8"`` — or ``(None,
    reason)`` when the loaded weights cannot serve it.  The reference's
    rule (llama_fastapi_k8s_gpu_tpu/models/params.py::decode_loop_plan):
    the fused Q4_K/Q5_K/Q6_K/Q8_0 layouts refuse, and the reason names the
    linear.  The port's kernel also takes one weight kind for a whole
    layer, so a plan that mixes bf16 and int8 linears refuses (no load
    format produces one)."""
    layers = getattr(params, "layers", None)
    if not layers:
        return None, "params carry no layers"
    if len(layers) != cfg.n_layers:
        return None, f"params have {len(layers)} layers but cfg.n_layers={cfg.n_layers}"
    fmts: dict[str, str] = {}
    for name in LOOP_LINEARS:
        kinds = {getattr(layer, name).kind for layer in layers
                 if isinstance(getattr(layer, name, None), Linear)}
        if len(kinds) != 1 or any(not hasattr(layer, name) for layer in layers):
            return None, f"linear {name!r} missing from params or of mixed kinds {sorted(kinds)}"
        kind = kinds.pop()
        if kind not in ("bf16", "int8"):
            return None, (
                f"linear {name!r} is a fused quantized layout (kind {kind!r}): "
                "the in-kernel fused K-quant matmul needs its block planes "
                "restacked per layer — serve per-layer decode")
        fmts[name] = kind
    if len(set(fmts.values())) > 1:
        return None, (f"linears mix bf16 and int8 ({fmts}): the looped kernel "
                      "takes one weight kind for a whole layer")
    return fmts, None

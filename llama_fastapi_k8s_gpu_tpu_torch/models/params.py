"""Parameter loading: GGUF tensors → per-layer PyTorch modules.

Formats (``ops.linear.Linear.kind``):

- ``bf16`` — every linear dequantized once on the host (numpy codecs) and
  held as a bf16 plane; 2 B/weight.  Small models and the CPU tests.
- ``q4k`` — fused serving: Q4_K, Q5_K, Q6_K and Q8_0 tensors stay in their
  GGUF block bytes on the device (4.5 / 5.5 / 6.6 / 8.5 bit/weight) and run
  through the fused kernels (kinds ``q4k`` / ``q5k`` / ``q6k`` / ``q8``);
  any other linear takes the bf16 path.  Because a name's layers share one
  kernel, the choice is per tensor *name*: a name fuses when all its layers
  hold one fusable type, and a name that mixes K-quants (llama.cpp's
  Q4_K_M / Q5_K_M put some layers of attn_v and ffn_down on Q6_K) is
  promoted to the highest of them (Q4_K < Q5_K < Q6_K) — the other layers
  are requantized onto that grid.  A name mixing Q8_0 with anything else
  takes bf16.

``token_embd`` of a Q4_K, Q5_K, Q6_K or Q8_0 file is uploaded as block
bytes and expanded to bf16 on the device by that format's dequant kernel.

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
from ..ops.linear import Linear
from ..utils.device import resolve_device
from .config import ModelConfig

logger = logging.getLogger(__name__)

#: GGML types with a fused kernel, and their Linear kinds
FUSED_KINDS = {GGMLType.Q4_K: "q4k", GGMLType.Q5_K: "q5k",
               GGMLType.Q6_K: "q6k", GGMLType.Q8_0: "q8"}
#: the K-quants a mixed name promotes among, coarsest first (the JAX
#: reference's ranking)
_K_RANK = {GGMLType.Q4_K: 0, GGMLType.Q5_K: 1, GGMLType.Q6_K: 2}
#: GGML types whose token_embd expands on the device, by dequant kernel
_EMB_DEQUANT = {GGMLType.Q4_K: dequant_q4_k, GGMLType.Q5_K: dequant_q5_k,
                GGMLType.Q6_K: dequant_q6_k, GGMLType.Q8_0: dequant_q8_0}

_LINEARS = {"attn_q": "wq", "attn_k": "wk", "attn_v": "wv",
            "attn_output": "wo", "ffn_gate": "w_gate", "ffn_up": "w_up",
            "ffn_down": "w_down"}


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


def _bf16(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device=device, dtype=torch.bfloat16)


def load_params(gf: GGUFFile, cfg: ModelConfig, fmt: str = "bf16",
                device: str | torch.device | None = None) -> LlamaParams:
    """Load every tensor of ``gf`` onto ``device`` (default: the GPU; raises
    without one) in format ``fmt`` (``bf16`` | ``q4k``, the fused formats
    — named, as in the JAX reference, after the first of them)."""
    if fmt not in ("bf16", "q4k"):
        raise ValueError(f"fmt must be bf16|q4k, got {fmt!r}")
    device = resolve_device(device)
    fused = _fused_names(gf, cfg) if fmt == "q4k" else {}

    def lin(name: str) -> Linear:
        t = gf[name]
        n_out, k_in = tuple(reversed(t.shape))
        short = name.split(".")[-2] if name.startswith("blk.") else name.split(".")[0]
        target = fused.get(short)
        if target is None:
            return Linear("bf16", _bf16(t.astype_f32(), device), n_out, k_in)
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

    te = gf["token_embd.weight"]
    if te.ggml_type in _EMB_DEQUANT:
        raw = torch.from_numpy(np.array(te.raw(), np.uint8)).to(device)
        emb = _EMB_DEQUANT[te.ggml_type](raw).reshape(tuple(reversed(te.shape)))
    else:
        emb = _bf16(te.astype_f32(), device)
    if cfg.tie_embeddings or "output.weight" not in gf.tensors:
        output = Linear("bf16", emb, cfg.vocab_size, cfg.dim)
    else:
        output = lin("output.weight")
    return LlamaParams(emb, layers, norm("output_norm.weight"), output)


def from_jax_params(tree: dict, cfg: ModelConfig,
                    device: str | torch.device | None = None) -> LlamaParams:
    """The JAX reference's bf16 param pytree, as numpy arrays, → the port's
    modules: stacked ``(L, …)`` leaves are split per layer, ``{"w"}``
    linears become bf16 :class:`Linear` s, norms stay f32.  Tests use it to
    run both frameworks on the same weights.  Only bf16 pytrees cross: a
    linear in one of the reference's TPU layouts (fused planes, int8) raises
    ``ValueError`` naming it — load the GGUF file with :func:`load_params`
    instead."""
    device = resolve_device(device)
    keys = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}

    def t(a, dtype):
        return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                              dtype=dtype)

    def w(leaf: dict, name: str):
        if "w" not in leaf:
            raise ValueError(f"from_jax_params: linear {name!r} holds "
                             f"{sorted(leaf)}, not a bf16 'w' (only bf16 pytrees "
                             f"cross; load the GGUF file with load_params)")
        return leaf["w"]

    def lin(a) -> Linear:
        a = np.asarray(a, np.float32)
        return Linear("bf16", t(a, torch.bfloat16), a.shape[0], a.shape[1])

    st = tree["layers"]
    stacked = {k: w(st[k], f"layers.{k}") for k in keys}
    layers = [
        Layer(attn_norm=t(st["attn_norm"][i], torch.float32),
              ffn_norm=t(st["ffn_norm"][i], torch.float32),
              **{k: lin(stacked[k][i]) for k in keys})
        for i in range(cfg.n_layers)
    ]
    return LlamaParams(t(tree["tok_emb"], torch.bfloat16), layers,
                       t(tree["out_norm"], torch.float32),
                       lin(w(tree["output"], "output")))

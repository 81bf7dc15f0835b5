"""Model architecture config, derived from GGUF metadata.

Mirrors the hparams llama.cpp reads when the reference loads a model
(``Llama(model_path=..., n_ctx=1024)``, reference api.py:24-28), for the
Llama family (Llama-2/3; Mistral's optional sliding window is one extra
mask term).  Keys are read under the file's ``general.architecture``
(``llama``, or ``mistral``), so a Mistral file loads under either name.
"""

from __future__ import annotations

import dataclasses

from ..gguf import GGUFFile


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    n_ctx: int
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    sliding_window: int = 0      # 0 = full causal attention
    tie_embeddings: bool = False
    # "xla" materializes the (S, n_ctx) score matrix in plain torch; "flash"
    # streams K/V through the hand-written flash kernel (ops/attention.py)
    # for prompt passes (S > 1).  Decode (S == 1) is always the plain path.
    attn_impl: str = "xla"
    # "bf16" keeps the KV ring in bf16; "int8" stores int8 values plus a
    # per-head, per-token f32 scale (ops/kvquant.py)
    kv_dtype: str = "bf16"
    # layer-looped decode (ops/decode_loop.py): layers per kernel launch on
    # a decode step (S == 1) — 0 = off (the per-layer path), -1 = all
    # layers in one launch, K > 0 = K layers (clamped to a divisor of
    # n_layers); bf16 and int8 linears only (params.decode_loop_plan)
    decode_layer_unroll: int = 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def from_gguf(cls, gf: GGUFFile, n_ctx: int | None = None) -> "ModelConfig":
        h = gf.hparam
        n_heads = int(h("attention.head_count"))
        vocab = h("vocab_size")
        if vocab is None:
            vocab = len(gf.metadata["tokenizer.ggml.tokens"])
        window = int(h("attention.sliding_window", 0) or 0)
        train_ctx = int(h("context_length", 4096))
        return cls(
            vocab_size=int(vocab),
            dim=int(h("embedding_length")),
            n_layers=int(h("block_count")),
            n_heads=n_heads,
            n_kv_heads=int(h("attention.head_count_kv", n_heads)),
            ffn_dim=int(h("feed_forward_length")),
            n_ctx=int(n_ctx if n_ctx is not None else min(train_ctx, 4096)),
            rope_theta=float(h("rope.freq_base", 10000.0)),
            rms_eps=float(h("attention.layer_norm_rms_epsilon", 1e-5)),
            sliding_window=window,
            tie_embeddings="output.weight" not in gf.tensors,
        )


# Canonical full-size configs (random-weight synthesis for chip runs; no
# network egress, so models are built from these shapes).
LLAMA3_8B = ModelConfig(
    vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, n_ctx=1024, rope_theta=500000.0, rms_eps=1e-5,
)
MISTRAL_7B = ModelConfig(
    vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, n_ctx=1024, rope_theta=1000000.0, rms_eps=1e-5,
)

"""A tiny random-weight Llama GGUF for the drills on the CPU.

Written with the port's own writer (gguf/writer.py): 2 layers of width 64,
a byte-level BPE vocabulary (256 bytes + the Llama-3 control tokens), Q8_0
linears and F16 embeddings, the Llama-3 chat template.  The file is the JAX
package's test fixture (``testing.write_tiny_llama_gguf``) byte for byte, so
a drill over it serves what the reference's drills serve.  numpy only.
"""

from __future__ import annotations

import numpy as np

from ..gguf import GGMLType, GGUFWriter
from ..tokenizer.base import TokenType
from ..tokenizer.bpe import bytes_to_unicode

#: vocab 256 + 7 specials, width 64, 2 layers, 4 query / 2 kv heads
DIM, N_LAYERS, N_HEADS, N_KV_HEADS, FFN_DIM, N_CTX = 64, 2, 4, 2, 128, 128
ROPE_THETA, RMS_EPS = 10000.0, 1e-5

LLAMA3_SPECIALS = [
    "<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
    "<|end_header_id|>", "<|eot_id|>", "<|python_tag|>", "<|eom_id|>",
]

LLAMA3_CHAT_TEMPLATE = (
    "{{bos_token}}{% for m in messages %}<|start_header_id|>{{m['role']}}"
    "<|end_header_id|>\n\n{{m['content']}}<|eot_id|>{% endfor %}"
)


def write_tiny_llama_gguf(path: str, seed: int = 0) -> None:
    """Write the tiny model to ``path`` (weights drawn from ``seed``)."""
    tokens = [bytes_to_unicode()[b] for b in range(256)] + list(LLAMA3_SPECIALS)
    types = [int(TokenType.NORMAL)] * 256 + [int(TokenType.CONTROL)] * len(LLAMA3_SPECIALS)
    vocab = len(tokens)
    w = GGUFWriter(path)
    for key, value in (
            ("general.architecture", "llama"),
            ("general.name", "tiny-llama-test"),
            ("llama.block_count", N_LAYERS),
            ("llama.context_length", N_CTX),
            ("llama.embedding_length", DIM),
            ("llama.feed_forward_length", FFN_DIM),
            ("llama.attention.head_count", N_HEADS),
            ("llama.attention.head_count_kv", N_KV_HEADS),
            ("llama.attention.layer_norm_rms_epsilon", RMS_EPS),
            ("llama.rope.freq_base", ROPE_THETA),
            ("llama.vocab_size", vocab),
            ("tokenizer.ggml.model", "gpt2"),
            ("tokenizer.ggml.pre", "llama-bpe"),
            ("tokenizer.ggml.tokens", tokens),
            ("tokenizer.ggml.token_type", types),
            ("tokenizer.ggml.merges", []),
            ("tokenizer.ggml.bos_token_id", tokens.index("<|begin_of_text|>")),
            ("tokenizer.ggml.eos_token_id", tokens.index("<|eot_id|>")),
            ("tokenizer.chat_template", LLAMA3_CHAT_TEMPLATE)):
        w.add_metadata(key, value)

    rng = np.random.default_rng(seed)
    scale = DIM ** -0.5
    kv_dim = N_KV_HEADS * (DIM // N_HEADS)

    def t(name, shape, gtype):
        w.add_tensor(name, rng.standard_normal(shape).astype(np.float32) * scale, gtype)

    t("token_embd.weight", (vocab, DIM), GGMLType.F16)
    for i in range(N_LAYERS):
        p = f"blk.{i}."
        t(p + "attn_norm.weight", (DIM,), GGMLType.F32)
        t(p + "attn_q.weight", (DIM, DIM), GGMLType.Q8_0)
        t(p + "attn_k.weight", (kv_dim, DIM), GGMLType.Q8_0)
        t(p + "attn_v.weight", (kv_dim, DIM), GGMLType.Q8_0)
        t(p + "attn_output.weight", (DIM, DIM), GGMLType.Q8_0)
        t(p + "ffn_norm.weight", (DIM,), GGMLType.F32)
        t(p + "ffn_gate.weight", (FFN_DIM, DIM), GGMLType.Q8_0)
        t(p + "ffn_up.weight", (FFN_DIM, DIM), GGMLType.Q8_0)
        t(p + "ffn_down.weight", (DIM, FFN_DIM), GGMLType.Q8_0)
    t("output_norm.weight", (DIM,), GGMLType.F32)
    t("output.weight", (vocab, DIM), GGMLType.F16)
    w.write()

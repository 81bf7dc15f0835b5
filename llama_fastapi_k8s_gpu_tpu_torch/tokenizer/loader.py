"""Build a tokenizer from GGUF metadata (the keys llama.cpp reads when the
reference constructs ``Llama(model_path=...)``, reference api.py:24-28).

Only the byte-level BPE family (``tokenizer.ggml.model == "gpt2"``, Llama-3)
is ported so far; SentencePiece files (Mistral, Llama-2) are refused."""

from __future__ import annotations

from ..gguf import GGUFFile
from .base import Tokenizer
from .bpe import BPETokenizer


def tokenizer_from_gguf(gf: GGUFFile) -> Tokenizer:
    md = gf.metadata
    model = md.get("tokenizer.ggml.model", "gpt2")
    if model != "gpt2":
        raise NotImplementedError(
            f"tokenizer model {model!r}: only byte-level BPE (gpt2) is ported")
    return BPETokenizer(
        tokens=md["tokenizer.ggml.tokens"],
        merges=md.get("tokenizer.ggml.merges", []),
        token_types=md.get("tokenizer.ggml.token_type"),
        bos_id=md.get("tokenizer.ggml.bos_token_id"),
        eos_id=md.get("tokenizer.ggml.eos_token_id"),
        add_bos=bool(md.get("tokenizer.ggml.add_bos_token", True)),
        pre=md.get("tokenizer.ggml.pre", "llama-bpe"),
    )

"""Build a tokenizer from GGUF metadata (the keys llama.cpp reads when the
reference constructs ``Llama(model_path=...)``, reference api.py:24-28):
byte-level BPE for ``tokenizer.ggml.model == "gpt2"`` (Llama-3) and
SentencePiece for ``"llama"``/``"spm"`` (Mistral, Llama-2); any other model
raises ``NotImplementedError``."""

from __future__ import annotations

from ..gguf import GGUFFile
from .base import Tokenizer
from .bpe import BPETokenizer
from .spm import SPMTokenizer


def tokenizer_from_gguf(gf: GGUFFile) -> Tokenizer:
    md = gf.metadata
    model = md.get("tokenizer.ggml.model", "gpt2")
    tokens = md["tokenizer.ggml.tokens"]
    token_types = md.get("tokenizer.ggml.token_type")
    bos_id = md.get("tokenizer.ggml.bos_token_id")
    eos_id = md.get("tokenizer.ggml.eos_token_id")
    add_bos = bool(md.get("tokenizer.ggml.add_bos_token", True))

    if model == "gpt2":
        return BPETokenizer(
            tokens=tokens,
            merges=md.get("tokenizer.ggml.merges", []),
            token_types=token_types,
            bos_id=bos_id,
            eos_id=eos_id,
            add_bos=add_bos,
            pre=md.get("tokenizer.ggml.pre", "llama-bpe"),
        )
    if model in ("llama", "spm"):
        return SPMTokenizer(
            tokens=tokens,
            scores=md.get("tokenizer.ggml.scores", [0.0] * len(tokens)),
            token_types=token_types,
            bos_id=bos_id if bos_id is not None else 1,
            eos_id=eos_id if eos_id is not None else 2,
            add_bos=add_bos,
            add_space_prefix=bool(md.get("tokenizer.ggml.add_space_prefix", True)),
        )
    raise NotImplementedError(f"tokenizer model {model!r}")

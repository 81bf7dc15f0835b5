"""Tokenizer interface + shared machinery.

The reference delegates tokenization entirely to the native engine
(``llm.create_chat_completion(messages=...)``, reference api.py:55-63); the
PyTorch port implements the two tokenizer families GGUF models carry:
byte-level BPE ("gpt2" model key — Llama-3) and SentencePiece-style
("llama" model key — Mistral/Llama-2).  Vocabulary, merges, scores and
special-token metadata all come from GGUF KV pairs, never from network.
"""

from __future__ import annotations

import enum
from typing import Iterable, Sequence


class TokenType(enum.IntEnum):
    """tokenizer.ggml.token_type values (llama.cpp llama_token_type)."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


class Tokenizer:
    """Common base: id↔piece tables, special-token splitting, decode glue."""

    def __init__(
        self,
        tokens: Sequence[str],
        token_types: Sequence[int] | None,
        bos_id: int | None,
        eos_id: int | None,
        add_bos: bool = True,
    ):
        self.tokens = list(tokens)
        self.token_types = (
            [TokenType(t) for t in token_types]
            if token_types is not None
            else [TokenType.NORMAL] * len(self.tokens)
        )
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.add_bos = add_bos
        # Tokens that must be matched literally before pre-tokenization when
        # parse_special=True (CONTROL and USER_DEFINED types).
        self.special_tokens = {
            t: i
            for i, t in enumerate(self.tokens)
            if self.token_types[i] in (TokenType.CONTROL, TokenType.USER_DEFINED)
        }
        self._special_sorted = sorted(self.special_tokens, key=len, reverse=True)

    # -- interface -----------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def encode(self, text: str, add_bos: bool | None = None,
               parse_special: bool = False) -> list[int]:
        ids: list[int] = []
        if add_bos is None:
            add_bos = self.add_bos
        if add_bos and self.bos_id is not None:
            ids.append(self.bos_id)
        for segment, special_id in self._split_special(text, parse_special):
            if special_id is not None:
                ids.append(special_id)
            elif segment:
                ids.extend(self._encode_fragment(segment))
        return ids

    def decode_bytes(self, ids: Iterable[int], skip_special: bool = True) -> bytes:
        """Raw UTF-8 byte stream for ``ids``.  Unlike the decoded *text*,
        the byte stream is append-only across incremental decodes — the
        property streaming emission relies on (engines feed the new bytes
        through an incremental UTF-8 decoder so streamed text always equals
        the batch decode, even mid-multibyte-sequence)."""
        raise NotImplementedError

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        return self.decode_bytes(ids, skip_special).decode("utf-8", errors="replace")

    def _encode_fragment(self, text: str) -> list[int]:
        raise NotImplementedError

    def id_to_piece(self, token_id: int) -> str:
        return self.tokens[token_id]

    def is_control(self, token_id: int) -> bool:
        return self.token_types[token_id] == TokenType.CONTROL

    @property
    def stop_ids(self) -> set[int]:
        """End-of-generation ids: eos plus any control token llama.cpp treats
        as end-of-generation (eot/eom variants)."""
        out = set()
        if self.eos_id is not None:
            out.add(self.eos_id)
        for name in ("<|eot_id|>", "<|end_of_text|>", "<|eom_id|>", "</s>",
                     "<|im_end|>", "<|endoftext|>"):
            if name in self.token_to_id:
                out.add(self.token_to_id[name])
        return out

    # -- helpers -------------------------------------------------------------
    def _split_special(self, text: str, parse_special: bool):
        """Yield (fragment, None) or ("", special_token_id) in order."""
        if not parse_special or not self.special_tokens:
            yield text, None
            return
        rest = text
        while rest:
            best_pos, best_tok = None, None
            for tok in self._special_sorted:
                pos = rest.find(tok)
                if pos != -1 and (best_pos is None or pos < best_pos or
                                  (pos == best_pos and len(tok) > len(best_tok))):
                    best_pos, best_tok = pos, tok
            if best_pos is None:
                yield rest, None
                return
            if best_pos:
                yield rest[:best_pos], None
            yield "", self.special_tokens[best_tok]
            rest = rest[best_pos + len(best_tok):]

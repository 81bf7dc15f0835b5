"""SentencePiece-style tokenizer (GGUF ``tokenizer.ggml.model == "llama"``).

The Mistral / Llama-2 family tokenizer: pieces carry scores
(``tokenizer.ggml.scores``); encoding greedily merges the adjacent pair with
the highest-scoring concatenation (ties broken leftmost), with per-byte
``<0xXX>`` fallback for anything outside the vocab (``<unk>`` for a byte
with no piece).  Whitespace is escaped to U+2581 and a dummy space prefix is
added, matching sentencepiece defaults.  Ids are bit-identical to the JAX
package's ``SPMTokenizer`` (tests/test_torch_spm.py).
"""

from __future__ import annotations

import heapq
from typing import Iterable, Sequence

from .base import Tokenizer, TokenType

_SPACE = "▁"  # ▁


class SPMTokenizer(Tokenizer):
    def __init__(
        self,
        tokens: Sequence[str],
        scores: Sequence[float],
        token_types: Sequence[int] | None = None,
        bos_id: int | None = 1,
        eos_id: int | None = 2,
        add_bos: bool = True,
        add_space_prefix: bool = True,
    ):
        super().__init__(tokens, token_types, bos_id, eos_id, add_bos)
        self.scores = list(scores)
        self.add_space_prefix = add_space_prefix
        self._byte_ids = {}
        for i, t in enumerate(self.tokens):
            if self.token_types[i] == TokenType.BYTE and len(t) == 6 and t.startswith("<0x"):
                self._byte_ids[int(t[3:5], 16)] = i

    # ------------------------------------------------------------------
    def _encode_fragment(self, text: str) -> list[int]:
        if not text:
            return []
        if self.add_space_prefix:
            text = " " + text
        text = text.replace(" ", _SPACE)
        symbols: list[str] = list(text)  # start from single characters
        # neighbour links; alive[i] is False once merged into its left
        prev = list(range(-1, len(symbols) - 1))
        nxt = list(range(1, len(symbols) + 1))
        alive = [True] * len(symbols)

        def score_of(s: str):
            tid = self.token_to_id.get(s)
            if tid is None:
                return None
            return self.scores[tid] if tid < len(self.scores) else 0.0

        heap: list[tuple[float, int, int, str]] = []

        def push(i: int):
            j = nxt[i]
            if j >= len(symbols):
                return
            merged = symbols[i] + symbols[j]
            sc = score_of(merged)
            if sc is not None:
                # max score first; ties → leftmost (llama.cpp llm_symbol_bigram)
                heapq.heappush(heap, (-sc, i, j, merged))

        for i in range(len(symbols) - 1):
            push(i)

        while heap:
            _, i, j, merged = heapq.heappop(heap)
            if not alive[i] or not alive[j] or symbols[i] + symbols[j] != merged:
                continue
            symbols[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < len(symbols):
                prev[nxt[j]] = i
            if prev[i] >= 0:
                push(prev[i])
            push(i)

        ids: list[int] = []
        i = 0
        while i < len(symbols):
            if not alive[i]:
                i = nxt[i]
                continue
            sym = symbols[i]
            tid = self.token_to_id.get(sym)
            if tid is not None:
                ids.append(tid)
            else:
                for b in sym.encode("utf-8"):
                    if b in self._byte_ids:
                        ids.append(self._byte_ids[b])
                    elif self.token_to_id.get("<unk>") is not None:
                        ids.append(self.token_to_id["<unk>"])
            i = nxt[i]
        return ids

    def decode_bytes(self, ids: Iterable[int], skip_special: bool = True) -> bytes:
        buf = bytearray()
        first_real = True
        for tid in ids:
            ttype = self.token_types[tid]
            piece = self.tokens[tid]
            if ttype == TokenType.CONTROL:
                if not skip_special:
                    buf.extend(piece.encode("utf-8"))
                continue
            if ttype == TokenType.BYTE:
                buf.append(int(piece[3:5], 16))
                first_real = False
                continue
            text = piece.replace(_SPACE, " ")
            if first_real and self.add_space_prefix and text.startswith(" "):
                text = text[1:]  # drop the dummy prefix space
            first_real = False
            buf.extend(text.encode("utf-8"))
        return bytes(buf)

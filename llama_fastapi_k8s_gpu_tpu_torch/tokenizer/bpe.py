"""Byte-level BPE tokenizer (GGUF ``tokenizer.ggml.model == "gpt2"``).

This is the Llama-3 family tokenizer: raw UTF-8 bytes are mapped to printable
unicode code points (the GPT-2 byte table), text is pre-split by a regex, and
each pre-token is merged bottom-up by merge rank.  Vocab and merges come from
GGUF metadata (``tokenizer.ggml.tokens`` / ``tokenizer.ggml.merges``).
"""

from __future__ import annotations

import functools
import heapq
import re
from typing import Iterable, Sequence

from .base import Tokenizer, TokenType

# Pre-tokenizer patterns keyed by GGUF `tokenizer.ggml.pre`.
# llama-bpe is the Llama-3 pattern; default matches GPT-2.
_PRE_PATTERNS = {
    "llama-bpe": (
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
        r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ),
    "llama3": None,  # alias, filled below
    "default": (
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
        r"|\s+(?!\S)|\s+"
    ),
}
_PRE_PATTERNS["llama3"] = _PRE_PATTERNS["llama-bpe"]

# The same patterns in the standard library's ``re`` dialect, for hosts
# without the third-party ``regex`` module (the GPU image carries none).
# ``re`` has no \p classes: letters are [^\W\d_] and numbers \d, and the
# "neither letter nor number" classes become (?:[^...\w]|_).  Identical to
# the \p forms on ASCII and on every script whose numerals are decimal
# digits; tests/test_torch_tokenizer.py holds both dialects to the same ids.
_RE_PATTERNS = {
    "llama-bpe": (
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|(?:[^\r\n\w]|_)?[^\W\d_]+|\d{1,3}"
        r"| ?(?:[^\s\w]|_)+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ),
    "default": (
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+"
        r"|\s+(?!\S)|\s+"
    ),
}
_RE_PATTERNS["llama3"] = _RE_PATTERNS["llama-bpe"]


@functools.lru_cache(maxsize=8)
def _compiled_pattern(pre: str, dialect: str | None = None):
    """Compiled pre-tokenizer: the ``regex`` module's \\p pattern when it is
    installed (or ``dialect="regex"``), else the ``re`` translation."""
    if dialect is None:
        try:
            import regex  # noqa: F401
            dialect = "regex"
        except ImportError:
            dialect = "re"
    if dialect == "regex":
        import regex

        return regex.compile(_PRE_PATTERNS.get(pre) or _PRE_PATTERNS["default"])
    return re.compile(_RE_PATTERNS.get(pre) or _RE_PATTERNS["default"])


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→unicode map (printable stand-ins for all 256)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class BPETokenizer(Tokenizer):
    def __init__(
        self,
        tokens: Sequence[str],
        merges: Sequence[str],
        token_types: Sequence[int] | None = None,
        bos_id: int | None = None,
        eos_id: int | None = None,
        add_bos: bool = True,
        pre: str = "llama-bpe",
    ):
        super().__init__(tokens, token_types, bos_id, eos_id, add_bos)
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(merges):
            left, _, right = merge.partition(" ")
            self.merge_ranks[(left, right)] = rank
        self.pre = pre
        self._pattern = _compiled_pattern(pre)
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = unicode_to_bytes()

    # ------------------------------------------------------------------
    def _bpe_merge(self, symbols: list[str]) -> list[str]:
        """Merge adjacent symbol pairs in rank order until no merge applies.

        Heap + neighbor links (the same O(n log n) bigram queue llama.cpp's
        ``llm_tokenizer_bpe`` uses, and that :mod:`spm` uses score-ordered):
        pop the lowest-rank pair (ties → leftmost), splice, and only re-rank
        the two pairs the splice created.  Stale heap entries are detected by
        comparing the recorded symbols against the current ones.  The round-2
        version rescanned the whole fragment per merge — O(n²) per fragment,
        which a 280k-merge real vocab turns into a latency cliff on long
        unbroken fragments."""
        n = len(symbols)
        if n < 2:
            return symbols
        ranks = self.merge_ranks
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap: list[tuple[int, int, int, str, str]] = []

        def push(i: int):
            j = nxt[i]
            if j >= n:
                return
            rank = ranks.get((symbols[i], symbols[j]))
            if rank is not None:
                heapq.heappush(heap, (rank, i, j, symbols[i], symbols[j]))

        for i in range(n - 1):
            push(i)

        while heap:
            _, i, j, si, sj = heapq.heappop(heap)
            if not alive[i] or not alive[j] or symbols[i] != si or symbols[j] != sj:
                continue
            symbols[i] = si + sj
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prev[nxt[j]] = i
            if prev[i] >= 0:
                push(prev[i])
            push(i)
        return [s for s, a in zip(symbols, alive) if a]

    def _encode_fragment(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self._pattern.findall(text):
            mapped = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
            for sym in self._bpe_merge(list(mapped)):
                tid = self.token_to_id.get(sym)
                if tid is not None:
                    ids.append(tid)
                else:
                    # unmergeable symbol: fall back to per-byte tokens
                    for ch in sym:
                        bid = self.token_to_id.get(ch)
                        if bid is not None:
                            ids.append(bid)
        return ids

    def decode_bytes(self, ids: Iterable[int], skip_special: bool = True) -> bytes:
        buf = bytearray()
        for tid in ids:
            ttype = self.token_types[tid]
            piece = self.tokens[tid]
            if ttype == TokenType.CONTROL:
                if not skip_special:
                    buf.extend(piece.encode("utf-8"))
                continue
            if ttype == TokenType.USER_DEFINED:
                # user-defined pieces are stored as raw text, not byte-mapped
                buf.extend(piece.encode("utf-8"))
                continue
            for ch in piece:
                b = self._byte_dec.get(ch)
                if b is None:
                    buf.extend(ch.encode("utf-8"))
                else:
                    buf.append(b)
        return bytes(buf)

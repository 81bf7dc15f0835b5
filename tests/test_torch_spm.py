"""The port's SentencePiece tokenizer against the JAX package's.

Token ids, decoded bytes and decoded text must be bit-identical to the JAX
``SPMTokenizer`` on: the hand-built vocabulary of ``tests/test_tokenizer.py``
(three byte pieces only, so most non-ASCII text falls to ``<unk>``); a
seeded vocabulary of about 2,000 scored pieces whose scores repeat (equal
score ties go to the leftmost pair) with every ``<0xXX>`` byte piece; seeded
and hypothesis strings with leading, trailing and repeated spaces,
non-ASCII text, ``<s>``/``</s>`` under ``parse_special`` and the empty
string; each with and without ``add_space_prefix``.  The GGUF loader builds
the SPM tokenizer for a ``llama`` (or ``spm``) model with the reference's
defaults, and still refuses an unknown model.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_mistral_gguf
from llama_fastapi_k8s_gpu_tpu.tokenizer import tokenizer_from_gguf as j_from_gguf
from llama_fastapi_k8s_gpu_tpu.tokenizer.spm import SPMTokenizer as JSPMTokenizer
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile, GGUFWriter
from llama_fastapi_k8s_gpu_tpu_torch.tokenizer import (
    SPMTokenizer,
    TokenType,
    apply_chat_template,
    detect_chat_template,
    tokenizer_from_gguf,
)

#: tests/test_tokenizer.py's SPM vocabulary: (piece, type, score)
SPM_TOKENS = [
    ("<unk>", TokenType.UNKNOWN, 0.0),
    ("<s>", TokenType.CONTROL, 0.0),
    ("</s>", TokenType.CONTROL, 0.0),
    ("▁", TokenType.NORMAL, -1.0),
    ("▁h", TokenType.NORMAL, 1.0),
    ("▁he", TokenType.NORMAL, 2.0),
    ("ll", TokenType.NORMAL, 1.5),
    ("lo", TokenType.NORMAL, 0.5),
    ("llo", TokenType.NORMAL, 3.0),
    ("▁hello", TokenType.NORMAL, 5.0),
    ("h", TokenType.NORMAL, -2.0),
    ("e", TokenType.NORMAL, -2.0),
    ("l", TokenType.NORMAL, -2.0),
    ("o", TokenType.NORMAL, -2.0),
    ("<0xE2>", TokenType.BYTE, 0.0),
    ("<0x82>", TokenType.BYTE, 0.0),
    ("<0xAC>", TokenType.BYTE, 0.0),
]

WORDS = ["hello", "world", "the", "cat", "sat", "on", "mat", "river", "boats",
         "summer", "trip", "morning", "walking", "planned", "story", "tell"]


def seeded_vocab(seed: int = 0, n: int = 2000):
    """<unk>, <s>, </s>, the 256 byte pieces, then ``n`` seeded pieces:
    ``▁word`` and its prefixes, letter pairs and triples, random letter
    runs — scores drawn from eight values, so many pairs tie."""
    rng = np.random.default_rng(seed)
    pieces = ["<unk>", "<s>", "</s>"]
    types = [int(TokenType.UNKNOWN), int(TokenType.CONTROL), int(TokenType.CONTROL)]
    for b in range(256):
        pieces.append(f"<0x{b:02X}>")
        types.append(int(TokenType.BYTE))
    seen = set(pieces)
    cand = ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    for w in WORDS:
        for i in range(1, len(w) + 1):
            cand += ["▁" + w[:i], w[:i], w[i - 1:]]
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(cand) < 4 * n:
        k = int(rng.integers(2, 6))
        run = "".join(letters[int(j)] for j in rng.integers(0, 26, k))
        cand.append(("▁" if rng.random() < 0.3 else "") + run)
    for c in cand:
        if c not in seen and len(pieces) < n + 259:
            seen.add(c)
            pieces.append(c)
            types.append(int(TokenType.NORMAL))
    levels = np.array([-9.0, -7.5, -6.0, -4.5, -3.0, -1.5, 0.0, 1.5])
    scores = [0.0] * 259 + list(levels[rng.integers(0, 8, len(pieces) - 259)])
    return pieces, types, [float(s) for s in scores]


def _pair(pieces, types, scores, add_space_prefix):
    kw = dict(bos_id=1, eos_id=2, add_space_prefix=add_space_prefix)
    return (JSPMTokenizer(pieces, scores, types, **kw),
            SPMTokenizer(pieces, scores, types, **kw))


VOCABS = {
    "hand": ([t for t, _, _ in SPM_TOKENS], [int(ty) for _, ty, _ in SPM_TOKENS],
             [s for _, _, s in SPM_TOKENS]),
    "seeded": seeded_vocab(),
}

TEXTS = [
    "", " ", "   ", "hello", " hello", "hello ", "  hello  world  ", "he llo",
    "hellohello hello", "the cat sat on the mat", "walking by the river, boats!",
    "€ and naïve café — Ελληνικά, 中文, 🙂", "tabs\tand\nnew lines\n",
    "<s>hello</s>", "</s></s> <s> x", "[INST] hello [/INST] world</s>",
    "summer trip planned▁with a literal escape char",
]


def _check(ref, got, text, add_bos, parse_special):
    ids = ref.encode(text, add_bos=add_bos, parse_special=parse_special)
    assert got.encode(text, add_bos=add_bos, parse_special=parse_special) == ids, text
    for skip in (True, False):
        assert got.decode_bytes(ids, skip) == ref.decode_bytes(ids, skip), text
        assert got.decode(ids, skip) == ref.decode(ids, skip), text


@pytest.mark.parametrize("vocab", list(VOCABS))
@pytest.mark.parametrize("add_space_prefix", [True, False])
@pytest.mark.parametrize("parse_special", [False, True])
def test_ids_and_bytes_identical(vocab, add_space_prefix, parse_special):
    ref, got = _pair(*VOCABS[vocab], add_space_prefix)
    for text in TEXTS:
        for add_bos in (True, False):
            _check(ref, got, text, add_bos, parse_special)
    assert got.stop_ids == ref.stop_ids
    assert got._byte_ids == ref._byte_ids


@pytest.mark.parametrize("add_space_prefix", [True, False])
def test_seeded_strings_identical(add_space_prefix):
    """Seeded strings from the vocabulary's words, spaces in runs at
    either end, non-ASCII characters and control pieces."""
    ref, got = _pair(*VOCABS["seeded"], add_space_prefix)
    rng = np.random.default_rng(5)
    extra = [" ", "  ", "   ", "é", "€", "日本", "🙂", "</s>", "<s>", "\n", "ß", "x"]
    for _ in range(300):
        parts = [(WORDS + extra)[int(i)] for i in
                 rng.integers(0, len(WORDS) + len(extra), int(rng.integers(0, 12)))]
        text = "".join(p + (" " * int(rng.integers(0, 3))) for p in parts)
        _check(ref, got, text, bool(rng.integers(0, 2)), bool(rng.integers(0, 2)))


@settings(max_examples=200, deadline=None)
@given(parts=st.lists(st.sampled_from(
    list("helowrdtcasmn ▁") + ["</s>", "<s>", "é", "€", "中", "🙂", "\n"]), max_size=40),
    add_space_prefix=st.booleans(), parse_special=st.booleans())
def test_hypothesis_strings_identical(parts, add_space_prefix, parse_special):
    text = "".join(parts)
    for vocab in VOCABS:
        ref, got = _pair(*VOCABS[vocab], add_space_prefix)
        _check(ref, got, text, True, parse_special)


def test_decode_drops_only_the_first_prefix_space():
    """The dummy prefix space of the first real piece goes, a later
    piece's space stays, and a byte piece first counts as the first."""
    ref, got = _pair(*VOCABS["hand"], True)
    ids = got.encode(" hello  hello", add_bos=True)
    assert got.decode(ids) == ref.decode(ids) == " hello  hello"
    e = got.token_to_id["<0xE2>"]
    h = got.token_to_id["▁hello"]
    for seq in ([h, h], [1, h, h], [e, h], [2, h]):
        assert got.decode_bytes(seq) == ref.decode_bytes(seq)


def _meta_file(path, model="llama", scores=True, ids=True, space=None):
    """A GGUF of tokenizer metadata only: the hand vocabulary, optionally
    without scores or bos/eos ids, or with ``add_space_prefix``."""
    w = GGUFWriter(path)
    w.add_metadata("general.architecture", "llama")
    w.add_metadata("tokenizer.ggml.model", model)
    w.add_metadata("tokenizer.ggml.tokens", VOCABS["hand"][0])
    w.add_metadata("tokenizer.ggml.token_type", VOCABS["hand"][1])
    if scores:
        w.add_metadata("tokenizer.ggml.scores", VOCABS["hand"][2])
    if ids:
        w.add_metadata("tokenizer.ggml.bos_token_id", 1)
        w.add_metadata("tokenizer.ggml.eos_token_id", 2)
    if space is not None:
        w.add_metadata("tokenizer.ggml.add_space_prefix", space)
    w.write()


@pytest.mark.parametrize("case", ["full", "no_scores", "no_ids", "no_space", "spm"])
def test_loader_builds_spm_with_the_reference_defaults(tmp_path, case):
    path = str(tmp_path / f"{case}.gguf")
    _meta_file(path, model="spm" if case == "spm" else "llama",
               scores=case != "no_scores", ids=case != "no_ids",
               space=False if case == "no_space" else None)
    ref, got = j_from_gguf(JGGUFFile(path)), tokenizer_from_gguf(GGUFFile(path))
    assert isinstance(got, SPMTokenizer)
    assert (got.bos_id, got.eos_id, got.add_bos, got.add_space_prefix) == \
        (ref.bos_id, ref.eos_id, ref.add_bos, ref.add_space_prefix)
    assert got.scores == ref.scores
    if case == "no_scores":
        assert got.scores == [0.0] * len(got.tokens)
    if case == "no_ids":
        assert (got.bos_id, got.eos_id) == (1, 2)
    assert got.add_space_prefix == (case != "no_space")
    for text in TEXTS:
        _check(ref, got, text, True, True)


def test_loader_refuses_an_unknown_model(tmp_path):
    path = str(tmp_path / "rwkv.gguf")
    _meta_file(path, model="rwkv")
    for load, GF in ((tokenizer_from_gguf, GGUFFile), (j_from_gguf, JGGUFFile)):
        with pytest.raises(NotImplementedError, match="rwkv"):
            load(GF(path))


MESSAGES = [
    {"role": "system", "content": "You are 'Alice.f.' a playful person."},
    {"role": "user", "content": "  hi there  "},
    {"role": "assistant", "content": "hey ✨"},
    {"role": "user", "content": "how are you?\n"},
]


def test_tiny_mistral_file_tokenizer_and_template(tmp_path):
    """``write_tiny_mistral_gguf``'s byte-only vocabulary: the loader's
    tokenizer, the ``mistral`` template kind, and the rendered prompt ids
    (the system turn folded into the first ``[INST]``, each assistant turn
    closed by ``</s>`` parsed as control id 2)."""
    path = str(tmp_path / "mistral.gguf")
    write_tiny_mistral_gguf(path)
    jgf, gf = JGGUFFile(path), GGUFFile(path)
    ref, got = j_from_gguf(jgf), tokenizer_from_gguf(gf)
    from llama_fastapi_k8s_gpu_tpu.tokenizer import apply_chat_template as j_apply
    from llama_fastapi_k8s_gpu_tpu.tokenizer import detect_chat_template as j_detect

    kind = detect_chat_template(gf.metadata.get("tokenizer.chat_template"), got)
    assert kind == j_detect(jgf.metadata.get("tokenizer.chat_template"), ref) == "mistral"
    ids = apply_chat_template(got, MESSAGES, kind=kind)
    assert ids == j_apply(ref, MESSAGES, kind=kind)
    assert ids[0] == 1 and ids.count(2) == 1
    for text in TEXTS:
        _check(ref, got, text, True, True)

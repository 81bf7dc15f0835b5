"""Port tokenizer against the JAX package's: identical ids, decoded bytes
and chat-template renderings, on the tiny byte-level file and on a file
with a synthetic merge table.  The port's pre-tokenizer has two dialects
(the ``regex`` module's \\p classes where it is installed, the standard
``re`` translation where it is not, as on the GPU image); both must give
the reference's ids."""

from __future__ import annotations

import pytest

from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.gguf import GGUFWriter as JGGUFWriter
from llama_fastapi_k8s_gpu_tpu.testing import (
    TINY_CFG,
    synth_bpe_vocab,
    write_llama_gguf_meta,
    write_tiny_llama_gguf,
)
from llama_fastapi_k8s_gpu_tpu.tokenizer import apply_chat_template as j_apply
from llama_fastapi_k8s_gpu_tpu.tokenizer import detect_chat_template as j_detect
from llama_fastapi_k8s_gpu_tpu.tokenizer import tokenizer_from_gguf as j_from_gguf
from llama_fastapi_k8s_gpu_tpu.tokenizer.chat_template import render_llama3 as j_render_llama3
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile
from llama_fastapi_k8s_gpu_tpu_torch.tokenizer import (
    apply_chat_template,
    detect_chat_template,
    tokenizer_from_gguf,
)
from llama_fastapi_k8s_gpu_tpu_torch.tokenizer.bpe import _compiled_pattern
from llama_fastapi_k8s_gpu_tpu_torch.tokenizer.chat_template import render_llama3

TEXTS = [
    "hello world",
    "How are you?  I'm fine, they'd say... 12345 67",
    "tabs\tand\nnew\r\nlines \n\n  trailing   ",
    "naïve café, Straße, Ελληνικά, русский, 中文字符, 日本語",
    "emoji 🙂👍🏽 and symbols ©®™ — “quotes” ‘x’",
    "under_score snake_case __dunder__ a_1_b",
    "<|start_header_id|>user<|end_header_id|> raw special text",
    "",
    "abababababababababababababababab cdcdcd zzz",
]

MESSAGES = [
    {"role": "user", "content": "  hi there  "},
    {"role": "system", "content": "You are 'Alice.f.' a playful person. You a girl."},
    {"role": "assistant", "content": "hey ✨"},
    {"role": "user", "content": "how are you?\n"},
]


@pytest.fixture(scope="module", params=["tiny", "merges"])
def gguf_path(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / f"{request.param}.gguf")
    if request.param == "tiny":
        write_tiny_llama_gguf(path)
    else:
        tokens, merges, types = synth_bpe_vocab(n_merges=3000)
        w = JGGUFWriter(path)
        write_llama_gguf_meta(w, TINY_CFG, tokens, types, merges=merges)
        w.write()
    return path


@pytest.mark.parametrize("dialect", ["regex", "re"])
def test_ids_and_bytes_identical(gguf_path, dialect, monkeypatch):
    ref = j_from_gguf(JGGUFFile(gguf_path))
    got = tokenizer_from_gguf(GGUFFile(gguf_path))
    monkeypatch.setattr(got, "_pattern", _compiled_pattern(got.pre, dialect))
    for text in TEXTS:
        ids = ref.encode(text)
        assert got.encode(text) == ids, text
        assert got.decode_bytes(ids) == ref.decode_bytes(ids)
    assert got.stop_ids == ref.stop_ids


def test_chat_template_identical(gguf_path):
    jgf, gf = JGGUFFile(gguf_path), GGUFFile(gguf_path)
    ref, got = j_from_gguf(jgf), tokenizer_from_gguf(gf)
    template = gf.metadata.get("tokenizer.chat_template")
    kind = detect_chat_template(template, got)
    assert kind == j_detect(jgf.metadata.get("tokenizer.chat_template"), ref) == "llama3"
    assert apply_chat_template(got, MESSAGES, kind=kind) == \
        j_apply(ref, MESSAGES, kind=kind)
    assert render_llama3(MESSAGES) == j_render_llama3(MESSAGES)

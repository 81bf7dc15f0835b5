"""The port's serial engine: streaming, deadlines and aborts, seeds and
prefix reuse, on the tiny GGUF and the CPU path.  Its bytes are held to
the JAX engine's through the server (tests/test_torch_server.py)."""

from __future__ import annotations

import time

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine

torch.set_num_threads(1)
MSGS = [{"role": "user", "content": "tell me a story about a cat " * 6}]


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eng") / "tiny.gguf")
    write_tiny_llama_gguf(path, quant=JGGMLType.F16)
    # 64-token slices: prompts in the 64 bucket take the whole-bucket
    # pass, larger ones the sliced pass, follow-ups the reuse suffix
    return Engine(path, n_ctx=512, max_gen_tokens=20, prefill_chunk=64,
                  prefill_buckets=(64, 128, 512), device="cpu")


def test_stream_concatenates_to_the_completion(engine):
    full = engine.create_chat_completion(MSGS, temperature=0.0, seed=1)
    chunks = list(engine.create_chat_completion(MSGS, temperature=0.0, seed=1,
                                                stream=True))
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert text == full["choices"][0]["message"]["content"]
    assert chunks[-1]["choices"][0]["finish_reason"] == \
        full["choices"][0]["finish_reason"]
    assert full["usage"]["completion_tokens"] == 20


def test_sliced_prefill_equals_whole_prefill(engine):
    """A 128-bucket prompt runs as two 64-token slices; the same prompt
    through the whole-bucket program gives the same logits."""
    from llama_fastapi_k8s_gpu_tpu_torch.models.generate import prefill

    ids = engine.tokenize_messages(MSGS)[:100]
    with engine._lock:
        sliced = engine._prefill_padded(ids, len(ids), 128)
        padded = torch.zeros(128, dtype=torch.int64)
        padded[:100] = torch.tensor(ids)
        whole = prefill(engine.params, engine.cfg, padded, 100, engine._cache)
        engine._prefix_ids = []
    assert torch.allclose(sliced, whole, atol=1e-3)


def test_prefix_reuse_only_without_explicit_seed(engine):
    first = engine.create_chat_completion(MSGS, temperature=0.0)
    reply = first["choices"][0]["message"]["content"]
    follow = MSGS + [{"role": "assistant", "content": reply},
                     {"role": "user", "content": "and then?"}]
    reused = engine.create_chat_completion(follow, temperature=0.0)
    assert reused["lfkt_timings"]["prefix_reused_tokens"] >= 32
    engine.create_chat_completion(MSGS, temperature=0.0)
    seeded = engine.create_chat_completion(follow, temperature=0.0, seed=5)
    assert seeded["lfkt_timings"]["prefix_reused_tokens"] == 0
    # greedy tokens of the reused and the full prefill agree here
    assert seeded["choices"][0]["message"]["content"] == \
        reused["choices"][0]["message"]["content"]


def test_seeded_sampling_is_reproducible(engine):
    kw = dict(temperature=1.0, top_p=0.95, seed=42)
    a = engine.create_chat_completion(MSGS, **kw)
    b = engine.create_chat_completion(MSGS, **kw)
    assert a["choices"][0]["message"]["content"] == b["choices"][0]["message"]["content"]


def test_deadline_and_abort_stop_within_a_chunk(engine):
    past = engine.create_chat_completion(MSGS, temperature=0.0,
                                         deadline=time.time() - 1)
    assert past["choices"][0]["finish_reason"] == "deadline"
    assert past["usage"]["completion_tokens"] <= 1 + engine.decode_chunk
    aborted = engine.create_chat_completion(MSGS, temperature=0.0, abort=lambda: True)
    assert aborted["choices"][0]["finish_reason"] == "deadline"


def test_oversized_prompt_and_warmup(engine):
    with pytest.raises(ValueError, match="exceed context window"):
        engine.create_chat_completion([{"role": "user", "content": "x" * 600}])
    engine.warmup()
    assert engine.create_chat_completion(MSGS, temperature=0.0)["usage"][
        "completion_tokens"] == 20


def test_kv_dtype_is_checked_before_the_file_is_read(tmp_path):
    """An unknown ``kv_dtype`` or a ``decode_layer_unroll`` below -1 raises
    ValueError at once: the file named is never opened (it does not
    exist)."""
    with pytest.raises(ValueError, match="kv_dtype"):
        Engine(str(tmp_path / "absent.gguf"), kv_dtype="fp8", device="cpu")
    with pytest.raises(ValueError, match="decode_layer_unroll"):
        Engine(str(tmp_path / "absent.gguf"), decode_layer_unroll=-2, device="cpu")
    with pytest.raises(FileNotFoundError):
        Engine(str(tmp_path / "absent.gguf"), kv_dtype="int8", device="cpu")


def test_looped_int8_engine_matches_its_per_layer_twin(tmp_path):
    """``weight_format="int8"`` with one looped launch a token: the greedy
    completion is the per-layer engine's on the same weights (on the CPU
    the looped step is the per-layer arithmetic), and the engine's config
    carries the unroll."""
    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama_gguf(path, quant=JGGMLType.F16)
    kw = dict(n_ctx=256, max_gen_tokens=12, weight_format="int8", device="cpu")
    looped = Engine(path, decode_layer_unroll=-1, **kw)
    plain = Engine(path, decode_layer_unroll=0, **kw)
    assert looped.cfg.decode_layer_unroll == -1 and plain.cfg.decode_layer_unroll == 0
    assert set(looped.params.formats().values()) == {"int8"}
    a = looped.create_chat_completion(MSGS, temperature=0.0, seed=3)
    b = plain.create_chat_completion(MSGS, temperature=0.0, seed=3)
    assert a["choices"][0]["message"] == b["choices"][0]["message"]
    assert a["usage"]["completion_tokens"] == 12


@pytest.mark.parametrize("impl,want", [("auto", "xla"), ("xla", "xla"),
                                       ("pallas", "flash"), ("flash", "flash")])
def test_engine_takes_every_reference_attn_impl(tmp_path, impl, want):
    """The reference's ``attn_impl`` values (auto | xla | pallas) and the
    port's ``flash`` build an engine; ``pallas`` names the flash path (on
    the CPU, its plain version), ``auto`` on the CPU the score matrix.
    Greedy text is the same on every path of the tiny model."""
    path = str(tmp_path / "tiny.gguf")
    write_tiny_llama_gguf(path, quant=JGGMLType.F16)
    eng = Engine(path, n_ctx=256, max_gen_tokens=8, attn_impl=impl, device="cpu")
    assert eng.cfg.attn_impl == want
    ref = Engine(path, n_ctx=256, max_gen_tokens=8, attn_impl="xla", device="cpu")
    got = eng.create_chat_completion(MSGS, temperature=0.0, seed=1)
    assert got["choices"][0]["message"] == \
        ref.create_chat_completion(MSGS, temperature=0.0, seed=1)["choices"][0]["message"]
    with pytest.raises(ValueError, match="attn_impl"):
        Engine(path, n_ctx=256, attn_impl="mosaic", device="cpu")


@pytest.mark.parametrize("n_heads,n_kv,want", [(32, 8, "flash"), (32, 1, "flash"),
                                               (64, 1, "flash"), (24, 8, "xla"),
                                               (40, 8, "xla"), (128, 1, "xla")])
def test_auto_attention_follows_the_flash_kernels_group_limit(n_heads, n_kv, want):
    """``auto`` picks flash on the GPU for any GQA group dividing the
    kernel's 64 query rows (groups 4, 32 and 64 here) and the score matrix
    for a group that does not (3, 5, 128); on the CPU always the score
    matrix."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine.engine import resolve_attn_impl
    from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
    from llama_fastapi_k8s_gpu_tpu_torch.ops.attention import _ROWS

    cfg = ModelConfig(vocab_size=256, dim=n_heads * 128, n_layers=1, n_heads=n_heads,
                      n_kv_heads=n_kv, ffn_dim=256, n_ctx=64)
    assert cfg.head_dim == 128
    assert (want == "flash") == (_ROWS % (n_heads // n_kv) == 0)
    assert resolve_attn_impl("auto", cfg, torch.device("cuda")) == want
    assert resolve_attn_impl("auto", cfg, torch.device("cpu")) == "xla"

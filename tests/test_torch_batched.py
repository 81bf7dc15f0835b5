"""The port's cycle-scheduler engine (engine/batched.py ``MeshEngine``) on
the CPU, held to the JAX package's ``MeshEngine`` (``dp=1, tp=1``) and to
the port's serial ``Engine`` on the same tiny file.

Greedy replies of one cycle are byte-equal to the reference's cycle and to
the serial engine's, on the tiny Llama over the bf16 and the int8 ring and
on the tiny Mistral past its window; then the semantics of
``tests/test_batched_engine.py`` (order, padding invariance, overflow,
timings, an oversized prompt failing alone, per-lane capacity) and the
port's own: per-entry deadlines, a mesh too large for the host refused,
the lane state zeroed in place by ``recover``, the ``kv_lanes`` ledger
row.
"""

from __future__ import annotations

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import MeshEngine as JMeshEngine
from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf, write_tiny_mistral_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine, MeshEngine

torch.set_num_threads(1)
MSGS = [{"role": "user", "content": "Say something."}]
KW = dict(n_ctx=128, decode_chunk=4, max_gen_tokens=16, prefill_buckets=(32, 64, 128))
PROMPTS = [[{"role": "user", "content": f"prompt number {i} " * (1 + i % 3)}]
           for i in range(4)]


def _texts(outs) -> list:
    return [o["choices"][0]["message"]["content"] for o in outs]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("batched")
    llama = str(d / "tiny.gguf")
    write_tiny_llama_gguf(llama, quant=JGGMLType.F16)
    mistral = str(d / "mistral.gguf")
    write_tiny_mistral_gguf(mistral)
    return {"llama": llama, "mistral": mistral}


@pytest.fixture(scope="module")
def mesh_engine(files):
    return MeshEngine(files["llama"], batch_size=4, device="cpu", **KW)


@pytest.mark.parametrize("arch,kv_dtype", [("llama", "bf16"), ("llama", "int8"),
                                           ("mistral", "bf16")])
def test_cycle_greedy_bytes_equal_the_reference_and_serial(files, arch, kv_dtype):
    """Four requests in one cycle at temperature 0: the port's replies equal
    the JAX MeshEngine's byte for byte, and the port's serial engine's."""
    kw = dict(KW, kv_dtype=kv_dtype)
    if arch == "mistral":
        kw["n_ctx"], kw["prefill_buckets"] = 256, (64, 128, 256)
    path = files[arch]
    want = _texts(JMeshEngine(path, dp=1, tp=1, batch_size=4, **kw).create_chat_completions(
        PROMPTS, temperature=0.0, max_tokens=12))
    port = MeshEngine(path, batch_size=4, device="cpu", **kw)
    got = _texts(port.create_chat_completions(PROMPTS, temperature=0.0, max_tokens=12))
    serial = Engine(path, device="cpu", **kw)
    alone = [serial.create_chat_completion(p, temperature=0.0, max_tokens=12)
             ["choices"][0]["message"]["content"] for p in PROMPTS]
    assert got == want
    assert got == alone
    assert len(set(got)) > 1


def test_batch_shapes_and_order(mesh_engine):
    outs = mesh_engine.create_chat_completions(PROMPTS[:3], max_tokens=6, seed=0)
    assert len(outs) == 3
    for o in outs:
        assert o["object"] == "chat.completion"
        assert o["usage"]["completion_tokens"] <= 6
        assert o["choices"][0]["finish_reason"] in ("stop", "length")


def test_batch_of_one_matches_engine_greedy(mesh_engine, files):
    single = Engine(files["llama"], device="cpu", **KW)
    a = single.create_chat_completion(MSGS, temperature=0.0, max_tokens=8)
    b = mesh_engine.create_chat_completions([MSGS], temperature=0.0, max_tokens=8)[0]
    assert a["choices"][0]["message"]["content"] == b["choices"][0]["message"]["content"]


def test_batch_greedy_is_padding_invariant(mesh_engine):
    solo = mesh_engine.create_chat_completions([MSGS], temperature=0.0, max_tokens=8)[0]
    crowd = mesh_engine.create_chat_completions(
        [MSGS, [{"role": "user", "content": "a much longer and very different prompt "
                 "that pads the bucket further out"}]],
        temperature=0.0, max_tokens=8)[0]
    assert solo["choices"][0]["message"]["content"] == \
        crowd["choices"][0]["message"]["content"]


def test_batch_overflow_raises(mesh_engine):
    with pytest.raises(ValueError):
        mesh_engine.create_chat_completions([MSGS] * 5)


def test_timings_recorded(mesh_engine):
    mesh_engine.create_chat_completions([MSGS] * 2, max_tokens=4, seed=1)
    t = mesh_engine.last_timings
    assert t["ttft_s"] > 0 and t["completion_tokens"] >= 2


def test_oversized_prompt_isolated(mesh_engine):
    big = [{"role": "user", "content": "x" * 600}]
    outs = mesh_engine.create_chat_completions([big, MSGS], max_tokens=4)
    assert "exceed context window" in outs[0]["error"]["message"]
    assert outs[1]["object"] == "chat.completion"
    assert outs[1]["usage"]["completion_tokens"] >= 1


def test_long_prompt_neighbor_does_not_truncate_short(mesh_engine):
    short = [{"role": "user", "content": "hi"}]
    long_p = [{"role": "user", "content": "y" * 80}]
    solo = mesh_engine.create_chat_completions([short], temperature=0.0, max_tokens=12)[0]
    crowd = mesh_engine.create_chat_completions([short, long_p], temperature=0.0,
                                                max_tokens=12)[0]
    assert crowd["usage"]["completion_tokens"] == solo["usage"]["completion_tokens"]
    assert crowd["choices"][0]["message"]["content"] == \
        solo["choices"][0]["message"]["content"]


def test_per_entry_deadline_and_abort_stop_their_entry_alone(mesh_engine):
    """An entry whose deadline has passed, and one whose abort fires, end
    with ``deadline`` after their first token; their neighbour runs to its
    budget."""
    import time

    outs = mesh_engine.create_chat_completions(
        [MSGS, MSGS, MSGS], temperature=0.0, max_tokens=12,
        deadlines=[time.time() - 1, None, None], aborts=[None, lambda: True, None])
    assert [o["choices"][0]["finish_reason"] for o in outs[:2]] == ["deadline"] * 2
    assert outs[0]["usage"]["completion_tokens"] == 1
    assert outs[2]["usage"]["completion_tokens"] == 12


def test_tp_above_one_is_refused(files):
    """On a one-device host a mesh of two is refused, as the JAX package's
    ``make_mesh`` refuses it (a list of devices serves it:
    tests/test_torch_mesh.py)."""
    with pytest.raises(ValueError, match="mesh 1x2x1 needs 2 devices, have 1"):
        MeshEngine(files["llama"], tp=2, batch_size=2, device="cpu", **KW)
    with pytest.raises(ValueError, match="mesh 2x1x1 needs 2 devices, have 1"):
        MeshEngine(files["llama"], dp=2, batch_size=2, device="cpu", **KW)


def test_recover_zeroes_the_lane_state_in_place(mesh_engine):
    """``recover`` keeps every lane leaf's storage (the lane graphs hold the
    addresses on the card) and zeroes it; the next cycle serves as before."""
    before = _texts(mesh_engine.create_chat_completions(PROMPTS, temperature=0.0,
                                                        max_tokens=6))
    s = mesh_engine._bstate
    ptrs = {k: v.data_ptr() for k, v in s["cache"].items()}
    assert mesh_engine.recover() is True
    assert {k: v.data_ptr() for k, v in s["cache"].items()} == ptrs
    assert all(not v.any() for v in s["cache"].values())
    assert bool((s["window"] == -1).all()) and not s["pos"].any()
    after = _texts(mesh_engine.create_chat_completions(PROMPTS, temperature=0.0,
                                                       max_tokens=6))
    assert after == before


def test_kv_lanes_ledger_row(mesh_engine):
    from llama_fastapi_k8s_gpu_tpu_torch.obs.memledger import MEMLEDGER
    from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import state_nbytes

    rows = {r["component"]: r["bytes"] for r in MEMLEDGER.snapshot()["components"]
            if r["model"] == mesh_engine.model_name}
    assert rows["kv_lanes"] >= state_nbytes(mesh_engine._bstate) > 0
    assert state_nbytes(mesh_engine._bstate) >= 4 * mesh_engine.kv_cache_bytes


def test_streams_take_the_serial_path(mesh_engine):
    """A stream of the cycle engine is the serial engine's stream: its text
    equals a one-entry cycle's reply."""
    chunks = list(mesh_engine.create_chat_completion(MSGS, stream=True, temperature=0.0,
                                                     max_tokens=8))
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    want = mesh_engine.create_chat_completions([MSGS], temperature=0.0, max_tokens=8)[0]
    assert text == want["choices"][0]["message"]["content"]

"""The port's compile and dispatch registry against the JAX package's.

The same producer calls on both registries give the same counters,
storms, event replays and ``/debug/compiles`` document; a request on the
port's engine dispatches what the same request dispatches on the JAX
engine (the reference's pins, tests/test_perf_pins.py: ``prefill`` 1,
``first_sample`` 1, ``decode_chunk`` 2 for ``max_tokens=9`` at chunks of
4); the registry's programs include every kernel, whose dispatches are
its launch counter; a storm reaches the in-flight traces; and a disarmed
registry is never touched on the decode path.  On the CPU nothing
compiles: the port compiles only graph captures and the kernel build,
both the card's.
"""

from __future__ import annotations

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.obs import devtime as jdevtime
from llama_fastapi_k8s_gpu_tpu.obs import trace as jtrace
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import Engine
from llama_fastapi_k8s_gpu_tpu_torch.obs import devtime, trace
from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS

torch.set_num_threads(1)

MSGS = [{"role": "user", "content": "Say something."}]
#: the reference pins' engine shapes
KW = dict(n_ctx=128, decode_chunk=4, max_gen_tokens=16, prefill_buckets=(32, 64, 128))

#: producer scripts: ("d", program) a dispatch, ("c", program, signature,
#: wall) a compile
SCRIPTS = {
    "captures": [("c", "decode_chunk", "top_k=40", 0.25), ("d", "prefill"),
                 ("d", "first_sample"), ("d", "decode_chunk"), ("d", "decode_chunk"),
                 ("c", "decode_chunk", "top_k=5", 0.125), ("c", "kernel_build", "ab12", 21.5)],
    "storm": [("c", "decode_chunk", f"top_k={k}", 0.1 * k) for k in (40, 5, 6, 7, 8)]
             + [("c", "decode_chunk", "top_k=5", 0.5), ("c", "decode_chunk", "top_k=9", 0.1)],
    "recapture": [("c", "p", "a", 1.0), ("c", "p", "a", 2.0), ("c", "p", "b", 3.0),
                  ("d", "p"), ("d", "q")],
}


def _run(reg, script):
    for step in script:
        if step[0] == "d":
            reg.record_dispatch(step[1])
        else:
            reg.record_compile(*step[1:])


def _no_at(doc):
    if isinstance(doc, dict):
        return {k: _no_at(v) for k, v in doc.items() if k != "at"}
    if isinstance(doc, list):
        return [_no_at(v) for v in doc]
    return doc


@pytest.mark.parametrize("budget", [2, 32])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_registry_like_the_reference(script, budget):
    """Counters, storms, the snapshot document and the event replay with
    its cursor are the reference's for the same calls."""
    mine = devtime.DevtimeRegistry(armed=True, budget=budget)
    ref = jdevtime.DevtimeRegistry(armed=True, budget=budget)
    for reg in (mine, ref):
        _run(reg, SCRIPTS[script])
    assert mine.counters() == ref.counters()
    assert mine.storms() == ref.storms() and mine.storms_total == ref.storms_total
    assert mine.snapshot() == ref.snapshot()
    cursors = [reg.events_since(-1) for reg in (mine, ref)]
    assert cursors[0][0] == cursors[1][0] and _no_at(cursors[0][1]) == _no_at(cursors[1][1])
    for reg in (mine, ref):
        _run(reg, SCRIPTS[script][:2])
    again = [reg.events_since(c[0]) for reg, c in zip((mine, ref), cursors)]
    assert again[0][0] == again[1][0] and _no_at(again[0][1]) == _no_at(again[1][1])
    for reg in (mine, ref):
        reg.reset()
    assert mine.snapshot() == ref.snapshot()


def test_event_ring_overflow_counts_the_dropped_events_like_the_reference(monkeypatch):
    for mod in (devtime, jdevtime):
        monkeypatch.setattr(mod, "MAX_EVENTS", 4)
    mine, ref = devtime.DevtimeRegistry(True, 32), jdevtime.DevtimeRegistry(True, 32)
    out = []
    for reg in (mine, ref):
        cur, _ = reg.events_since(0)
        for i in range(9):
            reg.record_compile("p", f"s{i}", 0.01)
        cur, events = reg.events_since(cur)
        out.append((cur, [e["signature"] for e in events], reg.events_dropped))
    assert out[0] == out[1] == (9, ["s5", "s6", "s7", "s8"], 5)


def _delta(before: dict, after: dict) -> dict:
    return {n: c["dispatches"] - before.get(n, {}).get("dispatches", 0)
            for n, c in after.items()
            if c["dispatches"] != before.get(n, {}).get("dispatches", 0)}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("devtime") / "tiny.gguf")
    write_tiny_llama_gguf(path)
    return path


@pytest.mark.parametrize("prefill_chunk", [256, 32])
def test_request_dispatches_equal_the_references(model_path, prefill_chunk):
    """One request of ``max_tokens=9`` at chunks of 4 dispatches ``prefill``
    (or a ``prefill_chunk`` a slice) once, ``first_sample`` once and
    ``decode_chunk`` twice, on both engines, twice in a row; the port
    compiles nothing on the CPU."""
    eng = Engine(model_path, **KW, prefix_cache=False, prefill_chunk=prefill_chunk,
                 device="cpu")
    ref = JEngine(model_path, **KW, prefix_cache=False, prefill_chunk=prefill_chunk)
    ref.create_chat_completion(MSGS, temperature=0.0, max_tokens=9)   # compiles
    compiles = {n: c["compiles"] for n, c in devtime.DEVTIME.counters().items()}
    for _ in range(2):
        got = []
        for e, reg in ((eng, devtime.DEVTIME), (ref, jdevtime.DEVTIME)):
            before = reg.counters()
            e.create_chat_completion(MSGS, temperature=0.0, max_tokens=9)
            got.append(_delta(before, reg.counters()))
        assert got[0] == got[1]
        assert got[0]["first_sample"] == 1 and got[0]["decode_chunk"] == 2
    assert {n: c["compiles"] for n, c in devtime.DEVTIME.counters().items()} == compiles


def test_snapshot_schema_is_the_references():
    mine = devtime.DEVTIME.snapshot()
    ref = jdevtime.DEVTIME.snapshot()
    assert set(mine) == set(ref)
    assert {tuple(sorted(p)) for p in mine["programs"]} == \
        {tuple(sorted(p)) for p in ref["programs"]}
    assert mine["degrades"] == []


def test_kernels_are_inner_programs_counting_their_launches(monkeypatch):
    """Every kernel wrapper is an inner program whose dispatches are its
    launch counter; the kernel build is a host program."""
    progs = {p["name"]: p for p in devtime.DEVTIME.snapshot()["programs"]}
    for name, fn in KERNELS.items():
        assert progs[name]["kind"] == devtime.INNER
        monkeypatch.setattr(fn, "launches", fn.launches + 7)
    counters = devtime.DEVTIME.counters()
    assert {n: counters[n]["dispatches"] for n in KERNELS} == \
        {n: fn.launches for n, fn in KERNELS.items()}
    assert progs["kernel_build"]["kind"] == devtime.ENTRY
    with pytest.raises(NotImplementedError):
        devtime.DEVTIME.record_degrade("flash_attention", "no degrade in the port")


def test_a_storm_reaches_every_inflight_trace_like_the_reference():
    events = []
    for mod, tmod in ((devtime, trace), (jdevtime, jtrace)):
        reg = mod.DevtimeRegistry(armed=True, budget=1)
        tracer = tmod.Tracer(sample=1.0, ring=4)
        tr = tracer.start()
        reg.record_compile("decode_chunk", "top_k=40", 0.1)
        reg.record_compile("decode_chunk", "top_k=5", 0.1)
        events.append([{k: v for k, v in e.items() if k != "at"}
                       for e in tr.to_dict()["root"]["events"]])
        tracer.finish(tr)
    assert events[0] == events[1] == [{"name": "recompile_storm", "program": "decode_chunk",
                                       "signatures": 2, "budget": 1}]


def test_disarmed_engine_decode_path_is_poison_proof(monkeypatch, model_path):
    """``LFKT_DEVTIME=0``: a whole generation never touches the registry."""
    def boom(*a, **kw):
        raise AssertionError("disarmed devtime touched its registry")

    eng = Engine(model_path, **KW, device="cpu")
    devtime.DEVTIME.configure(armed=False)
    try:
        monkeypatch.setattr(devtime.DEVTIME, "record_dispatch", boom)
        monkeypatch.setattr(devtime.DEVTIME, "record_compile", boom)
        out = eng.create_chat_completion(MSGS, temperature=0.0, max_tokens=8)
        assert out["usage"]["completion_tokens"] >= 1
    finally:
        devtime.DEVTIME.configure(armed=True)

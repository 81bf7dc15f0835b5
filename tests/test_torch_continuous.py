"""The port's continuous scheduler (engine/continuous.py) on the CPU.

Held to the JAX package's ``ContinuousEngine`` (``dp=1, tp=1``) and to the
port's serial ``Engine`` on the same tiny files: greedy replies of a wave
of concurrent requests byte-equal on the tiny Llama over the bf16 and the
int8 ring and on the tiny Mistral; ``scheduler_stats`` keys equal; the
``AdmissionController`` returns the reference controller's budgets and
stats on the same observations.  Then the semantics of
``tests/test_continuous.py`` and ``tests/test_admission.py`` without the
paged, speculative and sharded-mesh cases, and the port's own: a seeded
sampled request's bytes do not depend on its lane or its neighbours, and
``recover`` restarts a dead scheduler (and refuses after ``shutdown``).
Every future is waited on with a timeout.
"""

from __future__ import annotations

import threading
import time
import types
from concurrent.futures import CancelledError

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import ContinuousEngine as JContinuousEngine
from llama_fastapi_k8s_gpu_tpu.engine.continuous import (
    AdmissionController as JAdmissionController,
)
from llama_fastapi_k8s_gpu_tpu.gguf import GGMLType as JGGMLType
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf, write_tiny_mistral_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import AdmissionController, ContinuousEngine, Engine
from llama_fastapi_k8s_gpu_tpu_torch.utils.health import EngineUnavailable

torch.set_num_threads(1)
MSGS = [{"role": "user", "content": "Say something."}]
KW = dict(n_ctx=128, decode_chunk=4, max_gen_tokens=16, prefill_buckets=(32, 64, 128))
T = 120     # seconds any future may take


def _text(out) -> str:
    return out["choices"][0]["message"]["content"]


def _ask(eng, messages, **kw) -> dict:
    """One completion through the scheduler, waited on with a timeout."""
    return eng.submit(messages, **kw).result(timeout=T)


def _drain(stream) -> list:
    """Every chunk of a stream, read on a thread joined with a timeout."""
    out: list = []
    th = threading.Thread(target=lambda: out.extend(stream), daemon=True)
    th.start()
    th.join(T)
    assert not th.is_alive(), "the stream did not finish"
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cont")
    llama = str(d / "tiny.gguf")
    write_tiny_llama_gguf(llama, quant=JGGMLType.F16)
    mistral = str(d / "mistral.gguf")
    write_tiny_mistral_gguf(mistral)
    return {"llama": llama, "mistral": mistral}


@pytest.fixture(scope="module")
def cengine(files):
    eng = ContinuousEngine(files["llama"], batch_size=4, device="cpu", **KW)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def serial(files):
    return Engine(files["llama"], device="cpu", prefix_cache=False, **KW)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _record(eng, sink: dict) -> None:
    """Wrap ``eng``'s ``_finish_slot`` (either package's): each finished
    request's prompt ids and generated ids, by prompt."""
    orig = eng._finish_slot

    def finish(slot, why):
        sink[tuple(slot.ids)] = list(slot.gens)
        return orig(slot, why)

    eng._finish_slot = finish


def _same_or_tie(jeng, prompt: list, got: list, want: list) -> None:
    """The port's greedy ids ``got`` equal the reference's ``want``, or part
    at a tie of the reference's own logits (the scheduler's knobs at
    temperature 0): its best, its token and the port's within one bf16 step
    (tests/test_torch_generate.py's rule); only the parting is compared."""
    import jax.numpy as jnp
    import numpy as np

    from llama_fastapi_k8s_gpu_tpu.models.llama import decode_step as j_decode_step
    from llama_fastapi_k8s_gpu_tpu.models.llama import forward as j_forward
    from llama_fastapi_k8s_gpu_tpu.models.llama import init_cache as j_init_cache
    from llama_fastapi_k8s_gpu_tpu.sampling.sample import SamplingParams as JSP
    from llama_fastapi_k8s_gpu_tpu.sampling.sample import apply_penalties, sampling_tensors
    from llama_fastapi_k8s_gpu_tpu.sampling.sample import seed_window as j_seed_window

    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert i is not None, f"one reply is a prefix of the other: {got} / {want}"
    cfg = jeng.cfg
    lg, cache = j_forward(jeng.params, cfg, jnp.asarray(prompt, jnp.int32), jnp.int32(0),
                          j_init_cache(cfg))
    for step, tok in enumerate(want[:i]):
        lg, cache = j_decode_step(jeng.params, cfg, jnp.int32(tok),
                                  jnp.int32(len(prompt) + step), cache)
    jw, _ = j_seed_window(list(prompt) + want[:i])
    sp = JSP(temperature=0.0, top_p=0.95, top_k=40, min_p=0.05, frequency_penalty=0.0,
             presence_penalty=0.0, repeat_penalty=1.1)
    pen = np.asarray(apply_penalties(lg, jw, sampling_tensors(sp)))
    best = pen.max()
    step = 2.0 ** (np.floor(np.log2(abs(best))) - 7)
    assert best - pen[want[i]] <= step and best - pen[got[i]] <= step, (
        f"greedy ids part at {i}: {got[i]} against the reference's {want[i]}, not a tie")


@pytest.mark.parametrize("arch,kv_dtype", [("llama", "bf16"), ("llama", "int8"),
                                           ("mistral", "bf16")])
def test_wave_greedy_bytes_equal_the_reference_and_serial(files, arch, kv_dtype):
    """Six concurrent greedy requests over four lanes: each reply equals the
    port's serial engine's byte for byte, and the JAX ContinuousEngine's —
    or parts from it only at a tie of the reference's logits (the port's
    serial engine parts there too)."""
    kw = dict(KW, kv_dtype=kv_dtype)
    if arch == "mistral":
        kw["n_ctx"], kw["prefill_buckets"] = 256, (64, 128, 256)
    prompts = [[{"role": "user", "content": f"wave {i} " * (1 + i % 4)}] for i in range(6)]
    ref = JContinuousEngine(files[arch], dp=1, tp=1, batch_size=4, **kw)
    port = ContinuousEngine(files[arch], batch_size=4, device="cpu", **kw)
    jids, pids = {}, {}
    _record(ref, jids)
    _record(port, pids)
    try:
        jf = [ref.submit(p, temperature=0.0, max_tokens=12) for p in prompts]
        pf = [port.submit(p, temperature=0.0, max_tokens=12) for p in prompts]
        want = [_text(f.result(timeout=T)) for f in jf]
        got = [_text(f.result(timeout=T)) for f in pf]
        assert set(port.scheduler_stats()) == set(ref.scheduler_stats())
    finally:
        ref.shutdown()
        port.shutdown()
    alone = Engine(files[arch], device="cpu", **kw)
    assert got == [_text(alone.create_chat_completion(p, temperature=0.0, max_tokens=12))
                   for p in prompts]
    assert set(jids) == set(pids) and len(pids) == len(prompts)
    for ids, gens in pids.items():
        _same_or_tie(ref, list(ids), gens, jids[ids])
    assert sum(g == w for g, w in zip(got, want)) >= len(prompts) - 1


def _drive(ctl, seq):
    return [(ctl.observe_wave(*obs), ctl.stats()) for obs in seq]


@pytest.mark.parametrize("seq", [
    [(4, 0.0, 0.010)] * 40,                          # idle lanes: grow to the ceiling
    [(8, 0.0, 0.010)] * 20,                          # slack while full: grow
    [(8, 0.9, 1.0)] * 20,                            # pressure: halve to the floor
    [(4, 1.0, 1.0)] * 30,                            # the cut beats idle growth
    [(8, 1.0, 1.0)] * 10 + [(8, 0.0, 1.0)] * 30,     # recovers after pressure
    [(8, 0.0, 0.0)] * 5,                             # zero-length waves
    [(0, 0.0, 0.0)] * 5,
    [(2, 0.3, 0.5), (8, 0.1, 0.2), (5, 0.6, 0.7), (8, 0.0, 0.1, True), (1, 0.0, 0.3)],
])
@pytest.mark.parametrize("kw", [{}, {"alpha": 5.0}, {"alpha": 0.0}, {"alpha": 0.5}])
def test_admission_controller_equals_the_reference(seq, kw):
    ours = AdmissionController(256, 8, 512, **kw)
    ref = JAdmissionController(256, 8, 512, **kw)
    assert (ours.min_budget, ours.max_budget, ours.budget, ours.alpha) == \
        (ref.min_budget, ref.max_budget, ref.budget, ref.alpha)
    assert _drive(ours, seq) == _drive(ref, seq)


@pytest.mark.parametrize("waves,lanes_live", [(5, 0), (5, 8)])
def test_observe_wave_handles_zero_wave(waves, lanes_live):
    ctl = AdmissionController(256, 8, 512)
    for _ in range(waves):
        b = ctl.observe_wave(lanes_live, 0.0, 0.0)
        assert b == b and b >= ctl.min_budget


def test_controller_seeds_from_first_observation():
    ctl = AdmissionController(256, 8, 512)
    start = ctl.budget
    for _ in range(3):
        ctl.observe_wave(8, 1.0, 1.0)
    assert ctl.budget < start and ctl.ema_pressure > 0.9


# ---------------------------------------------------------------------------
# the reference's scheduler semantics
# ---------------------------------------------------------------------------

def test_greedy_parity_with_serial(cengine, serial):
    a = serial.create_chat_completion(MSGS, temperature=0.0, max_tokens=8)
    b = _ask(cengine, MSGS, temperature=0.0, max_tokens=8)
    assert _text(a) == _text(b)


def test_more_requests_than_lanes(cengine):
    futs = [cengine.submit([{"role": "user", "content": f"request number {i}"}],
                           temperature=0.0, max_tokens=4 + (i % 3)) for i in range(8)]
    outs = [f.result(timeout=T) for f in futs]
    assert all(o["object"] == "chat.completion" for o in outs)
    assert all(o["usage"]["completion_tokens"] >= 1 for o in outs)


def test_concurrent_admissions_in_one_round_are_correct(cengine, serial):
    """A wave of 12 distinct short prompts: every reply equals the serial
    engine's (back-to-back admissions through the one scratch ring never
    bleed into each other)."""
    prompts = [[{"role": "user", "content": f"wave {i} " * (1 + i % 4)}] for i in range(12)]
    want = [_text(serial.create_chat_completion(p, temperature=0.0, max_tokens=6))
            for p in prompts]
    futs = [cengine.submit(p, temperature=0.0, max_tokens=6) for p in prompts]
    assert [_text(f.result(timeout=T)) for f in futs] == want


def test_submissions_are_deterministic_under_concurrency(cengine):
    solo = _ask(cengine, MSGS, temperature=0.0, max_tokens=8)
    futs = [cengine.submit([{"role": "user", "content": f"noise {i} " * (i + 1)}],
                           temperature=0.0, max_tokens=8) for i in range(3)]
    crowd = _ask(cengine, MSGS, temperature=0.0, max_tokens=8)
    for f in futs:
        f.result(timeout=T)
    assert _text(solo) == _text(crowd)


def test_oversized_prompt_errors_alone(cengine):
    bad = cengine.submit([{"role": "user", "content": "x" * 600}])
    good = cengine.submit(MSGS, temperature=0.0, max_tokens=4)
    with pytest.raises(ValueError, match="exceed context window"):
        bad.result(timeout=T)
    assert good.result(timeout=T)["usage"]["completion_tokens"] >= 1


def test_cancelled_before_admission_is_skipped(cengine):
    blockers = [cengine.submit(MSGS, temperature=0.0, max_tokens=12) for _ in range(4)]
    victim = cengine.submit(MSGS, max_tokens=4)
    cancelled = victim.cancel()
    done = [b.result(timeout=T) for b in blockers]
    assert all(d["object"] == "chat.completion" for d in done)
    if cancelled:
        assert victim.cancelled()
    else:
        assert victim.result(timeout=T)["object"] == "chat.completion"


def test_batch_facade_isolates_errors(cengine):
    outs = cengine.create_chat_completions(
        [[{"role": "user", "content": "x" * 600}], MSGS], temperature=0.0, max_tokens=4)
    assert "error" in outs[0]
    assert outs[1]["object"] == "chat.completion"


def test_per_lane_sampling_isolation(cengine):
    solo = _ask(cengine, MSGS, temperature=0.0, max_tokens=10)
    hot = [cengine.submit([{"role": "user", "content": f"hot {i}"}], temperature=1.8,
                          max_tokens=10, seed=i) for i in range(3)]
    cold = _ask(cengine, MSGS, temperature=0.0, max_tokens=10)
    for f in hot:
        f.result(timeout=T)
    assert _text(solo) == _text(cold)


def test_max_tokens_one(cengine):
    out = _ask(cengine, MSGS, temperature=0.0, max_tokens=1)
    assert out["usage"]["completion_tokens"] == 1


def test_stream_via_lanes_matches_nonstream(cengine):
    ref = _ask(cengine, MSGS, temperature=0.0, max_tokens=8)
    chunks = _drain(cengine.create_chat_completion(MSGS, stream=True, temperature=0.0,
                                                 max_tokens=8))
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    assert chunks[-1]["lfkt_timings"]["completion_tokens"] >= 1
    assert "".join(c["choices"][0]["delta"].get("content", "") for c in chunks) == _text(ref)


def test_stream_concurrent_with_batch(cengine):
    solo = _ask(cengine, MSGS, temperature=0.0, max_tokens=10)
    it = cengine.create_chat_completion(MSGS, stream=True, temperature=0.0, max_tokens=10)
    futs = [cengine.submit([{"role": "user", "content": f"bg {i}"}], temperature=1.5,
                           max_tokens=10, seed=i) for i in range(3)]
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in _drain(it))
    for f in futs:
        assert f.result(timeout=T)["object"] == "chat.completion"
    assert text == _text(solo)


def test_abandon_frees_lane(cengine):
    fut = cengine.submit(MSGS, temperature=0.0, max_tokens=100)
    for _ in range(500):
        if fut.running():
            break
        time.sleep(0.01)
    cengine.abandon(fut)
    try:
        out = fut.result(timeout=T)
    except CancelledError:
        out = None
    else:
        assert out["object"] == "chat.completion"
    ok = _ask(cengine, MSGS, temperature=0.0, max_tokens=4)
    assert ok["usage"]["completion_tokens"] >= 1


def test_stream_close_abandons_lane(cengine):
    it = cengine.create_chat_completion(MSGS, stream=True, temperature=0.0, max_tokens=100)
    next(it)
    next(it)
    it.close()
    ok = _ask(cengine, MSGS, temperature=0.0, max_tokens=4)
    assert ok["usage"]["completion_tokens"] >= 1


def test_abandon_stops_decode_within_one_chunk(cengine, monkeypatch):
    """After a stream closes the scheduler may finish the chunk in flight and
    the one queued behind it, then stops dispatching."""
    from llama_fastapi_k8s_gpu_tpu_torch.engine import continuous as cont

    calls = [0]
    orig = cont.generate_chunk_lanes

    def counting(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(cont, "generate_chunk_lanes", counting)
    it = cengine.create_chat_completion(MSGS, stream=True, temperature=0.0, max_tokens=100)
    next(it)
    next(it)
    at_close = calls[0]
    it.close()
    deadline = time.time() + 20
    last, stable_since = calls[0], time.time()
    while time.time() < deadline:
        time.sleep(0.05)
        if calls[0] != last:
            last, stable_since = calls[0], time.time()
        elif time.time() - stable_since > 0.5:
            break
    assert cengine.scheduler_stats()["lanes_live"] == 0
    assert calls[0] - at_close <= 4, (calls[0], at_close)


def test_per_request_top_k(cengine):
    greedy = _ask(cengine, MSGS, temperature=0.0, max_tokens=8)
    k1 = _ask(cengine, MSGS, temperature=1.5, top_k=1, max_tokens=8,
                                        seed=123)
    assert _text(k1) == _text(greedy)


def test_stream_stop_string_holdback(cengine):
    base = _ask(cengine, MSGS, temperature=0.0, max_tokens=12)
    text = _text(base)
    stop = text[3:6]
    assert len(stop) == 3
    ref = _ask(cengine, MSGS, temperature=0.0, max_tokens=12, stop=[stop])
    chunks = _drain(cengine.create_chat_completion(MSGS, stream=True, temperature=0.0,
                                                 max_tokens=12, stop=[stop]))
    stext = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert stext == _text(ref)
    assert stop not in stext


def test_abandon_queued_request_resolves_future(cengine):
    blockers = [cengine.submit(MSGS, temperature=0.0, max_tokens=30) for _ in range(4)]
    victim = cengine.submit(MSGS, max_tokens=4)
    cengine.abandon(victim)
    try:
        victim.result(timeout=T)
    except CancelledError:
        pass
    assert victim.done()
    for b in blockers:
        assert b.result(timeout=T)["object"] == "chat.completion"


def test_scheduler_stats_surface(cengine):
    _ask(cengine, MSGS, temperature=0.0, max_tokens=4)
    stats = cengine.scheduler_stats()
    assert stats["batch_size"] == 4
    assert {"batch_size", "lanes_live", "pending", "admission_inflight"} <= set(stats)
    assert stats["adm_budget_tokens"] >= cengine._prefill_chunk
    assert 0.0 <= stats["adm_ema_idle"] <= 1.0
    assert 0.0 <= stats["adm_ema_pressure"] <= 1.0
    assert stats["lane_idle_seconds"] >= 0.0
    deadline = time.time() + 10
    while time.time() < deadline and cengine.scheduler_stats()["lanes_live"]:
        time.sleep(0.05)
    assert cengine.scheduler_stats()["lanes_live"] == 0
    assert cengine.scheduler_stats()["pending"] == 0


def test_scratch_none_recovers(cengine):
    cengine._scratch_cache = None
    out = _ask(cengine, [{"role": "user", "content": "recover please"}],
                                         temperature=0.0, max_tokens=4)
    assert out["usage"]["completion_tokens"] >= 1
    assert cengine._scratch_cache is not None


def test_decode_progresses_during_admission_wave(cengine):
    """Live lanes keep decoding while a wave of slow admissions prefills:
    with one slice a wave, a live stream's gap stays near one admission."""
    warm_it = iter(cengine.submit_stream([{"role": "user", "content": "warm stream"}],
                                         temperature=0.0, max_tokens=8))
    next(warm_it)
    warm = [cengine.submit([{"role": "user", "content": f"warm {j}"}], temperature=0.0,
                           max_tokens=2) for j in range(2)]
    _drain(warm_it)
    for f in warm:
        f.result(timeout=T)
    delay, n_wave = 0.4, 4
    orig = cengine._dispatch_prefill_chunk
    admitted = []

    def slow_chunk(adm):
        if admitted:
            time.sleep(delay)
        admitted.append(adm["n_prompt"])
        return orig(adm)

    cengine._dispatch_prefill_chunk = slow_chunk
    budget_saved, ctl_saved = cengine._adm_budget, cengine._adm_ctl
    cengine._adm_ctl = None
    cengine._adm_budget = 1
    try:
        it = iter(cengine.submit_stream([{"role": "user", "content": "stream me"}],
                                        temperature=0.0, max_tokens=14))
        next(it)
        gaps, t_prev, wave = [], time.perf_counter(), None
        for i, _chunk in enumerate(it):
            now = time.perf_counter()
            gaps.append(now - t_prev)
            t_prev = now
            if i == 0:
                wave = [cengine.submit([{"role": "user", "content": f"wave {j}"}],
                                       temperature=0.0, max_tokens=2) for j in range(n_wave)]
        assert wave is not None
        for f in wave:
            f.result(timeout=T)
        assert max(gaps) < (n_wave - 1) * delay, gaps
    finally:
        cengine._dispatch_prefill_chunk = orig
        cengine._adm_ctl = ctl_saved
        cengine._adm_budget = budget_saved


def test_chunked_prefill_bounds_stall_per_slice(files):
    """A long-prompt admission prefills in slices: a live stream's gap is
    bounded by ~one slice, not the whole bucket."""
    eng = ContinuousEngine(files["llama"], batch_size=2, n_ctx=128, decode_chunk=4,
                           max_gen_tokens=24, prefill_buckets=(64,), prefill_chunk=16,
                           adm_budget=16, adm_controller=False, device="cpu")
    try:
        eng.submit([{"role": "user", "content": "y " * 40}], temperature=0.0,
                   max_tokens=2).result(timeout=T)
        delay = 0.25
        orig = eng._dispatch_prefill_chunk
        n_slices = []

        def slow_chunk(adm):
            if n_slices:
                time.sleep(delay)
            n_slices.append(adm["offset"])
            return orig(adm)

        eng._dispatch_prefill_chunk = slow_chunk
        it = iter(eng.submit_stream([{"role": "user", "content": "stream me"}],
                                    temperature=0.0, max_tokens=20))
        next(it)
        gaps, t_prev, fut = [], time.perf_counter(), None
        for i, _chunk in enumerate(it):
            now = time.perf_counter()
            gaps.append(now - t_prev)
            t_prev = now
            if i == 0:
                fut = eng.submit([{"role": "user", "content": "x " * 40}], temperature=0.0,
                                 max_tokens=2)
        assert fut is not None
        fut.result(timeout=T)
        assert len([o for o in n_slices if o == 0]) >= 2
        assert max(gaps) < 3 * delay, gaps
    finally:
        eng.shutdown()


def test_outputs_independent_of_adm_budget(files):
    prompts = [[{"role": "user", "content": f"budget wave {i} " * (1 + i % 3)}]
               for i in range(8)]

    def run(budget):
        eng = ContinuousEngine(files["llama"], batch_size=4, adm_budget=budget, device="cpu",
                               **KW)
        try:
            if budget == 1:
                eng._adm_budget = 1
            futs = [eng.submit(p, temperature=0.0, max_tokens=8) for p in prompts]
            return [_text(f.result(timeout=T)) for f in futs]
        finally:
            eng.shutdown()

    assert run(1) == run(512)


def test_static_budget_mode_and_one_slice_a_wave(files):
    eng = ContinuousEngine(files["llama"], batch_size=2, n_ctx=128, decode_chunk=4,
                           max_gen_tokens=16, prefill_buckets=(32, 64), prefill_chunk=16,
                           adm_budget=48, adm_controller=False, lane_prefix_cache=False,
                           device="cpu")
    try:
        assert eng._adm_ctl is None
        _ask(eng, [{"role": "user", "content": "hello"}], temperature=0.0,
                                   max_tokens=4)
        assert eng._adm_budget == 48
        stats = eng.scheduler_stats()
        assert stats["adm_budget_tokens"] == 48 and "adm_ema_idle" not in stats
    finally:
        eng.shutdown()
    calls = []

    def fake_admit_step(slots):
        calls.append(1)
        eng._adm = {"fake": "mid-prompt"}
        return 16

    eng._admit_step = fake_admit_step
    try:
        assert eng._admit_round([None, None]) is True
        assert len(calls) == 1                # static: one slice a wave
        calls.clear()
        eng._adm = None
        eng._adm_ctl = AdmissionController(16, 2, 64)
        eng._adm_budget = 64
        assert eng._admit_round([None, None]) is True
        assert len(calls) == 4                # controller: the budget in slices
    finally:
        eng._adm = None


def test_deadline_request_progresses_at_budget_floor(files):
    eng = ContinuousEngine(files["llama"], batch_size=2, n_ctx=128, decode_chunk=4,
                           max_gen_tokens=32, prefill_buckets=(32, 64), prefill_chunk=16,
                           lane_prefix_cache=False, device="cpu")
    try:
        ctl = eng._adm_ctl
        ctl.ema_idle, ctl.ema_pressure, ctl.budget = 0.0, 1.0, ctl.min_budget
        eng._adm_budget = ctl.min_budget
        blocker = eng.submit([{"role": "user", "content": "keep decoding"}], temperature=0.0,
                             max_tokens=30)
        fut = eng.submit([{"role": "user", "content": "x " * 40}], temperature=0.0,
                         max_tokens=4, deadline=time.time() + 30)
        assert fut.result(timeout=T)["usage"]["completion_tokens"] >= 1
        blocker.result(timeout=T)
    finally:
        eng.shutdown()


def test_shutdown_resolves_outstanding(files):
    eng = ContinuousEngine(files["llama"], batch_size=2, n_ctx=64, decode_chunk=2,
                           max_gen_tokens=64, prefill_buckets=(32, 64), device="cpu")
    futs = [eng.submit(MSGS, max_tokens=60) for _ in range(4)]
    eng.shutdown()
    for f in futs:
        try:
            f.result(timeout=30)
        except Exception:  # noqa: BLE001 — any resolution will do
            pass
        assert f.done()
    with pytest.raises(EngineUnavailable):
        eng.submit(MSGS)
    assert eng.recover() is False          # a deliberate stop is not a fault


def test_recover_restarts_a_dead_scheduler(files):
    """A scheduler killed by an exception is the engine's failure; recover
    zeroes the lane state in place and restarts the thread, and the engine
    serves the same greedy reply again."""
    eng = ContinuousEngine(files["llama"], batch_size=2, device="cpu", **KW)
    try:
        want = _text(_ask(eng, MSGS, temperature=0.0, max_tokens=6))
        assert eng.recover() is False          # alive and well: refused
        boom = RuntimeError("scheduler boom")
        harvest = eng._harvest

        def die(pre, *a, **kw):
            # the previous request resolved before the scheduler read its
            # trailing chunk (the pipeline runs one chunk deep): that harvest
            # holds only finished slots and must not be the one that dies
            if all(s is None or s.finished for s in pre):
                return harvest(pre, *a, **kw)
            raise boom

        eng._harvest = die
        fut = eng.submit(MSGS, temperature=0.0, max_tokens=12)
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=T)
        eng._thread.join(timeout=10)
        assert eng.failure() is boom and not eng._thread.is_alive()
        with pytest.raises(EngineUnavailable):
            eng.submit(MSGS)
        del eng._harvest
        ptrs = {k: v.data_ptr() for k, v in eng._bstate["cache"].items()}
        assert eng.recover() is True and eng.failure() is None
        assert {k: v.data_ptr() for k, v in eng._bstate["cache"].items()} == ptrs
        assert _text(_ask(eng, MSGS, temperature=0.0, max_tokens=6)) == want
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# seeded sampling does not depend on the lane
# ---------------------------------------------------------------------------

def test_seeded_sample_is_the_same_in_any_lane_and_beside_neighbours(cengine):
    """A request at temperature 1.2 with seed 7: the same bytes alone (lane
    0), in lane 3 beside three running neighbours, and in lane 0 with three
    neighbours admitted after it."""
    prompt = [{"role": "user", "content": "tell me something random"}]
    kw = dict(temperature=1.2, max_tokens=12, seed=7)
    alone = _text(_ask(cengine, prompt, **kw))
    lanes = []
    orig = cengine._finish_admission

    def record(adm, lane, slots):
        if adm["item"].seed == 7:
            lanes.append(lane)
        return orig(adm, lane, slots)

    cengine._finish_admission = record
    try:
        blockers = [cengine.submit([{"role": "user", "content": f"neighbour {i}"}],
                                   temperature=0.9, max_tokens=40, seed=100 + i)
                    for i in range(3)]
        deadline = time.time() + 30
        while cengine.scheduler_stats()["lanes_live"] < 3 and time.time() < deadline:
            time.sleep(0.01)
        beside = _text(cengine.submit(prompt, **kw).result(timeout=T))
        for b in blockers:
            b.result(timeout=T)
        first = cengine.submit(prompt, **kw)
        after = [cengine.submit([{"role": "user", "content": f"later {i}"}],
                                temperature=1.5, max_tokens=12, seed=i) for i in range(3)]
        lane0 = _text(first.result(timeout=T))
        for f in after:
            f.result(timeout=T)
    finally:
        cengine._finish_admission = orig
    assert lanes == [3, 0]
    assert beside == alone == lane0


# ---------------------------------------------------------------------------
# lane-prefix reuse
# ---------------------------------------------------------------------------

LP_SYS = ("You are a meticulous assistant who answers carefully. " * 4).strip()


def _lp_multiturn(reply=None, new="And another one please."):
    msgs = [{"role": "system", "content": LP_SYS},
            {"role": "user", "content": "Tell me something interesting please."}]
    if reply is not None:
        msgs += [{"role": "assistant", "content": reply}, {"role": "user", "content": new}]
    return msgs


@pytest.fixture(scope="module")
def lp_engine(files):
    eng = ContinuousEngine(files["llama"], batch_size=2, n_ctx=512, decode_chunk=4,
                           max_gen_tokens=16, prefill_chunk=16, lane_prefix_cache=True,
                           prefill_buckets=(64, 128, 256, 512), device="cpu")
    yield eng
    eng.shutdown()


def test_lane_prefix_reuse_fires_on_multiturn(lp_engine, files):
    t1 = _ask(lp_engine, _lp_multiturn(), temperature=0.0, max_tokens=8)
    assert t1["lfkt_timings"]["prefix_reused_tokens"] == 0
    follow = _lp_multiturn(_text(t1))
    t2 = _ask(lp_engine, follow, temperature=0.0, max_tokens=8)
    reused = t2["lfkt_timings"]["prefix_reused_tokens"]
    assert reused >= lp_engine._prefill_chunk and reused % lp_engine._prefill_chunk == 0
    assert reused < t2["usage"]["prompt_tokens"]
    stats = lp_engine.scheduler_stats()
    assert stats["lane_prefix_hits"] >= 1 and stats["lane_prefix_reused_tokens"] >= reused
    assert _text(t2)


def test_lane_prefix_repeated_reuse_stays_well_formed(lp_engine):
    t1 = _ask(lp_engine, _lp_multiturn(), temperature=0.0, max_tokens=8)
    for _ in range(3):
        out = _ask(lp_engine, _lp_multiturn(_text(t1)), temperature=0.0,
                                               max_tokens=8)
        assert out["lfkt_timings"]["prefix_reused_tokens"] >= lp_engine._prefill_chunk
        assert _text(out) and out["usage"]["completion_tokens"] >= 1


def test_lane_prefix_explicit_seed_bypasses(lp_engine):
    t1 = _ask(lp_engine, _lp_multiturn(), temperature=0.0, max_tokens=8)
    t2 = _ask(lp_engine, _lp_multiturn(_text(t1)), temperature=0.0,
                                          max_tokens=8, seed=5)
    assert t2["lfkt_timings"]["prefix_reused_tokens"] == 0


def test_lane_prefix_divergent_prompt_no_reuse(lp_engine):
    _ask(lp_engine, _lp_multiturn(), temperature=0.0, max_tokens=8)
    other = [{"role": "system", "content": "Terse pirate bot speaks here."},
             {"role": "user", "content": "List three fruits right now."}]
    got = _ask(lp_engine, other, temperature=0.0, max_tokens=8)
    assert got["lfkt_timings"]["prefix_reused_tokens"] == 0 and _text(got)


def test_lane_prefix_claim_bookkeeping_unit(lp_engine):
    chunk = lp_engine._prefill_chunk
    slot = types.SimpleNamespace(n_prompt=40, gens=[7, 8, 9], ids=list(range(40)))
    saved = list(lp_engine._lane_claims)
    try:
        lp_engine._free_lane(0, slot, [None, None])
        claim = lp_engine._lane_claims[0]
        assert claim == list(range(40)) + [7, 8]
        ids = claim + [99] * 30
        reuse, src = lp_engine._find_lane_reuse(ids, len(ids))
        assert src == 0 and reuse == (len(claim) // chunk) * chunk
        reuse, src = lp_engine._find_lane_reuse([1] * 64, 64)
        assert reuse == 0 and src is None
        # a claim never reaches past n_ctx-1
        slot = types.SimpleNamespace(n_prompt=500, gens=list(range(30)), ids=[1] * 500)
        lp_engine._free_lane(1, slot, [None, None])
        assert len(lp_engine._lane_claims[1]) == lp_engine.cfg.n_ctx - 1
    finally:
        lp_engine._lane_claims[:] = saved


def test_lane_prefix_cache_defaults_on(files, serial):
    from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings, get_settings

    assert Settings.lane_prefix_cache is True and get_settings().lane_prefix_cache is True
    eng = ContinuousEngine(files["llama"], batch_size=2, device="cpu", **KW)
    try:
        assert eng._lane_prefix is True
        prompts = [[{"role": "user", "content": f"default wave {i} " * (1 + i % 3)}]
                   for i in range(6)]
        want = [_text(serial.create_chat_completion(p, temperature=0.0, max_tokens=6))
                for p in prompts]
        futs = [eng.submit(p, temperature=0.0, max_tokens=6) for p in prompts]
        assert [_text(f.result(timeout=T)) for f in futs] == want
    finally:
        eng.shutdown()

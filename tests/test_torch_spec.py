"""Prompt-lookup speculation (models/generate.py ``spec_verify``, the
engines' ``spec_decode``, engine/spec_auto.py) on the CPU, held to the JAX
package.

- **The verify step.**  On the tiny Llama loaded by both sides (the same
  weights), a 16-token prompt, its first greedy sample, then one verify of
  a perfect, a garbage and a partial draft: the port's emitted tokens,
  count, ``pos`` and last token equal the JAX ``spec_verify_jit``'s.
  After any verify, vanilla decode continues the vanilla stream exactly
  (over the bf16 and the int8 ring): the rejected slots stay invisible and
  the penalty ring, ``wpos`` and generator are where vanilla leaves them.
- **A proxy for its CUDA graph.**  The verify step's aten ops at two
  positions are the same, with no host read and no tensor from a host
  value (``tests/test_torch_generate.py``'s recorder).
- **The engines.**  Greedy speculation equals the vanilla path and the JAX
  spec engine (bytes and the acceptance counters); sampled output is
  deterministic per seed; a stream equals the batch; stop and budget hold;
  the lookup heuristic and the acceptance telemetry are the reference's;
  under the continuous scheduler with an always-hit draft every lane's
  greedy reply equals the serial vanilla engine's, and the lanes' verify
  equals the one-sequence verify lane by lane.
- **``spec_decode=auto``.**  The reference's cases with the RTT
  monkeypatched, on the H100's bandwidth default; the constructor's
  spec / paged / prefix gating.
"""

from __future__ import annotations

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from llama_fastapi_k8s_gpu_tpu.engine import ContinuousEngine as JContinuousEngine
from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.gguf import GGUFFile as JGGUFFile
from llama_fastapi_k8s_gpu_tpu.models.generate import generate_chunk_jit as j_generate_chunk_jit
from llama_fastapi_k8s_gpu_tpu.models.generate import init_state as j_init_state
from llama_fastapi_k8s_gpu_tpu.models.generate import prefill_jit as j_prefill_jit
from llama_fastapi_k8s_gpu_tpu.models.generate import sample_jit as j_sample_jit
from llama_fastapi_k8s_gpu_tpu.models.generate import spec_verify_jit as j_spec_verify_jit
from llama_fastapi_k8s_gpu_tpu.models.params import load_params as j_load_params
from llama_fastapi_k8s_gpu_tpu.sampling.sample import SamplingParams as JSamplingParams
from llama_fastapi_k8s_gpu_tpu.sampling.sample import sampling_tensors as j_sampling_tensors
from llama_fastapi_k8s_gpu_tpu.sampling.sample import seed_window as j_seed_window
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine, spec_auto
from llama_fastapi_k8s_gpu_tpu_torch.gguf import GGUFFile
from llama_fastapi_k8s_gpu_tpu_torch.models import llama
from llama_fastapi_k8s_gpu_tpu_torch.models.config import ModelConfig
from llama_fastapi_k8s_gpu_tpu_torch.models.generate import (
    first_sample,
    generate_chunk,
    init_state,
    prefill,
    spec_verify,
    verify_round,
)
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import init_cache, init_lane_cache
from llama_fastapi_k8s_gpu_tpu_torch.models.params import from_jax_params
from llama_fastapi_k8s_gpu_tpu_torch.ops import KERNELS, linear
from llama_fastapi_k8s_gpu_tpu_torch.parallel.batched import (
    batched_spec_verify_perlane,
    init_batched_state,
)
from llama_fastapi_k8s_gpu_tpu_torch.sampling.sample import (
    SamplingParams,
    lane_tensors,
    sampling_tensors,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
PROMPT = list(range(1, 17))
VOCAB = 256
T = 120     # seconds any future may take


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree, jnp.float32))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spec") / "tiny.gguf")
    write_tiny_llama_gguf(path)
    return path


@pytest.fixture(scope="module")
def models(tiny):
    """The tiny file's weights on both sides (the port's from the JAX
    load, so the two hold the same bf16 values)."""
    jcfg = JEngine(tiny, n_ctx=128).cfg
    jparams = j_load_params(JGGUFFile(tiny), jcfg, fmt="bf16", on_device=False)
    cfg = ModelConfig.from_gguf(GGUFFile(tiny), n_ctx=jcfg.n_ctx)
    return jcfg, jparams, cfg, from_jax_params(_numpy_tree(jparams), cfg, device="cpu")


def _port_state(params, cfg, seed=7):
    st = sampling_tensors(SamplingParams(temperature=0.0), CPU)
    state = init_state(init_cache(cfg, CPU), PROMPT, seed, CPU)
    logits = prefill(params, cfg, torch.tensor(PROMPT), len(PROMPT), state["cache"])
    first_sample(logits, state, st)
    return state, st


def _jax_state(jparams, jcfg, seed=7):
    st = j_sampling_tensors(JSamplingParams(temperature=0.0))
    logits, cache = j_prefill_jit(jparams, jcfg, jnp.asarray(PROMPT, jnp.int32),
                                  jnp.int32(len(PROMPT)), j_init_state(jcfg)["cache"])
    window, wpos = j_seed_window(PROMPT)
    token, window, wpos, key = j_sample_jit(logits, window, wpos, jax.random.PRNGKey(seed),
                                            st, jcfg)
    return {"cache": cache, "pos": jnp.int32(len(PROMPT)), "token": token, "window": window,
            "wpos": wpos, "key": key}, st


@pytest.fixture(scope="module")
def vanilla(models):
    """The port's vanilla greedy continuation (12 tokens), equal to the
    JAX package's."""
    jcfg, jparams, cfg, params = models
    state, st = _port_state(params, cfg)
    ref = generate_chunk(params, cfg, state, st, 12).tolist()
    jstate, jst = _jax_state(jparams, jcfg)
    _, jtoks = j_generate_chunk_jit(jparams, jcfg, jstate, jst, n_steps=12)
    assert ref == np.asarray(jtoks).tolist()
    return ref


def _drafts(ref, D=6):
    return {"perfect": ref[:D], "garbage": [(t + 97) % VOCAB for t in ref[:D]],
            "partial": ref[:3] + [(ref[3] + 11) % VOCAB] + ref[4:D]}


@pytest.mark.parametrize("kind,count", [("perfect", 7), ("garbage", 1), ("partial", 4)])
def test_verify_matches_the_reference(models, vanilla, kind, count):
    jcfg, jparams, cfg, params = models
    draft = _drafts(vanilla)[kind]
    state, st = _port_state(params, cfg)
    toks, n = spec_verify(params, cfg, state, st, torch.tensor(draft))
    jstate, jst = _jax_state(jparams, jcfg)
    jstate, jtoks, jn = j_spec_verify_jit(jparams, jcfg, jstate, jst, jnp.asarray(draft, jnp.int32))
    assert int(n) == int(jn) == count
    assert toks[:count].tolist() == np.asarray(jtoks)[:count].tolist() == vanilla[:count]
    assert int(state["pos"]) == int(jstate["pos"]) == len(PROMPT) + count
    assert int(state["token"]) == int(jstate["token"]) == vanilla[count - 1]
    assert int(state["wpos"]) == int(jstate["wpos"])
    assert state["window"].tolist() == np.asarray(jstate["window"]).tolist()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kind", ["perfect", "garbage", "partial"])
def test_continuation_after_verify_matches_vanilla(models, kind, kv_dtype):
    """Whatever a verify accepted, vanilla decode afterwards reproduces the
    vanilla stream: stale rejected slots invisible, window and wpos right;
    the host mirror advanced by the count."""
    import dataclasses

    _, _, cfg, params = models
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    state, st = _port_state(params, cfg)
    ref = generate_chunk(params, cfg, state, st, 12).tolist()
    state, st = _port_state(params, cfg)
    toks, n = verify_round(params, cfg, state, st, _drafts(ref)[kind])
    assert state["slot"] == len(PROMPT) + n
    more = generate_chunk(params, cfg, state, st, 12 - n).tolist()
    assert toks + more == ref


def test_verify_round_checks_the_ring_on_the_host(models):
    _, _, cfg, params = models
    state, st = _port_state(params, cfg)
    state["slot"] = cfg.n_ctx - 4
    with pytest.raises(ValueError, match="does not fit"):
        verify_round(params, cfg, state, st, [1] * 4)


# ---------------------------------------------------------------------------
# a proxy for the verify graph: the same ops at every position
# ---------------------------------------------------------------------------

HOST_READS = ("aten._local_scalar_dense", "aten.item", "aten.lift_fresh")


def _arg(a):
    if isinstance(a, torch.Tensor):
        return ("T", tuple(a.shape), str(a.dtype))
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype, torch.device)):
        return a
    if isinstance(a, (list, tuple)):
        return tuple(_arg(x) for x in a)
    return type(a).__name__


class _Recorder(TorchDispatchMode):
    """Every aten op run under it; a kernel wrapper as one op."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self._inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._inside:
            self.ops.append((str(func), tuple(_arg(a) for a in tree_leaves((args, kwargs)))))
        return func(*args, **kwargs)

    @contextlib.contextmanager
    def kernel(self, name):
        self.ops.append((f"kernel:{name}", ()))
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_verify_step_has_the_same_ops_at_every_position(tiny, monkeypatch, kv_dtype):
    import dataclasses

    from llama_fastapi_k8s_gpu_tpu_torch.models.params import load_params

    cfg = dataclasses.replace(ModelConfig.from_gguf(GGUFFile(tiny), n_ctx=1024),
                              kv_dtype=kv_dtype, attn_impl="flash")
    params = load_params(GGUFFile(tiny), cfg, "q4k", CPU)
    rec = _Recorder()
    names = {fn: n for n, fn in KERNELS.items()}

    def wrapped(name, fn):
        def call(*a, **k):
            with rec.kernel(name):
                return fn(*a, **k)
        return call

    for kind, fn in list(linear._FUSED.items()):
        monkeypatch.setitem(linear._FUSED, kind, wrapped(names[fn], fn))
    monkeypatch.setattr(llama, "kv_quantize", wrapped("kv_quantize", llama.kv_quantize))
    st = sampling_tensors(SamplingParams(temperature=0.8), CPU)
    draft = torch.tensor([3, 4, 5, 6, 7, 8, 9, 10])
    ops = []
    for pos in (5, 900):
        state = init_state(init_cache(cfg, CPU), [i % 200 for i in range(pos)], 3, CPU)
        rec.ops = []
        with rec:
            spec_verify(params, cfg, state, st, draft)
        ops.append(rec.ops)
    names_seen = [op for op, _ in ops[0]]
    assert not [op for op in names_seen if op.startswith(HOST_READS)]
    assert ops[0] == ops[1]
    kernels = {op for op in names_seen if op.startswith("kernel:")}
    assert "kernel:q8_matmul" in kernels
    assert ("kernel:kv_quantize" in kernels) == (kv_dtype == "int8")


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

KW = dict(n_ctx=128, decode_chunk=4, max_gen_tokens=48, prefill_buckets=(64,))
#: repetitive text: the byte-level prompt has recurring n-grams
MSGS = [{"role": "user", "content": "the cat sat on the mat. the cat sat on the mat. "
         "the cat sat on"}]


def _text(r) -> str:
    return r["choices"][0]["message"]["content"]


@pytest.fixture(scope="module")
def engines(tiny):
    plain = Engine(tiny, device="cpu", **KW)
    spec = Engine(tiny, device="cpu", spec_decode="lookup", **KW)
    assert spec._spec_enabled() and spec._spec_draft == 8
    return plain, spec


@pytest.fixture
def always_hit(monkeypatch):
    """The reference's always-hit, usually wrong draft: the last token
    repeated, so every round runs the accept/reject arithmetic."""
    monkeypatch.setattr(Engine, "_lookup_draft",
                        staticmethod(lambda history, D, max_ngram=3: [history[-1]] * D))


@pytest.mark.parametrize("hit", [False, True])
def test_engine_spec_greedy_equals_vanilla_and_the_reference(tiny, engines, request, hit):
    if hit:
        request.getfixturevalue("always_hit")
    plain, spec = engines
    jspec = JEngine(tiny, spec_decode="lookup", **KW)
    if hit:
        import llama_fastapi_k8s_gpu_tpu.engine.engine as jengine_mod

        request.getfixturevalue("monkeypatch").setattr(
            jengine_mod.Engine, "_lookup_draft",
            staticmethod(lambda history, D, max_ngram=3: [history[-1]] * D))
    a = plain.create_chat_completion(MSGS, temperature=0.0, max_tokens=32, seed=5)
    b = spec.create_chat_completion(MSGS, temperature=0.0, max_tokens=32, seed=5)
    c = jspec.create_chat_completion(MSGS, temperature=0.0, max_tokens=32, seed=5)
    assert _text(a) == _text(b) == _text(c)
    assert a["usage"] == b["usage"] == c["usage"]
    assert b["lfkt_timings"]["spec"] == c["lfkt_timings"]["spec"]
    if hit:
        assert b["lfkt_timings"]["spec"]["verify_steps"] >= 1


def test_engine_spec_sampled_deterministic(engines, always_hit):
    _, spec = engines
    a = spec.create_chat_completion(MSGS, temperature=1.2, max_tokens=24, seed=9)
    b = spec.create_chat_completion(MSGS, temperature=1.2, max_tokens=24, seed=9)
    assert _text(a) == _text(b)
    assert a["lfkt_timings"]["spec"]["verify_steps"] >= 1


def test_engine_spec_sampled_in_distribution(models):
    """At temperature, the emitted first token of a verify is drawn from the
    same distribution as vanilla decode's: over many seeds the two samplers'
    token histograms at that position agree (both are fresh draws of the
    same filtered distribution)."""
    _, _, cfg, params = models
    st = sampling_tensors(SamplingParams(temperature=1.5, top_k=8, top_p=1.0, min_p=0.0), CPU)
    counts = [{}, {}]
    for seed in range(160):
        for i, use_verify in enumerate((False, True)):
            state = init_state(init_cache(cfg, CPU), PROMPT, seed, CPU)
            logits = prefill(params, cfg, torch.tensor(PROMPT), len(PROMPT), state["cache"])
            first_sample(logits, state, st)
            if use_verify:
                toks, _ = spec_verify(params, cfg, state, st, torch.tensor([0, 0, 0]))
                t = int(toks[0])
            else:
                t = int(generate_chunk(params, cfg, state, st, 1)[0])
            counts[i][t] = counts[i].get(t, 0) + 1
    support = set(counts[0]) | set(counts[1])
    tv = sum(abs(counts[0].get(t, 0) - counts[1].get(t, 0)) for t in support) / (2 * 160)
    assert len(counts[1]) > 1 and tv < 0.25


def test_engine_spec_stream_matches_batch(engines, always_hit):
    _, spec = engines
    batch = spec.create_chat_completion(MSGS, temperature=0.0, max_tokens=24, seed=3)
    chunks = spec.create_chat_completion(MSGS, temperature=0.0, max_tokens=24, seed=3,
                                         stream=True)
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert text == _text(batch)


def test_engine_spec_respects_stop_and_budget(engines, always_hit):
    _, spec = engines
    out = spec.create_chat_completion(MSGS, temperature=0.0, max_tokens=3, seed=1)
    assert out["usage"]["completion_tokens"] <= 3
    content = _text(spec.create_chat_completion(MSGS, temperature=0.0, max_tokens=32, seed=5))
    if len(content) > 4:
        stop = content[2:4]
        stopped = spec.create_chat_completion(MSGS, temperature=0.0, max_tokens=32, seed=5,
                                              stop=[stop])
        assert stop not in _text(stopped)
        assert stopped["choices"][0]["finish_reason"] == "stop"


def test_lookup_draft_heuristic():
    hist = [1, 2, 3, 9, 9, 1, 2, 3]
    for eng in (Engine, JEngine):
        assert eng._lookup_draft(hist, 4) == [9, 9, 1, 2]
        assert eng._lookup_draft([1, 2, 3, 4], 4) is None
        assert eng._lookup_draft([5, 5], 3) == [5, 0, 0]
    rng = np.random.default_rng(0)
    for _ in range(50):
        h = rng.integers(0, 6, size=int(rng.integers(1, 30))).tolist()
        assert Engine._lookup_draft(h, 5) == JEngine._lookup_draft(h, 5)


def test_spec_timings_report_acceptance(engines):
    _, spec = engines
    st = spec.create_chat_completion(MSGS, temperature=0.0, max_tokens=16, seed=2)[
        "lfkt_timings"]["spec"]
    assert st["verify_steps"] + st["fallback_steps"] >= 1
    assert 0 <= st["accepted"] <= st["drafted"]


def test_spec_realized_acceptance_on_repetitive_generation(tiny):
    """Organic lookup (no patched draft) accepts drafted tokens on the tiny
    model's repetitive greedy output, with the vanilla path's bytes."""
    kw = dict(KW, n_ctx=256, max_gen_tokens=96)
    plain = Engine(tiny, device="cpu", **kw)
    spec = Engine(tiny, device="cpu", spec_decode="lookup", spec_draft=4, **kw)
    msgs = [{"role": "user", "content": "repeat after me: the cat sat"}]
    a = plain.create_chat_completion(msgs, temperature=0.0, max_tokens=96, seed=0)
    b = spec.create_chat_completion(msgs, temperature=0.0, max_tokens=96, seed=0)
    assert _text(a) == _text(b)
    st = b["lfkt_timings"]["spec"]
    assert st["accepted"] > 0 and st["accepted"] >= st["verify_steps"], st


# ---------------------------------------------------------------------------
# lanes
# ---------------------------------------------------------------------------

def test_lane_verify_equals_the_serial_verify_lane_by_lane(models):
    """Each lane of the batched verify is the one-sequence verify on the
    lane's ring, rows, generator and knobs; a lane past the ring writes
    nothing outside it."""
    _, _, cfg, params = models
    B, D = 3, 4
    bstate = init_batched_state(cfg, B, CPU, seed=11)
    sps = [SamplingParams(temperature=0.0), SamplingParams(temperature=0.9, top_k=5),
           SamplingParams()]
    knobs = lane_tensors(sps, CPU)
    serial = []
    for b, n in enumerate((16, 40, 0)):
        ids = [(7 * i + b) % 200 for i in range(max(n, 1))]
        if n:
            logits = prefill(params, cfg, torch.tensor(ids), n,
                             {k: v[b] for k, v in bstate["cache"].items()})
            st1 = sampling_tensors(sps[b], CPU)
            s = init_state({k: v[b] for k, v in bstate["cache"].items()}, ids, 11 + b, CPU)
            first_sample(logits, s, st1)
            for k in ("pos", "token", "window", "wpos"):
                bstate[k][b].copy_(s[k])
        else:
            bstate["pos"][b].fill_(cfg.n_ctx + 5)        # a free lane run past the ring
    drafts = torch.tensor([[5, 6, 7, 8], [1, 1, 1, 1], [0, 0, 0, 0]])
    # the serial verifies on clones
    for b in range(B):
        ring = {k: v[b].clone() for k, v in bstate["cache"].items()}
        g = torch.Generator()
        g.set_state(bstate["gens"][b].get_state())
        s = {"cache": ring, "gen": g, **{k: bstate[k][b].clone()
                                          for k in ("pos", "token", "window", "wpos")}}
        t, n = spec_verify(params, cfg, s, sampling_tensors(sps[b], CPU), drafts[b])
        serial.append((t.tolist(), int(n), s))
    toks, counts = batched_spec_verify_perlane(params, cfg, bstate, knobs, drafts)
    for b in range(B):
        assert toks[b].tolist() == serial[b][0] and int(counts[b]) == serial[b][1]
        for k in ("pos", "token", "window", "wpos"):
            assert torch.equal(bstate[k][b], serial[b][2][k])
        if b < 2:
            for k, v in bstate["cache"].items():
                assert torch.equal(v[b], serial[b][2]["cache"][k])
    assert init_lane_cache(cfg, B, CPU)["k"].shape == bstate["cache"]["k"].shape


def test_continuous_spec_greedy_parity(tiny, always_hit):
    plain = Engine(tiny, device="cpu", **KW)
    ceng = ContinuousEngine(tiny, batch_size=4, device="cpu", spec_decode="lookup",
                            spec_draft=4, **KW)
    try:
        assert not ceng._lane_prefix
        misc = [{"role": "user", "content": "alpha bravo charlie delta"}]
        want = {id(m): _text(plain.create_chat_completion(m, temperature=0.0, max_tokens=24))
                for m in (MSGS, misc)}
        futs = [(m, ceng.submit(m, temperature=0.0, max_tokens=24)) for m in (MSGS, misc, MSGS)]
        for m, f in futs:
            assert _text(f.result(T)) == want[id(m)]
        stats = ceng.scheduler_stats()["spec"]
        assert stats["verify_steps"] >= 1 and stats["drafted"] >= 1
    finally:
        ceng.shutdown()


def _vanilla_replies(eng, msgs_list) -> list:
    """``eng``'s greedy prompt and generated ids for each message list."""
    out, finish = [], eng._finish

    def finished(ctx):
        out.append({"prompt": list(ctx["prompt_ids"]), "ids": list(ctx["ids"])})
        return finish(ctx)

    eng._finish = finished
    try:
        for msgs in msgs_list:
            eng.create_chat_completion(msgs, temperature=0.0, max_tokens=24)
    finally:
        del eng._finish
    return out


def _draft_fn(kind: str, refs: list):
    """The always-hit draft, or ``chip_smoke.oracle_draft`` of the vanilla
    replies ``refs`` (their next D tokens while a history follows one)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import oracle_draft

    return staticmethod(lambda history, D, max_ngram=3:
                        oracle_draft(refs if kind == "oracle" else [], history, D))


MISC = [{"role": "user", "content": "alpha bravo charlie delta"}]


@pytest.mark.parametrize("draft", ["always_hit", "oracle"])
def test_engine_spec_over_the_int8_ring_equals_vanilla(tiny, monkeypatch, draft):
    """Over the int8 ring greedy speculation equals the vanilla int8 engine
    and the JAX int8 spec engine, bytes and acceptance: under the always-hit
    draft (each round keeps its first row) and under the oracle draft (the
    vanilla reply), whose rounds accept every draft token and emit D+1."""
    import llama_fastapi_k8s_gpu_tpu.engine.engine as jengine_mod

    plain = Engine(tiny, device="cpu", kv_dtype="int8", **KW)
    refs = _vanilla_replies(plain, [MSGS, MISC])
    monkeypatch.setattr(Engine, "_lookup_draft", _draft_fn(draft, refs))
    monkeypatch.setattr(jengine_mod.Engine, "_lookup_draft", _draft_fn(draft, refs))
    spec = Engine(tiny, device="cpu", kv_dtype="int8", spec_decode="lookup", spec_draft=4, **KW)
    jspec = JEngine(tiny, kv_dtype="int8", spec_decode="lookup", spec_draft=4, **KW)
    for msgs in (MSGS, MISC):
        a = plain.create_chat_completion(msgs, temperature=0.0, max_tokens=24)
        b = spec.create_chat_completion(msgs, temperature=0.0, max_tokens=24)
        c = jspec.create_chat_completion(msgs, temperature=0.0, max_tokens=24)
        assert _text(a) == _text(b) == _text(c)
        assert b["lfkt_timings"]["spec"] == c["lfkt_timings"]["spec"]
        got = b["lfkt_timings"]["spec"]
        if draft == "oracle":
            assert got["accepted"] >= 4 * (got["verify_steps"] - 1)
        else:
            assert got["verify_steps"] >= 1


def test_continuous_spec_over_the_int8_ring_with_accepted_drafts(tiny, monkeypatch):
    """Four int8 lanes under the oracle draft: rounds accept drafts (a count
    above one slices the harvest, advances the host mirror and keeps the
    accepted rows' K/V), and every lane's greedy reply equals the serial
    vanilla int8 engine's."""
    plain = Engine(tiny, device="cpu", kv_dtype="int8", **KW)
    refs = _vanilla_replies(plain, [MSGS, MISC])
    monkeypatch.setattr(Engine, "_lookup_draft", _draft_fn("oracle", refs))
    ceng = ContinuousEngine(tiny, batch_size=4, device="cpu", kv_dtype="int8",
                            spec_decode="lookup", spec_draft=4, **KW)
    try:
        want = {id(m): _text(plain.create_chat_completion(m, temperature=0.0, max_tokens=24))
                for m in (MSGS, MISC)}
        futs = [(m, ceng.submit(m, temperature=0.0, max_tokens=24))
                for m in (MSGS, MISC, MSGS, MISC)]
        for m, f in futs:
            assert _text(f.result(T)) == want[id(m)]
        stats = ceng.scheduler_stats()["spec"]
        assert stats["accepted"] >= stats["verify_steps"] > 0
    finally:
        ceng.shutdown()


def test_continuous_spec_matches_the_reference_scheduler(tiny, monkeypatch):
    """Organic drafts under lanes: the port's replies and acceptance equal
    the JAX continuous engine's."""
    ceng = ContinuousEngine(tiny, batch_size=2, device="cpu", spec_decode="lookup",
                            spec_draft=4, **KW)
    jeng = JContinuousEngine(tiny, dp=1, tp=1, batch_size=2, spec_decode="lookup",
                             spec_draft=4, **KW)
    try:
        got = [[_text(e.submit(MSGS, temperature=0.0, max_tokens=20).result(T))
                for _ in range(2)] for e in (ceng, jeng)]
        assert got[0] == got[1]
        ps, js = ceng.scheduler_stats()["spec"], jeng.scheduler_stats()["spec"]
        assert {k: ps[k] for k in ("verify_steps", "drafted", "accepted")} == \
            {k: js[k] for k in ("verify_steps", "drafted", "accepted")}
    finally:
        ceng.shutdown()
        jeng.shutdown()


def test_continuous_spec_stream_matches_batch(tiny):
    ceng = ContinuousEngine(tiny, batch_size=2, device="cpu", spec_decode="lookup",
                            spec_draft=4, **KW)
    try:
        batch = ceng.create_chat_completion(MSGS, temperature=0.0, max_tokens=20)
        text = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in ceng.submit_stream(MSGS, temperature=0.0, max_tokens=20))
        assert text == _text(batch)
    finally:
        ceng.shutdown()


# ---------------------------------------------------------------------------
# spec_decode=auto
# ---------------------------------------------------------------------------

class _Params:
    """Params of ``nbytes`` bytes beside a ``tok_emb`` table."""

    def __init__(self, nbytes: int, emb_shape=(1, 1)):
        self._n = nbytes
        self.tok_emb = torch.empty(emb_shape, dtype=torch.float32, device="meta")

    def nbytes(self) -> int:
        return self._n + self.tok_emb.numel() * 4


def test_breakeven_model_directions(monkeypatch):
    """An RTT far below a token's weight read resolves lookup; far above,
    off — at the H100's bandwidth by default."""
    params = _Params(5_400_000_000)                                   # 5.4 GB
    assert spec_auto.HBM_GBPS_DEFAULT == 3350.0
    monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", lambda: 0.00004)
    mode, dec = spec_auto.resolve_auto(params)
    assert mode == "lookup" and dec["hbm_gbps"] == 3350.0
    assert dec["breakeven_acceptance"] < 0.1
    monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", lambda: 0.072)
    mode, dec = spec_auto.resolve_auto(params, hbm_gbps=819.0, accept=1.0)
    assert mode == "off" and dec["breakeven_acceptance"] > 5


def test_embedding_table_excluded_from_bytes(models):
    assert spec_auto.decode_bytes_per_token(_Params(64 * 64, (1000, 64))) == 64 * 64
    _, _, _, port_params = models
    emb = port_params.tok_emb
    assert spec_auto.decode_bytes_per_token(port_params) == \
        port_params.nbytes() - emb.numel() * emb.element_size()


def test_measurement_failure_degrades_to_off(monkeypatch):
    def boom():
        raise RuntimeError("no device")

    monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", boom)
    mode, dec = spec_auto.resolve_auto(_Params(1), hbm_gbps=819.0, accept=1.0)
    assert mode == "off" and "no device" in dec["error"]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mode, dec = spec_auto.resolve_auto(_Params(1))
    assert mode == "off" and "no CUDA device" in dec["error"]


def test_engine_auto_resolves_on_and_serves(tiny, monkeypatch):
    monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", lambda: 1e-9)
    eng = Engine(tiny, device="cpu", n_ctx=128, decode_chunk=4, max_gen_tokens=8,
                 prefill_buckets=(32, 64, 128), spec_decode="auto", spec_draft=4)
    assert eng._spec_draft == 4 and eng.spec_auto_decision["resolved"] == "lookup"
    assert eng.spec_auto_decision["breakeven_acceptance"] < 1.0
    assert not eng._prefix_cache
    out = eng.create_chat_completion([{"role": "user", "content": "Say something."}],
                                     temperature=0.0, max_tokens=6)
    assert out["usage"]["completion_tokens"] >= 1


def test_engine_auto_resolves_off_under_high_rtt(tiny, monkeypatch):
    monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", lambda: 10.0)
    eng = Engine(tiny, device="cpu", n_ctx=128, decode_chunk=4, max_gen_tokens=8,
                 prefill_buckets=(32, 64, 128), spec_decode="auto", spec_draft=4,
                 kv_paged=True, kv_page_tokens=16)
    assert eng._spec_draft == 0 and eng.spec_auto_decision["resolved"] == "off"
    # auto-off keeps the reuse paths: speculation is what excludes them
    assert eng._kv_paged and eng._kvpool is not None


def test_continuous_engine_auto_gates_lane_prefix(tiny, monkeypatch):
    monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", lambda: 1e-9)
    eng = ContinuousEngine(tiny, batch_size=2, device="cpu", n_ctx=128, decode_chunk=4,
                           max_gen_tokens=8, prefill_buckets=(32, 64, 128),
                           spec_decode="auto", spec_draft=4, lane_prefix_cache=True)
    try:
        assert eng._spec_draft == 4 and not eng._lane_prefix
        assert "spec" in eng.scheduler_stats()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw,match", [(dict(spec_decode="maybe"), "spec_decode"),
                                      (dict(spec_decode="lookup", spec_draft=0), "spec_draft"),
                                      (dict(spec_decode="lookup", spec_draft=127), "spec_draft")])
def test_spec_knobs_validated_before_the_load(kw, match):
    with pytest.raises(ValueError, match=match):
        Engine("/nonexistent.gguf", device="cpu", n_ctx=128, **kw)

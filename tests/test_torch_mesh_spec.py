"""Lane speculation over a tp mesh (the continuous scheduler's verify
rounds, parallel/batched.py ``batched_spec_verify_perlane`` through
``models.llama.forward_mesh``), on the CPU, held to the one-device engine
and to the JAX package's ``ContinuousEngine(dp=2, tp=2)``.

- **The engines.**  The port's ``ContinuousEngine(tp=2)`` over ``[cpu] *
  4`` (dp = 2) with ``spec_decode="lookup"`` replies as the JAX engine on
  the same mesh, greedy bytes and acceptance counters, under organic
  drafts and the always-hit draft; under the oracle draft (the vanilla reply) rounds accept drafts
  and every reply equals the port's one-device lane engine's.
- **A verify round.**  Over the sharded lane ring (dp = 2 × tp = 2, the
  kv heads split) each lane's emitted tokens, counts, positions and
  penalty rings equal the one-device round's, and every shard's ring,
  gathered over tp, equals the one-device lane ring up to the lane's new
  ``pos`` (the rejected drafts' stale K/V past it are positional, as on
  one device).
- **``spec_decode="auto"``.**  Over ``MeshParams`` a decode token's bytes
  are the whole model's, each weight once, less the embedding: the JAX
  package's count over its global arrays, and the decision equals its.
"""

from __future__ import annotations

import gc
import os
import sys

import pytest
import torch

import llama_fastapi_k8s_gpu_tpu.engine.engine as jengine_mod
from llama_fastapi_k8s_gpu_tpu.engine import ContinuousEngine as JContinuousEngine
from llama_fastapi_k8s_gpu_tpu.engine import spec_auto as j_spec_auto
from llama_fastapi_k8s_gpu_tpu.testing import write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine, spec_auto
from llama_fastapi_k8s_gpu_tpu_torch.models.generate import (
    first_sample,
    generate_chunk,
    init_state,
    prefill,
)
from llama_fastapi_k8s_gpu_tpu_torch.models.llama import lane_view
from llama_fastapi_k8s_gpu_tpu_torch.parallel import mesh as pmesh
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
T = 120     # seconds any future may take
KW = dict(n_ctx=128, decode_chunk=4, max_gen_tokens=48, prefill_buckets=(64,))
#: repetitive text: the byte-level prompt has recurring n-grams
MSGS = [{"role": "user", "content": "the cat sat on the mat. the cat sat on the mat. "
         "the cat sat on"}]
MISC = [{"role": "user", "content": "alpha bravo charlie delta"}]


def _text(r) -> str:
    return r["choices"][0]["message"]["content"]


@pytest.fixture(autouse=True)
def _collect_engines():
    yield
    gc.collect()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_spec") / "tiny.gguf")
    write_tiny_llama_gguf(path)
    return path


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


def _oracle(refs: list):
    """``chip_smoke.oracle_draft`` of the vanilla replies ``refs``."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import oracle_draft

    return staticmethod(lambda history, D, max_ngram=3: oracle_draft(refs, history, D))


def _always_hit():
    """The reference's always-hit, usually wrong draft: the last token
    repeated, so every round runs the accept/reject arithmetic."""
    return staticmethod(lambda history, D, max_ngram=3: [history[-1]] * D)


@pytest.mark.parametrize("draft", ["organic", "always_hit"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_continuous_tp_spec_replies_as_the_jax_engine_on_the_same_mesh(tiny, monkeypatch,
                                                                       kv_dtype, draft):
    """Prompt-lookup drafts (the organic heuristic, and the always-hit
    draft that makes every wave a verify round): the port's tp = 2 × dp = 2
    lane engine and the JAX one reply alike, round for round (verify
    steps, drafted and accepted tokens equal)."""
    if draft == "always_hit":
        monkeypatch.setattr(Engine, "_lookup_draft", _always_hit())
        monkeypatch.setattr(jengine_mod.Engine, "_lookup_draft", _always_hit())
    kw = dict(batch_size=2, spec_decode="lookup", spec_draft=4, kv_dtype=kv_dtype, **KW)
    eng = ContinuousEngine(tiny, tp=2, devices=[CPU] * 4, device="cpu", **kw)
    ref = JContinuousEngine(tiny, dp=2, tp=2, **kw)
    try:
        assert eng.mesh.shape == {"dp": 2, "tp": 2, "sp": 1} and eng._spec_draft == 4
        assert isinstance(eng._bstate["cache"], pmesh.ShardedRing)
        got = [[_text(e.submit(m, temperature=0.0, max_tokens=20).result(T))
                for m in (MSGS, MISC, MSGS)] for e in (eng, ref)]
        assert got[0] == got[1]
        ps, js = eng.scheduler_stats()["spec"], ref.scheduler_stats()["spec"]
        assert {k: ps[k] for k in ("verify_steps", "drafted", "accepted")} == \
            {k: js[k] for k in ("verify_steps", "drafted", "accepted")}
        if draft == "always_hit":
            assert ps["verify_steps"] > 0 and ps["drafted"] > 0
    finally:
        eng.shutdown()
        ref.shutdown()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_continuous_tp_spec_accepts_drafts_and_replies_as_one_device(tiny, monkeypatch,
                                                                     kv_dtype):
    """Under the oracle draft (the vanilla greedy reply) the tp lanes'
    rounds accept drafts, and every reply equals the port's one-device
    vanilla engine's, the port's one-device lane engine's and the JAX tp
    lane engine's under the same draft."""
    plain = Engine(tiny, device="cpu", kv_dtype=kv_dtype, **KW)
    refs = _vanilla_replies(plain, [MSGS, MISC])
    monkeypatch.setattr(Engine, "_lookup_draft", _oracle(refs))
    monkeypatch.setattr(jengine_mod.Engine, "_lookup_draft", _oracle(refs))
    kw = dict(batch_size=2, spec_decode="lookup", spec_draft=4, kv_dtype=kv_dtype, **KW)
    engines = (ContinuousEngine(tiny, tp=2, devices=[CPU] * 4, device="cpu", **kw),
               ContinuousEngine(tiny, device="cpu", **kw),
               JContinuousEngine(tiny, dp=2, tp=2, **kw))
    try:
        want = {id(m): _text(plain.create_chat_completion(m, temperature=0.0, max_tokens=24))
                for m in (MSGS, MISC)}
        for e in engines:
            futs = [(m, e.submit(m, temperature=0.0, max_tokens=24))
                    for m in (MSGS, MISC, MISC, MSGS)]
            for m, f in futs:
                assert _text(f.result(T)) == want[id(m)], type(e).__module__
        stats = [e.scheduler_stats()["spec"] for e in engines]
        assert stats[0]["accepted"] >= stats[0]["verify_steps"] > 0
        assert stats[0]["accepted"] == stats[2]["accepted"]
    finally:
        for e in engines:
            e.shutdown()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_verify_round_over_the_sharded_lane_ring_equals_one_devices(tiny, kv_dtype):
    """Two lanes over dp = 2 × tp = 2 against two one-device lanes on the
    same prompts and drafts (lane 0 the vanilla continuation: accepted
    whole; lane 1 right for two tokens, then wrong): the round's tokens,
    counts and lane rows are equal, and each lane's shards, gathered over
    tp, hold the one-device lane ring's K/V up to its new ``pos``."""
    eng = Engine(tiny, device="cpu", kv_dtype=kv_dtype, **KW)
    params, cfg = eng.params, eng.cfg
    mesh = pmesh.make_mesh(dp=2, tp=2, devices=[CPU] * 4)
    mp = pmesh.shard_params(params, mesh, cfg)
    assert mp.tp_heads
    B, D = 2, 4
    one = init_batched_state(cfg, B, CPU, seed=11)
    sh = init_batched_state(cfg, B, CPU, seed=11, mesh=mesh, tp_split=mp.tp_heads)
    greedy = SamplingParams(temperature=0.0)
    st = sampling_tensors(greedy, CPU)
    drafts = []
    for b, n in enumerate((16, 29)):
        ids = [(7 * i + 3 * b) % 200 + 1 for i in range(n)]
        lg = prefill(params, cfg, torch.tensor(ids), n, lane_view(one["cache"], b))
        assert torch.equal(prefill(mp, cfg, torch.tensor(ids), n, lane_view(sh["cache"], b)),
                           lg)
        s = init_state(lane_view(one["cache"], b), ids, 11 + b, CPU)
        first_sample(lg, s, st)
        for k in ("pos", "token", "window", "wpos"):
            one[k][b].copy_(s[k])
            sh[k][b].copy_(s[k])
        # the vanilla continuation on a clone of the lane's ring
        clone = dict(s, cache={k: v.clone() for k, v in s["cache"].items()},
                     window=s["window"].clone(), slot=n)
        clone["out"] = torch.zeros(cfg.n_ctx, dtype=torch.int64)
        nxt = generate_chunk(params, cfg, clone, st, D).tolist()
        drafts.append(nxt if b == 0 else nxt[:2] + [(t + 1) % 200 for t in nxt[2:]])
    drafts = torch.tensor(drafts)
    knobs = lane_tensors([greedy] * B, CPU)
    toks1, counts1 = batched_spec_verify_perlane(params, cfg, one, knobs, drafts)
    toks2, counts2 = batched_spec_verify_perlane(mp, cfg, sh, knobs, drafts)
    assert counts1.tolist() == counts2.tolist() == [D + 1, 3]
    assert torch.equal(toks1, toks2)
    for k in ("pos", "token", "window", "wpos"):
        assert torch.equal(one[k], sh[k]), k
    for b in range(B):
        pos = int(one["pos"][b])
        lane = sh["cache"].lane(b)
        for name, shards in lane.items():
            whole = one["cache"][name][b]
            assert torch.equal(torch.cat(shards, 1)[:, :, :pos], whole[:, :, :pos]), (b, name)


def test_spec_auto_over_a_tp_mesh_counts_and_decides_as_the_jax_package(tiny, monkeypatch):
    """``decode_bytes_per_token`` over the port's ``MeshParams`` (tp = 2,
    dp = 2) is the whole model's bytes less the embedding: the one-device
    count and the JAX package's over its global arrays on the same mesh;
    under one measured RTT the two decide alike, on both sides of the
    breakeven, and the engines' ``auto`` records agree."""
    kw = dict(batch_size=2, **KW)
    eng = ContinuousEngine(tiny, tp=2, devices=[CPU] * 4, device="cpu", **kw)
    ref = JContinuousEngine(tiny, dp=2, tp=2, **kw)
    try:
        one = Engine(tiny, device="cpu", **KW).params
        bpt = spec_auto.decode_bytes_per_token(eng.params)
        assert bpt == spec_auto.decode_bytes_per_token(one)
        assert bpt == j_spec_auto.decode_bytes_per_token(ref.params)
        assert eng.params.nbytes() > bpt            # the shards hold copies
        for rtt in (1e-9, 10.0):
            monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", lambda: rtt)
            monkeypatch.setattr(j_spec_auto, "measure_dispatch_rtt_s", lambda: rtt)
            mode, dec = spec_auto.resolve_auto(eng.params, hbm_gbps=3350.0, accept=1.0)
            jmode, jdec = j_spec_auto.resolve_auto(ref.params, hbm_gbps=3350.0, accept=1.0)
            assert mode == jmode == ("lookup" if rtt < 1 else "off")
            assert dec["bytes_per_token"] == jdec["bytes_per_token"] == bpt
            assert dec["breakeven_acceptance"] == jdec["breakeven_acceptance"]
    finally:
        eng.shutdown()
        ref.shutdown()
    monkeypatch.setattr(spec_auto, "measure_dispatch_rtt_s", lambda: 1e-9)
    monkeypatch.setattr(j_spec_auto, "measure_dispatch_rtt_s", lambda: 1e-9)
    engines = (ContinuousEngine(tiny, tp=2, devices=[CPU] * 4, device="cpu",
                                spec_decode="auto", spec_draft=4, **kw),
               JContinuousEngine(tiny, dp=2, tp=2, spec_decode="auto", spec_draft=4, **kw))
    try:
        recs = [e.spec_auto_decision for e in engines]
        assert recs[0]["resolved"] == recs[1]["resolved"] == "lookup"
        assert recs[0]["bytes_per_token"] == recs[1]["bytes_per_token"] == bpt
        assert engines[0]._spec_draft == 4
        out = engines[0].submit(MSGS, temperature=0.0, max_tokens=8).result(T)
        assert out["usage"]["completion_tokens"] >= 1
    finally:
        for e in engines:
            e.shutdown()

"""The port's multi-model registry (serving/manifest.py, serving/registry.py)
against the JAX package's, on the CPU.

Three tiny GGUFs: ``a`` and ``b`` of one geometry (different seeds, so the
KV of identical token ids differs and a leak across namespaces would show)
and ``c`` one layer deeper (its pages cannot share the arena).

- the manifest grammar: the port's parse, ``pick_default`` and
  ``resolved_path`` equal the JAX package's, rejects included (the same
  exception type and message);
- serial and continuous registries: each alias's greedy reply equals the
  JAX registry's and the port's own engine alone, bit for bit;
- one shared arena, one radix namespace a model: the same prompt under two
  aliases never hits across them, the pool's counters equal the JAX pool's
  request by request; a deeper model degrades to a private pool with the
  reference's warning;
- the weight budget's refusal names the offender; a live reload adds,
  removes (the namespace drained to 0 pages), re-resolves the default,
  refuses a changed kept spec, waits for in-flight requests, and unwinds a
  failed warmup; each as the JAX registry does;
- the app: ``/v1/models``, the ``/health`` ``models`` rows, ``model=``
  routing in ``/response`` and ``/v1/chat/completions``, unknown model 400
  and ``POST /admin/models/reload``, against the JAX app.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import threading
import time

import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.engine import ContinuousEngine as JContinuousEngine
from llama_fastapi_k8s_gpu_tpu.engine import Engine as JEngine
from llama_fastapi_k8s_gpu_tpu.server.app import create_app as j_create_app
from llama_fastapi_k8s_gpu_tpu.serving import ModelRegistry as JModelRegistry
from llama_fastapi_k8s_gpu_tpu.serving import manifest as jmanifest
from llama_fastapi_k8s_gpu_tpu.serving import registry as jregistry
from llama_fastapi_k8s_gpu_tpu.testing import TINY_CFG, write_tiny_llama_gguf
from llama_fastapi_k8s_gpu_tpu.utils.config import Settings as JSettings
from llama_fastapi_k8s_gpu_tpu_torch.engine import ContinuousEngine, Engine
from llama_fastapi_k8s_gpu_tpu_torch.server.app import _registry_factory, create_app
from llama_fastapi_k8s_gpu_tpu_torch.serving import (
    ModelRegistry,
    ModelSpec,
    UnknownModelError,
    WeightBudgetError,
    manifest,
    parse_manifest,
    pick_default,
    registry,
)
from llama_fastapi_k8s_gpu_tpu_torch.utils.config import Settings, get_settings
from tests.test_torch_openai import call, serve

torch.set_num_threads(1)
T = 120      # seconds any future may take
MSGS = [{"role": "user", "content": "The quick brown fox jumps over the lazy dog "
                                    "near the old riverbank while leaves drift."}]
MSGS2 = [{"role": "user", "content": "something else entirely"}]
SERIAL = dict(n_ctx=256, prefill_buckets=(64, 128, 256), max_gen_tokens=8, decode_chunk=4)
PAGED = dict(kv_paged=True, kv_page_tokens=16, kv_pool_pages=64)
BOT = {"name": "Ada", "appearance": "a,b,c,d"}


@pytest.fixture(autouse=True)
def _collect_engines():
    """A registry installs bound methods on itself (a reference cycle), so
    its engines outlive the test until a collection: collect them when each
    test ends, so no later test in the process finds their memory-ledger
    rows."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("registry")
    out = {}
    for name, seed, cfg in (("a", 0, TINY_CFG), ("b", 7, TINY_CFG),
                            ("c", 13, dataclasses.replace(TINY_CFG,
                                                          n_layers=TINY_CFG.n_layers + 1))):
        out[name] = str(d / f"{name}.gguf")
        write_tiny_llama_gguf(out[name], cfg=cfg, seed=seed)
    out["dir"] = str(d)
    return out


def _port_build(**extra):
    def build(spec, path, shared_pool):
        return Engine(path, device="cpu", **SERIAL, **PAGED, **extra, **spec.overrides,
                      kv_pool=shared_pool, kv_namespace=spec.name)
    return build


def _jax_build(**extra):
    def build(spec, path, shared_pool):
        return JEngine(path, **SERIAL, **PAGED, **extra, **spec.overrides,
                       kv_pool=shared_pool, kv_namespace=spec.name)
    return build


def _pair(ggufs, manifest_str: str, budget: int = 0):
    """The port's and the JAX registry over one manifest (paged, shared)."""
    specs = parse_manifest(manifest_str)
    jspecs = jmanifest.parse_manifest(manifest_str)
    mine = ModelRegistry.from_specs(specs, _port_build(), default_model=specs[0].name,
                                    model_dir=ggufs["dir"], weight_budget_bytes=budget)
    ref = JModelRegistry.from_specs(jspecs, _jax_build(), default_model=jspecs[0].name,
                                    model_dir=ggufs["dir"], weight_budget_bytes=budget)
    return mine, ref


def _greedy(reg, model=None, messages=MSGS, n=8) -> str:
    kw = {} if model is None else {"model": model}
    out = reg.create_chat_completion(messages, max_tokens=n, temperature=0.0, **kw)
    return out["choices"][0]["message"]["content"]


def _outcome(fn, *a, **kw):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*a, **kw), None
    except Exception as e:  # noqa: BLE001 — compared across packages
        return None, (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# the manifest grammar
# ---------------------------------------------------------------------------

MANIFESTS = [
    "llama=models/a.gguf:n_ctx=2048;kv_dtype=int8, mistral=/abs/b.gguf",
    "a=x.gguf:decode_layer_unroll=-1;spec_decode=lookup;spec_draft=4",
    "a=x.gguf:weight_format=q4k;attn_impl=xla;decode_chunk=16;max_gen_tokens=9",
    "a=x.gguf:;n_ctx=64;",
    "noequals", "a=x.gguf:bogus=1", "a=x.gguf:n_ctx=abc", "a=x.gguf,a=y.gguf",
    "bad name=x.gguf", "a=", " , ", "a=:n_ctx=3", "a=x.gguf:n_ctx", "a=x.gguf:n_ctx= ",
    "=x.gguf", "a.b-c_d=x.gguf",
]


@pytest.mark.parametrize("spec", MANIFESTS)
def test_manifest_parse_and_rejects_equal_the_references(spec):
    got, gerr = _outcome(parse_manifest, spec)
    want, werr = _outcome(jmanifest.parse_manifest, spec)
    assert gerr == werr
    if got is not None:
        assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
        for req in ("", got[-1].name, "zzz"):
            assert _outcome(pick_default, got, req) == _outcome(jmanifest.pick_default, want,
                                                                req)
    assert manifest.OVERRIDE_KEYS == jmanifest.OVERRIDE_KEYS


@pytest.mark.parametrize("path", ["a.gguf", "sub/../a.gguf", "../../etc/passwd",
                                  "/abs/x.gguf", "sub/../../x.gguf"])
def test_resolved_path_contains_relative_paths_as_the_reference(tmp_path, path):
    d = str(tmp_path / "models")
    got = _outcome(ModelSpec("m", path).resolved_path, d)
    want = _outcome(jmanifest.ModelSpec("m", path).resolved_path, d)
    assert got == want


def test_settings_carry_the_references_registry_and_disagg_knobs(monkeypatch):
    fields = ("models", "default_model", "hbm_weight_budget_mb", "reload_drain_seconds",
              "disagg_role", "disagg_peer", "disagg_bind", "disagg_port",
              "disagg_timeout_seconds", "disagg_queue_frames", "mesh_sp")
    for f in fields:
        assert getattr(Settings(), f) == getattr(JSettings(), f), f
    monkeypatch.setenv("LFKT_MODELS", "x=a.gguf,y=b.gguf")
    monkeypatch.setenv("LFKT_HBM_WEIGHT_BUDGET_MB", "12.5")
    monkeypatch.setenv("LFKT_DISAGG_ROLE", "both")
    s = get_settings()
    assert (s.models, s.hbm_weight_budget_mb, s.disagg_role) == ("x=a.gguf,y=b.gguf", 12.5,
                                                                 "both")


# ---------------------------------------------------------------------------
# serial registries: replies, routing, the shared arena and its namespaces
# ---------------------------------------------------------------------------

def test_serial_registry_replies_equal_the_references_and_each_engine_alone(ggufs):
    mine, ref = _pair(ggufs, "alpha=a.gguf,beta=b.gguf")
    try:
        alone = {n: Engine(ggufs[f], device="cpu", **SERIAL) for n, f in
                 (("alpha", "a"), ("beta", "b"))}
        for model in ("alpha", "beta", None):
            got = _greedy(mine, model)
            assert got == _greedy(ref, model)
            assert got == _greedy(alone[model or "alpha"])
        out = mine.create_chat_completion(MSGS2, max_tokens=4, temperature=0.0, model="beta")
        assert out["model"] == "beta" and out["lfkt_timings"]["model"] == "beta"
        with pytest.raises(UnknownModelError) as ei:
            mine.resolve("gamma")
        with pytest.raises(jregistry.UnknownModelError) as ej:
            ref.resolve("gamma")
        assert str(ei.value) == str(ej.value)
        assert mine.inflight("alpha") == 0
    finally:
        mine.shutdown()
        ref.shutdown()


def test_shared_arena_namespaces_and_counters_equal_the_references_pool(ggufs):
    mine, ref = _pair(ggufs, "alpha=a.gguf,beta=b.gguf")
    try:
        pools = [reg.resolve("alpha")._kvpool for reg in (mine, ref)]
        for reg, pool in zip((mine, ref), pools):
            assert reg.resolve("beta")._kvpool is pool and len(reg._pools()) == 1
        ids = mine.resolve("alpha").tokenize_messages(MSGS)
        assert ids == ref.resolve("alpha").tokenize_messages(MSGS)
        first = {}
        # the same prompt: alpha, then beta (no hit across namespaces), then
        # alpha again (a hit in its own); the counters equal op by op
        for step, model in enumerate(("alpha", "beta", "alpha", "beta")):
            texts = [_greedy(reg, model, n=6) for reg in (mine, ref)]
            assert texts[0] == texts[1], step
            first.setdefault(model, texts[0])
            assert texts[0] == first[model]
            assert pools[0].stats() == pools[1].stats(), step
            occ = [p.occupancy() for p in pools]
            assert occ[0] == occ[1], step
            if step == 1:
                assert pools[0].stats()["hits"] == 0
                assert occ[0]["namespaces"] == 2
        assert pools[0].stats()["hits"] == 2
        assert pools[0].match_len(ids, namespace="gamma") == 0
        assert mine.kv_pool_occupancy() == ref.kv_pool_occupancy()
        assert mine.kv_cache_bytes == mine.resolve("alpha").kv_cache_bytes + \
            mine.resolve("beta").kv_cache_bytes - pools[0].arena_nbytes
    finally:
        mine.shutdown()
        ref.shutdown()


def test_a_deeper_model_degrades_to_a_private_pool_with_the_warning(ggufs, caplog):
    caplog.set_level(logging.WARNING)
    mine, ref = _pair(ggufs, "alpha=a.gguf,gamma=c.gguf")
    try:
        for reg in (mine, ref):
            assert reg.resolve("gamma")._kvpool is not reg.resolve("alpha")._kvpool
            assert len(reg._pools()) == 2
        warned = [r.getMessage() for r in caplog.records
                  if "cannot share the KV page arena" in r.getMessage()]
        assert len(warned) == 2 and warned[0] == warned[1]
        got, want = mine.kv_pool_occupancy(), ref.kv_pool_occupancy()
        assert got["pools"] == want["pools"] == 2
        assert got["per_pool"] == want["per_pool"]
        assert got["pages_total"] == want["pages_total"] == 2 * PAGED["kv_pool_pages"]
        assert _greedy(mine, "gamma") == _greedy(ref, "gamma")
    finally:
        mine.shutdown()
        ref.shutdown()


def test_weight_budget_refusal_names_the_offender(ggufs):
    per_model = Engine(ggufs["a"], device="cpu", **SERIAL).weight_bytes
    specs = parse_manifest("alpha=a.gguf,beta=b.gguf")
    with pytest.raises(WeightBudgetError) as ei:
        ModelRegistry.from_specs(specs, _port_build(), default_model="alpha",
                                 model_dir=ggufs["dir"],
                                 weight_budget_bytes=int(per_model * 1.5))
    msg = str(ei.value)
    assert msg.startswith("HBM weight budget exhausted loading 'beta': ")
    assert f"alpha={per_model / 1e6:.0f}MB, beta={per_model / 1e6:.0f}MB" in msg
    assert "LFKT_HBM_WEIGHT_BUDGET_MB" in msg
    reg = ModelRegistry.from_specs(specs, _port_build(), default_model="alpha",
                                   model_dir=ggufs["dir"],
                                   weight_budget_bytes=int(per_model * 3))
    rows = reg.models()
    assert [r["name"] for r in rows] == ["alpha", "beta"]
    assert all(r["weight_bytes"] == per_model and r["state"] == "ready"
               and r["quant"] == "bf16" and r["kv_dtype"] == "bf16" for r in rows)
    reg.shutdown()


def test_quant_labels_map_the_ports_linear_kinds():
    class Params:
        def __init__(self, kinds):
            self._kinds = kinds

        def formats(self):
            return self._kinds

    def eng(kinds):
        return type("E", (), {"params": Params(kinds)})()

    assert registry._quant_summary(eng({"wq": "q4k", "w2": "q6k", "output": "q8"})) \
        == "q4k-fused+q6k-fused"
    assert registry._quant_summary(eng({"wq": "int8", "w2": "int8"})) == "int8"
    assert registry._quant_summary(eng({"wq": "q5k", "w2": "q8", "w1": "bf16"})) \
        == "bf16+q5k-fused+q8-fused"
    assert registry._quant_summary(object()) is None
    assert set(registry._WEIGHT_KINDS.values()) <= set(jregistry._WEIGHT_KINDS.values())


# ---------------------------------------------------------------------------
# live reload
# ---------------------------------------------------------------------------

def _report(doc: dict) -> dict:
    """A reload report without its wall time and paths."""
    out = {k: v for k, v in doc.items() if k not in ("wall_s", "models")}
    out["models"] = [{k: v for k, v in r.items() if k not in ("path", "weight_bytes", "quant")}
                     for r in doc["models"]]
    return out


def test_reload_adds_removes_drains_and_reresolves_as_the_reference(ggufs):
    mine, ref = _pair(ggufs, "alpha=a.gguf,beta=b.gguf")
    try:
        for reg in (mine, ref):
            _greedy(reg, "alpha")
            _greedy(reg, "beta")
        pool = mine._pools()[0]
        alpha_pages = pool._ns_pages["alpha"]
        assert pool._ns_pages["beta"] > 0
        added = [reg.reload_manifest("alpha=a.gguf,beta=b.gguf,gamma=c.gguf")
                 for reg in (mine, ref)]
        assert _report(added[0]) == _report(added[1])
        assert added[0]["added"] == ["gamma"] and mine.model_names() == ["alpha", "beta",
                                                                           "gamma"]
        assert _greedy(mine, "gamma") == _greedy(ref, "gamma")
        assert len(mine._pools()) == 2          # gamma is deeper: a private pool
        evictions = pool.counters["evictions"]
        removed = [reg.reload_manifest("gamma=c.gguf,alpha=a.gguf") for reg in (mine, ref)]
        assert _report(removed[0]) == _report(removed[1])
        assert removed[0]["removed"] == [{"name": "beta", "pages_remaining": 0,
                                          "inflight_at_release": 0}]
        assert removed[0]["default_model"] == "gamma" and mine.resolve(None).model_name == "gamma"
        assert pool._ns_pages.get("beta") is None and "beta" not in pool._roots
        assert pool.counters["evictions"] == evictions
        assert pool._ns_pages["alpha"] == alpha_pages
        assert pool.occupancy()["pages_pinned"] == 0
        with pytest.raises(UnknownModelError):
            mine.resolve("beta")
        out = mine.create_chat_completion(MSGS, max_tokens=8, temperature=0.0, model="alpha")
        assert out["lfkt_timings"]["prefix_reused_tokens"] > 0
        # a kept model's spec cannot change in place; the set stays
        errs = [_outcome(reg.reload_manifest, "gamma=c.gguf:n_ctx=128,alpha=a.gguf")
                for reg in (mine, ref)]
        assert errs[0] == errs[1] and errs[0][1][0] == "ValueError"
        assert mine.model_names() == ["alpha", "gamma"]
    finally:
        mine.shutdown()
        ref.shutdown()


def test_reload_over_the_budget_is_refused_and_the_set_untouched(ggufs):
    mine, ref = _pair(ggufs, "alpha=a.gguf,beta=b.gguf")
    try:
        errs = []
        for reg in (mine, ref):
            reg._weight_budget_bytes = sum(r["weight_bytes"] for r in reg.models()) + 1
            errs.append(_outcome(reg.reload_manifest, "alpha=a.gguf,beta=b.gguf,gamma=c.gguf"))
        assert errs[0][1][0] == errs[1][1][0] == "WeightBudgetError"
        assert "gamma" in errs[0][1][1] and "the running set is untouched" in errs[0][1][1]
        assert mine.model_names() == ["alpha", "beta"]
        assert [r["state"] for r in mine.models()] == ["ready", "ready"]
        assert _greedy(mine, "alpha") == _greedy(ref, "alpha")
    finally:
        mine.shutdown()
        ref.shutdown()


class _Slow:
    """An engine-shaped stub whose reply takes ``delay`` seconds."""

    def __init__(self, reply: str, delay: float = 0.0, explode: bool = False):
        self.reply, self.delay, self.explode = reply, delay, explode
        self.model_name = reply
        self.weight_bytes = 10
        self.closed = 0

    def warmup(self):
        if self.explode:
            raise RuntimeError("compile boom")

    def create_chat_completion(self, messages, stream=False, **kw):
        time.sleep(self.delay)
        return {"choices": [{"message": {"content": self.reply}}]}

    def close(self):
        self.closed += 1

    shutdown = close


def test_reload_waits_for_in_flight_requests_before_release():
    slow = _Slow("slow-done", delay=0.6)
    reg = ModelRegistry({"alpha": _Slow("a"), "beta": slow}, "alpha")
    got = {}
    th = threading.Thread(target=lambda: got.update(
        beta=reg.create_chat_completion([{"role": "user", "content": "hi"}], model="beta")))
    th.start()
    time.sleep(0.15)
    assert reg.inflight("beta") == 1
    t0 = time.time()
    doc = reg.reload_manifest("alpha=whatever.gguf")
    wall = time.time() - t0
    th.join(timeout=5)
    assert wall >= 0.3 and slow.closed == 1
    assert doc["removed"] == [{"name": "beta", "pages_remaining": 0,
                               "inflight_at_release": 0}]
    assert got["beta"]["choices"][0]["message"]["content"] == "slow-done"
    with pytest.raises(UnknownModelError):
        reg.resolve("beta")


def test_reload_warmup_failure_unwinds_everything():
    built = {}

    def build(spec, path, pool):
        built[spec.name] = _Slow(spec.name, explode=spec.name == "bad")
        return built[spec.name]

    class Sink:
        def __init__(self):
            self.incs = []

        def inc(self, name, value=1.0, **labels):
            self.incs.append((name, labels))

    reg = ModelRegistry.from_specs(parse_manifest("alpha=x.gguf"), build, default_model="alpha")
    reg.metrics_sink = Sink()
    with pytest.raises(RuntimeError, match="compile boom"):
        reg.reload_manifest("alpha=x.gguf,good=y.gguf,bad=z.gguf")
    assert reg.model_names() == ["alpha"] and [r["name"] for r in reg.models()] == ["alpha"]
    assert built["good"].closed == 1 and built["bad"].closed == 1
    assert built["alpha"].closed == 0
    assert reg.metrics_sink.incs == [("model_reloads_total", {"action": "refused"})]
    with pytest.raises(ValueError, match="cannot load new ones"):
        ModelRegistry({"alpha": _Slow("a")}, "alpha").reload_manifest("alpha=x,new=y")


# ---------------------------------------------------------------------------
# continuous registries
# ---------------------------------------------------------------------------

def test_continuous_registry_replies_equal_the_references(ggufs):
    ckw = dict(n_ctx=128, prefill_buckets=(32, 64, 128), batch_size=2, prefill_chunk=16,
               decode_chunk=4, max_gen_tokens=8)
    mine = ModelRegistry({n: ContinuousEngine(ggufs[f], device="cpu", **ckw)
                          for n, f in (("alpha", "a"), ("beta", "b"))}, "alpha")
    ref = JModelRegistry({n: JContinuousEngine(ggufs[f], **ckw)
                          for n, f in (("alpha", "a"), ("beta", "b"))}, "alpha")
    try:
        outs = []
        for reg in (mine, ref):
            futs = [reg.submit(m, max_tokens=8, temperature=0.0, model=n)
                    for n, m in (("alpha", MSGS), ("beta", MSGS2), ("alpha", MSGS2),
                                 ("beta", MSGS))]
            outs.append([f.result(timeout=T)["choices"][0]["message"]["content"]
                         for f in futs])
        assert outs[0] == outs[1]
        stats = mine.scheduler_stats()
        want = ref.scheduler_stats()
        assert stats["models"] == 2 and "alpha_lanes_live" in stats
        assert {"adm_budget_tokens", "lane_idle_seconds"} <= set(stats)
        assert set(k for k in stats if not k.endswith("_seconds")) <= set(want) | {
            k for k in stats if k.startswith(("alpha_", "beta_"))}
    finally:
        mine.shutdown()
        ref.shutdown()


def test_registry_factory_refusals_and_single_entry_shape(ggufs, monkeypatch):
    from llama_fastapi_k8s_gpu_tpu_torch.engine import engine as engine_mod

    monkeypatch.setattr(engine_mod, "resolve_device", lambda device=None: torch.device("cpu"))
    a = ggufs["a"]
    reg = _registry_factory(Settings(models=f"solo={a}", scheduler="cycle", batch_size=2,
                                     max_context_tokens=128, prefill_buckets="32"))
    try:
        assert type(reg.resolve(None)).__name__ == "MeshEngine"
    finally:
        reg.shutdown()
    from llama_fastapi_k8s_gpu_tpu.server.app import _registry_factory as j_registry_factory

    for kw in (dict(models=f"x={a},y={a}", scheduler="cycle", batch_size=2),
               dict(models=f"solo={a}", mesh_sp=2, batch_size=2),
               dict(models=f"x={a},y={a}", mesh_sp=2)):
        got = _outcome(_registry_factory, Settings(**kw))
        want = _outcome(j_registry_factory, JSettings(**kw))
        assert got == want and got[1][0] == "ValueError"


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------

def _body(model=None) -> dict:
    b = {"bot_profile": BOT, "user_profile": {"name": "Bob"},
         "context": [{"turn": "user", "message": "hello there, how was your day?"}]}
    if model is not None:
        b["model"] = model
    return b


def _v1(model, **kw) -> dict:
    return {"model": model, "max_tokens": 6, "temperature": 0.0,
            "messages": [{"role": "user", "content": "hi"}], **kw}


def _rows(doc: dict) -> list:
    return [{k: v for k, v in r.items() if k not in ("path", "weight_bytes", "quant")}
            for r in doc]


def test_app_routes_equal_the_references(ggufs):
    mine, ref = _pair(ggufs, "alpha=a.gguf,beta=b.gguf")
    apps = [create_app(engine=mine, settings=Settings(temperature=0.0, watchdog=False,
                                                      model_dir=ggufs["dir"])),
            j_create_app(engine=ref, settings=JSettings(temperature=0.0, watchdog=False,
                                                        model_dir=ggufs["dir"]))]

    async def go(apps):
        out = []
        for a in apps:
            doc = {}
            st, _, b = await call(a, "GET", "/v1/models")
            doc["models"] = (st, [m["id"] for m in json.loads(b)["data"]])
            for model in ("alpha", "beta", None):
                st, _, b = await call(a, "POST", "/response", _body(model))
                doc[f"response/{model}"] = (st, json.loads(b))
                st, _, b = await call(a, "POST", "/v1/chat/completions", _v1(model or "alpha"))
                d = json.loads(b)
                doc[f"v1/{model}"] = (st, d["model"], d["choices"][0]["message"]["content"])
            st, _, b = await call(a, "POST", "/response", _body("gamma"))
            doc["response/gamma"] = (st, json.loads(b))
            st, _, b = await call(a, "POST", "/v1/chat/completions", _v1("gamma"))
            doc["v1/gamma"] = (st, json.loads(b))
            st, _, b = await call(a, "GET", "/health")
            h = json.loads(b)
            doc["health"] = (st, _rows(h["engine"]["models"]), h["engine"]["default_model"])
            st, _, b = await call(a, "GET", "/metrics")
            doc["metrics"] = sorted(ln for ln in b.decode().splitlines()
                                    if ln.startswith(("models_loaded", "model_reloads_total")))
            st, _, b = await call(a, "POST", "/admin/models/reload",
                                  {"models": "beta=b.gguf", "default_model": "beta"})
            r = json.loads(b)
            doc["reload"] = (st, r["added"], r["removed"], r["default_model"], r["kept"])
            st, _, b = await call(a, "GET", "/v1/models")
            doc["models_after"] = (st, [m["id"] for m in json.loads(b)["data"]])
            st, _, b = await call(a, "POST", "/admin/models/reload",
                                  {"models": "beta=b.gguf,evil=../../../../etc/passwd"})
            doc["reload_evil"] = (st, json.loads(b))
            st, _, b = await call(a, "POST", "/admin/models/reload", {"models": "beta=b:x=1"})
            doc["reload_bad"] = (st, json.loads(b))
            st, _, b = await call(a, "GET", "/metrics")
            doc["metrics_after"] = sorted(ln for ln in b.decode().splitlines()
                                          if ln.startswith(("models_loaded",
                                                            "model_reloads_total")))
            out.append(doc)
        return out

    try:
        got, want = serve(apps, go)
    finally:
        mine.shutdown()
        ref.shutdown()
    assert got == want
    assert got["models"] == (200, ["alpha", "beta"])
    assert got["response/gamma"][0] == 400 and "alpha, beta" in got["response/gamma"][1]["detail"]
    assert got["v1/gamma"][0] == 400
    assert got["v1/gamma"][1]["error"]["code"] == "model_not_found"
    assert got["reload"] == (200, [], [{"name": "alpha", "pages_remaining": 0,
                                        "inflight_at_release": 0}], "beta", ["beta"])
    assert got["models_after"] == (200, ["beta"])
    assert got["reload_evil"][0] == 400 and "escapes the model dir" in got["reload_evil"][1][
        "detail"]
    assert any('model_reloads_total{action="remove"} 1' in ln for ln in got["metrics_after"])


def test_admin_reload_is_refused_on_a_single_engine(ggufs):
    app = create_app(engine=Engine(ggufs["a"], device="cpu", **SERIAL),
                     settings=Settings(watchdog=False))

    async def go(apps):
        st, _, b = await call(apps[0], "POST", "/admin/models/reload", {"models": "x=a.gguf"})
        return st, json.loads(b)

    st, doc = serve([app], go)
    assert st == 400 and "single engine" in doc["detail"]


def test_reload_never_releases_an_engine_under_a_request_under_stress():
    """16 threads hammer one alias while a reload removes it, the switch
    interval shortened: every request either ran on the engine before its
    release or got UnknownModelError; none ran on a released engine, and
    the in-flight count ends at zero."""
    import sys

    class Counting(_Slow):
        def __init__(self, reply):
            super().__init__(reply)
            self.after_close = 0
            self.served = 0

        def create_chat_completion(self, messages, stream=False, **kw):
            if self.closed:
                self.after_close += 1
            self.served += 1
            return super().create_chat_completion(messages, stream, **kw)

    beta = Counting("b")
    reg = ModelRegistry({"alpha": _Slow("a"), "beta": beta}, "alpha")
    outcomes = {"ok": 0, "unknown": 0}
    lock = threading.Lock()

    def client():
        for _ in range(50):
            try:
                reg.create_chat_completion([{"role": "user", "content": "x"}], model="beta")
                key = "ok"
            except UnknownModelError:
                key = "unknown"
            with lock:
                outcomes[key] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client) for _ in range(16)]
        for th in threads:
            th.start()
        time.sleep(0.01)
        doc = reg.reload_manifest("alpha=x.gguf", drain_seconds=30)
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert outcomes["ok"] + outcomes["unknown"] == 16 * 50
    assert beta.after_close == 0 and beta.closed == 1 and beta.served == outcomes["ok"]
    assert reg.inflight("beta") == 0 and doc["removed"][0]["inflight_at_release"] == 0

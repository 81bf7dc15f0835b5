"""The model registry: N named engines served from one process, one card.

The port of the JAX package's registry
(llama_fastapi_k8s_gpu_tpu/serving/registry.py).  The registry

- loads every :class:`~.manifest.ModelSpec` through a caller-supplied
  ``build`` function (the server factory closes over the process-wide
  scheduler settings, so every model gets the same serving shape — lanes,
  chunk cadence, admission control);
- accounts an explicit **weight budget** on the card across the set and
  refuses at load time, with per-model attribution, when the fleet cannot
  fit (``LFKT_HBM_WEIGHT_BUDGET_MB``), after the memory ledger's pre-load
  fit check against the card's free bytes;
- threads one **shared paged KV arena** through every compatible engine
  (the same per-page geometry), with per-model radix **namespaces**, so
  one tenant's system prompt never produces a prefix hit for another
  (parallel/kvpool.py);
- routes per-request ``model=`` to the named engine.  In continuous mode
  each model owns a scheduler thread and its lane graph; their replays
  interleave on the card.

Gating, with attribution: the ``cycle`` scheduler coalesces requests into
one shared lane program, which cannot interleave models — the server
factory refuses it with more than one model.  The engine watchdog is
single-engine and does not run over a registry.  A removed model's engine
is closed (its graphs and their memory pools released) and dropped, so
its weights leave the card.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time

from ..obs import memledger as _memledger
from ..obs.logctx import sanitize_text
from .manifest import ModelSpec, parse_manifest, pick_default

logger = logging.getLogger(__name__)


class UnknownModelError(ValueError):
    """A request named a model the manifest does not serve (HTTP 400)."""

    def __init__(self, model: str, known: list[str]):
        self.model = model
        self.known = list(known)
        super().__init__(
            f"unknown model {model!r}; this pod serves: "
            f"{', '.join(self.known)}")


class WeightBudgetError(RuntimeError):
    """The manifest's weights exceed the declared HBM budget."""


#: the port's Linear kinds (``ops.linear.Linear.kind``) -> the reference's
#: served-layout labels.  The port's fused Q5_K/Q6_K kernels take either
#: block layout, so its labels carry no ``-pre`` variant
_WEIGHT_KINDS = {"q4k": "q4k-fused", "q5k": "q5k-fused", "q6k": "q6k-fused",
                 "q8": "q8-fused", "int8": "int8", "bf16": "bf16"}


def _quant_summary(engine) -> str | None:
    """One label for how the model's layer linears are served (e.g.
    ``q4k-fused+q6k-fused`` when kinds differ) — the /health ``models``
    row's ``quant`` field."""
    formats = getattr(getattr(engine, "params", None), "formats", None)
    if not callable(formats):
        return None
    labels = {_WEIGHT_KINDS.get(kind, "?")
              for name, kind in formats().items() if name != "output"}
    return "+".join(sorted(labels)) if labels else None


def _release(engine) -> None:
    """Stop a removed (or unwound) engine and release its graphs and their
    memory pools; its weights go with the last reference to it."""
    close = getattr(engine, "close", None) or getattr(engine, "shutdown", None)
    if close is not None:
        close()


class ModelRegistry:
    """Named engines behind one engine-shaped facade.

    The server talks to a registry exactly as it talks to a single
    engine (``create_chat_completion`` / ``submit`` / ``scheduler_stats``
    / ``kv_cache_bytes`` ...), plus ``model=`` routing and the
    ``models()`` descriptor that feeds ``GET /v1/models`` and the
    /health ``models`` block.  ``submit``/``submit_stream``/
    ``create_chat_completions`` are installed only when every engine
    provides them, so the server's capability probes keep working.
    """

    # lock discipline: one mutex guards the routing dict, the descriptor
    # rows and the in-flight counters; the separate _reload_lock serializes
    # whole reload operations (loads run outside _lock — a multi-GB load
    # must not stall resolve())

    # -- lock discipline (lfkt-lint LOCK001-004): one mutex guards the
    # routing dict, the descriptor rows and the in-flight counters; the
    # separate _reload_lock serializes whole reload operations (loads
    # run OUTSIDE _lock — a multi-GB load must not stall resolve())
    _GUARDED_BY = {
        "_engines": "_lock",
        "_model_info": "_lock",
        "_inflight": "_lock",
        "_specs": "_lock",
    }

    def __init__(self, engines: dict[str, object], default_model: str,
                 model_info: list[dict] | None = None):
        if not engines:
            raise ValueError("ModelRegistry needs at least one engine")
        if default_model not in engines:
            raise ValueError(
                f"default model {default_model!r} is not among "
                f"{', '.join(engines)}")
        self._lock = threading.Lock()
        self._reload_lock = threading.Lock()
        #: in-flight requests per model alias — reload's removal path
        #: waits for a model's count to reach zero before draining its
        #: namespace and releasing its weights
        self._inflight: dict[str, int] = {}
        #: the manifest specs behind each live engine (from_specs fills
        #: this; direct construction leaves it empty, which disables
        #: override-change detection but still allows remove-only reloads)
        self._specs: dict[str, ModelSpec] = {}
        #: reload plumbing (from_specs): the engine builder + its inputs
        self._build = None
        self._model_dir = "models"
        self._weight_budget_bytes = 0
        self._engines = dict(engines)
        for name, eng in self._engines.items():
            # the registry alias IS the serving identity: responses,
            # traces, /debug/requests rows and metric labels all read
            # model_name (from_specs already did this; direct
            # construction — tests, embedders — gets it here)
            try:
                eng.model_name = name
            except AttributeError:   # read-only property: keep its label
                pass
        self.default_model = default_model
        #: single-model-compat surface: responses carry their own model
        #: name; this is only the fallback label (e.g. untimed fakes)
        self.model_name = default_model
        self._model_info = list(model_info or [])
        if not self._model_info:
            self._model_info = [
                self._describe(name, eng, path=None)
                for name, eng in self._engines.items()
            ]
        self._metrics_sink = None
        if all(hasattr(e, "submit") for e in self._engines.values()):
            self.submit = self._submit
        if all(hasattr(e, "submit_stream") for e in self._engines.values()):
            self.submit_stream = self._submit_stream
        if all(hasattr(e, "create_chat_completions")
               for e in self._engines.values()):
            self.create_chat_completions = self._create_chat_completions
        if all(hasattr(e, "scheduler_stats")
               for e in self._engines.values()):
            self.scheduler_stats = self._scheduler_stats

    # ------------------------------------------------------------------
    @staticmethod
    def _describe(name: str, engine, path: str | None,
                  state: str = "ready") -> dict:
        # ``state`` is the live-reload observability surface:
        # loading (fit-checked, weights still coming up) -> ready
        # (routable) -> draining (unrouted, in-flight finishing + radix
        # namespace retiring).  /health shows every row; /v1/models lists
        # only routable ones — a half-reloaded pod is observable, never
        # lying.
        cfg = getattr(engine, "cfg", None)
        return {
            "name": name,
            "path": path,
            "quant": _quant_summary(engine),
            "weight_bytes": int(getattr(engine, "weight_bytes", 0) or 0),
            "n_ctx": getattr(cfg, "n_ctx", None),
            "kv_dtype": getattr(cfg, "kv_dtype", None),
            "state": state,
        }

    @classmethod
    def from_specs(cls, specs: list[ModelSpec], build, *,
                   default_model: str, model_dir: str = "models",
                   weight_budget_bytes: int = 0) -> "ModelRegistry":
        """Load every spec through ``build(spec, path, shared_pool)``,
        accounting the HBM weight budget as the fleet grows and sharing
        the first paged engine's KV pool with every later compatible one.

        ``build`` must return an un-warmed engine; call
        :meth:`warmup` on the returned registry afterwards (budget
        refusal should cost a load, never a compile sweep)."""
        engines: dict[str, object] = {}
        info: list[dict] = []
        shared_pool = None
        used = 0
        eng = None
        try:
            for spec in specs:
                path = spec.resolved_path(model_dir)
                # pre-load fit check: before a multi-GB load even
                # starts, ask the memory ledger whether the device can hold
                # it (file size lower-bounds the resident weight bytes; the
                # serving layout is never smaller than the quantized file).
                # Where the backend reports no memory_stats (CPU) this is a
                # no-op and the weight BUDGET below stays the only gate.
                try:
                    est = os.path.getsize(path)
                except OSError:
                    est = 0             # missing file: let build() name it
                refusal = _memledger.MEMLEDGER.fit_check(est, label=spec.name)
                if refusal is not None:
                    raise WeightBudgetError(refusal)
                eng = build(spec, path, shared_pool)
                # responses, traces, /debug/requests rows and metric labels
                # all read model_name — the manifest alias IS the serving
                # identity, not the GGUF's embedded general.name
                eng.model_name = spec.name
                row = cls._describe(spec.name, eng, path=path)
                used += row["weight_bytes"]
                if weight_budget_bytes and used > weight_budget_bytes:
                    table = ", ".join(
                        f"{r['name']}={r['weight_bytes'] / 1e6:.0f}MB"
                        for r in info + [row])
                    raise WeightBudgetError(
                        f"HBM weight budget exhausted loading {spec.name!r}: "
                        f"{used / 1e6:.0f}MB of weights vs "
                        f"LFKT_HBM_WEIGHT_BUDGET_MB="
                        f"{weight_budget_bytes / 1e6:.0f}MB ({table}); shrink "
                        "the manifest, quantize harder, or raise the budget "
                        "(docs/MULTIMODEL.md)")
                engines[spec.name] = eng
                info.append(row)
                if shared_pool is None:
                    shared_pool = getattr(eng, "_kvpool", None)
        except BaseException:
            # a refused or failed load: release what this call loaded, the
            # engine over the budget included
            if eng is not None and all(e is not eng for e in engines.values()):
                _release(eng)
            for e in engines.values():
                _release(e)
            raise
        logger.info(  # lfkt: sanitizes[manifest] -- used is an integer byte counter (getsize/_describe sums); the only manifest string here is default_model, sanitized below
            "model registry: %d models, %.0fMB weights%s (default=%s)",
            len(engines), used / 1e6,
            f" of {weight_budget_bytes / 1e6:.0f}MB budget"
            if weight_budget_bytes else "",
            # the name may come from a POSTed reload manifest
            sanitize_text(default_model, limit=128))
        reg = cls(engines, default_model, model_info=info)
        # live-reload plumbing (reload_manifest): the SAME builder +
        # budget the startup load used, so a reloaded model is shaped
        # exactly like a boot-loaded one
        reg._build = build
        reg._model_dir = model_dir
        reg._weight_budget_bytes = weight_budget_bytes
        reg._specs = {s.name: s for s in specs}
        return reg

    # -- routing --------------------------------------------------------
    def model_names(self) -> list[str]:
        return list(self._engines)

    def has_model(self, name: str) -> bool:
        return name in self._engines

    def resolve(self, model: str | None):
        """The engine serving ``model`` (None = the default alias)."""
        name = model or self.default_model
        eng = self._engines.get(name)
        if eng is None:
            raise UnknownModelError(name, list(self._engines))
        return eng

    def models(self) -> list[dict]:
        """Manifest descriptor rows — ``GET /v1/models`` and the /health
        ``models`` block (name, quant, weight bytes, load state)."""
        with self._lock:
            return [dict(r) for r in self._model_info]

    # -- in-flight accounting (the reload drain's wait condition) --------
    def _resolve_tracked(self, model: str | None):
        """(name, engine) with the model's in-flight count raised; every
        facade entry pairs this with exactly one :meth:`_track_exit`.
        Lookup and increment share ONE lock acquisition: a reload
        removing the model either happens-before (the request 400s) or
        happens-after (the drain sees the raised count and waits) —
        never in between, where it would shut the engine down under a
        just-admitted request."""
        name = model or self.default_model
        with self._lock:
            eng = self._engines.get(name)
            if eng is not None:
                self._inflight[name] = self._inflight.get(name, 0) + 1
            known = list(self._engines)
        if eng is None:
            raise UnknownModelError(name, known)
        return name, eng

    def _track_exit(self, name: str) -> None:
        with self._lock:
            left = self._inflight.get(name, 0) - 1
            if left > 0:
                self._inflight[name] = left
            else:
                self._inflight.pop(name, None)

    def inflight(self, name: str) -> int:
        with self._lock:
            return self._inflight.get(name, 0)

    def _tracked_iter(self, name: str, it):
        """Stream wrapper: the request stays in-flight until the engine
        iterator finishes OR the caller closes it (disconnect path)."""
        try:
            yield from it
        finally:
            self._track_exit(name)

    # -- engine-shaped facade -------------------------------------------
    def create_chat_completion(self, messages, stream: bool = False, *,
                               model: str | None = None, **kw):
        name, eng = self._resolve_tracked(model)
        if stream:
            try:
                it = eng.create_chat_completion(messages, stream=True,
                                                **kw)
            except BaseException:
                self._track_exit(name)
                raise
            return self._tracked_iter(name, it)
        try:
            return eng.create_chat_completion(messages, stream=False, **kw)
        finally:
            self._track_exit(name)

    def _submit(self, messages, *, model: str | None = None, **kw):
        name, eng = self._resolve_tracked(model)
        try:
            fut = eng.submit(messages, **kw)
        except BaseException:
            self._track_exit(name)
            raise
        fut._lfkt_engine = eng           # abandon() routes through this
        fut.add_done_callback(lambda _f: self._track_exit(name))
        return fut

    def _submit_stream(self, messages, *, model: str | None = None, **kw):
        name, eng = self._resolve_tracked(model)
        try:
            it = eng.submit_stream(messages, **kw)
        except BaseException:
            self._track_exit(name)
            raise
        return self._tracked_iter(name, it)

    def _create_chat_completions(self, batch_messages, *,
                                 model: str | None = None, **kw):
        name, eng = self._resolve_tracked(model)
        try:
            return eng.create_chat_completions(batch_messages, **kw)
        finally:
            self._track_exit(name)

    def abandon(self, fut) -> None:
        eng = getattr(fut, "_lfkt_engine", None)
        if eng is not None and hasattr(eng, "abandon"):
            eng.abandon(fut)

    def warmup(self) -> None:
        for name, eng in self._engines.items():
            logger.info("warming up model %r", name)
            eng.warmup()

    def shutdown(self) -> None:
        for eng in self._engines.values():
            _release(eng)

    # -- live manifest reload (docs/MULTIMODEL.md) -------------------------
    #: facade capabilities every engine must share; an added engine
    #: missing one the registry installed at construction would silently
    #: break the server's capability probes mid-flight — refuse instead
    _CAPABILITIES = ("submit", "submit_stream", "create_chat_completions",
                     "scheduler_stats")

    def _emit_reload(self, action: str) -> None:
        m = self._metrics_sink
        if m is None:
            return
        try:
            m.inc("model_reloads_total", action=action)
        except Exception:  # noqa: BLE001 — telemetry must never fail reload
            pass

    def _set_state(self, name: str, state: str) -> None:
        with self._lock:
            for r in self._model_info:
                if r["name"] == name:
                    r["state"] = state

    def reload_manifest(self, manifest: str, default_model: str = "", *,  # lfkt: blocks-under[_reload_lock] -- reloads serialize whole-operation by design; the routing lock (_lock) is never held across loads, so resolve() stays hot
                        drain_seconds: float = 30.0) -> dict:
        """Diff a new ``LFKT_MODELS`` manifest against the running set and
        converge to it WITHOUT a pod restart (``POST /admin/models/reload``
        and SIGHUP — server/app.py):

        - **added** models load under the memory ledger's pre-load fit
          check and the HBM weight budget — a refusal
          (:class:`WeightBudgetError`) unwinds everything this reload
          loaded and leaves the running set untouched;
        - **removed** models first leave the routing table (new requests
          400 with the live model list), then wait out their in-flight
          requests (bounded by ``drain_seconds``), then retire their
          radix namespace through the pool's drain path
          (``KVPool.drain_namespace`` — pages freed, no cross-namespace
          eviction) before the engine is closed (graphs and their pools
          released) and dropped, its weights with it;
        - **kept** models are untouched — changing a kept model's
          overrides/path is refused with attribution (remove + re-add
          under the new spec, or restart);
        - the default alias re-resolves against the NEW manifest
          (``LFKT_DEFAULT_MODEL`` semantics, pick_default).

        Model rows surface the transition (``loading``/``ready``/
        ``draining``) in /health throughout; /v1/models lists the
        routable set.  Returns the reload report."""
        specs = parse_manifest(manifest)
        default = pick_default(specs, default_model)
        with self._reload_lock:
            return self._reload(specs, default, drain_seconds)

    def _reload(self, specs: list[ModelSpec], default: str,
                drain_seconds: float) -> dict:
        t0 = time.time()
        new_names = {s.name for s in specs}
        added = [s for s in specs if s.name not in self._engines]
        removed = [n for n in self._engines if n not in new_names]
        changed = [s.name for s in specs
                   if s.name in self._specs and self._specs[s.name] != s]
        if changed:
            raise ValueError(
                f"reload cannot change a live model's spec in place: "
                f"{', '.join(sorted(changed))} (remove the alias in one "
                "reload and re-add it under the new path/overrides in the "
                "next, or restart the pod — docs/MULTIMODEL.md)")
        if added and self._build is None:
            raise ValueError(
                "this registry was not built from a manifest "
                "(ModelRegistry.from_specs): it can retire models but "
                "cannot load new ones")

        # -- phase 1: load additions (budget-refusable, running set
        # untouched until every addition is in hand) ----------------------
        loaded: list[tuple[ModelSpec, object, dict]] = []
        try:
            for spec in added:
                path = spec.resolved_path(self._model_dir)
                try:
                    est = os.path.getsize(path)
                except OSError:
                    est = 0         # missing file: let build() name it
                refusal = _memledger.MEMLEDGER.fit_check(est,
                                                         label=spec.name)
                if refusal is not None:
                    raise WeightBudgetError(refusal)
                # the loading row is visible in /health BEFORE the
                # (potentially minutes-long) load — observable, not lying
                placeholder = {"name": spec.name, "path": path,
                               "quant": None, "weight_bytes": 0,
                               "n_ctx": None, "kv_dtype": None,
                               "state": "loading"}
                with self._lock:
                    self._model_info.append(placeholder)
                eng = self._build(spec, path, self._shared_pool())
                eng.model_name = spec.name
                missing = [c for c in self._CAPABILITIES
                           if hasattr(self, c) and not hasattr(eng, c)]
                if missing:
                    raise ValueError(
                        f"added model {spec.name!r} lacks the fleet's "
                        f"shared capabilities ({', '.join(missing)}): "
                        "every co-resident engine must share one serving "
                        "shape (docs/MULTIMODEL.md)")
                row = self._describe(spec.name, eng, path=path,
                                     state="loading")
                budget = self._weight_budget_bytes
                used = self._live_weight_bytes() \
                    + sum(r["weight_bytes"] for _s, _e, r in loaded) \
                    + row["weight_bytes"]
                if budget and used > budget:
                    table = ", ".join(
                        f"{r['name']}={r['weight_bytes'] / 1e6:.0f}MB"
                        for r in self.models() + [row]
                        if r["weight_bytes"])
                    raise WeightBudgetError(
                        f"HBM weight budget exhausted reloading "
                        f"{spec.name!r}: {used / 1e6:.0f}MB of weights vs "
                        f"LFKT_HBM_WEIGHT_BUDGET_MB={budget / 1e6:.0f}MB "
                        f"({table}); the running set is untouched "
                        "(docs/MULTIMODEL.md)")
                # warm INSIDE the refusable phase: a failed compile
                # unwinds like a failed load (running set untouched),
                # instead of leaving earlier additions half-installed.
                # Appended BEFORE warming so the unwind releases this
                # engine too when its own warmup raises.
                loaded.append((spec, eng, row))
                logger.info("reload: warming up model %r", spec.name)
                eng.warmup()
        except Exception:
            # unwind: release everything THIS reload loaded and drop the
            # loading rows — the running set stays exactly as it was
            for _spec, eng, _row in loaded:
                _release(eng)
            loaded.clear()
            gc.collect()
            with self._lock:
                self._model_info = [
                    r for r in self._model_info
                    if not (r["state"] == "loading"
                            and r["name"] in {s.name for s in added})]
            self._emit_reload("refused")
            raise

        # install: every addition loaded AND warmed (all of phase 1 ran
        # off the routing lock — live traffic never stalled), so turning
        # routable is pure bookkeeping with no failure modes left
        for spec, eng, row in loaded:
            if self._metrics_sink is not None \
                    and hasattr(eng, "metrics_sink"):
                eng.metrics_sink = self._metrics_sink
            row["state"] = "ready"
            with self._lock:
                self._engines[spec.name] = eng
                self._specs[spec.name] = spec
                self._model_info = [
                    r for r in self._model_info
                    if not (r["name"] == spec.name
                            and r["state"] == "loading")] + [row]
            self._emit_reload("add")
            logger.info("reload: model %r ready", spec.name)

        # the default re-resolves against the NEW manifest BEFORE any
        # removal, so there is no instant with a dangling default
        self.default_model = default
        self.model_name = default

        # -- phase 2: removals (drain, then release) ----------------------
        drained: list[dict] = []
        for name in removed:
            with self._lock:
                eng = self._engines.pop(name)
                self._specs.pop(name, None)
            self._set_state(name, "draining")
            deadline = time.time() + drain_seconds
            # in-flight requests on the removed model finish (new ones
            # already 400 — the alias left the routing table above)
            while self.inflight(name) and time.time() < deadline:
                time.sleep(0.05)
            stranded = self.inflight(name)
            if stranded:
                logger.warning(
                    "reload: removing %r with %d request(s) still "
                    "in flight after the %.0fs drain budget", name,
                    stranded, drain_seconds)
            # retire the radix namespace: pages freed (never evicted
            # cross-namespace), polled until in-flight leases release
            pool = getattr(eng, "_kvpool", None)
            remaining = 0
            if pool is not None and hasattr(pool, "drain_namespace"):
                remaining = pool.drain_namespace(name)
                while remaining and time.time() < deadline:
                    time.sleep(0.05)
                    remaining = pool.drain_namespace(name)
            _release(eng)
            eng = pool = None
            # the engine's last references: reference cycles (its scheduler
            # thread's closures) go now, so its weights leave the card here
            gc.collect()
            with self._lock:
                self._model_info = [r for r in self._model_info
                                    if r["name"] != name]
            self._emit_reload("remove")
            drained.append({"name": name, "pages_remaining": remaining,
                            "inflight_at_release": stranded})
            logger.info("reload: model %r removed (namespace drained, "
                        "%d pages remaining)", name, remaining)

        return {
            "added": [s.name for s in added],
            "removed": drained,
            "kept": sorted(n for n in new_names
                           if n not in {s.name for s in added}),
            "default_model": self.default_model,
            "models": self.models(),
            "wall_s": round(time.time() - t0, 3),
        }

    def _live_weight_bytes(self) -> int:
        with self._lock:
            return sum(r["weight_bytes"] for r in self._model_info
                       if r["state"] == "ready")

    def _shared_pool(self):
        """The pool new engines should join: the fleet's first live pool
        (build degrades geometry-incompatible engines to a private pool,
        exactly like the startup path)."""
        pools = self._pools()
        return pools[0] if pools else None

    # -- telemetry fan-in/out -------------------------------------------
    @property
    def metrics_sink(self):
        return self._metrics_sink

    @metrics_sink.setter
    def metrics_sink(self, sink) -> None:
        self._metrics_sink = sink
        for eng in self._engines.values():
            if hasattr(eng, "metrics_sink"):
                eng.metrics_sink = sink

    def _pools(self) -> list:
        """Distinct KV pools across the fleet (shared pools once)."""
        seen: dict[int, object] = {}
        for eng in self._engines.values():
            pool = getattr(eng, "_kvpool", None)
            if pool is not None:
                seen[id(pool)] = pool
        return list(seen.values())

    @property
    def kv_cache_bytes(self) -> int:
        """Fleet-wide resident KV bytes: per-engine rings/state plus each
        DISTINCT pool arena once (engines sharing a pool each report the
        arena in their own figure — deduplicate it here)."""
        total = 0
        pool_refs: dict[int, list] = {}
        for eng in self._engines.values():
            total += int(getattr(eng, "kv_cache_bytes", 0) or 0)
            pool = getattr(eng, "_kvpool", None)
            if pool is not None:
                entry = pool_refs.setdefault(id(pool), [pool, 0])
                entry[1] += 1
        for pool, n in pool_refs.values():
            total -= (n - 1) * pool.arena_nbytes
        return total

    #: per-pool descriptive (NON-additive) occupancy fields: summing
    #: them across heterogeneous pools would report nonsense geometry —
    #: the merged document lists them per pool instead
    #: (largest_free_run is a within-arena contiguity fact: runs do not
    #: concatenate across arenas)
    _POOL_DESCRIPTIVE = ("page_tokens", "page_bytes", "largest_free_run")

    def kv_pool_occupancy(self) -> dict | None:
        """Merged pool occupancy + counters for /health and the
        ``kv_pool_pages_*`` gauges: the single shared pool verbatim (the
        common case); when geometry split the fleet across pools, the
        additive fields (page/spill counts, byte totals, event counters)
        are summed and the descriptive ones (page geometry) listed per
        pool under ``per_pool`` (``pools`` says how many)."""
        pools = self._pools()
        if not pools:
            return None
        if len(pools) == 1:
            p = pools[0]
            return {**p.occupancy(), **p.stats(), "pools": 1}
        out: dict = {"pools": len(pools), "per_pool": []}
        for p in pools:
            occ = p.occupancy()
            out["per_pool"].append(
                {k: occ[k] for k in self._POOL_DESCRIPTIVE})
            for k, v in {**occ, **p.stats()}.items():
                if k in self._POOL_DESCRIPTIVE:
                    continue
                if isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
        return out

    def _scheduler_stats(self) -> dict:
        """Per-model scheduler stats flattened under the model name
        (``scheduler_<model>_<stat>`` gauges), plus the fleet-level
        ``adm_budget_tokens``/``lane_idle_seconds`` the HPA scales on
        (summed: total scheduler pressure across co-resident models)."""
        out: dict = {"models": len(self._engines)}
        budget = 0
        idle = 0.0
        for name, eng in self._engines.items():
            stats = eng.scheduler_stats()
            budget += stats.get("adm_budget_tokens", 0)
            idle += stats.get("lane_idle_seconds", 0.0)
            for k, v in stats.items():
                if isinstance(v, dict):        # nested (spec): one level
                    for kk, vv in v.items():
                        out[f"{name}_{k}_{kk}"] = vv
                else:
                    out[f"{name}_{k}"] = v
        out["adm_budget_tokens"] = budget
        out["lane_idle_seconds"] = round(idle, 3)
        return out

"""Env-overridable runtime settings: the ``LFKT_*`` knobs the port reads.

The same names and defaults as the JAX package's registry
(llama_fastapi_k8s_gpu_tpu/utils/config.py), limited to what the pod
reads: its routes, the engines (serial and batched), the watchdog, the
tracer, the disagg and fleet tiers.  The reference's constants (model dir and name,
1024-token context, 25 s timeout, queue of 5) stay the defaults.

The knobs that are no ``Settings`` field (the worker count, the kernel
library's directory, the compile registry, the memory ledger, the incident
recorder, the SLO engine, the profiler and ``spec_decode=auto``'s cost
model) are read with :func:`knob` from the
:data:`KNOBS` table, with the reference's names and defaults — but for
``LFKT_HBM_GBPS``, whose default is the H100's bandwidth, not the v5e's.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Settings:
    model_dir: str = "models"
    model_name: str = "Lexi-Llama-3-8B-Uncensored_Q4_K_M.gguf"
    # -- multi-model serving (serving/manifest.py, serving/registry.py) ---
    # the model manifest: name=path[:knob=value;...] entries, comma-
    # separated.  Empty (the default) keeps the single-model
    # LFKT_MODEL_DIR/LFKT_MODEL_NAME path
    models: str = ""
    # the alias served when a request names no model= (default: the
    # manifest's first entry)
    default_model: str = ""
    # budget for the fleet's weights on the card, in MB (0 = unlimited):
    # the registry refuses at load time, naming each model's bytes
    hbm_weight_budget_mb: float = 0.0
    max_context_tokens: int = 1024
    timeout_seconds: float = 25.0
    max_queue_size: int = 5
    # total wall-clock bound of one streamed response (the per-chunk gap
    # is timeout_seconds)
    stream_deadline_seconds: float = 300.0
    # graceful-shutdown budget and slowloris guard of the in-tree httpd
    drain_seconds: float = 30.0
    read_timeout: float = 30.0
    # the engine watchdog (engine/watchdog.py): a stall (no beat for
    # watchdog_stall_seconds with a generation in flight) or a burst of
    # watchdog_error_burst engine errors in watchdog_error_window seconds
    # trips it to DEGRADED; it recovers with exponential backoff, or goes
    # DEAD after watchdog_max_recoveries trips
    watchdog: bool = True
    watchdog_stall_seconds: float = 60.0
    watchdog_poll_seconds: float = 1.0
    watchdog_max_recoveries: int = 3
    watchdog_error_burst: int = 5
    watchdog_error_window: float = 30.0
    watchdog_backoff_seconds: float = 1.0
    watchdog_backoff_max: float = 60.0
    # request traces (obs/trace.py): the fraction traced (0 disarms) and
    # the completed traces kept for /debug/traces; JSON log lines with
    # request ids (server/__main__.py)
    trace_sample: float = 1.0
    trace_ring: int = 256
    json_logs: bool = True
    # the sampling parameters the reference passes on every request
    temperature: float = 1.2
    top_p: float = 0.9
    frequency_penalty: float = 0.7
    presence_penalty: float = 0.8
    max_gen_tokens: int = 512
    decode_chunk: int = 8              # decode steps per host read
    prefill_buckets: str = "128,256,512,1024"
    weight_format: str = "auto"        # auto | bf16 | int8 | q4k
    attn_impl: str = "auto"            # auto | xla | pallas (= flash) (prompt passes)
    kv_dtype: str = "bf16"             # bf16 | int8 KV cache
    # layers per launch of the layer-looped decode kernel: 0 off, -1 all
    decode_layer_unroll: int = 0
    # prompt-lookup speculation (engine/engine.py, engine/spec_auto.py):
    # off | lookup | auto — auto measures the pod's dispatch round trip at
    # startup and takes lookup iff its breakeven acceptance is under
    # LFKT_SPEC_AUTO_ACCEPT
    spec_decode: str = "off"
    spec_draft: int = 8                # draft tokens per verify step
    prefix_cache: bool = True          # reuse the previous request's KV prefix
    prefill_chunk: int = 256           # prompt slice size for large buckets
    #                                    (and the continuous scheduler's
    #                                    admission slices)
    # the continuous scheduler's lane-prefix reuse: an admission whose
    # prompt shares a freed lane's conversation snapshots that lane's ring
    # and prefills only the suffix slices (explicit seeds bypass it)
    lane_prefix_cache: bool = True
    # the block-paged KV pool and its radix prefix cache (parallel/
    # kvpool.py): shared system prompts prefill once per process and
    # multi-turn requests resume from their last committed page on any
    # lane.  Off by default: the dense ring stays the A/B control
    kv_paged: bool = False
    kv_page_tokens: int = 128          # token slots per pool page
    kv_pool_pages: int = 0             # arena size in pages (0 = auto: four
    #                                    full contexts' worth)
    kv_spill_pages: int = 0            # host spill tier in pages (0 = off:
    #                                    evictions discard)
    # admission prefill tokens a scheduler wave: the static budget with the
    # controller off, its base with it on
    adm_budget: int = 512
    # the admission controller (engine/continuous.py AdmissionController):
    # each wave's budget from EMAs of the lane-idle fraction and the decode
    # pressure, floored at one slice
    adm_controller: bool = True
    adm_ema_alpha: float = 0.25        # EMA weight of the controller's signals
    # > 1 serves batched lanes of one card; scheduler picks the flavour:
    #   cycle      — MeshEngine: coalesce up to batch_size queued requests a
    #                generation cycle
    #   continuous — ContinuousEngine: free lanes admit new requests at
    #                every chunk boundary
    batch_size: int = 1
    scheduler: str = "continuous"
    # the mesh (parallel/mesh.py), over the pod's cards (too few raise):
    # mesh_tp shards the lane engines' weights, heads and KV ring over tp
    # devices (batch_size > 1; dp takes the cards left over); mesh_sp > 1
    # serves SPEngine, the ring's slots over sp devices with ring attention
    # (mesh_tp its heads inside the ring; batch_size must be 1)
    mesh_tp: int = 1
    mesh_sp: int = 1
    # -- disaggregated prefill/decode (serving/disagg/) ---------------------
    # this process's role: off (the single-process path), prefill (the KV
    # page service), decode (prompts hop to LFKT_DISAGG_PEER, whose pages
    # import into this pod's paged arena) or both (service and client on
    # one engine over loopback).  Any role but off needs LFKT_KV_PAGED=1
    disagg_role: str = "off"
    disagg_peer: str = ""              # decode: the page service, host:port
    disagg_bind: str = "0.0.0.0"       # prefill: the service's bind address
    disagg_port: int = 8470            # prefill: its port (0 = ephemeral)
    # one hop's wire budget: a remote prefill that cannot finish within
    # min(this, the request's remaining deadline) degrades to local prefill
    disagg_timeout_seconds: float = 5.0
    # frames queued a peer connection before the page export blocks (the
    # queued bytes are the memory ledger's disagg_txbuf component)
    disagg_queue_frames: int = 32
    # -- the fleet tier (serving/fleet/) ------------------------------------
    # "router" turns this process into the prefix-affinity proxy in front of
    # the replicas (no engine, no torch); "off" is a serving replica
    fleet_role: str = "off"
    fleet_peers: str = ""              # router: static replicas, host:port,...
    # router: headless-Service DNS name:port, re-resolved every probe cycle
    fleet_dns: str = ""
    fleet_policy: str = "affinity"     # router placement: affinity | roundrobin
    fleet_probe_seconds: float = 2.0   # router: /health/ready probe period
    # router: first ejection backoff (doubles per consecutive failure), cap
    fleet_eject_backoff_seconds: float = 1.0
    fleet_eject_backoff_max: float = 30.0
    # router: backend connect + response-head deadline (the body rides
    # stream_deadline_seconds)
    fleet_proxy_timeout_seconds: float = 5.0
    # router: replicas tried past the owner before a 503 + Retry-After
    fleet_max_spills: int = 3
    # -- warm KV-page migration (serving/fleet/migrate.py) -------------------
    # the page service, pull-on-remap, SIGTERM drain push and scale-out
    # warm-up on this replica (requires LFKT_KV_PAGED=1)
    migrate: bool = False
    migrate_bind: str = "0.0.0.0"      # the page service's bind address
    # its port (0 = ephemeral; peers find the bound port in /health)
    migrate_port: int = 8471
    # this replica's own fleet address host:port (excluded from the drain
    # successors and the warm-up sources)
    migrate_self: str = ""
    # one wire hop's budget, also clipped to the request's deadline
    migrate_timeout_seconds: float = 2.0
    migrate_top_k: int = 8             # hottest prefixes a warm-up / drain moves
    # the drain push's total budget before termination proceeds
    migrate_drain_seconds: float = 5.0
    # router: a peer (re)admitted within this window is "fresh" and requests
    # it owns carry a prior-owner stamp (0 disables)
    migrate_fresh_seconds: float = 600.0
    # live manifest reload (POST /admin/models/reload, SIGHUP): the bounded
    # wait for a removed model's in-flight requests and pinned pages
    reload_drain_seconds: float = 30.0
    host: str = "0.0.0.0"
    port: int = 8000

    @property
    def model_path(self) -> str:
        return os.path.join(self.model_dir, self.model_name)

    @property
    def prefill_bucket_list(self) -> list[int]:
        return sorted(int(x) for x in self.prefill_buckets.split(",") if x.strip())


def _env(name: str, default, cast):  # lfkt: noqa[GRAPH001] -- reached from captured code only through the kernel library's first load: capture_step's eager warm-up step runs the captured callable first, so a capture finds the library cached (ops/_kernels.library) and never reaches this
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return cast(raw)


def get_settings() -> Settings:
    """Settings with every field overridden by ``LFKT_<FIELD>`` when set."""
    kw = {}
    for f in dataclasses.fields(Settings):
        kw[f.name] = _env(f"LFKT_{f.name.upper()}", f.default, type(f.default))
    return Settings(**kw)


@dataclasses.dataclass(frozen=True)
class Knob:
    """One env knob read outside ``Settings``, with its default.
    ``serving=True`` marks a knob a deployment sets per pod (the GPU
    chart, ``helm-gpu/``, names it), as in the reference's registry."""

    name: str
    cast: type
    default: object
    help: str = ""
    serving: bool = False


#: the ad-hoc knobs: the worker count the server refuses to raise, the
#: kernel library's directory and the observability layer's (the
#: reference's utils/config.py table, its defaults)
KNOBS: dict[str, Knob] = {k.name: k for k in (
    Knob("LFKT_WORKERS", int, 1,
         "must stay 1: one model per process (server/__main__.py refuses "
         "any other value)"),
    Knob("LFKT_COMPILE_CACHE_DIR", str, "",
         "where the kernel library is built and found "
         "(utils/kernelcache.py): <dir>/lfkt-kernels/<digest>/; empty = "
         "the package's _build/", serving=True),
    Knob("LFKT_PROFILE_DIR", str, "",
         "torch.profiler traces per generation (utils/tracing.py) and via "
         "GET /debug/profile; empty = off"),
    Knob("LFKT_DEVTIME", bool, True,
         "graph-capture and dispatch attribution (obs/devtime.py; 0 disarms)"),
    Knob("LFKT_RECOMPILE_BUDGET", int, 32,
         "distinct signatures per program before a recompile storm is flagged"),
    Knob("LFKT_SLO_TTFT_P95_S", float, 1.0,
         "SLO: TTFT bound (seconds) 95% of requests must beat, per prefill bucket"),
    Knob("LFKT_SLO_DECODE_FLOOR_TPS", float, 10.0,
         "SLO: decode tok/s floor 95% of requests must clear"),
    Knob("LFKT_SLO_ERROR_RATE", float, 0.01,
         "SLO: 5xx error-rate budget over each burn window"),
    Knob("LFKT_SLO_QUEUE_P95_S", float, 0.5,
         "SLO: admission-queue wait bound (seconds) at the 95th percentile"),
    Knob("LFKT_SLO_WINDOWS", str, "300,3600",
         "SLO burn-rate windows, csv seconds (short,long)"),
    Knob("LFKT_MEM_LEDGER", bool, True,
         "device memory ledger: /debug/memory and the hbm_bytes gauges (0 disarms)"),
    Knob("LFKT_MEM_PRESSURE_FRACTION", float, 0.05,
         "device headroom fraction below which memory counts as pressure"),
    Knob("LFKT_INCIDENT_DIR", str, "",
         "incident flight-recorder directory (empty = recorder off)"),
    Knob("LFKT_INCIDENT_RING", int, 16,
         "incident bundles kept on disk (oldest pruned)"),
    Knob("LFKT_INCIDENT_DEBOUNCE_S", float, 30.0,
         "per-kind minimum seconds between incident bundles"),
    Knob("LFKT_INCIDENT_LOG_LINES", int, 100,
         "structured log lines kept for a bundle's log_tail"),
    Knob("LFKT_HBM_GBPS", float, 3350.0,
         "assumed device memory bandwidth (GB/s) for spec_decode=auto's "
         "breakeven; the default is the H100 SXM's published 3.35 TB/s"),
    Knob("LFKT_SPEC_AUTO_ACCEPT", float, 1.0,
         "assumed lookup acceptance for spec_decode=auto"),
)}


def knob(name: str):  # lfkt: noqa[GRAPH001] -- reached from captured code only through the kernel library's first load: capture_step's eager warm-up step runs the captured callable first, so a capture finds the library cached (ops/_kernels.library) and never reaches this
    """The value of registered knob ``name``: its env var, else its
    default.  An unregistered name raises ``KeyError``."""
    k = KNOBS[name]
    return _env(name, k.default, k.cast)

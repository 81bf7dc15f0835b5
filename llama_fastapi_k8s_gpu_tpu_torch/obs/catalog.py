"""The metric catalog — every series ``/metrics`` may expose, declared once.

The families of the JAX package's catalog
(llama_fastapi_k8s_gpu_tpu/obs/catalog.py) that the serial pod emits, each
with the reference's name, type, help text, labels and buckets.  Recording
a name that is not here raises ``KeyError`` (utils/metrics.py).  The
``xla_*`` and ``jit_*`` names stay the reference's (dashboards and the
chart's alerts key on them): in the port a "compile" is a CUDA-graph
capture or the kernel library's build, and a "jit dispatch" a call of a
host program or a kernel's launch (obs/devtime.py).

:data:`MEM_COMPONENTS` is the memory ledger's catalog of the allocation
surfaces the pod registers (obs/memledger.py).

Families whose members are synthesized at runtime (the continuous
scheduler's ``scheduler_stats()`` keys) declare a *prefix family*: one
entry, ``prefix=True``, that governs every name starting with it.
"""

from __future__ import annotations

import dataclasses

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

#: default latency buckets (seconds): tuned for a serving path whose TTFT
#: sits in the 0.05-1 s band and whose tail is the 25 s admission timeout
LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 25.0, 60.0)
#: requests per batched cycle
OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
#: decode throughput buckets (tokens/sec)
RATE_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0)
#: token-count buckets (prefix reuse lengths: one page up to a 32k prompt)
TOKEN_BUCKETS = (64.0, 128.0, 256.0, 512.0, 1024.0, 2048.0, 4096.0,
                 8192.0, 16384.0, 32768.0)
#: compile-wall buckets (seconds)
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0)


@dataclasses.dataclass(frozen=True)
class Metric:
    """One registered metric family.  ``labels`` names the allowed label
    keys (order is the render order)."""

    name: str
    mtype: str = COUNTER
    help: str = ""
    buckets: tuple = ()
    labels: tuple = ()
    prefix: bool = False


def _register(*metrics: Metric) -> dict[str, Metric]:
    out: dict[str, Metric] = {}
    for m in metrics:
        if m.mtype == HISTOGRAM and not m.buckets:
            raise ValueError(f"histogram {m.name} needs explicit buckets")
        out[m.name] = m
    return out


METRICS: dict[str, Metric] = _register(
    # -- request path (server/app.py) --------------------------------------
    Metric("http_requests_total", COUNTER,
           "requests served, by route and status code",
           labels=("route", "code")),
    Metric("request_seconds", HISTOGRAM,
           "end-to-end request latency, by route",
           buckets=LATENCY_BUCKETS, labels=("route",)),
    Metric("queue_wait_seconds", HISTOGRAM,
           "admission-queue wait (enqueue -> consumer pickup)",
           buckets=LATENCY_BUCKETS),
    Metric("generation_seconds", HISTOGRAM,
           "engine generation wall time (prefill + decode), by model",
           buckets=LATENCY_BUCKETS, labels=("model",)),
    Metric("queue_depth", GAUGE, "admission queue occupancy"),
    Metric("requests_rejected_total", COUNTER,
           "503s from the bounded admission queue"),
    Metric("requests_timed_out_total", COUNTER,
           "408s (admission timeout / stream deadline)"),
    # -- engine phase timings ----------------------------------------------
    Metric("engine_ttft_seconds", HISTOGRAM,
           "time to first token (prefill + first sample), by prefill "
           "bucket and model — the SLO engine evaluates each label "
           "series separately, so burn rates report the worst "
           "bucket+model (docs/SLO.md)",
           buckets=LATENCY_BUCKETS, labels=("bucket", "model")),
    Metric("engine_decode_tokens_per_sec", HISTOGRAM,
           "per-request decode throughput, by model",
           buckets=RATE_BUCKETS, labels=("model",)),
    Metric("generated_tokens_total", COUNTER, "completion tokens emitted"),
    Metric("batched_generations_total", COUNTER,
           "mesh-batched generation cycles"),
    Metric("streamed_generations_total", COUNTER, "SSE streams served"),
    Metric("batch_occupancy", HISTOGRAM,
           "requests coalesced per batched cycle",
           buckets=OCCUPANCY_BUCKETS),
    # -- speculative decoding / prefix reuse -------------------------------
    Metric("spec_drafted_tokens_total", COUNTER,
           "speculative tokens drafted"),
    Metric("spec_accepted_tokens_total", COUNTER,
           "speculative tokens accepted"),
    Metric("spec_verify_steps_total", COUNTER, "speculative verify steps"),
    Metric("spec_fallback_steps_total", COUNTER,
           "plain decode steps taken on lookup miss"),
    Metric("prefix_cache_hits_total", COUNTER,
           "requests served with prompt-prefix KV reuse"),
    Metric("prefix_cache_reused_tokens_total", COUNTER,
           "prompt tokens NOT re-prefilled thanks to prefix reuse"),
    # -- block-paged KV pool + radix prefix cache (parallel/kvpool.py) -----
    Metric("prefix_cache_misses_total", COUNTER,
           "requests that consulted the radix prefix index and took a "
           "full prefill (no usable cached prefix)"),
    Metric("prefix_cache_evictions_total", COUNTER,
           "KV pool nodes evicted (LRU, unpinned) to free pages"),
    Metric("prefix_cache_spills_total", COUNTER,
           "evicted KV nodes DMA'd to the host-RAM spill tier"),
    Metric("prefix_cache_restores_total", COUNTER,
           "spilled KV nodes restored to HBM on a prefix hit"),
    Metric("prefix_reuse_tokens", HISTOGRAM,
           "per-hit prompt tokens served from cached KV pages",
           buckets=TOKEN_BUCKETS),
    Metric("kv_pool_pages_used", GAUGE,
           "KV pool pages holding indexed cache content"),
    Metric("kv_pool_pages_free", GAUGE, "KV pool pages on the free list"),
    # -- disaggregated prefill/decode (serving/disagg/) --------------------
    Metric("disagg_prefills_served_total", COUNTER,
           "prefill tier: remote prefill requests answered with pages"),
    Metric("disagg_pages_sent_total", COUNTER,
           "prefill tier: KV pages streamed to decode replicas"),
    Metric("disagg_bytes_sent_total", COUNTER,
           "prefill tier: page payload bytes put on the wire"),
    Metric("disagg_remote_prefills_total", COUNTER,
           "decode replica: admissions whose prefix was imported from "
           "the prefill tier (pages restored instead of local prefill)"),
    Metric("disagg_pages_received_total", COUNTER,
           "decode replica: KV pages received from the prefill tier"),
    Metric("disagg_bytes_received_total", COUNTER,
           "decode replica: page payload bytes received"),
    Metric("disagg_local_fallbacks_total", COUNTER,
           "decode replica: remote prefills degraded to LOCAL prefill, "
           "by reason (peer_dead, peer_unreachable, refused, import, "
           "prefill, ...) — nonzero = the split fleet is not splitting",
           labels=("reason",)),
    Metric("disagg_handshake_refusals_total", COUNTER,
           "page-wire handshakes refused (schema/geometry mismatch — "
           "a mis-deployed tier pair, docs/RUNBOOK.md)"),
    Metric("disagg_transfer_seconds", HISTOGRAM,
           "decode replica: one remote-prefill hop's wall (request -> "
           "pages imported)",
           buckets=LATENCY_BUCKETS),
    Metric("disagg_peer_connected", GAUGE,
           "decode replica: 1 while the prefill peer connection is up"),
    # -- fleet tier: the prefix-affinity router (serving/fleet/) -----------
    Metric("fleet_requests_total", COUNTER,
           "router: requests proxied, by serving replica and affinity-"
           "key source (header | conversation | prefix | opaque)",
           labels=("peer", "source")),
    Metric("fleet_spills_total", COUNTER,
           "router: requests NOT served by their rendezvous owner, by "
           "reason (ejected = retried onto the next peer, spilled = "
           "served off-owner, mid_stream_abort = peer died after bytes "
           "reached the client, no_replica = whole fleet down -> 503); "
           "sustained nonzero = conversations are running cold",
           labels=("reason",)),
    Metric("fleet_peer_ejections_total", COUNTER,
           "router: replica ejections (probe failure or proxied-request "
           "failure), by peer — the /health peers block names the reason",
           labels=("peer",)),
    Metric("fleet_peers_healthy", GAUGE,
           "router: replicas currently accepting traffic"),
    Metric("fleet_proxy_seconds", HISTOGRAM,
           "router: one proxied request's wall (client head in -> "
           "backend response relayed)",
           buckets=LATENCY_BUCKETS),
    Metric("fleet_probe_seconds", HISTOGRAM,
           "router: one health-probe round trip per replica, success or "
           "failure — the ejection-threshold tuning signal (a peer whose "
           "probes crawl toward the timeout is about to be ejected)",
           buckets=LATENCY_BUCKETS, labels=("peer",)),
    # -- fleet KV migration (serving/fleet/migrate.py) ---------------------
    Metric("kv_migration_pulls_total", COUNTER,
           "migration pulls attempted, by trigger (remap = router "
           "prior-owner hint, warmup = scale-out pre-pull, drain = "
           "commanded pull from a DRAINING peer)",
           labels=("reason",)),
    Metric("kv_migration_pushes_total", COUNTER,
           "migration page service: pull requests answered with pages "
           "(this pod was the warm side)"),
    Metric("kv_migration_pages_total", COUNTER,
           "KV pages moved by migration, by direction (pulled | pushed)",
           labels=("reason",)),
    Metric("kv_migration_failures_total", COUNTER,
           "migration attempts degraded, by reason (connect, wire, "
           "refused, deadline, import, drain_push, ...) — every one "
           "fell back to local recompute or plain termination, with "
           "this attribution",
           labels=("reason",)),
    Metric("kv_migration_seconds", HISTOGRAM,
           "one migration hop's wall (request -> pages imported)",
           buckets=LATENCY_BUCKETS),
    # -- live manifest reload (serving/registry.py reload_manifest) --------
    Metric("model_reloads_total", COUNTER,
           "live-reload actions on the model registry (add = model "
           "loaded+warmed in place, remove = namespace drained + weights "
           "released, refused = budget/fit/grammar refusal with the "
           "running set untouched)",
           labels=("action",)),
    # -- prefill pipeline ----------------------------------------------------
    Metric("prefill_slice_seconds", HISTOGRAM,
           "host wall of one prefill-slice dispatch (prep + enqueue; "
           "long = device-queue pushback)",
           buckets=LATENCY_BUCKETS),
    Metric("admission_budget_tokens", GAUGE,
           "admission controller's live per-wave prefill-token budget"),
    Metric("lane_idle_seconds", GAUGE,
           "cumulative idle lane-seconds while other lanes decoded "
           "(monotonic; the admission controller's raw loss signal)"),
    # -- resilience / error taxonomy ---------------------------------------
    Metric("engine_unavailable_total", COUNTER,
           "503s from watchdog trips / recovery in progress"),
    Metric("engine_errors_total", COUNTER, "engine-side request failures"),
    Metric("watchdog_trips_total", COUNTER, "watchdog trip count"),
    Metric("watchdog_recoveries_total", COUNTER,
           "successful watchdog recoveries"),
    Metric("watchdog_escalations_total", COUNTER,
           "recovery budget exhaustions (DEAD)"),
    Metric("health_state", GAUGE,
           "pod health state code (0=STARTING 1=READY 2=DEGRADED "
           "3=DRAINING 4=DEAD)"),
    Metric("engine_inflight", GAUGE, "engine busy count (heartbeat)"),
    Metric("engine_error_count", GAUGE, "heartbeat errors_total"),
    # -- capacity ----------------------------------------------------------
    Metric("kv_cache_bytes", GAUGE, "resident KV-cache HBM bytes"),
    # -- the device memory ledger (obs/memledger.py) -----------------------
    Metric("hbm_bytes", GAUGE,
           "live HBM bytes per memory-ledger component and model "
           "(component=residual carries bytes the ledger cannot "
           "attribute vs device ground truth; docs/OBSERVABILITY.md "
           "memory-ledger section)",
           labels=("component", "model")),
    Metric("hbm_headroom_bytes", GAUGE,
           "free device HBM (bytes_limit - bytes_in_use); only exported "
           "where the backend reports memory_stats"),
    Metric("mem_pressure_events_total", COUNTER,
           "admission-controller budget cuts triggered by low HBM "
           "headroom (rising edges, not waves — docs/RUNBOOK.md "
           "'Diagnosing HBM OOM')"),
    # -- the incident flight recorder (obs/flightrec.py) -------------------
    Metric("incidents_total", GAUGE,
           "incident bundles recorded by the flight recorder this "
           "process (snapshot; bundles live in LFKT_INCIDENT_DIR)"),
    # -- token metering ------------------------------------------------------
    Metric("tokens_prompt_total", COUNTER,
           "prompt tokens ingested, by model (from the engines' own "
           "usage counts — metering without scraping /v1 responses)",
           labels=("model",)),
    Metric("tokens_generated_total", COUNTER,
           "completion tokens emitted, by model (from the engines' own "
           "usage counts)",
           labels=("model",)),
    Metric("models_loaded", GAUGE,
           "models served by this process (manifest rows, or 1)"),
    Metric("model_weight_bytes", GAUGE,
           "resident weight HBM bytes per served model (the registry's "
           "LFKT_HBM_WEIGHT_BUDGET_MB accounting unit)",
           labels=("model",)),
    # -- tracer self-telemetry (obs/trace.py) ------------------------------
    Metric("trace_ring_used", GAUGE, "completed traces held in the ring"),
    Metric("traces_started_total", GAUGE, "requests that drew a trace"),
    Metric("traces_sampled_out_total", GAUGE,
           "requests skipped by LFKT_TRACE_SAMPLE"),
    # -- capture and dispatch attribution (obs/devtime.py): the registry
    # owns the counts, /metrics copies them as snapshots --------------------
    Metric("xla_compiles_total", GAUGE,
           "jit compile events per program (devtime snapshot)",
           labels=("program",)),
    Metric("jit_dispatches_total", GAUGE,
           "host dispatches per jit program (devtime snapshot)",
           labels=("program",)),
    Metric("xla_recompile_storms_total", GAUGE,
           "signatures minted past LFKT_RECOMPILE_BUDGET "
           "(devtime snapshot; docs/RUNBOOK.md recompile-storm runbook)"),
    Metric("xla_compile_seconds", HISTOGRAM,
           "wall time of jit compile events, by program (first-dispatch "
           "wall; replayed from the devtime event ring at scrape time)",
           buckets=COMPILE_BUCKETS, labels=("program",)),
    Metric("xla_compile_events_dropped_total", GAUGE,
           "compile events evicted from the ring before replay — nonzero "
           "means xla_compile_seconds undercounts vs xla_compiles_total "
           "(a storm outran the scrape cadence)"),
    # -- the SLO engine (obs/slo.py) ----------------------------------------
    Metric("slo_burn_rate", GAUGE,
           "error-budget burn rate per SLO and window (1.0 = burning "
           "exactly the budget; sustained >1 on every window = breach); "
           "scope=pod on replica scrapes, scope=fleet when the router "
           "evaluates the catalog over federated histograms",
           labels=("slo", "window", "scope")),
    # -- runtime-synthesized families --------------------------------------
    Metric("scheduler_", GAUGE,
           "continuous-scheduler occupancy family "
           "(ContinuousEngine.scheduler_stats: lanes_live, pending, "
           "admission_inflight, spec_*, lane_prefix_* / radix_prefix_*)",
           prefix=True),
)


@dataclasses.dataclass(frozen=True)
class MemComponent:
    """One memory-ledger component: an allocation surface that reports
    live bytes into ``hbm_bytes{component,model}``.  ``device=False``
    marks a host tier (listed, not reconciled); ``always=True`` keeps a
    zero row instead of dropping it."""

    name: str
    help: str = ""
    device: bool = True
    always: bool = False


#: the components the pod registers, with the reference's help;
#: ``residual`` is computed (ground truth minus the attributed device
#: components), never registered.  The decode graphs' private pool and
#: cuBLAS's workspace are not components: they land in ``residual``.
MEM_COMPONENTS: dict[str, MemComponent] = {
    c.name: c for c in (
        MemComponent("weights",
                     "per-model resident weight bytes (Engine.weight_bytes"
                     " — the registry's HBM budget unit)"),
        MemComponent("kv_ring",
                     "serial dense KV ring (Engine._cache; allocated on "
                     "every engine, serving or not)"),
        MemComponent("kv_lanes",
                     "batched lane state: the mesh/continuous engines' "
                     "shared decode pytree (parallel/batched.py)"),
        MemComponent("kv_scratch",
                     "the continuous scheduler's persistent prefill "
                     "scratch ring (engine/continuous.py)"),
        MemComponent("kv_arena_used",
                     "KV pool arena pages holding indexed cache content, "
                     "per radix namespace (model); model=(unindexed) is "
                     "allocated-but-uncommitted in-flight pages"),
        MemComponent("kv_arena_free",
                     "KV pool arena pages on the free list (allocated "
                     "HBM, no content); reported even at 0 — exhaustion "
                     "is the alert", always=True),
        MemComponent("host_spill",
                     "host-RAM KV spill tier (LFKT_KV_SPILL_PAGES)",
                     device=False),
        MemComponent("disagg_txbuf",
                     "disagg page-wire send queues: host bytes buffered "
                     "between page export and the socket (bounded by "
                     "LFKT_DISAGG_QUEUE_FRAMES x peers — "
                     "serving/disagg/transport.py)",
                     device=False),
        MemComponent("residual",
                     "ground truth minus every attributed device "
                     "component: bytes the ledger cannot explain "
                     "(computed, never registered)"),
    )
}


def lookup(name: str) -> Metric | None:
    """The catalog entry governing ``name``: exact match first, then the
    longest matching declared prefix family."""
    m = METRICS.get(name)
    if m is not None:
        return m
    best = None
    for entry in METRICS.values():
        if entry.prefix and name.startswith(entry.name):
            if best is None or len(entry.name) > len(best.name):
                best = entry
    return best

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
surfaces the serial pod registers (obs/memledger.py).
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
#: decode throughput buckets (tokens/sec)
RATE_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0)
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
    Metric("streamed_generations_total", COUNTER, "SSE streams served"),
    # -- prefix reuse --------------------------------------------------------
    Metric("prefix_cache_hits_total", COUNTER,
           "requests served with prompt-prefix KV reuse"),
    Metric("prefix_cache_reused_tokens_total", COUNTER,
           "prompt tokens NOT re-prefilled thanks to prefix reuse"),
    # -- prefill pipeline ----------------------------------------------------
    Metric("prefill_slice_seconds", HISTOGRAM,
           "host wall of one prefill-slice dispatch (prep + enqueue; "
           "long = device-queue pushback)",
           buckets=LATENCY_BUCKETS),
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


#: the components the serial pod registers, with the reference's help;
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
        MemComponent("residual",
                     "ground truth minus every attributed device "
                     "component: bytes the ledger cannot explain "
                     "(computed, never registered)"),
    )
}


def lookup(name: str) -> Metric | None:
    """The catalog entry for ``name``, or None."""
    return METRICS.get(name)

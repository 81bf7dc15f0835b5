"""Env-overridable runtime settings: the ``LFKT_*`` knobs the port reads.

The same names and defaults as the JAX package's registry
(llama_fastapi_k8s_gpu_tpu/utils/config.py), limited to what the serial
pod reads: its routes, the engine, the watchdog and the tracer.  The reference's constants (model dir and name,
1024-token context, 25 s timeout, queue of 5) stay the defaults.

The observability knobs that are no ``Settings`` field (the compile
registry, the memory ledger, the incident recorder, the SLO engine and
the profiler) are read with :func:`knob` from the :data:`KNOBS` table,
with the reference's names and defaults.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Settings:
    model_dir: str = "models"
    model_name: str = "Lexi-Llama-3-8B-Uncensored_Q4_K_M.gguf"
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
    prefix_cache: bool = True          # reuse the previous request's KV prefix
    prefill_chunk: int = 256           # prompt slice size for large buckets
    host: str = "0.0.0.0"
    port: int = 8000

    @property
    def model_path(self) -> str:
        return os.path.join(self.model_dir, self.model_name)

    @property
    def prefill_bucket_list(self) -> list[int]:
        return sorted(int(x) for x in self.prefill_buckets.split(",") if x.strip())


def _env(name: str, default, cast):
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
    """One env knob read outside ``Settings``, with its default."""

    name: str
    cast: type
    default: object
    help: str = ""


#: the ad-hoc knobs of the observability layer (the reference's
#: utils/config.py table, its defaults)
KNOBS: dict[str, Knob] = {k.name: k for k in (
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
)}


def knob(name: str):
    """The value of registered knob ``name``: its env var, else its
    default.  An unregistered name raises ``KeyError``."""
    k = KNOBS[name]
    return _env(name, k.default, k.cast)

"""Declarative SLOs evaluated as multi-window burn rates.

The JAX package's SLO engine (llama_fastapi_k8s_gpu_tpu/obs/slo.py).
Each :class:`SLO` names one cataloged family, a threshold (an
``LFKT_SLO_*`` knob, utils/config.py) and an objective (the fraction of
events that must be good).  Evaluation is the multi-window burn-rate
recipe:

- every consultation (each ``/metrics`` scrape and ``/debug/slo`` hit)
  snapshots the app's metrics registry (``Metrics.snapshot``), keeping a
  bounded history;
- for every window (``LFKT_SLO_WINDOWS``, default 5 min and 1 h) the
  current snapshot is diffed against the one at the window's start: the
  histogram buckets are cumulative, so the delta is an exact count;
- ``burn = bad_fraction / error_budget``, the budget being ``1 -
  objective`` (latency and floor SLOs) or the error-rate threshold itself
  (ratio SLOs).  Burning ≥ 1 on every window is a breach, on only some a
  warning.  A window truncated to the process's age (a fresh pod) can
  warn but never confirm a breach: it holds the same evidence as the
  short one, and its job is to prove the burn lasted.

Per-label families are evaluated per series and report the worst.  The
verdict also folds in the recompile-storm state of obs/devtime.py, and a
confirmed breach records an ``slo_breach`` incident (obs/flightrec.py)
once per episode.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from . import flightrec as _flightrec
from .catalog import lookup
from .devtime import DEVTIME

#: snapshot history bound (a 15 s scrape cadence over the default 1 h long
#: window needs 240; headroom for /debug/slo polls in between)
MAX_SNAPSHOTS = 1024

LATENCY = "latency"     # histogram of seconds; good = obs <= threshold
FLOOR = "floor"         # histogram of a rate;  good = obs >= threshold
RATIO = "ratio"         # labeled counter;      bad/total <= threshold


@dataclasses.dataclass(frozen=True)
class SLO:
    """One service-level objective over a cataloged metric family."""

    name: str
    metric: str                 # a catalog family
    kind: str                   # LATENCY | FLOOR | RATIO
    threshold_knob: str         # LFKT_SLO_* knob carrying the threshold
    #                             (single source of truth for the default:
    #                             the Knob table in utils/config.py)
    objective: float = 0.95     # good-event fraction (latency/floor only)
    help: str = ""
    #: RATIO only: name of the label whose value classifies an event as
    #: bad when it starts with ``bad_prefix``
    bad_label: str = ""
    bad_prefix: str = ""
    #: RATIO only: series whose ``route`` label starts with one of these
    #: are self-monitoring traffic (scrapes, probes, debug) — excluded so
    #: a quiet pod's guaranteed-200 probe stream cannot dilute the
    #: user-facing error ratio below its budget
    exclude_routes: tuple = ()


#: THE SLO catalog (the reference's).  Thresholds are deploy-time knobs;
#: objectives are part of the promise itself.
SLOS: tuple[SLO, ...] = (
    SLO("ttft_p95", metric="engine_ttft_seconds", kind=LATENCY,
        threshold_knob="LFKT_SLO_TTFT_P95_S", objective=0.95,
        help="95% of requests see their first token within the bound, "
             "evaluated per prefill bucket and model (worst "
             "bucket+model series reported)"),
    SLO("decode_floor", metric="engine_decode_tokens_per_sec", kind=FLOOR,
        threshold_knob="LFKT_SLO_DECODE_FLOOR_TPS", objective=0.95,
        help="95% of requests decode at or above the floor, per model "
             "(worst model reported)"),
    SLO("error_rate", metric="http_requests_total", kind=RATIO,
        threshold_knob="LFKT_SLO_ERROR_RATE",
        bad_label="code", bad_prefix="5",
        exclude_routes=("/metrics", "/health", "/debug"),
        help="5xx responses stay under the budget fraction of all "
             "user-facing requests (scrape/probe/debug routes excluded)"),
    SLO("queue_p95", metric="queue_wait_seconds", kind=LATENCY,
        threshold_knob="LFKT_SLO_QUEUE_P95_S", objective=0.95,
        help="95% of admissions leave the queue within the bound"),
)


def _n_at_or_below(bounds, bucket_deltas, count_delta, threshold) -> float:
    """Estimated observations <= ``threshold`` in a windowed histogram
    delta — cumulative up to the containing bucket, linearly interpolated
    inside it (the same convention as the derived quantile gauges in
    utils/metrics.py, so a threshold equal to a bucket bound is exact)."""
    if count_delta <= 0:
        return 0.0
    cum = 0.0
    lo = 0.0
    for i, hi in enumerate(bounds):
        n = bucket_deltas[i]
        if threshold < hi:
            if n <= 0 or hi <= lo:
                return cum
            frac = max(0.0, min(1.0, (threshold - lo) / (hi - lo)))
            return cum + n * frac
        cum += n
        lo = hi
    return float(count_delta)       # threshold >= the largest finite bound


class SLOEngine:
    """Burn-rate evaluator bound to one Metrics registry (per app)."""

    # snapshots are appended by whichever thread scrapes or evaluates;
    # the breach-episode latch is one bool shared with the short-lived
    # incident-record worker (a racing rollback costs at most one extra
    # record attempt, which the recorder's debounce absorbs)

    def __init__(self, metrics, windows=None, thresholds: dict | None = None,
                 devtime=None, scope: str = "pod"):
        from ..utils.config import knob

        self._metrics = metrics
        #: the slo_burn_rate gauge's scope label ("pod": this replica's
        #: own registry)
        self.scope = str(scope)
        self._devtime = devtime if devtime is not None else DEVTIME
        if windows is None:
            raw = str(knob("LFKT_SLO_WINDOWS"))
            windows = [float(w) for w in raw.split(",") if w.strip()]
        self.windows = sorted(float(w) for w in windows) or [300.0, 3600.0]
        self.thresholds: dict[str, float] = {}
        for slo in SLOS:
            if thresholds and slo.name in thresholds:
                self.thresholds[slo.name] = float(thresholds[slo.name])
            else:
                self.thresholds[slo.name] = float(knob(slo.threshold_knob))
        self._lock = threading.Lock()
        self._snaps: deque[tuple[float, dict]] = deque(maxlen=MAX_SNAPSHOTS)
        #: breach-episode edge detector for the flight recorder: True
        #: while the current breach has already been bundled (worst case
        #: under racing evaluators: one extra bundle, caught by the
        #: recorder's own per-kind debounce)
        self._breach_recorded = False
        #: minimum spacing between RETAINED snapshots: without it, a 1 Hz
        #: /debug/slo poller fills the deque in ~17 min and silently
        #: truncates the long window's baseline while the gauge label
        #: still claims the full window.  At this floor the deque always
        #: spans >= 1.5x the longest window.
        self._min_gap = max(1.0, 1.5 * max(self.windows) / MAX_SNAPSHOTS)

    # ------------------------------------------------------------------
    @staticmethod
    def _window_label(w: float) -> str:
        return f"{int(w)}s"

    def _baseline(self, now: float,
                  window: float) -> tuple[float, dict]:  # lfkt: holds[_lock]
        """The snapshot at the window's start: the newest one at least
        ``window`` old, else the oldest available (young process: the
        window truncates to process age), else empty (since-boot)."""
        best = (now, {})
        for t, snap in self._snaps:
            if t <= now - window:
                best = (t, snap)
            else:
                break
        if best[1] or len(self._snaps) <= 1:
            return best
        t, snap = self._snaps[0]
        return (t, snap) if t < now else (now, {})

    def _eval_series(self, slo: SLO, threshold: float, cur: dict,
                     base: dict) -> dict:
        """One (slo, window) evaluation across the family's label series:
        ``{"burn_rate", "bad", "total", "worst_series"}``."""
        metric = lookup(slo.metric)
        fam_cur = cur.get(slo.metric, {})
        fam_base = base.get(slo.metric, {})
        if slo.kind == RATIO:
            bad = total = 0.0
            li = metric.labels.index(slo.bad_label) if slo.bad_label else -1
            ri = (metric.labels.index("route")
                  if slo.exclude_routes and "route" in metric.labels else -1)
            for key, v in fam_cur.items():
                if ri >= 0 and str(key[ri]).startswith(slo.exclude_routes):
                    continue
                d = float(v) - float(fam_base.get(key, 0.0))
                if d <= 0:
                    continue
                total += d
                if li >= 0 and str(key[li]).startswith(slo.bad_prefix):
                    bad += d
            ratio = (bad / total) if total else 0.0
            burn = (ratio / threshold) if threshold > 0 else 0.0
            return {"burn_rate": round(burn, 4), "bad": round(bad, 3),
                    "total": round(total, 3), "worst_series": None}
        # histogram kinds: evaluate each label series, report the worst
        budget = max(1e-9, 1.0 - slo.objective)
        worst = {"burn_rate": 0.0, "bad": 0.0, "total": 0.0,
                 "worst_series": None}
        series_out = {}
        for key, h in fam_cur.items():
            if not isinstance(h, dict):
                continue
            bh = fam_base.get(key)
            dcount = h["count"] - (bh["count"] if bh else 0)
            if dcount <= 0:
                continue
            dbuckets = [n - (bh["buckets"][i] if bh else 0)
                        for i, n in enumerate(h["buckets"])]
            n_le = _n_at_or_below(metric.buckets, dbuckets, dcount,
                                  threshold)
            bad = (dcount - n_le) if slo.kind == LATENCY else n_le
            burn = (bad / dcount) / budget
            label = ",".join(key) if key else ""
            series_out[label] = round(burn, 4)
            if burn >= worst["burn_rate"]:
                worst = {"burn_rate": round(burn, 4),
                         "bad": round(bad, 3), "total": dcount,
                         "worst_series": label or None}
        if series_out:
            worst["series"] = series_out
        return worst

    # ------------------------------------------------------------------
    def evaluate(self, now: float | None = None) -> dict:
        """Take a snapshot, evaluate every (SLO, window), and return the
        full verdict document (the ``/debug/slo`` body).  ``now`` is
        injectable for deterministic tests."""
        if now is None:
            now = time.time()
        snap = self._metrics.snapshot()
        with self._lock:
            if not self._snaps or now - self._snaps[-1][0] >= self._min_gap:
                self._snaps.append((now, snap))
            horizon = now - max(self.windows) * 1.5
            while len(self._snaps) > 2 and self._snaps[1][0] <= horizon:
                self._snaps.popleft()
            baselines = {w: self._baseline(now, w) for w in self.windows}

        slos = []
        worst_rank = 0
        ranks = {"ok": 0, "warn": 1, "breach": 2}
        for slo in SLOS:
            threshold = self.thresholds[slo.name]
            per_window = {}
            burning = []
            confirmed = []
            for w in self.windows:
                t_base, base = baselines[w]
                ev = self._eval_series(slo, threshold, snap, base)
                span = now - t_base
                ev["window_s"] = round(span, 3)
                # a baseline younger than the window means the window is
                # truncated to process age: it holds the SAME evidence as
                # the shorter windows and cannot play its independent
                # confirm-the-burn-lasted role in a breach verdict
                truncated = span < w
                if truncated:
                    ev["truncated"] = True
                per_window[self._window_label(w)] = ev
                hit = ev["burn_rate"] >= 1.0
                burning.append(hit)
                confirmed.append(hit and not truncated)
            if confirmed and all(confirmed):
                verdict = "breach"
            elif any(burning):
                verdict = "warn"
            else:
                verdict = "ok"
            worst_rank = max(worst_rank, ranks[verdict])
            slos.append({
                "name": slo.name, "metric": slo.metric, "kind": slo.kind,
                "threshold": threshold, "objective": slo.objective,
                "help": slo.help, "windows": per_window,
                "verdict": verdict,
            })

        storms = self._devtime.storms()
        recompile = {
            "budget": self._devtime.budget,
            "storms": storms,
            "storms_total": self._devtime.storms_total,
            "verdict": "storm" if storms else "ok",
        }
        overall = ["ok", "warn", "breach"][worst_rank]
        if storms and overall == "ok":
            overall = "warn"        # perf incident with green latency SLOs
        doc = {"now": now,
               "windows": [self._window_label(w) for w in self.windows],
               "slos": slos, "recompile": recompile, "verdict": overall}
        if overall == "breach":
            # flight recorder (obs/flightrec.py): a confirmed breach is an
            # incident — bundle the verdict with the process state while
            # the burn is live.  Recorded on the RISING EDGE only (one
            # bundle per breach episode): a breach persists across every
            # scrape, and re-recording each debounce window would flood
            # the bounded ring and prune the rare trip/OOM bundles the
            # recorder exists to preserve.  The capture+write (ledger
            # snapshot, trace serialization, fsync) runs on a short-lived
            # worker thread: evaluate() is called from the async /metrics
            # and /debug/slo handlers, and a multi-ms disk write must not
            # stall the event loop of an already-degraded pod.  The latch
            # is optimistic and ROLLED BACK by the worker when the record
            # failed (disk full) or was debounced, so a later scrape
            # retries instead of leaving the episode evidence-less.
            if _flightrec.FLIGHTREC.armed and not self._breach_recorded:
                self._breach_recorded = True
                breached = [s["name"] for s in slos
                            if s["verdict"] == "breach"]

                def _record(doc=doc, names=tuple(breached)):
                    if _flightrec.record_incident(
                            "slo_breach",
                            "SLO breach: " + ", ".join(names),
                            extra={"slo": doc}) is None:
                        self._breach_recorded = False
                threading.Thread(target=_record, name="lfkt-slo-incident",
                                 daemon=True).start()
        else:
            self._breach_recorded = False    # episode over: re-arm
        return doc

    def export(self, now: float | None = None) -> dict:
        """Evaluate and publish ``slo_burn_rate{slo,window,scope}``
        gauges into the bound metrics registry (the /metrics scrape
        hook).  Returns the verdict document so callers can reuse it."""
        doc = self.evaluate(now=now)
        for s in doc["slos"]:
            for wl, ev in s["windows"].items():
                self._metrics.set_gauge("slo_burn_rate", ev["burn_rate"],
                                        slo=s["name"], window=wl,
                                        scope=self.scope)
        return doc

"""Prometheus-text metrics registry: labeled series + true histograms.

The JAX package's registry (llama_fastapi_k8s_gpu_tpu/utils/metrics.py):
every family is declared once in obs/catalog.py (an unregistered name
raises ``KeyError``); ``observe`` feeds an explicit-bucket histogram
(cumulative ``_bucket{le="..."}`` + ``_sum`` + ``_count``) and the render
derives p50/p95/p99 gauges per series (``{name}_p50`` ...) by linear
interpolation inside a bucket; counters, gauges and histograms take the
catalog's labels as keyword arguments.  One ``# HELP`` and one ``# TYPE``
per family, families contiguous.
"""

from __future__ import annotations

import bisect
import threading

from ..obs.catalog import COUNTER, GAUGE, HISTOGRAM, Metric, lookup

#: derived-quantile gauge suffixes rendered for every histogram series
QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers without the trailing .0."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Series:
    """One labelset's storage: a scalar for counter/gauge, buckets+sum for
    a histogram."""

    __slots__ = ("value", "buckets", "total", "count")

    def __init__(self, metric: Metric):
        self.value = 0.0
        if metric.mtype == HISTOGRAM:
            self.buckets = [0] * (len(metric.buckets) + 1)  # + the +Inf bucket
            self.total = 0.0
            self.count = 0

    def copy(self) -> "_Series":
        """Numeric snapshot for the render path (copy-then-release)."""
        c = _Series.__new__(_Series)
        c.value = self.value
        if hasattr(self, "buckets"):
            c.buckets = list(self.buckets)
            c.total = self.total
            c.count = self.count
        return c

    def quantile(self, metric: Metric, q: float) -> float:
        """histogram_quantile(): linear interpolation inside the bucket the
        q-th observation falls in — between that bucket's OWN bounds (the
        lower bound is the previous bucket's bound even when every lower
        bucket is empty); the +Inf bucket clamps to the largest finite
        bound (Prometheus convention)."""
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self.buckets):
            if n and cum + n >= rank:
                if i >= len(metric.buckets):        # +Inf bucket
                    return float(metric.buckets[-1])
                hi = float(metric.buckets[i])
                lo = float(metric.buckets[i - 1]) if i else 0.0
                return lo + (hi - lo) * ((rank - cum) / n)
            cum += n
        return float(metric.buckets[-1])


class Metrics:
    # inc/observe run on handler, engine and watchdog threads concurrently
    # with the /metrics render: every store goes through _lock
    def __init__(self):
        self._lock = threading.Lock()
        #: name -> { labels_tuple -> _Series }
        self._series: dict[str, dict[tuple, _Series]] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _resolve(name: str, mtype: str, labels: dict) -> tuple[Metric, tuple]:
        metric = lookup(name)
        if metric is None:
            raise KeyError(
                f"metric {name!r} is not in the catalog (obs/catalog.py); "
                "register it before recording it")
        if metric.mtype != mtype:
            raise KeyError(
                f"metric {name!r} is a {metric.mtype}, recorded as {mtype}")
        if set(labels) != set(metric.labels):
            raise KeyError(
                f"metric {name!r} takes labels {metric.labels}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in metric.labels)
        return metric, key

    def _get(self, name: str, mtype: str,
             labels: dict) -> tuple[Metric, _Series]:  # under _lock
        metric, key = self._resolve(name, mtype, labels)
        by_label = self._series.setdefault(name, {})
        s = by_label.get(key)
        if s is None:
            s = by_label[key] = _Series(metric)
        return metric, s

    # -- producer API ---------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels):
        with self._lock:
            self._get(name, COUNTER, labels)[1].value += value

    def set_gauge(self, name: str, value: float, **labels):
        with self._lock:
            self._get(name, GAUGE, labels)[1].value = float(value)

    def observe(self, name: str, value: float, **labels):
        """Record one observation into the name's histogram."""
        with self._lock:
            metric, s = self._get(name, HISTOGRAM, labels)
            s.buckets[bisect.bisect_left(metric.buckets, float(value))] += 1
            s.total += float(value)
            s.count += 1

    def reset_family(self, name: str) -> None:
        """Drop every series of a snapshot-style GAUGE family before a
        re-export, so a family rebuilt whole at scrape time forgets series
        whose source vanished.  Counters and histograms are cumulative and
        are never reset this way."""
        metric = lookup(name)
        if metric is None or metric.mtype != GAUGE:
            raise KeyError(
                f"reset_family is for cataloged gauge families; "
                f"{name!r} is not one")
        with self._lock:
            self._series.pop(name, None)

    def snapshot(self) -> dict:
        """Every series' raw storage at this moment: ``{name: {labels:
        value | {"buckets", "sum", "count"}}}``.  The SLO engine diffs two
        of them: the buckets are cumulative since boot, so a window's
        delta is an exact event count."""
        out: dict = {}
        with self._lock:
            for name, series in self._series.items():
                metric = lookup(name)
                per: dict = {}
                for key, s in series.items():
                    if metric.mtype == HISTOGRAM:
                        per[key] = {"buckets": list(s.buckets),
                                    "sum": s.total, "count": s.count}
                    else:
                        per[key] = s.value
                out[name] = per
        return out

    # -- exposition ------------------------------------------------------
    @staticmethod
    def _label_str(metric: Metric, key: tuple, extra: str = "") -> str:
        parts = [f'{k}="{_escape(v)}"' for k, v in zip(metric.labels, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> str:
        # copy-then-release: the numeric state is snapshotted under the
        # lock; the sort and all string work run off it, so a scrape never
        # stalls a hot-path inc() behind formatting
        with self._lock:
            snap = {name: {key: s.copy() for key, s in by_label.items()}
                    for name, by_label in self._series.items()}
        lines: list[str] = []
        for name in sorted(snap):
            metric = lookup(name)
            mtype = metric.mtype
            series = snap[name]
            lines.append(f"# HELP {name} {metric.help}")
            lines.append(f"# TYPE {name} {mtype}")
            if mtype != HISTOGRAM:
                for key in sorted(series):
                    lines.append(
                        f"{name}{self._label_str(metric, key)} "
                        f"{_fmt(series[key].value)}")
                continue
            for key in sorted(series):
                s = series[key]
                cum = 0
                for bound, n in zip(metric.buckets, s.buckets):
                    cum += n
                    le = f'le="{_fmt(bound)}"'
                    lines.append(
                        f"{name}_bucket"
                        f"{self._label_str(metric, key, le)} {cum}")
                inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{self._label_str(metric, key, inf)} "
                    f"{s.count}")
                lines.append(
                    f"{name}_sum{self._label_str(metric, key)} "
                    f"{_fmt(s.total)}")
                lines.append(
                    f"{name}_count{self._label_str(metric, key)} "
                    f"{s.count}")
            # derived quantiles: separate gauge families (legal — a
            # histogram family itself may not carry quantile samples)
            for suffix, q in QUANTILES:
                lines.append(
                    f"# HELP {name}_{suffix} derived {q:.2f} quantile "
                    f"of {name}")
                lines.append(f"# TYPE {name}_{suffix} gauge")
                for key in sorted(series):
                    lines.append(
                        f"{name}_{suffix}{self._label_str(metric, key)} "
                        f"{_fmt(series[key].quantile(metric, q))}")
        return "\n".join(lines) + "\n"

"""Fleet-scope observability: cross-process trace assembly + metrics
federation (the router-side half).

The port's copy of the JAX package's module
(llama_fastapi_k8s_gpu_tpu/obs/fleettrace.py); stdlib only, so the router
process never loads torch.  Every pod carries its own tracer, metrics
registry, SLO engine and flight recorder, while a request spans the router,
a replica and, for a migration pull, a second replica.  Three pull-based
primitives make the fleet one observability domain:

- **trace assembly** — :func:`collect_fragments` pulls each pod's
  ``/debug/traces/{id}`` fragment for one request id and :func:`stitch`
  grafts every fragment's root under the span named by its
  ``parent_span_id`` (the outbound hop stamp of
  :func:`obs.trace.span_traceparent`): ONE multi-process span tree.  A
  fragment whose parent span is missing is kept, attached under the
  primary root and flagged ``orphan``.

- **metrics federation** — :func:`federate` parses each peer's Prometheus
  text (utils/metrics.py's rendering) and merges per family: counters SUM,
  histograms merge BUCKET-WISE, gauges re-label by peer.  The merged state
  is also snapshot-shaped (utils/metrics.py ``snapshot()``), so the
  unmodified SLO engine evaluates the catalog over fleet-wide
  distributions via :class:`FleetMetricsView` (``slo_burn_rate{scope=
  "fleet"}``).

- **incident correlation** — :func:`incident_pull` fetches recent
  flight-recorder bundle summaries from the ejected peer (best-effort) and
  the surviving fleet, and records ONE local ``fleet_peer_ejected`` bundle.

Every peer fetch has a hard timeout, every peer-supplied string passes
:func:`obs.logctx.sanitize_text`, and a peer that answers garbage degrades
to "missing from the merge" — never an exception on the router's path.
"""

from __future__ import annotations

import http.client
import json
import re
import threading

from .logctx import sanitize_text
from ..utils.metrics import COUNTER, GAUGE, HISTOGRAM, _fmt, lookup

#: bound on one peer response body (a hostile/byzantine peer must not
#: balloon the router's heap: 8 MiB >> any sane scrape or trace doc)
MAX_BODY = 8 << 20

#: derived-quantile gauge families (utils/metrics.py QUANTILES) are
#: recomputable from the merged buckets and meaningless to sum — skipped
_QUANTILE_SUFFIXES = ("_p50", "_p95", "_p99")

#: one exposition sample line: name{labels} value  (labels optional)
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$')
#: one label pair inside the braces, honouring \" escapes
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


# ---------------------------------------------------------------------------
# bounded peer HTTP (stdlib only)
# ---------------------------------------------------------------------------

def fetch_text(addr: str, path: str, timeout: float = 2.0) -> str | None:
    """GET ``http://addr path`` → body text, or None on ANY failure
    (connect, timeout, non-200, oversized).  Peer observability fetches
    are best-effort by contract."""
    host, _, port = addr.partition(":")
    try:
        conn = http.client.HTTPConnection(host, int(port or 80),
                                          timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            body = resp.read(MAX_BODY + 1)
            if len(body) > MAX_BODY:
                return None
            return body.decode("utf-8", "replace")
        finally:
            conn.close()
    except (OSError, ValueError):
        return None


def fetch_json(addr: str, path: str, timeout: float = 2.0) -> dict | None:
    text = fetch_text(addr, path, timeout=timeout)
    if text is None:
        return None
    try:
        doc = json.loads(text)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


# ---------------------------------------------------------------------------
# layer 1: cross-process trace assembly
# ---------------------------------------------------------------------------

def collect_fragments(trace_id: str, peers: list[str],
                      timeout: float = 2.0,
                      local: dict | None = None,
                      local_name: str = "router") -> list[dict]:
    """Pull ``/debug/traces/{trace_id}`` from every peer; return
    ``[{"peer": name, "doc": trace_doc}]`` for the ones that had the
    fragment.  ``local`` lets the router contribute its own in-process
    fragment without HTTP."""
    out: list[dict] = []
    if local is not None:
        out.append({"peer": local_name, "doc": local})
    for addr in peers:
        doc = fetch_json(addr, f"/debug/traces/{trace_id}",
                         timeout=timeout)
        if doc is not None and doc.get("trace_id") == trace_id:
            out.append({"peer": addr, "doc": doc})
    return out


def _walk_spans(span: dict):
    yield span
    for child in span.get("children", ()):
        yield from _walk_spans(child)


def stitch(fragments: list[dict]) -> dict | None:
    """One multi-process span tree from per-process fragments.

    Each fragment doc is a ``Trace.to_dict()``: its ``parent_span_id``
    names the span (in ANOTHER process) that stamped the hop.  Grafting
    is by span id across all fragments, so chains work unordered: the
    prefiller fragment's parent lives in the replica fragment, whose own
    parent lives in the router fragment.  Fragments with no resolvable
    parent are orphans — attached under the primary root (flagged) so
    evidence is never dropped, and counted so CI can pin zero."""
    if not fragments:
        return None
    frags = [dict(f) for f in fragments]
    index: dict[str, dict] = {}
    for f in frags:
        root = f["doc"].get("root") or {}
        f["root"] = root
        for sp in _walk_spans(root):
            sid = sp.get("span_id")
            if sid:
                index.setdefault(sid, sp)

    def _start(f):
        return f["root"].get("start") or 0.0

    # primary = the rootmost fragment: no parent stamp at all, earliest
    # start breaking ties; with every fragment parented (router fragment
    # missing), fall back to the earliest-started one
    parentless = [f for f in frags if not f["doc"].get("parent_span_id")]
    primary = min(parentless or frags, key=_start)
    primary["root"].setdefault("attrs", {})["process"] = primary["peer"]

    orphans: list[str] = []
    for f in frags:
        if f is primary:
            continue
        attrs = f["root"].setdefault("attrs", {})
        attrs["process"] = f["peer"]
        attrs["hop"] = True
        parent = index.get(f["doc"].get("parent_span_id") or "")
        if parent is None or parent is f["root"]:
            attrs["orphan"] = True
            orphans.append(str(f["peer"]))
            parent = primary["root"]
        parent.setdefault("children", []).append(f["root"])

    return {
        "trace_id": primary["doc"].get("trace_id"),
        "stitched": True,
        "processes": [str(f["peer"]) for f in frags],
        "fragments": len(frags),
        "orphans": orphans,
        "dropped_nodes": sum(int(f["doc"].get("dropped_nodes") or 0)
                             for f in frags),
        "finished": all(bool(f["doc"].get("finished")) for f in frags),
        "root": primary["root"],
    }


# ---------------------------------------------------------------------------
# layer 2: metrics federation
# ---------------------------------------------------------------------------

def parse_exposition(text: str) -> dict:
    """Prometheus exposition text → ``{family: {"type": t, "series":
    {label_key: float}, "hist": {label_key: {"le": {le_str: cum}, "sum",
    "count"}}}}``.  Label keys are tuples of (name, value) pairs in line
    order; values are sanitized (a byzantine peer must not forge merged
    exposition lines through a label value)."""
    fams: dict = {}
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, rawlabels, rawval = m.groups()
        try:
            value = float(rawval)
        except ValueError:
            continue
        labels = [(k, sanitize_text(v.replace('\\"', '"')
                                    .replace("\\\\", "\\")
                                    .replace("\\n", " "), limit=128))
                  for k, v in _LABEL_RE.findall(rawlabels or "")]
        base, kind = name, None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(name[:-len(suffix)]) \
                    == "histogram":
                base, kind = name[:-len(suffix)], suffix
                break
        fam = fams.setdefault(base, {"type": types.get(base, "untyped"),
                                     "series": {}, "hist": {}})
        fam["type"] = types.get(base, fam["type"])
        if kind is None:
            fam["series"][tuple(labels)] = value
            continue
        le = None
        if kind == "_bucket":
            le = next((v for k, v in labels if k == "le"), None)
            labels = [(k, v) for k, v in labels if k != "le"]
        h = fam["hist"].setdefault(tuple(labels),
                                   {"le": {}, "sum": 0.0, "count": 0.0})
        if kind == "_bucket" and le is not None:
            h["le"][le] = value
        elif kind == "_sum":
            h["sum"] = value
        elif kind == "_count":
            h["count"] = value
    return fams


def _catalog_key(name: str, labels: tuple) -> tuple | None:
    """Reorder parsed (k, v) label pairs into the catalog's label-value
    tuple (the utils/metrics.py snapshot key), or None when the set
    doesn't match the catalog (foreign series never poison the merge)."""
    metric = lookup(name)
    if metric is None:
        return None
    got = dict(labels)
    if set(got) != set(metric.labels):
        return None
    return tuple(got[k] for k in metric.labels)


def federate(texts: dict[str, str]) -> dict:
    """Merge per-peer exposition texts.  Returns::

        {"peers": [...], "exposition": str, "snapshot": {...}}

    ``exposition`` is servable at ``GET /metrics/fleet``: counters
    summed across peers, histograms merged bucket-wise, gauges
    re-labeled ``{...,peer="host:port"}``.  ``snapshot`` holds the
    merged counter/histogram state in the utils/metrics.py
    ``snapshot()`` shape so :class:`FleetMetricsView` can feed the
    unmodified SLO engine."""
    parsed = {peer: parse_exposition(text)
              for peer, text in texts.items() if text}
    names: dict[str, str] = {}
    for fams in parsed.values():
        for name, fam in fams.items():
            if name.endswith(_QUANTILE_SUFFIXES):
                continue
            names.setdefault(name, fam["type"])

    lines: list[str] = []
    snapshot: dict = {}
    for name in sorted(names):
        ftype = names[name]
        metric = lookup(name)
        help_text = metric.help if metric is not None else "federated"
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {ftype}")
        if ftype == "histogram":
            merged: dict = {}
            for fams in parsed.values():
                for key, h in fams.get(name, {}).get("hist", {}).items():
                    agg = merged.setdefault(
                        key, {"le": {}, "sum": 0.0, "count": 0.0})
                    for le, cum in h["le"].items():
                        agg["le"][le] = agg["le"].get(le, 0.0) + cum
                    agg["sum"] += h["sum"]
                    agg["count"] += h["count"]
            snap_per: dict = {}
            for key in sorted(merged):
                agg = merged[key]
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                pre = "{" + lbl + "," if lbl else "{"
                for le, cum in sorted(
                        agg["le"].items(),
                        key=lambda kv: float("inf")
                        if kv[0] == "+Inf" else float(kv[0])):
                    lines.append(f'{name}_bucket{pre}le="{le}"}} '
                                 f'{_fmt(agg["le"][le])}')
                tail = "{" + lbl + "}" if lbl else ""
                lines.append(f'{name}_sum{tail} {_fmt(agg["sum"])}')
                lines.append(f'{name}_count{tail} {_fmt(agg["count"])}')
                skey = _catalog_key(name, key)
                if skey is not None and metric is not None \
                        and metric.mtype == HISTOGRAM:
                    cum_prev, deltas = 0.0, []
                    for bound in metric.buckets:
                        cum = agg["le"].get(_fmt(bound), cum_prev)
                        deltas.append(max(0.0, cum - cum_prev))
                        cum_prev = cum
                    deltas.append(max(0.0, agg["count"] - cum_prev))
                    snap_per[skey] = {"buckets": deltas,
                                      "sum": agg["sum"],
                                      "count": agg["count"]}
            if snap_per:
                snapshot[name] = snap_per
        elif ftype == "counter":
            merged2: dict = {}
            for fams in parsed.values():
                for key, v in fams.get(name, {}).get("series", {}).items():
                    merged2[key] = merged2.get(key, 0.0) + v
            snap_per = {}
            for key in sorted(merged2):
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                tail = "{" + lbl + "}" if lbl else ""
                lines.append(f"{name}{tail} {_fmt(merged2[key])}")
                skey = _catalog_key(name, key)
                if skey is not None and metric is not None \
                        and metric.mtype == COUNTER:
                    snap_per[skey] = merged2[key]
            if snap_per:
                snapshot[name] = snap_per
        else:
            # gauges re-label by peer: summing a utilization or a
            # connected-flag across pods would manufacture nonsense
            for peer in sorted(parsed):
                fam = parsed[peer].get(name)
                if fam is None:
                    continue
                speer = sanitize_text(peer, limit=128)
                for key in sorted(fam["series"]):
                    lbl = ",".join(f'{k}="{v}"' for k, v in key)
                    lbl = (lbl + "," if lbl else "") + f'peer="{speer}"'
                    lines.append(
                        f"{name}{{{lbl}}} {_fmt(fam['series'][key])}")
    return {"peers": sorted(parsed), "exposition": "\n".join(lines) + "\n",
            "snapshot": snapshot}


class FleetMetricsView:
    """The SLO engine's view of the federated fleet: quacks like
    utils/metrics.py ``Metrics`` for exactly the two methods
    obs/slo.py uses — ``snapshot()`` returns the latest merge and
    ``set_gauge`` captures the published burn gauges for re-rendering
    into the ``/metrics/fleet`` body.  The engine itself is unmodified:
    federation happens underneath it, not inside it."""

    # snapshot updates come from whichever thread serves the scrape; both
    # sides swap or read whole dicts, so a reader sees the old merge or
    # the new one, never a torn one

    # snapshot updates come from whichever thread serves the scrape;
    # reads may race — both sides swap/read whole dicts (lfkt-lint
    # LOCK001: attribute swap is atomic, readers see old or new, never
    # a torn merge)
    _SHARED_ATOMIC = ("_snap", "gauges")

    def __init__(self):
        self._snap: dict = {}
        self.gauges: dict = {}

    def update(self, snapshot: dict) -> None:
        self._snap = snapshot

    def snapshot(self) -> dict:
        return self._snap

    def set_gauge(self, name: str, value: float, **labels) -> None:
        gauges = dict(self.gauges)
        gauges[(name, tuple(sorted(labels.items())))] = float(value)
        self.gauges = gauges

    def render_gauges(self) -> str:
        """Exposition lines for the captured gauges (appended to the
        federated body so ``slo_burn_rate{scope="fleet"}`` rides the
        same scrape that produced it)."""
        items = sorted(self.gauges.items())
        if not items:
            return ""
        lines = []
        seen_help = False
        for (name, labels), value in items:
            if not seen_help:
                metric = lookup(name)
                if metric is not None:
                    lines.append(f"# HELP {name} {metric.help}")
                    lines.append(f"# TYPE {name} {metric.mtype}")
                seen_help = True
            metric = lookup(name)
            order = metric.labels if metric is not None \
                else tuple(k for k, _ in labels)
            got = dict(labels)
            lbl = ",".join(f'{k}="{got[k]}"' for k in order if k in got)
            lines.append(f"{name}{{{lbl}}} {_fmt(value)}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# layer 3: correlated incident capture
# ---------------------------------------------------------------------------

def incident_pull(peer: str, healthy: list[str], reason: str,
                  recorder=None, timeout: float = 2.0,
                  limit: int = 5) -> dict | None:
    """On an ejection/chaos event: fetch recent incident-bundle
    summaries from the ejected peer (best-effort — it may be the corpse)
    and from each surviving peer, and record ONE local
    ``fleet_peer_ejected`` bundle correlating them.  Returns the extra
    dict (for tests), or None when the local recorder is disarmed."""
    from .flightrec import FLIGHTREC

    rec = recorder if recorder is not None else FLIGHTREC
    if not rec.armed:
        return None
    correlated: dict[str, list] = {}
    for addr in [peer] + [a for a in healthy if a != peer]:
        doc = fetch_json(addr, "/debug/incidents", timeout=timeout)
        if doc is None:
            continue
        rows = doc.get("incidents")
        if not isinstance(rows, list):
            continue
        correlated[sanitize_text(addr, limit=128)] = [
            {k: sanitize_text(r.get(k), limit=128)
             for k in ("id", "kind", "reason", "ts") if k in r}
            for r in rows[:limit] if isinstance(r, dict)]
    extra = {"peer": sanitize_text(peer, limit=128),
             "reason": sanitize_text(reason, limit=256),
             "correlated": correlated}
    rec.record("fleet_peer_ejected",
               f"peer {sanitize_text(peer, limit=128)} ejected: "
               f"{sanitize_text(reason, limit=256)}", extra=extra)
    return extra


def incident_pull_async(peer: str, healthy: list[str], reason: str,
                        recorder=None, timeout: float = 2.0) -> None:
    """Fire-and-forget :func:`incident_pull` on a short-lived daemon
    thread — ejections happen on the router's event loop (or the prober
    thread) and must never block on N peer fetches.  The flight
    recorder's per-kind debounce bounds a flapping peer to one bundle
    per window."""
    from .flightrec import FLIGHTREC

    rec = recorder if recorder is not None else FLIGHTREC
    if not rec.armed:
        return
    threading.Thread(
        target=incident_pull, name="lfkt-fleet-incident",
        args=(peer, list(healthy), reason),
        kwargs={"recorder": rec, "timeout": timeout},
        daemon=True).start()

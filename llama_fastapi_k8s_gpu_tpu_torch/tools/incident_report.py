"""incident_report — list, summarize and validate incident bundles.

The flight recorder (obs/flightrec.py) writes schema-versioned JSON bundles
into ``LFKT_INCIDENT_DIR`` on watchdog trips, DEAD escalations, CUDA
out-of-memory errors, SLO breaches and a router's peer ejections.  This is
the post-mortem reader and, with ``--validate``, the schema gate ``ci_gate``
runs: every bundle present must validate, else the exit is nonzero.

Usage::

    # table of bundles in a ring directory (default: $LFKT_INCIDENT_DIR)
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.incident_report --dir /var/incidents

    # one bundle's full summary: reason, health trail, memory totals,
    # recompile state, interrupted requests, log tail
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.incident_report \\
        --dir /var/incidents --id inc-000001-watchdog_trip

    # schema gate: exit 1 if any bundle drifts
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.incident_report --validate

The listing, the summary and the verdicts are the JAX package's tool's
(tools/incident_report.py), over the port's recorder schema (the same
``SCHEMA`` and kinds).  Stdlib only, no torch: safe beside a wedged engine.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

from ..obs.flightrec import SCHEMA, validate_bundle
from ..utils.config import knob


def _bundles(directory: str) -> list[tuple[str, dict | None, str | None]]:
    """[(filename, parsed bundle | None, parse error | None)] in ring
    (sequence) order."""
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("inc-") and n.endswith(".json"))
    except OSError as e:
        print(f"cannot read {directory!r}: {e}", file=sys.stderr)
        return []
    out = []
    for n in names:
        try:
            with open(os.path.join(directory, n), encoding="utf-8") as f:
                out.append((n, json.load(f), None))
        except (OSError, ValueError) as e:
            out.append((n, None, str(e)))
    return out


def _fmt_mb(b) -> str:
    return "?" if not isinstance(b, (int, float)) else f"{b / 1e6:.1f}MB"


def render_listing(directory: str) -> str:
    rows = [f"incident ring: {directory} (schema {SCHEMA})",
            f"{'id':<32} {'kind':<20} {'at':<20} reason"]
    for name, doc, err in _bundles(directory):
        if doc is None:
            rows.append(f"{name:<32} UNPARSEABLE: {err}")
            continue
        at = doc.get("at")
        ts = (datetime.datetime.fromtimestamp(at).strftime("%F %T")
              if isinstance(at, (int, float)) else "?")
        rows.append(f"{doc.get('id', name):<32} {doc.get('kind', '?'):<20} "
                    f"{ts:<20} {doc.get('reason', '?')}")
    if len(rows) == 2:
        rows.append("(no bundles)")
    return "\n".join(rows)


def render_bundle(doc: dict) -> str:
    lines = [f"incident {doc.get('id')}  kind={doc.get('kind')}",
             f"reason: {doc.get('reason')}", ""]
    mem = doc.get("memory") or {}
    if mem.get("armed"):
        lines.append("memory ledger:")
        for row in mem.get("components", ()):
            model = f" [{row['model']}]" if row.get("model") else ""
            tier = "" if row.get("device", True) else " (host)"
            lines.append(f"  {row['component']:<16}{model:<16} "
                         f"{_fmt_mb(row['bytes']):>10}{tier}")
        lines.append(f"  {'residual':<32} "
                     f"{_fmt_mb(mem.get('residual_bytes')):>10}")
        hr = mem.get("headroom")
        if hr:
            lines.append(f"  headroom: {_fmt_mb(hr.get('bytes'))} of "
                         f"{_fmt_mb(hr.get('limit'))}")
    else:
        lines.append("memory ledger: disarmed at capture")
    health = doc.get("health")
    if health:
        lines.append("")
        lines.append(f"health: {health.get('state')} "
                     f"({health.get('reason')})")
        for t in health.get("transitions", ()):
            lines.append(f"  {t.get('from')} -> {t.get('to')}: "
                         f"{t.get('reason')}")
    sched = doc.get("scheduler")
    if sched:
        lines.append("")
        keys = ("lanes_live", "pending", "admission_inflight",
                "adm_budget_tokens", "mem_pressure")
        lines.append("scheduler: " + "  ".join(
            f"{k}={sched[k]}" for k in keys if k in sched))
    rec = doc.get("recompile") or {}
    if rec.get("storms"):
        lines.append("")
        lines.append(f"recompile storms ({rec.get('storms_total')} total):")
        for s in rec["storms"]:
            lines.append(f"  {s.get('program')}: {s.get('signatures')} "
                         f"signatures (budget {s.get('budget')})")
    traces = doc.get("traces") or ()
    if traces:
        lines.append("")
        lines.append(f"in-flight requests at capture ({len(traces)}):")
        for t in traces:
            meta = t.get("meta") or {}
            lines.append(f"  {t.get('trace_id')}  "
                         f"route={meta.get('route', '?')} "
                         f"model={meta.get('model', '-')} "
                         f"tokens={meta.get('tokens', '?')}")
    tail = doc.get("log_tail") or ()
    if tail:
        lines.append("")
        lines.append(f"log tail (last {len(tail)} lines):")
        for rec_line in tail[-10:]:
            lines.append(f"  [{rec_line.get('level')}] "
                         f"{rec_line.get('message')}")
    return "\n".join(lines)


def validate(directory: str | None) -> int:
    """The ci_gate check: every bundle in the ring must parse and match
    the schema.  No directory configured = nothing to validate = OK."""
    if not directory:
        print("incident-schema: no LFKT_INCIDENT_DIR configured; "
              "nothing to validate")
        return 0
    if not os.path.isdir(directory):
        print(f"incident-schema: {directory!r} does not exist; "
              "nothing to validate")
        return 0
    bad = 0
    n = 0
    for name, doc, err in _bundles(directory):
        n += 1
        if doc is None:
            print(f"{name}: unparseable ({err})")
            bad += 1
            continue
        for v in validate_bundle(doc):
            print(f"{name}: {v}")
            bad += 1
    print(f"incident-schema: {'FAIL' if bad else 'OK'} "
          f"({n} bundle(s), {bad} violation(s))")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="incident_report")
    ap.add_argument("--dir", default=knob("LFKT_INCIDENT_DIR"),
                    help="incident ring directory "
                         "(default: $LFKT_INCIDENT_DIR)")
    ap.add_argument("--id", help="render one bundle in full")
    ap.add_argument("--validate", action="store_true",
                    help="schema gate: exit 1 on any drift (ci_gate)")
    args = ap.parse_args(argv)

    if args.validate:
        return validate(args.dir)
    if not args.dir:
        ap.error("--dir (or LFKT_INCIDENT_DIR) is required")
    if args.id:
        path = os.path.join(args.dir, args.id + ".json")
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read {path!r}: {e}", file=sys.stderr)
            return 1
        print(render_bundle(doc))
        return 0
    print(render_listing(args.dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())

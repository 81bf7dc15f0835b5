"""fleet_trace — pull one request's trace fragments from every process that
touched it and render the stitched cross-process waterfall.

A request id (= trace id, the router's ``x-request-id`` response header)
names spans in the ROUTER (peer pick, spills, retries, stream relay), the
OWNING REPLICA (admission, queue, prefill, decode) and, when disagg or
migration fired, the prefill or warm peers' wire serves.  Each process
knows only its own fragment; this tool assembles them
(obs/fleettrace.py ``stitch``) into one waterfall with hop boundaries.

Usage::

    # the easy path: ask the router, which collects from its peers
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.fleet_trace \\
        --router http://router:8080 --trace <id>

    # routerless: name the pods yourself (host:port, comma separated)
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.fleet_trace \\
        --peers 10.0.0.4:8000,10.0.0.5:8000 --trace <id>

    # raw stitched JSON instead of the waterfall (pipe to a file/jq)
    python -m llama_fastapi_k8s_gpu_tpu_torch.tools.fleet_trace \\
        --router http://router:8080 --trace <id> --json

The CLI and the rendering are the JAX package's tool's (tools/fleet_trace.py,
which renders through tools/trace_report.py); the waterfall renderer is kept
here, as :func:`render_trace`, because a pod's image carries the package and
not ``tools/``.  Stdlib only, no torch: safe on a serving pod or a laptop.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

from ..obs import fleettrace

_TRACE_ID_RE = re.compile(r"[0-9a-f]{32}")

WIDTH = 56          # timeline columns
INDENT = 2          # per-depth indent in the name column
NAME_COL = 26


def _walk(span: dict, depth: int = 0):
    yield span, depth
    for child in span.get("children", ()):
        yield from _walk(child, depth + 1)


def _fmt_ms(seconds: float | None) -> str:
    return "     ?" if seconds is None else f"{seconds * 1000.0:6.1f}"


def _fmt_bytes(b) -> str:
    """Compact byte count for event suffixes (page moves, headroom)."""
    if not isinstance(b, (int, float)):
        return "?"
    if b >= 1e9:
        return f"{b / 1e9:.2f}GB"
    if b >= 1e6:
        return f"{b / 1e6:.1f}MB"
    return f"{b / 1e3:.0f}KB"


def render_trace(trace: dict) -> str:
    """One trace's ASCII waterfall and phase percentages.

    ``trace`` is a ``/debug/traces/{id}`` document (trace_id, meta, root)
    or a STITCHED fleet document (the router's ``/debug/fleet/traces/{id}``):
    grafted fragment roots carry ``process``/``hop`` attrs and render behind
    a hop-boundary rule, so one waterfall shows the router, the owning
    replica and the prefill/migration tiers on one clock.  Spans with no end
    (in flight, or the producer died) render to the trace's horizon with a
    ``…`` marker."""
    root = trace["root"]
    t0 = root["start"]
    horizon = root.get("end") or max(
        (s.get("end") or s["start"] for s, _ in _walk(root)), default=t0)
    total = max(horizon - t0, 1e-9)

    lines = []
    meta = trace.get("meta") or {}
    head = [f"trace {trace.get('trace_id', '?')}"]
    for k in ("route", "engine", "lane", "status"):
        if meta.get(k) is not None:
            head.append(f"{k}={meta[k]}")
    if trace.get("stitched"):
        head.append(f"processes={','.join(trace.get('processes') or [])}")
        if trace.get("orphans"):
            head.append(f"orphans={len(trace['orphans'])}")
    lines.append("  ".join(head))
    lines.append(f"total {total * 1000.0:.1f} ms"
                 + ("" if root.get("end") else "  (in flight)"))
    lines.append("")

    # name | start-ms | dur-ms | timeline bar
    phase_seconds: dict[str, float] = {}
    for span, depth in _walk(root):
        attrs = span.get("attrs") or {}
        if attrs.get("process") is not None:
            # a stitched fragment's root: everything under this line ran
            # in ANOTHER process, linked by the wire/header hop named here
            label = f"─ hop: {attrs['process']}"
            if attrs.get("orphan"):
                label += " (orphan)"
            lines.append(f"{label[:NAME_COL]:<{NAME_COL}} {'':>6} {'':>6} "
                         f"|{'┈' * WIDTH}|")
        start = span["start"] - t0
        end = (span.get("end") or horizon) - t0
        dur = max(end - start, 0.0)
        open_marker = "" if span.get("end") else "…"
        if depth == 1:      # direct children of the root ARE the phases
            phase_seconds[span["name"]] = (
                phase_seconds.get(span["name"], 0.0) + dur)
        lo = min(int(start / total * WIDTH), WIDTH - 1)
        hi = max(min(int(end / total * WIDTH + 0.999), WIDTH), lo + 1)
        bar = " " * lo + "█" * (hi - lo) + " " * (WIDTH - hi)
        name = (" " * (depth * INDENT) + span["name"])[:NAME_COL]
        extra = ""
        if span.get("attrs", {}).get("tokens") is not None:
            extra = f"  t={span['attrs']['tokens']}"
        lines.append(f"{name:<{NAME_COL}} {_fmt_ms(start)} "
                     f"{_fmt_ms(dur)} |{bar}|{open_marker}{extra}")

        def duration_bar(at, host_s, glyph, label, suffix):
            # a timed event rendered as a bar ENDING at its timestamp
            # (producers stamp the event after the work), so back-to-back
            # events visibly tile their parent span
            mark = min(int(at / total * WIDTH), WIDTH - 1)
            lo = max(0, min(int((at - host_s) / total * WIDTH), mark))
            ebar = (" " * lo + glyph * max(mark - lo + 1, 1)
                    + " " * (WIDTH - mark - 1))[:WIDTH]
            ename = (" " * ((depth + 1) * INDENT) + "* " + label)[:NAME_COL]
            lines.append(f"{ename:<{NAME_COL}} {_fmt_ms(at - host_s)} "
                         f"{_fmt_ms(host_s)} |{ebar}|  {suffix}")

        for ev in span.get("events", ()):
            at = ev["at"] - t0
            host_s = ev.get("host_s")
            if ev["name"] == "prefill_slice" and host_s is not None:
                # a prompt slice (▒)
                duration_bar(at, host_s, "▒",
                             f"slice@{ev.get('offset', '?')}",
                             f"n={ev.get('tokens', '?')}")
                continue
            if ev["name"] in ("kv_restore", "kv_spill", "kv_spill_restore") \
                    and host_s is not None:
                # paged-KV page movement (░, parallel/kvpool.py): the copy
                # cost, with its byte count, beside the slices it delays
                suffix = f"pages={ev.get('pages', '?')}"
                if ev.get("bytes") is not None:
                    suffix += f" {_fmt_bytes(ev['bytes'])}"
                duration_bar(at, host_s, "░", ev["name"], suffix)
                continue
            if ev["name"] in ("disagg_recv", "kv_migrate_pull",
                              "handshake") and host_s is not None:
                # wire-delivered KV pages (▓): a disagg prefill transfer or
                # a fleet migration pull; the dial handshake alike
                suffix = (f"pages={ev.get('pages', '?')}"
                          f" t={ev.get('tokens', '?')}"
                          if ev["name"] != "handshake"
                          else f"peer={ev.get('peer', '?')}")
                if ev.get("bytes") is not None:
                    suffix += f" {_fmt_bytes(ev['bytes'])}"
                if ev.get("reason") is not None:
                    suffix += f" reason={ev['reason']}"
                duration_bar(at, host_s, "▓", ev["name"], suffix)
                continue
            mark = min(int(at / total * WIDTH), WIDTH - 1)
            tick = " " * mark + "▲" + " " * (WIDTH - mark - 1)
            ename = (" " * ((depth + 1) * INDENT) + "* " + ev["name"])[:NAME_COL]
            suffix = ""
            if ev["name"] == "kv_pages":
                # serve-side wire progress: one PAGE group on the wire a tick
                suffix = (f"  pages={ev.get('pages', '?')}"
                          f" {_fmt_bytes(ev.get('bytes'))}")
            if ev["name"] == "mem_pressure":
                # the admission controller cut its budget on low headroom
                suffix = (f"  headroom={_fmt_bytes(ev.get('headroom_bytes'))}"
                          f"/{_fmt_bytes(ev.get('limit_bytes'))}")
            lines.append(
                f"{ename:<{NAME_COL}} {_fmt_ms(at)} {'':>6} |{tick}|{suffix}")

    if phase_seconds:
        lines.append("")
        lines.append("phase breakdown:")
        accounted = 0.0
        for name, dur in sorted(phase_seconds.items(), key=lambda kv: -kv[1]):
            accounted += dur
            lines.append(f"  {name:<20} {dur * 1000.0:8.1f} ms "
                         f"{dur / total * 100.0:5.1f}%")
        other = max(total - accounted, 0.0)
        lines.append(f"  {'(unattributed)':<20} {other * 1000.0:8.1f} ms "
                     f"{other / total * 100.0:5.1f}%")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fleet_trace")
    ap.add_argument("--trace", required=True,
                    help="trace id (= request id / x-request-id)")
    ap.add_argument("--router",
                    help="router base URL — it collects from its peers")
    ap.add_argument("--peers",
                    help="host:port,host:port — collect directly")
    ap.add_argument("--timeout", type=float, default=2.0)
    ap.add_argument("--json", action="store_true",
                    help="print the stitched document, not the waterfall")
    args = ap.parse_args(argv)

    trace_id = args.trace.strip().lower()
    if _TRACE_ID_RE.fullmatch(trace_id) is None:
        print(f"fleet_trace: {args.trace!r} is not a trace id "
              "(32 lowercase hex chars)", file=sys.stderr)
        return 2

    if args.router:
        # the router stitches: it knows the peer set and holds its own
        # fragment (the hop spans), so one GET does the whole assembly
        base = args.router.rstrip("/")
        host = base.split("//", 1)[-1].split("/", 1)[0]
        doc = fleettrace.fetch_json(
            host, f"/debug/fleet/traces/{trace_id}", timeout=args.timeout)
        if doc is None:
            print(f"fleet_trace: no stitched trace for {trace_id} at "
                  f"{base} (sampled out, expired from the rings, or the "
                  "router is unreachable)", file=sys.stderr)
            return 1
    elif args.peers:
        peers = [p.strip() for p in args.peers.split(",") if p.strip()]
        frags = fleettrace.collect_fragments(trace_id, peers,
                                             timeout=args.timeout)
        doc = fleettrace.stitch(frags)
        if doc is None:
            print(f"fleet_trace: no fragment of {trace_id} on any of "
                  f"{len(peers)} peer(s)", file=sys.stderr)
            return 1
    else:
        ap.error("one of --router or --peers is required")

    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    print(render_trace(doc))
    if doc.get("orphans"):
        print()
        print(f"WARNING: {len(doc['orphans'])} orphan fragment(s) — a "
              "process produced spans for this id whose parent span is "
              "missing (its pod's ring may have evicted the parent)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

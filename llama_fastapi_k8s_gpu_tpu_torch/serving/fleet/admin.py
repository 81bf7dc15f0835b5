"""Fleet admin client — drive a replica's live-reload surface from a
terminal (or a CI job) without remembering the wire shapes:

    # swap the manifest on one replica (no pod restart)
    python -m llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.admin \\
        --peer 10.0.0.7:8000 reload \\
        --models "llama8b=Llama-3-8B.Q4_K_M.gguf,phi=phi.gguf"

    # re-read the replica's own LFKT_MODELS env (the SIGHUP twin)
    python -m ...fleet.admin --peer host:port reload

    # the live model set / the health document
    python -m ...fleet.admin --peer host:port models
    python -m ...fleet.admin --peer host:port health

The port's copy of the JAX package's client
(llama_fastapi_k8s_gpu_tpu/serving/fleet/admin.py); stdlib only.
``reload`` POSTs ``/admin/models/reload`` (server/app.py) and prints the
replica's reload report; nonzero exit on refusal (HTTP 4xx/5xx), with
the replica's attributed reason on stderr — a weight-budget refusal
names the model and the byte table, a grammar error names the offending
manifest entry.  Rolling a fleet = this command per replica, behind the
router's health-aware ejection (a reloading replica that drops READY is
routed around automatically).  Operations guide: docs/RUNBOOK.md
"Running a replica fleet".
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys


def _request(peer: str, method: str, path: str, body: dict | None = None,
             timeout: float = 600.0) -> tuple[int, dict | str]:
    """One HTTP round trip to ``peer``; (status, parsed-or-raw body).
    The generous default timeout covers a multi-GB model load — reload
    answers only after the added engines are warm."""
    host, _, port = peer.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        raw = resp.read().decode("utf-8", "replace")
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw
    finally:
        conn.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llama_fastapi_k8s_gpu_tpu_torch.serving.fleet.admin",
        description="live-reload admin client for a serving replica")
    ap.add_argument("--peer", required=True, help="replica host:port")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="HTTP timeout (reload waits for the load+warmup)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rl = sub.add_parser("reload", help="POST /admin/models/reload")
    rl.add_argument("--models", default="",
                    help="new LFKT_MODELS manifest (empty = the replica "
                         "re-reads its own env)")
    rl.add_argument("--default-model", default="",
                    help="new default alias (empty = first manifest entry)")
    sub.add_parser("models", help="GET /v1/models")
    sub.add_parser("health", help="GET /health")
    args = ap.parse_args(argv)

    if args.cmd == "reload":
        body: dict = {}
        if args.models:
            body["models"] = args.models
        if args.default_model:
            body["default_model"] = args.default_model
        status, doc = _request(args.peer, "POST", "/admin/models/reload",
                               body, timeout=args.timeout)
    elif args.cmd == "models":
        status, doc = _request(args.peer, "GET", "/v1/models",
                               timeout=args.timeout)
    else:
        status, doc = _request(args.peer, "GET", "/health",
                               timeout=args.timeout)

    text = json.dumps(doc, indent=1) if isinstance(doc, dict) else str(doc)
    if status >= 400:
        print(f"{args.peer} -> HTTP {status}\n{text}", file=sys.stderr)
        return 1
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

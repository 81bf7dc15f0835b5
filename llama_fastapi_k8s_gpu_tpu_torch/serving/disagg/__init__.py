"""Disaggregated prefill/decode: KV-page streaming between tiers.

The port of the JAX package's tier (llama_fastapi_k8s_gpu_tpu/serving/
disagg/), on the same wire: a **prefill tier** prefills prompts and
streams the finished KV pages of its paged arena to **decode replicas**,
which import them into their own arena and decode from the restored
prefix.  The paged pool makes the wire format free: a finished prefill is
already a set of self-contained pages (int8 scales ride the page).

Pieces (each its own module):

- wire.py       — versioned frame format + geometry handshake (pinned by
                  the golden ``docs/disagg_wire_schema.json``)
- transport.py  — stdlib sockets, length-prefixed frames, bounded send
                  queue with backpressure (memory ledger: disagg_txbuf)
- prefiller.py  — the page service (``LFKT_DISAGG_ROLE=prefill``)
- decoder.py    — the remote-prefill client (``role=decode``); every
                  failure degrades to LOCAL prefill with attribution

``LFKT_DISAGG_ROLE=both`` arms both halves on one engine over loopback:
the CPU-testable configuration, the full wire still crossed.
"""

from __future__ import annotations

# NOTE: submodules import lazily (build_roles) — `python -m
# ...serving.disagg.wire` (the golden schema check) must not find wire
# pre-imported by this package (runpy warning), and a wire-only consumer
# must not pay the prefiller/decoder imports.

#: valid LFKT_DISAGG_ROLE values (utils/config.py)
ROLES = ("off", "prefill", "decode", "both")


class DisaggRoles:
    """This process's armed disagg halves + the /health tier block."""

    def __init__(self, role: str, server=None, client=None):
        self.role = role
        self.server = server
        self.client = client

    def status(self) -> dict:
        out: dict = {"role": self.role}
        if self.server is not None:
            out["prefill_service"] = self.server.status()
        if self.client is not None:
            out["peer"] = self.client.status()
        return out

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
        if self.server is not None:
            self.server.stop()


def build_roles(role: str, engine, settings, metrics=None,
                health=None) -> DisaggRoles | None:
    """Arm the configured disagg role(s) on ``engine`` (server startup,
    server/app.py).  Misconfiguration refuses LOUDLY at startup — the
    LFKT_WORKERS idiom — instead of silently serving a half-armed fleet:

    - any non-off role needs the paged pool (pages ARE the wire format);
    - the multi-model registry gates off (one model per tier — the two
      pools' geometries must match EXACTLY, which the manifest cannot
      promise across N models);
    - role=decode needs a peer address.
    """
    if role not in ROLES:
        raise ValueError(
            f"LFKT_DISAGG_ROLE must be one of {'|'.join(ROLES)}, "
            f"got {role!r}")
    if role == "off":
        return None
    if callable(getattr(engine, "models", None)):
        raise ValueError(
            "LFKT_DISAGG_ROLE gates off multi-model registry serving: a "
            "split fleet runs one model per tier pair (the page wire "
            "demands one exact cache geometry) — drop LFKT_MODELS or "
            "set LFKT_DISAGG_ROLE=off (docs/RUNBOOK.md)")
    pool = getattr(engine, "_kvpool", None)
    if pool is None:
        raise ValueError(
            f"LFKT_DISAGG_ROLE={role} requires LFKT_KV_PAGED=1 on a "
            "pool-capable engine: finished prefills ship as KV pages, "
            "and only the paged arena produces/receives them "
            "(docs/RUNBOOK.md 'Operating a split prefill/decode fleet')")
    from .decoder import DisaggClient
    from .prefiller import PrefillServer

    server = client = None
    if role in ("prefill", "both"):
        server = PrefillServer(
            engine,
            host="127.0.0.1" if role == "both" else settings.disagg_bind,
            port=0 if role == "both" else settings.disagg_port,
            queue_frames=settings.disagg_queue_frames, metrics=metrics)
    if role in ("decode", "both"):
        peer = (f"127.0.0.1:{server.port}" if role == "both"
                else settings.disagg_peer)
        if not peer:
            if server is not None:
                server.stop()
            raise ValueError(
                "LFKT_DISAGG_ROLE=decode requires LFKT_DISAGG_PEER="
                "host:port (the prefill tier's page service)")
        try:
            client = DisaggClient(
                peer, pool, timeout_s=settings.disagg_timeout_seconds,
                metrics=metrics, health=health)
            engine.install_disagg(client)
        except Exception:
            if server is not None:
                server.stop()
            raise
    return DisaggRoles(role, server, client)

"""The fleet tier: prefix-affinity routing, warm-page migration and
live-reload plumbing above the pod.

The port's copy of the JAX package's tier
(llama_fastapi_k8s_gpu_tpu/serving/fleet/).  The radix prefix cache makes
one pod warm for the conversations it served; above one replica,
round-robin placement scatters a conversation's turns and the warm pages
sit on the wrong replica.  This package is the layer above the pod:

- affinity.py — stable per-conversation keys from the request's prefix
  content + rendezvous (HRW) hashing over the replica set
- peers.py    — the health-aware peer table: ``LFKT_FLEET_PEERS`` or
  headless-Service DNS discovery, ``/health/ready`` probing, ejection
  with exponential backoff, re-admission
- router.py   — the proxy process (``LFKT_FLEET_ROLE=router``): raw
  streaming passthrough, spill-to-rendezvous-next with attribution
- migrate.py  — the replica side of warm-page migration (the page
  service, pull-on-remap, SIGTERM drain, scale-out warm-up), armed by
  ``LFKT_MIGRATE=1``
- admin.py    — the live-reload client (``python -m ...fleet.admin``) for
  the replica-side ``POST /admin/models/reload``

The router imports none of the replica machinery and no torch: a router
process is a few MB of stdlib.  Nothing here imports a submodule eagerly.
"""

from __future__ import annotations

#: valid LFKT_FLEET_ROLE values (utils/config.py).  Replicas are plain
#: serving pods (role stays "off"); only the router changes process type.
FLEET_ROLES = ("off", "router")


def build_router(settings, metrics=None, tracer=None):
    """A ready-to-serve :class:`FleetRouter` from the fleet knobs, with
    the peer table probed once synchronously (the router never starts
    blind).  Misconfiguration refuses loudly — the LFKT_WORKERS idiom —
    instead of routing into an empty fleet.  ``tracer`` (an
    obs.trace.Tracer; the process-wide one honours ``LFKT_TRACE_*``)
    arms router-side span production and the fleet trace collector."""
    from .peers import PeerTable
    from .router import FleetRouter

    peers = [p.strip() for p in settings.fleet_peers.split(",")
             if p.strip()]
    table = PeerTable(
        peers=peers, dns=settings.fleet_dns,
        probe_seconds=settings.fleet_probe_seconds,
        backoff_seconds=settings.fleet_eject_backoff_seconds,
        backoff_max=settings.fleet_eject_backoff_max,
        probe_timeout=settings.fleet_proxy_timeout_seconds,
        metrics=metrics).start()
    return FleetRouter(
        table, policy=settings.fleet_policy, metrics=metrics,
        proxy_timeout=settings.fleet_proxy_timeout_seconds,
        stream_timeout=settings.stream_deadline_seconds,
        max_spills=settings.fleet_max_spills,
        fresh_seconds=settings.migrate_fresh_seconds,
        tracer=tracer)


def run_router(host: str, port: int) -> None:
    """``LFKT_FLEET_ROLE=router`` entry point (server/__main__.py): build
    the peer table + router from settings and serve until SIGTERM.  No
    engine, no torch — the router is a placement process."""
    import asyncio

    from ...obs.flightrec import FLIGHTREC
    from ...obs.trace import TRACER
    from ...utils.config import get_settings
    from ...utils.metrics import Metrics

    settings = get_settings()
    # the process-wide tracer honours LFKT_TRACE_SAMPLE/LFKT_TRACE_RING;
    # incident bundles recorded by the router carry its fleet identity
    router = build_router(settings, metrics=Metrics(), tracer=TRACER)
    FLIGHTREC.install(fleet=lambda: {
        "role": "router",
        "policy": router.policy,
        "peers": router.peers.snapshot()})
    asyncio.run(router.serve(host, port))

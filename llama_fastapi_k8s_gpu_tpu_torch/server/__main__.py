"""``python -m llama_fastapi_k8s_gpu_tpu_torch.server`` — run the service.

Serves the app on the in-tree ``httpd`` (the GPU image carries no uvicorn)
in one process: the model loads once, onto the GPU, so there is exactly one
worker (``LFKT_WORKERS`` other than 1 is refused before anything loads).
``LFKT_HOST`` / ``LFKT_PORT`` choose the address, ``LFKT_MODEL_DIR`` /
``LFKT_MODEL_NAME`` the GGUF.  Log lines are JSON objects stamped with the
request id unless ``LFKT_JSON_LOGS=0``.  On SIGTERM the pod drains: the
watchdog stops first, so no trip fails a request that is finishing, and a
prefill tier (``LFKT_DISAGG_ROLE=prefill``) stops taking new page-wire peers;
after the in-flight requests finish, a migrating replica (``LFKT_MIGRATE=1``)
hands its hottest conversations to their successors (server/httpd.py).

``LFKT_FLEET_ROLE=router`` runs the fleet router (serving/fleet/) instead:
no app, no engine and no torch are loaded; any other role but ``off`` is
refused.
"""

import functools
import logging


def stop_watchdog(app) -> None:
    """The drain hook: stop ``app``'s engine watchdog, if it runs one, and
    close a prefill tier's page-service listener (in-flight transfers
    finish; decode replicas re-resolving the service land on a live pod)."""
    watchdog = app.state.watchdog
    if watchdog is not None:
        watchdog.stop()
    disagg = app.state.disagg
    if disagg is not None and disagg.server is not None:
        disagg.server.stop_accepting()


def main():
    from ..utils.config import get_settings, knob

    # the reference scales with `gunicorn -w N`; here a worker is a process
    # that loads the model onto the card, so N workers would hold N copies
    # of the weights on one card.  Refused before anything loads
    workers = knob("LFKT_WORKERS")
    if workers != 1:
        raise SystemExit(
            f"LFKT_WORKERS={workers} refused: one worker per process is "
            "load-bearing (the model loads once per process, onto the "
            "card). Scale within a card with LFKT_BATCH_SIZE lanes; "
            "across processes by ROLE, not by copy: LFKT_DISAGG_ROLE="
            "prefill|decode splits prefill and decode into cooperating "
            "processes streaming KV pages; across cards and hosts with k8s "
            "replicas (helm-gpu/ replicaCount) behind the fleet router "
            "(LFKT_FLEET_ROLE=router).")
    logging.basicConfig(level=logging.INFO)
    settings = get_settings()
    if settings.json_logs:
        from ..obs.logctx import setup_json_logging

        root = logging.getLogger()
        for h in list(root.handlers):   # replace basicConfig's text handler
            root.removeHandler(h)
        setup_json_logging()
    # the fleet router is a placement process: decided before anything
    # imports the app, the engine or torch
    if settings.fleet_role == "router":
        from ..serving.fleet import run_router

        run_router(settings.host, settings.port)
        return
    if settings.fleet_role != "off":
        from ..serving.fleet import FLEET_ROLES

        raise SystemExit(
            f"LFKT_FLEET_ROLE must be one of {'|'.join(FLEET_ROLES)}, "
            f"got {settings.fleet_role!r}: replicas stay role=off; only the "
            "router process changes type (docs/RUNBOOK.md 'Running a "
            "replica fleet')")
    from .app import create_app
    from .httpd import run

    app = create_app(settings=settings)
    run(app, settings.host, settings.port,
        on_drain=functools.partial(stop_watchdog, app))


if __name__ == "__main__":
    main()

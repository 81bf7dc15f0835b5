"""``python -m llama_fastapi_k8s_gpu_tpu_torch.server`` — run the service.

Serves the app on the in-tree ``httpd`` (the GPU image carries no uvicorn)
in one process: the model loads once, onto the GPU, so there is exactly one
worker.  ``LFKT_HOST`` / ``LFKT_PORT`` choose the address, ``LFKT_MODEL_DIR``
/ ``LFKT_MODEL_NAME`` the GGUF.  Log lines are JSON objects stamped with the
request id unless ``LFKT_JSON_LOGS=0``.  On SIGTERM the pod drains: the
watchdog stops first, so no trip fails a request that is finishing, and a
prefill tier (``LFKT_DISAGG_ROLE=prefill``) stops taking new page-wire peers.
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
    from ..utils.config import get_settings
    from .app import create_app
    from .httpd import run

    logging.basicConfig(level=logging.INFO)
    settings = get_settings()
    if settings.json_logs:
        from ..obs.logctx import setup_json_logging

        root = logging.getLogger()
        for h in list(root.handlers):   # replace basicConfig's text handler
            root.removeHandler(h)
        setup_json_logging()
    app = create_app(settings=settings)
    run(app, settings.host, settings.port,
        on_drain=functools.partial(stop_watchdog, app))


if __name__ == "__main__":
    main()

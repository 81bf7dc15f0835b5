"""``python -m llama_fastapi_k8s_gpu_tpu_torch.tools.cpu_replica`` — one
serving replica whose engine runs on the CPU, for the drills.

The same process as ``python -m llama_fastapi_k8s_gpu_tpu_torch.server``,
read from the same ``LFKT_*`` env (the model, the paged pool, migration,
``LFKT_MODELS``, ``LFKT_FAULTS``), on the in-tree httpd with the same SIGTERM
drain, but its engines (live reloads' too) are built on the CPU.  The server
itself has no CPU switch: a pod serves on the card.  ``chaos_drill --device
cpu`` starts two of these.
"""

from __future__ import annotations

import functools
import logging


def main() -> None:
    from ..server.__main__ import stop_watchdog
    from ..server.app import _default_engine_factory, create_app
    from ..server.httpd import run
    from ..utils.config import get_settings

    logging.basicConfig(level=logging.INFO)
    settings = get_settings()
    app = create_app(settings=settings,
                     engine_factory=_default_engine_factory(settings, device="cpu"))
    run(app, settings.host, settings.port,
        on_drain=functools.partial(stop_watchdog, app))


if __name__ == "__main__":
    main()

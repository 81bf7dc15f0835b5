"""``python -m llama_fastapi_k8s_gpu_tpu_torch.server`` — run the service.

Serves the app on the in-tree ``httpd`` (the GPU image carries no uvicorn)
in one process: the model loads once, onto the GPU, so there is exactly one
worker.  ``LFKT_HOST`` / ``LFKT_PORT`` choose the address, ``LFKT_MODEL_DIR``
/ ``LFKT_MODEL_NAME`` the GGUF.
"""

import logging


def main():
    from ..utils.config import get_settings
    from .app import create_app
    from .httpd import run

    logging.basicConfig(level=logging.INFO)
    settings = get_settings()
    run(create_app(settings=settings), settings.host, settings.port)


if __name__ == "__main__":
    main()

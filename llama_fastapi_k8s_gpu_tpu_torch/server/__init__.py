"""HTTP serving layer: the ``/response`` app, its ASGI kit and the httpd.

Imports nothing: ``python -m llama_fastapi_k8s_gpu_tpu_torch.server`` with
``LFKT_FLEET_ROLE=router`` runs the fleet router, which must not load the
app, the engine or torch."""

"""HTTP serving layer: the ``/response`` app, its ASGI kit and the httpd."""

"""Inference engines (the serial ``Engine`` so far)."""

from .engine import Engine  # noqa: F401

"""Inference engines: the serial ``Engine``, the cycle scheduler's
``MeshEngine`` and the continuous scheduler's ``ContinuousEngine``."""

from .batched import MeshEngine  # noqa: F401
from .continuous import AdmissionController, ContinuousEngine  # noqa: F401
from .engine import Engine  # noqa: F401

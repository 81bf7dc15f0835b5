"""Inference engines: the serial ``Engine``, the cycle scheduler's
``MeshEngine``, the continuous scheduler's ``ContinuousEngine`` and the
sequence-parallel ``SPEngine``."""

from .batched import MeshEngine  # noqa: F401
from .continuous import AdmissionController, ContinuousEngine  # noqa: F401
from .engine import Engine  # noqa: F401
from .sp import SPEngine  # noqa: F401

"""Multi-model serving (``manifest``, ``registry``) and the disaggregated
prefill/decode tier (``serving/disagg/``, imported lazily by server/app.py,
never here: a wire-only consumer must not pay the registry's imports)."""

from .manifest import OVERRIDE_KEYS, ModelSpec, parse_manifest, pick_default  # noqa: F401
from .registry import ModelRegistry, UnknownModelError, WeightBudgetError  # noqa: F401

"""The Llama model: config, weights, forward pass and generation."""

from .config import LLAMA3_8B, ModelConfig  # noqa: F401

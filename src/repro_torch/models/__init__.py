"""The LM stack of the port (dense family): port of ``src/repro/models``."""
from .layers import ModelConfig
from .registry import ModelApi, get_model

__all__ = ["ModelApi", "ModelConfig", "get_model"]

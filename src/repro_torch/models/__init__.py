"""Model families (decoder LM, encoder-decoder, hybrid, SSM), their
layers, and ``build_model``."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]

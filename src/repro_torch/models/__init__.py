"""Model families (decoder LM, encoder-decoder, hybrid, SSM), their
layers, ``build_model``, and ``graph_decode_step`` (the decode step as
captured CUDA graphs)."""

from .graphs import graph_decode_step
from .model import Model, build_model

__all__ = ["Model", "build_model", "graph_decode_step"]

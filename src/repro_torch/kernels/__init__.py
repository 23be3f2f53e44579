"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
their plain PyTorch versions, and the device-dispatching entry points
(``ops.py``).  Nothing is built or loaded at import time."""

from .ops import paged_attention
from .ref import paged_attention_ref
from .kv_append import kv_append_cuda

__all__ = ["paged_attention", "paged_attention_ref", "kv_append_cuda"]

"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
their plain PyTorch versions, and the device-dispatching entry points
(``ops.py``).  Nothing is built or loaded at import time."""

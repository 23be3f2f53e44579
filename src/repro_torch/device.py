"""Device selection for every entry point of the port.

Entry points run on the card: ``device=None`` means ``"cuda"``, and with no
GPU present that is an error, never a silent fall back to the CPU.  Tests
and CPU parity runs pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev

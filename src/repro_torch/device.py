"""Device selection for every entry point of the port, and the one way it
reads a small tensor back to the host.

Entry points run on the card: ``device=None`` means ``"cuda"``, and with no
GPU present that is an error, never a silent fall back to the CPU.  Tests
and CPU parity runs pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

from repro_torch.spans import current_span


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def host_list(t: torch.Tensor) -> list:
    """``t.tolist()``, read without pageable memory on a card: a copy into
    pinned memory and a wait for the current stream.  A copy to pageable
    memory (``.tolist()``, ``.cpu()``) waits inside the CUDA driver, where
    it holds up every other thread's CUDA calls until this stream's work
    ends — behind a fleet replica stalled on the card, every replica; a
    stream's wait holds up nothing but its caller.

    Each read is a ``device.read`` span of the tracer whose span is open
    innermost on this thread, where one is (``spans.py``)."""
    with current_span("device.read"):
        if t.device.type != "cuda":
            return t.tolist()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host.tolist()

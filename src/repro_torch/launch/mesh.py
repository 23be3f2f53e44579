"""The tensor-parallel serving mesh of the port.

The port of ``repro.launch.mesh.make_serving_mesh``.  A JAX serving mesh is
a ``('data', 'model')`` mesh of ``(1, tp)`` devices run by one controller;
its counterpart here is an ordered tuple of shard devices that one host
thread drives: shard ``s`` holds its slices of the weights and its slab of
the KV arena on ``devices[s]``, the host enqueues every shard's work, and
what the JAX mesh keeps replicated (the page pool, block tables, per-slot
state) lives once, on the first device (``lead``).

A device may repeat only when the caller names it so: ``devices=["cuda:0",
"cuda:0"]`` lays two shards out on one card (each launch and each slab is
still per shard), and ``["cpu", "cpu"]`` is the CPU tests' counterpart of
the reference's forced host devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ServingMesh(NamedTuple):
    """``tp`` shard devices in order; ``lead`` (the first) holds the
    replicated state and the residual stream."""

    devices: tuple[torch.device, ...]
    tp: int

    @property
    def lead(self) -> torch.device:
        """The first shard's device."""
        return self.devices[0]

    def replicate(self, t: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``t`` on every shard's device: the tensor itself where it already
        lies there, else a device-to-device copy queued without a host
        sync."""
        return tuple(t.to(d, non_blocking=True) for d in self.devices)


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available for shard {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_serving_mesh(tp: int, devices=None) -> ServingMesh:
    """The first ``tp`` of ``devices`` (default ``cuda:0`` … ``cuda:tp-1``)
    as a serving mesh.  Raises ``RuntimeError`` when fewer devices exist."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tensor_parallel must be >= 1, got {tp}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp:
            raise RuntimeError(
                f"tensor_parallel={tp} needs {tp} devices; have {have} CUDA "
                f"devices (pass devices=[...] to name them)")
        devices = [f"cuda:{i}" for i in range(tp)]
    devs = [_device(d) for d in devices]
    if len(devs) < tp:
        raise RuntimeError(
            f"tensor_parallel={tp} needs {tp} devices; have {len(devs)}")
    devs = devs[:tp]
    missing = [d for d in devs
               if d.type == "cuda" and d.index >= torch.cuda.device_count()]
    if missing:
        raise RuntimeError(
            f"tensor_parallel={tp}: no device {missing[0]}; have "
            f"{torch.cuda.device_count()} CUDA devices")
    return ServingMesh(tuple(devs), tp)

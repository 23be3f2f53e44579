"""Meshes of the port: the abstract production meshes of the dry run and the
tensor-parallel serving mesh.

The port of ``repro.launch.mesh``.  :func:`make_production_mesh` and
:func:`make_smoke_mesh` give an :class:`AbstractMesh`: axis names and
sizes, no devices — what the sharding rules (``sharding/rules.py``) and
the dry run (``launch/dryrun.py``) read, as they read a jax ``Mesh``'s
``.shape``; the dry run touches no device, so the reference's 512 forced
host devices have no counterpart.  ``_make_mesh`` and ``mesh_context``
(jax-version shims) have none either.

:func:`make_serving_mesh` is the port of ``make_serving_mesh``.  A JAX
serving mesh is
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

import math
from typing import NamedTuple

import torch


class AbstractMesh(NamedTuple):
    """A mesh without devices: ``shape`` maps each axis name, in order, to
    its size (jax's ``Mesh.shape``)."""

    shape: dict

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        """The device count."""
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16,16) 'data' x 'model' single pod; (2,16,16) 'pod' x 'data' x
    'model' across two pods (512 chips)."""
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return AbstractMesh({"data": 16, "model": 16})


def make_smoke_mesh(shape=(2, 2), axes=("data", "model")) -> AbstractMesh:
    """A small mesh of the same axes, for tests."""
    return AbstractMesh(dict(zip(axes, shape)))


class ServingMesh(NamedTuple):
    """``tp`` shard devices in order; ``lead`` (the first) holds the
    replicated state and the residual stream.  ``moe_shard`` is the expert
    layout the weights were cut by (``REPRO_MOE_SHARD``,
    ``sharding/rules.py``)."""

    devices: tuple[torch.device, ...]
    tp: int
    moe_shard: str = "tp"

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


def make_serving_mesh(tp: int, devices=None,
                      moe_shard: str = "tp") -> ServingMesh:
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
    return ServingMesh(tuple(devs), tp, moe_shard)

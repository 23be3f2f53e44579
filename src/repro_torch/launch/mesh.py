"""Meshes of the port: the abstract production meshes of the dry run, the
device meshes of the sharded step, and the tensor-parallel serving mesh.

The port of ``repro.launch.mesh``.  :func:`make_production_mesh` and
:func:`make_smoke_mesh` give an :class:`AbstractMesh`: axis names and
sizes, no devices — what the sharding rules (``sharding/rules.py``) read,
as they read a jax ``Mesh``'s ``.shape``.

:func:`make_device_mesh` is the port of the device-backed meshes: a
``torch.distributed`` ``DeviceMesh`` over the default process group, one
rank per device, with the reference's axis names (``("data", "model")``
or ``("pod", "data", "model")``).  The process group comes first
(:func:`init_distributed`: NCCL on the card, gloo on the CPU, given its
address, rank and world size; nothing on a machine announces a cluster).
:func:`mesh_context` is the port of ``jax.set_mesh``: the annotations of
``sharding/rules.py`` read the mesh it sets (:func:`current_mesh`), and
inside it a plain tensor that meets a DTensor counts as replicated (every
rank makes the same ``arange`` and masks; DTensor's
``implicit_replication``).  The reference's ``_make_mesh`` shim has no
counterpart.  The dry run's mesh of 256 or 512 ranks is a fake process
group (``launch/abstract.py::fake_world``).

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

import contextlib
import math
from typing import NamedTuple

import torch
import torch.distributed as dist


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


def init_distributed(*, rank: int, world_size: int, device_type: str = "cuda",
                     address: str = "localhost", port: int = 29500) -> None:
    """Join the default process group: NCCL for ``"cuda"`` (rank r on
    ``cuda:r``), gloo for ``"cpu"``, at ``tcp://address:port``."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device_type='cuda'): no CUDA "
                               "device is available")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    dist.init_process_group(backend, init_method=f"tcp://{address}:{port}",
                            rank=rank, world_size=world_size)


def make_device_mesh(shape, axes=("data", "model"), *,
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, its
    dims named ``axes``.  Raises ``RuntimeError`` when the world size is
    not ``prod(shape)``, and when ``"cuda"`` is asked for and no card is
    present (never a fall back to the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_device_mesh(device_type='cuda'): no CUDA "
                           "device is available")
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: no process group; call "
                           "init_distributed first")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(
            f"mesh {shape} needs {math.prod(shape)} ranks; the process group "
            f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


_MESHES: list = []


def current_mesh():
    """The mesh :func:`mesh_context` set, or None."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh (the port of ``jax.set_mesh``): the
    sharding annotations act on DTensors under it; plain tensors meeting a
    DTensor count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    _MESHES.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()


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

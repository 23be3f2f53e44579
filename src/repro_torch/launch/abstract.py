"""Shapes without memory: the port's counterpart of ``jax.eval_shape``.

Under torch's ``FakeTensorMode`` every tensor carries its shape, dtype and
device and no storage, and every op computes only those: a model's
parameters, its optimizer state, caches and whole steps run at the
production shapes (qwen2-72b's 72.7 B parameters) without allocating.
The seeded draws of ``init`` run on a CPU generator, which the mode
accepts.  Tensors of one mode meet only tensors of the same mode: make a
cell's parameters, batch and cache under one (:func:`fake_mode`) and run
its step under it too.  The dry run (``launch/dryrun.py``), the roofline
(``launch/roofline.py``) and the sharding tests read these.

:func:`fake_world` is the counterpart of the reference's 512 forced host
devices: a process group of the production mesh's size in which this
process is rank 0 and every collective returns at once, so a sharded step
(``launch/steps.py::sharded``) runs one rank's share on fake tensors and
issues its collectives, which ``launch/op_analysis.py`` counts.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import build_model


def fake_mode(allow_non_fake_inputs: bool = False) -> FakeTensorMode:
    """A new mode; what is made under it stays out of memory.  A sharded
    step needs ``allow_non_fake_inputs``: DTensor reads its mesh's real
    table of ranks under the mode."""
    return FakeTensorMode(allow_non_fake_inputs=allow_non_fake_inputs)


def abstract_params(cfg, mode: FakeTensorMode, dtype=torch.bfloat16):
    """The family's parameter module (``build_model(cfg).init``) as fake
    tensors under ``mode``, in ``dtype`` (the float32 leaves float32, as
    ``init`` keeps them)."""
    with mode:
        return build_model(cfg).init(dtype=dtype, device="cpu")


def abstract_cache(cfg, batch_size: int, cache_size: int,
                   mode: FakeTensorMode) -> dict:
    """The family's decode cache as fake tensors under ``mode``."""
    with mode:
        return build_model(cfg).init_cache(batch_size, cache_size,
                                           device="cpu")


def abstract_opt_state(params, mode: FakeTensorMode) -> dict:
    """AdamW's state (``optim.adamw_init``) for ``params`` under ``mode``."""
    from repro_torch.optim import adamw_init

    with mode:
        return adamw_init(params)


@contextlib.contextmanager
def _index_math_on_real_tensors():
    """DTensor computes where a strided shard (two sharded dims flattened
    into one, as ``x @ w`` does to a [B, S, d] residual sharded on B and S)
    starts with ``torch.arange(...).tolist()``; under ``FakeTensorMode``
    that tensor is fake and has no values.  For the block, that one method
    runs with the mode unset, and uncounted.  The class and the method are
    DTensor's own, private: a PyTorch without them raises."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    from repro_torch.launch.op_analysis import muted

    cls = getattr(placement_types, "_StridedShard", None)
    fn = None if cls is None else cls.__dict__.get(
        "local_shard_size_and_offset")
    if not callable(fn):
        raise RuntimeError(
            f"fake_world: PyTorch {torch.__version__} has no "
            f"_StridedShard.local_shard_size_and_offset to run on real "
            f"tensors")

    def real(self, *args, **kwargs):
        with unset_fake_temporarily(), muted():
            return fn(self, *args, **kwargs)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = fn


@contextlib.contextmanager
def fake_world(world_size: int):
    """The default process group, for the block, as ``world_size`` ranks of
    the ``"fake"`` backend, this process rank 0.  The backend's store lives
    in ``torch.testing._internal`` (PyTorch's own distributed tests): its
    only public home, imported here and nowhere else."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        with _index_math_on_real_tensors():
            yield
    finally:
        dist.destroy_process_group()

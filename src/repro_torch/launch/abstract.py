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
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.models import build_model


def fake_mode() -> FakeTensorMode:
    """A new mode; what is made under it stays out of memory."""
    return FakeTensorMode()


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

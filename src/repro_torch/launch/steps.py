"""Step functions composed from model + optimizer (the port of
``repro.launch.steps``)."""

from __future__ import annotations

import torch

from repro_torch.optim import AdamWConfig, adamw_update


def make_train_step(model, opt_cfg: AdamWConfig, *, grad_compression: str = "none"):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the model's module with gradients on
    (``requires_grad_(True)``); it and ``opt_state`` are updated in place
    and returned.  A parameter the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives it.  ``grad_compression='bf16'`` casts
    the gradients to bf16 before the update, as the reference does ahead
    of its data-parallel all-reduce (the error stays in the float32
    moments).  The metrics are device tensors: reading one is the caller's
    host transfer.
    """

    def step(params, opt_state, batch):
        loss, metrics = model.loss(params, batch)
        names, leaves = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        if grad_compression == "bf16":
            grads = [g.to(torch.bfloat16) for g in grads]
        params, opt_state, info = adamw_update(
            opt_cfg, params, dict(zip(names, grads)), opt_state)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **info}
        return params, opt_state, out

    return step


def make_prefill_step(model, cache_size: int):
    def step(params, batch):
        return model.prefill(params, batch, cache_size)

    return step


def make_decode_step(model):
    def step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return step

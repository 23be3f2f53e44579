"""Step functions composed from model + optimizer (the port of
``repro.launch.steps``), and :func:`sharded`, the port of
``jax.jit(step, in_shardings=..., out_shardings=...)`` on a named mesh.

A sharded step runs the same Python step on every rank of a
``DeviceMesh`` (``launch/mesh.py::make_device_mesh``) over DTensors: the
arguments placed by the reference's specs (``sharding/rules.py``), the
model's annotations redistributing under ``mesh_context``, DTensor's
sharding rules deciding each op's collectives, the outputs redistributed
to their specs.  :func:`step_specs` gives a cell's specs as the
reference's ``lower_cell`` passes them (``launch/dryrun.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.launch.mesh import mesh_context
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.sharding import rules


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


def place_tree(tree, specs, mesh):
    """``tree`` (nested dicts, tuples and lists of tensors and modules)
    placed on ``mesh`` by ``specs`` of the same structure: a module's specs
    a dict by parameter name (its parameters replaced in place, see
    ``rules.place_module``), a tensor's a spec tuple; a spec of None
    replicates a tensor, and leaves a non-tensor as it is."""
    if isinstance(tree, nn.Module):
        return rules.place_module(tree, mesh, specs)
    if isinstance(tree, dict):
        return {k: place_tree(v, None if specs is None else specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, None if specs is None else s, mesh)
                          for v, s in zip(tree, specs or [None] * len(tree)))
    if not isinstance(tree, torch.Tensor):
        return tree
    spec = (None,) * tree.ndim if specs is None else specs
    return rules.place(tree, mesh, rules.placements(spec, mesh))


def sharded(step, mesh, in_specs, out_specs):
    """``step`` over ``mesh``: each argument placed by its entry of
    ``in_specs`` (:func:`place_tree`: a tensor not yet placed is cut, a
    DTensor redistributed), the step run under ``mesh_context(mesh)``, each
    output redistributed to its entry of ``out_specs`` (None: replicated,
    as a metric comes out).  Every rank of the mesh's group calls it with
    the same arguments."""

    def run(*args):
        args = tuple(place_tree(a, s, mesh) for a, s in zip(args, in_specs))
        with mesh_context(mesh):
            return place_tree(step(*args), out_specs, mesh)

    return run


def step_specs(cfg, kind: str, mesh, params, batch, cache_size=None):
    """(in_specs, out_specs) of the ``kind`` step (``"train"``,
    ``"prefill"``, ``"decode"``) on ``mesh``, as the reference's
    ``lower_cell`` passes them: parameters by ``param_specs`` (the serving
    specs for decode), AdamW state by ``opt_specs``, the batch by
    ``batch_specs``, caches by ``cache_specs``; metrics and logits
    replicated.  Specs are in the port's layout (a module's by parameter
    name, ``rules.module_specs``); ``cache_size`` sizes the cache of
    prefill and decode."""
    pspec = rules.module_specs(rules.param_specs(
        cfg, params, mesh, serving=(kind == "decode")), params, mesh)
    bspec = rules.batch_specs(cfg, batch, mesh)
    if kind == "train":
        moments = rules.module_specs(rules.opt_specs(cfg, params, mesh)["m"],
                                     params, mesh)
        ospec = {"m": moments, "v": moments, "step": ()}
        return (pspec, ospec, bspec), (pspec, ospec, None)
    rows = next(iter(batch.values())).shape[0]
    cache = build_model(cfg).init_cache(rows, cache_size, device="meta")
    cspec = rules.cache_specs(cfg, cache, mesh)
    if kind == "prefill":
        return (pspec, bspec), (cspec, None)
    return (pspec, cspec, bspec), (None, cspec)

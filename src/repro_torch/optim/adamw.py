"""In-house AdamW with global-norm clipping and cosine schedule.

The port of ``repro.optim.adamw``.  The state mirrors the parameters by
name (``module.named_parameters()``, or a dict of tensors): float32
moments ``m`` and ``v`` and an int32 ``step``, all on the parameters'
device.  The learning rate, the clip scale and the bias corrections are
float32 tensors on that device, computed in the reference's order, so an
update reads nothing back to the host and does no float64 arithmetic.
The update is plain tensor ops, as the reference's is jnp (no kernel of
the repository).

Unlike the reference's, which returns new trees, :func:`adamw_update`
writes the new parameters and moments into the tensors it is given (no
second copy of a 1B model's float32 moments) and returns them.

On DTensors (the sharded step, ``launch/steps.py::sharded``) the moments
keep their own placements (``sharding/rules.py::opt_specs``, ZeRO-1):
each gradient is redistributed to its moment's placement first — the
reduce-scatter (or all-reduce) that GSPMD inserts — so the global norm is
a sum of each rank's share, one replicated scalar, and the new parameter
is computed in the moment's placement and redistributed back to the
parameter's (the all-gather).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _named(params) -> dict:
    """name -> tensor of a module's parameters, or a dict as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to 0, float32 (``step`` an int
    tensor or a number)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1.0 + torch.cos(math.pi * t)))


def adamw_init(params) -> dict:
    """Zero float32 moments per parameter (placed as it is) and step 0."""
    named = _named(params)
    zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = next(iter(named.values())).device
    return {"m": {n: zeros32(p) for n, p in named.items()},
            "v": {n: zeros32(p) for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum of squares of every tensor (a dict's values or an
    iterable), in float32.  DTensor leaves sum by placements first (each
    group's sum one scalar, partial over the mesh dims the group shards),
    then the groups' sums, reduced, add up: one replicated scalar."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    squares = (torch.sum(torch.square(x.float())) for x in leaves)
    groups = {}
    for sq in squares:
        key = tuple(sq.placements) if isinstance(sq, DTensor) else None
        groups[key] = sq if key not in groups else groups[key] + sq
    total = None
    for key, sq in groups.items():
        if key is not None:
            sq = sq.redistribute(sq.device_mesh,
                                 [Replicate()] * sq.device_mesh.ndim)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _placed_like(t, ref):
    """``t`` in ``ref``'s placements where both are DTensors, else ``t``."""
    if isinstance(ref, DTensor) and isinstance(t, DTensor) and \
            tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads: dict, state: dict):
    """One step over ``params`` (a module or a dict of tensors) with
    ``grads`` (name -> gradient, any float dtype) -> (params, state,
    {"grad_norm", "lr"}).  Parameters keep their dtype; the moments stay
    float32.  Parameters and moments are updated in place."""
    named = _named(params)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    grads = {n: _placed_like(grads[n], state["m"][n]) for n in named}
    gnorm = global_norm(grads[n] for n in named)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-6), max=1.0)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    for n, p in named.items():
        g = grads[n].float() * scale
        m, v = state["m"][n], state["v"][n]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        p32 = _placed_like(p, m).float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(_placed_like(p32 - lr * delta, p))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}

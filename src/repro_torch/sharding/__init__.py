"""Sharding rules (``rules.py``): the reference's specs for parameters,
optimizer state, batches and caches, as DTensor placements on a device
mesh for the sharded step and its annotations, and the serving cut of a
decoder LM's weights and paged KV arena over a serving mesh.  ``to_placed``
is the reference's ``to_named``."""

from .rules import (
    param_specs,
    opt_specs,
    batch_specs,
    cache_specs,
    dp_axes_for,
    constrain,
    to_placed,
)

__all__ = [
    "param_specs",
    "opt_specs",
    "batch_specs",
    "cache_specs",
    "dp_axes_for",
    "constrain",
    "to_placed",
]

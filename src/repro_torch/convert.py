"""The weight bridge: the JAX package's parameter pytree -> the port's.

The reference's ``init_decoder_lm`` returns nested dicts whose ``blocks``
entry holds every per-layer leaf stacked on a leading L axis.  Handed over
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``),
:func:`params_from_jax` splits ``blocks`` into L per-layer dicts and casts
every leaf through float32 to ``dtype`` on ``device``, except the MoE
router ``w_router``, which stays float32 as the reference keeps it
whatever the model's dtype.  The float32 step
is exact for bf16 leaves (``np.asarray(x, np.float32)`` reads ml_dtypes
bfloat16 arrays without importing ml_dtypes), so a bf16 -> bf16 bridge is
bit-exact.  Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecoderLM


#: leaves kept float32 whatever the model's dtype
FLOAT32_LEAVES = frozenset({"w_router"})


def _leaf(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        dtype=dtype, device=device)


def _tree(d, dtype, device):
    return {k: _tree(v, dtype, device) if isinstance(v, dict)
            else _leaf(v, torch.float32 if k in FLOAT32_LEAVES else dtype,
                       device) for k, v in d.items()}


def _layer(d, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in d.items()}


def params_from_jax(cfg, tree: dict, dtype=torch.bfloat16, device=None) -> dict:
    """Nested numpy dicts (blocks stacked on L) -> the port's nested tensor
    dicts (blocks a list of L per-layer dicts)."""
    dev = resolve_device(device)
    out = {k: _tree(v, dtype, dev) if isinstance(v, dict) else _leaf(v, dtype, dev)
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_tree(_layer(tree["blocks"], i), dtype, dev)
                     for i in range(cfg.n_layers)]
    return out


def model_from_jax(cfg, tree: dict, dtype=torch.bfloat16, device=None) -> DecoderLM:
    """:func:`params_from_jax` wrapped in the port's :class:`DecoderLM`."""
    return DecoderLM(cfg, params_from_jax(cfg, tree, dtype, device))

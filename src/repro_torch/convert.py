"""The weight bridge: the JAX package's parameter pytree -> the port's.

The reference's ``init_*`` functions return nested dicts whose stacked
groups hold every per-layer leaf on a leading axis: ``blocks`` (every
family), ``enc_blocks`` (whisper's encoder), ``groups`` (RecurrentGemma's
rec, rec, attn groups, each entry a nested dict) and ``tail`` (its
trailing recurrent layers).  Handed over as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), :func:`params_from_jax` splits
each stacked group into a list of per-layer dicts, copies the other
entries (``embed``, the norms, and the top-level ``enc_pos`` and
``lm_head``) as they are, and casts every leaf through float32 to
``dtype`` on ``device`` — except :data:`FLOAT32_LEAVES`, which stay
float32 as the reference keeps them whatever the model's dtype: the MoE
router, and the SSM decay, skip and step bias and the RG-LRU gate, which
in bf16 would change the recurrences.  The float32 step is exact for bf16
leaves (``np.asarray(x, np.float32)`` reads ml_dtypes bfloat16 arrays
without importing ml_dtypes), so a bf16 -> bf16 bridge is bit-exact.
Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import STACKED, lm_class


#: leaves kept float32 whatever the model's dtype
FLOAT32_LEAVES = frozenset({"w_router", "A_log", "D", "dt_bias", "lam"})


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


def _depth(d) -> int:
    """The leading (stacked) axis of a stacked group's leaves."""
    v = next(iter(d.values()))
    return _depth(v) if isinstance(v, dict) else len(v)


def params_from_jax(cfg, tree: dict, dtype=torch.bfloat16, device=None) -> dict:
    """Nested numpy dicts (stacked groups on their leading axis) -> the
    port's nested tensor dicts (each stacked group a list of per-layer
    dicts)."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k in STACKED:
            out[k] = [_tree(_layer(v, i), dtype, dev) for i in range(_depth(v))]
        elif isinstance(v, dict):
            out[k] = _tree(v, dtype, dev)
        else:
            out[k] = _leaf(v, dtype, dev)
    return out


def model_from_jax(cfg, tree: dict, dtype=torch.bfloat16, device=None):
    """:func:`params_from_jax` wrapped in the family's module
    (:class:`~repro_torch.models.transformer.DecoderLM`, ``EncDecLM``,
    ``HybridLM`` or ``SSMLM``)."""
    return lm_class(cfg)(cfg, params_from_jax(cfg, tree, dtype, device))

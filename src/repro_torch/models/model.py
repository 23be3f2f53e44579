"""Top-level model API: one object per architecture config.

The port of ``repro.models.model``'s inference half::

    model = build_model(cfg)
    params = model.init(seed, dtype, device)           # the family's module
    hidden, aux = model.forward(params, batch)         # teacher forcing
    cache, logits = model.prefill(params, batch, n)    # inference prefill
    logits, cache = model.decode_step(params, cache, b)
    cache = model.init_cache(batch_size, cache_size)

``params`` is the family's ``nn.Module`` (``models/transformer.py``), or
the weight bridge's (``convert.py::model_from_jax``).  ``forward`` is the
reference's ``fwd_eval``: for MoE the dropless dispatch, so it is the same
per-token function as prefill + decode_step.  The training objective
(``Model.loss`` and its chunked cross-entropy ``_chunked_ce``) ports with
training, where its gradient is held too (ROADMAP A.7).  Entry points run
on ``cuda`` unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import transformer as T


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable  # (seed=0, dtype=bf16, device=None) -> module
    forward: Callable  # (params, batch) -> (hidden [B,S,d], aux)
    prefill: Callable  # (params, batch, cache_size) -> (cache, logits)
    decode_step: Callable  # (params, cache, batch) -> (logits, cache)
    init_cache: Callable  # (batch_size, cache_size, device=None) -> cache


#: family -> (init, forward, prefill, decode_step, init_cache)
_FAMILIES = {
    "decoder": (T.init_decoder_lm, T.decoder_forward, T.decoder_prefill,
                T.decoder_decode_step, T.decoder_init_cache),
    "audio": (T.init_encdec, T.encdec_forward, T.encdec_prefill,
              T.encdec_decode_step, T.encdec_init_cache),
    "hybrid": (T.init_hybrid, T.hybrid_forward, T.hybrid_prefill,
               T.hybrid_decode_step, T.hybrid_init_cache),
    "ssm": (T.init_ssm_lm, T.ssm_forward, T.ssm_prefill, T.ssm_decode_step,
            T.ssm_init_cache),
}


def build_model(cfg) -> Model:
    """The config's family's entry points; an unknown family raises
    ``ValueError``, as the reference's does."""
    fam = "decoder" if cfg.family in T.DECODER_FAMILIES else cfg.family
    if fam not in _FAMILIES:
        raise ValueError(cfg.family)
    init, fwd, prefill, decode, init_cache = _FAMILIES[fam]
    cls = T.lm_class(cfg)

    def init_module(seed: int = 0, dtype=torch.bfloat16, device=None):
        return cls(cfg, init(cfg, seed, dtype, device))

    return Model(
        cfg=cfg,
        init=init_module,
        forward=lambda params, batch: fwd(cfg, params, batch),
        prefill=lambda params, batch, n: prefill(cfg, params, batch, n),
        decode_step=lambda params, cache, batch: decode(cfg, params, cache,
                                                        batch),
        init_cache=lambda bs, n, device=None: init_cache(cfg, bs, n,
                                                         device=device),
    )

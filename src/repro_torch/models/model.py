"""Top-level model API: one object per architecture config.

The port of ``repro.models.model``::

    model = build_model(cfg)
    params = model.init(seed, dtype, device)           # the family's module
    loss, metrics = model.loss(params, batch)          # training objective
    hidden, aux = model.forward(params, batch)         # teacher forcing
    cache, logits = model.prefill(params, batch, n)    # inference prefill
    logits, cache = model.decode_step(params, cache, b)
    cache = model.init_cache(batch_size, cache_size)

``params`` is the family's ``nn.Module`` (``models/transformer.py``), or
the weight bridge's (``convert.py::model_from_jax``).  ``forward`` is the
reference's ``fwd_eval``: for MoE the dropless dispatch, so it is the same
per-token function as prefill + decode_step; ``loss`` runs the
capacity-bounded forward, as the reference's does.

The loss computes cross-entropy in sequence chunks (:func:`_chunked_ce`),
each chunk's logits under ``torch.utils.checkpoint``, so the float32
[B, S, vocab] logits are never live at once, in the forward or the
backward.  Entry points run on ``cuda`` unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import rules
from . import transformer as T


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable  # (seed=0, dtype=bf16, device=None) -> module
    forward: Callable  # (params, batch) -> (hidden [B,S,d], aux)
    loss: Callable  # (params, batch) -> (loss, metrics)
    prefill: Callable  # (params, batch, cache_size) -> (cache, logits)
    decode_step: Callable  # (params, cache, batch) -> (logits, cache)
    init_cache: Callable  # (batch_size, cache_size, device=None) -> cache


def _gold(logits, lbl):
    """logits [B, c, V] at the labels [B, c]."""
    return torch.gather(logits, -1, lbl[..., None])[..., 0]


def _gold_local(logits, lbl):
    """:func:`_gold` of one rank's vocab slice: the labels it holds, 0 for
    the others (the slices' picks sum to the whole pick)."""
    V = logits.shape[-1]
    idx = lbl.long() - rules.model_rank() * V
    own = (idx >= 0) & (idx < V)
    return _gold(logits, torch.clamp(idx, 0, V - 1)) * own


def _ce_chunk(h, w, lbl, msk):
    """Summed masked NLL of one chunk: h [B, c, d] @ w in the model's
    dtype, then float32 over the (padded) vocabulary."""
    logits = rules.shard_logits(h @ w).float()
    if rules.sharded_on_mesh(logits):
        return _ce_chunk_sharded(logits, lbl, msk)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.sum((lse - _gold(logits, lbl)) * msk)


def _ce_chunk_sharded(logits, lbl, msk):
    """:func:`_ce_chunk` over vocab-sharded logits (``shard_logits``): each
    rank's slice gives its max, its sum of exponentials and its labels'
    logits, each reduced over 'model' explicitly (a partial max, then two
    partial sums), so every step of the log-sum-exp has one layout."""
    split = rules.model_sharded(logits, -1)
    ls, rs = rules.batch_spec(logits, 0, 2, split), rules.batch_spec(lbl)
    mesh = rules.current_mesh()
    red = ("model",) if split else ()
    m = rules.settle(rules.local(
        lambda t: t.detach().amax(dim=-1), (logits,), (ls,),
        rules.placements(rs, mesh, partial=red, reduce_op="max")))
    sums = rules.settle(rules.local(
        lambda t, m: torch.sum(torch.exp(t - m[..., None]), dim=-1),
        (logits, m), (ls, rs), rules.placements(rs, mesh, partial=red)))
    gold = rules.settle(rules.local(
        _gold_local if split else _gold, (logits, lbl), (ls, rs),
        rules.placements(rs, mesh, partial=red)))
    return torch.sum((m + torch.log(sums) - gold) * msk)


def _chunked_ce(cfg, params, hidden, labels, mask):
    """hidden [B,S,d], labels/mask [B,S] -> mean NLL over masked positions."""
    S = hidden.shape[1]
    chunk = min(cfg.loss_chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    w = params.embed["tok"].T if cfg.tie_embeddings else params.lm_head
    w = rules.shard_vocab(rules.gather_data(w))
    tot, cnt = None, torch.zeros((), device=hidden.device)
    for i in range(0, hidden.shape[1], chunk):
        args = (hidden[:, i:i + chunk], w, labels[:, i:i + chunk],
                mask[:, i:i + chunk])
        if torch.is_grad_enabled():  # recompute the logits in the backward
            nll = checkpoint(_ce_chunk, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            nll = _ce_chunk(*args)
        tot = nll if tot is None else tot + nll
        cnt = cnt + torch.sum(args[3])
    return rules.settle(tot / torch.clamp(cnt, min=1.0))


def _next_tokens(tokens):
    """Each position's next token [B, S] (0 after the last); under a mesh
    on each rank's rows (DTensor's padding rule is not one every PyTorch
    has right)."""
    shift = lambda t: F.pad(t[:, 1:].long(), (0, 1))
    if not rules.sharded_on_mesh(tokens):
        return shift(tokens)
    spec = rules.batch_spec(tokens)
    return rules.local(shift, (tokens,), (spec,), spec)


def _loss(cfg, fwd, params, batch):
    """The reference's ``loss_fn``: next-token cross-entropy (the last
    position masked; the VLM's on its text suffix only) plus
    ``moe_aux_coef`` times the aux loss -> (loss, {"ce", "aux"})."""
    hidden, aux = fwd(cfg, params, batch)
    tokens = batch["tokens"]
    if cfg.prefix_tokens:  # VLM: loss only on the text suffix
        hidden = hidden[:, batch["patches"].shape[1]:, :]
    labels = _next_tokens(tokens)
    mask = F.pad(torch.ones(tokens[:, 1:].shape, device=tokens.device),
                 (0, 1))
    ce = _chunked_ce(cfg, params, hidden, labels, mask)
    return ce + cfg.moe_aux_coef * aux, {"ce": ce, "aux": aux}


#: family -> (init, training forward, eval forward, prefill, decode_step,
#: init_cache); the eval forward is the reference's ``fwd_eval``
_FAMILIES = {
    "decoder": (T.init_decoder_lm, T.decoder_forward,
                functools.partial(T.decoder_forward, dropless=True),
                T.decoder_prefill, T.decoder_decode_step,
                T.decoder_init_cache),
    "audio": (T.init_encdec, T.encdec_forward, T.encdec_forward,
              T.encdec_prefill, T.encdec_decode_step, T.encdec_init_cache),
    "hybrid": (T.init_hybrid, T.hybrid_forward, T.hybrid_forward,
               T.hybrid_prefill, T.hybrid_decode_step, T.hybrid_init_cache),
    "ssm": (T.init_ssm_lm, T.ssm_forward, T.ssm_forward, T.ssm_prefill,
            T.ssm_decode_step, T.ssm_init_cache),
}


def build_model(cfg) -> Model:
    """The config's family's entry points; an unknown family raises
    ``ValueError``, as the reference's does."""
    fam = "decoder" if cfg.family in T.DECODER_FAMILIES else cfg.family
    if fam not in _FAMILIES:
        raise ValueError(cfg.family)
    init, fwd, fwd_eval, prefill, decode, init_cache = _FAMILIES[fam]
    cls = T.lm_class(cfg)

    def init_module(seed: int = 0, dtype=torch.bfloat16, device=None):
        return cls(cfg, init(cfg, seed, dtype, device))

    return Model(
        cfg=cfg,
        init=init_module,
        forward=lambda params, batch: fwd_eval(cfg, params, batch),
        loss=lambda params, batch: _loss(cfg, fwd, params, batch),
        prefill=lambda params, batch, n: prefill(cfg, params, batch, n),
        decode_step=lambda params, cache, batch: decode(cfg, params, cache,
                                                        batch),
        init_cache=lambda bs, n, device=None: init_cache(cfg, bs, n,
                                                         device=device),
    )

"""Decoder-LM assembly: embedding, unembedding, blocks, and the module.

The port of the dense decoder-LM part of ``repro.models.transformer``.  The
JAX package keeps parameters as a pytree with the blocks stacked on a
leading L axis and scans over them; here the model is an ``nn.Module``
whose blocks sit in a ``ModuleList`` (one Python loop over layers), and
every parameter keeps the reference's name and ``[in, out]`` layout:
``model.blocks[l].attn["wq"]`` is ``params["blocks"]["attn"]["wq"][l]``.
Parameters never require gradients: this slice serves, it does not train.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from .layers import _normal, init_attention, init_mlp, init_norm

# ===========================================================================
# Embedding / unembedding


def init_embed(cfg, gen, dtype=torch.bfloat16, device=None):
    """Token table (and learned positions when RoPE is off), std 0.02."""
    p = {"tok": _normal(gen, (cfg.vocab_padded, cfg.d_model), 0.02, dtype,
                        device)}
    if not cfg.use_rope:
        p["pos"] = _normal(gen, (cfg.max_seq, cfg.d_model), 0.02, dtype, device)
    return p


def embed_tokens(cfg, p, tokens, positions):
    """tokens [B, S] -> [B, S, d_model] (scaled / plus learned positions as
    the config says)."""
    x = p["tok"][tokens]
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if not cfg.use_rope:
        x = x + p["pos"][positions]
    return x


def unembed(cfg, model, x):
    """Hidden states -> logits through the tied table or ``lm_head``."""
    w = model.embed["tok"].T if cfg.tie_embeddings else model.lm_head
    return x @ w


# ===========================================================================
# Decoder-LM family (dense)


def init_decoder_block(cfg, gen, dtype=torch.bfloat16, device=None):
    """One block's parameters as nested dicts (ln1, attn, ln2, mlp)."""
    if cfg.moe:
        raise NotImplementedError("the port serves dense decoder LMs only")
    return {
        "ln1": init_norm(cfg, cfg.d_model, dtype, device),
        "attn": init_attention(cfg, gen, dtype, device),
        "ln2": init_norm(cfg, cfg.d_model, dtype, device),
        "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype, device=device),
    }


def init_decoder_lm(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """Seeded parameters with the reference's shapes and scales, as nested
    dicts with ``blocks`` a list of per-layer dicts.  The draw is made on
    ``device`` (a CUDA generator there), so the weights differ from the
    reference's ``jax.random`` ones: parity tests convert the reference's
    weights with :func:`repro_torch.convert.params_from_jax` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {
        "embed": init_embed(cfg, gen, dtype, dev),
        "blocks": [init_decoder_block(cfg, gen, dtype, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (cfg.d_model, cfg.vocab_padded), 0.02,
                                    dtype, dev)
    return params


def _pdict(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in d.items()})


class DecoderBlock(nn.Module):
    """One pre-norm decoder block's parameters: ln1, attn, ln2, mlp."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = _pdict(p["ln1"])
        self.attn = _pdict(p["attn"])
        self.ln2 = _pdict(p["ln2"])
        self.mlp = _pdict(p["mlp"])


class DecoderLM(nn.Module):
    """A dense decoder LM's parameters (see module docstring).  The serving
    step (``serving/paged_decode.py``) runs the math over these; the module
    holds no behaviour of its own beyond placement."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        if cfg.family != "dense" or cfg.moe:
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense decoder LMs only")
        self.cfg = cfg
        self.embed = _pdict(params["embed"])
        self.blocks = nn.ModuleList(DecoderBlock(b) for b in params["blocks"])
        self.final_norm = _pdict(params["final_norm"])
        self.lm_head = (nn.Parameter(params["lm_head"], requires_grad=False)
                        if "lm_head" in params else None)

    @property
    def device(self) -> torch.device:
        """Where the weights live."""
        return self.embed["tok"].device

    def tree(self) -> dict:
        """The parameters as the nested dicts the module is built from."""
        out = {"embed": dict(self.embed),
               "blocks": [{n: dict(getattr(b, n))
                           for n in ("ln1", "attn", "ln2", "mlp")}
                          for b in self.blocks],
               "final_norm": dict(self.final_norm)}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head
        return out

"""Decoder-LM assembly: embedding, unembedding, blocks, and the module.

The port of the decoder-LM part of ``repro.models.transformer`` (dense,
MoE and the prefix-VLM's text decoder: the paged serving path reads no
image patches, as the reference's does not).  The
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
from .moe import init_moe

#: the decoder-LM families the port serves (the reference's paged step's)
DECODER_FAMILIES = ("dense", "moe", "vlm")

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
# Decoder-LM family (dense / MoE / prefix-VLM)


def init_decoder_block(cfg, gen, dtype=torch.bfloat16, device=None):
    """One block's parameters as nested dicts: ln1, attn, ln2, and ``moe``
    in place of ``mlp`` for an MoE config."""
    p = {
        "ln1": init_norm(cfg, cfg.d_model, dtype, device),
        "attn": init_attention(cfg, gen, dtype, device),
        "ln2": init_norm(cfg, cfg.d_model, dtype, device),
    }
    if cfg.moe:
        p["moe"] = init_moe(cfg, gen, dtype, device)
    else:
        p["mlp"] = init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype,
                            device=device)
    return p


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


def _map(tree, fn):
    """``fn`` of every tensor of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _pdict(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in d.items()})


class DecoderBlock(nn.Module):
    """One pre-norm decoder block's parameters: ln1, attn, ln2, and mlp or
    (MoE) moe; :attr:`groups` names the ones it holds."""

    def __init__(self, p: dict):
        super().__init__()
        self.groups = tuple(g for g in ("ln1", "attn", "ln2", "mlp", "moe")
                            if g in p)
        for g in self.groups:
            setattr(self, g, _pdict(p[g]))


class DecoderLM(nn.Module):
    """A decoder LM's parameters (see module docstring).  The serving
    step (``serving/paged_decode.py``) runs the math over these; the module
    holds no behaviour of its own beyond placement."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        if cfg.family not in DECODER_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port serves decoder LMs "
                f"({', '.join(DECODER_FAMILIES)}); the {cfg.family} family "
                f"is not ported (ROADMAP A.6b)")
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

    def placed(self, device) -> "DecoderLM":
        """These weights on ``device``: this module itself where they already
        lie there, else a copy there.  Unlike ``.to()``, which moves a
        module in place, the caller's module never moves, so replicas on
        two devices can be built from one model."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if self.device == dev:
            return self
        return DecoderLM(self.cfg, _map(self.tree(), lambda t: t.to(dev)))

    def tree(self) -> dict:
        """The parameters as the nested dicts the module is built from."""
        out = {"embed": dict(self.embed),
               "blocks": [{n: dict(getattr(b, n)) for n in b.groups}
                          for b in self.blocks],
               "final_norm": dict(self.final_norm)}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head
        return out

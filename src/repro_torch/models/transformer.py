"""Model family assembly: decoder LM (dense / MoE / prefix-VLM), encoder-
decoder (whisper), hybrid recurrent (RecurrentGemma), SSM (Mamba-2).

The port of ``repro.models.transformer``.  The JAX package
keeps parameters as a pytree with the layers stacked on a leading axis and
scans over them; here each family's parameters are an ``nn.Module``
(:class:`DecoderLM`, :class:`EncDecLM`, :class:`HybridLM`, :class:`SSMLM`)
whose stacked groups (``blocks``, ``enc_blocks``, ``groups``, ``tail``)
are ``ModuleList``s of per-layer :class:`Block`s, walked by a Python loop.
Every parameter keeps the reference's name and ``[in, out]`` layout:
``model.blocks[l]["attn"]["wq"]`` is ``params["blocks"]["attn"]["wq"][l]``.
Parameters are created with ``requires_grad=False``, so the serving and
inference paths build no autograd graph; the trainer turns gradients on
with ``module.requires_grad_(True)`` (``launch/train.py``).  Each
family's ``*_forward`` runs its layer loop under the config's ``remat``
(:func:`_remat`), as the reference wraps its scans in ``_maybe_remat``,
and the decoder's takes the reference's ``dropless`` switch: the training
loss runs the capacity-bounded MoE, every inference path the dropless one.

Each family has the reference's four entry points, plain functions over
its module (``models/model.py::build_model`` binds them):

  *_forward(cfg, model, batch)             -> (hidden, aux)  teacher forcing
  *_prefill(cfg, model, batch, cache_size) -> (cache, logits)
  *_decode_step(cfg, model, cache, batch)  -> (logits, cache)
  *_init_cache(cfg, batch_size, cache_size, ...) -> cache

Caches are dicts of tensors with the reference's keys, shapes and dtypes.
``pos`` in a decode batch is a [B] vector of absolute positions; a KV
cache of W slots is a ring (slot ``pos % W``).  A decode step writes the
new K/V into the cache's K/V tensors IN PLACE (cast to their dtype, as
the reference's scatter casts) and returns a new dict whose recurrent
states and ``len`` are new tensors.  No step reads the device from the
host.  The decoder families' paged serving path is
``serving/paged_decode.py``; this module's decoder functions are the
non-paged path (sliding window and VLM image prefix included).

Under a device mesh (``launch/steps.py::sharded``) the same functions run
on DTensors: ``shard_seq`` sits at the reference's sites, every sublayer
output joins the residual through :func:`_residual`, and each layer's
parameters are gathered over the data axes where it runs (FSDP,
``rules.gather_data``); on plain tensors all of it is the identity.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.sharding import rules
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .layers import (_normal, apply_norm, attention_out, attention_qkv,
                     decode_attention, flash_attention, init_attention,
                     init_mlp, init_norm, mlp_apply)
from .moe import init_moe, moe_apply

#: the decoder-LM families (the ones the paged serving path serves);
#: ``afmoe`` (trinity-mini) adds the block options of
#: ``configs/base.py::PortArchConfig`` to ``moe``
DECODER_FAMILIES = ("dense", "moe", "vlm", "afmoe")
#: the entries of a parameter tree stacked per layer (lists in the port)
STACKED = ("blocks", "enc_blocks", "groups", "tail")

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
    x = _lookup(p["tok"], tokens)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if not cfg.use_rope:
        x = x + _lookup(p["pos"], positions)
    return x


def _lookup(table, idx):
    """``table[idx]``; under a mesh on each rank's rows of ``idx`` from the
    whole table (DTensor's rule for the lookup's backward scatter is not
    one every PyTorch has right).  A table replicated as it is (a tied
    one, which the unembedding also reads) gets its gradient back in its
    own layout here, so its two gradients add in one layout."""
    if not rules.sharded_on_mesh(table):
        return table[idx]
    if not any(isinstance(p, rules.Shard) for p in table.placements):
        table = rules.grad_layout(table)
    spec = rules.batch_spec(idx)
    return rules.local(lambda t, i: t[i], (table, idx), ((None, None), spec),
                       spec + (None,))


def unembed(cfg, model, x):
    """Hidden states -> logits through the tied table or ``lm_head``."""
    w = model.embed["tok"].T if cfg.tie_embeddings else model.lm_head
    return x @ rules.gather_data(w)


def _residual(x, y):
    """x plus a sublayer's output y, laid out as the residual stream
    (``shard_seq``): under a mesh, a row-parallel product's partial sums
    reduce-scatter into the sequence shards here (Megatron-SP; a one-token
    step's are summed whole), and the backward then brings y's gradient
    back with its sequence whole.  Every add sees one layout, so no
    version of DTensor has a choice to make."""
    return x + rules.shard_seq(y)


def post_norm(cfg, y, blk, name):
    """A sublayer's output ``y`` through the block's norm ``name`` where it
    has one (``sandwich_norm``: ``post_attn``, ``post_mlp``)."""
    return apply_norm(cfg, y, blk[name]) if name in blk else y


def _ffn(cfg, x, blk, norm, dropless=False):
    """x plus the block's MLP (or MoE, capacity-bounded unless
    ``dropless``) of ``norm``(x)."""
    h = apply_norm(cfg, x, blk[norm])
    if "moe" in blk:
        y = moe_apply(cfg, h, blk["moe"], dropless=dropless)[0]
    else:
        y = mlp_apply(cfg, h, blk["mlp"])
    return _residual(x, post_norm(cfg, y, blk, "post_mlp"))


#: the matrix products without batch dimensions, whose outputs ``"dots"``
#: keeps (the reference's ``dots_with_no_batch_dims_saveable``)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn, *args):
    """``fn(*args)`` — one layer of a layer loop — under the config's
    rematerialisation, the reference's ``_maybe_remat``: ``"full"`` keeps
    only the layer's inputs and recomputes the rest in the backward,
    ``"dots"`` also keeps the outputs of its matrix products without
    batch dimensions.  With ``"none"``, or where no backward can follow
    (grad mode off), ``fn`` runs as it is.  Under a mesh the layer's
    parameters are gathered over the data axes inside it
    (``rules.gather_data``), so a recomputed layer gathers them again, as
    FSDP does."""
    def layer(x, blk, *rest):  # a layer's parameters gathered (FSDP)
        return fn(x, rules.gather_data(blk), *rest)

    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer(*args)
    # the layers draw no random numbers: no RNG state to stash
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "full":
        return checkpoint(layer, *args, **kw)
    if cfg.remat == "dots":
        return checkpoint(layer, *args, **kw, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(cfg.remat)


def _ring_align(kv, W):
    """Last-W window of kv [B, S, ...] placed into ring slots (slot = pos %
    W); zero-padded to W slots when S < W."""
    S = kv.shape[1]
    if S < W:
        return torch.cat([kv, kv.new_zeros((kv.shape[0], W - S)
                                           + kv.shape[2:])], dim=1)
    return torch.roll(kv[:, S - W:], S % W, dims=1)


def _ring_step(cache, layer, rows, slot, k, v):
    """Write the new token's K/V [B, 1, Hkv, D] into ring slot ``slot`` of
    layer ``layer``'s cache, in place.  Returns that layer's (k, v)."""
    kc, vc = cache["k"][layer], cache["v"][layer]
    if rules.sharded_on_mesh(kc):
        _ring_write_sharded(kc, slot, k[:, 0])
        _ring_write_sharded(vc, slot, v[:, 0])
        return kc, vc
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)
    return kc, vc


def _ring_write_sharded(c, slot, new):
    """``c[b, slot[b]] = new[b]`` on each rank's shard of the DTensor cache
    layer c [B, W, Hkv, D] (batch and ring slots as ``cache_specs`` placed
    them): the rank holding the slot writes it, the others write back what
    they hold."""
    off = rules.shard_offset(c, 1)
    dp = rules.batch_spec(slot)[0]

    def write(c, slot, new):
        rows = torch.arange(c.shape[0], device=c.device)
        i = slot.long() - off
        own = (i >= 0) & (i < c.shape[1])
        i = torch.clamp(i, 0, c.shape[1] - 1)
        c[rows, i] = torch.where(own[:, None, None], new.to(c.dtype),
                                 c[rows, i])

    # the cache keeps its placements: the region writes its own shards
    rules.local(write, (c, slot, new), (c.placements, (dp,), (dp, None, None)),
                None)


def _decode_setup(cfg, model, batch, W):
    """(x [B, 1, d], rows, ring slot and valid length [B]) for a decode
    step over W cache slots."""
    token, pos = batch["token"], batch["pos"]
    x = embed_tokens(cfg, model.embed, token[:, None], pos[:, None])
    rows = torch.arange(token.shape[0], device=token.device)
    return x, rows, (pos % W).long(), torch.clamp(pos + 1, max=W)


def _logits_last(cfg, model, x):
    """Final norm then the last position's logits, float32 [B, 1, V]."""
    x = apply_norm(cfg, x, model.final_norm)
    return unembed(cfg, model, x[:, -1:, :]).float()


# ===========================================================================
# Parameter modules


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


class Block(nn.Module):
    """One layer's parameters (or one hybrid group's): each entry holding
    tensors becomes an ``nn.ParameterDict``, each holding dicts a nested
    ``Block``; ``blk["attn"]["wq"]`` (or ``blk.attn["wq"]``) reads as the
    reference's pytree does.  :attr:`groups` names the entries held."""

    def __init__(self, p: dict):
        super().__init__()
        self.groups = tuple(p)
        for g, v in p.items():
            nested = any(isinstance(x, dict) for x in v.values())
            setattr(self, g, Block(v) if nested else _pdict(v))

    def __getitem__(self, g):
        return getattr(self, g)

    def __contains__(self, g) -> bool:
        return g in self.groups

    def tree(self) -> dict:
        """The nested dicts the block is built from."""
        return {g: self[g].tree() if isinstance(self[g], Block)
                else dict(self[g]) for g in self.groups}


class _LM(nn.Module):
    """A family's parameters: the tree's stacked groups as ``ModuleList``s
    of :class:`Block`, other dict entries as ``ParameterDict``s, top-level
    tensors (``lm_head``, ``enc_pos``) as parameters.  Holds no behaviour
    beyond placement: the family's functions run the math over it."""

    families: tuple = ()

    def __init__(self, cfg, params: dict):
        super().__init__()
        if cfg.family not in self.families:
            raise NotImplementedError(
                f"{cfg.name}: {type(self).__name__} holds the "
                f"{', '.join(self.families)} families, not {cfg.family}; "
                f"repro_torch.models.build_model(cfg) builds each family's "
                f"model")
        self.cfg = cfg
        self.names = tuple(params)
        if "lm_head" not in params:
            self.lm_head = None
        for k, v in params.items():
            if k in STACKED:
                setattr(self, k, nn.ModuleList(Block(b) for b in v))
            elif isinstance(v, dict):
                setattr(self, k, _pdict(v))
            else:
                setattr(self, k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k) -> bool:
        return k in self.names

    @property
    def device(self) -> torch.device:
        """Where the weights live."""
        return self.embed["tok"].device

    def placed(self, device) -> "_LM":
        """These weights on ``device``: this module itself where they already
        lie there, else a copy there.  Unlike ``.to()``, which moves a
        module in place, the caller's module never moves, so replicas on
        two devices can be built from one model."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if self.device == dev:
            return self
        return type(self)(self.cfg, _map(self.tree(), lambda t: t.to(dev)))

    def tree(self) -> dict:
        """The parameters as the nested dicts the module is built from."""
        out = {}
        for k in self.names:
            mod = self[k]
            out[k] = ([b.tree() for b in mod] if k in STACKED
                      else dict(mod) if isinstance(mod, nn.ParameterDict)
                      else mod)
        return out


class DecoderLM(_LM):
    """A decoder LM's parameters (dense, MoE, the VLM's text decoder): the
    paged serving step (``serving/paged_decode.py``) and the non-paged
    decoder functions below run over it."""

    families = DECODER_FAMILIES


class EncDecLM(_LM):
    """Whisper's parameters: ``enc_pos``, ``enc_blocks``, ``enc_norm`` and
    decoder ``blocks`` with self and cross attention."""

    families = ("audio",)


class HybridLM(_LM):
    """RecurrentGemma's parameters: ``groups`` of (rec1, rec2, attn)
    sublayers and the trailing recurrent ``tail``."""

    families = ("hybrid",)


class SSMLM(_LM):
    """Mamba-2's parameters: ``blocks`` of (ln1, ssm)."""

    families = ("ssm",)


def lm_class(cfg) -> type:
    """The module class holding ``cfg``'s family."""
    for cls in (DecoderLM, EncDecLM, HybridLM, SSMLM):
        if cfg.family in cls.families:
            return cls
    raise ValueError(cfg.family)


def _generator(seed, device):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen, dev


# ===========================================================================
# Decoder-LM family (dense / MoE / prefix-VLM)


def init_decoder_block(cfg, gen, dtype=torch.bfloat16, device=None,
                       layer: int = 0):
    """Layer ``layer``'s parameters as nested dicts: ln1, attn, ln2, and
    ``moe`` in place of ``mlp`` for an MoE config past its dense layers
    (``cfg.moe_at``; a dense layer's MLP is ``dense_ff`` wide where the
    config sets it); with ``sandwich_norm``, ``post_attn`` and
    ``post_mlp`` too."""
    p = {
        "ln1": init_norm(cfg, cfg.d_model, dtype, device),
        "attn": init_attention(cfg, gen, dtype, device),
        "ln2": init_norm(cfg, cfg.d_model, dtype, device),
    }
    if cfg.sandwich_norm:
        p["post_attn"] = init_norm(cfg, cfg.d_model, dtype, device)
        p["post_mlp"] = init_norm(cfg, cfg.d_model, dtype, device)
    if cfg.moe_at(layer):
        p["moe"] = init_moe(cfg, gen, dtype, device)
    else:
        p["mlp"] = init_mlp(cfg, gen, cfg.d_model, cfg.dense_ff or cfg.d_ff,
                            dtype, device=device)
    return p


def init_decoder_lm(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """Seeded parameters with the reference's shapes and scales, as nested
    dicts with ``blocks`` a list of per-layer dicts.  The draw is made on
    ``device`` (a CUDA generator there), so the weights differ from the
    reference's ``jax.random`` ones: parity tests convert the reference's
    weights with :func:`repro_torch.convert.params_from_jax` instead."""
    gen, dev = _generator(seed, device)
    params = {
        "embed": init_embed(cfg, gen, dtype, dev),
        "blocks": [init_decoder_block(cfg, gen, dtype, dev, layer)
                   for layer in range(cfg.n_layers)],
        "final_norm": init_norm(cfg, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (cfg.d_model, cfg.vocab_padded), 0.02,
                                    dtype, dev)
    return params


def _embed_seq(cfg, model, tokens):
    """Embeddings of tokens [B, S] at positions 0..S-1 -> (x, positions
    [S])."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return embed_tokens(cfg, model.embed, tokens, pos[None, :]), pos


def _decoder_embed(cfg, model, batch):
    """Token embeddings, after the VLM's image ``patches`` where the config
    has a prefix -> (x [B, S, d], prefix_len)."""
    x = _embed_seq(cfg, model, batch["tokens"])[0]
    if not cfg.prefix_tokens:
        return x, 0
    prefix = batch["patches"].to(x.dtype)  # [B, P, d] (stub frontend)
    return torch.cat([prefix, x], dim=1), prefix.shape[1]


def _decoder_block_fwd(cfg, x, blk, positions, prefix_len, dropless=False,
                       layer: int = 0):
    """Layer ``layer`` over the whole sequence -> (x, aux, k, v); MoE blocks
    capacity-bounded unless ``dropless``.  Its attention window and RoPE
    are the layer's (``cfg.window_at``, ``cfg.rope_at``)."""
    x = rules.shard_seq(x)  # sequence-parallel residual stream (Megatron-SP)
    h = apply_norm(cfg, x, blk["ln1"])
    q, k, v = attention_qkv(cfg, h, blk["attn"], positions,
                            rope=cfg.rope_at(layer))
    # prefix_len > 0: leading (image) tokens attend bidirectionally
    att = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                          window=cfg.window_at(layer) or cfg.sliding_window,
                          prefix_len=prefix_len)
    x = _residual(x, post_norm(cfg, attention_out(
        cfg, h, rules.merge_heads(att), blk["attn"]), blk, "post_attn"))
    h2 = apply_norm(cfg, x, blk["ln2"])
    if "moe" in blk:
        y, aux = moe_apply(cfg, h2, blk["moe"], dropless=dropless)
    else:
        y = mlp_apply(cfg, h2, blk["mlp"])
        aux = torch.zeros((), device=x.device)
    return _residual(x, post_norm(cfg, y, blk, "post_mlp")), aux, k, v


def decoder_forward(cfg, model, batch, dropless=False):
    """-> (hidden [B, S, d] final-normed, aux loss float32 []).  S includes
    the VLM prefix if present.  ``dropless``: size MoE capacity so no
    assignment is dropped, the inference (teacher-forcing) function that
    matches prefill + decode_step; the training loss keeps the
    capacity-bounded default, as the reference's does."""
    x, prefix_len = _decoder_embed(cfg, model, batch)
    pos_all = torch.arange(x.shape[1], device=x.device)

    def layer(x, blk, l):
        return _decoder_block_fwd(cfg, x, blk, pos_all, prefix_len,
                                  dropless, l)[:2]

    auxs = []
    for l, blk in enumerate(model.blocks):
        x, aux = _remat(cfg, layer, x, blk, l)
        auxs.append(aux)
    return apply_norm(cfg, x, model.final_norm), torch.stack(auxs).sum()


def decoder_prefill(cfg, model, batch, cache_size):
    """The prompt through every block -> (cache {"k", "v": [L, B, W, Hkv,
    D], "len"}, last-position logits float32 [B, 1, V]).  When the prompt
    is longer than ``cache_size`` (a sliding-window ring) the cache holds
    its last W positions in ring slots."""
    x, prefix_len = _decoder_embed(cfg, model, batch)
    B, S = x.shape[:2]
    pos_all = torch.arange(S, device=x.device)
    kc = vc = None
    for l, blk in enumerate(model.blocks):
        x, _, k, v = _decoder_block_fwd(cfg, x, rules.gather_data(blk),
                                        pos_all, prefix_len, dropless=True,
                                        layer=l)
        if kc is None:
            kc = k.new_zeros((cfg.n_layers, B, cache_size) + k.shape[2:])
            vc = torch.zeros_like(kc)
        kc[l], vc[l] = _ring_align(k, cache_size), _ring_align(v, cache_size)
    cache = {"k": kc, "v": vc,
             "len": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return cache, _logits_last(cfg, model, x)


def decoder_decode_step(cfg, model, cache, batch):
    """batch: token [B] int, pos [B] int (absolute position of the new
    token).  Ring-buffer semantics when the cache has fewer slots than
    positions; the sliding window applies only when the cache is longer
    than it.  The cache's K/V are written in place (module docstring)."""
    W = cache["k"].shape[2]
    x, rows, slot, cache_len = _decode_setup(cfg, model, batch, W)
    for l, blk in enumerate(model.blocks):
        w = cfg.window_at(l) or cfg.sliding_window
        window = w if W > (w or W) else None
        h = apply_norm(cfg, x, blk["ln1"])
        q, k, v = attention_qkv(cfg, h, blk["attn"], batch["pos"][:, None],
                                rope=cfg.rope_at(l))
        kc, vc = _ring_step(cache, l, rows, slot, k, v)
        att = decode_attention(q, kc, vc, cache_len, window=window)
        x = _residual(x, post_norm(cfg, attention_out(
            cfg, h, rules.merge_heads(att), blk["attn"]), blk, "post_attn"))
        x = _ffn(cfg, x, blk, "ln2", dropless=True)
    x = apply_norm(cfg, x, model.final_norm)
    return (unembed(cfg, model, x)[:, 0].float(),
            {**cache, "len": cache["len"] + 1})


def decoder_init_cache(cfg, batch_size, cache_size, device=None):
    """An empty cache, bf16 K/V as the reference's whatever the model's
    dtype."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cache_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


# ===========================================================================
# Encoder-decoder family (whisper)


def init_encdec(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """Seeded whisper parameters (reference shapes and scales)."""
    gen, dev = _generator(seed, device)

    def enc_block():
        return {"ln1": init_norm(cfg, cfg.d_model, dtype, dev),
                "attn": init_attention(cfg, gen, dtype, dev),
                "ln2": init_norm(cfg, cfg.d_model, dtype, dev),
                "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype,
                                bias=True, device=dev)}

    def dec_block():
        return {"ln1": init_norm(cfg, cfg.d_model, dtype, dev),
                "self_attn": init_attention(cfg, gen, dtype, dev),
                "ln2": init_norm(cfg, cfg.d_model, dtype, dev),
                "cross_attn": init_attention(cfg, gen, dtype, dev),
                "ln3": init_norm(cfg, cfg.d_model, dtype, dev),
                "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype,
                                bias=True, device=dev)}

    return {
        "embed": init_embed(cfg, gen, dtype, dev),
        "enc_pos": _normal(gen, (cfg.encoder_seq, cfg.d_model), 0.02, dtype,
                           dev),
        "enc_blocks": [enc_block() for _ in range(cfg.encoder_layers)],
        "enc_norm": init_norm(cfg, cfg.d_model, dtype, dev),
        "blocks": [dec_block() for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg, cfg.d_model, dtype, dev),
    }


def encoder_forward(cfg, model, frames):
    """frames [B, F, d]: precomputed conv-frontend embeddings (stub), cast
    to bf16 and added to ``enc_pos`` as the reference does -> [B, F, d]."""
    x = frames.to(torch.bfloat16) + model.enc_pos[None, :frames.shape[1], :]
    pos = torch.arange(x.shape[1], device=x.device)

    def layer(x, blk):
        x = rules.shard_seq(x)
        h = apply_norm(cfg, x, blk["ln1"])
        q, k, v = attention_qkv(cfg, h, blk["attn"], pos)
        att = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        x = _residual(x, rules.merge_heads(att) @ blk["attn"]["wo"])
        return _residual(x, mlp_apply(cfg, apply_norm(cfg, x, blk["ln2"]),
                                      blk["mlp"]))

    for blk in model.enc_blocks:
        x = _remat(cfg, layer, x, blk)
    return apply_norm(cfg, x, model.enc_norm)


def _cross_kv(cfg, blk, enc_out):
    """The block's cross-attention K/V over the encoder output [B, F, Hkv,
    D] (no bias, as the reference's)."""
    B = enc_out.shape[0]
    shape = (B, -1, cfg.n_kv_heads, cfg.head_dim)
    return tuple(rules.split_heads(enc_out @ blk["cross_attn"][w],
                                   cfg.n_kv_heads).reshape(shape)
                 for w in ("wk", "wv"))


def _encdec_block_fwd(cfg, x, blk, pos, enc_out):
    """One decoder block over the whole sequence -> (x, k, v, ck, cv)."""
    B, S, _ = x.shape
    h = apply_norm(cfg, x, blk["ln1"])
    q, k, v = attention_qkv(cfg, h, blk["self_attn"], pos)
    att = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    x = _residual(x, rules.merge_heads(att) @ blk["self_attn"]["wo"])
    h = apply_norm(cfg, x, blk["ln2"])
    cq = rules.split_heads(h @ blk["cross_attn"]["wq"],
                           cfg.n_heads).reshape(B, S, cfg.n_heads,
                                               cfg.head_dim)
    ck, cv = _cross_kv(cfg, blk, enc_out)
    att = flash_attention(cq, ck, cv, causal=False, chunk=cfg.attn_chunk)
    x = _residual(x, rules.merge_heads(att) @ blk["cross_attn"]["wo"])
    x = _residual(x, mlp_apply(cfg, apply_norm(cfg, x, blk["ln3"]),
                               blk["mlp"]))
    return x, k, v, ck, cv


def _encdec_decoder(cfg, model, batch):
    """(encoder output, token embeddings, positions) of a batch."""
    return (encoder_forward(cfg, model, batch["frames"]),
            *_embed_seq(cfg, model, batch["tokens"]))


def encdec_forward(cfg, model, batch):
    """batch: frames [B, F, d], tokens [B, S] -> (hidden [B, S, d], 0)."""
    enc_out, x, pos = _encdec_decoder(cfg, model, batch)

    def layer(x, blk, enc_out):
        return _encdec_block_fwd(cfg, x, blk, pos, enc_out)[0]

    for blk in model.blocks:
        x = _remat(cfg, layer, x, blk, enc_out)
    return (apply_norm(cfg, x, model.final_norm),
            torch.zeros((), device=x.device))


def encdec_prefill(cfg, model, batch, cache_size):
    """-> (cache {"k", "v": [L, B, cache_size, Hkv, D], "ck", "cv": [L, B,
    F, Hkv, D] from the encoder output, "len"}, logits [B, 1, V])."""
    enc_out, x, pos = _encdec_decoder(cfg, model, batch)
    B, S = x.shape[:2]
    parts = []
    for blk in model.blocks:
        x, *kv = _encdec_block_fwd(cfg, x, rules.gather_data(blk), pos,
                                   enc_out)
        parts.append(kv)
    ks, vs, cks, cvs = (torch.stack(t) for t in zip(*parts))
    kc = ks.new_zeros(ks.shape[:2] + (cache_size,) + ks.shape[3:])
    vc = torch.zeros_like(kc)
    kc[:, :, :S], vc[:, :, :S] = ks, vs
    cache = {"k": kc, "v": vc, "ck": cks, "cv": cvs,
             "len": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return cache, _logits_last(cfg, model, x)


def encdec_init_cache(cfg, batch_size, cache_size, device=None):
    """An empty cache, bf16 as the reference's whatever the model's
    dtype."""
    dev = resolve_device(device)
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    kv = (L, batch_size, cache_size, Hkv, Dh)
    enc = (L, batch_size, cfg.encoder_seq, Hkv, Dh)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    return {"k": torch.zeros(kv, **bf16), "v": torch.zeros(kv, **bf16),
            "ck": torch.zeros(enc, **bf16), "cv": torch.zeros(enc, **bf16),
            "len": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def encdec_decode_step(cfg, model, cache, batch):
    """One token: self attention over the ring cache (written in place),
    cross attention over the whole cached encoder output."""
    W = cache["k"].shape[2]
    x, rows, slot, cache_len = _decode_setup(cfg, model, batch, W)
    B = x.shape[0]
    enc_len = torch.full((B,), cache["ck"].shape[2], dtype=torch.int32,
                         device=x.device)
    for l, blk in enumerate(model.blocks):
        h = apply_norm(cfg, x, blk["ln1"])
        q, k, v = attention_qkv(cfg, h, blk["self_attn"],
                                batch["pos"][:, None])
        kc, vc = _ring_step(cache, l, rows, slot, k, v)
        att = decode_attention(q, kc, vc, cache_len)
        x = _residual(x, rules.merge_heads(att) @ blk["self_attn"]["wo"])
        # cross attention over the precomputed encoder KV
        h2 = apply_norm(cfg, x, blk["ln2"])
        cq = rules.split_heads(h2 @ blk["cross_attn"]["wq"],
                               cfg.n_heads).reshape(B, 1, cfg.n_heads,
                                                    cfg.head_dim)
        catt = decode_attention(cq, cache["ck"][l], cache["cv"][l], enc_len)
        x = _residual(x, rules.merge_heads(catt) @ blk["cross_attn"]["wo"])
        x = _residual(x, mlp_apply(cfg, apply_norm(cfg, x, blk["ln3"]),
                                   blk["mlp"]))
    x = apply_norm(cfg, x, model.final_norm)
    return (unembed(cfg, model, x)[:, 0].float(),
            {**cache, "len": cache["len"] + 1})


# ===========================================================================
# Hybrid family (RecurrentGemma: groups of rec, rec, local-attn)


def _init_hybrid_sublayer(cfg, gen, kind, dtype, device):
    mix = (rglru_lib.init_rglru(cfg, gen, dtype, device) if kind == "rec"
           else init_attention(cfg, gen, dtype, device))
    return {"ln_mix": init_norm(cfg, cfg.d_model, dtype, device),
            "mix": mix,
            "ln_mlp": init_norm(cfg, cfg.d_model, dtype, device),
            "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype,
                            device=device)}


def init_hybrid(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """Seeded RecurrentGemma parameters: n_layers // 3 (rec, rec, attn)
    groups and n_layers % 3 trailing recurrent sublayers."""
    gen, dev = _generator(seed, device)
    params = {
        "embed": init_embed(cfg, gen, dtype, dev),
        "groups": [{name: _init_hybrid_sublayer(cfg, gen, kind, dtype, dev)
                    for name, kind in (("rec1", "rec"), ("rec2", "rec"),
                                       ("attn", "attn"))}
                   for _ in range(cfg.n_layers // 3)],
        "final_norm": init_norm(cfg, cfg.d_model, dtype, dev),
    }
    if cfg.n_layers % 3:
        params["tail"] = [_init_hybrid_sublayer(cfg, gen, "rec", dtype, dev)
                          for _ in range(cfg.n_layers % 3)]
    return params


def _hybrid_rec(cfg, x, sub):
    """A recurrent sublayer over the sequence -> (x, {"h", "conv"})."""
    h = apply_norm(cfg, x, sub["ln_mix"])
    y, st = rglru_lib.rglru_apply(cfg, h, sub["mix"], return_state=True)
    return _ffn(cfg, _residual(x, y), sub, "ln_mlp"), st


def _hybrid_attn(cfg, x, sub, pos):
    """The local-attention sublayer over the sequence -> (x, k, v)."""
    h = apply_norm(cfg, x, sub["ln_mix"])
    q, k, v = attention_qkv(cfg, h, sub["mix"], pos)
    att = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                          window=cfg.local_window)
    x = _residual(x, rules.merge_heads(att) @ sub["mix"]["wo"])
    return _ffn(cfg, x, sub, "ln_mlp"), k, v


def hybrid_forward(cfg, model, batch):
    """-> (hidden [B, S, d], 0).  Each (rec, rec, attn) group runs under
    the config's remat; the tail does not, as in the reference."""
    x, pos = _embed_seq(cfg, model, batch["tokens"])

    def group(x, g):
        x = rules.shard_seq(x)
        x = _hybrid_rec(cfg, x, g["rec1"])[0]
        x = _hybrid_rec(cfg, x, g["rec2"])[0]
        return _hybrid_attn(cfg, x, g["attn"], pos)[0]

    for g in model.groups:
        x = _remat(cfg, group, x, g)
    for sub in model.tail if "tail" in model else ():
        x = _hybrid_rec(cfg, x, rules.gather_data(sub))[0]
    return (apply_norm(cfg, x, model.final_norm),
            torch.zeros((), device=x.device))


def hybrid_prefill(cfg, model, batch, cache_size):
    """-> (cache {"h1", "conv1", "h2", "conv2": per group; "k", "v": the
    last W = min(cache_size, local_window) positions in ring slots; "th",
    "tconv": the tail's; "len"}, logits [B, 1, V])."""
    x, pos = _embed_seq(cfg, model, batch["tokens"])
    B, S = x.shape[:2]
    W = min(cache_size, cfg.local_window)
    parts = []
    for g in map(rules.gather_data, model.groups):
        x, st1 = _hybrid_rec(cfg, x, g["rec1"])
        x, st2 = _hybrid_rec(cfg, x, g["rec2"])
        x, k, v = _hybrid_attn(cfg, x, g["attn"], pos)
        parts.append((st1["h"], st1["conv"], st2["h"], st2["conv"],
                      _ring_align(k, W), _ring_align(v, W)))
    cache = dict(zip(("h1", "conv1", "h2", "conv2", "k", "v"),
                     (torch.stack(t) for t in zip(*parts))))
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if "tail" in model:
        tail = []
        for sub in map(rules.gather_data, model.tail):
            x, st = _hybrid_rec(cfg, x, sub)
            tail.append((st["h"], st["conv"]))
        cache["th"], cache["tconv"] = (torch.stack(t) for t in zip(*tail))
    return cache, _logits_last(cfg, model, x)


def hybrid_init_cache(cfg, batch_size, cache_size, device=None):
    """An empty cache: recurrent states float32, conv caches and K/V bf16
    (as the reference's, whatever the model's dtype)."""
    dev = resolve_device(device)
    G, n_tail = cfg.n_layers // 3, cfg.n_layers % 3
    W = min(cache_size, cfg.local_window)
    dr = cfg.rnn_width

    def z(shape, dt=torch.bfloat16):
        return torch.zeros(shape, dtype=dt, device=dev)

    kv = (G, batch_size, W, cfg.n_kv_heads, cfg.head_dim)
    cache = {"h1": z((G, batch_size, dr), torch.float32),
             "conv1": z((G, batch_size, 3, dr)),
             "h2": z((G, batch_size, dr), torch.float32),
             "conv2": z((G, batch_size, 3, dr)),
             "k": z(kv), "v": z(kv),
             "len": z((batch_size,), torch.int32)}
    if n_tail:
        cache["th"] = z((n_tail, batch_size, dr), torch.float32)
        cache["tconv"] = z((n_tail, batch_size, 3, dr))
    return cache


def _hybrid_rec_step(cfg, x, sub, h, conv):
    """A recurrent sublayer for one token -> (x, h, conv)."""
    hin = apply_norm(cfg, x, sub["ln_mix"])
    y, st = rglru_lib.rglru_decode_step(cfg, hin, sub["mix"],
                                        {"h": h, "conv": conv})
    return _ffn(cfg, _residual(x, y), sub, "ln_mlp"), st["h"], st["conv"]


def hybrid_decode_step(cfg, model, cache, batch):
    """One token: the recurrent states step, the local attention reads its
    ring of W slots (which holds the window, so no window is passed) and
    writes the new K/V into it in place."""
    W = cache["k"].shape[2]
    x, rows, slot, cache_len = _decode_setup(cfg, model, batch, W)
    B = x.shape[0]
    parts = []
    for gi, g in enumerate(model.groups):
        x, h1, c1 = _hybrid_rec_step(cfg, x, g["rec1"], cache["h1"][gi],
                                     cache["conv1"][gi])
        x, h2, c2 = _hybrid_rec_step(cfg, x, g["rec2"], cache["h2"][gi],
                                     cache["conv2"][gi])
        sub = g["attn"]
        h = apply_norm(cfg, x, sub["ln_mix"])
        q, k, v = attention_qkv(cfg, h, sub["mix"], batch["pos"][:, None])
        kc, vc = _ring_step(cache, gi, rows, slot, k, v)
        att = decode_attention(q, kc, vc, cache_len)
        x = _residual(x, rules.merge_heads(att) @ sub["mix"]["wo"])
        x = _ffn(cfg, x, sub, "ln_mlp")
        parts.append((h1, c1, h2, c2))
    new = {**cache, "len": cache["len"] + 1}
    new.update(zip(("h1", "conv1", "h2", "conv2"),
                   (torch.stack(t) for t in zip(*parts))))
    if "tail" in model:
        tail = []
        for i, sub in enumerate(model.tail):
            x, th, tc = _hybrid_rec_step(cfg, x, sub, cache["th"][i],
                                         cache["tconv"][i])
            tail.append((th, tc))
        new["th"], new["tconv"] = (torch.stack(t) for t in zip(*tail))
    x = apply_norm(cfg, x, model.final_norm)
    return unembed(cfg, model, x)[:, 0].float(), new


# ===========================================================================
# SSM family (Mamba-2)


def init_ssm_lm(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """Seeded Mamba-2 parameters: ``blocks`` of (ln1, ssm)."""
    gen, dev = _generator(seed, device)
    return {
        "embed": init_embed(cfg, gen, dtype, dev),
        "blocks": [{"ln1": init_norm(cfg, cfg.d_model, dtype, dev),
                    "ssm": ssm_lib.init_ssm(cfg, gen, dtype, dev)}
                   for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg, cfg.d_model, dtype, dev),
    }


def ssm_forward(cfg, model, batch):
    """-> (hidden [B, S, d], 0)."""
    x = _embed_seq(cfg, model, batch["tokens"])[0]

    def layer(x, blk):
        x = rules.shard_seq(x)
        h = apply_norm(cfg, x, blk["ln1"])
        return _residual(x, ssm_lib.ssd_apply(cfg, h, blk["ssm"],
                                              chunk=cfg.ssd_chunk))

    for blk in model.blocks:
        x = _remat(cfg, layer, x, blk)
    return (apply_norm(cfg, x, model.final_norm),
            torch.zeros((), device=x.device))


def ssm_prefill(cfg, model, batch, cache_size=0):
    """-> (cache {"ssm": [L, B, H, P, N], "conv": [L, B, 3, ch], "len"},
    logits [B, 1, V]); the state is O(1) in the sequence, so
    ``cache_size`` is unused."""
    x = _embed_seq(cfg, model, batch["tokens"])[0]
    sts, cvs = [], []
    for blk in map(rules.gather_data, model.blocks):
        h = apply_norm(cfg, x, blk["ln1"])
        y, st = ssm_lib.ssd_apply(cfg, h, blk["ssm"], chunk=cfg.ssd_chunk,
                                  return_state=True)
        x = _residual(x, y)
        sts.append(st["ssm"])
        cvs.append(st["conv"])
    cache = {"ssm": torch.stack(sts), "conv": torch.stack(cvs),
             "len": torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                               device=x.device)}
    return cache, _logits_last(cfg, model, x)


def ssm_init_cache(cfg, batch_size, cache_size=0, device=None):
    """An empty cache: each layer's zero decode state (the state float32,
    the conv cache bf16, as the reference's whatever the model's dtype);
    ``cache_size`` is unused."""
    dev = resolve_device(device)
    st = ssm_lib.ssd_decode_init(cfg, batch_size, device=dev)
    cache = {k: v.new_zeros((cfg.n_layers,) + v.shape) for k, v in st.items()}
    cache["len"] = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    return cache


def ssm_decode_step(cfg, model, cache, batch):
    """One token through every block's state."""
    x = embed_tokens(cfg, model.embed, batch["token"][:, None],
                     batch["pos"][:, None])
    sts, cvs = [], []
    for l, blk in enumerate(model.blocks):
        h = apply_norm(cfg, x, blk["ln1"])
        y, ns = ssm_lib.ssd_decode_step(
            cfg, h, blk["ssm"], {"ssm": cache["ssm"][l],
                                 "conv": cache["conv"][l]})
        x = _residual(x, y)
        sts.append(ns["ssm"])
        cvs.append(ns["conv"])
    x = apply_norm(cfg, x, model.final_norm)
    return (unembed(cfg, model, x)[:, 0].float(),
            {"ssm": torch.stack(sts), "conv": torch.stack(cvs),
             "len": cache["len"] + 1})

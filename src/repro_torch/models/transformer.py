"""Model family assembly: decoder LM (dense / MoE / prefix-VLM), encoder-
decoder (whisper), hybrid recurrent (RecurrentGemma), SSM (Mamba-2).

The port of ``repro.models.transformer``'s inference half.  The JAX package
keeps parameters as a pytree with the layers stacked on a leading axis and
scans over them; here each family's parameters are an ``nn.Module``
(:class:`DecoderLM`, :class:`EncDecLM`, :class:`HybridLM`, :class:`SSMLM`)
whose stacked groups (``blocks``, ``enc_blocks``, ``groups``, ``tail``)
are ``ModuleList``s of per-layer :class:`Block`s, walked by a Python loop.
Every parameter keeps the reference's name and ``[in, out]`` layout:
``model.blocks[l]["attn"]["wq"]`` is ``params["blocks"]["attn"]["wq"][l]``.
Parameters never require gradients: training ports later (ROADMAP A.7).

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
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .layers import (_normal, apply_norm, attention_qkv, decode_attention,
                     flash_attention, init_attention, init_mlp, init_norm,
                     mlp_apply)
from .moe import init_moe, moe_apply

#: the decoder-LM families (the ones the paged serving path serves)
DECODER_FAMILIES = ("dense", "moe", "vlm")
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


def _ffn(cfg, x, blk, norm):
    """x plus the block's MLP (or dropless MoE) of ``norm``(x)."""
    h = apply_norm(cfg, x, blk[norm])
    if "moe" in blk:
        return x + moe_apply(cfg, h, blk["moe"], dropless=True)[0]
    return x + mlp_apply(cfg, h, blk["mlp"])


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
    kc[rows, slot] = k[:, 0].to(kc.dtype)
    vc[rows, slot] = v[:, 0].to(vc.dtype)
    return kc, vc


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
    gen, dev = _generator(seed, device)
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


def _decoder_block_fwd(cfg, x, blk, positions, prefix_len):
    """One block over the whole sequence -> (x, aux, k, v); MoE blocks
    dispatch dropless."""
    h = apply_norm(cfg, x, blk["ln1"])
    q, k, v = attention_qkv(cfg, h, blk["attn"], positions)
    # prefix_len > 0: leading (image) tokens attend bidirectionally
    att = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                          window=cfg.sliding_window, prefix_len=prefix_len)
    x = x + att.reshape(*x.shape[:2], -1) @ blk["attn"]["wo"]
    h2 = apply_norm(cfg, x, blk["ln2"])
    if cfg.moe:
        y, aux = moe_apply(cfg, h2, blk["moe"], dropless=True)
    else:
        y = mlp_apply(cfg, h2, blk["mlp"])
        aux = torch.zeros((), device=x.device)
    return x + y, aux, k, v


def decoder_forward(cfg, model, batch):
    """-> (hidden [B, S, d] final-normed, aux loss float32 []).  S includes
    the VLM prefix if present.  MoE runs dropless: the reference's
    ``fwd_eval``, the same per-token function as prefill + decode_step
    (its capacity-bounded training forward ports with the loss)."""
    x, prefix_len = _decoder_embed(cfg, model, batch)
    pos_all = torch.arange(x.shape[1], device=x.device)
    auxs = []
    for blk in model.blocks:
        x, aux, _, _ = _decoder_block_fwd(cfg, x, blk, pos_all, prefix_len)
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
        x, _, k, v = _decoder_block_fwd(cfg, x, blk, pos_all, prefix_len)
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
    window = cfg.sliding_window if W > (cfg.sliding_window or W) else None
    for l, blk in enumerate(model.blocks):
        h = apply_norm(cfg, x, blk["ln1"])
        q, k, v = attention_qkv(cfg, h, blk["attn"], batch["pos"][:, None])
        kc, vc = _ring_step(cache, l, rows, slot, k, v)
        att = decode_attention(q, kc, vc, cache_len, window=window)
        x = x + att.reshape(*x.shape[:2], -1) @ blk["attn"]["wo"]
        x = _ffn(cfg, x, blk, "ln2")
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
    for blk in model.enc_blocks:
        h = apply_norm(cfg, x, blk["ln1"])
        q, k, v = attention_qkv(cfg, h, blk["attn"], pos)
        att = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        x = x + att.reshape(*x.shape[:2], -1) @ blk["attn"]["wo"]
        x = x + mlp_apply(cfg, apply_norm(cfg, x, blk["ln2"]), blk["mlp"])
    return apply_norm(cfg, x, model.enc_norm)


def _cross_kv(cfg, blk, enc_out):
    """The block's cross-attention K/V over the encoder output [B, F, Hkv,
    D] (no bias, as the reference's)."""
    B = enc_out.shape[0]
    shape = (B, -1, cfg.n_kv_heads, cfg.head_dim)
    return ((enc_out @ blk["cross_attn"]["wk"]).reshape(shape),
            (enc_out @ blk["cross_attn"]["wv"]).reshape(shape))


def _encdec_block_fwd(cfg, x, blk, pos, enc_out):
    """One decoder block over the whole sequence -> (x, k, v, ck, cv)."""
    B, S, _ = x.shape
    h = apply_norm(cfg, x, blk["ln1"])
    q, k, v = attention_qkv(cfg, h, blk["self_attn"], pos)
    att = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    x = x + att.reshape(B, S, -1) @ blk["self_attn"]["wo"]
    h = apply_norm(cfg, x, blk["ln2"])
    cq = (h @ blk["cross_attn"]["wq"]).reshape(B, S, cfg.n_heads,
                                               cfg.head_dim)
    ck, cv = _cross_kv(cfg, blk, enc_out)
    att = flash_attention(cq, ck, cv, causal=False, chunk=cfg.attn_chunk)
    x = x + att.reshape(B, S, -1) @ blk["cross_attn"]["wo"]
    x = x + mlp_apply(cfg, apply_norm(cfg, x, blk["ln3"]), blk["mlp"])
    return x, k, v, ck, cv


def _encdec_decoder(cfg, model, batch):
    """(encoder output, token embeddings, positions) of a batch."""
    return (encoder_forward(cfg, model, batch["frames"]),
            *_embed_seq(cfg, model, batch["tokens"]))


def encdec_forward(cfg, model, batch):
    """batch: frames [B, F, d], tokens [B, S] -> (hidden [B, S, d], 0)."""
    enc_out, x, pos = _encdec_decoder(cfg, model, batch)
    for blk in model.blocks:
        x = _encdec_block_fwd(cfg, x, blk, pos, enc_out)[0]
    return (apply_norm(cfg, x, model.final_norm),
            torch.zeros((), device=x.device))


def encdec_prefill(cfg, model, batch, cache_size):
    """-> (cache {"k", "v": [L, B, cache_size, Hkv, D], "ck", "cv": [L, B,
    F, Hkv, D] from the encoder output, "len"}, logits [B, 1, V])."""
    enc_out, x, pos = _encdec_decoder(cfg, model, batch)
    B, S = x.shape[:2]
    parts = []
    for blk in model.blocks:
        x, *kv = _encdec_block_fwd(cfg, x, blk, pos, enc_out)
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
        x = x + att.reshape(B, 1, -1) @ blk["self_attn"]["wo"]
        # cross attention over the precomputed encoder KV
        h2 = apply_norm(cfg, x, blk["ln2"])
        cq = (h2 @ blk["cross_attn"]["wq"]).reshape(B, 1, cfg.n_heads,
                                                    cfg.head_dim)
        catt = decode_attention(cq, cache["ck"][l], cache["cv"][l], enc_len)
        x = x + catt.reshape(B, 1, -1) @ blk["cross_attn"]["wo"]
        x = x + mlp_apply(cfg, apply_norm(cfg, x, blk["ln3"]), blk["mlp"])
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
    return _ffn(cfg, x + y, sub, "ln_mlp"), st


def _hybrid_attn(cfg, x, sub, pos):
    """The local-attention sublayer over the sequence -> (x, k, v)."""
    h = apply_norm(cfg, x, sub["ln_mix"])
    q, k, v = attention_qkv(cfg, h, sub["mix"], pos)
    att = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                          window=cfg.local_window)
    x = x + att.reshape(*x.shape[:2], -1) @ sub["mix"]["wo"]
    return _ffn(cfg, x, sub, "ln_mlp"), k, v


def hybrid_forward(cfg, model, batch):
    """-> (hidden [B, S, d], 0)."""
    x, pos = _embed_seq(cfg, model, batch["tokens"])
    for g in model.groups:
        x = _hybrid_rec(cfg, x, g["rec1"])[0]
        x = _hybrid_rec(cfg, x, g["rec2"])[0]
        x = _hybrid_attn(cfg, x, g["attn"], pos)[0]
    for sub in model.tail if "tail" in model else ():
        x = _hybrid_rec(cfg, x, sub)[0]
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
    for g in model.groups:
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
        for sub in model.tail:
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
    return _ffn(cfg, x + y, sub, "ln_mlp"), st["h"], st["conv"]


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
        x = x + att.reshape(B, 1, -1) @ sub["mix"]["wo"]
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
    for blk in model.blocks:
        h = apply_norm(cfg, x, blk["ln1"])
        x = x + ssm_lib.ssd_apply(cfg, h, blk["ssm"], chunk=cfg.ssd_chunk)
    return (apply_norm(cfg, x, model.final_norm),
            torch.zeros((), device=x.device))


def ssm_prefill(cfg, model, batch, cache_size=0):
    """-> (cache {"ssm": [L, B, H, P, N], "conv": [L, B, 3, ch], "len"},
    logits [B, 1, V]); the state is O(1) in the sequence, so
    ``cache_size`` is unused."""
    x = _embed_seq(cfg, model, batch["tokens"])[0]
    sts, cvs = [], []
    for blk in model.blocks:
        h = apply_norm(cfg, x, blk["ln1"])
        y, st = ssm_lib.ssd_apply(cfg, h, blk["ssm"], chunk=cfg.ssd_chunk,
                                  return_state=True)
        x = x + y
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
        x = x + y
        sts.append(ns["ssm"])
        cvs.append(ns["conv"])
    x = apply_norm(cfg, x, model.final_norm)
    return (unembed(cfg, model, x)[:, 0].float(),
            {"ssm": torch.stack(sts), "conv": torch.stack(cvs),
             "len": cache["len"] + 1})

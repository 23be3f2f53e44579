"""Shared model layers: norms, RoPE, QKV projection, MLP variants, and
chunked-flash attention (with its hand-written backward) and decode
attention.

The port of ``repro.models.layers``.  Parameters are
mappings of tensors (``nn.ParameterDict`` in the model, plain dicts in the
tests) in the JAX package's ``[in, out]`` layout, so ``x @ w`` is the same
product in both and the weight bridge is a plain copy.

Dtype policy as in the reference: norms and RoPE compute in float32 and
cast back to the activation dtype; matrix products run in the weights'
dtype (bf16 with float32 accumulation on the card).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import rules

# ---------------------------------------------------------------------------
# Norms


def rmsnorm(x, scale, eps=1e-6):
    """RMSNorm scaling by ``1 + scale`` (gemma convention)."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    """LayerNorm in float32 with optional learned scale and bias."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def nonparam_layernorm(x, eps=1e-5):
    """OLMo-style non-parametric LayerNorm (no learned scale/bias)."""
    return layernorm(x, None, None, eps)


def apply_norm(cfg, x, norm_params):
    """The config's norm over the last axis; under a mesh the output's
    sequence is gathered (``rules.gather_seq``) for the products that
    read it."""
    if cfg.norm_type == "rmsnorm":
        y = rmsnorm(x, norm_params["scale"], cfg.norm_eps)
    elif cfg.norm_type == "layernorm":
        y = layernorm(x, norm_params["scale"], norm_params["bias"])
    elif cfg.norm_type == "nonparam_ln":
        y = nonparam_layernorm(x)
    else:
        raise ValueError(cfg.norm_type)
    return rules.gather_seq(y)


def init_norm(cfg, d, dtype=torch.bfloat16, device=None):
    """Norm parameters as in the reference (rmsnorm scale starts at 0)."""
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {}  # non-parametric


# ---------------------------------------------------------------------------
# RoPE


def rope_angles(positions, head_dim, theta):
    """positions [*(pos)] -> (sin, cos) each [*(pos), head_dim/2], fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x [..., H, D]; sin/cos broadcastable to [..., 1, D/2] (split-half)."""
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs


def mlp_apply(cfg, x, p):
    """The config's MLP variant: swiglu, geglu (tanh GELU), gelu (with
    optional biases) or relu2."""
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    if cfg.mlp_type == "geglu":  # gemma-family gated GELU
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
        return h @ p["w_down"]
    if cfg.mlp_type == "gelu":
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"].to(x.dtype)
        y = F.gelu(h, approximate="tanh") @ p["w_down"]
        if "b_down" in p:
            y = y + p["b_down"].to(x.dtype)
        return y
    if cfg.mlp_type == "relu2":  # Nemotron-4 squared ReLU
        h = torch.square(F.relu(x @ p["w_up"]))
        return h @ p["w_down"]
    raise ValueError(cfg.mlp_type)


def _normal(gen, shape, std, dtype, device):
    """Seeded normal draw made on ``gen``'s device, then cast and moved."""
    w = torch.randn(shape, generator=gen, device=gen.device) * std
    return w.to(dtype=dtype, device=device)


def init_mlp(cfg, gen, d, ff, dtype=torch.bfloat16, bias=False, device=None):
    """MLP weights with the reference's shapes and scales."""
    std_in, std_out = 0.02, 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    p = {}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _normal(gen, (d, ff), std_in, dtype, device)
        p["w_up"] = _normal(gen, (d, ff), std_in, dtype, device)
        p["w_down"] = _normal(gen, (ff, d), std_out, dtype, device)
    else:
        p["w_up"] = _normal(gen, (d, ff), std_in, dtype, device)
        p["w_down"] = _normal(gen, (ff, d), std_out, dtype, device)
        if bias:
            p["b_up"] = torch.zeros((ff,), dtype=dtype, device=device)
            p["b_down"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Attention block params


def init_attention(cfg, gen, dtype=torch.bfloat16, device=None):
    """Attention projections with the reference's shapes and scales; the
    port's options add the output gate ``wg`` [d, Hq·D] and the QK-norm
    scales ``q_norm``/``k_norm`` [D] (``configs/base.py::PortArchConfig``)."""
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std_in, std_out = 0.02, 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    p = {
        "wq": _normal(gen, (d, Hq * Dh), std_in, dtype, device),
        "wk": _normal(gen, (d, Hkv * Dh), std_in, dtype, device),
        "wv": _normal(gen, (d, Hkv * Dh), std_in, dtype, device),
        "wo": _normal(gen, (Hq * Dh, d), std_out, dtype, device),
    }
    if cfg.attn_bias:  # qwen2-style QKV bias
        p["bq"] = torch.zeros((Hq * Dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hkv * Dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hkv * Dh,), dtype=dtype, device=device)
    if cfg.attn_gate:
        p["wg"] = _normal(gen, (d, Hq * Dh), std_in, dtype, device)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((Dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((Dh,), dtype=dtype, device=device)
    return p


def attention_qkv(cfg, x, p, positions, rope: bool | None = None):
    """Project to q/k/v, RMS-normalise each head of q and k where ``p``
    holds ``q_norm``/``k_norm`` (QK-norm), then apply RoPE unless ``rope``
    is False (None: ``cfg.use_rope``).  x [B,S,d] -> q [B,S,Hq,D], k/v."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = rules.split_heads(q, Hq).reshape(B, S, Hq, Dh)
    k = rules.split_heads(k, Hkv).reshape(B, S, Hkv, Dh)
    v = rules.split_heads(v, Hkv).reshape(B, S, Hkv, Dh)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope if rope is None else rope:
        sin, cos = rope_angles(positions, Dh, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def attention_out(cfg, h, att, p):
    """The attention block's output from the merged heads ``att`` [..,
    Hq·D] of the normed input ``h``: times ``sigmoid(h·wg)`` where ``p``
    has the output gate, then ``wo``."""
    if "wg" in p:
        g = torch.sigmoid((h @ p["wg"]).float())
        att = (att.float() * g).to(att.dtype)
    return att @ p["wo"]


# ---------------------------------------------------------------------------
# Attention (chunked online softmax for forward/prefill; one product for
# decode).  Plain tensor ops, as the reference's jnp: the masks and the
# handling of a row with every key masked are the reference's own, so
# neither is ``scaled_dot_product_attention``.  Scores, softmax and the
# accumulator are float32 whatever the inputs' dtype (the reference's
# ``preferred_element_type``): each product runs on float32 copies of its
# operands, and the probabilities are rounded to V's dtype first, as the
# reference rounds them before its PV product.


def _f32_einsum(eq, a, b):
    return torch.einsum(eq, a.float(), b.float())


def _flash_mask(k_pos, q_pos, Sk, causal, window, prefix_len):
    """[Sq, chunk] bool validity mask."""
    mask = k_pos[None, :] < Sk  # KV padding
    if causal:
        cm = q_pos[:, None] >= k_pos[None, :]
        if prefix_len:
            cm = cm | (k_pos[None, :] < prefix_len)  # bidirectional prefix
        mask = mask & cm
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask


def _flash_chunks(x, chunk):
    """x [B, S, H, D] right-padded to whole chunks -> ([B, n, chunk, H, D],
    n)."""
    B, S, H, D = x.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
    return x.reshape(B, n, chunk, H, D), n


def _flash_fwd(qg, k, v, cfgt):
    """The forward loop over KV chunks: qg [B, Sq, Hkv, G, D], k/v [B, Sk,
    Hkv, D] -> (out float32 [B, Sq, Hkv, G, D], lse float32 [B, Sq, Hkv,
    G]); ``lse`` is -inf where no key is visible, and ``out`` 0 there."""
    causal, chunk, window, q_offset, prefix_len = cfgt
    Sk, D = k.shape[1], qg.shape[-1]
    scale = 1.0 / math.sqrt(D)
    kc, n = _flash_chunks(k, chunk)
    vc, _ = _flash_chunks(v, chunk)
    dev = qg.device
    q_pos = q_offset + torch.arange(qg.shape[1], device=dev)
    m = torch.full(qg.shape[:-1], -math.inf, device=dev)
    l = torch.zeros(qg.shape[:-1], device=dev)
    acc = torch.zeros(qg.shape, device=dev)
    for ci in range(n):
        kb, vb = kc[:, ci], vc[:, ci]
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        s = _f32_einsum("bqhgd,bkhd->bqhgk", qg, kb) * scale
        mask = _flash_mask(k_pos, q_pos, Sk, causal, window,
                           prefix_len)[None, :, None, None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = _f32_einsum("bqhgk,bkhd->bqhgd", p.to(vb.dtype), vb)
        acc = acc * alpha[..., None] + pv
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = acc / l_safe[..., None]
    lse = torch.where(l > 0, m + torch.log(l_safe), -math.inf)
    return out, lse


class _FlashCore(torch.autograd.Function):
    """Flash attention with the reference's hand-written backward
    (``_flash_core``'s ``custom_vjp``).  The forward saves only (qg, k, v,
    out, lse), and the backward recomputes each KV chunk's probabilities
    from ``lse`` in its own loop, so no chunk's Sq×chunk scores outlive
    it.  Autograd never sees the forward loop."""

    @staticmethod
    def forward(ctx, qg, k, v, cfgt):
        out, lse = _flash_fwd(qg, k, v, cfgt)
        ctx.save_for_backward(qg, k, v, out, lse)
        ctx.cfgt = cfgt
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, out, lse = ctx.saved_tensors
        causal, chunk, window, q_offset, prefix_len = ctx.cfgt
        B, Sq, Hkv, G, D = qg.shape
        Sk = k.shape[1]
        scale = 1.0 / math.sqrt(D)
        kc, n = _flash_chunks(k, chunk)
        vc, _ = _flash_chunks(v, chunk)
        dev = qg.device
        q_pos = q_offset + torch.arange(Sq, device=dev)
        dout32 = dout.float()
        delta = torch.sum(dout32 * out, dim=-1)  # [B, Sq, Hkv, G]
        lse_safe = torch.where(torch.isfinite(lse), lse, 0.0)
        q32 = qg.float()
        dq = torch.zeros(qg.shape, device=dev)
        dks, dvs = [], []
        for ci in range(n):
            kb, vb = kc[:, ci], vc[:, ci]
            k_pos = ci * chunk + torch.arange(chunk, device=dev)
            s = _f32_einsum("bqhgd,bkhd->bqhgk", qg, kb) * scale
            mask = _flash_mask(k_pos, q_pos, Sk, causal, window,
                               prefix_len)[None, :, None, None, :]
            p = torch.where(mask, torch.exp(s - lse_safe[..., None]), 0.0)
            dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dout32))
            dp = _f32_einsum("bqhgd,bkhd->bqhgk", dout, vb)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + _f32_einsum("bqhgk,bkhd->bqhgd", ds.to(kb.dtype), kb)
            dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, q32))
        dk = torch.cat(dks, dim=1)[:, :Sk]
        dv = torch.cat(dvs, dim=1)[:, :Sk]
        return dq.to(qg.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q, k, v, *, causal=True, chunk=512, window=None,
                    q_offset=0, prefix_len=0):
    """Online-softmax attention over KV chunks, without an S×S score
    matrix, with the reference's memory-true backward
    (:class:`_FlashCore`).

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] with Hq % Hkv == 0 (GQA, as
    ``[B, Sq, Hkv, G, D]``).  ``window``: sliding-window size (None =
    full); ``prefix_len``: leading positions that attend bidirectionally
    (VLM image prefix); ``q_offset``: global position of q[0].  A query
    whose every key is masked gets 0.  Returns [B, Sq, Hq, D] in q.dtype.
    """
    kw = dict(causal=causal, chunk=chunk, window=window, q_offset=q_offset,
              prefix_len=prefix_len)
    if rules.sharded_on_mesh(q):
        return _flash_sharded(q, k, v, kw)
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    out = _FlashCore.apply(qg, k, v,
                           (causal, chunk, window, q_offset, prefix_len))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _flash_sharded(q, k, v, kw):
    """:func:`flash_attention` on DTensors: each rank attends over its batch
    rows and, over 'model', its query heads with their KV heads
    (``rules.head_slab``): its own KV heads where 'model' divides them,
    else the KV heads its query slab reads, cut from whole K/V; where the
    query heads do not divide either, every rank attends over all heads."""
    how, kv = rules.head_slab(q.shape[2], k.shape[2])
    qs = rules.batch_spec(q, 0, 2, how != "whole")
    ks = rules.batch_spec(k, 0, 2, how == "heads")

    def attend(q, k, v):
        if kv is not None:
            k, v = (t.narrow(2, kv[0], kv[1]) for t in (k, v))
        return flash_attention(q, k, v, **kw)

    return rules.local(attend, (q, k, v), (qs, ks, ks), qs)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """Single-token attention over a (possibly longer-than-valid) cache.

    q: [B, 1, Hq, D]; caches: [B, S, Hkv, D]; cache_len: [] or [B] valid
    length (slots ``< cache_len`` are read; with ``window``, also only
    slots ``>= cache_len - window``).  Returns [B, 1, Hq, D] in q.dtype.
    Under a mesh: :func:`_decode_attention_sharded`."""
    if rules.sharded_on_mesh(k_cache):
        return _decode_attention_sharded(q, k_cache, v_cache, cache_len,
                                         window)
    s = _decode_scores(q, k_cache, cache_len, window)
    p = torch.softmax(s, dim=-1)
    o = _decode_mix(p, v_cache)
    return o.reshape(q.shape).to(q.dtype)


def _decode_scores(q, k_cache, cache_len, window, first=0):
    """Masked float32 scores [B, Hkv, G, S] of q against the cache's slots
    (``first``: the global index of its slot 0)."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    s = _f32_einsum("bhgd,bkhd->bhgk", qg, k_cache) / math.sqrt(D)
    k_pos = torch.arange(first, first + S, device=q.device)
    n = cache_len.reshape(-1, 1)
    valid = k_pos[None, :] < n  # [B or 1, S]
    if window is not None:
        valid = valid & (k_pos[None, :] >= n - window)
    return torch.where(valid[:, None, None, :], s, -math.inf)


def _decode_mix(p, v_cache):
    """The probabilities [B, Hkv, G, S], rounded to V's dtype as the
    reference rounds them, times V -> float32 [B, Hkv, G, D]."""
    return _f32_einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)


def _decode_attention_sharded(q, k_cache, v_cache, cache_len, window):
    """:func:`decode_attention` over a DTensor cache whose slots
    ``cache_specs`` put over 'model': each rank scores its slots against
    every head (q whole), the softmax runs over all slots (DTensor gathers
    the scores, B·Hq·S floats, not the cache), and each rank mixes its
    slots' values, a partial sum over 'model'."""
    split = rules.model_sharded(k_cache, 1)
    first = rules.shard_offset(k_cache, 1)
    cs = rules.batch_spec(k_cache, 0, 1, split)
    dp = cs[0]
    ss = (dp, None, None, "model" if split else None)
    s = rules.local(
        lambda q, k, n: _decode_scores(q, k, n, window, first),
        (q, k_cache, cache_len),
        ((dp, None, None, None), cs, (dp,) if cache_len.ndim else ()), ss)
    p = torch.softmax(s, dim=-1)
    o = rules.local(_decode_mix, (p, v_cache), (ss, cs), rules.placements(
        (dp, None, None, None), rules.current_mesh(),
        partial=("model",) if split else ()))
    return rules.settle(o).reshape(q.shape).to(q.dtype)

"""Shared model layers: norms, RoPE, QKV projection, MLP variants, and
chunked-flash (forward) and decode attention.

The port of ``repro.models.layers`` (forward only: the flash backward
ports with training, ROADMAP A.7).  Parameters are
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
    """The config's norm over the last axis."""
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, norm_params["scale"])
    if cfg.norm_type == "layernorm":
        return layernorm(x, norm_params["scale"], norm_params["bias"])
    if cfg.norm_type == "nonparam_ln":
        return nonparam_layernorm(x)
    raise ValueError(cfg.norm_type)


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
    """Attention projections with the reference's shapes and scales."""
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
    return p


def attention_qkv(cfg, x, p, positions):
    """Project to q/k/v with RoPE applied.  x [B,S,d] -> q [B,S,Hq,D], k/v."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, Hq, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if cfg.use_rope:
        sin, cos = rope_angles(positions, Dh, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


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


def flash_attention(q, k, v, *, causal=True, chunk=512, window=None,
                    q_offset=0, prefix_len=0):
    """Online-softmax attention over KV chunks, without an S×S score
    matrix (forward only: the reference's backward ports with training).

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] with Hq % Hkv == 0 (GQA, as
    ``[B, Sq, Hkv, G, D]``).  ``window``: sliding-window size (None =
    full); ``prefix_len``: leading positions that attend bidirectionally
    (VLM image prefix); ``q_offset``: global position of q[0].  A query
    whose every key is masked gets 0.  Returns [B, Sq, Hq, D] in q.dtype.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    scale = 1.0 / math.sqrt(D)
    kc, n = _flash_chunks(k, chunk)
    vc, _ = _flash_chunks(v, chunk)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
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
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """Single-token attention over a (possibly longer-than-valid) cache.

    q: [B, 1, Hq, D]; caches: [B, S, Hkv, D]; cache_len: [] or [B] valid
    length (slots ``< cache_len`` are read; with ``window``, also only
    slots ``>= cache_len - window``).  Returns [B, 1, Hq, D] in q.dtype.
    """
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    s = _f32_einsum("bhgd,bkhd->bhgk", qg, k_cache) / math.sqrt(D)
    k_pos = torch.arange(S, device=q.device)
    n = cache_len.reshape(-1, 1)
    valid = k_pos[None, :] < n  # [B or 1, S]
    if window is not None:
        valid = valid & (k_pos[None, :] >= n - window)
    s = torch.where(valid[:, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = _f32_einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, Hq, D).to(q.dtype)

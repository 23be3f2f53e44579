"""Dense decoder layers: norms, RoPE, QKV projection, MLP variants.

The port of the dense subset of ``repro.models.layers``.  Parameters are
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

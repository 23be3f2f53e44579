"""Plain float32 forward of the toy family ``relu2``, and its fp8 control.

One sequence, whole: embed, then per layer non-parametric LayerNorm (eps
1e-5), causal attention with split-half RoPE, LayerNorm and the
squared-ReLU MLP ``relu(h @ w_up)² @ w_down``, then a final LayerNorm and
the tied unembedding.  Every product in float32 with TF32 off; with
``precision="fp8"`` every product's operands rounded to float8 e4m3 (one
scale a row of activations, a column of weights).  Imports nothing of the
program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(t, dim):
    scale = E4M3_MAX / t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def _ln(x):
    mu = x.mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True)
                                  + 1e-5)


def _rope(x, theta):
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(x.shape[0], device=x.device).float()[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward_logits(spec, params, tokens, precision="fp32"):
    """Logits [S, vocab] float32 of one sequence ``tokens`` [S]."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")

    def mm(x, w):
        w = w.float()
        return (_fp8(x, -1) @ _fp8(w, -2)) if precision == "fp8" else x @ w

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tok = params["embed"]["tok"]
        tokens = torch.as_tensor(tokens, device=tok.device)
        S, Hq, Hkv, D = (tokens.shape[0], spec.n_heads, spec.n_kv_heads,
                         spec.head_dim)
        causal = torch.ones(S, S, dtype=torch.bool,
                            device=tok.device).tril()
        x = tok[tokens].float()
        for blk in params["blocks"]:
            h, a = _ln(x), blk["attn"]
            q = _rope(mm(h, a["wq"]).view(S, Hq, D), spec.rope_theta)
            k = _rope(mm(h, a["wk"]).view(S, Hkv, D), spec.rope_theta)
            v = mm(h, a["wv"]).view(S, Hkv, D)
            k = k.repeat_interleave(Hq // Hkv, dim=1)
            v = v.repeat_interleave(Hq // Hkv, dim=1)
            s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
            p = torch.softmax(s.masked_fill(~causal, -math.inf), -1)
            o = torch.einsum("hqk,khd->qhd", p, v).reshape(S, Hq * D)
            x = x + mm(o, a["wo"])
            m = blk["mlp"]
            x = x + mm(torch.square(F.relu(mm(_ln(x), m["w_up"]))),
                       m["w_down"])
        return mm(_ln(x), tok.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

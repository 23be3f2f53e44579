"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of ``repro.models.rglru``.  Temporal mixing: x -> W_in ->
depthwise conv(4) -> RG-LRU -> (* gelu gate) -> W_out.  The RG-LRU
recurrence

    r_t = sigmoid(W_a u_t),  i_t = sigmoid(W_x u_t)
    a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

is linear in h.  The reference runs ``jax.lax.associative_scan`` within
chunks; torch has none, so :func:`_scan` is a log-depth doubling
(Hillis–Steele) scan over ``(a, b)`` pairs with the same :func:`_combine`.
It multiplies the decays pairwise and never divides by a running product:
``a`` is as small as ``exp(-8·softplus(lam))`` a step, and a cumulative
product of it underflows to 0 within a chunk.  The two scans associate
the same products differently, so they agree to float32 rounding.

``F.softplus`` switches to the identity above ``threshold=20`` where
``jax.nn.softplus`` does not; the two differ there by under 1e-8 relative.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import rules
from .layers import _normal

_C = 8.0


def init_rglru(cfg, gen, dtype=torch.bfloat16, device=None):
    """Seeded weights with the reference's shapes and scales; ``lam`` is
    float32 whatever the model's dtype."""
    d, dr = cfg.d_model, cfg.rnn_width
    std_in, std_out = 0.02, 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "w_in": _normal(gen, (d, dr), std_in, dtype, device),
        "w_gate": _normal(gen, (d, dr), std_in, dtype, device),
        "conv_w": _normal(gen, (4, dr), 0.2, dtype, device),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=device),
        "w_a": _normal(gen, (dr, dr), std_in, dtype, device),
        "w_x": _normal(gen, (dr, dr), std_in, dtype, device),
        "lam": torch.full((dr,), 0.72, dtype=torch.float32, device=device),
        "w_out": _normal(gen, (dr, d), std_out, dtype, device),
    }


def _conv1d(u, w, b, cache=None):
    """Depthwise causal conv, width 4.  cache: [B, 3, ch] previous inputs
    (its dtype and u's promote, as the reference's concatenation does).
    Returns (conv output, the last 3 inputs)."""
    B, S, ch = u.shape
    if cache is None:
        cache = u.new_zeros((B, 3, ch))
    dt = torch.promote_types(cache.dtype, u.dtype)
    up = torch.cat([cache.to(dt), u.to(dt)], dim=1)
    out = sum(up[:, i:i + S, :] * w[i][None, None, :] for i in range(4))
    return out + b[None, None, :], up[:, -3:, :]


def _gates(u, p):
    """Per-step decay a and input b, float32 [B, S, dr] (under a mesh the
    gate products read u whole over 'model', ``rules.gather_model``)."""
    uw = rules.gather_model(u)
    r = torch.sigmoid((uw @ p["w_a"]).float())
    i = torch.sigmoid((uw @ p["w_x"]).float())
    log_a = -_C * F.softplus(p["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())
    return a, b


def _combine(lhs, rhs):
    """The earlier step ``lhs`` then ``rhs``: h -> a2 (a1 h + b1) + b2."""
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


def _scan(a, b):
    """Inclusive scan of :func:`_combine` along axis 1 -> h [B, S, dr]
    (h_t with h_{-1} = 0): each of the ceil(log2 S) rounds combines every
    step with the one ``k`` before it."""
    S = a.shape[1]
    k = 1
    while k < S:
        a2, b2 = _combine((a[:, :-k], b[:, :-k]), (a[:, k:], b[:, k:]))
        a = torch.cat([a[:, :k], a2], dim=1)
        b = torch.cat([b[:, :k], b2], dim=1)
        k *= 2
    return b


def _add_first(b, a, h):
    """b with ``a[:, 0] * h`` added at step 0 (a fresh tensor)."""
    return torch.cat([b[:, :1] + a[:, :1] * h[:, None], b[:, 1:]], dim=1)


def rglru_apply(cfg, x, p, h0=None, return_state=False, chunk=512):
    """Full-sequence recurrent block.  x [B, S, d] -> (y [B, S, d], h_last
    [B, dr]), or with ``return_state`` (y, {"h", "conv"}).

    When ``chunk`` divides S and S > chunk, the scan runs within chunks
    with the state carried across them in order (the reference's bound on
    its backward's memory); otherwise over the whole sequence."""
    B, S, _ = x.shape
    u = x @ p["w_in"]
    u, conv_cache = _conv1d(u, p["conv_w"], p["conv_b"])
    a, b = _gates(u, p)
    if h0 is not None:
        b = _add_first(b, a, h0)
    if S % chunk == 0 and S > chunk:
        h_last = a.new_zeros((B, a.shape[-1]))
        hs = []
        for i in range(0, S, chunk):
            ai = a[:, i:i + chunk]
            hi = _scan(ai, _add_first(b[:, i:i + chunk], ai, h_last))
            h_last = hi[:, -1, :]
            hs.append(hi)
        h = torch.cat(hs, dim=1)
    else:
        h = _scan(a, b)
        h_last = h[:, -1, :]
    gate = F.gelu((x @ p["w_gate"]).float(), approximate="tanh")
    y = (h * gate).to(x.dtype) @ p["w_out"]
    if return_state:
        return y, {"h": h_last, "conv": conv_cache}
    return y, h_last


def rglru_decode_init(cfg, batch, device=None):
    """A zero decode state: h float32, the conv cache bf16 (as the
    reference makes it, whatever the model's dtype)."""
    dr = cfg.rnn_width
    return {"h": torch.zeros((batch, dr), device=device),
            "conv": torch.zeros((batch, 3, dr), dtype=torch.bfloat16,
                                device=device)}


def rglru_decode_step(cfg, x, p, state):
    """One token.  x [B, 1, d] -> (y [B, 1, d], new state)."""
    u = x @ p["w_in"]
    u, conv_cache = _conv1d(u, p["conv_w"], p["conv_b"], cache=state["conv"])
    a, b = _gates(u, p)
    h = a[:, 0] * state["h"] + b[:, 0]  # [B, dr]
    gate = F.gelu((x @ p["w_gate"]).float(), approximate="tanh")
    y = (h[:, None, :] * gate).to(x.dtype)
    return y @ p["w_out"], {"h": h, "conv": conv_cache}

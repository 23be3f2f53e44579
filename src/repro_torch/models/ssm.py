"""Mamba-2: the State Space Duality (SSD) mixer in its chunked matmul form.

The port of ``repro.models.ssm``.  SSD (Dao & Gu, 2024) computes the
selective-SSM recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,   y_t = C_t . h_t + D x_t

as (i) an intra-chunk attention-like term through a decay-masked C·Bᵀ
product and (ii) an inter-chunk low-rank state hand-off: matrix products
plus one short sequential loop over chunks.  The reference computes it in
jnp (no Pallas kernel), so the port is plain tensor ops; each three-way
einsum of the reference is written as an elementwise product and one
two-operand einsum.

Layout as the reference's: d_inner = 2·d_model, heads of 64, one SSM group,
state size N, a depthwise conv of width 4 on the (x, B, C) projections.
``A_log``, ``D`` and ``dt_bias`` are float32 whatever the model's dtype.
``F.softplus`` switches to the identity above ``threshold=20`` where
``jax.nn.softplus`` does not; the two differ there by under 1e-8 relative.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import rules
from .layers import _normal


def ssm_dims(cfg):
    """(d_inner, headdim P, heads H, state N)."""
    d_inner = 2 * cfg.d_model
    headdim = 64
    return d_inner, headdim, d_inner // headdim, cfg.ssm_state


def init_ssm(cfg, gen, dtype=torch.bfloat16, device=None):
    """Seeded weights with the reference's shapes, scales and dtypes."""
    d = cfg.d_model
    d_inner, P, H, N = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N  # x, B, C get the depthwise conv
    proj_out = 2 * d_inner + 2 * N + H  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _normal(gen, (d, proj_out), 0.02, dtype, device),
        "conv_w": _normal(gen, (4, conv_dim), 0.2, dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "out_proj": _normal(gen, (d_inner, d),
                            0.02 / math.sqrt(2 * max(cfg.n_layers, 1)),
                            dtype, device),
    }


def _split_proj(cfg, zxbcdt):
    """-> (z, xBC, dt) along the last axis."""
    d_inner, P, H, N = ssm_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)


def _conv1d(xBC, w, b, cache=None):
    """Depthwise causal conv, width 4, then SiLU.  cache: [B, 3, ch]
    previous inputs (its dtype and the input's promote).  Returns (output,
    the last 3 inputs)."""
    B, S, ch = xBC.shape
    if cache is None:
        cache = xBC.new_zeros((B, 3, ch))
    dt = torch.promote_types(cache.dtype, xBC.dtype)
    xp = torch.cat([cache.to(dt), xBC.to(dt)], dim=1)  # [B, S+3, ch]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(4))
    return F.silu(out + b[None, None, :]), xp[:, -3:, :]


def _segsum(x):
    """x [..., Q] -> [..., Q, Q]: sum_{i=s+1..l} x_i for l >= s, -inf above
    the diagonal (so its exp is 0 there)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -math.inf)


def ssd_apply(cfg, x, p, chunk=128, return_state=False):
    """Full-sequence SSD.  x [B, S, d] -> y [B, S, d] (and with
    ``return_state`` the decode state {"ssm", "conv"}).

    A sequence ``chunk`` does not divide is right-padded; padded steps get
    ``dt_raw = -1e9`` (softplus 0) and a zero mask on dt, so they leave the
    state untouched, and the conv cache is taken from the TRUE sequence
    end.  Under a mesh the projections are DTensor products and the mixer
    between them runs on each rank's batch rows, whole over 'model' (its
    conv and scan cut neither the channels nor the heads evenly)."""
    S_true = x.shape[1]
    proj = x @ p["in_proj"]
    args = (proj, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"])
    mix = functools.partial(_ssd_mix, cfg, chunk, x.dtype)
    if rules.sharded_on_mesh(proj):
        bs = rules.batch_spec(proj)
        dp = bs[0]
        y, carry, conv_cache = rules.local(
            mix, args, (bs, (None, None)) + ((None,),) * 4,
            [bs, (dp, None, None, None), (dp, None, None)])
    else:
        y, carry, conv_cache = mix(*args)
    out = (y @ p["out_proj"])[:, :S_true]
    if return_state:
        return out, {"ssm": carry, "conv": conv_cache}
    return out


def _ssd_mix(cfg, chunk, dtype, proj, conv_w, conv_b, dt_bias, A_log, D):
    """The mixer between the projections: proj [B, S, proj_out] -> (y [B,
    S_padded, d_inner] in ``dtype``, the final state, the conv cache)."""
    B, S_true, _ = proj.shape
    d_inner, P, H, N = ssm_dims(cfg)
    z, xBC, dt_raw = _split_proj(cfg, proj)
    pad = (-S_true) % chunk
    xBC_raw = xBC
    if pad:
        xBC = F.pad(xBC, (0, 0, 0, pad))
        dt_raw = F.pad(dt_raw, (0, 0, 0, pad), value=-1e9)
        z = F.pad(z, (0, 0, 0, pad))
    S = S_true + pad
    xBC, _ = _conv1d(xBC, conv_w, conv_b)
    left = torch.cat([xBC_raw.new_zeros((B, 3, xBC_raw.shape[-1])), xBC_raw],
                     dim=1)
    conv_cache = left[:, S_true:S_true + 3, :]
    xs, B_, C_ = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + dt_bias)  # [B, S, H]
    if pad:
        live = torch.arange(S, device=proj.device) < S_true
        dt = dt * live[None, :, None].to(dt.dtype)
    A = -torch.exp(A_log)  # [H]

    nc = S // chunk
    xc = xs.reshape(B, nc, chunk, H, P).float()
    Bc = B_.reshape(B, nc, chunk, N).float()
    Cc = C_.reshape(B, nc, chunk, N).float()
    dtc = dt.reshape(B, nc, chunk, H)
    dA = dtc * A[None, None, None, :]  # [B, nc, Q, H]
    dAcs = torch.cumsum(dA, dim=2)

    # (i) intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA.transpose(-1, -2)))  # [B, nc, H, Q, Q]
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)  # [B, nc, Q, Q]
    xdt = xc * dtc[..., None]  # [B, nc, Q, H, P]
    y_diag = torch.einsum("bchls,bcshp->bclhp", CB[:, :, None] * L, xdt)

    # (ii) inter-chunk states
    decay_end = torch.exp(dAcs[:, :, -1:, :] - dAcs)  # [B, nc, Q, H]
    states = torch.einsum("bcsn,bcshp->bchpn", Bc, decay_end[..., None] * xdt)
    chunk_decay = torch.exp(dAcs[:, :, -1, :])  # [B, nc, H]
    carry = proj.new_zeros((B, H, P, N), dtype=torch.float32)
    states_in = []  # each chunk's INCOMING state
    for c in range(nc):
        states_in.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    states_in = torch.stack(states_in, dim=1)  # [B, nc, H, P, N]
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, states_in) \
        * torch.exp(dAcs)[..., None]

    y = (y_diag + y_off).reshape(B, S, H, P)
    y = y + xs.reshape(B, S, H, P).float() * D[None, None, :, None]
    y = y.reshape(B, S, d_inner) * F.silu(z.float())
    return y.to(dtype), carry, conv_cache


def ssd_decode_init(cfg, batch, device=None):
    """A zero decode state: ssm [B, H, P, N] float32, the conv cache bf16
    (as the reference makes it, whatever the model's dtype)."""
    d_inner, P, H, N = ssm_dims(cfg)
    return {"ssm": torch.zeros((batch, H, P, N), device=device),
            "conv": torch.zeros((batch, 3, d_inner + 2 * N),
                                dtype=torch.bfloat16, device=device)}


def ssd_decode_step(cfg, x, p, state):
    """One token.  x [B, 1, d] -> (y [B, 1, d], new state)."""
    B = x.shape[0]
    d_inner, P, H, N = ssm_dims(cfg)
    z, xBC, dt = _split_proj(cfg, x @ p["in_proj"])
    xBC, conv_cache = _conv1d(xBC, p["conv_w"], p["conv_b"],
                              cache=state["conv"])
    xs, B_, C_ = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # [B, H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])  # [B, H]
    xh = xs.reshape(B, H, P).float()
    Bv = B_[:, 0].float()  # [B, N]
    Cv = C_[:, 0].float()
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bv)
    ssm = state["ssm"] * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", ssm, Cv) + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, d_inner) * F.silu(z.float())
    return y.to(x.dtype) @ p["out_proj"], {"ssm": ssm, "conv": conv_cache}

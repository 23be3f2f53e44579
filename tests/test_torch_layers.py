"""Dense decoder layers of the port against the JAX package, in float32.

Same inputs (numpy, from a seed) through both.  Tolerance: 1e-5 abs/rel —
both sides compute in float32 and differ only in summation order and in
the last bits of the transcendental functions (exp/sin/cos/tanh).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(0)


def _cfgs(**over):
    j = dataclasses.replace(jreduced(jget("olmo-1b")), **over)
    t = dataclasses.replace(treduced(tget("olmo-1b")), **over)
    return j, t


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _randn(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms(norm):
    jc, tc = _cfgs(norm_type=norm)
    x = _randn(2, 5, 64, scale=3.0)
    p = {"scale": _randn(64), "bias": _randn(64)}
    jx, tx = _both(x)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(jl.apply_norm(jc, jx, jp), tl.apply_norm(tc, tx, tp))


def test_rope_split_half():
    pos = RNG.integers(0, 300, (3, 7)).astype(np.int32)
    js, jc = jl.rope_angles(jnp.asarray(pos), 16, 1e4)
    ts, tc = tl.rope_angles(torch.from_numpy(pos), 16, 1e4)
    _close(js, ts, dict(atol=2e-4, rtol=1e-5))  # angles up to ~300 rad
    _close(jc, tc, dict(atol=2e-4, rtol=1e-5))
    x = _randn(3, 7, 4, 16)
    jx, tx = _both(x)
    _close(jl.apply_rope(jx, js, jc), tl.apply_rope(tx, ts, tc))


@pytest.mark.parametrize("bias", [False, True])
def test_attention_qkv(bias):
    jc, tc = _cfgs(attn_bias=bias, n_kv_heads=2)
    d, Hq, Hkv, Dh = jc.d_model, jc.n_heads, jc.n_kv_heads, jc.head_dim
    p = {"wq": _randn(d, Hq * Dh, scale=0.1), "wk": _randn(d, Hkv * Dh, scale=0.1),
         "wv": _randn(d, Hkv * Dh, scale=0.1)}
    if bias:
        p.update(bq=_randn(Hq * Dh), bk=_randn(Hkv * Dh), bv=_randn(Hkv * Dh))
    x = _randn(2, 6, d)
    pos = RNG.integers(0, 50, (2, 6)).astype(np.int32)
    jout = jl.attention_qkv(jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                                 p.items()}, jnp.asarray(pos))
    tout = tl.attention_qkv(tc, torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(pos))
    for j, t in zip(jout, tout):
        _close(j, t, dict(atol=5e-5, rtol=1e-5))


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_variants(mlp):
    jc, tc = _cfgs(mlp_type=mlp)
    d, ff = jc.d_model, jc.d_ff
    p = {"w_gate": _randn(d, ff, scale=0.1), "w_up": _randn(d, ff, scale=0.1),
         "w_down": _randn(ff, d, scale=0.1)}
    if mlp == "gelu":
        p.update(b_up=_randn(ff), b_down=_randn(d))
    x = _randn(2, 3, d)
    _close(jl.mlp_apply(jc, jnp.asarray(x), {k: jnp.asarray(v)
                                            for k, v in p.items()}),
           tl.mlp_apply(tc, torch.from_numpy(x), {k: torch.from_numpy(v)
                                                 for k, v in p.items()}),
           dict(atol=5e-5, rtol=1e-5))


@pytest.mark.parametrize("tied,rope,scale", [(True, True, False),
                                             (False, True, True),
                                             (True, False, False)])
def test_embed_and_unembed(tied, rope, scale):
    jc, tc = _cfgs(tie_embeddings=tied, use_rope=rope, embed_scale=scale)
    embed = {"tok": _randn(jc.vocab_padded, jc.d_model, scale=0.02)}
    if not rope:  # learned positions
        embed["pos"] = _randn(jc.max_seq, jc.d_model, scale=0.02)
    tok = RNG.integers(0, jc.vocab, (2, 5)).astype(np.int32)
    pos = RNG.integers(0, jc.max_seq, (2, 5)).astype(np.int32)
    jx = jt.embed_tokens(jc, {k: jnp.asarray(v) for k, v in embed.items()},
                         jnp.asarray(tok), jnp.asarray(pos))
    params = {"embed": {k: torch.from_numpy(v) for k, v in embed.items()},
              "blocks": [], "final_norm": {}}
    jparams = {"embed": {k: jnp.asarray(v) for k, v in embed.items()}}
    if not tied:
        head = _randn(jc.d_model, jc.vocab_padded, scale=0.02)
        params["lm_head"] = torch.from_numpy(head)
        jparams["lm_head"] = jnp.asarray(head)
    model = tt.DecoderLM(dataclasses.replace(tc, n_layers=0), params)
    tx = tt.embed_tokens(tc, model.embed, torch.from_numpy(tok).long(),
                         torch.from_numpy(pos).long())
    _close(jx, tx)
    h = _randn(2, 5, jc.d_model)
    _close(jt.unembed(jc, jparams, jnp.asarray(h)),
           tt.unembed(tc, model, torch.from_numpy(h)))

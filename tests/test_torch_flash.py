"""The port's chunked-flash and decode attention against the JAX package's.

``repro_torch.models.layers.flash_attention`` (forward) and
``decode_attention`` against ``repro.models.layers``' on the same inputs
(numpy, from a seed).  Tolerance: 1e-5 abs/rel in float32 (the two differ
only in summation order and the last bits of exp); 2e-2 in bf16 (an
output may round to a neighbouring bf16 value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)

#: the reference's flash test cases (tests/test_flash_attention.py), then
#: a q_offset case (the last 16 queries of 64) and a chunk of 24 that
#: divides neither S nor the reference cases' 16
CASES = [
    dict(B=2, S=64, Hq=4, Hkv=2, D=16, causal=True, window=None, prefix=0),
    dict(B=1, S=48, Hq=4, Hkv=1, D=8, causal=True, window=16, prefix=0),
    dict(B=2, S=32, Hq=8, Hkv=8, D=16, causal=True, window=None, prefix=8),
    dict(B=2, S=40, Hq=4, Hkv=4, D=16, causal=False, window=None, prefix=0),
    dict(B=1, S=33, Hq=2, Hkv=1, D=8, causal=True, window=None, prefix=0),
    dict(B=1, S=64, Hq=2, Hkv=2, D=16, causal=True, window=None, prefix=0,
         q_last=16),
    dict(B=2, S=40, Hq=4, Hkv=2, D=16, causal=True, window=12, prefix=4,
         chunk=24),
]


def _qkv(c, seed):
    rng = np.random.default_rng(seed)
    Sq = c.get("q_last", c["S"])
    q = rng.standard_normal((c["B"], Sq, c["Hq"], c["D"])).astype(np.float32)
    k = rng.standard_normal((c["B"], c["S"], c["Hkv"], c["D"])).astype(np.float32)
    v = rng.standard_normal((c["B"], c["S"], c["Hkv"], c["D"])).astype(np.float32)
    return q, k, v


def _flash_both(c, q, k, v, tdtype=torch.float32, jdtype=jnp.float32):
    kw = dict(causal=c["causal"], chunk=c.get("chunk", 16),
              window=c["window"], prefix_len=c["prefix"],
              q_offset=c["S"] - q.shape[1])
    j = jl.flash_attention(*(jnp.asarray(a, jdtype) for a in (q, k, v)), **kw)
    t = tl.flash_attention(*(torch.from_numpy(a).to(tdtype)
                             for a in (q, k, v)), **kw)
    return np.asarray(j.astype(jnp.float32)), t


@pytest.mark.parametrize("c", CASES, ids=[str(i) for i in range(len(CASES))])
def test_flash_matches_reference(c):
    q, k, v = _qkv(c, seed=len(str(c)))
    j, t = _flash_both(c, q, k, v)
    assert t.dtype == torch.float32 and t.shape == q.shape
    np.testing.assert_allclose(t.numpy(), j, **TOL)


def test_flash_bf16_matches_reference():
    c = CASES[0]
    q, k, v = _qkv(c, seed=7)
    j, t = _flash_both(c, q, k, v, torch.bfloat16, jnp.bfloat16)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), j, atol=2e-2, rtol=2e-2)


def test_flash_fully_masked_rows_are_zero():
    """Queries whose every key is masked (window 0 past the prefix) give 0,
    not NaN, in both packages."""
    c = dict(CASES[0], window=0)
    q, k, v = _qkv(c, seed=3)
    j, t = _flash_both(c, q, k, v)
    assert np.all(j == 0) and torch.all(t == 0)


@pytest.mark.parametrize("lens", ["scalar", "per_row"])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_matches_reference(lens, window):
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, D = 3, 32, 4, 2, 16
    kc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    n = (np.int32(19) if lens == "scalar"
         else np.array([5, 32, 17], np.int32))
    j = jl.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(n), window=window)
    t = tl.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                            torch.from_numpy(vc), torch.as_tensor(n),
                            window=window)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)

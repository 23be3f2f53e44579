"""The port's recurrent mixers against the JAX package's: Mamba-2's SSD
(``models/ssm.py``) and RecurrentGemma's RG-LRU (``models/rglru.py``).

Reduced configs, float32 weights drawn by the reference's own ``init_*``
and handed over as numpy, the same inputs (numpy, from a seed) through
both.  Tolerance 1e-4 abs/rel: both compute in float32; the port's
doubling scan and the reference's ``associative_scan`` associate the
same products in another order, and the SSD einsums contract in another
order.  Then the port's own duality checks, as ``tests/test_model_math.py``
makes them for the reference: chunked SSD and the RG-LRU scan against
their token-by-token decode recurrences, padded SSD against exact
chunking, at 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.models import rglru as jr
from repro.models import ssm as js
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.models import rglru as tr
from repro_torch.models import ssm as ts

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
DUAL = dict(atol=2e-3, rtol=2e-3)


def _cfgs(arch):
    return jreduced(jget(arch)), treduced(tget(arch))


def _params(init, cfg):
    """The reference's float32 weights, as (jax, torch) dicts."""
    p = init(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(B, S, d, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _state_close(ts_, js_, tol=TOL):
    assert set(ts_) == set(js_)
    for k in js_:
        assert ts_[k].dtype == getattr(torch, str(js_[k].dtype)), k
        _close(ts_[k], js_[k], tol)


# ---------------------------------------------------------------------------
# SSD


@pytest.mark.parametrize("S", [32, 24], ids=["multiple", "padded"])
@pytest.mark.parametrize("return_state", [False, True])
def test_ssd_apply_matches_reference(S, return_state):
    jc, tc = _cfgs("mamba2-780m")
    jp, tp = _params(js.init_ssm, jc)
    jx, tx = _x(2, S, jc.d_model)
    j = js.ssd_apply(jc, jx, jp, chunk=16, return_state=return_state)
    t = ts.ssd_apply(tc, tx, tp, chunk=16, return_state=return_state)
    if return_state:
        _state_close(t[1], j[1])
        j, t = j[0], t[0]
    _close(t, j)


@pytest.mark.parametrize("start", ["prefill", "init"])
def test_ssd_decode_step_matches_reference(start):
    """Four steps from a prefill state (float32 conv cache) or from the
    zero state (bf16 conv cache, promoted by the step)."""
    jc, tc = _cfgs("mamba2-780m")
    jp, tp = _params(js.init_ssm, jc)
    jx, tx = _x(2, 20, jc.d_model)
    if start == "prefill":
        _, jst = js.ssd_apply(jc, jx[:, :16], jp, chunk=16, return_state=True)
        _, tst = ts.ssd_apply(tc, tx[:, :16], tp, chunk=16, return_state=True)
    else:
        jst, tst = js.ssd_decode_init(jc, 2), ts.ssd_decode_init(tc, 2)
        _state_close(tst, jst)
    for t in range(16, 20):
        jy, jst = js.ssd_decode_step(jc, jx[:, t:t + 1], jp, jst)
        ty, tst = ts.ssd_decode_step(tc, tx[:, t:t + 1], tp, tst)
        _close(ty, jy)
        _state_close(tst, jst)


def test_ssd_padding_matches_exact_chunking():
    jc, tc = _cfgs("mamba2-780m")
    _, tp = _params(js.init_ssm, jc)
    _, tx = _x(2, 24, tc.d_model)
    _close(ts.ssd_apply(tc, tx, tp, chunk=16), ts.ssd_apply(tc, tx, tp, chunk=8),
           dict(atol=2e-4, rtol=2e-4))


def test_ssd_chunked_matches_decode_recurrence():
    jc, tc = _cfgs("mamba2-780m")
    _, tp = _params(js.init_ssm, jc)
    _, tx = _x(1, 16, tc.d_model)
    y_par, st = ts.ssd_apply(tc, tx, tp, chunk=8, return_state=True)
    state = ts.ssd_decode_init(tc, 1)
    ys = []
    for t in range(16):
        yt, state = ts.ssd_decode_step(tc, tx[:, t:t + 1], tp, state)
        ys.append(yt)
    _close(y_par, torch.cat(ys, dim=1).numpy(), DUAL)
    _close(st["ssm"], state["ssm"].numpy(), DUAL)


def test_segsum_is_minus_inf_above_the_diagonal():
    x = torch.arange(1.0, 6.0)
    seg = ts._segsum(x)
    assert torch.all(torch.exp(seg).triu(1) == 0)
    assert seg[4, 1] == 3.0 + 4.0 + 5.0 and seg[2, 2] == 0.0


# ---------------------------------------------------------------------------
# RG-LRU


@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8)],
                         ids=["chunked", "whole"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_apply_matches_reference(S, chunk, with_h0):
    """Both branches: chunk divides S and S > chunk (the sequential carry
    over chunks), else one scan over the whole sequence."""
    jc, tc = _cfgs("recurrentgemma-9b")
    jp, tp = _params(jr.init_rglru, jc)
    jx, tx = _x(2, S, jc.d_model)
    h0 = (np.random.default_rng(5).standard_normal((2, jc.rnn_width))
          .astype(np.float32) if with_h0 else None)
    jy, jst = jr.rglru_apply(jc, jx, jp, return_state=True, chunk=chunk,
                             h0=None if h0 is None else jnp.asarray(h0))
    ty, tst = tr.rglru_apply(tc, tx, tp, return_state=True, chunk=chunk,
                             h0=None if h0 is None else torch.from_numpy(h0))
    _close(ty, jy)
    _state_close(tst, jst)


@pytest.mark.parametrize("start", ["prefill", "init"])
def test_rglru_decode_step_matches_reference(start):
    jc, tc = _cfgs("recurrentgemma-9b")
    jp, tp = _params(jr.init_rglru, jc)
    jx, tx = _x(2, 12, jc.d_model)
    if start == "prefill":
        _, jst = jr.rglru_apply(jc, jx[:, :8], jp, return_state=True)
        _, tst = tr.rglru_apply(tc, tx[:, :8], tp, return_state=True)
    else:
        jst, tst = jr.rglru_decode_init(jc, 2), tr.rglru_decode_init(tc, 2)
        _state_close(tst, jst)
    for t in range(8, 12):
        jy, jst = jr.rglru_decode_step(jc, jx[:, t:t + 1], jp, jst)
        ty, tst = tr.rglru_decode_step(tc, tx[:, t:t + 1], tp, tst)
        _close(ty, jy)
        _state_close(tst, jst)


def test_rglru_scan_matches_decode_recurrence():
    jc, tc = _cfgs("recurrentgemma-9b")
    _, tp = _params(jr.init_rglru, jc)
    _, tx = _x(2, 12, tc.d_model)
    y_par, st = tr.rglru_apply(tc, tx, tp, return_state=True, chunk=4)
    state = tr.rglru_decode_init(tc, 2)
    state = {"h": state["h"], "conv": state["conv"].float()}
    ys = []
    for t in range(12):
        yt, state = tr.rglru_decode_step(tc, tx[:, t:t + 1], tp, state)
        ys.append(yt)
    _close(y_par, torch.cat(ys, dim=1).numpy(), DUAL)
    _close(st["h"], state["h"].numpy(), DUAL)


def test_rglru_scan_survives_long_decays():
    """A 512-step chunk of the strongest decays (r = 1 throughout): the
    doubling scan stays finite and equals the sequential recurrence; a
    running product of a would have underflowed to 0."""
    S, dr = 512, 8
    a = torch.full((1, S, dr), float(np.exp(-8 * np.log1p(np.exp(0.72)))))
    b = torch.from_numpy(np.random.default_rng(2).standard_normal((1, S, dr))
                         .astype(np.float32))
    assert torch.prod(a[0, :, 0]) == 0
    h = tr._scan(a, b)
    ref, hs = torch.zeros(1, dr), []
    for t in range(S):
        ref = a[:, t] * ref + b[:, t]
        hs.append(ref)
    assert torch.isfinite(h).all()
    _close(h, torch.stack(hs, dim=1).numpy(), dict(atol=1e-6, rtol=1e-6))

"""The port's ``fused_decode_step`` against the JAX one over a trajectory.

Both steps start from the same state (pages granted by each package's own
pool, the same prompts) and run the same plan: C=8 chunked prefill, a mixed
prefill/decode chunk that copy-on-writes a page shared to refcount 2, a
C=1 decode with ``do_validate=False``, a speculative verify step, a step on
a dry pool (a starved grant) and a speculative step after it.  After every
step all 12 outputs are compared: integer state (pool, block tables,
snapshots, lengths, tokens, flags) exactly, the float32 KV arena within
1e-5 (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.core import pagepool as jpp
from repro.models.transformer import init_decoder_lm
from repro.serving.paged_decode import (fused_decode_step as jax_step,
                                        kv_storage_init as jax_kv)
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.core import pagepool as tpp
from repro_torch.serving.paged_decode import (fused_decode_step as port_step,
                                              kv_storage_init as port_kv)

torch.set_num_threads(1)

NUM_PAGES, PAGE, B, M = 14, 4, 3, 6
PROMPTS = [[5, 9, 2, 7, 7, 1, 3, 8, 4, 6], [11, 3, 3, 2, 9], [4, 1, 6]]


@pytest.fixture(scope="module")
def models():
    jc = jreduced(jget("olmo-1b"))
    tc = treduced(tget("olmo-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      init_decoder_lm(jc, jax.random.PRNGKey(1)))
    tm = model_from_jax(tc, jax.tree.map(np.asarray, jp), dtype=torch.float32,
                        device="cpu")
    return jc, jp, tc, tm


def _state():
    """Both packages' initial engine state: one fresh page per row."""
    jpool = jpp.pool_init(NUM_PAGES, 4)
    tpool = tpp.pool_init(NUM_PAGES, 4, device="cpu")
    jpool, g, _ = jpp.alloc_pages_batch(jpool, jnp.ones((B,), jnp.int32), 1)
    tpool, _, _ = tpp._alloc_pages_batch_impl(tpool, torch.ones(B), 1)
    bt = np.full((B, M), -1, np.int32)
    bt[:, 0] = np.asarray(g)[:, 0]
    pbuf = np.zeros((B, 16), np.int32)
    for i, p in enumerate(PROMPTS):
        pbuf[i, :len(p)] = p
    plen = np.asarray([len(p) for p in PROMPTS], np.int32)
    j = dict(pool=jpool, bt=jnp.asarray(bt),
             snap=jnp.zeros((B, M), jnp.uint32), lengths=jnp.zeros(B, jnp.int32),
             last=jnp.zeros(B, jnp.int32), active=jnp.ones(B, bool),
             pbuf=jnp.asarray(pbuf), plen=jnp.asarray(plen))
    t = dict(pool=tpool, bt=torch.from_numpy(bt.copy()),
             snap=torch.zeros((B, M), dtype=torch.int64),
             lengths=torch.zeros(B, dtype=torch.int32),
             last=torch.zeros(B, dtype=torch.int32),
             active=torch.ones(B, dtype=torch.bool),
             pbuf=torch.from_numpy(pbuf), plen=torch.from_numpy(plen))
    return j, t


def _compare(jo, to):
    names = ("kv", "pool", "block_tables", "snapshot", "lengths", "last_tok",
             "tokens", "valid", "grant_info", "cow", "adv", "n_acc")
    for name, j, t in zip(names, jo, to):
        if name == "kv":
            for n in ("k", "v"):
                np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n]),
                                           atol=1e-5, rtol=1e-5)
        elif name == "pool":
            for f in jpp.PagePool._fields:
                a = np.asarray(getattr(j, f))
                np.testing.assert_array_equal(
                    getattr(t, f).numpy().astype(a.dtype), a, err_msg=f)
        else:
            a = np.asarray(j)
            np.testing.assert_array_equal(t.numpy().astype(a.dtype), a,
                                          err_msg=name)


def test_fused_step_trajectory_matches_reference(models):
    jc, jp, tc, tm = models
    js, ts = _state()
    jkv = jax_kv(jc, NUM_PAGES, PAGE, dtype=jnp.float32)
    tkv = port_kv(tc, NUM_PAGES, PAGE, dtype=torch.float32, device="cpu")
    key = jax.random.PRNGKey(0)
    # (chunk size, budget, speculative, do_validate, before-step action)
    plan = [(8, 8, False, True, None), (8, 8, False, True, "share"),
            (1, 1, False, False, None), (4, 4, True, True, None),
            (4, 4, True, True, "drain"), (1, 1, False, True, "refill"),
            (4, 4, True, True, None)]
    seen = dict(cow=False, starved=False, accepted=False)
    drained = None
    for C, budget, spec, val, action in plan:
        if action == "share":  # row 2's write page gains a second holder
            page = int(np.asarray(js["bt"])[2, 0])
            js["pool"], _ = jpp.share_pages(js["pool"], jnp.asarray([page]))
            ts["pool"], _ = tpp._share_pages_impl(ts["pool"],
                                                  torch.tensor([page]))
        elif action == "drain":  # take every free page: the pool runs dry
            n = int(np.asarray(js["pool"].free_top))
            js["pool"], g, _ = jpp.alloc_pages_batch(
                js["pool"], jnp.asarray([n], jnp.int32), n)
            ts["pool"], _, _ = tpp._alloc_pages_batch_impl(
                ts["pool"], torch.tensor([n]), n)
            drained = np.asarray(g)[0].copy()
        elif action == "refill":
            js["pool"] = jpp.unshare_pages(js["pool"], jnp.asarray(drained))
            ts["pool"] = tpp._unshare_pages_impl(ts["pool"],
                                                 torch.from_numpy(drained))
        if spec:  # draft the echo of the last token (the model's habit)
            last = np.asarray(js["last"])
            dt = np.repeat(last[:, None], C - 1, axis=1).astype(np.int32)
            dl = np.full(B, C - 1, np.int32)
            jd, td = (jnp.asarray(dt), jnp.asarray(dl)), \
                (torch.from_numpy(dt), torch.from_numpy(dl))
        else:
            jd, td = (None, None), (None, None)
        jo = jax_step(jp, jkv, js["pool"], js["bt"], js["snap"], js["lengths"],
                      js["last"], js["active"], js["pbuf"], js["plen"], key,
                      jnp.asarray(1.0), jnp.asarray(budget, jnp.int32), *jd,
                      jnp.asarray(val), cfg=jc, impl="ref", greedy=True,
                      chunk_size=C, speculative=spec)
        to = port_step(tm, tkv, ts["pool"], ts["bt"], ts["snap"],
                       ts["lengths"], ts["last"], ts["active"], ts["pbuf"],
                       ts["plen"], None, 1.0, budget, *td, val, cfg=tc,
                       greedy=True, chunk_size=C, speculative=spec)
        _compare(jo, to)
        jkv, js["pool"], js["bt"], js["snap"], js["lengths"], js["last"] = jo[:6]
        tkv = to[0]
        assert to[2] is ts["bt"] and to[4] is ts["lengths"]  # in place
        seen["cow"] |= bool(to[9].any())
        seen["starved"] |= bool((to[8] == -1).any())
        seen["accepted"] |= bool((to[11] > 0).any())
    assert all(seen.values()), seen


def test_sampling_path_runs_and_stays_in_vocab(models):
    """Non-greedy sampling (Gumbel-max on a seeded generator) draws valid
    ids and repeats under the same seed."""
    _, _, tc, tm = models
    out = []
    for _ in range(2):
        _, ts = _state()
        tkv = port_kv(tc, NUM_PAGES, PAGE, dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(5)
        res = port_step(tm, tkv, ts["pool"], ts["bt"], ts["snap"],
                        ts["lengths"], ts["last"], ts["active"], ts["pbuf"],
                        ts["plen"], gen, 0.8, 8, cfg=tc, greedy=False,
                        chunk_size=8)
        out.append(res[6].clone())
        assert ((res[6] >= 0) & (res[6] < tc.vocab_padded)).all()
    assert torch.equal(out[0], out[1])
    with pytest.raises(ValueError, match="greedy"):
        port_step(tm, tkv, ts["pool"], ts["bt"], ts["snap"], ts["lengths"],
                  ts["last"], ts["active"], ts["pbuf"], ts["plen"], None, 1.0,
                  cfg=tc, greedy=False, speculative=True)


def test_paged_decode_step_logits_match_reference(models):
    """The bare model step (one token per row, logits out) against the JAX
    ``paged_decode_step`` on the same arena contents, float32, 1e-5."""
    from repro.serving.paged_decode import paged_decode_step as jax_bare
    from repro_torch.serving.paged_decode import paged_decode_step as port_bare

    jc, jp, tc, tm = models
    rng = np.random.default_rng(9)
    bt = np.array([[3, 7, -1], [1, -1, -1], [0, 2, 5]], np.int32)
    ln = np.array([5, 2, 9], np.int32)
    tok = np.array([11, 4, 200], np.int32)
    shape = (jc.n_layers, NUM_PAGES, PAGE, jc.n_kv_heads, jc.head_dim)
    base = {n: rng.standard_normal(shape).astype(np.float32) for n in "kv"}
    jl, jkv = jax_bare(jp, {n: jnp.asarray(a) for n, a in base.items()},
                       jnp.asarray(bt), jnp.asarray(ln), jnp.asarray(tok),
                       cfg=jc)
    tkv = {n: torch.from_numpy(a.copy()) for n, a in base.items()}
    tl, tkv = port_bare(tm, tkv, torch.from_numpy(bt), torch.from_numpy(ln),
                        torch.from_numpy(tok), cfg=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    for n in "kv":
        np.testing.assert_allclose(tkv[n].numpy(), np.asarray(jkv[n]),
                                   atol=1e-5, rtol=1e-5)

"""``repro_torch.models.build_model`` against ``repro.models.build_model``
on every architecture of the zoo, reduced, on the CPU.

Each JAX model is initialised with ``PRNGKey(0)`` (bf16 weights, float32
where the reference keeps them so), its weights cast to float32 on both
sides (the port's through ``convert.py``), and the same batch (numpy, from
a seed) goes through both:

- ``forward``'s hidden states (the reference's ``fwd_eval``: dropless
  MoE), ``prefill``'s logits and every cache leaf (keys, dtypes, values),
  then 8 greedy ``decode_step``s' logits and caches, within 1e-4 abs/rel:
  both compute in float32 and differ in summation order; the greedy
  tokens and ``len`` exactly;
- ``init_cache``: the reference's keys, shapes and dtypes, all zeros, and
  four decode steps from it (its bf16 caches under a float32 model: a
  bf16 leaf also within one bf16 step, 2^-7 relative, as two float32
  values a rounding apart may round to neighbouring bf16 values);
- the ring-window continuation of ``tests/test_ring_cache.py``
  (recurrentgemma-9b, mixtral-8x7b: a 19-token prefill into a 16-slot
  ring, then decode across two wraps) with the port's logits held to the
  JAX model's and to its own teacher forcing, and the ``_ring_align``
  slot invariant;
- a bf16 bridge of each tree is bit-exact, the float32 leaves kept
  float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as jget, reduced as jreduced
from repro.models import build_model as jbuild
from repro.models.transformer import unembed as junembed
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import FLOAT32_LEAVES, model_from_jax
from repro_torch.models import build_model
from repro_torch.models.transformer import (STACKED, _ring_align, lm_class,
                                            unembed)

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, CACHE, STEPS = 2, 24, 36, 8


@functools.cache
def _setup(arch):
    """(jax cfg, torch cfg, jax model, port model, jax bf16 params)."""
    jc, tc = jreduced(jget(arch)), treduced(tget(arch))
    return jc, tc, jbuild(jc), build_model(tc), jbuild(jc).init(
        jax.random.PRNGKey(0))


def _float32(arch):
    """The reference's weights in float32: (jax tree, port module)."""
    jc, tc, _, _, jp = _setup(arch)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp32, model_from_jax(tc, jax.tree.map(np.asarray, jp32),
                                dtype=torch.float32, device="cpu")


def _batch(cfg, seed=0, S=S):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S - cfg.prefix_tokens))
         .astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.prefix_tokens:
        b["patches"] = rng.standard_normal(
            (B, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(t, j, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), err_msg=msg, **TOL)


def _caches_close(tcache, jcache, where):
    """Keys, dtypes and shapes equal; values within 1e-4, and a bf16 leaf
    (K/V rounded from float32 values that differ in their last bits) also
    within one bf16 step (2^-7 relative)."""
    assert set(tcache) == set(jcache), where
    for k, j in jcache.items():
        t = tcache[k]
        assert t.dtype == getattr(torch, str(j.dtype)), (where, k, t.dtype)
        assert tuple(t.shape) == j.shape, (where, k)
        if t.dtype == torch.bfloat16:
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(j, np.float32), atol=1e-4,
                rtol=2**-7, err_msg=f"{where}: cache {k}")
        else:
            _close(t, j, f"{where}: cache {k}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    jc, tc, jm, tm, _ = _setup(arch)
    jp, tp = _float32(arch)
    jb, tb = _batch(jc)
    jh, jaux = jm.forward(jp, jb)
    th, taux = tm.forward(tp, tb)
    assert th.shape == (B, S, tc.d_model)
    _close(th, jh)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    jc, tc, jm, tm, _ = _setup(arch)
    jp, tp = _float32(arch)
    jb, tb = _batch(jc, seed=1)
    jcache, jlog = jm.prefill(jp, jb, CACHE)
    tcache, tlog = tm.prefill(tp, tb, CACHE)
    _close(tlog, jlog)
    _caches_close(tcache, jcache, "prefill")
    step = jax.jit(jm.decode_step)
    jtok, ttok = jnp.argmax(jlog[:, -1], -1), tlog[:, -1].argmax(-1)
    for i in range(STEPS):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), f"step {i}"
        pos = np.full((B,), S + i, np.int32)
        jlog, jcache = step(jp, jcache, {"token": jtok.astype(jnp.int32),
                                         "pos": jnp.asarray(pos)})
        tlog, tcache = tm.decode_step(tp, tcache, {
            "token": ttok.to(torch.int32), "pos": torch.from_numpy(pos)})
        _close(tlog, jlog, f"step {i}")
        _caches_close(tcache, jcache, f"step {i}")
        jtok, ttok = jnp.argmax(jlog, -1), tlog.argmax(-1)
    assert np.array_equal(tcache["len"].numpy(), np.full((B,), S + STEPS))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_matches_reference(arch):
    jc, tc, jm, tm, _ = _setup(arch)
    j = jm.init_cache(B, CACHE)
    t = tm.init_cache(B, CACHE, device="cpu")
    _caches_close(t, j, "init_cache")
    assert all(not v.any() for v in t.values())


# the reference's scatter of float32 K/V into its bf16 cache warns
@pytest.mark.filterwarnings("ignore:scatter inputs have incompatible types")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_from_init_cache_matches_reference(arch):
    """Four steps from ``init_cache`` (bf16 K/V and conv caches under a
    float32 model): the K/V writes round to bf16, the conv caches promote
    to float32 after one step, as the reference's do."""
    jc, tc, jm, tm, _ = _setup(arch)
    jp, tp = _float32(arch)
    jcache, tcache = jm.init_cache(B, 8), tm.init_cache(B, 8, device="cpu")
    toks = np.random.default_rng(2).integers(0, jc.vocab, (4, B)).astype(
        np.int32)
    step = jax.jit(jm.decode_step)
    for i, tok in enumerate(toks):
        pos = np.full((B,), i, np.int32)
        jlog, jcache = step(jp, jcache, {"token": jnp.asarray(tok),
                                         "pos": jnp.asarray(pos)})
        tlog, tcache = tm.decode_step(tp, tcache, {
            "token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)})
        _close(tlog, jlog, f"step {i}")
        _caches_close(tcache, jcache, f"step {i}")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mixtral-8x7b"])
def test_ring_window_continuation(arch):
    """A 19-token prefill into a 16-slot ring (19 % 16 != 0), then decode
    to position 43: every step's logits equal the JAX model's and match
    the port's own teacher forcing within the reference test's 5e-2."""
    jc, tc, jm, tm, _ = _setup(arch)
    jp, tp = _float32(arch)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (1, 44)).astype(
        np.int32)
    hidden, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    tf = unembed(tc, tp, hidden).float()
    split = 19
    jcache, jlog = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :split])}, 16)
    tcache, tlog = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :split])},
                              16)
    _close(tlog, jlog)
    assert tcache["k"].shape[2] == 16
    np.testing.assert_allclose(tlog[:, -1].numpy(), tf[:, split - 1].numpy(),
                               atol=5e-2, rtol=5e-2)
    step = jax.jit(jm.decode_step)
    for pos in range(split, 44):
        p = np.full((1,), pos, np.int32)
        jlog, jcache = step(jp, jcache, {"token": jnp.asarray(toks[:, pos]),
                                         "pos": jnp.asarray(p)})
        tlog, tcache = tm.decode_step(tp, tcache, {
            "token": torch.from_numpy(toks[:, pos]),
            "pos": torch.from_numpy(p)})
        _close(tlog, jlog, f"pos {pos}")
        np.testing.assert_allclose(tlog.numpy(), tf[:, pos].numpy(),
                                   atol=5e-2, rtol=5e-2, err_msg=f"pos {pos}")
    # the JAX model's own teacher forcing agrees with the port's
    jh, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    _close(tf, junembed(jc, jp, jh).astype(jnp.float32))


def test_ring_align_slot_invariant():
    """After _ring_align, ring slot (p % W) holds position p of the
    sequence, for aligned and misaligned S."""
    W = 8
    for n in (4, 8, 11, 16, 19, 24):
        ring = _ring_align(torch.arange(n, dtype=torch.float32)
                           .reshape(1, n, 1, 1), W)
        assert ring.shape[1] == W
        for p in range(max(0, n - W), n):
            assert ring[0, p % W, 0, 0] == p, (n, p)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_bridge_is_bit_exact(arch):
    """Every leaf of the reference's bf16 tree arrives bit for bit; the
    float32 leaves (router, SSM decay/skip/step bias, RG-LRU gate) stay
    float32."""
    jc, tc, _, _, jp = _setup(arch)
    model = model_from_jax(tc, jax.tree.map(np.asarray, jp),
                           dtype=torch.bfloat16, device="cpu")
    assert isinstance(model, lm_class(tc))
    tree = model.tree()
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert flat
    for path, leaf in flat:
        keys = [k.key for k in path]
        get = functools.partial(functools.reduce, lambda d, k: d[k], keys[1:])
        top = tree[keys[0]]
        got = (torch.stack([get(b) for b in top]) if keys[0] in STACKED
               else get(top))
        name = keys[-1]
        dt = torch.float32 if name in FLOAT32_LEAVES else torch.bfloat16
        assert got.dtype == dt and str(leaf.dtype) == str(dt)[6:], keys
        assert tuple(got.shape) == leaf.shape, keys
        assert np.array_equal(got.float().numpy(),
                              np.asarray(leaf, np.float32)), keys


def test_unknown_family_raises():
    cfg = dataclasses.replace(treduced(tget("olmo-1b")), family="bogus")
    with pytest.raises(ValueError):
        build_model(cfg)

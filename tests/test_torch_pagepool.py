"""The port's page pool against the JAX pool: seeded op sequences through
both, the whole state compared exactly after every op.

Versions and the clock are uint32 in the reference and int64 (masked to
32 bits) in the port, so they are compared as ``np.uint32``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pagepool as jpp
from repro_torch.core import pagepool as tpp
from repro_torch.core.allocator import Allocator

torch.set_num_threads(1)


def assert_same(j, t):
    np.testing.assert_array_equal(t.sb_pages.numpy(), np.asarray(j.sb_pages))
    np.testing.assert_array_equal(t.sb_free.numpy(), np.asarray(j.sb_free))
    np.testing.assert_array_equal(t.sb_mapped.numpy(), np.asarray(j.sb_mapped))
    np.testing.assert_array_equal(t.page_version.numpy().astype(np.uint32),
                                  np.asarray(j.page_version))
    np.testing.assert_array_equal(t.page_refcount.numpy(),
                                  np.asarray(j.page_refcount))
    assert np.uint32(int(t.clock)) == np.asarray(j.clock)
    np.testing.assert_array_equal(tpp.superblock_states(t).numpy(),
                                  np.asarray(jpp.superblock_states(j)))


def _ids(rng, live, n, p_free=0.0, num_pages=1):
    """n entries drawn from the live pages (duplicates allowed), some −1 and
    (with p_free) some arbitrary — possibly free — ids."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.15 or not live:
            out.append(-1)
        elif r < 0.15 + p_free:
            out.append(int(rng.integers(0, num_pages)))
        else:
            out.append(int(rng.choice(live)))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("num_pages,ppsb", [(24, 8), (21, 4), (9, 16)])
def test_random_op_sequences_match_exactly(seed, num_pages, ppsb):
    rng = np.random.default_rng(seed)
    j = jpp.pool_init(num_pages, ppsb)
    t = tpp.pool_init(num_pages, ppsb, device="cpu")
    assert_same(j, t)
    for step in range(30):
        live = [int(p) for p in np.nonzero(np.asarray(j.page_refcount))[0]]
        op = rng.choice(["alloc", "unshare", "share", "release", "map",
                         "validate"], p=[.3, .25, .15, .1, .1, .1])
        if op == "alloc":
            B, mg = int(rng.integers(1, 5)), int(rng.integers(1, 4))
            need = rng.integers(0, mg + 2, B).astype(np.int32)  # some > mg
            j, jg, jok = jpp.alloc_pages_batch(j, jnp.asarray(need), mg)
            t, tg, tok = tpp._alloc_pages_batch_impl(t, torch.from_numpy(need),
                                                     mg)
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
            assert bool(tok) == bool(jok)
        elif op == "unshare":  # duplicates within a batch included
            ids = _ids(rng, live, int(rng.integers(1, 7)))
            j = jpp.unshare_pages(j, jnp.asarray(ids))
            t = tpp._unshare_pages_impl(t, torch.from_numpy(ids))
        elif op == "share":  # sometimes names a free page: refused
            ids = _ids(rng, live, int(rng.integers(1, 5)), 0.2, num_pages)
            j, jok = jpp.share_pages(j, jnp.asarray(ids))
            t, tok = tpp._share_pages_impl(t, torch.from_numpy(ids))
            assert bool(tok) == bool(jok)
        elif op == "release":
            mx, keep = int(rng.integers(0, 4)), int(rng.integers(0, 3))
            j, jn, jpg = jpp.release_empty_superblocks(
                j, jnp.asarray(mx, jnp.int32), jnp.asarray(keep, jnp.int32))
            t, tn, tpg = tpp._release_empty_impl(t, mx, keep)
            assert (int(tn), int(tpg)) == (int(jn), int(jpg))
        elif op == "map":
            n = int(rng.integers(0, 3))
            j, jn, jpg = jpp.map_superblocks(j, jnp.asarray(n, jnp.int32))
            t, tn, tpg = tpp._map_superblocks_impl(t, n)
            assert (int(tn), int(tpg)) == (int(jn), int(jpg))
        else:
            pages = rng.integers(-1, num_pages, (3, 5)).astype(np.int32)
            snap = np.asarray(jpp.snapshot_versions(j, jnp.asarray(pages)))
            snap = snap.copy()
            snap[0, 0] += 1  # one row is stale
            jv, jcur = jpp.validate_and_commit(j, jnp.asarray(pages),
                                               jnp.asarray(snap))
            tv, tcur = tpp._validate_and_commit_impl(
                t, torch.from_numpy(pages), torch.from_numpy(snap.astype(
                    np.int64)))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(tcur.numpy().astype(np.uint32),
                                          np.asarray(jcur))
        assert_same(j, t)


def test_duplicate_unshare_zero_transition_rule():
    """A page held twice and unshared twice in ONE batch frees exactly once
    (the entry whose cumulative drop reaches the old count), bumping its
    version once and ticking the clock once."""
    j = jpp.pool_init(8, 4)
    t = tpp.pool_init(8, 4, device="cpu")
    j, jg, _ = jpp.alloc_pages_batch(j, jnp.asarray([2], jnp.int32), 2)
    t, tg, _ = tpp._alloc_pages_batch_impl(t, torch.tensor([2]), 2)
    p = int(tg[0, 0])
    j, _ = jpp.share_pages(j, jnp.asarray([p], jnp.int32))
    t, _ = tpp._share_pages_impl(t, torch.tensor([p]))
    ids = np.asarray([p, -1, p, p], np.int32)  # three drops of a count of 2
    j = jpp.unshare_pages(j, jnp.asarray(ids))
    t = tpp._unshare_pages_impl(t, torch.from_numpy(ids))
    assert_same(j, t)
    assert int(t.page_version[p]) == 1 and int(t.clock) == 1
    assert int(t.page_refcount[p]) == 0


def test_version_and_clock_wrap_like_uint32():
    t = tpp.pool_init(4, 2, device="cpu")
    t = t._replace(page_version=torch.full((4,), 0xFFFFFFFF, dtype=torch.int64),
                   clock=torch.tensor(0xFFFFFFFF, dtype=torch.int64))
    t, g, _ = tpp._alloc_pages_batch_impl(t, torch.tensor([1]), 1)
    t = tpp._unshare_pages_impl(t, g.reshape(-1))
    assert int(t.page_version[int(g[0, 0])]) == 0 and int(t.clock) == 0


def test_device_page_pool_protocol_surface():
    """Both adapters satisfy ``Allocator`` and answer the same script
    identically (grants, share refusals, release/map counts, snapshots,
    anchor views)."""
    jd = jpp.DevicePagePool(20, 4)
    td = tpp.DevicePagePool(20, 4, device="cpu")
    assert isinstance(td, Allocator)
    assert (td.num_pages, td.pages_per_superblock) == (20, 4)

    def both(name, *args):
        a, b = getattr(jd, name)(*args), getattr(td, name)(*args)
        if name == "snapshot":
            np.testing.assert_array_equal(b.numpy().astype(np.uint32),
                                          np.asarray(a))
        else:
            assert a == b, (name, a, b)
        assert_same(jd.state, td.state)
        assert dataclasses.asdict(jd.view()) == dataclasses.asdict(td.view())
        return b

    a, _ = both("alloc", 6)
    both("alloc", 30)  # exhaustion: ([], False), nothing changes
    both("share", a[:2])
    both("share", [19])  # a free page: refused
    both("free", a[:3])
    both("unshare", a[:2])
    both("snapshot", a + [-1])
    both("free", a[2:])
    both("release", 1)
    both("map", 2)
    both("release", 0)
    both("alloc", 3)
    both("map", 5)

"""The port's public pool functions against ``repro.core.pagepool``'s.

Each case of the reference's own pool tests (``test_pagepool.py``,
``test_pagepool_batch.py``, ``test_superblock.py``, the pool calls of
``test_prefix_sharing.py``) runs through both packages' public functions on
the same inputs: after every call the whole pool state and every returned
value must be equal exactly (versions as ``np.uint32``: the port keeps them
in int64), and the reference test's own assertions hold on the port's
results.  The reference's hypothesis cases run here as seeded sequences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, reduced as jreduced
from repro.core import pagepool as jpp
from repro.models import build_model
from repro.serving import PagedServingEngine as JEngine
from repro_torch.configs import get_config as tget, reduced as treduced
from repro_torch.convert import model_from_jax
from repro_torch.core import pagepool as tpp
from repro_torch.serving import PagedServingEngine as TEngine
from test_torch_pagepool import assert_same

torch.set_num_threads(1)

PUBLIC = ["alloc_pages_batch", "alloc_pages", "unshare_pages", "free_pages",
          "share_pages", "release_empty_superblocks", "map_superblocks",
          "snapshot_versions", "validate_and_commit", "validate_read",
          "kv_pages_init", "append_kv", "gather_kv"]


def _same_value(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape
    if j.dtype == np.uint32:  # versions: int64 holding uint32 values
        t = t.astype(np.uint32)
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j)


class Both:
    """One reference pool and one port pool, driven through the public
    functions together.  Arguments are numpy arrays (each package gets its
    own array of them), 0-dim numpy scalars (a 0-dim array or tensor) or
    ints (passed as they are)."""

    def __init__(self, num_pages, *args):
        self.j = jpp.pool_init(num_pages, *args)
        self.t = tpp.pool_init(num_pages, *args, device="cpu")
        assert_same(self.j, self.t)

    def __call__(self, name, *args):
        """Call ``name`` on both pools, compare the new states and every
        returned value, and return the port's values as numpy."""
        def conv(a, to):
            return to(np.asarray(a)) if isinstance(a, (np.ndarray, np.generic)) \
                else a

        def to_jax(a):  # the port's int64 snapshots are uint32 values
            return jnp.asarray(a.astype(np.uint32) if a.dtype == np.int64
                               else a)
        jout = getattr(jpp, name)(self.j, *[conv(a, to_jax) for a in args])
        tout = getattr(tpp, name)(self.t, *[conv(a, torch.from_numpy)
                                            for a in args])
        if not isinstance(tout, tuple) or isinstance(tout, tpp.PagePool):
            jout, tout = (jout,), (tout,)
        if isinstance(tout[0], tpp.PagePool):
            self.j, self.t = jout[0], tout[0]
            jout, tout = jout[1:], tout[1:]
        assert len(jout) == len(tout)
        for j, t in zip(jout, tout):
            _same_value(j, t)
        assert_same(self.j, self.t)
        out = tuple(t.numpy() for t in tout)
        return out[0] if len(out) == 1 else out

    def states(self):
        return tpp.superblock_states(self.t).tolist()


def i32(*x):
    return np.asarray(x, np.int32)


def test_public_names_are_exported():
    assert set(PUBLIC) <= set(tpp.__all__)
    assert set(jpp.__all__) == set(tpp.__all__)


# ---------------------------------------------------------------------------
# tests/test_pagepool.py


def test_alloc_unique_and_exhaustion():
    b = Both(8)
    a, ok1 = b("alloc_pages", 5)
    c, ok2 = b("alloc_pages", 3)
    assert ok1 and ok2
    assert len(set(np.concatenate([a, c]).tolist())) == 8
    d, ok3 = b("alloc_pages", 1)
    assert not ok3 and d[0] == -1
    assert int(b.t.free_top) == 0


def test_free_bumps_version_and_clock():
    b = Both(8)
    pages, _ = b("alloc_pages", 4)
    snap = b("snapshot_versions", pages)
    assert b("validate_read", pages, snap)
    clock0 = int(b.t.clock)
    b("free_pages", pages)
    assert int(b.t.clock) == clock0 + 1  # one warning per batch (Alg. 1)
    assert not b("validate_read", pages, snap)


def test_free_ignores_unmapped_entries():
    b = Both(8)
    pages, _ = b("alloc_pages", 2)
    b("free_pages", np.concatenate([pages, i32(-1, -1, -1)]))
    assert int(b.t.free_top) == 8


def test_stale_read_detected_after_reuse():
    """The ABA case: a page freed AND granted again must fail the old
    snapshot's ``validate_read``."""
    b = Both(4)
    pages, _ = b("alloc_pages", 2)
    snap = b("snapshot_versions", pages)
    b("free_pages", pages)
    again, _ = b("alloc_pages", 2)  # the same physical pages (LIFO)
    assert set(again.tolist()) == set(pages.tolist())
    assert not b("validate_read", pages, snap)


@pytest.mark.parametrize("seed", range(6))
def test_pool_never_double_allocates(seed):
    rng = np.random.default_rng(seed)
    npages = int(rng.integers(4, 33))
    b = Both(npages)
    live: set[int] = set()
    for _ in range(int(rng.integers(1, 41))):
        if rng.random() < 0.5 and live:
            k = int(rng.integers(1, len(live) + 1))
            batch = [live.pop() for _ in range(k)]
            b("free_pages", i32(*batch))
        else:
            k = int(rng.integers(1, npages + 1))
            pages, ok = b("alloc_pages", k)
            got = [int(p) for p in pages if p >= 0]
            if ok:
                assert len(got) == k and not set(got) & live
                live.update(got)
            else:
                assert not got
    assert int(b.t.free_top) == npages - len(live)


@pytest.mark.parametrize("nfree", [1, 4, 8])
def test_versions_monotone(nfree):
    b = Both(8)
    pages, _ = b("alloc_pages", 8)
    v0 = b("snapshot_versions", pages)
    for _ in range(nfree):
        b("free_pages", pages[:2])
        b("alloc_pages", 2)
    v1 = b("snapshot_versions", pages)
    assert (v1 >= v0).all() and (v1[:2] > v0[:2]).all()


@pytest.mark.parametrize("seed", range(6))
def test_superblock_interleavings_never_dup_or_leak_unmapped(seed):
    """Seeded ``alloc_pages_batch``/``free_pages``/release/map
    interleavings: no live page granted twice, none from an unmapped
    superblock, multi-page rows all-or-nothing, anchors exact."""
    rng = np.random.default_rng(100 + seed)
    npages, K = int(rng.integers(4, 25)), int(rng.integers(1, 7))
    b = Both(npages, K)
    K, S = b.t.pages_per_superblock, b.t.num_superblocks
    caps = [min(K, npages - s * K) for s in range(S)]
    live: set[int] = set()
    for _ in range(int(rng.integers(1, 26))):
        op = rng.choice(["alloc", "free", "release", "map"])
        if op == "alloc":
            B, mg = int(rng.integers(1, 5)), int(rng.integers(1, 5))
            need = rng.integers(0, mg + 1, B).astype(np.int32)
            g, ok = b("alloc_pages_batch", need, mg)
            got = [int(p) for p in g.ravel() if p >= 0]
            mapped = set(np.flatnonzero(b.t.sb_mapped.numpy()).tolist())
            assert len(got) == len(set(got)) and not set(got) & live
            assert all(p // K in mapped for p in got)
            for r in range(B):
                assert len([p for p in g[r] if p >= 0]) in (0, need[r])
            if ok:
                assert len(got) == need.sum()
            live.update(got)
        elif op == "free" and live:
            k = int(rng.integers(1, len(live) + 1))
            b("free_pages", i32(*[live.pop() for _ in range(k)]))
        elif op == "release":
            b("release_empty_superblocks", np.int32(rng.integers(0, S + 1)),
              np.int32(rng.integers(0, S + 1)))
        elif op == "map":
            b("map_superblocks", np.int32(rng.integers(0, S + 1)))
        mapped = set(np.flatnonzero(b.t.sb_mapped.numpy()).tolist())
        assert all(p // K in mapped for p in live)
        live_in = [sum(1 for p in live if p // K == s) for s in range(S)]
        np.testing.assert_array_equal(b.t.sb_free.numpy(),
                                      [caps[s] - live_in[s] for s in range(S)])
        assert int(b.t.free_top) == sum(caps[s] for s in mapped) - len(live)


@pytest.mark.parametrize("seed", range(6))
def test_share_unshare_free_release_interleavings(seed):
    """Seeded interleavings of every refcount op against a host model: no
    negative refcount, no page with holders granted again, no superblock
    with a holder released; extra decrefs clamp at zero."""
    rng = np.random.default_rng(200 + seed)
    npages, K = int(rng.integers(4, 21)), int(rng.integers(2, 6))
    b = Both(npages, K)
    K, S = b.t.pages_per_superblock, b.t.num_superblocks
    refs: dict[int, int] = {}
    for _ in range(int(rng.integers(1, 31))):
        op = rng.choice(["alloc", "share", "unshare", "free", "release",
                         "map"])
        live = sorted(refs)
        if op == "alloc":
            pages, _ = b("alloc_pages", int(rng.integers(1, 5)))
            for p in (int(p) for p in pages if p >= 0):
                assert p not in refs
                refs[p] = 1
        elif op == "share" and live:
            batch = rng.choice(live, int(rng.integers(1, 5)))
            assert b("share_pages", batch.astype(np.int32))
            for p in batch:
                refs[int(p)] += 1
        elif op == "share":
            assert not b("share_pages", i32(0))
        elif op in ("unshare", "free") and live:
            batch = rng.choice(live, min(len(live), int(rng.integers(1, 5))),
                               replace=False)
            b(f"{op}_pages", batch.astype(np.int32))
            for p in batch:
                refs[int(p)] -= 1
                if refs[int(p)] == 0:
                    del refs[int(p)]
        elif op == "release":
            b("release_empty_superblocks", np.int32(rng.integers(0, S + 1)),
              np.int32(rng.integers(0, S + 1)))
        elif op == "map":
            b("map_superblocks", np.int32(rng.integers(0, S + 1)))
        rc = b.t.page_refcount.numpy()
        assert (rc >= 0).all()
        assert [rc[p] for p in range(npages)] == \
            [refs.get(p, 0) for p in range(npages)]
        mapped = b.t.sb_mapped.numpy()
        assert all(mapped[p // K] for p in refs)
    before = int(b.t.free_top)
    b("unshare_pages", np.arange(npages, dtype=np.int32))
    rc = b.t.page_refcount.numpy()
    assert all(rc[p] == max(0, refs.get(p, 0) - 1) for p in range(npages))
    assert int(b.t.free_top) >= before


def _kv_pair(num_pages, page_size, hkv, d, dtype):
    return (jpp.kv_pages_init(num_pages, page_size, hkv, d, dtype=dtype),
            tpp.kv_pages_init(num_pages, page_size, hkv, d,
                              dtype=getattr(torch, jnp.dtype(dtype).name),
                              device="cpu"))


def _same_kv(jkv, tkv):
    for n in ("k", "v"):
        np.testing.assert_array_equal(tkv[n].float().numpy(),
                                      np.asarray(jkv[n].astype(jnp.float32)))


def test_append_and_gather_roundtrip():
    jkv, tkv = _kv_pair(8, 4, 2, 8, jnp.float32)
    bt = i32(2, 5, -1, -1)[None]
    lengths = i32(0)
    for t in range(6):
        k = np.full((1, 2, 8), float(t + 1), np.float32)
        v = np.full((1, 2, 8), float(-(t + 1)), np.float32)
        jkv = jpp.append_kv(jkv, jnp.asarray(bt), jnp.asarray(lengths),
                            jnp.asarray(k), jnp.asarray(v))
        tkv = tpp.append_kv(tkv, torch.from_numpy(bt),
                            torch.from_numpy(lengths), torch.from_numpy(k),
                            torch.from_numpy(v))
        _same_kv(jkv, tkv)
        lengths = lengths + 1
    jk, jv = jpp.gather_kv(jkv, jnp.asarray(bt[0]), 8)
    tk, tv = tpp.gather_kv(tkv, torch.from_numpy(bt[0]), 8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tk[:6, 0, 0].tolist() == [1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_append_drops_unmapped_and_past_the_table(dtype):
    """Rows whose page is −1, or whose position lies past the block table,
    write nothing — and no live slot is overwritten in their place (a
    dropped row aimed at the same slot as a live row changes nothing);
    ``gather_kv`` reads −1 as page 0 and clamps ids past the arena."""
    rng = np.random.default_rng(3)
    P, page, hkv, d, B, M = 6, 4, 2, 8, 5, 3
    jkv, tkv = _kv_pair(P, page, hkv, d, dtype)
    bt = i32([0, 1, -1], [-1, -1, -1], [2, 3, 4], [0, -1, 5], [1, 2, 3])
    lengths = i32(0, 2, 12, 5, 7)  # row 1: page −1; row 2: past the table
    for step in range(6):
        k = rng.standard_normal((B, hkv, d)).astype(np.float32)
        v = rng.standard_normal((B, hkv, d)).astype(np.float32)
        jkv = jpp.append_kv(jkv, jnp.asarray(bt), jnp.asarray(lengths),
                            jnp.asarray(k, dtype), jnp.asarray(v, dtype))
        tkv = tpp.append_kv(tkv, torch.from_numpy(bt),
                            torch.from_numpy(lengths),
                            torch.from_numpy(k), torch.from_numpy(v))
        _same_kv(jkv, tkv)
        lengths = lengths + 1
    for row in (i32(0, 1, -1), i32(5, 9, 2), i32(-1, -1, 3)):
        for a, b in zip(jpp.gather_kv(jkv, jnp.asarray(row), 12),
                        tpp.gather_kv(tkv, torch.from_numpy(row), 12)):
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a.astype(jnp.float32)))


def test_kv_pages_init_layout():
    kv = tpp.kv_pages_init(3, 4, 2, 8, device="cpu")
    assert set(kv) == {"k", "v"}
    assert kv["k"].shape == (3, 4, 2, 8) and kv["k"].dtype == torch.bfloat16
    assert not kv["v"].any()


# ---------------------------------------------------------------------------
# tests/test_pagepool_batch.py


def test_alloc_batch_grants_whole_batch_in_one_call():
    b = Both(16)
    grants, ok = b("alloc_pages_batch", i32(1, 0, 1, 1))
    g = grants[:, 0]
    assert ok and g[1] == -1 and all(g[i] >= 0 for i in (0, 2, 3))
    assert len({g[0], g[2], g[3]}) == 3
    assert int(b.t.free_top) == 13


def test_alloc_batch_prefix_grant_on_exhaustion():
    b = Both(2)
    grants, ok = b("alloc_pages_batch", i32(1, 1, 1))
    g = grants[:, 0]
    assert not ok and g[0] >= 0 and g[1] >= 0 and g[2] == -1
    assert int(b.t.free_top) == 0
    b2 = Both(1)
    grants2, ok2 = b2("alloc_pages_batch", i32(1, 0))
    assert ok2 and grants2[1, 0] == -1


def test_alloc_batch_multi_grow_rows():
    b = Both(8)
    g, ok = b("alloc_pages_batch", i32(2, 3), 4)
    got = [int(p) for p in g.ravel() if p >= 0]
    assert ok and len(got) == 5 and len(set(got)) == 5
    assert (g[0, 2:] == -1).all() and g[1, 3] == -1
    assert int(b.t.free_top) == 3


def test_alloc_batch_matches_sequential_alloc():
    seq = Both(8)
    ids = [int(seq("alloc_pages", 1)[0][0]) for _ in range(3)]
    batch = Both(8)
    grants, _ = batch("alloc_pages_batch", np.ones(3, np.int32))
    assert grants[:, 0].tolist() == ids
    assert int(batch.t.free_top) == int(seq.t.free_top)


def test_validate_and_commit_rows():
    b = Both(8)
    a, _ = b("alloc_pages", 2)
    c, _ = b("alloc_pages", 2)
    tables = np.stack([a, c])
    snap = b("snapshot_versions", tables)
    valid, cur = b("validate_and_commit", tables, snap)
    assert valid.tolist() == [True, True]
    np.testing.assert_array_equal(cur, snap)
    b("free_pages", c)
    valid, cur = b("validate_and_commit", tables, snap)
    assert valid.tolist() == [True, False]
    assert (cur[1] == snap[1] + 1).all()


def test_validate_and_commit_ignores_unmapped():
    b = Both(4)
    a, _ = b("alloc_pages", 1)
    tables = i32(int(a[0]), -1, -1)[None]
    valid, _ = b("validate_and_commit", tables, b("snapshot_versions", tables))
    assert valid[0]


# ---------------------------------------------------------------------------
# tests/test_superblock.py


def test_pool_init_superblock_layout():
    b = Both(16, 4)
    assert (b.t.num_superblocks, b.t.pages_per_superblock) == (4, 4)
    assert int(b.t.free_top) == 16 and b.states() == [tpp.SB_EMPTY] * 4
    ids = b.t.sb_pages.numpy()
    assert sorted(ids.ravel().tolist()) == list(range(16))
    assert all(p // 4 == s for s in range(4) for p in ids[s])


def test_ragged_last_superblock():
    b = Both(10, 4)
    assert b.t.num_superblocks == 3 and int(b.t.free_top) == 10
    pages, ok = b("alloc_pages", 10)
    assert ok and sorted(pages.tolist()) == list(range(10))
    assert b.states() == [tpp.SB_FULL] * 3
    b("free_pages", pages)
    assert b.states() == [tpp.SB_EMPTY] * 3


def test_anchor_state_transitions():
    b = Both(8, 4)
    a, _ = b("alloc_pages", 4)
    st = b.states()
    assert sorted(st) == [tpp.SB_FULL, tpp.SB_EMPTY]
    full_sb = st.index(tpp.SB_FULL)
    b("free_pages", a[:2])
    assert b.states()[full_sb] == tpp.SB_PARTIAL
    b("free_pages", a[2:])
    assert b.states()[full_sb] == tpp.SB_EMPTY


def test_alloc_prefers_partial_over_empty():
    b = Both(16, 4)
    b("alloc_pages", 16)
    b("free_pages", np.arange(8, 12, dtype=np.int32))
    b("free_pages", np.arange(4, 6, dtype=np.int32))
    g, ok = b("alloc_pages", 1)
    assert ok and g[0] // 4 == 1
    assert b("alloc_pages", 1)[0][0] // 4 == 1
    assert b("alloc_pages", 1)[0][0] // 4 == 2


def test_fullest_partial_first_packs():
    b = Both(12, 4)
    b("alloc_pages", 12)
    b("free_pages", i32(0))
    b("free_pages", i32(4, 5, 6))
    assert b("alloc_pages", 1)[0][0] // 4 == 0


def test_release_empty_superblocks_accounting():
    b = Both(16, 4)
    n, npg = b("release_empty_superblocks", np.int32(16), np.int32(1))
    assert (n, npg) == (3, 12) and int(b.t.free_top) == 4
    assert b.states() == [tpp.SB_EMPTY] + [tpp.SB_UNMAPPED] * 3
    _, ok = b("alloc_pages", 5)
    assert not ok and int(b.t.free_top) == 4
    assert int(b.t.clock) == 1


@pytest.mark.parametrize("scalar", [int, np.int32])
def test_release_respects_keep_mapped_floor_and_quota(scalar):
    """Ints and 0-dim tensors are both accepted for the dynamic scalars."""
    b = Both(16, 4)
    assert b("release_empty_superblocks", scalar(1), scalar(1))[0] == 1
    assert b("release_empty_superblocks", scalar(16), scalar(2))[0] == 1
    assert int(b.t.sb_mapped.sum()) == 2


def test_release_never_touches_live_pages():
    b = Both(16, 4)
    held, _ = b("alloc_pages", 2)
    n, _ = b("release_empty_superblocks", np.int32(16), np.int32(0))
    assert bool(b.t.sb_mapped[int(held[0]) // 4]) and n == 3
    assert b("validate_read", held, b("snapshot_versions", held))


def test_release_bumps_versions_catches_inflight_reader():
    b = Both(8, 4)
    pages, _ = b("alloc_pages", 2)
    snap = b("snapshot_versions", pages)
    b("free_pages", pages)
    snap2 = b("snapshot_versions", pages)
    n, _ = b("release_empty_superblocks", np.int32(8), np.int32(0))
    assert n == 2
    assert not b("validate_read", pages, snap)
    assert not b("validate_read", pages, snap2)


def test_map_superblocks_restores_circulation():
    b = Both(16, 4)
    assert b("release_empty_superblocks", np.int32(16), np.int32(1))[0] == 3
    nm, npm = b("map_superblocks", np.int32(2))
    assert (nm, npm) == (2, 8) and int(b.t.free_top) == 12
    pages, ok = b("alloc_pages", 12)
    assert ok and len(set(pages.tolist())) == 12
    assert b("map_superblocks", 99)[0] == 1
    assert int(b.t.sb_mapped.sum()) == 4


def test_release_map_cycle_never_duplicates_pages():
    b = Both(16, 4)
    live, _ = b("alloc_pages", 3)
    for _ in range(3):
        b("release_empty_superblocks", np.int32(16), np.int32(1))
        b("map_superblocks", np.int32(16))
    rest, ok = b("alloc_pages", 13)
    assert ok and sorted(live.tolist() + rest.tolist()) == list(range(16))


def test_batch_alloc_never_grants_from_unmapped():
    b = Both(16, 4)
    assert b("release_empty_superblocks", np.int32(2), np.int32(1))[0] == 2
    mapped = set(np.flatnonzero(b.t.sb_mapped.numpy()).tolist())
    grants, ok = b("alloc_pages_batch", i32(2, 2, 2, 2), 2)
    g = [int(p) for p in grants.ravel() if p >= 0]
    assert ok and len(g) == len(set(g)) == 8
    assert all(p // 4 in mapped for p in g)


def test_free_of_only_unmapped_entries_does_not_tick_clock():
    b = Both(8, 4)
    pages, _ = b("alloc_pages", 2)
    clock0, top0 = int(b.t.clock), int(b.t.free_top)
    b("free_pages", np.full(5, -1, np.int32))
    assert int(b.t.clock) == clock0 and int(b.t.free_top) == top0
    b("free_pages", i32(int(pages[0]), -1, -1))
    assert int(b.t.clock) == clock0 + 1


def test_free_top_property_matches_flat_pool_view():
    b = Both(10, 4)
    a, _ = b("alloc_pages", 7)
    assert int(b.t.free_top) == 3
    b("free_pages", a[:4])
    assert int(b.t.free_top) == 7


def test_public_functions_leave_their_argument_unchanged():
    """Nothing is donated: each call returns a new pool and the pool it
    was given still holds the state before the call."""
    pool = tpp.pool_init(8, 4, device="cpu")
    before = [x.clone() for x in pool]
    for name, args in [("alloc_pages_batch", (torch.tensor([2, 1]), 2)),
                       ("alloc_pages", (3,)),
                       ("share_pages", (torch.tensor([0]),)),
                       ("unshare_pages", (torch.tensor([0]),)),
                       ("free_pages", (torch.tensor([0]),)),
                       ("release_empty_superblocks", (2, 0)),
                       ("map_superblocks", (1,))]:
        out = getattr(tpp, name)(pool, *args)
        assert isinstance(out if isinstance(out, tpp.PagePool) else out[0],
                          tpp.PagePool)
        for a, b in zip(pool, before):
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# tests/test_prefix_sharing.py: the pool calls on an engine's pool


SYS = list(range(40, 48))  # 8 tokens = 2 full pages at page_size 4


@pytest.fixture(scope="module")
def engines_after_donation():
    """Both engines (the same float32 weights, prefix cache on) after one
    request donated its prompt's pages to the cache."""
    jc, tc = jreduced(jget("olmo-1b")), treduced(tget("olmo-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      build_model(jc).init(jax.random.PRNGKey(0)))
    tm = model_from_jax(tc, jax.tree.map(np.asarray, jp),
                        dtype=torch.float32, device="cpu")
    kw = dict(num_pages=32, page_size=4, max_batch=2, max_pages_per_seq=8,
              prefix_cache=True, pages_per_superblock=4)
    je, te = JEngine(jc, jp, **kw), TEngine(tc, tm, device="cpu", **kw)
    for e in (je, te):
        e.submit(SYS + [101, 201], 5)
        e.run()
    assert sorted(je._cache_pages) == sorted(te._cache_pages)
    return je, te


def test_release_never_unmaps_cache_or_shared_pages(engines_after_donation):
    """``shrink`` parks only EMPTY superblocks: the cached prefix pages
    stay mapped and still validate through ``validate_read``."""
    je, te = engines_after_donation
    pages = np.asarray(sorted(te._cache_pages), np.int32)
    jsnap = jpp.snapshot_versions(je.pool, jnp.asarray(pages))
    tsnap = tpp.snapshot_versions(te.pool, torch.from_numpy(pages))
    _same_value(jsnap, tsnap)
    je.shrink()
    te.shrink()
    assert_same(je.pool, te.pool)
    mapped = te.pool.sb_mapped.numpy()
    assert all(mapped[p // te.pages_per_superblock] for p in pages)
    assert bool(jpp.validate_read(je.pool, jnp.asarray(pages), jsnap))
    assert bool(tpp.validate_read(te.pool, torch.from_numpy(pages), tsnap))


def test_draining_an_engine_pool_and_handing_it_back(engines_after_donation):
    """The starved-COW test's manipulation: ``alloc_pages`` of every free
    page drains the pool from under the engine, ``free_pages`` hands them
    back with one clock tick; both packages agree at every step (first
    ``map_superblocks`` brings back whatever a shrink parked)."""
    je, te = engines_after_donation
    je.pool, jn, jpg = jpp.map_superblocks(je.pool, 8)
    te.pool, tn, tpg = tpp.map_superblocks(te.pool, 8)
    _same_value(jn, tn)
    _same_value(jpg, tpg)
    free = int(te.pool.free_top)
    assert free == int(je.pool.free_top) and free > 0
    je.pool, jheld, jok = jpp.alloc_pages(je.pool, free)
    te.pool, theld, tok = tpp.alloc_pages(te.pool, free)
    _same_value(jheld, theld)
    assert bool(tok) and bool(jok)
    assert_same(je.pool, te.pool)
    clock0 = int(te.pool.clock)
    je.pool = jpp.free_pages(je.pool, jheld)
    te.pool = tpp.free_pages(te.pool, theld)
    assert_same(je.pool, te.pool)
    assert int(te.pool.clock) == clock0 + 1
    assert int(te.pool.free_top) == free

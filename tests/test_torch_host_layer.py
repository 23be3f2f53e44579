"""The port's host layer: LRMalloc with ``palloc``, the mmap arena, the
reclaimers and the lock-free list and hash table, in ``repro_torch.core``.

Part 1 runs the reference's host-layer test cases (``test_allocator.py``,
``test_allocator_prop.py``, ``test_reclaim.py``,
``test_system.py::test_host_layer_end_to_end`` and the protocol exerciser of
``test_layering.py``) on the port's package.  Part 2 drives both packages
through the same seeded, single-threaded sequences and compares what they
return and the state they keep: block offsets, superblock anchors,
``AllocatorStats``, ``view()``, the tables' keys and ``ReclaimStats``.
"""

import dataclasses
import random
import threading

import hypothesis.strategies as st
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings

import repro.core as J
import repro_torch.core as T
from repro_torch.core import (
    EMPTY, FULL, PARTIAL, HarrisMichaelList, HostAllocator, LRMalloc, MAX_SZ,
    MichaelHashTable, NR, OA, OABit, OAVer, RECLAIMERS, ReleaseStrategy,
    SIZE_CLASSES, class_block_size, size_to_class,
)
from repro_torch.core.allocator import Allocator
from repro_torch.core.pagepool import DevicePagePool
from repro_torch.core.reclaim import ThreadCtx

torch.set_num_threads(1)


def make(strategy=ReleaseStrategy.MADVISE, nsb=64):
    return LRMalloc(num_superblocks=nsb, superblock_size=64 * 1024,
                    strategy=strategy)


def test_exports_match_the_reference():
    assert set(J.__all__) <= set(T.__all__)
    assert set(T.__all__) - set(J.__all__) == {"superblock_floor"}


# ---------------------------------------------------------------------------
# tests/test_allocator.py on the port


def test_size_classes_monotone_and_cover():
    assert SIZE_CLASSES[0] == 16 and SIZE_CLASSES[-1] == MAX_SZ
    assert list(SIZE_CLASSES) == sorted(set(SIZE_CLASSES))
    for req in (1, 15, 16, 17, 100, 1024, 1500, MAX_SZ):
        ci = size_to_class(req)
        assert class_block_size(ci) >= req
        if ci:
            assert class_block_size(ci - 1) < req


def test_size_class_rejects_large():
    with pytest.raises(ValueError):
        size_to_class(MAX_SZ + 1)


def test_malloc_free_roundtrip_unique_offsets():
    a = make()
    ptrs = [a.malloc(48) for _ in range(1000)]
    assert len(set(ptrs)) == 1000
    assert all(p % 16 == 0 and 0 < p < a.arena.total for p in ptrs)
    for p in ptrs:
        a.write_u64(p, p)
    for p in ptrs:
        assert a.read_u64(p) == p
        a.free(p)
    a.close()


def test_reuse_after_free():
    a = make()
    p1 = a.malloc(64)
    a.free(p1)
    assert a.malloc(64) == p1  # LIFO thread cache
    a.close()


def test_offset_zero_reserved():
    a = make()
    assert 0 not in [a.malloc(16) for _ in range(5000)]
    a.close()


def test_distinct_size_classes_dont_collide():
    a = make()
    small = [a.malloc(16) for _ in range(100)]
    big = [a.malloc(8192) for _ in range(20)]
    for p in small:
        a.write_u64(p, 1)
    for p in big:
        a.write_u64(p, 2)
    assert all(a.read_u64(p) == 1 for p in small)
    a.close()


def test_palloc_rejects_large():
    a = make()
    with pytest.raises(ValueError):
        a.palloc(MAX_SZ + 1)
    a.close()


def test_large_allocation_path():
    a = make()
    p = a.malloc(MAX_SZ + 1)
    assert p >= a.arena.total
    assert a.stats.large_allocs == 1
    a.free(p)
    a.close()


@pytest.mark.parametrize("strategy", list(ReleaseStrategy))
def test_persistent_release_keeps_ranges_readable(strategy):
    a = make(strategy, nsb=128)
    ptrs = [a.palloc(1024) for _ in range(2000)]
    for p in ptrs:
        a.write_u64(p, p)
    for p in ptrs:
        a.free(p)
    a.flush_all_caches()
    assert a.stats.persistent_released > 0
    for p in ptrs[::37]:
        a.read_u64(p)  # the OA contract: freed addresses stay readable
    p2 = [a.palloc(1024) for _ in range(500)]
    for p in p2:
        a.write_u64(p, 7)
    assert a.stats.superblocks_reused_mapped > 0
    a.close()


@pytest.mark.parametrize("strategy",
                         [ReleaseStrategy.MADVISE, ReleaseStrategy.SHARED_REMAP])
def test_frames_actually_released(strategy):
    a = make(strategy, nsb=128)
    ptrs = [a.palloc(1024) for _ in range(3000)]
    for p in ptrs:
        a.write_u64(p, 1)
    before = a.resident_bytes()
    for p in ptrs:
        a.free(p)
    a.flush_all_caches()
    after = a.resident_bytes()
    assert after < before * 0.2, (before, after)
    a.close()


def test_keep_strategy_retains_frames():
    a = make(ReleaseStrategy.KEEP, nsb=128)
    ptrs = [a.palloc(1024) for _ in range(3000)]
    for p in ptrs:
        a.write_u64(p, 1)
    before = a.resident_bytes()
    for p in ptrs:
        a.free(p)
    a.flush_all_caches()
    assert a.resident_bytes() >= before * 0.9
    a.close()


def test_superblock_state_machine():
    a = make()
    ptrs = [a.malloc(64) for _ in range(a.sb_size // 64 + 10)]
    base = ptrs[0] - ptrs[0] % a.sb_size
    assert a.pagemap[base].anchor.load()[0] in (FULL, PARTIAL)
    for p in ptrs:
        a.free(p)
    a.flush_all_caches()
    assert base not in a.pagemap or a.pagemap[base].anchor.load()[0] != FULL
    a.close()


def test_dwcas_leak_madvise_but_not_shared_remap():
    """Paper §3.2: a DWCAS on reclaimed memory faults frames back in under
    MADV_DONTNEED but lands on the one shared frame under the shared
    mapping."""
    leaks = {}
    for strategy in (ReleaseStrategy.MADVISE, ReleaseStrategy.SHARED_REMAP):
        a = make(strategy, nsb=128)
        ptrs = [a.palloc(1024) for _ in range(2000)]
        for p in ptrs:
            a.write_u64(p, p)
        for p in ptrs:
            a.free(p)
        a.flush_all_caches()
        before = a.resident_bytes()
        for p in ptrs:
            assert not a.arena.cas_u64_hw(p, 0xDEAD, 0xBEEF)
        leaks[strategy] = a.resident_bytes() - before
        a.close()
    assert leaks[ReleaseStrategy.MADVISE] > \
        20 * leaks[ReleaseStrategy.SHARED_REMAP] + 1


def test_rss_goes_haywire_under_shared_remap_but_pss_does_not():
    a = make(ReleaseStrategy.SHARED_REMAP, nsb=128)
    ptrs = [a.palloc(1024) for _ in range(3000)]
    for p in ptrs:
        a.write_u64(p, 1)
    for p in ptrs:
        a.free(p)
    a.flush_all_caches()
    for p in ptrs[::16]:
        a.arena.cas_u64_hw(p, 1, 2)
    assert a.arena.resident_rss_pages() > 3 * a.arena.resident_pages()
    a.close()


def test_arena_exhaustion_raises():
    a = LRMalloc(num_superblocks=2, superblock_size=64 * 1024)
    with pytest.raises(MemoryError):
        [a.malloc(16 * 1024) for _ in range(100)]
    a.close()


# ---------------------------------------------------------------------------
# tests/test_allocator_prop.py on the port (hypothesis)

SETTINGS = dict(max_examples=30, deadline=None,
                suppress_health_check=[HealthCheck.too_slow])


@given(ops=st.lists(st.tuples(
    st.sampled_from(["malloc", "palloc", "free"]), st.integers(1, MAX_SZ)),
    min_size=1, max_size=300))
@settings(**SETTINGS)
def test_no_live_block_overlap(ops):
    a = LRMalloc(num_superblocks=128, superblock_size=64 * 1024)
    live: dict[int, int] = {}
    try:
        for op, size in ops:
            if op == "free" and live:
                off = next(iter(live))
                live.pop(off)
                a.free(off)
            elif op in ("malloc", "palloc"):
                off = a.malloc(size) if op == "malloc" else a.palloc(size)
                if off >= a.arena.total:
                    a.free(off)
                    continue
                assert off % 16 == 0 and off not in live
                live[off] = size
        spans = sorted((o, o + class_block_size(size_to_class(s)))
                       for o, s in live.items())
        for (_, e1), (s2, _) in zip(spans, spans[1:]):
            assert e1 <= s2, "live blocks overlap"
    finally:
        a.close()


@given(sizes=st.lists(st.integers(1, 2048), min_size=1, max_size=200))
@settings(**SETTINGS)
def test_write_read_isolation(sizes):
    a = LRMalloc(num_superblocks=128, superblock_size=64 * 1024)
    try:
        ptrs = [a.palloc(max(s, 8)) for s in sizes]
        for i, p in enumerate(ptrs):
            a.write_u64(p, i + 1)
        for i, p in enumerate(ptrs):
            assert a.read_u64(p) == i + 1
        for p in ptrs:
            a.free(p)
        for p in ptrs:
            a.read_u64(p)
    finally:
        a.close()


@given(n=st.integers(1, 400), strategy=st.sampled_from(list(ReleaseStrategy)))
@settings(**SETTINGS)
def test_alloc_free_alloc_stability(n, strategy):
    a = LRMalloc(num_superblocks=128, superblock_size=64 * 1024,
                 strategy=strategy)
    try:
        for _ in range(3):
            ptrs = [a.palloc(256) for _ in range(n)]
            for p in ptrs:
                a.write_u64(p, p)
            for p in ptrs:
                assert a.read_u64(p) == p
            for p in ptrs:
                a.free(p)
            a.flush_all_caches()
    finally:
        a.close()


# ---------------------------------------------------------------------------
# tests/test_reclaim.py on the port


def make_alloc(nsb=128):
    return LRMalloc(num_superblocks=nsb, superblock_size=64 * 1024)


@pytest.mark.parametrize("name", ["NR", "OA-BIT", "OA-VER"])
def test_list_semantics_single_thread(name):
    a = make_alloc()
    rec = RECLAIMERS[name](a, limbo_threshold=8)
    lst = HarrisMichaelList(rec)
    ctx = rec.thread_ctx()
    assert all(lst.insert(k, ctx) for k in range(1, 100))
    assert not lst.insert(50, ctx)
    assert lst.contains(50, ctx) and not lst.contains(1000, ctx)
    assert all(lst.delete(k, ctx) for k in range(1, 100, 2))
    assert not lst.delete(1, ctx)
    assert lst.keys(ctx) == list(range(2, 100, 2))
    rec.flush(ctx)
    if name != "NR":
        assert rec.stats.nodes_freed.value > 0
    a.close()


def test_oa_pooled_recycles_without_allocator():
    a = make_alloc()
    rec = OA(a, limbo_threshold=8, pool_size=300)
    lst = HarrisMichaelList(rec)
    ctx = rec.thread_ctx()
    allocs_before = a.stats.allocs
    for _ in range(4):
        for k in range(1, 150):
            lst.insert(k, ctx)
        for k in range(1, 150):
            lst.delete(k, ctx)
    assert a.stats.allocs == allocs_before
    assert rec.stats.recycling_phases.value > 0
    a.close()


def test_oa_pool_exhaustion_raises():
    a = make_alloc()
    rec = OA(a, limbo_threshold=1000, pool_size=10)
    lst = HarrisMichaelList(rec)
    ctx = rec.thread_ctx()
    with pytest.raises(MemoryError):
        for k in range(1, 100):
            lst.insert(k, ctx)
    a.close()


def _threads(worker, n=4):
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def test_oaver_piggybacks_and_restarts_less():
    results = {}
    for name in ("OA-BIT", "OA-VER"):
        a = make_alloc(256)
        rec = RECLAIMERS[name](a, limbo_threshold=16)
        lst = HarrisMichaelList(rec)

        def worker(seed):
            ctx = rec.thread_ctx()
            rnd = random.Random(seed)
            for _ in range(1500):
                k = rnd.randrange(1, 300)
                if rnd.random() < 0.5:
                    lst.insert(k, ctx)
                else:
                    lst.delete(k, ctx)

        _threads(worker)
        results[name] = rec.stats.snapshot()
        a.close()
    assert results["OA-VER"]["warnings_fired"] <= \
        results["OA-BIT"]["warnings_fired"]


def test_warning_fires_before_free():
    a = make_alloc()
    rec = OABit(a, limbo_threshold=4)
    lst = HarrisMichaelList(rec)
    ctx = rec.thread_ctx()
    t2 = ThreadCtx(99)
    rec._threads.append(t2)
    for k in range(1, 20):
        lst.insert(k, ctx)
    for k in range(1, 10):
        lst.delete(k, ctx)
    assert rec.stats.nodes_freed.value > 0
    assert t2.warning.load() is True
    a.close()


def test_hazard_pointer_blocks_free():
    a = make_alloc()
    rec = OABit(a, limbo_threshold=2)
    lst = HarrisMichaelList(rec)
    ctx = rec.thread_ctx()
    holder = ThreadCtx(42)
    rec._threads.append(holder)
    for k in (1, 2, 3, 4, 5):
        lst.insert(k, ctx)
    victim_off = a.read_u64(lst.head + 8) & ~1
    holder.hazards[0].store(victim_off)
    rec.retire(ctx, victim_off)
    for k in (2, 3, 4, 5):
        lst.delete(k, ctx)
    rec.flush(ctx)
    assert victim_off in ctx.limbo
    holder.hazards[0].store(0)
    rec.flush(ctx)
    assert victim_off not in ctx.limbo
    a.close()


@pytest.mark.parametrize("name", ["NR", "OA-BIT", "OA-VER"])
def test_concurrent_hash_stress_all_methods(name):
    a = make_alloc(512)
    rec = RECLAIMERS[name](a, limbo_threshold=32)
    ht = MichaelHashTable(rec, 64)
    errors = []

    def worker(seed):
        try:
            ctx = rec.thread_ctx()
            rnd = random.Random(seed)
            for _ in range(2000):
                k = rnd.randrange(1, 1000)
                r = rnd.random()
                if r < 0.3:
                    ht.insert(k, ctx)
                elif r < 0.6:
                    ht.delete(k, ctx)
                else:
                    ht.contains(k, ctx)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    _threads(worker)
    assert not errors, errors
    ctx = rec.thread_ctx()
    allk = []
    for b in ht.buckets:
        ks = b.keys(ctx)
        assert ks == sorted(ks)
        allk += ks
    assert len(allk) == len(set(allk))
    a.close()


# ---------------------------------------------------------------------------
# tests/test_system.py::test_host_layer_end_to_end on the port


def test_host_layer_end_to_end():
    alloc = LRMalloc(num_superblocks=256, superblock_size=64 * 1024,
                     strategy=ReleaseStrategy.SHARED_REMAP)
    rec = OAVer(alloc, limbo_threshold=32)
    ht = MichaelHashTable(rec, 512)
    ctx = rec.thread_ctx()
    for k in range(1, 5000):
        assert ht.insert(k, ctx)
    peak = alloc.resident_bytes()
    for k in range(1, 5000):
        assert ht.delete(k, ctx)
    rec.flush(ctx)
    alloc.flush_all_caches()
    after = alloc.resident_bytes()
    assert rec.stats.snapshot()["nodes_freed"] > 4000
    assert after < peak
    assert alloc.stats.persistent_released > 0
    for off in range(16, alloc.arena.total, 512 * 1024):
        alloc.read_u64(off)
    alloc.close()


# ---------------------------------------------------------------------------
# tests/test_layering.py's protocol exerciser on the port's two allocators


def _exercise(alloc) -> None:
    assert isinstance(alloc, Allocator)
    ids, ok = alloc.alloc(3)
    assert ok and len(ids) == 3
    base = list(np.asarray(alloc.snapshot(ids)))
    assert alloc.share(ids[:1])
    alloc.free(ids[:1])
    assert list(np.asarray(alloc.snapshot(ids))) == base
    alloc.free(ids)
    bumped = list(np.asarray(alloc.snapshot(ids)))
    assert all(b > a for b, a in zip(bumped, base))
    assert not alloc.share(ids[:1])
    n_sb, _ = alloc.release(1)
    view = alloc.view()
    assert view.superblocks_released >= n_sb >= 0
    assert view.superblocks_mapped <= view.superblocks_total
    assert view.pages_per_superblock > 0
    alloc.release(0)
    assert alloc.view().superblocks_mapped >= 0


def test_device_pool_satisfies_protocol():
    _exercise(DevicePagePool(16, 4, ReleaseStrategy.MADVISE, device="cpu"))


def test_host_allocator_satisfies_protocol():
    a = HostAllocator(block_bytes=64, num_superblocks=16,
                      superblock_size=64 * 1024)
    try:
        _exercise(a)
    finally:
        a.close()


def test_host_allocator_release_respects_keep_floor():
    a = HostAllocator(block_bytes=64, num_superblocks=16,
                      superblock_size=64 * 1024)
    try:
        per_sb = a.view().pages_per_superblock
        ids, ok = a.alloc(per_sb + per_sb // 2)
        assert ok
        mapped = a.view().superblocks_mapped
        assert mapped >= 2
        a.free(ids)
        got_sb, _ = a.release(mapped)
        assert got_sb == 0
        assert a.view().superblocks_mapped == mapped
        a.release(1)
        assert a.view().superblocks_mapped >= 1
    finally:
        a.close()


# ---------------------------------------------------------------------------
# parity: both packages through one seeded sequence


def _anchors(lr) -> dict:
    """Superblock base -> (anchor, persistent, size class, generation)."""
    return {b: (d.anchor.load(), d.persistent, d.size_class, d.generation)
            for b, d in lr.pagemap.items()}


def _arena_counters(lr) -> tuple:
    ar = lr.arena
    return ar.sb_acquired, ar.sb_released, ar.remap_syscalls


@pytest.mark.parametrize("strategy", list(ReleaseStrategy))
@pytest.mark.parametrize("seed", range(3))
def test_lrmalloc_parity(seed, strategy):
    """malloc/palloc/free/flush in one seeded order on both packages'
    ``LRMalloc``: the same offsets, anchors, counters and stats."""
    rng = random.Random(seed)
    pair = [pkg.LRMalloc(num_superblocks=32, superblock_size=64 * 1024,
                         strategy=getattr(pkg.ReleaseStrategy, strategy.name))
            for pkg in (J, T)]
    live: list[int] = []
    try:
        for _ in range(1500):
            r = rng.random()
            if r < 0.45 or not live:
                size = rng.choice([16, 48, 64, 200, 1024, 4096, MAX_SZ + 8])
                op = "palloc" if rng.random() < 0.5 and size <= MAX_SZ \
                    else "malloc"
                got = [getattr(a, op)(size) for a in pair]
                live.append(got[0])
            elif r < 0.9:
                off = live.pop(rng.randrange(len(live)))
                got = [a.free(off) for a in pair]
            elif r < 0.97:
                n = rng.randrange(1, 64)
                got = [a.flush_cache_blocks(n) for a in pair]
            else:
                got = [a.flush_all_caches() for a in pair]
            assert got[0] == got[1]
            for a in pair:
                for off in live[-3:]:
                    if off < a.arena.total:
                        a.write_u64(off, off)
            assert _anchors(pair[0]) == _anchors(pair[1])
        assert pair[0].stats.snapshot() == pair[1].stats.snapshot()
        assert _arena_counters(pair[0]) == _arena_counters(pair[1])
    finally:
        for a in pair:
            a.close()


@pytest.mark.parametrize("strategy", list(ReleaseStrategy))
@pytest.mark.parametrize("seed", range(3))
def test_host_allocator_parity(seed, strategy):
    """The ``Allocator`` protocol on both packages' ``HostAllocator``: the
    same grants, share answers, release counts, snapshots and views."""
    rng = random.Random(100 + seed)
    pair = [pkg.HostAllocator(
        block_bytes=256, num_superblocks=8, superblock_size=64 * 1024,
        release_strategy=getattr(pkg.ReleaseStrategy, strategy.name))
        for pkg in (J, T)]
    refs: dict[int, int] = {}
    try:
        for _ in range(300):
            op = rng.choice(["alloc", "free", "free", "share", "release",
                             "map", "snapshot"])
            held = sorted(refs)
            if op == "alloc":
                n = rng.randrange(1, 700)  # 2048 blocks: some exhaust
                got = [a.alloc(n) for a in pair]
                for off in got[0][0]:
                    refs[off] = 1
            elif op == "free":
                ids = rng.sample(held, min(len(held), rng.randrange(1, 400))) \
                    + [-1]
                got = [a.free(ids) for a in pair]
                for off in ids[:-1]:
                    refs[off] -= 1
                    if not refs[off]:
                        del refs[off]
            elif op == "share":
                ids = rng.sample(held, min(len(held), 4))
                if rng.random() < 0.2:
                    ids.append(rng.randrange(0, 8 * 64 * 1024, 256))
                got = [a.share(ids) for a in pair]
                if got[0]:
                    for off in ids:
                        refs[off] += 1
            elif op == "release":
                keep = rng.randrange(0, 9)
                got = [a.release(keep) for a in pair]
            elif op == "map":
                n = rng.randrange(0, 9)
                got = [a.map(n) for a in pair]
            else:
                ids = rng.sample(held, min(len(held), 8)) + [-1, 16]
                got = [a.snapshot(ids) for a in pair]
            assert got[0] == got[1], op
            assert dataclasses.asdict(pair[0].view()) == \
                dataclasses.asdict(pair[1].view())
            assert _anchors(pair[0]._lr) == _anchors(pair[1]._lr)
            assert pair[0]._lr.stats.snapshot() == pair[1]._lr.stats.snapshot()
        if strategy is not ReleaseStrategy.KEEP:  # KEEP's release is a no-op
            assert pair[1].view().superblocks_released > 0
    finally:
        for a in pair:
            a.close()


@pytest.mark.parametrize("table", ["list", "hash"])
@pytest.mark.parametrize("name", ["NR", "OA-BIT", "OA-VER"])
def test_reclaimer_parity_single_thread(name, table):
    """A seeded single-threaded mix of insert/delete/contains on both
    packages' list or hash table under one reclaimer: the same answers,
    keys, ``ReclaimStats`` and allocator stats."""
    rng = random.Random(f"{name}/{table}")
    runs = []
    for pkg in (J, T):
        a = pkg.LRMalloc(num_superblocks=128, superblock_size=64 * 1024)
        rec = pkg.RECLAIMERS[name](a, limbo_threshold=16)
        ds = pkg.HarrisMichaelList(rec) if table == "list" \
            else pkg.MichaelHashTable(rec, 64)
        runs.append((a, rec, ds, rec.thread_ctx()))
    try:
        for _ in range(3000):
            k, r = rng.randrange(1, 500), rng.random()
            op = "insert" if r < 0.4 else "delete" if r < 0.8 else "contains"
            got = [getattr(ds, op)(k, ctx) for _, _, ds, ctx in runs]
            assert got[0] == got[1], (op, k)
        for _, rec, _, ctx in runs:
            rec.flush(ctx)
        keys = [ds.keys(ctx) if table == "list"
                else sorted(k for b in ds.buckets for k in b.keys(ctx))
                for _, _, ds, ctx in runs]
        assert keys[0] == keys[1]
        assert runs[0][1].stats.snapshot() == runs[1][1].stats.snapshot()
        assert runs[0][0].stats.snapshot() == runs[1][0].stats.snapshot()
        if name != "NR":
            assert runs[1][1].stats.snapshot()["nodes_freed"] > 0
    finally:
        for a, *_ in runs:
            a.close()

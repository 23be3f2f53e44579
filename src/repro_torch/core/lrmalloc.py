"""LRMalloc (Leite & Rocha 2019) extended with ``palloc`` — paper §2.3 + §3.

Three components, exactly as the paper describes:

- **thread caches** — one stack per (size class, persistent-flag) per thread;
  a malloc is a pop, a free is a push; fills/flushes hit the heap.
- **heap** — manages *superblocks* (large arena blocks carved into same-size
  blocks) through *descriptors* that are never reclaimed, only recycled.
- **pagemap** — maps any block offset to its superblock's descriptor.

The paper's extension: ``palloc()`` allocates from superblocks flagged
*persistent*.  A persistent superblock that becomes empty is NOT released to
the OS; instead the configured `vm.ReleaseStrategy` drops its physical frames
while keeping the range readable, and its descriptor — which still owns the
virtual range — goes to a second recycling pool that is preferred when a new
superblock is needed (that is how virtual address space is recycled, §3.2).

Superblock states and transitions follow Fig. 2:
FULL -> PARTIAL -> {FULL, EMPTY}; persistent EMPTY superblocks re-enter
circulation through the mapped-descriptor pool rather than being unmapped.

The anchor CAS protocol mirrors LRMalloc: a descriptor's ``anchor`` packs
(state, avail, count, tag) and every state transition is a single CAS; block
free lists are threaded *through the block memory itself*.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .allocator import AllocatorView
from .atomic import AtomicRef
from .sizeclass import MAX_SZ, NUM_CLASSES, class_block_size, size_to_class
from .vm import Arena, LargeAllocation, ReleaseStrategy

# Anchor states (paper Fig. 2)
FULL, PARTIAL, EMPTY = 0, 1, 2

_STATE_NAMES = {FULL: "full", PARTIAL: "partial", EMPTY: "empty"}


@dataclass
class Anchor:
    state: int
    avail: int  # offset of first free block (0 = none)
    count: int  # number of free blocks
    tag: int  # ABA tag

    def as_tuple(self):
        """Packed form for the descriptor's single-word anchor CAS."""
        return (self.state, self.avail, self.count, self.tag)


class Descriptor:
    """Superblock metadata; never reclaimed, recycled via pools (§2.3)."""

    __slots__ = ("anchor", "base", "block_size", "size_class", "nblocks",
                 "persistent", "generation")

    def __init__(self):
        self.anchor = AtomicRef((EMPTY, 0, 0, 0))
        self.base = -1  # arena offset of the superblock; -1 = no range owned
        self.block_size = 0
        self.size_class = -1
        self.nblocks = 0
        self.persistent = False
        self.generation = 0  # bumped on every reuse; stale-entry filter


class _TreiberStack:
    """Lock-free stack of (descriptor, generation) entries."""

    def __init__(self):
        self._top = AtomicRef(None)  # linked tuples: (desc, gen, rest)

    def push(self, desc: Descriptor) -> None:
        while True:
            top = self._top.load()
            if self._top.cas(top, (desc, desc.generation, top)):
                return

    def pop(self):
        while True:
            top = self._top.load()
            if top is None:
                return None
            desc, gen, rest = top
            if self._top.cas(top, rest):
                if desc.generation != gen:
                    continue  # stale entry from a recycled descriptor
                return desc


@dataclass
class AllocatorStats:
    allocs: int = 0
    frees: int = 0
    cache_fills: int = 0
    cache_flushes: int = 0
    superblocks_created: int = 0
    superblocks_reused_mapped: int = 0  # virtual range recycled (§3.2)
    persistent_released: int = 0
    large_allocs: int = 0

    def snapshot(self) -> dict:
        """Plain-dict copy of the allocator counters."""
        return dict(self.__dict__)


class _ThreadCache(threading.local):
    def __init__(self):
        # (size_class, persistent) -> list of free block offsets
        self.stacks: dict[tuple[int, bool], list[int]] = {}


class LRMalloc:
    """The allocator.  Block "pointers" are integer offsets into the arena."""

    #: soft per-class cache bound; a flush drains half of it back to the heap
    CACHE_CAP = 256

    def __init__(
        self,
        num_superblocks: int = 256,
        superblock_size: int = 64 * 1024,
        strategy: ReleaseStrategy = ReleaseStrategy.MADVISE,
    ):
        self.arena = Arena(num_superblocks, superblock_size, strategy)
        self.sb_size = superblock_size
        # pagemap: superblock base offset -> descriptor (dict ops are atomic
        # under the GIL; the real pagemap is a flat lock-free array).
        self.pagemap: dict[int, Descriptor] = {}
        # partial-superblock stacks per (size class, persistent)
        self._partial = {
            (ci, p): _TreiberStack() for ci in range(NUM_CLASSES) for p in (False, True)
        }
        # descriptor recycling pools (§4): mapped pool first, generic second
        self._pool_mapped = _TreiberStack()  # descriptors owning a live range
        self._pool_generic = _TreiberStack()
        self._cache = _ThreadCache()
        self._large: dict[int, LargeAllocation] = {}
        self._large_next = self.arena.total + superblock_size  # synthetic keys
        self._large_lock = threading.Lock()
        self.stats = AllocatorStats()
        self._stats_lock = threading.Lock()

    # -- public API ------------------------------------------------------------

    def malloc(self, nbytes: int) -> int:
        """Ordinary allocation (LRMalloc fast path; large sizes direct-map).
        The block may be UNMAPPED after free — use ``palloc`` for memory
        optimistic readers may touch after reclamation."""
        if nbytes > MAX_SZ:
            return self._malloc_large(nbytes)
        return self._malloc_sc(size_to_class(nbytes), persistent=False)

    def palloc(self, nbytes: int) -> int:
        """Persistent allocation: the returned block's address range stays
        readable for the process lifetime even after ``free`` (paper §3.1).
        Restricted to size-class sizes (paper §4)."""
        if nbytes > MAX_SZ:
            raise ValueError(
                f"palloc restricted to size-class sizes <= {MAX_SZ} (paper §4)"
            )
        return self._malloc_sc(size_to_class(nbytes), persistent=True)

    def free(self, off: int) -> None:
        """Free a block into the thread cache (flushes at CACHE_CAP).  For
        persistent blocks the RANGE stays readable afterwards — only reuse
        is gated, which is what lets OA readers race reclamation."""
        if off >= self.arena.total:
            return self._free_large(off)
        desc = self.pagemap[off - off % self.sb_size]
        key = (desc.size_class, desc.persistent)
        stack = self._cache.stacks.setdefault(key, [])
        stack.append(off)
        with self._stats_lock:
            self.stats.frees += 1
        if len(stack) > self.CACHE_CAP:
            self._flush_cache(key, len(stack) // 2)

    # convenience accessors used by data structures / tests
    def read_u64(self, off: int) -> int:
        """Read 8 bytes at offset (valid even for freed persistent blocks)."""
        return self.arena.read_u64(off)

    def write_u64(self, off: int, val: int) -> None:
        """Write 8 bytes at offset (caller must hold a hazard/ownership)."""
        self.arena.write_u64(off, val)

    def cas_u64(self, off: int, exp: int, new: int) -> bool:
        """CAS 8 bytes at offset (emulated word CAS; see core.atomic)."""
        return self.arena.cas_u64(off, exp, new)

    def flush_all_caches(self) -> None:
        """Flush this thread's caches (tests/benchmarks teardown)."""
        for key in list(self._cache.stacks):
            self._flush_cache(key, len(self._cache.stacks[key]))

    def flush_cache_blocks(self, n: int = 1) -> int:
        """Flush up to ``n`` blocks from THIS thread's caches back to their
        superblocks (EMPTY transitions retire per the release strategy).
        Returns the number actually flushed (0 = caches empty).  The public
        fine-grained hook incremental release policies need — e.g. the
        ``HostAllocator`` adapter flushing until a mapped-superblock floor
        is reached; like ``flush_all_caches`` it only sees the calling
        thread's cache."""
        flushed = 0
        for key in list(self._cache.stacks):
            while flushed < n and self._cache.stacks.get(key):
                self._flush_cache(key, 1)
                flushed += 1
            if flushed >= n:
                break
        return flushed

    # -- size-class path ---------------------------------------------------------

    def _malloc_sc(self, ci: int, persistent: bool) -> int:
        key = (ci, persistent)
        stack = self._cache.stacks.setdefault(key, [])
        if not stack:
            self._fill_cache(ci, persistent, stack)
        with self._stats_lock:
            self.stats.allocs += 1
        return stack.pop()

    def _fill_cache(self, ci: int, persistent: bool, stack: list[int]) -> None:
        with self._stats_lock:
            self.stats.cache_fills += 1
        # 1) try a partial superblock (paper: partials have priority)
        while True:
            desc = self._partial[(ci, persistent)].pop()
            if desc is None:
                break
            got = self._reserve_all(desc)
            if got:
                self._stock_cache(desc, got, stack)
                return
        # 2) new superblock: mapped-descriptor pool > generic pool > fresh
        desc = None
        if persistent:
            desc = self._pool_mapped.pop()
            if desc is not None:
                self.arena.prepare_reuse(desc.base)
                with self._stats_lock:
                    self.stats.superblocks_reused_mapped += 1
        if desc is None:
            desc = self._pool_generic.pop()
        if desc is None:
            desc = Descriptor()
        if desc.base < 0:
            desc.base = self.arena.acquire_superblock()
        desc.generation += 1
        bs = class_block_size(ci)
        desc.block_size = bs
        desc.size_class = ci
        desc.nblocks = self.sb_size // bs
        desc.persistent = persistent
        # Initial state is FULL: every block goes straight to the cache (§2.3).
        tag = desc.anchor.load()[3]
        desc.anchor.store((FULL, 0, 0, tag + 1))
        self.pagemap[desc.base] = desc
        with self._stats_lock:
            self.stats.superblocks_created += 1
        start = desc.base
        if start == 0:
            # Burn block 0 so offset 0 serves as NULL.  Superblock 0 can then
            # never reach EMPTY (count tops out at nblocks-1) — it lives for
            # the process lifetime, which is exactly what a NULL guard needs.
            start += bs
        self._stock_cache(
            desc, list(range(start, desc.base + desc.nblocks * bs, bs)), stack
        )

    def _stock_cache(self, desc: Descriptor, blocks: list[int], stack: list[int]) -> None:
        """Keep at most CACHE_CAP blocks in the cache; surplus returns to the
        superblock in one anchor CAS (LRMalloc reserves up to the cache
        capacity — superblocks go FULL at creation then immediately PARTIAL
        with the surplus published for other threads)."""
        if len(blocks) > self.CACHE_CAP:
            self._return_blocks(desc, blocks[self.CACHE_CAP :])
            blocks = blocks[: self.CACHE_CAP]
        stack.extend(blocks)

    def _reserve_all(self, desc: Descriptor) -> list[int]:
        """MallocFromPartial: one CAS claims every available block, then the
        claimant privately walks the in-memory free list."""
        while True:
            state, avail, count, tag = desc.anchor.load()
            if state != PARTIAL or count == 0:
                return []
            if desc.anchor.cas((state, avail, count, tag), (FULL, 0, 0, tag + 1)):
                blocks = []
                off = avail
                for _ in range(count):
                    blocks.append(off)
                    off = self.arena.read_u64(off)
                return blocks

    def _flush_cache(self, key: tuple[int, bool], n: int) -> None:
        """Return ``n`` cached blocks to their superblocks (anchor CAS per
        group), handling FULL->PARTIAL and PARTIAL->EMPTY transitions."""
        stack = self._cache.stacks[key]
        with self._stats_lock:
            self.stats.cache_flushes += 1
        by_desc: dict[int, list[int]] = {}
        for _ in range(min(n, len(stack))):
            off = stack.pop()
            by_desc.setdefault(off - off % self.sb_size, []).append(off)
        for base, blocks in by_desc.items():
            self._return_blocks(self.pagemap[base], blocks)

    def _return_blocks(self, desc: Descriptor, blocks: list[int]) -> None:
        while True:
            state, avail, count, tag = desc.anchor.load()
            # thread the group through block memory: last -> current avail
            for i, off in enumerate(blocks):
                nxt = blocks[i + 1] if i + 1 < len(blocks) else avail
                self.arena.write_u64(off, nxt)
            new_count = count + len(blocks)
            new_state = EMPTY if new_count == desc.nblocks else PARTIAL
            if desc.anchor.cas(
                (state, avail, count, tag), (new_state, blocks[0], new_count, tag + 1)
            ):
                if new_state == EMPTY:
                    self._retire_superblock(desc)
                elif state == FULL:  # FULL -> PARTIAL: publish for fills
                    self._partial[(desc.size_class, desc.persistent)].push(desc)
                return

    def _retire_superblock(self, desc: Descriptor) -> None:
        """EMPTY transition (Fig. 2): non-persistent superblocks release their
        range to the OS; persistent ones run the release strategy and park
        their descriptor (still owning the range) in the mapped pool."""
        base = desc.base
        self.pagemap.pop(base, None)
        desc.generation += 1  # invalidate stale partial-stack entries
        self.arena.release_superblock(base, desc.persistent)
        if desc.persistent:
            with self._stats_lock:
                self.stats.persistent_released += 1
            self._pool_mapped.push(desc)
        else:
            desc.base = -1
            self._pool_generic.push(desc)

    # -- large allocations (paper §4: straight to the OS) -----------------------

    def _malloc_large(self, nbytes: int) -> int:
        la = LargeAllocation(nbytes)
        with self._large_lock:
            key = self._large_next
            self._large_next += ((nbytes + self.sb_size - 1) // self.sb_size) * self.sb_size
            self._large[key] = la
            self.stats.large_allocs += 1
        return key

    def _free_large(self, off: int) -> None:
        with self._large_lock:
            la = self._large.pop(off)
        la.close()

    # -- introspection -----------------------------------------------------------

    def resident_bytes(self) -> int:
        """Physically resident bytes of the arena (smaps Pss; see vm.py)."""
        return self.arena.resident_bytes()

    def close(self) -> None:
        """Release the arena mapping and any direct-mapped large blocks."""
        self.arena.close()
        for la in self._large.values():
            la.close()


class HostAllocator:
    """:class:`repro.core.allocator.Allocator` over an :class:`LRMalloc`.

    Units are fixed-size *persistent* blocks (``palloc``: the range stays
    readable after free — the OA guarantee), refcounted by the adapter so
    the host model supports the same share/unshare vocabulary as the device
    pool: a block frees (and its VERSION bumps — the OA-VER warning) only on
    the refcount zero-transition, so several owners of one block compose
    with optimistic readers exactly as KV-page sharing does on the device.

    Superblock accounting maps onto LRMalloc's own lifecycle: an EMPTY
    persistent superblock runs the configured release strategy at its
    retire transition and parks its descriptor in the mapped pool, which a
    later fill reuses (``map`` is therefore lazy here — remapping happens
    on the allocation path, and :meth:`map` reports ``(0, 0)``).  The
    adapter owns its private LRMalloc, so every superblock it sees is a
    persistent one and the counter arithmetic in :meth:`view` is exact.
    """

    def __init__(self, block_bytes: int = 64, num_superblocks: int = 64,
                 superblock_size: int = 64 * 1024,
                 release_strategy: ReleaseStrategy = ReleaseStrategy.MADVISE):
        if block_bytes > MAX_SZ:
            raise ValueError("persistent blocks are size-class sized (§4)")
        self._lr = LRMalloc(num_superblocks=num_superblocks,
                            superblock_size=superblock_size,
                            strategy=release_strategy)
        self.block_bytes = class_block_size(size_to_class(block_bytes))
        self.release_strategy = release_strategy
        self.state = None  # host state is internal (protocol: opaque anyway)
        self._refcount: dict[int, int] = {}
        self._version: dict[int, int] = {}

    def alloc(self, n: int) -> tuple[list[int], bool]:
        """Grant ``n`` persistent blocks at refcount 1.  All-or-nothing: on
        arena exhaustion every block of the partial grant is returned and
        ``([], False)`` comes back — the caller reclaims and retries."""
        got: list[int] = []
        try:
            for _ in range(n):
                got.append(self._lr.palloc(self.block_bytes))
        except MemoryError:
            for off in got:
                self._lr.free(off)
            return [], False
        for off in got:
            self._refcount[off] = 1
            self._version.setdefault(off, 0)
        return got, True

    def free(self, units) -> None:
        """Drop one reference per block (negative ids ignored); the
        zero-transition bumps the block's version (readers of a stale
        snapshot fail validation) and returns it to the heap — where an
        EMPTY superblock's retire transition runs the release strategy."""
        for off in units:
            off = int(off)
            if off < 0:
                continue
            rc = self._refcount.get(off, 0)
            if rc <= 1:
                if rc == 1:
                    self._refcount.pop(off)
                    self._version[off] = self._version.get(off, 0) + 1
                    self._lr.free(off)
                continue  # double-free of a free block: a no-op, like the pool
            self._refcount[off] = rc - 1

    def unshare(self, units) -> None:
        """Alias of :meth:`free` (the refcount vocabulary)."""
        self.free(units)

    def share(self, units) -> bool:
        """Add one reference per LIVE block; naming a free block suppresses
        every increment and returns False (use-after-free in the making)."""
        offs = [int(o) for o in units if int(o) >= 0]
        if any(self._refcount.get(o, 0) == 0 for o in offs):
            return False
        for o in offs:
            self._refcount[o] += 1
        return True

    def release(self, keep_superblocks: int) -> tuple[int, int]:
        """Flush the thread caches so EMPTY persistent superblocks reach
        their retire transition (frames dropped per the strategy, the
        descriptor parked still owning the range), stopping once the
        mapped count touches the ``keep_superblocks`` floor.  Superblocks
        holding any live block are never releasable regardless; flushing
        happens block-by-block so a retire that lands the floor halts
        further releases.  Returns the delta ``(n_superblocks, n_blocks)``
        this call released."""
        if self.release_strategy is ReleaseStrategy.KEEP:
            return 0, 0
        before = self._lr.stats.persistent_released
        keep = max(0, keep_superblocks)
        while self.view().superblocks_mapped > keep:
            if self._lr.flush_cache_blocks(1) == 0:
                break  # caches drained: whatever is left holds live blocks
        got = self._lr.stats.persistent_released - before
        return got, got * (self._lr.sb_size // self.block_bytes)

    def map(self, n_superblocks: int) -> tuple[int, int]:
        """LRMalloc remaps lazily: the next cache fill pops a parked
        descriptor from the mapped pool and ``prepare_reuse`` restores the
        range (§3.2) — there is nothing to do eagerly, so this reports
        ``(0, 0)`` and the remap shows up in :meth:`view` afterwards."""
        return 0, 0

    def snapshot(self, units):
        """Current versions of ``units`` (negative ids read as 0) — the OA
        reader's LocalClock, host-dict edition."""
        return [0 if int(o) < 0 else self._version.get(int(o), 0)
                for o in units]

    def view(self) -> AllocatorView:
        """Anchor introspection from the LRMalloc counters (exact because
        this adapter's private heap only ever holds persistent blocks)."""
        s = self._lr.stats
        return AllocatorView(
            superblocks_total=self._lr.arena.num_sb,
            superblocks_mapped=s.superblocks_created - s.persistent_released,
            superblocks_released=s.persistent_released,
            superblocks_remapped=s.superblocks_reused_mapped,
            pages_mapped=((s.superblocks_created - s.persistent_released)
                          * (self._lr.sb_size // self.block_bytes)),
            pages_per_superblock=self._lr.sb_size // self.block_bytes,
            release_strategy=self.release_strategy.value,
        )

    def resident_bytes(self) -> int:
        """Physically resident bytes of the backing arena (smaps Pss)."""
        return self._lr.resident_bytes()

    def close(self) -> None:
        """Release the backing arena mapping."""
        self._lr.close()

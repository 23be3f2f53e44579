"""Virtual-memory arena implementing the paper's §3.2 for real on Linux.

Superblocks live inside one large anonymous private mapping.  Releasing a
*persistent* superblock must keep its address range readable while giving the
physical frames back to the OS.  Three strategies (paper §3.1–§3.2):

- ``KEEP``          — allocator-level recycling only: frames are kept; memory
                      is reusable by the whole process but never returned to
                      the OS (the paper's first, portable solution).
- ``MADVISE``       — ``madvise(MADV_DONTNEED)``: pages revert to the shared
                      zero copy-on-write frame.  Reads stay valid (return 0),
                      frames are freed immediately (Linux semantics).
- ``SHARED_REMAP``  — ``mmap(MAP_FIXED|MAP_SHARED)`` the dead range onto one
                      pre-reserved shared region backed by a single set of
                      frames (memfd).  Arbitrarily many dead superblocks cost
                      one superblock of physical memory.  Reuse remaps the
                      range ``MAP_FIXED|MAP_PRIVATE|MAP_ANONYMOUS``.

Non-persistent superblocks are "released to the OS"; in this single-mapping
arena that is modelled as ``MADV_DONTNEED`` (frames dropped) plus returning
the index to the free stack — physically equivalent to unmap+remap of the
same range, without fragmenting the Python mmap object.

``resident_pages`` measures actual physical residency via ``mincore(2)`` so
tests and benchmarks can *prove* frames were released (paper Fig. 3).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import enum
import mmap
import os
import threading

_libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)

_libc.mmap.restype = ctypes.c_void_p
_libc.mmap.argtypes = [
    ctypes.c_void_p,
    ctypes.c_size_t,
    ctypes.c_int,
    ctypes.c_int,
    ctypes.c_int,
    ctypes.c_long,
]
_libc.mincore.restype = ctypes.c_int
_libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p]

PROT_READ = 0x1
PROT_WRITE = 0x2
MAP_SHARED = 0x01
MAP_PRIVATE = 0x02
MAP_FIXED = 0x10
MAP_ANONYMOUS = 0x20

PAGE_SIZE = os.sysconf("SC_PAGESIZE")


class ReleaseStrategy(enum.Enum):
    """How released superblocks relate to the OS (paper §3.1–§3.2).

    Shared vocabulary between the host arena (this module) and the device
    page pool (``core.pagepool`` / the serving engine): ``KEEP`` recycles
    within the process but never releases; ``MADVISE`` / ``SHARED_REMAP``
    release physical frames while the virtual range stays readable.
    """

    KEEP = "keep"
    MADVISE = "madvise"
    SHARED_REMAP = "shared_remap"


def superblock_floor(distinct_live_pages: int, pages_per_superblock: int,
                     min_mapped: int = 1) -> int:
    """Mapped-superblock floor a release must respect, given demand.

    ``distinct_live_pages`` must count every page ONCE no matter how many
    holders reference it: with the refcount layer a prompt-prefix page can
    back several requests plus the prefix cache simultaneously, and summing
    per-request footprints would overstate demand — pinning superblocks
    mapped that are actually releasable.  The caller (the engine's
    quiescence shrink) computes the distinct count from its host mirrors;
    this helper just turns pages into a superblock floor:
    ``max(min_mapped, ceil(pages / pages_per_superblock))``.
    """
    if pages_per_superblock <= 0:
        raise ValueError("pages_per_superblock must be positive")
    need = -(-max(0, distinct_live_pages) // pages_per_superblock)
    return max(min_mapped, need)


class Arena:
    """A contiguous region carved into equal-size superblocks.

    "Pointers" handed to the rest of the system are integer byte offsets into
    the arena (offset 0 is reserved as NULL).  ``view`` exposes the raw bytes;
    reads through it remain valid after any release strategy — that is the
    paper's core guarantee.
    """

    def __init__(
        self,
        num_superblocks: int = 64,
        superblock_size: int = 256 * 1024,
        strategy: ReleaseStrategy = ReleaseStrategy.MADVISE,
    ):
        if superblock_size % PAGE_SIZE:
            raise ValueError("superblock size must be page-aligned")
        self.sb_size = superblock_size
        self.num_sb = num_superblocks
        self.total = num_superblocks * superblock_size
        self.strategy = strategy
        self._mm = mmap.mmap(-1, self.total)  # MAP_PRIVATE|MAP_ANONYMOUS
        self.view = memoryview(self._mm)
        self._base = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
        self._lock = threading.Lock()
        # Free superblock indices; index 0's first 16 bytes are burned so that
        # offset 0 can serve as NULL.
        self._free_sbs: list[int] = list(range(num_superblocks - 1, -1, -1))
        # Pre-reserved shared region: one superblock worth of frames backed by
        # a memfd; every SHARED_REMAP'd dead superblock maps onto it.
        self._shared_fd = -1
        if strategy is ReleaseStrategy.SHARED_REMAP:
            self._shared_fd = os.memfd_create("repro-oa-shared")
            os.ftruncate(self._shared_fd, superblock_size)
        # Striped locks emulating word-level CAS on arena memory (CPython has
        # no native CAS; the GIL makes this faithful to TSO semantics).
        self._stripes = [threading.Lock() for _ in range(256)]
        # stats
        self.sb_acquired = 0
        self.sb_released = 0
        self.remap_syscalls = 0

    # -- superblock lifecycle -------------------------------------------------

    def acquire_superblock(self) -> int:
        """Return the base offset of a fresh superblock ("request from OS")."""
        with self._lock:
            if not self._free_sbs:
                raise MemoryError("arena exhausted (no free superblocks)")
            idx = self._free_sbs.pop()
            self.sb_acquired += 1
        return idx * self.sb_size

    def release_superblock(self, base_off: int, persistent: bool) -> None:
        """Release an empty superblock.

        Non-persistent: frames dropped and the range returns to the free
        stack (the classic malloc→OS path).  Persistent: the configured
        strategy runs and the range is NOT returned here — the caller keeps
        the (still readable) range alive inside a mapped-descriptor pool
        (paper §3.2 recycles the virtual range via descriptor recycling).
        """
        assert base_off % self.sb_size == 0
        if not persistent:
            self._mm.madvise(mmap.MADV_DONTNEED, base_off, self.sb_size)
            with self._lock:
                self._free_sbs.append(base_off // self.sb_size)
                self.sb_released += 1
            return
        if self.strategy is ReleaseStrategy.KEEP:
            return  # frames retained; reusable by the process, not the OS
        if self.strategy is ReleaseStrategy.MADVISE:
            self._mm.madvise(mmap.MADV_DONTNEED, base_off, self.sb_size)
            return
        # SHARED_REMAP: map the dead range onto the single shared region.
        # PROT_WRITE included: optimistic DWCAS (VBR-style, paper §3.2) may
        # issue write-intent to reclaimed memory; under the shared mapping
        # that dirties the one shared frame (whose contents are garbage by
        # contract) instead of faulting in a private frame per page — the
        # leak-freedom property the paper claims for this method.
        res = _libc.mmap(
            self._base + base_off,
            self.sb_size,
            PROT_READ | PROT_WRITE,
            MAP_SHARED | MAP_FIXED,
            self._shared_fd,
            0,
        )
        if res == ctypes.c_void_p(-1).value or res is None:
            raise OSError(ctypes.get_errno(), "mmap(MAP_FIXED|MAP_SHARED) failed")
        self.remap_syscalls += 1

    def prepare_reuse(self, base_off: int) -> None:
        """Make a previously released persistent range writable again.

        KEEP/MADVISE need nothing (CoW faults frames back in on write);
        SHARED_REMAP replaces the shared window with fresh anonymous memory —
        one syscall regardless of the shared-region granularity (paper §3.2).
        """
        if self.strategy is not ReleaseStrategy.SHARED_REMAP:
            return
        res = _libc.mmap(
            self._base + base_off,
            self.sb_size,
            PROT_READ | PROT_WRITE,
            MAP_PRIVATE | MAP_FIXED | MAP_ANONYMOUS,
            -1,
            0,
        )
        if res == ctypes.c_void_p(-1).value or res is None:
            raise OSError(ctypes.get_errno(), "mmap(MAP_FIXED|MAP_PRIVATE) failed")
        self.remap_syscalls += 1

    # -- memory access --------------------------------------------------------

    def read_u64(self, off: int) -> int:
        """Read 8 little-endian bytes (valid even after any release)."""
        return int.from_bytes(self.view[off : off + 8], "little")

    def write_u64(self, off: int, val: int) -> None:
        """Write 8 little-endian bytes at ``off``."""
        self.view[off : off + 8] = (val & (2**64 - 1)).to_bytes(8, "little")

    def cas_u64(self, off: int, expected: int, new: int) -> bool:
        """CAS on 8 arena bytes (emulated; see ``core.atomic``)."""
        with self._stripes[(off >> 4) & 0xFF]:
            if self.read_u64(off) == expected:
                self.write_u64(off, new)
                return True
            return False

    def cas_u64_hw(self, off: int, expected: int, new: int) -> bool:
        """CAS with *hardware* write-intent semantics: a real lock-prefixed
        CAS needs the cacheline writable even when the compare FAILS, so it
        dirties the page either way (paper §3.2: this is why VBR's DWCAS on
        reclaimed memory faults CoW frames back in under MADV_DONTNEED —
        memory leak — but not under the shared mapping)."""
        with self._stripes[(off >> 4) & 0xFF]:
            cur = self.read_u64(off)
            if cur == expected:
                self.write_u64(off, new)
                return True
            self.write_u64(off, cur)  # write-intent touch: dirties the page
            return False

    # -- measurement -----------------------------------------------------------

    def _smaps_field(self, field: str, off: int, length: int | None) -> int:
        """Sum a /proc/self/smaps field (KiB) over mappings in the range."""
        length = self.total - off if length is None else length
        lo = self._base + off
        hi = lo + length
        total = 0
        cur_overlap = 0.0
        with open("/proc/self/smaps") as f:
            for line in f:
                if "-" in line.split(" ", 1)[0] and line[0] in "0123456789abcdef":
                    try:
                        rng, _ = line.split(" ", 1)
                        a, b = (int(x, 16) for x in rng.split("-"))
                    except ValueError:
                        continue
                    span = max(0, min(b, hi) - max(a, lo))
                    cur_overlap = span / (b - a) if b > a else 0.0
                elif line.startswith(field + ":") and cur_overlap > 0:
                    total += int(int(line.split()[1]) * cur_overlap)
                    cur_overlap = 0.0
        return total

    def resident_pages(self, off: int = 0, length: int | None = None) -> int:
        """Physically resident pages in [off, off+length), measured as smaps
        **Pss** (proportional set size).

        Why not mincore(2): on this kernel it reports MADV_DONTNEED'ed anon
        pages as resident.  Why not Rss: the paper itself observes (§3.2)
        that under the shared-remap method "the memory statistics go
        haywire" — Linux counts the ONE shared frame once per mapping in
        Rss.  Pss divides shared frames by their mapper count, so N dead
        superblocks over one frame cost ~one frame, which is the physical
        truth the paper's argument rests on.  ``resident_rss_pages`` exposes
        the haywire number for the reproduction of that observation.
        """
        return (self._smaps_field("Pss", off, length) * 1024) // PAGE_SIZE

    def resident_rss_pages(self, off: int = 0, length: int | None = None) -> int:
        """Rss-based residency — the 'haywire' number under SHARED_REMAP
        (each mapping of the one shared frame counts fully; paper §3.2)."""
        return (self._smaps_field("Rss", off, length) * 1024) // PAGE_SIZE

    def resident_bytes(self, off: int = 0, length: int | None = None) -> int:
        """Physically resident bytes in the range (Pss-based)."""
        return self.resident_pages(off, length) * PAGE_SIZE

    def close(self) -> None:
        """Unmap the arena and close the shared-frame memfd."""
        self.view.release()
        self._mm.close()
        if self._shared_fd >= 0:
            os.close(self._shared_fd)


class LargeAllocation:
    """Direct-mapped allocation above the largest size class (paper §4).

    These bypass the heap entirely; ``palloc`` refuses them — the paper
    restricts persistent allocation to size-class sizes.
    """

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self._mm = mmap.mmap(-1, nbytes)
        self.view = memoryview(self._mm)

    def close(self) -> None:
        """Unmap the direct-mapped allocation."""
        self.view.release()
        self._mm.close()

"""Both halves of the paper's allocator, ported.

The host layer is LRMalloc extended with ``palloc`` and virtual-memory
release (``lrmalloc.py`` over the mmap arena of ``vm.py``), the reclaimers
``NR``/``OA``/``OABit``/``OAVer`` (``reclaim.py``) and the lock-free list
and hash table they protect (``datastructures.py``): framework-free copies
of the reference's modules.  The device layer is the refcounted, versioned,
superblock-structured KV page pool (``pagepool.py``).  Both sit behind the
unified ``Allocator`` protocol (``allocator.py``), with the pluggable
reclamation policies (``reclaim_policy.py``) in front of the pool and the
seeded fault-injection layer (``chaos.py``) at the protocol surface."""

from .allocator import Allocator, AllocatorView
from .chaos import ChaosAllocator, ChaosConfig
from .atomic import AtomicRef, AtomicCounter, ReclaimStats, memory_barrier
from .sizeclass import SIZE_CLASSES, MAX_SZ, size_to_class, class_block_size
from .vm import (Arena, ReleaseStrategy, LargeAllocation, PAGE_SIZE,
                 superblock_floor)
from .lrmalloc import LRMalloc, AllocatorStats, HostAllocator, FULL, PARTIAL, EMPTY
from .reclaim import NR, OA, OABit, OAVer, RECLAIMERS, ReclaimerBase, ThreadCtx
from .datastructures import HarrisMichaelList, MichaelHashTable, NODE_SIZE

__all__ = [
    "Allocator", "AllocatorView",
    "ChaosAllocator", "ChaosConfig",
    "AtomicRef", "AtomicCounter", "ReclaimStats", "memory_barrier",
    "SIZE_CLASSES", "MAX_SZ", "size_to_class", "class_block_size",
    "Arena", "ReleaseStrategy", "LargeAllocation", "PAGE_SIZE",
    "superblock_floor",
    "LRMalloc", "AllocatorStats", "HostAllocator", "FULL", "PARTIAL", "EMPTY",
    "NR", "OA", "OABit", "OAVer", "RECLAIMERS", "ReclaimerBase", "ThreadCtx",
    "HarrisMichaelList", "MichaelHashTable", "NODE_SIZE",
]

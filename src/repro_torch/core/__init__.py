"""The device half of the paper's allocator, ported: the refcounted,
versioned, superblock-structured KV page pool (``pagepool.py``) behind the
unified ``Allocator`` protocol (``allocator.py``), with the pluggable
reclamation policies (``reclaim_policy.py``) in front of it, and the
seeded fault-injection layer (``chaos.py``) at the protocol surface."""

from .allocator import Allocator, AllocatorView
from .chaos import ChaosAllocator, ChaosConfig
from .vm import ReleaseStrategy, superblock_floor

__all__ = ["Allocator", "AllocatorView", "ChaosAllocator", "ChaosConfig",
           "ReleaseStrategy", "superblock_floor"]

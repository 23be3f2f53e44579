"""Memory-reclamation methods (paper §2.4 + §3.1).

Four schemes behind one API, matching the paper's evaluation:

- ``NR``     — no reclamation: retire is a no-op, memory is never reused.
- ``OA``     — the *original* Optimistic Access method (Cohen & Petrank 2015):
               a closed recycling pool (ready / retire / processing) with
               phase-based recycling; never interacts with the allocator
               after the pool is built.  This is the paper's baseline.
- ``OABit``  — paper Alg. 1: allocator-backed (``palloc``) with a per-thread
               warning *bit*; a reclamation batch sets every thread's bit,
               issues one barrier, scans hazard pointers, frees the rest.
- ``OAVer``  — paper Alg. 2: allocator-backed with one global monotonic
               clock; threads piggy-back on each other's warnings (a failed
               CAS on the clock counts as an observed warning).

Reader protocol (identical for all; NR's checks always pass):

    ctx = rec.thread_ctx()
    rec.start_op(ctx)
    ... read node fields ...
    if not rec.check(ctx): restart from a known-valid root
    ... before any CAS: rec.protect(ctx, slot, off) for each involved node,
        then rec.validate(ctx) — one barrier for the whole set (§2.4) ...

The DEVICE-side analogue of this choice-of-scheme lives in
``core/reclaim_policy.py``: the serving stack's fused step swaps its
per-step OA validation for epoch-grace skipping or IBR-style interval
deferral behind one ``ReclamationPolicy`` seam — the same
precision-vs-throughput spectrum these host schemes span, finally
benchmarked head-to-head in ``benchmarks/reclaim_matrix.py``.
"""

from __future__ import annotations

import threading
from collections import deque

from .atomic import AtomicRef, ReclaimStats, memory_barrier
from .lrmalloc import LRMalloc

NUM_HAZARDS = 3  # prev, cur, next — enough for Harris-Michael lists


class ThreadCtx:
    __slots__ = ("tid", "warning", "hazards", "limbo", "local_clock",
                 "last_retire_time")

    def __init__(self, tid: int):
        self.tid = tid
        self.warning = AtomicRef(False)
        self.hazards = [AtomicRef(0) for _ in range(NUM_HAZARDS)]
        self.limbo: list[int] = []
        self.local_clock = 0
        self.last_retire_time = 0


class ReclaimerBase:
    """Common thread registry + hazard-pointer plumbing."""

    name = "base"
    uses_palloc = False

    def __init__(self, alloc: LRMalloc, limbo_threshold: int = 64):
        self.alloc = alloc
        self.limbo_threshold = limbo_threshold
        self.stats = ReclaimStats()
        self._threads: list[ThreadCtx] = []
        self._reg_lock = threading.Lock()
        self._tls = threading.local()

    # -- registry ---------------------------------------------------------------

    def thread_ctx(self) -> ThreadCtx:
        """This thread's registered context (created on first use)."""
        ctx = getattr(self._tls, "ctx", None)
        if ctx is None:
            with self._reg_lock:
                ctx = ThreadCtx(len(self._threads))
                self._threads.append(ctx)
            self._tls.ctx = ctx
        return ctx

    # -- reader/writer protocol ---------------------------------------------------

    def start_op(self, ctx: ThreadCtx) -> None:
        """Begin an optimistic operation (OA-VER snapshots the clock here)."""
        pass

    def check(self, ctx: ThreadCtx) -> bool:
        """True iff every read since start_op is still valid (no warning)."""
        return True

    def protect(self, ctx: ThreadCtx, slot: int, off: int) -> None:
        """Publish a hazard pointer for ``off`` in the ctx's ``slot``."""
        ctx.hazards[slot].store(off)
        self.stats.hazard_writes.increment()

    def validate(self, ctx: ThreadCtx) -> bool:
        """One barrier validates the whole hazard set (§2.4)."""
        memory_barrier()
        self.stats.memory_barriers.increment()
        return self.check(ctx)

    def clear_hazards(self, ctx: ThreadCtx) -> None:
        """Drop every hazard this ctx holds (end of the protected region)."""
        for h in ctx.hazards:
            h.store(0)

    # -- allocation / retirement ----------------------------------------------------

    def alloc_node(self, ctx: ThreadCtx, nbytes: int) -> int:
        """Allocate node memory under this scheme's rules (palloc for OA)."""
        raise NotImplementedError

    def cancel_node(self, ctx: ThreadCtx, off: int) -> None:
        """Return a never-published node."""
        self.alloc.free(off)

    def retire(self, ctx: ThreadCtx, off: int) -> None:
        """Hand an unlinked node to the reclaimer (free happens later)."""
        raise NotImplementedError

    def flush(self, ctx: ThreadCtx) -> None:
        """Force reclamation of everything reclaimable (teardown/accounting)."""
        pass

    # -- internals shared by OABit / OAVer ---------------------------------------

    def _scan_and_free(self, ctx: ThreadCtx) -> None:
        hps = set()
        for t in self._threads:
            for h in t.hazards:
                hps.add(h.load())
        kept = []
        for m in ctx.limbo:
            if m in hps:
                kept.append(m)
            else:
                self.alloc.free(m)
                self.stats.nodes_freed.increment()
        ctx.limbo[:] = kept


class NR(ReclaimerBase):
    """No reclamation: the leak baseline."""

    name = "NR"

    def alloc_node(self, ctx: ThreadCtx, nbytes: int) -> int:
        """Plain malloc — nothing is ever reclaimed."""
        return self.alloc.malloc(nbytes)

    def retire(self, ctx: ThreadCtx, off: int) -> None:
        """Count the retire and leak the node (the baseline's point)."""
        self.stats.nodes_retired.increment()  # dropped on the floor

    def protect(self, ctx: ThreadCtx, slot: int, off: int) -> None:
        """No-op: memory never moves under NR."""
        pass  # nothing ever moves; no protection needed

    def validate(self, ctx: ThreadCtx) -> bool:
        """Always valid: nothing is ever reclaimed."""
        return True


class OABit(ReclaimerBase):
    """Paper Alg. 1 — simplified OA on top of ``palloc``."""

    name = "OA-BIT"
    uses_palloc = True

    def alloc_node(self, ctx: ThreadCtx, nbytes: int) -> int:
        """palloc: the node's range stays readable after reclamation."""
        return self.alloc.palloc(nbytes)

    def check(self, ctx: ThreadCtx) -> bool:
        """Consume this thread's warning bit; False = restart the op."""
        if ctx.warning.load():
            ctx.warning.store(False)
            self.stats.reader_restarts.increment()
            return False
        return True

    def retire(self, ctx: ThreadCtx, off: int) -> None:
        """Limbo the node; a full limbo list triggers warn-then-free."""
        self.stats.nodes_retired.increment()
        ctx.limbo.append(off)
        if len(ctx.limbo) >= self.limbo_threshold:
            self._reclaim(ctx)

    def _reclaim(self, ctx: ThreadCtx) -> None:
        for t in self._threads:
            t.warning.store(True)
        memory_barrier()
        self.stats.memory_barriers.increment()
        self.stats.warnings_fired.increment()
        self._scan_and_free(ctx)

    def flush(self, ctx: ThreadCtx) -> None:
        """Reclaim everything limboed by this ctx (teardown/accounting)."""
        if ctx.limbo:
            self._reclaim(ctx)


class OAVer(ReclaimerBase):
    """Paper Alg. 2 — simplified OA with a global monotonic clock (VBR-style
    warning channel); piggy-backs on other threads' warnings."""

    name = "OA-VER"
    uses_palloc = True

    def __init__(self, alloc: LRMalloc, limbo_threshold: int = 64):
        super().__init__(alloc, limbo_threshold)
        self.global_clock = AtomicRef(0)

    def alloc_node(self, ctx: ThreadCtx, nbytes: int) -> int:
        """palloc: the node's range stays readable after reclamation."""
        return self.alloc.palloc(nbytes)

    def start_op(self, ctx: ThreadCtx) -> None:
        """Snapshot the global clock as this op's LocalClock (Alg. 2)."""
        ctx.local_clock = self.global_clock.load()

    def check(self, ctx: ThreadCtx) -> bool:
        """Clock moved since start_op? -> reads may be stale, restart."""
        g = self.global_clock.load()
        if g != ctx.local_clock:
            ctx.local_clock = g
            self.stats.reader_restarts.increment()
            return False
        return True

    def retire(self, ctx: ThreadCtx, off: int) -> None:
        """Alg. 2 retire: bump-or-piggyback the clock, then scan-and-free."""
        # Alg. 2, verbatim structure.
        self.stats.nodes_retired.increment()
        if len(ctx.limbo) >= self.limbo_threshold:
            if ctx.last_retire_time == ctx.local_clock:
                if self.global_clock.cas(ctx.local_clock, ctx.local_clock + 1):
                    self.stats.warnings_fired.increment()
                else:
                    # a failed CAS means someone else fired the warning for us
                    self.stats.warnings_piggybacked.increment()
                ctx.local_clock = self.global_clock.load()
        if ctx.last_retire_time < ctx.local_clock and len(ctx.limbo) >= self.limbo_threshold:
            memory_barrier()
            self.stats.memory_barriers.increment()
            self._scan_and_free(ctx)
        ctx.last_retire_time = ctx.local_clock
        ctx.limbo.append(off)

    def flush(self, ctx: ThreadCtx) -> None:
        """Drain this ctx's limbo (hazard-protected nodes may remain)."""
        while ctx.limbo:
            before = len(ctx.limbo)
            self.global_clock.cas(ctx.local_clock, ctx.local_clock + 1)
            ctx.local_clock = self.global_clock.load()
            memory_barrier()
            self._scan_and_free(ctx)
            if len(ctx.limbo) == before:  # everything left is hazard-protected
                break


class OA(ReclaimerBase):
    """The original Optimistic Access method (paper §2.4) — the baseline.

    A closed, fixed-size pool of nodes recycled in phases; memory is never
    returned to the allocator/OS (that is the drawback the paper removes).
    The pool is built with regular ``malloc`` before the workload starts,
    exactly as the paper benchmarks it.
    """

    name = "OA"
    uses_palloc = False

    def __init__(self, alloc: LRMalloc, limbo_threshold: int = 64,
                 pool_size: int = 0, node_size: int = 16):
        super().__init__(alloc, limbo_threshold)
        self.node_size = node_size
        self._ready: deque[int] = deque()
        self._retired: list[int] = []
        self._processing: list[int] = []
        self._pool_lock = threading.Lock()  # emulates lock-free pool CAS + helping
        for _ in range(pool_size):
            self._ready.append(alloc.malloc(node_size))
        self.pool_size = pool_size

    def grow_pool(self, n: int) -> None:
        """Pre-size the closed pool (the knob the paper's OA requires)."""
        with self._pool_lock:
            for _ in range(n):
                self._ready.append(self.alloc.malloc(self.node_size))
            self.pool_size += n

    def alloc_node(self, ctx: ThreadCtx, nbytes: int) -> int:
        """Pop from the ready pool; exhaustion forces a recycling phase."""
        assert nbytes <= self.node_size
        while True:
            with self._pool_lock:
                if self._ready:
                    return self._ready.popleft()
            # ready pool exhausted -> a recycling phase is triggered (§2.4);
            # threads arriving here concurrently help finish the phase.
            if not self._recycling_phase():
                raise MemoryError(
                    "OA pool exhausted and no node is reclaimable "
                    f"(pool_size={self.pool_size})"
                )

    def cancel_node(self, ctx: ThreadCtx, off: int) -> None:
        """Return a never-published node straight to the ready pool."""
        with self._pool_lock:
            self._ready.append(off)

    def check(self, ctx: ThreadCtx) -> bool:
        """Consume this thread's warning bit; False = restart the op."""
        if ctx.warning.load():
            ctx.warning.store(False)
            self.stats.reader_restarts.increment()
            return False
        return True

    def retire(self, ctx: ThreadCtx, off: int) -> None:
        """Park the node in the retired list for the next recycling phase."""
        self.stats.nodes_retired.increment()
        with self._pool_lock:
            self._retired.append(off)

    def _recycling_phase(self) -> bool:
        """Move retire->processing, warn everyone, HP-scan, unprotected->ready.
        Returns True if any node became ready."""
        self.stats.recycling_phases.increment()
        with self._pool_lock:
            self._processing, self._retired = self._retired, []
        for t in self._threads:
            t.warning.store(True)
        memory_barrier()
        self.stats.memory_barriers.increment()
        self.stats.warnings_fired.increment()
        hps = set()
        for t in self._threads:
            for h in t.hazards:
                hps.add(h.load())
        made_ready = 0
        with self._pool_lock:
            for m in self._processing:
                if m in hps:
                    self._retired.append(m)
                else:
                    self._ready.append(m)
                    made_ready += 1
                    self.stats.nodes_freed.increment()  # "freed" = recycled
            self._processing = []
        return made_ready > 0


RECLAIMERS = {"NR": NR, "OA": OA, "OA-BIT": OABit, "OA-VER": OAVer}

"""Lock-free data structures used by the paper's evaluation (§5.1).

- Harris-Michael lock-free linked list (sorted set, marked-pointer deletion)
- Michael lock-free hash table (one Harris-Michael list per bucket)

Nodes live *in arena memory* — layout ``[key:u64][next:u64]`` (16 bytes, the
smallest size class); the low bit of ``next`` is the deletion mark.  All node
access goes through the allocator's arena so that reclamation behavior
(zeroed pages after MADV_DONTNEED, shared-frame reads after remap, reuse by
other allocations) manifests exactly as it would in the C implementation.

Traversals follow the OA discipline: read optimistically, call
``reclaimer.check`` *before* dereferencing anything derived from the read,
restart from a known-valid root on warning.  CAS writes follow the OA write
protocol: hazard-protect every involved node, one ``validate`` (single
barrier for the whole set), then CAS.

Offsets read from possibly-reclaimed memory are bounds-checked before being
dereferenced; in the C world this safety comes from ranges staying mapped —
here a garbage offset could index outside the arena, which would be a crash,
not a benign optimistic read, so the check stands in for "the range is
always dereferenceable".
"""

from __future__ import annotations

from .reclaim import ReclaimerBase, ThreadCtx

NODE_SIZE = 16
_MARK = 1
_PTR = ~1 & (2**64 - 1)


class HarrisMichaelList:
    """Sorted lock-free set of u64 keys, parameterized by a Reclaimer."""

    def __init__(self, reclaimer: ReclaimerBase, head_off: int | None = None):
        self.rec = reclaimer
        self.alloc = reclaimer.alloc
        if head_off is None:
            head_off = self.alloc.malloc(NODE_SIZE)  # sentinel, never retired
        self.head = head_off
        self.alloc.write_u64(self.head, 0)
        self.alloc.write_u64(self.head + 8, 0)

    # -- helpers -----------------------------------------------------------------

    def _valid(self, off: int) -> bool:
        return 0 < off < self.alloc.arena.total and off % NODE_SIZE == 0

    # -- core find (Michael 2002), OA-style -----------------------------------------

    def _find(self, key: int, ctx: ThreadCtx):
        """Returns (prev, cur, found, nxt).  cur == 0 means end of list."""
        rec, alloc = self.rec, self.alloc
        while True:
            rec.start_op(ctx)
            prev = self.head
            cur = alloc.read_u64(prev + 8) & _PTR
            if not rec.check(ctx):
                continue
            restart = False
            while True:
                if cur == 0:
                    return prev, 0, False, 0
                if not self._valid(cur):
                    restart = True  # stale read; warning is pending
                    break
                ckey = alloc.read_u64(cur)
                craw = alloc.read_u64(cur + 8)
                if not rec.check(ctx):
                    restart = True
                    break
                nxt, marked = craw & _PTR, craw & _MARK
                if marked:
                    # physically unlink cur (OA write protocol)
                    rec.protect(ctx, 0, prev)
                    rec.protect(ctx, 1, cur)
                    rec.protect(ctx, 2, nxt)
                    ok = rec.validate(ctx)
                    if ok:
                        ok = alloc.cas_u64(prev + 8, cur, nxt)
                    rec.clear_hazards(ctx)
                    if not ok:
                        restart = True
                        break
                    rec.retire(ctx, cur)
                    cur = nxt
                    continue
                if ckey >= key:
                    return prev, cur, ckey == key, nxt
                prev, cur = cur, nxt
            if restart:
                continue

    # -- set operations -----------------------------------------------------------

    def insert(self, key: int, ctx: ThreadCtx) -> bool:
        """Insert ``key``; False if already present (Michael's algorithm)."""
        rec, alloc = self.rec, self.alloc
        node = rec.alloc_node(ctx, NODE_SIZE)
        alloc.write_u64(node, key)
        while True:
            prev, cur, found, _ = self._find(key, ctx)
            if found:
                rec.cancel_node(ctx, node)
                return False
            alloc.write_u64(node + 8, cur)
            rec.protect(ctx, 0, prev)
            rec.protect(ctx, 1, node)
            ok = rec.validate(ctx)
            if ok:
                ok = alloc.cas_u64(prev + 8, cur, node)
            rec.clear_hazards(ctx)
            if ok:
                return True

    def delete(self, key: int, ctx: ThreadCtx) -> bool:
        """Logically mark then unlink ``key``; the node is RETIRED, not freed
        — the reclaimer decides when memory is safe to reuse."""
        rec, alloc = self.rec, self.alloc
        while True:
            prev, cur, found, nxt = self._find(key, ctx)
            if not found:
                return False
            rec.protect(ctx, 0, prev)
            rec.protect(ctx, 1, cur)
            ok = rec.validate(ctx)
            if ok:
                ok = alloc.cas_u64(cur + 8, nxt, nxt | _MARK)  # logical delete
            if not ok:
                rec.clear_hazards(ctx)
                continue
            if alloc.cas_u64(prev + 8, cur, nxt):  # physical unlink
                rec.retire(ctx, cur)
            # else: some later _find will unlink and retire it
            rec.clear_hazards(ctx)
            return True

    def contains(self, key: int, ctx: ThreadCtx) -> bool:
        """Read-only traversal: pure optimistic reads, no unlinking."""
        rec, alloc = self.rec, self.alloc
        while True:
            rec.start_op(ctx)
            cur = alloc.read_u64(self.head + 8) & _PTR
            if not rec.check(ctx):
                continue
            restart = False
            while True:
                if cur == 0:
                    return False
                if not self._valid(cur):
                    restart = True
                    break
                ckey = alloc.read_u64(cur)
                craw = alloc.read_u64(cur + 8)
                if not rec.check(ctx):
                    restart = True
                    break
                if ckey >= key:
                    return ckey == key and not (craw & _MARK)
                cur = craw & _PTR
            if restart:
                continue

    # -- test/teardown helpers -------------------------------------------------------

    def keys(self, ctx: ThreadCtx) -> list[int]:
        """Quiescent snapshot (single-threaded use only)."""
        out = []
        cur = self.alloc.read_u64(self.head + 8) & _PTR
        while cur:
            raw = self.alloc.read_u64(cur + 8)
            if not raw & _MARK:
                out.append(self.alloc.read_u64(cur))
            cur = raw & _PTR
        return out


class MichaelHashTable:
    """Michael's lock-free hash table: an array of Harris-Michael buckets."""

    _GOLD = 2654435761  # Knuth multiplicative hash

    def __init__(self, reclaimer: ReclaimerBase, nbuckets: int):
        self.rec = reclaimer
        self.nbuckets = nbuckets
        self.buckets = [HarrisMichaelList(reclaimer) for _ in range(nbuckets)]

    def _bucket(self, key: int) -> HarrisMichaelList:
        return self.buckets[(key * self._GOLD) % self.nbuckets]

    def insert(self, key: int, ctx: ThreadCtx) -> bool:
        """Insert into the key's bucket list; False if present."""
        return self._bucket(key).insert(key, ctx)

    def delete(self, key: int, ctx: ThreadCtx) -> bool:
        """Delete from the key's bucket list; False if absent."""
        return self._bucket(key).delete(key, ctx)

    def contains(self, key: int, ctx: ThreadCtx) -> bool:
        """Membership test via an optimistic traversal of the bucket."""
        return self._bucket(key).contains(key, ctx)

    def size(self, ctx: ThreadCtx) -> int:
        """Total keys across buckets (O(n); test/debug helper)."""
        return sum(len(b.keys(ctx)) for b in self.buckets)

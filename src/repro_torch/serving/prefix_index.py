"""The prefix index with its eviction order kept as entries change.

:class:`repro_torch.serving.scheduler.PrefixIndex` (a drift-checked copy
of the reference's) rebuilds its order on every sweep: a child count over
every index key, then a sort of all tails and all keys by length — work
in the whole index times its keys' length, to evict the few entries one
finish leaves over the cap.  :class:`OrderedPrefixIndex` evicts the same
entries in the same order, with the same return value, statistics and
one batched unshare, but keeps that order as the index changes.

The order is a total one: tails before index keys, longer keys first,
and among keys of one kind and length the dictionary's insertion order
(the reference's stable sorts).  A sweep evicts, in that order, each
entry that is a leaf when it is reached — a tail always; an index key
with no longer key under it and no tail at it — unless ``freeable_only``
holds and a running slot shares its page.  An eviction only ever makes a
later entry a leaf (a tail's own key, the shorter parent of a key), so a
heap of the current leaves, keyed ``(kind, -len(key), rank)``, yields
exactly the entries the reference's sweep evicts.

The heap is kept up to date by the index's two dictionaries, which report
each key they gain or lose (:class:`_Entries`); a key that stops being a
leaf keeps its entry, which is dropped when it is popped and pushed anew
when the key is a leaf again.  Each key has at most one entry that counts
(:attr:`OrderedPrefixIndex._keys`); an entry whose rank is no longer its
key's (the key left, or left and came back) is stale, and skipped.  A
sweep costs O((evicted + pinned + stale) · log N) heap operations.
"""

from __future__ import annotations

import itertools
from heapq import heappop, heappush

from .scheduler import PrefixIndex

TAIL, PAGE = 0, 1  # the kinds, in eviction order


class _Entries(dict):
    """One of the index's dictionaries (``tail`` or ``index``), telling
    its index of every key it gains or loses."""

    def __init__(self, owner: "OrderedPrefixIndex", kind: int):
        super().__init__()
        self._owner, self._kind = owner, kind

    def __setitem__(self, key, value):
        n = len(self)
        super().__setitem__(key, value)
        if len(self) > n:
            self._owner._added(self._kind, key)

    def __delitem__(self, key):
        super().__delitem__(key)
        self._owner._removed(self._kind, key)

    def pop(self, key, *default):
        n = len(self)
        value = super().pop(key, *default)
        if len(self) < n:
            self._owner._removed(self._kind, key)
        return value

    def _refused(self, *args, **kw):
        raise TypeError("the prefix index's dictionaries change only by "
                        "item assignment, del and pop")

    popitem = setdefault = update = clear = __ior__ = _refused


class OrderedPrefixIndex(PrefixIndex):
    """:class:`PrefixIndex` whose sweep pops its candidates from a heap of
    the current leaves instead of re-deriving the order (module
    docstring).  ``index``, ``tail`` and ``pages`` read as before;
    ``pages`` is still the dictionary the manager bound."""

    def __init__(self, page_size: int, cap: int, kvm, stats):
        super().__init__(page_size, cap, kvm, stats)
        self.index = _Entries(self, PAGE)
        self.tail = _Entries(self, TAIL)
        self._ranks = itertools.count()
        #: kind -> {key: [insertion rank, whether its heap entry counts]}
        #: for the keys present
        self._keys: tuple[dict, dict] = ({}, {})
        #: index keys one page longer under each key, present or not
        self._children: dict[tuple, int] = {}
        self._heap: list[tuple] = []
        #: candidates the last sweep popped, stale and pinned ones included
        self.examined = 0

    def _is_leaf(self, key: tuple) -> bool:
        """Whether index key ``key`` may go: nothing longer hangs on it."""
        return not self._children.get(key) and key not in self.tail

    def _push(self, kind: int, key: tuple, state: list) -> None:
        if not state[1]:
            state[1] = True
            heappush(self._heap, (kind, -len(key), state[0], key))

    def _added(self, kind: int, key: tuple) -> None:
        state = self._keys[kind][key] = [next(self._ranks), False]
        if kind == PAGE:
            if len(key) > self.page_size:
                parent = key[: len(key) - self.page_size]
                self._children[parent] = self._children.get(parent, 0) + 1
            if not self._is_leaf(key):
                return
        # a tail is always a leaf; index key ``key`` no longer is (seen
        # when its entry is popped)
        self._push(kind, key, state)

    def _removed(self, kind: int, key: tuple) -> None:
        del self._keys[kind][key]  # its entry, if any, is stale
        if kind == TAIL:
            self._maybe_leaf(key)
        elif len(key) > self.page_size:
            parent = key[: len(key) - self.page_size]
            left = self._children[parent] - 1
            if left:
                self._children[parent] = left
            else:
                del self._children[parent]
                self._maybe_leaf(parent)

    def _maybe_leaf(self, key: tuple) -> None:
        """Queue index key ``key``, if present, once it is a leaf."""
        state = self._keys[PAGE].get(key)
        if state is not None and self._is_leaf(key):
            self._push(PAGE, key, state)

    def evict(self, need_pages: int | None = None,
              freeable_only: bool = True) -> int:
        """The reference's sweep (``PrefixIndex.evict``), leaf by leaf
        from the heap: the same entries in the same order, the same
        ``freed``, one batched unshare at the end."""
        kvm, heap = self.kvm, self._heap
        to_unshare: list[int] = []
        pinned: list[tuple] = []
        freed = examined = 0
        while heap:
            if need_pages is not None and freed >= need_pages:
                break
            if need_pages is None and len(self.pages) <= self.cap:
                break
            entry = heappop(heap)
            examined += 1
            kind, _, rank, key = entry
            state = self._keys[kind].get(key)
            if state is None or state[0] != rank:
                continue  # stale: the key left since it was pushed
            if kind == PAGE and not self._is_leaf(key):
                state[1] = False  # pushed again once it is a leaf
                continue
            entries = self.tail if kind == TAIL else self.index
            page = entries[key][0] if kind == TAIL else entries[key]
            if freeable_only and kvm.sharer_count(page) > 0:
                pinned.append(entry)  # a leaf still, for a later sweep
                continue
            entries.pop(key)
            self.pages.pop(page, None)
            to_unshare.append(page)
            if kvm.sharer_count(page) == 0:
                freed += 1
            self.stats.record_eviction()
        for entry in pinned:  # still the entry that counts for its key
            heappush(heap, entry)
        self.examined = examined
        if to_unshare:
            kvm.unshare_batch(to_unshare, freed)
            self.stats.record_cache_pages(len(self.pages))
        return freed

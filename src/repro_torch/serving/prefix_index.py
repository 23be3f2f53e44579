"""The host-side prefix cache: aligned token tuples → resident pages.

Pure-dictionary *policy* (what matches, what a finish donates, what
pressure evicts first); every refcount consequence goes through the
manager (``drop_ref_frees``/``dec_sharer``/``unshare_batch``), which
owns the mirrors.  ``match`` and ``donate`` are the reference's
(``repro.serving.scheduler.PrefixIndex``); ``evict`` evicts the entries
the reference's sweep evicts, in the same order, with the same return
value, statistics and one batched unshare, but keeps that order as the
index changes instead of re-deriving it on every sweep.

The order is a total one: tails before index keys, longer keys first, and
among keys of one kind and length the dictionary's insertion order (the
reference's stable sorts).  A sweep evicts, in that order, each entry that
is a leaf when it is reached — a tail always; an index key with no longer
key under it and no tail at it — unless ``freeable_only`` holds and a
running slot shares its page.  An eviction only ever makes a later entry a
leaf (a tail's own key, the shorter parent of a key), so a heap of the
current leaves, keyed ``(kind, -len(key), rank)``, yields exactly the
entries the reference's sweep evicts.

The dictionaries change at four places — two inserts in :meth:`donate`,
two pops in :meth:`evict` — and each tells the heap
(:meth:`PrefixIndex._added`, :meth:`PrefixIndex._removed`).  Each key
present has at most one entry in the heap (``_keys``), and a key leaves
only when its entry is popped, so no entry outlives its key.  A key that
stops being a leaf keeps its entry, which is dropped when it is popped and
pushed anew when the key is a leaf again.  A sweep costs
O((evicted + pinned + non-leaves) · log N) heap operations.
"""

from __future__ import annotations

import itertools
from heapq import heappop, heappush

TAIL, PAGE = 0, 1  # the kinds, in eviction order


class PrefixIndex:
    """The prefix cache (module docstring).  ``index`` maps an exact token
    tuple (length a multiple of ``page_size``) to the device page holding
    that tuple's LAST page_size tokens; a chain of k pages is recovered by
    looking up the k aligned prefixes.  ``tail`` holds one partially-filled
    page per aligned prefix for sub-page (COW) matching.  The index owns ONE
    reference per page.  Each sweep is a ``prefix.evict`` span of
    ``tracer`` (``repro_torch/spans.py``)."""

    def __init__(self, page_size: int, cap: int, kvm, stats, tracer):
        self.page_size = page_size
        self.cap = cap
        self.kvm = kvm
        self.stats = stats
        self.tracer = tracer
        self.index: dict[tuple, int] = {}
        self.tail: dict[tuple, tuple[int, tuple]] = {}
        self.pages: dict[int, tuple] = {}  # page -> ("page"|"tail", key)
        # the manager's zero-transition predicates read a LIVE view of
        # ``pages`` — one mutation updates policy and mirrors together
        kvm.bind_index(self.pages)
        self._ranks = itertools.count()
        #: kind -> {key: [insertion rank, whether its heap entry counts]}
        #: for the keys present
        self._keys: tuple[dict, dict] = ({}, {})
        #: index keys one page longer under each key, present or not
        self._children: dict[tuple, int] = {}
        self._heap: list[tuple] = []
        #: candidates the last sweep popped, pinned ones included
        self.examined = 0

    def match(self, prompt: list[int]):
        """Longest resident prefix of ``prompt``: ``(m, chain, tail_page)``.

        ``chain`` holds page ids for the first ``m // page_size`` fully
        matched pages; ``tail_page`` (−1 = none) extends the match by
        ``m % page_size`` tokens into a partially matching page (granted
        copy-on-write).  ``m`` caps at ``len(prompt) − 1`` — the last
        prompt token is always recomputed, because its forward pass
        produces the first generated token.  Host dictionary walk only."""
        ps = self.page_size
        chain: list[int] = []
        k = 0
        while (k + 1) * ps <= len(prompt):
            page = self.index.get(tuple(prompt[: (k + 1) * ps]))
            if page is None:
                break
            chain.append(page)
            k += 1
        extra, tail_page = 0, -1
        tail = self.tail.get(tuple(prompt[: k * ps]))
        if tail is not None:
            tp, ttoks = tail
            rest = prompt[k * ps:]
            while (extra < len(ttoks) and extra < len(rest)
                   and ttoks[extra] == rest[extra]):
                extra += 1
            tail_page = tp if extra > 0 else -1
        m = k * ps + extra
        if m >= len(prompt):  # never grant the full prompt (see docstring)
            m = len(prompt) - 1
            k2, extra = divmod(m, ps)
            if k2 < k:
                tail_page = chain[k2] if extra > 0 else -1
                chain = chain[:k2]
            elif extra == 0:
                tail_page = -1
        if m <= 0:
            return 0, [], -1
        return m, chain, (tail_page if m % ps else -1)

    def donate(self, row: list[int], seq: list[int], committed: int,
               shared_ids: set[int]) -> None:
        """Finish-path policy: offer the row's committed pages to the index
        (references TRANSFER — no device op, no version bump) and unshare
        whatever the index does not take, in one batched drop."""
        kvm, ps = self.kvm, self.page_size
        k_full, t_extra = divmod(committed, ps)
        to_unshare: list[int] = []
        freed = 0
        covered = k_full + (1 if t_extra else 0)
        for j in range(covered):
            page = row[j]
            if page < 0:  # defensive: a committed position must be mapped
                continue
            if j < k_full:
                key = tuple(seq[: (j + 1) * ps])
                existing = self.index.get(key)
                if existing == page:
                    # already indexed (shared at admission): drop the slot's
                    # extra reference, the index keeps its own
                    to_unshare.append(page)
                    freed += kvm.drop_ref_frees(page, page in shared_ids)
                elif existing is None and page not in self.pages:
                    self.index[key] = page
                    self._added(PAGE, key)
                    self.pages[page] = ("page", key)
                    if page in shared_ids:
                        kvm.dec_sharer(page)  # sharer ref becomes the
                        # index's ref — refcount unchanged, no device op
                else:
                    # same content already cached under a different page:
                    # keep the cache's copy, drop ours
                    to_unshare.append(page)
                    freed += kvm.drop_ref_frees(page, page in shared_ids)
            else:  # the partially filled tail page (always owned: any shared
                # tail was COW-diverged by this request's first write)
                key = tuple(seq[: k_full * ps])
                ttoks = tuple(seq[k_full * ps: committed])
                if key in self.tail or page in self.pages or not ttoks:
                    to_unshare.append(page)
                    freed += kvm.drop_ref_frees(page, page in shared_ids)
                else:
                    self.tail[key] = (page, ttoks)
                    self._added(TAIL, key)
                    self.pages[page] = ("tail", key)
                    if page in shared_ids:
                        kvm.dec_sharer(page)
        for j in range(covered, len(row)):  # uncommitted growth grants
            if row[j] >= 0:
                to_unshare.append(row[j])
                freed += kvm.drop_ref_frees(row[j], row[j] in shared_ids)
        kvm.unshare_batch(to_unshare, freed)
        self.stats.record_cache_pages(len(self.pages))
        self.enforce_cap()

    def evict(self, need_pages: int | None = None,
              freeable_only: bool = True) -> int:
        """Evict entries leaf-first, popped from the heap of leaves (module
        docstring); returns pages actually FREED.

        ``need_pages``: stop once that many pages freed (None = down to the
        cap).  ``freeable_only``: skip pages still referenced by a running
        slot (dropping the index's reference would free nothing).  One
        batched unshare at the end; the clock mirror ticks once iff any page
        hit zero."""
        kvm, heap = self.kvm, self._heap
        to_unshare: list[int] = []
        pinned: list[tuple] = []
        freed = examined = 0
        with self.tracer.span("prefix.evict") as span:
            while heap:
                if need_pages is not None and freed >= need_pages:
                    break
                if need_pages is None and len(self.pages) <= self.cap:
                    break
                entry = heappop(heap)
                examined += 1
                kind, _, _, key = entry
                if kind == PAGE and not self._is_leaf(key):
                    self._keys[PAGE][key][1] = False  # pushed again once
                    continue  # it is a leaf
                entries = self.tail if kind == TAIL else self.index
                page = entries[key][0] if kind == TAIL else entries[key]
                if freeable_only and kvm.sharer_count(page) > 0:
                    pinned.append(entry)  # a leaf still, for a later sweep
                    continue
                entries.pop(key)
                self._removed(kind, key)
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
            span.set(keys_scanned=examined, entries_evicted=len(to_unshare))
        return freed

    def enforce_cap(self) -> None:
        """Shrink the index back under its page cap (pressure-free path)."""
        if len(self.pages) > self.cap:
            self.evict(need_pages=None, freeable_only=False)

    # -- the heap of leaves --------------------------------------------------

    def _is_leaf(self, key: tuple) -> bool:
        """Whether index key ``key`` may go: nothing longer hangs on it."""
        return not self._children.get(key) and key not in self.tail

    def _push(self, kind: int, key: tuple, state: list) -> None:
        if not state[1]:
            state[1] = True
            heappush(self._heap, (kind, -len(key), state[0], key))

    def _added(self, kind: int, key: tuple) -> None:
        """``key`` has just entered ``index`` (PAGE) or ``tail`` (TAIL)."""
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
        """``key`` has just left ``index`` (PAGE) or ``tail`` (TAIL)."""
        del self._keys[kind][key]
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

"""KVCacheManager: page / refcount / superblock lifecycle for serving.

The port of ``repro.serving.kv_manager``: the same mechanics and mirrors
over the port's tensors.  The per-slot device arrays are updated in place
by plain tensor writes where the reference runs donated jitted installs.

The middle layer of the serving stack (ARCHITECTURE.md):

    Scheduler (policy)  ->  KVCacheManager (mechanics)  ->  Allocator
                             ^ the ONLY layer that talks to the pool

Everything that touches the allocator protocol (``core.allocator``) or the
per-slot device arrays lives here: share/unshare batches with their clock
mirror, slot install/clear/release, the sharer and index-pin refcount
mirrors, physical release (shrink) and remap.  The layer makes NO policy
decisions — *when* to evict, whom to preempt, how big a chunk to run are
the scheduler's; *how* to do each of those without breaking the OA
invariants is this file.  The scheduler drives it with plain host types
(ints, lists, bools) so the cross-layer contract tests can substitute a
pure-host fake allocator (``tests/test_layering.py``).

Mirror discipline (the exactness contract): ``stats.warnings_fired`` is the
host mirror of the device pool's reclamation clock.  Every method here that
can cause a zero-transition free ticks it exactly once per device batch
that actually freed something — matching ``unshare_pages``' once-per-batch
rule — so ``warnings_fired == pool.clock`` holds after any interleaving
(tested per workload in the engine suites).

Under the interval reclamation policy (``core/reclaim_policy.py``) the
allocator this layer holds is an ``IntervalAllocator`` that DEFERS
``free``/``unshare`` batches: the mirror still ticks here at call time
while the device clock ticks when the batch matures, so the exactness
contract is asserted at quiescent points (after the engine's drain-time
``flush``) rather than mid-flight — each deferred batch corresponds 1:1 to
one eventual device batch, which is what keeps the equality exact at every
flushed point (``tests/test_reclaim_diff.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.allocator import Allocator
from repro_torch.device import resolve_device
from .stats import EngineStats


class DeviceStepState(NamedTuple):
    """The persistent device-resident batch state, bundled for the runner.

    The runner treats every field as opaque (it forwards ``pool`` into the
    fused step without looking inside — the layering contract); the manager
    owns the fields' meaning: ``kv`` is the paged KV arena, ``pool`` the
    allocator's PagePool, the rest the per-slot arrays documented on
    ``fused_decode_step``."""

    kv: dict
    pool: object
    block_tables: torch.Tensor
    snapshot: torch.Tensor
    lengths: torch.Tensor
    last_tok: torch.Tensor
    active: torch.Tensor
    prompt_buf: torch.Tensor
    prompt_len: torch.Tensor


class KVCacheManager:
    """Page lifecycle mechanics behind the scheduler (module docstring)."""

    def __init__(self, allocator: Allocator, *, kv, max_batch: int,
                 max_pages_per_seq: int, page_size: int, stats: EngineStats,
                 device=None):
        self.allocator = allocator
        self.kv = kv
        self.stats = stats
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        self.device = resolve_device(device)
        B, M = max_batch, max_pages_per_seq
        dev = self.device
        self._bt = torch.full((B, M), -1, dtype=torch.int32, device=dev)
        self._snap = torch.zeros((B, M), dtype=torch.int64, device=dev)
        self._len = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._last = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._prompt_cap = 16
        self._pbuf = torch.zeros((B, self._prompt_cap), dtype=torch.int32,
                                 device=dev)
        self._plen = torch.zeros((B,), dtype=torch.int32, device=dev)
        #: slot index -> the request object occupying it (None = free)
        self.slots: list = [None] * B
        #: page -> live slot references beyond the allocator's own refcount
        self.sharers: dict[int, int] = {}
        #: pages the prefix index holds a reference on — a LIVE view of the
        #: scheduler's page->entry dict (bound via :meth:`bind_index`), so
        #: the zero-transition predicates can never drift from the index
        self.index_pages = {}.keys()

    # -- step-state plumbing (the runner's side of the contract) -------------

    def step_state(self) -> DeviceStepState:
        """Bundle the device-resident batch state for one fused dispatch."""
        return DeviceStepState(self.kv, self.allocator.state, self._bt,
                               self._snap, self._len, self._last,
                               self._active, self._pbuf, self._plen)

    def install_state(self, st: DeviceStepState) -> None:
        """Thread the (in-place updated, possibly still in-flight) state
        back in."""
        self.kv = st.kv
        self.allocator.state = st.pool
        (self._bt, self._snap, self._len, self._last) = (
            st.block_tables, st.snapshot, st.lengths, st.last_tok)

    # -- slot lifecycle (allowed sync points only) ---------------------------

    def free_slot_index(self) -> int:
        """Lowest unoccupied slot (caller checks occupancy beforehand)."""
        return self.slots.index(None)

    def row_pages(self, slot: int) -> list[int]:
        """The slot's mapped page ids, materialised to host ints (finish /
        donation are allowed sync points)."""
        return self._bt[slot].tolist()

    def _ensure_prompt_cap(self, n: int) -> None:
        if n <= self._prompt_cap:
            return
        cap = self._prompt_cap
        while cap < n:
            cap *= 2
        self._pbuf = torch.nn.functional.pad(
            self._pbuf, (0, cap - self._prompt_cap))
        self._prompt_cap = cap

    def install_slot(self, slot: int, row: list[int], start_len: int,
                     prompt: list[int]) -> None:
        """Install ``row`` (page ids, −1 padding to the block-table width)
        into ``slot`` and snapshot the CURRENT version of every mapped page
        through the allocator protocol — the OA baseline."""
        self._ensure_prompt_cap(len(prompt))
        prow = np.zeros((self._prompt_cap,), np.int32)
        prow[: len(prompt)] = prompt
        bt_row = np.full((self.max_pages_per_seq,), -1, np.int32)
        bt_row[: len(row)] = row
        row_t = torch.as_tensor(bt_row, device=self.device)
        vers = self.allocator.snapshot(row_t).to(torch.int64)
        self._bt[slot] = row_t
        self._snap[slot] = torch.where(row_t >= 0, vers, 0)
        self._len[slot] = start_len
        self._last[slot] = 0
        self._active[slot] = True
        self._pbuf[slot] = torch.as_tensor(prow, device=self.device)
        self._plen[slot] = len(prompt)

    def clear_slot(self, slot: int) -> None:
        """Vacate a slot without freeing its pages (the caller freed them
        already, or a racing reclaimer owns them)."""
        self._bt[slot] = -1
        self._snap[slot] = 0
        self._len[slot] = 0
        self._last[slot] = 0
        self._active[slot] = False
        self.slots[slot] = None

    def release_slot(self, slot: int) -> None:
        """OPTIMISTIC release of a whole row: one reference dropped per
        mapped page (owned pages free with a version bump; shared ones just
        lose this holder), then the slot is cleared.  The caller accounts
        the mirror via :meth:`release_mirror`.  The row is handed over as a
        copy: a deferring allocator must not see the cleared slot."""
        self.allocator.free(self._bt[slot].clone())
        self.clear_slot(slot)

    def free_row(self, slot: int) -> None:
        """Free a row's page references WITHOUT clearing the slot (the
        external-reclaimer race hook: the scheduler still believes the slot
        runs, which is the point of the OA race test)."""
        self.allocator.free(self._bt[slot].clone())

    def free_row_tail(self, slot: int, start: int) -> None:
        """Free only the row's pages at block-table positions >= ``start``
        (grants landed after a racing reclaim's watermark)."""
        self.allocator.free(self._bt[slot, start:].clone())

    # -- refcount mirrors ----------------------------------------------------

    def sharer_count(self, page: int) -> int:
        """Live slot references on ``page`` (beyond the index's own)."""
        return self.sharers.get(page, 0)

    def inc_sharer(self, page: int) -> None:
        """A slot took a shared reference on ``page``."""
        self.sharers[page] = self.sharers.get(page, 0) + 1

    def dec_sharer(self, page: int) -> None:
        """A slot dropped its shared reference on ``page``."""
        c = self.sharers.get(page, 0)
        if c <= 1:
            self.sharers.pop(page, None)
        else:
            self.sharers[page] = c - 1

    def bind_index(self, pages: dict) -> None:
        """Adopt the prefix index's page->entry dict as the single source
        of index-held pages: the mirrors read a live key view of it, so a
        donate or evict updates both layers in one mutation (no shadow set
        to keep in lockstep)."""
        self.index_pages = pages.keys()

    def shared_distinct(self) -> int:
        """Distinct pages held shared (slots' shares ∪ the index) — each
        counted ONCE, the way release floors and admission guards bill."""
        return len(self.index_pages | set(self.sharers))

    def drop_ref_frees(self, page: int, was_shared: bool) -> bool:
        """Account one reference drop on ``page`` in the mirrors; True iff
        that drop is the zero-transition (the page actually frees)."""
        if was_shared:
            frees = (self.sharer_count(page) == 1
                     and page not in self.index_pages)
            self.dec_sharer(page)
            return frees
        return page not in self.index_pages  # owned: refcount 1 -> 0

    def release_mirror(self, shared_pages: list[int], owned: int) -> None:
        """Host mirror of a whole-row unshare (:meth:`release_slot`): owned
        pages hit zero, shared pages lose this holder — freeing only if it
        was the last AND the index holds no reference.  Ticks the clock
        mirror iff SOME page hit zero, exactly the device's rule."""
        freed_shared = sum(
            1 for p in shared_pages
            if self.sharers.get(p, 0) == 1 and p not in self.index_pages)
        if owned > 0 or freed_shared:
            self.stats.record_warning()
        for p in shared_pages:
            self.dec_sharer(p)
        self.stats.record_reclaimed(owned + freed_shared)

    # -- share / unshare / alloc mechanics -----------------------------------

    def share(self, pages: list[int]) -> None:
        """Grant slot references on resident ``pages`` (refcount += 1, no
        version moves).  A False from the allocator means the host index
        named a FREE page — an index/pool desync that must fail loudly here,
        not surface later as two requests corrupting one KV page."""
        ok = self.allocator.share(pages)
        assert ok, (
            f"prefix index named free page(s) among {pages} — host cache "
            f"mirrors diverged from the allocator")
        for p in pages:
            self.inc_sharer(p)

    def unshare_batch(self, pages: list[int], freed: int) -> None:
        """Drop one reference per page in ONE allocator batch; ``freed`` is
        the caller-computed zero-transition count (mirror predicates), which
        ticks the clock mirror once iff positive — the device's rule."""
        if not pages:
            return
        self.allocator.unshare(pages)
        if freed:
            self.stats.record_warning()
        self.stats.record_reclaimed(freed)

    def alloc_fresh(self) -> int | None:
        """One fresh page at refcount 1, or None when the pool is dry (the
        scheduler then remaps / evicts / preempts and retries)."""
        pages, ok = self.allocator.alloc(1)
        return pages[0] if ok else None

    # -- physical release / remap (paper §3.2) -------------------------------

    @property
    def mapped_pages(self) -> int:
        """Current allocatable capacity (free + held), from the anchors."""
        return self.allocator.view().pages_mapped

    def shrink(self, keep_superblocks: int) -> int:
        """Release every EMPTY superblock above the floor; a release batch
        bumps released versions and ticks the clock once (OA warning for
        in-flight readers of the range).  Returns superblocks released."""
        got_sb, _ = self.allocator.release(keep_superblocks)
        if got_sb > 0:
            self.stats.record_warning()
            self.stats.record_superblocks(self.allocator.view())
        return got_sb

    def remap_for(self, need_pages: int) -> bool:
        """Bring released superblocks back to cover ``need_pages`` more
        pages; True if any superblock was remapped.  Preferred over
        preemption: remapping costs no running request anything."""
        view = self.allocator.view()
        if need_pages <= 0 or view.superblocks_mapped >= view.superblocks_total:
            return False
        want = -(-need_pages // view.pages_per_superblock)
        got_sb, _ = self.allocator.map(want)
        if got_sb > 0:
            self.stats.record_superblocks(self.allocator.view())
        return got_sb > 0

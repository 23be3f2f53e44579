"""Device-side paged KV-cache pool with Optimistic-Access semantics (PyTorch).

The port of ``repro.core.pagepool``: the same superblock-structured,
refcounted, versioned page pool, as plain functions on tensors.

- Pages are grouped into superblocks, each with a LIFO free list and an
  anchor (free count + mapped bit).  Allocation prefers PARTIAL
  superblocks, fullest first, then EMPTY ones; UNMAPPED (released)
  superblocks never serve grants.
- Every page carries a version and a refcount; the pool a clock.  Only the
  refcount ZERO-transition (or a superblock release) bumps a version and
  ticks the clock — the OA warning an optimistic reader validates against.

Two representation choices differ from the JAX pytree:

- ``page_version`` and ``clock`` are uint32 in the reference.  PyTorch's
  uint32 lacks ``add``/``index_add_``/``index_put_``, so they are int64
  here, masked with ``& 0xFFFFFFFF`` on every bump: the same values as the
  reference's wrapping uint32 arithmetic.
- jnp's out-of-bounds-dropping scatter (``mode="drop"``) has no torch
  counterpart.  Every such scatter here writes into a copy padded by one
  sentinel row or column, which is then sliced away; an index is never
  clamped onto a real slot, where it could collide with a valid write.

Every ``_*_impl`` is functional (returns a new :class:`PagePool`) and makes
no host sync: boolean-mask indexing, ``nonzero`` and ``.item()`` are absent,
so the fused serving step can inline them and keep its one transfer.  The
public functions (``alloc_pages_batch`` ... ``validate_read``, and the
arena's ``kv_pages_init``/``append_kv``/``gather_kv``) are the reference's
names, argument orders and return tuples over the same bodies.  The
reference donates its pool to each jitted call; here each returns a new
:class:`PagePool` and leaves its argument as it was.  Where the reference
takes a dynamic scalar (``max_release``, ``keep_mapped``, ``n`` of
``map_superblocks``) an int or a 0-dim tensor does; ``n`` of
``alloc_pages`` and ``max_grow`` are static there and ints here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import host_list, resolve_device
from .allocator import AllocatorView
from .vm import ReleaseStrategy

__all__ = [
    "PagePool", "DevicePagePool", "ReleaseStrategy", "pool_init",
    "SB_FULL", "SB_PARTIAL", "SB_EMPTY", "SB_UNMAPPED", "superblock_states",
    "alloc_pages", "alloc_pages_batch", "free_pages",
    "share_pages", "unshare_pages",
    "release_empty_superblocks", "map_superblocks",
    "snapshot_versions", "validate_and_commit", "validate_read",
    "kv_pages_init", "append_kv", "gather_kv",
]

#: default superblock granularity (pages); ``pool_init`` clamps to the pool
DEFAULT_PAGES_PER_SUPERBLOCK = 8

# superblock states (LRMalloc Fig. 2 plus the released state of §3.2)
SB_FULL, SB_PARTIAL, SB_EMPTY, SB_UNMAPPED = 0, 1, 2, 3

#: the reference keeps versions and the clock in uint32
U32 = 0xFFFFFFFF


class PagePool(NamedTuple):
    """Device-side page pool state (see module docstring).

    ``page_version`` only moves when a page is reclaimed (refcount
    zero-transition, or superblock release) — never on alloc or share.
    """

    sb_pages: torch.Tensor  # [S, K] int32 per-superblock LIFO free lists
    sb_free: torch.Tensor  # [S] int32 anchor: free pages per superblock
    sb_mapped: torch.Tensor  # [S] bool anchor: in circulation?
    page_version: torch.Tensor  # [num_pages] int64 holding uint32 values
    page_refcount: torch.Tensor  # [num_pages] int32 — owners (0 = free)
    clock: torch.Tensor  # [] int64 holding a uint32 — reclamation clock

    @property
    def num_pages(self) -> int:
        """Total pages in the arena (constant)."""
        return self.page_version.shape[0]

    @property
    def num_superblocks(self) -> int:
        """Superblock count S (the last one may be ragged)."""
        return self.sb_pages.shape[0]

    @property
    def pages_per_superblock(self) -> int:
        """Superblock granularity K (pages per LIFO free list)."""
        return self.sb_pages.shape[1]

    @property
    def free_top(self) -> torch.Tensor:
        """Total allocatable pages (mapped superblocks only)."""
        return _free_total(self)


def _arange(n: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=ref.device)


def _capacities(pool: PagePool) -> torch.Tensor:
    """Per-superblock page capacity [S] int64 (the last may be ragged)."""
    S, K = pool.sb_pages.shape
    return torch.clamp(pool.num_pages - _arange(S, pool.sb_pages) * K, max=K)


def _free_total(pool: PagePool) -> torch.Tensor:
    return torch.where(pool.sb_mapped, pool.sb_free, 0).sum().to(torch.int32)


def _drop_scatter_fill(dst: torch.Tensor, idx: torch.Tensor,
                       keep: torch.Tensor, val: int) -> torch.Tensor:
    """``dst.at[idx].set(val, mode="drop")`` on a 1-D tensor: entries with
    ``keep`` False (or an index outside ``dst``) land on a sentinel slot.
    ``index_fill_`` passes the scalar to the kernel; an indexed assignment
    of a Python scalar would first copy it to the device and synchronise."""
    n = dst.shape[0]
    ok = keep & (idx >= 0) & (idx < n)
    pad = torch.cat([dst, dst.new_zeros(1)])
    pad.index_fill_(0, torch.where(ok, idx, n), val)
    return pad[:n]


def _drop_scatter_add(dst: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].add(val, mode="drop")`` on a 1-D tensor."""
    n = dst.shape[0]
    ok = keep & (idx >= 0) & (idx < n)
    pad = torch.cat([dst, dst.new_zeros(1)])
    pad.index_add_(0, torch.where(ok, idx, n), val.to(dst.dtype))
    return pad[:n]


def _ids(pool: PagePool, x) -> torch.Tensor:
    """Page ids or needs (a tensor or a host sequence) on the pool's
    device; a tensor already there is passed through untouched."""
    return torch.as_tensor(x, device=pool.sb_free.device)


def _scalar(pool: PagePool, x):
    """A dynamic scalar: an int stays an int, a 0-dim tensor moves to the
    pool's device (no copy when it is already there)."""
    return x.to(pool.sb_free.device) if isinstance(x, torch.Tensor) else x


def superblock_states(pool: PagePool) -> torch.Tensor:
    """[S] int32 anchor states: SB_FULL/SB_PARTIAL/SB_EMPTY/SB_UNMAPPED."""
    cap = _capacities(pool)
    st = torch.where(pool.sb_free == 0, SB_FULL,
                     torch.where(pool.sb_free >= cap, SB_EMPTY, SB_PARTIAL))
    return torch.where(pool.sb_mapped, st, SB_UNMAPPED).to(torch.int32)


def pool_init(num_pages: int,
              pages_per_superblock: int = DEFAULT_PAGES_PER_SUPERBLOCK,
              device=None) -> PagePool:
    """Build a fully-mapped pool: every page free (refcount 0), version 0."""
    dev = resolve_device(device)
    K = max(1, min(pages_per_superblock, num_pages))
    S = -(-num_pages // K)
    lists = np.full((S, K), -1, np.int32)
    caps = np.minimum(K, num_pages - np.arange(S) * K)
    for s in range(S):
        c = int(caps[s])
        # LIFO top is index c-1; lowest page id on top so a fresh pool hands
        # out ascending ids within each superblock
        lists[s, :c] = s * K + np.arange(c - 1, -1, -1)
    return PagePool(
        sb_pages=torch.as_tensor(lists, device=dev),
        sb_free=torch.as_tensor(caps.astype(np.int32), device=dev),
        sb_mapped=torch.ones((S,), dtype=torch.bool, device=dev),
        page_version=torch.zeros((num_pages,), dtype=torch.int64, device=dev),
        page_refcount=torch.zeros((num_pages,), dtype=torch.int32, device=dev),
        clock=torch.zeros((), dtype=torch.int64, device=dev),
    )


# ---------------------------------------------------------------------------
# allocation: one-pass segmented pop over a superblock priority ordering


def _alloc_order(pool: PagePool):
    """Priority ordering of superblocks: PARTIAL first (fullest first), then
    EMPTY by index; FULL and UNMAPPED excluded.  Returns (order [S] int64,
    avail-in-order [S] int64)."""
    S, K = pool.sb_pages.shape
    cap = _capacities(pool)
    fc = pool.sb_free.to(torch.int64)
    allocatable = pool.sb_mapped & (fc > 0)
    partial = allocatable & (fc < cap)
    rank = torch.where(partial, 0, torch.where(allocatable, 1, 2))
    big = (K + 1) * S
    key = rank * big + torch.where(partial, fc, 0) * S + _arange(S, fc)
    order = torch.argsort(key, stable=True)
    avail = torch.where(rank < 2, fc, 0)[order]
    return order, avail


def _segmented_pop_impl(pool: PagePool, total: torch.Tensor, max_total: int):
    """Pop ``total`` (<= free_top) pages across superblocks in priority
    order.  Returns (pool, pages [max_total] int32 with −1 past ``total``)."""
    S, K = pool.sb_pages.shape
    order, avail = _alloc_order(pool)
    cum = torch.cumsum(avail, 0)
    total = torch.minimum(total.to(torch.int64), cum[-1])
    j = _arange(max_total, cum)
    seg = torch.searchsorted(cum, j, right=True)
    segc = torch.clamp(seg, max=S - 1)
    sb = order[segc]
    prev = torch.where(segc > 0, cum[torch.clamp(segc - 1, min=0)], 0)
    pos = pool.sb_free.to(torch.int64)[sb] - 1 - (j - prev)  # LIFO top
    pages = pool.sb_pages[sb, torch.clamp(pos, 0, K - 1)]
    pages = torch.where(j < total, pages, -1).to(torch.int32)
    taken = torch.minimum(torch.clamp(total - (cum - avail), min=0), avail)
    # a granted page leaves the free list with exactly one owner
    refcount = _drop_scatter_fill(pool.page_refcount, pages.to(torch.int64),
                                 pages >= 0, 1)
    sb_free = pool.sb_free.clone()
    sb_free.index_add_(0, order, (-taken).to(torch.int32))
    return pool._replace(sb_free=sb_free, page_refcount=refcount), pages


def _alloc_pages_batch_impl(pool: PagePool, need: torch.Tensor, max_grow: int):
    """Grant every row's ``need`` [B] pages (clipped to ``max_grow``) in one
    prefix-satisfying pop.  Returns (pool, grants [B, max_grow] int32, −1 =
    not granted, ok [] bool)."""
    B = need.shape[0]
    need = torch.clamp(need.to(torch.int64), 0, max_grow)
    end = torch.cumsum(need, 0)
    start = end - need
    # prefix satisfaction: once the pool runs dry every later needy row
    # fails too, so one segmented pop assigns a contiguous run of pages
    sat = end <= _free_total(pool)
    ok = torch.all(sat | (need == 0))
    total = torch.where(sat, need, 0).sum()
    pool, popped = _segmented_pop_impl(pool, total, B * max_grow)
    j = _arange(max_grow, need)[None, :]
    take = (j < need[:, None]) & sat[:, None]
    lin = torch.clamp(start[:, None] + j, max=B * max_grow - 1)
    grants = torch.where(take, popped[lin], -1).to(torch.int32)
    return pool, grants, ok


def alloc_pages_batch(pool: PagePool, need, max_grow: int = 1):
    """Grant pages for a whole batch's growth in one pass.

    ``need`` [B] — pages wanted per row (clipped to ``max_grow``).  Returns
    (pool, grants [B, max_grow] int32 (−1 = not granted), ok [] bool).  On
    exhaustion the satisfied prefix keeps its pages and ``ok`` is False;
    PARTIAL superblocks serve first, UNMAPPED ones never.  No host sync."""
    return _alloc_pages_batch_impl(pool, _ids(pool, need), max_grow)


def _alloc_pages_impl(pool: PagePool, n: int):
    ok = _free_total(pool) >= n
    pool, pages = _segmented_pop_impl(
        pool, torch.where(ok, n, 0).to(torch.int64), n)
    return pool, pages, ok


def alloc_pages(pool: PagePool, n: int):
    """Pop ``n`` pages.  Returns (pool, pages [n] int32, ok [] bool); on
    exhaustion nothing changes and pages are −1."""
    return _alloc_pages_impl(pool, n)


# ---------------------------------------------------------------------------
# refcounted free/share: a page re-enters its HOME superblock's LIFO free
# list only on the refcount ZERO-TRANSITION


def _unshare_pages_impl(pool: PagePool, pages: torch.Tensor) -> PagePool:
    """Drop one reference per valid entry (−1 ignored).  The entry whose
    drop takes the count to zero pushes the page back onto its superblock's
    free list, bumps its version and arms the clock tick.  Duplicate
    entries each count as a drop; drops below zero clamp."""
    pages = pages.reshape(-1).to(torch.int64)
    n = pages.shape[0]
    P = pool.num_pages
    S, K = pool.sb_pages.shape
    valid = pages >= 0
    pidx = torch.where(valid, pages, P)
    rc0 = torch.where(valid, pool.page_refcount[torch.clamp(pidx, max=P - 1)],
                      0)
    # cnt_incl[i] = occurrences of pages[i] among valid entries 0..i — the
    # entry where the cumulative drop count reaches the old refcount is the
    # (unique) one that performs the zero-transition push
    i = _arange(n, pages)
    same = (pages[None, :] == pages[:, None]) & valid[None, :] & valid[:, None]
    cnt_incl = (same & (i[None, :] <= i[:, None])).sum(1)
    frees = valid & (rc0 > 0) & (cnt_incl == rc0)
    drops = _drop_scatter_add(
        torch.zeros((P,), dtype=torch.int32, device=pages.device),
        pidx, valid, valid.to(torch.int32))
    refcount = torch.clamp(pool.page_refcount - drops, min=0)
    # push only the zero-transition entries, packed per superblock
    sb = torch.where(frees, pages // K, S)
    before = (sb[None, :] == sb[:, None]) & (i[None, :] < i[:, None]) \
        & frees[None, :]
    occ = before.sum(1)
    slot = pool.sb_free.to(torch.int64)[torch.clamp(sb, max=S - 1)] + occ
    put = frees & (sb < S) & (slot >= 0) & (slot < K)
    lists = torch.full((S + 1, K + 1), -1, dtype=pool.sb_pages.dtype,
                       device=pages.device)
    lists[:S, :K] = pool.sb_pages
    lists[torch.where(put, sb, S), torch.where(put, slot, K)] = \
        pages.to(lists.dtype)
    freed = _drop_scatter_add(torch.zeros_like(pool.sb_free), sb, frees,
                              frees.to(torch.int32))
    version = _drop_scatter_add(pool.page_version, pages, frees,
                                frees.to(torch.int64)) & U32
    # the warning fires only when something was actually reclaimed
    any_freed = frees.any()
    return pool._replace(
        sb_pages=lists[:S, :K].contiguous(),
        sb_free=pool.sb_free + freed,
        page_version=version,
        page_refcount=refcount,
        clock=(pool.clock + any_freed.to(torch.int64)) & U32,
    )


def unshare_pages(pool: PagePool, pages) -> PagePool:
    """Drop one reference from each page (−1 entries ignored).  Pages whose
    count hits zero re-enter their superblock's free list, their versions
    bump, and the clock ticks once per batch with a zero-transition."""
    return _unshare_pages_impl(pool, _ids(pool, pages))


def free_pages(pool: PagePool, pages) -> PagePool:
    """Release the caller's reference on each page (−1 entries ignored):
    alias of :func:`unshare_pages` — a page granted by ``alloc`` holds one
    reference, so freeing it is exactly the zero-transition decref."""
    return _unshare_pages_impl(pool, _ids(pool, pages))


def _share_pages_impl(pool: PagePool, pages: torch.Tensor):
    """Add one reference to each LIVE page (−1 ignored).  Returns (pool,
    ok [] bool); sharing a FREE page is refused and ok goes False."""
    pages = pages.reshape(-1).to(torch.int64)
    P = pool.num_pages
    valid = pages >= 0
    pidx = torch.where(valid, pages, P)
    rc = torch.where(valid, pool.page_refcount[torch.clamp(pidx, max=P - 1)],
                     1)
    ok = torch.all(rc > 0)
    inc = _drop_scatter_add(torch.zeros_like(pool.page_refcount), pidx,
                            valid & (rc > 0), (valid & (rc > 0)).to(torch.int32))
    return pool._replace(page_refcount=pool.page_refcount + inc), ok


def share_pages(pool: PagePool, pages):
    """Add one reference to each LIVE page (−1 entries ignored).  Returns
    (pool, ok [] bool): ok is False if any entry named a free page, whose
    increment alone is suppressed.  No version bump, no clock tick."""
    return _share_pages_impl(pool, _ids(pool, pages))


# ---------------------------------------------------------------------------
# physical release accounting (paper §3.2, device edition)


def _release_empty_impl(pool: PagePool, max_release, keep_mapped):
    """Take up to ``max_release`` EMPTY superblocks (highest index first)
    out of circulation while keeping ``keep_mapped`` mapped; released pages'
    versions bump and the clock ticks once per non-empty batch.  Returns
    (pool, n_released [], pages_released [])."""
    S, K = pool.sb_pages.shape
    cap = _capacities(pool)
    # a superblock holding any referenced page is never released, even if a
    # corrupted anchor claims it is EMPTY
    page_sb_all = _arange(pool.num_pages, cap) // K
    refs_in_sb = torch.zeros((S,), dtype=torch.int64, device=cap.device)
    refs_in_sb.index_add_(0, page_sb_all,
                          (pool.page_refcount > 0).to(torch.int64))
    empty = pool.sb_mapped & (pool.sb_free >= cap) & (refs_in_sb == 0)
    mapped_count = pool.sb_mapped.to(torch.int64).sum()
    quota = torch.clamp(
        torch.clamp(mapped_count - keep_mapped, max=max_release), 0, S)
    from_top = torch.flip(torch.cumsum(torch.flip(empty.to(torch.int64), [0]),
                                       0), [0])
    release = empty & (from_top <= quota)
    version = (pool.page_version + release[page_sb_all].to(torch.int64)) & U32
    n_rel = release.to(torch.int32).sum()
    pages_rel = torch.where(release, cap, 0).sum().to(torch.int32)
    return (
        pool._replace(
            sb_mapped=pool.sb_mapped & ~release,
            page_version=version,
            clock=(pool.clock + (n_rel > 0).to(torch.int64)) & U32,
        ),
        n_rel, pages_rel,
    )


def _map_superblocks_impl(pool: PagePool, n):
    """Bring up to ``n`` released superblocks back (lowest index first).
    Returns (pool, n_mapped [], pages_mapped [])."""
    cap = _capacities(pool)
    unmapped = ~pool.sb_mapped
    rk = torch.cumsum(unmapped.to(torch.int64), 0)  # 1-based rank
    take = unmapped & (rk <= n)
    n_map = take.to(torch.int32).sum()
    pages_map = torch.where(take, cap, 0).sum().to(torch.int32)
    return pool._replace(sb_mapped=pool.sb_mapped | take), n_map, pages_map


def release_empty_superblocks(pool: PagePool, max_release, keep_mapped):
    """Take up to ``max_release`` EMPTY superblocks out of circulation while
    keeping at least ``keep_mapped`` mapped.  Released pages' versions bump
    (an in-flight reader of the range fails validation) and the clock ticks
    once per non-empty batch; the KV arena stays allocated.  Returns (pool,
    n_released [] int32, pages_released [] int32)."""
    pool, n, pages = _release_empty_impl(pool, _scalar(pool, max_release),
                                         _scalar(pool, keep_mapped))
    return pool, n.to(torch.int32), pages


def map_superblocks(pool: PagePool, n):
    """Bring up to ``n`` released superblocks back into circulation (lowest
    index first).  Returns (pool, n_mapped [] int32, pages_mapped [] int32)."""
    pool, n_map, pages = _map_superblocks_impl(pool, _scalar(pool, n))
    return pool, n_map.to(torch.int32), pages


# ---------------------------------------------------------------------------
# OA snapshot / validate


def _snapshot_impl(pool: PagePool, pages: torch.Tensor) -> torch.Tensor:
    """Versions of ``pages`` (−1 reads as 0) — the reader's LocalClock."""
    idx = torch.clamp(pages.to(torch.int64), 0, pool.num_pages - 1)
    return torch.where(pages >= 0, pool.page_version[idx], 0)


def _validate_and_commit_impl(pool: PagePool, pages: torch.Tensor,
                              snapshot: torch.Tensor):
    """Per-row OA check: (valid [...] bool, freshly read versions)."""
    cur = _snapshot_impl(pool, pages)
    return torch.all(cur == snapshot, dim=-1), cur


def snapshot_versions(pool: PagePool, pages) -> torch.Tensor:
    """Versions of ``pages`` (−1 entries read as 0) — the reader's
    LocalClock; int64 holding uint32 values."""
    return _snapshot_impl(pool, _ids(pool, pages))


def validate_and_commit(pool: PagePool, pages, snapshot):
    """Per-row OA check and reader clock advance in one pass.  ``pages`` and
    ``snapshot`` [..., n].  Returns (valid [...] bool — True iff no page of
    the row was reclaimed since the snapshot — and the freshly read
    versions, the next snapshot for rows that commit)."""
    return _validate_and_commit_impl(pool, _ids(pool, pages),
                                     _ids(pool, snapshot))


def validate_read(pool: PagePool, pages, snapshot) -> torch.Tensor:
    """OA check: a 0-dim bool tensor, True iff none of ``pages`` was
    reclaimed since ``snapshot`` (a reclaim or a release bumps the version
    before the page can be granted again — the warning-before-free order
    of Alg. 1).  The caller decides when to read it."""
    cur = _snapshot_impl(pool, _ids(pool, pages))
    return torch.all(cur == _ids(pool, snapshot))


def assign_pool(dst: PagePool, src: PagePool) -> PagePool:
    """Write ``src``'s state into ``dst``'s tensors in place (the port's
    counterpart of the reference's donated pool buffers); returns ``dst``."""
    for a, b in zip(dst, src):
        a.copy_(b)
    return dst


# ---------------------------------------------------------------------------
# KV page storage


def kv_pages_init(num_pages: int, page_size: int, n_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, device=None):
    """The persistent KV arena: allocated once, never released (palloc).
    ``{"k", "v"}`` zeros of [num_pages, page_size, n_kv_heads, head_dim].
    Superblock release is accounting on the pool only, so reads through
    released ranges stay safe (they fail validation instead of faulting).
    On ``cuda`` unless ``device=`` says otherwise; no card is an error."""
    dev = resolve_device(device)
    shape = (num_pages, page_size, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _drop_rows_put(arena: torch.Tensor, pages: torch.Tensor,
                   slot: torch.Tensor, keep: torch.Tensor,
                   new: torch.Tensor) -> torch.Tensor:
    """``arena.at[pages, slot].set(new, mode="drop")``: a copy of the arena
    padded by one sentinel page, which takes the entries with ``keep``
    False and is then sliced away."""
    P = arena.shape[0]
    pad = torch.cat([arena, arena.new_zeros((1, *arena.shape[1:]))])
    pad.index_put_((torch.where(keep, pages, P), slot), new.to(arena.dtype))
    return pad[:P]


def append_kv(kv, block_tables, lengths, k_new, v_new):
    """Write one new token's K/V for each sequence; returns a new dict.

    kv: page arrays; block_tables [B, max_pages] (−1 = unmapped); lengths
    [B] current lengths (the new token goes at position ``lengths``);
    k_new/v_new [B, n_kv_heads, head_dim].  A row whose page is −1, or
    whose position lies past its table, is dropped.  Only pages pinned in a
    live block table are written (hazard-pointer discipline)."""
    P, page_size = kv["k"].shape[:2]
    M = block_tables.shape[1]
    lengths = lengths.to(torch.int64)
    page_idx = lengths // page_size
    slot = lengths % page_size
    inside = (page_idx >= 0) & (page_idx < M)
    pages = torch.gather(block_tables.to(torch.int64), 1,
                         torch.clamp(page_idx, 0, M - 1)[:, None])[:, 0]
    keep = inside & (pages >= 0) & (pages < P)
    return {"k": _drop_rows_put(kv["k"], pages, slot, keep, k_new),
            "v": _drop_rows_put(kv["v"], pages, slot, keep, v_new)}


def gather_kv(kv, block_table, max_len: int):
    """Optimistic gather of one sequence's KV as [max_len, Hkv, D] each.
    Reads through freed pages are safe (the arena is persistent); −1 reads
    page 0 and an id past the arena its last page, as the reference's
    gather clamps."""
    P, page_size = kv["k"].shape[:2]
    n = max_len // page_size
    pages = torch.clamp(block_table[:n].to(torch.int64), 0, P - 1)
    k = kv["k"][pages].reshape(n * page_size, *kv["k"].shape[2:])
    v = kv["v"][pages].reshape(n * page_size, *kv["v"].shape[2:])
    return k, v


# ---------------------------------------------------------------------------
# the stateful Allocator-protocol adapter (core.allocator.Allocator)


class DevicePagePool:
    """Stateful :class:`repro_torch.core.allocator.Allocator` over the pool.

    Owns the :class:`PagePool` (``state``) plus host mirrors of the
    superblock anchors, which move only at the ``release``/``map`` sync
    points, so :meth:`view` never costs a transfer.  The allowed sync
    points (``alloc``, ``share``, ``release``, ``map``) read their small
    results back (``device.host_list``: through pinned memory on a card);
    ``free`` and ``snapshot`` never read.
    """

    def __init__(self, num_pages: int,
                 pages_per_superblock: int = DEFAULT_PAGES_PER_SUPERBLOCK,
                 release_strategy: ReleaseStrategy = ReleaseStrategy.MADVISE,
                 device=None):
        self.device = resolve_device(device)
        self.state = pool_init(num_pages, pages_per_superblock, self.device)
        self.release_strategy = release_strategy
        self.superblocks_total = self.state.num_superblocks
        self.superblocks_mapped = self.superblocks_total
        self.superblocks_released = 0  # cumulative
        self.superblocks_remapped = 0  # cumulative
        self.pages_mapped = num_pages

    @property
    def num_pages(self) -> int:
        """Total pages in the arena (constant)."""
        return self.state.num_pages

    @property
    def pages_per_superblock(self) -> int:
        """Release granularity (pages per superblock)."""
        return self.state.pages_per_superblock

    def _ids(self, pages) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.int64, device=self.device)

    def alloc(self, n: int) -> tuple[list[int], bool]:
        """Pop ``n`` pages (refcount 1 each).  Returns ``(ids, ok)``; on
        exhaustion ``ok`` is False, nothing changes and ``ids`` is empty.
        An allowed sync point: one read of the grant and its flag."""
        self.state, pages, ok = _alloc_pages_impl(self.state, n)
        out = host_list(torch.cat([ok.to(torch.int32).reshape(1), pages]))
        if not out[0]:
            return [], False
        return out[1:], True

    def free(self, pages) -> None:
        """Drop one reference per page (−1 ignored); zero-transitions
        re-enter the free list with a version bump and one clock tick per
        batch.  Accepts host lists or device tensors — no device read."""
        self.state = _unshare_pages_impl(self.state, self._ids(pages))

    def unshare(self, pages) -> None:
        """Alias of :meth:`free` (the refcount vocabulary)."""
        self.free(pages)

    def share(self, pages) -> bool:
        """Add one reference per live page; returns False (and suppresses
        the increment) if any id named a FREE page.  Reads the flag —
        sharing happens at admission, an allowed sync point."""
        self.state, ok = _share_pages_impl(self.state, self._ids(pages))
        return bool(host_list(ok.reshape(1))[0])

    def release(self, keep_superblocks: int) -> tuple[int, int]:
        """Take EMPTY superblocks above the floor out of circulation and
        update the anchor mirrors; returns ``(n_superblocks, n_pages)``.
        A ``KEEP`` pool never releases."""
        if self.release_strategy is ReleaseStrategy.KEEP:
            return 0, 0
        self.state, n_sb, n_pg = _release_empty_impl(
            self.state, self.superblocks_total, max(0, keep_superblocks))
        got_sb, got_pg = host_list(torch.stack([n_sb, n_pg]))
        self.superblocks_mapped -= got_sb
        self.superblocks_released += got_sb
        self.pages_mapped -= got_pg
        return got_sb, got_pg

    def map(self, n_superblocks: int) -> tuple[int, int]:
        """Bring up to ``n_superblocks`` released superblocks back; returns
        ``(n_superblocks, n_pages)`` and updates the anchor mirrors."""
        if n_superblocks <= 0 or self.superblocks_mapped >= self.superblocks_total:
            return 0, 0
        self.state, n_sb, n_pg = _map_superblocks_impl(self.state,
                                                       n_superblocks)
        got_sb, got_pg = host_list(torch.stack([n_sb, n_pg]))
        self.superblocks_mapped += got_sb
        self.superblocks_remapped += got_sb
        self.pages_mapped += got_pg
        return got_sb, got_pg

    def snapshot(self, pages) -> torch.Tensor:
        """Versions of ``pages`` (−1 reads as 0) as a device tensor."""
        return _snapshot_impl(self.state, self._ids(pages))

    def view(self) -> AllocatorView:
        """Anchor introspection from the host mirrors (no device read)."""
        return AllocatorView(
            superblocks_total=self.superblocks_total,
            superblocks_mapped=self.superblocks_mapped,
            superblocks_released=self.superblocks_released,
            superblocks_remapped=self.superblocks_remapped,
            pages_mapped=self.pages_mapped,
            pages_per_superblock=self.pages_per_superblock,
            release_strategy=self.release_strategy.value,
        )

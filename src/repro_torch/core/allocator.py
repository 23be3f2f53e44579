"""The unified OA-allocator protocol: one contract for host and device.

The paper's thesis is that optimistic-access reclamation becomes simple when
the *allocator* owns page lifecycle behind a clean interface: ``palloc``
keeps freed memory readable, versions warn in-flight readers, superblocks
give physical release a natural granularity.  This repo implements that
hybrid design twice — the CPU model (``core/lrmalloc.py`` over the
``core/vm.py`` arena) and the device page pool (``core/pagepool.py``) — and
before this module the two exposed unrelated APIs, so every layer above had
to know which one it was holding.

:class:`Allocator` is the shared protocol.  Both
:class:`repro.core.lrmalloc.HostAllocator` and
:class:`repro.core.pagepool.DevicePagePool` implement it, and the serving
stack's KV manager (``repro.serving.kv_manager``) talks *only* to this
surface — the cross-layer contract tests in ``tests/test_layering.py``
drive the manager with a pure-host fake to prove nothing reaches around it.

Because the protocol is the ONLY seam the stack sees, reclamation schemes
can be swapped behind it: ``core/reclaim_policy.py`` puts a
:class:`~repro.core.reclaim_policy.ReclamationPolicy` in front of any
implementation (the interval policy wraps ``free``/``unshare`` in a limbo
list; the chaos layer ``core/chaos.py`` wraps the same surface for fault
injection) and the differential tests in ``tests/test_reclaim_diff.py``
prove the serving stack is token-exact under every backend.

The protocol's vocabulary is the paper's:

- ``alloc`` / ``free``: grant with one owner / drop one reference.  The
  refcount ZERO-transition is the reclamation point — the unit's version
  bumps so optimistic readers holding an older :meth:`Allocator.snapshot`
  fail validation instead of reading recycled memory.
- ``share`` / ``unshare``: add / drop an owner without moving versions
  (sharing never invalidates anyone's snapshot; ``unshare`` == ``free``).
- ``release`` / ``map``: take EMPTY superblocks out of circulation
  (physical release, §3.2 — versions over the released range bump) and
  bring them back under pressure.
- ``snapshot`` / ``view``: the OA reader's version read and the anchor
  introspection (:class:`AllocatorView`) that replaces the ad-hoc mirror
  counters the engine and both allocators used to keep separately.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

from .vm import ReleaseStrategy

__all__ = ["Allocator", "AllocatorView", "ReleaseStrategy"]


@dataclasses.dataclass(frozen=True)
class AllocatorView:
    """Anchor introspection: one consistent snapshot of allocator state.

    This is the single home of the superblock accounting that used to be
    duplicated across ``EngineStats`` (``superblocks_mapped`` …), the
    engine's private ``_mapped_sbs``/``_mapped_pages`` mirrors and
    ``lrmalloc.AllocatorStats`` — every consumer now reads the allocator's
    own ``view()`` instead of keeping its own copy.
    """

    superblocks_total: int  # arena footprint (constant: palloc'd once)
    superblocks_mapped: int  # currently in circulation
    superblocks_released: int  # cumulative physical releases
    superblocks_remapped: int  # cumulative remaps under pressure
    pages_mapped: int  # allocatable capacity (free + held)
    pages_per_superblock: int  # release granularity
    release_strategy: str  # ReleaseStrategy value string


@runtime_checkable
class Allocator(Protocol):
    """What every OA allocator owes the layers above it.

    Implementations: :class:`repro.core.pagepool.DevicePagePool` (units are
    KV pages; state is a jax pytree, ops are fused dispatches),
    :class:`repro.core.lrmalloc.HostAllocator` (units are persistent
    size-class blocks in the mmap arena).  ``tests/test_layering.py`` runs
    both through one generic exerciser, and drives the serving stack with a
    fake implementation to prove the layering.
    """

    #: The allocator's threadable state.  Fused device dispatches inline the
    #: allocator's traceable op bodies (the paper's amortization: grant +
    #: validate fused with the compute they guard), so the executor threads
    #: this value through a step and hands it back — treating it as opaque.
    #: Host allocators, whose state is internal, expose ``None``.
    state: object

    def alloc(self, n: int) -> tuple[list[int], bool]:
        """Grant ``n`` units, each with refcount 1.

        Returns ``(ids, ok)``.  On exhaustion ``ok`` is False and no state
        changes — the caller must reclaim (evict, preempt) or ``map``
        released superblocks and retry; the allocator never blocks.
        """
        ...

    def free(self, units: Sequence[int]) -> None:
        """Drop one reference per unit (negative ids ignored).

        A unit whose count hits ZERO is reclaimed *optimistically*: its
        version bumps and it becomes immediately re-allocatable; readers
        racing the reclaim fail :meth:`snapshot` validation rather than
        fencing.  Alias of :meth:`unshare` (a sole owner's drop IS the
        zero-transition).
        """
        ...

    def unshare(self, units: Sequence[int]) -> None:
        """Drop one reference per unit — see :meth:`free`."""
        ...

    def share(self, units: Sequence[int]) -> bool:
        """Add one reference to each LIVE unit; no version moves.

        Returns False if any id named a free unit (the increment is
        suppressed — sharing a free unit would be a use-after-free in the
        making, the caller must treat its bookkeeping as corrupt).
        """
        ...

    def release(self, keep_superblocks: int) -> tuple[int, int]:
        """Physically release EMPTY superblocks above the floor (§3.2).

        Keeps at least ``keep_superblocks`` mapped (``0`` means every EMPTY
        superblock may go — implementations must honor it identically, see
        the shared exerciser in ``tests/test_layering.py``).  Released
        units leave circulation and their versions bump (in-flight
        optimistic readers of the range fail validation).  Returns
        ``(n_superblocks, n_units)`` actually released; a ``KEEP``-strategy
        allocator always returns ``(0, 0)``.
        """
        ...

    def map(self, n_superblocks: int) -> tuple[int, int]:
        """Bring up to ``n_superblocks`` released superblocks back into
        circulation.  Returns ``(n_superblocks, n_units)`` mapped (an
        allocator that remaps lazily may return ``(0, 0)``)."""
        ...

    def snapshot(self, units):
        """Current versions of ``units`` (negative ids read as 0) — the OA
        reader's LocalClock.  A later equality check against a fresh
        snapshot is the validation step of the read protocol."""
        ...

    def view(self) -> AllocatorView:
        """Anchor introspection (see :class:`AllocatorView`)."""
        ...

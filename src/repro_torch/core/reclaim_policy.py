"""Pluggable reclamation backends behind the ``Allocator`` protocol.

The paper's comparison — OA's optimistic access vs the epoch/interval
rivals (EBR; IBR/Hyaline; VBR's version stamps, arxiv 2107.13843) — needs
all schemes runnable against ONE serving stack.  This module is that seam:
a :class:`ReclamationPolicy` decides, per step, whether the fused dispatch
must run the device-side ``validate_and_commit`` pass, and may interpose on
the allocator itself (the interval policy wraps it to defer frees).

Three policies ship:

``oa-validate``
    Today's scheme, extracted unchanged: every step validates each row's
    version snapshot against the live page versions.  Precise — stale
    readers are detected the same step the reclaim happened — at the cost
    of one gather/compare per row per step.

``epoch-grace``
    EBR-flavoured grace periods on top of the same version clock.  The
    host mirror of the pool's reclamation clock (``stats.warnings_fired``)
    *is* the epoch counter: steady-state steps in which no free / release /
    evict has ticked the mirror since the last validated step skip the
    device validation pass entirely (the fused step branches on a traced
    boolean, so there is no recompile and no extra transfer).  Any mirror
    tick — a finish freeing pages, a superblock release, a prefix eviction,
    a COW zero-transition — forces one validation pass before the freed
    pages' reuse can go undetected.

``interval``
    IBR-style interval-based reclamation: frees requested in interval *i*
    are held in a limbo list and only applied to the pool (becoming
    grantable) at interval *i+2*, where intervals advance once per engine
    step.  Any reader whose access began in interval *i* has finished (its
    one-step dispatch collected) before the page can be re-granted, so the
    per-step validation pass is dropped entirely — zero validation, at the
    price of a bounded free-list lag and host-side detection of *external*
    reclaims (the scheduler restarts externally-reclaimed rows itself,
    mirroring OA's reader-restart surface).

This module is deliberately jax-free: the interval limbo holds whatever
unit handles the wrapped allocator accepts (host lists or opaque device
arrays) without inspecting them, so the pure-host scheduler may import it
under the layering lint.
"""

from __future__ import annotations

import os
from typing import Any

POLICY_NAMES = ("oa-validate", "epoch-grace", "interval")

# Frees applied at interval i become grantable at i + INTERVAL_LAG: one full
# interval must separate the free from the grant so any reader whose access
# began before the free has retired (IBR's 2-era rule).
INTERVAL_LAG = 2

_ENV_VAR = "RECLAIM_POLICY"


def default_policy_name() -> str:
    """The policy used when the engine is not told otherwise.

    Reads the ``RECLAIM_POLICY`` environment variable (the CI matrix knob)
    and falls back to ``oa-validate`` — the paper's scheme stays the
    default."""
    return os.environ.get(_ENV_VAR, "oa-validate")


class ReclamationPolicy:
    """Base class: the per-step reclamation decisions the engine delegates.

    A policy is consulted at three points of the serving loop: once when a
    step is *planned* (:meth:`needs_validation` — should the fused dispatch
    run the OA validate/commit pass?), once when its results are *absorbed*
    (:meth:`on_validated` / :meth:`on_step`), and at allocator construction
    (:meth:`wrap` — interpose on frees).  The default implementations are
    the OA behaviour: always validate, never interpose."""

    #: Registry name; overridden per subclass.
    name = "oa-validate"

    #: True when the DEVICE detects stale readers (the validation pass).
    #: Policies that skip validation unconditionally must set this False so
    #: the scheduler restarts externally-reclaimed rows host-side instead.
    detects_stale_readers = True

    def wrap(self, allocator: Any) -> Any:
        """Interpose on the allocator at engine construction.

        Returns ``allocator`` unchanged by default; the interval policy
        returns an :class:`IntervalAllocator` deferring its frees."""
        return allocator

    def needs_validation(self, clock_mirror: int) -> bool:
        """Must the step planned NOW run the device validation pass?

        ``clock_mirror`` is the host mirror of the pool's reclamation clock
        (``stats.warnings_fired``) at plan time."""
        return True

    def on_validated(self, clock_mirror: int) -> None:
        """A step planned at mirror value ``clock_mirror`` validated and
        its results were absorbed.  Default: nothing to remember."""

    def on_step(self) -> None:
        """One engine step's results were fully absorbed (interval tick)."""

    def pending_frees(self) -> bool:
        """True when frees are deferred and not yet applied to the pool.

        The scheduler consults this before preempting for pages: limbo
        pages mature within :data:`INTERVAL_LAG` steps, so waiting beats
        evicting a victim whose pages would only join the limbo."""
        return False

    def drain_pending(self) -> bool:
        """Apply deferred frees early because NO optimistic reader is live
        (the engine calls this only when the running set is empty, where
        every interval guarantee is trivially satisfied).  Returns True if
        anything was applied."""
        return False

    def flush(self) -> None:
        """Apply ALL deferred frees unconditionally (end-of-drain, zero
        readers).  Default: nothing deferred."""


class OAValidatePolicy(ReclamationPolicy):
    """The paper's scheme: validate every row's snapshot every step."""

    name = "oa-validate"
    detects_stale_readers = True


class EpochGracePolicy(ReclamationPolicy):
    """Skip validation on steps whose epoch saw no reclamation.

    The epoch counter is the host clock mirror: it ticks exactly when a
    device batch performed a zero-transition free, release or evict — the
    only events that can invalidate a live row's snapshot.  A step planned
    at the same mirror value as the last *validated* step cannot observe a
    stale page, so its validation pass is skipped.  The first step always
    validates (``_validated_at`` starts as None), and any tick that lands
    mid-step (e.g. a COW zero-transition discovered at absorb time) forces
    validation on the NEXT step — conservative by one step, never late."""

    name = "epoch-grace"
    detects_stale_readers = True

    def __init__(self) -> None:
        """Start with no validated epoch so the first step validates."""
        self._validated_at: int | None = None

    def needs_validation(self, clock_mirror: int) -> bool:
        """Validate iff the mirror moved since the last validated step."""
        return self._validated_at != clock_mirror

    def on_validated(self, clock_mirror: int) -> None:
        """Record the mirror value the validated step was PLANNED at (ticks
        that landed during the step force one more validation)."""
        self._validated_at = clock_mirror


class IntervalAllocator:
    """Allocator wrapper deferring frees by :data:`INTERVAL_LAG` intervals.

    ``free``/``unshare`` requests are parked in a limbo list stamped with
    the interval they mature at; :meth:`tick` (called once per engine step
    by the policy) advances the interval and applies mature batches to the
    wrapped allocator.  Everything else forwards — the wrapper composes
    with :class:`repro.core.chaos.ChaosAllocator` in either order because
    both follow the same forwarding discipline."""

    def __init__(self, inner: Any):
        """Wrap ``inner`` (a DevicePagePool, HostPagePool or chaos wrapper)."""
        self.inner = inner
        self.interval = 0
        # list of [mature_interval, method_name, units]
        self._limbo: list[list[Any]] = []
        self.frees_deferred = 0
        self.frees_applied = 0

    # -- deferred mutation paths --------------------------------------------

    def free(self, units: Any) -> None:
        """Park ``units`` in limbo; applied at interval ``now + LAG``."""
        self._limbo.append([self.interval + INTERVAL_LAG, "free", units])
        self.frees_deferred += 1

    def unshare(self, units: Any) -> None:
        """Defer a refcount decrement exactly like a free: the decrement
        may be the zero-transition that recycles the page."""
        self._limbo.append([self.interval + INTERVAL_LAG, "unshare", units])
        self.frees_deferred += 1

    # -- interval machinery --------------------------------------------------

    def tick(self) -> bool:
        """Advance one interval and apply batches that matured.  Returns
        True if any batch was applied (pages may have become grantable)."""
        self.interval += 1
        return self._apply_due(self.interval)

    def _apply_due(self, now: int) -> bool:
        due = [b for b in self._limbo if b[0] <= now]
        if not due:
            return False
        self._limbo = [b for b in self._limbo if b[0] > now]
        for _, method, units in due:
            getattr(self.inner, method)(units)
            self.frees_applied += 1
        return True

    def pending(self) -> int:
        """Number of limbo batches not yet applied."""
        return len(self._limbo)

    def flush(self) -> None:
        """Apply every limbo batch now (caller guarantees zero readers);
        chains to the inner allocator's ``flush`` when it has one (the
        chaos wrapper's delayed frees)."""
        self._apply_due(now=self.interval + INTERVAL_LAG)
        inner_flush = getattr(self.inner, "flush", None)
        if inner_flush is not None:
            inner_flush()

    # -- forwarding ----------------------------------------------------------

    @property
    def state(self):
        """The wrapped pool's device state (pass-through)."""
        return self.inner.state

    @state.setter
    def state(self, value):
        """Install an updated device state on the wrapped pool."""
        self.inner.state = value

    def alloc(self, n):
        """Forward: grants only see pages whose frees matured."""
        return self.inner.alloc(n)

    def share(self, units):
        """Forward: refcount increments carry no reclamation hazard."""
        return self.inner.share(units)

    def release(self, keep_superblocks):
        """Forward: limbo pages are still ALLOCATED in the pool (their free
        has not been applied), so superblocks with deferred frees are not
        EMPTY and cannot be released early."""
        return self.inner.release(keep_superblocks)

    def map(self, n):
        """Forward remap-on-demand."""
        return self.inner.map(n)

    def snapshot(self, units):
        """Forward version snapshots (unused for validation under interval,
        but rows still carry them so policies stay switch-compatible)."""
        return self.inner.snapshot(units)

    def view(self):
        """Forward the anchor-counter view."""
        return self.inner.view()

    def __getattr__(self, name):
        """Forward everything else (page_size, pages_per_superblock, ...)."""
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)


class IntervalPolicy(ReclamationPolicy):
    """IBR-style: defer frees two intervals, run zero validation passes.

    The device never validates (``needs_validation`` is always False);
    soundness comes from the :class:`IntervalAllocator` grant delay — a
    page freed while a dispatch was in flight cannot be re-granted until
    every such dispatch has retired.  External reclaims (pages yanked from
    a RUNNING row) are outside the free→grant discipline, so
    ``detects_stale_readers`` is False and the scheduler restarts those
    rows host-side at absorb time."""

    name = "interval"
    detects_stale_readers = False

    def __init__(self) -> None:
        """The wrapped allocator is bound by :meth:`wrap`."""
        self._alloc: IntervalAllocator | None = None

    def wrap(self, allocator: Any) -> Any:
        """Interpose the limbo wrapper; called once at engine build."""
        self._alloc = IntervalAllocator(allocator)
        return self._alloc

    def needs_validation(self, clock_mirror: int) -> bool:
        """Never: the grant delay replaces the validation pass."""
        return False

    def on_step(self) -> None:
        """One step retired — advance the interval, apply mature frees."""
        if self._alloc is not None:
            self._alloc.tick()

    def pending_frees(self) -> bool:
        """True while limbo batches wait (admission should wait, not
        preempt — the pages mature within the lag)."""
        return self._alloc is not None and self._alloc.pending() > 0

    def drain_pending(self) -> bool:
        """With zero live readers every limbo batch is safe to apply now."""
        if self._alloc is None or self._alloc.pending() == 0:
            return False
        self._alloc.flush()
        return True

    def flush(self) -> None:
        """End-of-drain: apply everything (also flushes chaos frees)."""
        if self._alloc is not None:
            self._alloc.flush()


def make_policy(name: str | None = None) -> ReclamationPolicy:
    """Build a fresh policy instance by registry name.

    ``None`` resolves through :func:`default_policy_name` (the
    ``RECLAIM_POLICY`` env var, default ``oa-validate``).  Raises
    ``ValueError`` on unknown names so typos fail loudly at engine build."""
    if name is None:
        name = default_policy_name()
    if name == "oa-validate":
        return OAValidatePolicy()
    if name == "epoch-grace":
        return EpochGracePolicy()
    if name == "interval":
        return IntervalPolicy()
    raise ValueError(
        f"unknown reclaim policy {name!r}; expected one of {POLICY_NAMES}")

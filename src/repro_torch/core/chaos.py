"""Fault-injection chaos layer over the unified OA-allocator protocol.

The port of ``repro.core.chaos``: the same seeded ``numpy`` Generator and
the same order of draws, so a seed gives the reference's fault schedule.
The one change is :meth:`ChaosAllocator.snapshot`: the pool's versions
are a device tensor (int64 holding uint32 values), so the perturbation is
a device op masked to the reference's uint32 wrap, with no host read.  One
counter is added: ``unmap_clock_ticks``, the clock ticks of spontaneous
releases, which the engine's clock mirror cannot see.

The paper's core move is to make *failure a normal event*: an optimistic
reader may touch reclaimed memory and must validate-and-retry, and the
allocator must stay correct while superblocks vanish underneath it.  The
serving stack inherits those retry paths (``validate_and_commit`` failures,
``grant_info == -1`` rows, remap-before-preempt), but in a healthy run they
fire rarely — which means they are the least-tested code in the hot path.

:class:`ChaosAllocator` wraps any :class:`repro_torch.core.allocator.Allocator`
implementation and deterministically (seeded) injects the paper's failure
modes at the protocol surface, so every retry path is exercisable on
demand:

- **grant denials** — ``alloc`` returns ``([], False)`` as if the pool were
  exhausted; the scheduler's bounded retry / remap / evict / preempt chain
  must absorb it (``tests/test_torch_chaos.py``).
- **spurious validation failures** — ``snapshot`` returns versions bumped
  by one for a row's mapped pages, so the NEXT fused step's OA validation
  fails and the request restarts from a known-valid state, exactly as if a
  reclaimer had raced it.  Perturbation only ever *increases* a version, so
  it can produce a false INVALID but never mask a real reclaim as valid.
- **delayed releases** — a ``free``/``unshare`` batch is held back for a
  few protocol calls before being applied.  The deferred pages stay live in
  the inner allocator (refcount > 0), so they can never be re-granted while
  deferred — the injection starves the free list without ever risking a
  use-after-free.
- **unmap-under-reader** — after a free, the chaos layer spontaneously
  releases EVERY empty superblock (``release(0)``), bumping versions over
  the released range so in-flight optimistic readers fail validation and
  the growth path has to remap under pressure.

The wrapper is a pure pass-through for ``state`` (the fused steps
thread the inner pool state untouched — chaos never perturbs device-side
grants, only the host-protocol surface), and forwards every attribute it
does not own, so the engine's introspection surface keeps working when a
pool is wrapped.  All randomness comes from one ``numpy`` Generator seeded
by :class:`ChaosConfig` — a chaos run is exactly reproducible.

The reclamation policies (``core/reclaim_policy.py``) compose with this
layer: the engine wraps ``policy.wrap(ChaosAllocator(pool))``, so the
interval policy's limbo defers the very frees the fault schedule perturbs,
and both wrappers follow the same forwarding discipline (``state``
pass-through, ``__getattr__`` delegation, a chainable ``flush``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ChaosConfig", "ChaosAllocator"]


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded fault-injection schedule for a :class:`ChaosAllocator`.

    All probabilities are per protocol call; ``seed`` makes the whole
    schedule deterministic.  The JAX package's chaos benchmark runs
    ``grant_denial_p=0.10`` plus one replica kill (injected at the fleet
    layer, ``serving/parallel.py``, not here).
    """

    seed: int = 0
    #: P(``alloc`` is denied as if the pool were exhausted)
    grant_denial_p: float = 0.0
    #: P(``snapshot`` perturbs a row's versions so its next validation fails)
    spurious_invalid_p: float = 0.0
    #: P(a ``free``/``unshare`` batch is deferred for ``delay_ops`` calls)
    delayed_free_p: float = 0.0
    #: protocol calls a deferred free batch is held back before applying
    delay_ops: int = 3
    #: P(a free is followed by a spontaneous ``release(0)`` — every EMPTY
    #: superblock leaves circulation under any in-flight reader)
    unmap_under_reader_p: float = 0.0


class ChaosAllocator:
    """Fault-injecting :class:`~repro_torch.core.allocator.Allocator` decorator
    (module docstring).  ``faults`` counts every injected event by kind so
    tests can assert the schedule actually fired."""

    def __init__(self, inner, config: ChaosConfig):
        self.inner = inner
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        self._deferred: list[list] = []  # [countdown, units] batches
        self.faults = {"grant_denial": 0, "spurious_invalid": 0,
                       "delayed_free": 0, "unmap_under_reader": 0}
        #: pool-clock ticks of the spontaneous releases (one per release
        #: that took a superblock).  They happen behind the KV manager, so
        #: its clock mirror (``stats.warnings_fired``) does not count them,
        #: here as in the reference: ``warnings_fired + unmap_clock_ticks
        #: == pool.clock`` once deferred frees are flushed
        self.unmap_clock_ticks = 0

    # -- plumbing ------------------------------------------------------------

    @property
    def state(self):
        """The inner allocator's threaded pool state, untouched — fused
        steps run exactly as without chaos."""
        return self.inner.state

    @state.setter
    def state(self, value):
        """Thread the (possibly in-flight) state back to the inner pool."""
        self.inner.state = value

    def __getattr__(self, name):
        """Forward introspection attributes (``num_pages``,
        ``pages_per_superblock``, anchor mirrors, …) to the inner pool."""
        if name == "inner":  # not yet bound: do not recurse through self
            raise AttributeError(name)
        return getattr(self.inner, name)

    def _tick(self) -> None:
        """One protocol call elapsed: age the deferred free batches and
        apply every batch whose delay has run out."""
        due = []
        for batch in self._deferred:
            batch[0] -= 1
            if batch[0] <= 0:
                due.append(batch)
        for batch in due:
            self._deferred.remove(batch)
            self.inner.free(batch[1])

    def flush(self) -> None:
        """Apply every still-deferred free batch now (drain/test hook)."""
        for _, units in self._deferred:
            self.inner.free(units)
        self._deferred.clear()

    # -- the protocol surface, with faults -----------------------------------

    def alloc(self, n: int):
        """Grant ``n`` units — or deny the grant (``([], False)``) with
        probability ``grant_denial_p``, indistinguishable from exhaustion."""
        self._tick()
        if self._rng.random() < self.config.grant_denial_p:
            self.faults["grant_denial"] += 1
            return [], False
        return self.inner.alloc(n)

    def free(self, units) -> None:
        """Drop references — possibly deferred (``delayed_free_p``), and
        possibly followed by a spontaneous empty-superblock release
        (``unmap_under_reader_p``)."""
        self._tick()
        if self._rng.random() < self.config.delayed_free_p:
            self.faults["delayed_free"] += 1
            self._deferred.append([max(1, self.config.delay_ops), units])
            return
        self.inner.free(units)
        if self._rng.random() < self.config.unmap_under_reader_p:
            self.faults["unmap_under_reader"] += 1
            got_sb, _ = self.inner.release(0)
            self.unmap_clock_ticks += got_sb > 0

    def unshare(self, units) -> None:
        """Alias of :meth:`free` (protocol vocabulary)."""
        self.free(units)

    def share(self, units) -> bool:
        """Forwarded clean: a failed share means corrupt caller bookkeeping
        (the manager asserts on it), never a transient fault to inject."""
        self._tick()
        return self.inner.share(units)

    def release(self, keep_superblocks: int):
        """Forwarded clean — the spontaneous unmap rides :meth:`free`, so
        policy-driven shrinks stay deterministic for the release tests."""
        self._tick()
        return self.inner.release(keep_superblocks)

    def map(self, n_superblocks: int):
        """Forwarded clean: remap is the RECOVERY path the other faults
        drive traffic into; injecting here would deadlock recovery."""
        self._tick()
        return self.inner.map(n_superblocks)

    def snapshot(self, units):
        """The OA reader's version read — perturbed (+1 on every mapped
        unit) with probability ``spurious_invalid_p``, so the holder's next
        validation fails and it restarts.  Monotone: the perturbation can
        only fake a reclaim, never hide one.  The bump is a device op on
        the versions' device (``units`` is usually a row already there), and
        wraps at ``0xFFFFFFFF`` as the reference's uint32 add does."""
        self._tick()
        vers = self.inner.snapshot(units)
        if self._rng.random() < self.config.spurious_invalid_p:
            self.faults["spurious_invalid"] += 1
            ids = torch.as_tensor(units, device=vers.device).reshape(-1)
            return (vers + (ids >= 0)) & 0xFFFFFFFF
        return vers

    def view(self):
        """Anchor introspection, forwarded (chaos does not lie to the
        pressure arithmetic — denials starve the free list instead)."""
        return self.inner.view()

"""Overload policy: request classes, bounded admission queues, the
graceful-degradation ladder and pluggable victim selection.

Pure host logic, scheduler-layer only (no jax, no pool module — the same
lint that covers ``scheduler.py`` covers this file).  The pieces:

- :class:`RequestClass` — a multi-tenant service class (``interactive`` /
  ``batch`` / ``background``) with per-class TTFT/TPOT SLO targets, a
  strict admission priority and a bounded queue depth.
- :class:`ClassQueues` — the scheduler's admission queue, one bounded FIFO
  per class drained in strict priority order.  ``submit()`` REJECTS when a
  class queue is full (explicit backpressure — the queue never grows
  unboundedly); the engine facade offers a blocking wrapper that drives
  steps until space frees.
- :class:`DegradationLadder` — pressure-driven rungs that engage IN ORDER
  under sustained pool/queue pressure and release in reverse when it
  clears: (1) shrink the chunk budget, (2) cap speculative drafts at zero,
  (3) evict the prefix cache, (4) shed lowest-class QUEUED work.  The
  ladder only decides the level; the scheduler applies each rung through
  knobs it already owns, so every rung is host policy — the fused dispatch
  and its one ``device_get`` per step are untouched.
- ``VICTIM_POLICIES`` — preemption victim selection as a policy point:
  PR 4's youngest-overall, plus a deadline-aware policy that spares the
  requests closest to missing their SLO.

Shedding here happens ONLY to queued requests (rung 4) or at admission
(the deadline estimator in ``scheduler._shed_if_hopeless``); a running
request is never shed — its committed KV is sunk cost worth finishing.
The hypothesis suite in ``tests/test_traffic.py`` pins these invariants.
"""

from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One multi-tenant service class.

    ``priority``: strict admission priority, LOWER is served first.
    ``slo_ttft_s`` / ``slo_tpot_s``: the class's latency targets (time to
    first token; per-token inter-token latency) — reporting targets the
    stats layer scores percentiles against, and the deadline the traffic
    harness derives per request.  ``max_queue_depth``: bound on this
    class's admission queue (None = the scheduler's global default)."""

    name: str
    priority: int
    slo_ttft_s: float
    slo_tpot_s: float
    max_queue_depth: int | None = None


#: The reference three-tenant mix (benchmarks/traffic.py's trace schema and
#: ``launch/serve.py --classes`` validate against these names).
DEFAULT_CLASSES: dict[str, RequestClass] = {
    "interactive": RequestClass("interactive", 0, slo_ttft_s=1.0,
                                slo_tpot_s=0.25),
    "batch": RequestClass("batch", 1, slo_ttft_s=10.0, slo_tpot_s=1.0),
    "background": RequestClass("background", 2, slo_ttft_s=60.0,
                               slo_tpot_s=5.0),
}


class ClassQueues:
    """Per-class bounded FIFOs drained in strict priority order.

    Quacks like the scheduler's historical single ``deque`` for every
    access pattern the stack uses — ``bool``, ``len``, iteration,
    ``[0]`` (the head: FIFO front of the highest-priority non-empty
    class), ``append`` (routes on ``req.cls``), ``popleft`` (pops that
    same head), ``clear`` — so the engine facade, the data-parallel
    migrator and the tests keep working unchanged.  Strict priority means
    a higher class can never be starved by lower ones; lower classes CAN
    wait indefinitely under sustained high-priority load, which is the
    contract rung 4 of the ladder (shed lowest first) builds on.

    Capacity is enforced by :meth:`full`, consulted by the scheduler's
    ``submit`` BEFORE enqueueing — ``append`` itself never drops (the
    preemption/migration requeue paths must always succeed: those
    requests were already admitted once)."""

    def __init__(self, classes: dict[str, RequestClass],
                 default_depth: int | None = None):
        self.classes = classes
        self.default_depth = default_depth
        order = sorted(classes.values(), key=lambda c: (c.priority, c.name))
        self._order = [c.name for c in order]
        self._queues: dict[str, deque] = {n: deque() for n in self._order}

    def depth_cap(self, cls: str) -> int | None:
        """``cls``'s queue bound: its own, else the global default."""
        cap = self.classes[cls].max_queue_depth
        return self.default_depth if cap is None else cap

    def full(self, cls: str) -> bool:
        """True when ``cls``'s queue is at its bound (submit must reject)."""
        cap = self.depth_cap(cls)
        return cap is not None and len(self._queues[cls]) >= cap

    def append(self, req) -> None:
        """Enqueue on ``req.cls``'s FIFO (never drops — class docstring)."""
        self._queues[getattr(req, "cls", self._order[0])].append(req)

    def popleft(self):
        """Pop the head: FIFO front of the highest-priority non-empty
        class (raises ``IndexError`` when empty, deque-style)."""
        for name in self._order:
            q = self._queues[name]
            if q:
                return q.popleft()
        raise IndexError("pop from an empty ClassQueues")

    def shed_lowest(self):
        """Remove and return the YOUNGEST queued request of the LOWEST
        priority non-empty class (rung 4's victim: the work least likely
        to be missed, losing the least queue wait), or None."""
        for name in reversed(self._order):
            q = self._queues[name]
            if q:
                return q.pop()
        return None

    def remove(self, req) -> None:
        """Remove ``req`` from its class queue (ValueError if absent)."""
        self._queues[req.cls].remove(req)

    def clear(self) -> None:
        """Drop every queued request (deque-compatible)."""
        for q in self._queues.values():
            q.clear()

    def depth(self, cls: str) -> int:
        """Queued requests of ``cls`` only (``len()`` sums all classes)."""
        return len(self._queues[cls])

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def __bool__(self) -> bool:
        return any(self._queues.values())

    def __iter__(self):
        for name in self._order:
            yield from self._queues[name]

    def __getitem__(self, i):
        if i == 0:
            for name in self._order:
                if self._queues[name]:
                    return self._queues[name][0]
            raise IndexError("empty ClassQueues")
        return list(self)[i]


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Degradation-ladder thresholds (hysteresis keeps rungs from
    flapping).  ``high_water``/``low_water`` bound the combined pressure
    signal — max of pool pressure (distinct live pages over mapped) and
    queue pressure (total depth over ``queue_soft_limit``).  A rung
    engages after ``engage_after`` consecutive high observations and
    releases after ``release_after`` consecutive low ones — one rung per
    crossing, so the ladder moves MONOTONICALLY with sustained pressure
    (the hypothesis property in tests/test_traffic.py)."""

    high_water: float = 0.85
    low_water: float = 0.60
    engage_after: int = 3
    release_after: int = 6
    queue_soft_limit: int = 16


class DegradationLadder:
    """Sustained-pressure state machine over the four rungs (module
    docstring).  ``observe()`` folds one pressure sample and returns the
    (possibly unchanged) level; the SCHEDULER applies what each level
    means.  Levels: 0 none, 1 chunk-budget shrink, 2 +drafts off,
    3 +prefix cache evicted, 4 +shed lowest-class queued work."""

    NUM_RUNGS = 4

    def __init__(self, config: LadderConfig | None = None):
        self.config = config or LadderConfig()
        self.level = 0
        self._hot = 0
        self._cold = 0

    def observe(self, pressure: float) -> int:
        """Fold one pressure sample; returns the (possibly unchanged)
        level.  Moves at most ONE rung per threshold crossing — sustained
        pressure climbs the ladder monotonically, sustained calm walks it
        back down in reverse."""
        cfg = self.config
        if pressure >= cfg.high_water:
            self._hot += 1
            self._cold = 0
            if self._hot >= cfg.engage_after and self.level < self.NUM_RUNGS:
                self.level += 1
                self._hot = 0
        elif pressure <= cfg.low_water:
            self._cold += 1
            self._hot = 0
            if self._cold >= cfg.release_after and self.level > 0:
                self.level -= 1
                self._cold = 0
        else:
            self._hot = 0
            self._cold = 0
        return self.level


def _victim_youngest(sched, cands):
    """PR 4's policy: least committed work lost (LIFO)."""
    return min(cands, key=lambda r: r.committed)


def _victim_deadline(sched, cands):
    """Deadline-aware: evict the request that can best AFFORD a restart —
    no deadline at all first, then the most slack (time to deadline minus
    the speed model's estimate of remaining work), ties broken youngest.
    Requests already past their deadline sort as infinite slack too: their
    SLO is lost either way, so their pages should fund one that can still
    make it."""
    spt = sched.sec_per_token or 0.0
    now = sched.clock()

    def slack(r):
        if r.deadline is None:
            return float("inf")
        remaining = r.deadline - now
        if remaining <= 0:
            return float("inf")
        return remaining - (r.target_len - r.committed) * spt

    return max(cands, key=lambda r: (slack(r), -r.committed))


#: name -> callable(scheduler, candidates) -> Request.  ``Scheduler``'s
#: ``victim_policy=`` kwarg accepts these names or any callable with the
#: same signature (the pluggable seam ROADMAP item 4 asks for).
VICTIM_POLICIES = {
    "youngest": _victim_youngest,
    "deadline": _victim_deadline,
}

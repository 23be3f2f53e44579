"""Engine counters with a single owner per field.

``EngineStats`` used to be a bag of public fields mutated from three call
sites (the engine's decode loop, the release machinery and the sharing
layer), which made double-counting a standing hazard for any refactor.  All
updates now go through ``record_*`` methods and the layered stack
(scheduler / kv_manager / runner) never assigns a field directly — enforced
by a lint-style test in ``tests/test_layering.py``, while the existing
host-mirror exactness tests (``warnings_fired == pool.clock``) prove no
path double-counts.

``warnings_fired`` doubles as the host mirror of the device pool's
reclamation clock: :meth:`EngineStats.record_warning` is the ONE place the
mirror ticks, and it must be called exactly when (and only when) a device
batch performed at least one zero-transition free, release or remap-visible
reclamation — the same once-per-batch rule the pool's ``clock`` follows.
"""

from __future__ import annotations

import dataclasses
import random

from repro_torch.core.allocator import AllocatorView
from repro_torch.core.vm import ReleaseStrategy


class LatencyReservoir:
    """Fixed-size uniform reservoir for streaming latency percentiles.

    Algorithm R (Vitter): the first ``cap`` samples are kept verbatim, each
    later sample replaces a uniformly random slot with probability
    ``cap/seen``.  Deterministic via a seeded private ``random.Random`` so
    benchmark gates are replayable.  Host-only, O(cap) memory regardless of
    trace length; percentiles are nearest-rank over the sorted sample."""

    def __init__(self, cap: int = 1024, seed: int = 0):
        self.cap = cap
        self.seen = 0
        self.samples: list[float] = []
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        """Fold one observation in (class docstring: Algorithm R)."""
        self.seen += 1
        if len(self.samples) < self.cap:
            self.samples.append(value)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.cap:
                self.samples[j] = value

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile of the held sample (``q`` in [0, 100]);
        0.0 when empty so gate arithmetic never trips on a quiet class."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        rank = max(0, min(len(s) - 1, int(round(q / 100.0 * len(s))) - 1))
        if q <= 0:
            rank = 0
        return s[rank]

    def merge_from(self, other: "LatencyReservoir") -> None:
        """Fold another reservoir in (fleet aggregation): concatenate then
        deterministically downsample back to cap via the seeded RNG."""
        self.seen += other.seen
        self.samples.extend(other.samples)
        while len(self.samples) > self.cap:
            self.samples.pop(self._rng.randrange(len(self.samples)))


@dataclasses.dataclass
class ClassStats:
    """Per-request-class accounting: lifecycle counters plus streaming
    TTFT and inter-token-latency reservoirs (host-only — nothing here
    touches the device or adds a sync)."""

    name: str
    submitted: int = 0
    finished: int = 0
    shed: int = 0
    rejected: int = 0
    ttft: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir)
    itl: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir)

    def percentiles(self) -> dict[str, float]:
        """p50/p95/p99 of both reservoirs (0.0 for a quiet class)."""
        return {
            "ttft_p50": self.ttft.percentile(50),
            "ttft_p95": self.ttft.percentile(95),
            "ttft_p99": self.ttft.percentile(99),
            "itl_p50": self.itl.percentile(50),
            "itl_p95": self.itl.percentile(95),
            "itl_p99": self.itl.percentile(99),
        }

    def summary(self) -> dict:
        """Lifecycle counters + percentiles as one JSON-ready dict."""
        out = {"submitted": self.submitted, "finished": self.finished,
               "shed": self.shed, "rejected": self.rejected}
        out.update(self.percentiles())
        return out


@dataclasses.dataclass
class EngineStats:
    """Serving counters mirroring the paper's (warnings, restarts, reclaimed)
    plus the superblock, sharing and chunked-prefill layers' accounting.
    Mutate only through the ``record_*`` methods (single-owner contract)."""

    steps: int = 0
    tokens_committed: int = 0
    preemptions: int = 0
    reader_restarts: int = 0
    warnings_fired: int = 0  # host mirror of the pool's reclamation clock
    pages_reclaimed: int = 0
    wall_seconds: float = 0.0
    tokens_per_second: float = 0.0
    # superblock / physical-release accounting (paper §3.2, device edition);
    # refreshed wholesale from the allocator's AllocatorView — the engine no
    # longer keeps its own copies of the anchor counters
    superblocks_resident: int = 0
    superblocks_mapped: int = 0
    superblocks_released: int = 0
    superblocks_remapped: int = 0
    mapped_pages: int = 0
    release_strategy: str = ReleaseStrategy.KEEP.value
    # prefix-sharing / refcount accounting
    pages_allocated: int = 0
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    cow_copies: int = 0
    prefix_cache_pages: int = 0
    prefix_evictions: int = 0
    # chunked-prefill / TTFT accounting (per-request detail on Request)
    ttft_requests: int = 0
    mean_ttft_steps: float = 0.0
    mean_ttft_seconds: float = 0.0
    chunked_steps: int = 0
    prefill_tokens_chunked: int = 0
    # speculative decoding accounting (draft-and-verify, the sequence-axis
    # OA validate/commit); accept_rate is the running tokens_accepted /
    # tokens_drafted, draft_k the live AIMD cap (a gauge, not a counter)
    tokens_drafted: int = 0
    tokens_accepted: int = 0
    accept_rate: float = 0.0
    draft_k: int = 0
    spec_steps: int = 0  # dispatches that ran the speculative executable
    # robustness / self-healing accounting (chaos layer, PR 6)
    grant_denials: int = 0  # admission allocs the pool (or chaos) refused
    grant_retries: int = 0  # bounded plain retries those denials consumed
    requests_shed: int = 0  # rejected AT ADMISSION for a hopeless deadline
    requests_migrated: int = 0  # requeued onto this replica from a dead one
    replica_failures: int = 0  # this replica died or stalled mid-run
    replica_revivals: int = 0  # fresh engines re-admitted after a failure
    # reclamation-policy accounting (core/reclaim_policy.py): which backend
    # is live and how many fused steps ran vs elided the OA validation pass
    reclaim_policy: str = "oa-validate"
    validation_passes: int = 0
    validation_skipped: int = 0
    # backpressure gauges (latest observation, not counters): pool pressure
    # is distinct-live-pages over mapped capacity, aimd_ratio the chunk
    # budget cap over its configured chunk (1.0 = no backoff in force)
    pool_pressure: float = 0.0
    aimd_ratio: float = 1.0
    queue_depth: int = 0
    # overload / multi-tenant accounting (serving/overload.py): per-class
    # lifecycle + tail-latency reservoirs, bounded-queue rejections, and the
    # graceful-degradation ladder (level is a gauge; engagements/releases/
    # sheds are counters so a rung that flaps still leaves a trace)
    class_stats: dict = dataclasses.field(default_factory=dict)
    requests_rejected: int = 0  # bounded admission queue was full
    degradation_level: int = 0  # live ladder rung (0 = healthy)
    degradation_level_peak: int = 0  # highest rung reached (high-water mark)
    ladder_engagements: int = 0
    ladder_releases: int = 0
    ladder_sheds: int = 0  # queued work dropped by rung 4

    # -- the decode loop ----------------------------------------------------

    def record_step(self, chunked: bool = False) -> None:
        """One dispatch completed (``chunked``: the C>1 executable ran)."""
        self.steps += 1
        if chunked:
            self.chunked_steps += 1

    def record_commit(self, n: int, chunked_prefill: bool = False) -> None:
        """``n`` tokens committed by one row (``chunked_prefill``: they were
        prompt tokens advanced by a C>1 chunk)."""
        self.tokens_committed += n
        if chunked_prefill:
            self.prefill_tokens_chunked += n

    def record_preemption(self) -> None:
        """A running request was optimistically reclaimed and requeued."""
        self.preemptions += 1

    def record_restart(self) -> None:
        """A row failed OA validation (page reclaimed under its snapshot)."""
        self.reader_restarts += 1

    def _class(self, cls: str) -> ClassStats:
        cs = self.class_stats.get(cls)
        if cs is None:
            cs = self.class_stats[cls] = ClassStats(cls)
        return cs

    def record_ttft(self, steps: int, seconds: float,
                    cls: str | None = None) -> None:
        """A request produced its first token; fold into the running means
        (and, when the request carries a class, its class reservoir)."""
        self.ttft_requests += 1
        self.mean_ttft_steps += (steps - self.mean_ttft_steps) / self.ttft_requests
        self.mean_ttft_seconds += (
            (seconds - self.mean_ttft_seconds) / self.ttft_requests)
        if cls is not None:
            self._class(cls).ttft.add(seconds)

    def record_itl(self, cls: str, seconds: float) -> None:
        """One inter-token gap observed for a running request of ``cls``."""
        self._class(cls).itl.add(seconds)

    def record_class_submit(self, cls: str) -> None:
        """A request of ``cls`` was accepted into the admission queue."""
        self._class(cls).submitted += 1

    def record_class_finish(self, cls: str) -> None:
        """A request of ``cls`` finished (reached its target length)."""
        self._class(cls).finished += 1

    def record_wall(self, seconds: float) -> None:
        """A drain loop finished; derive throughput from committed tokens."""
        self.wall_seconds = seconds
        self.tokens_per_second = (
            self.tokens_committed / seconds if seconds > 0 else 0.0)

    def record_speculation(self, drafted: int, accepted: int) -> None:
        """One VALID speculative row verified ``drafted`` draft tokens and
        accepted ``accepted`` of them; refresh the running accept rate."""
        self.tokens_drafted += drafted
        self.tokens_accepted += accepted
        if self.tokens_drafted:
            self.accept_rate = self.tokens_accepted / self.tokens_drafted

    def record_spec_step(self, draft_k: int) -> None:
        """One dispatch ran the speculative executable; ``draft_k`` is the
        AIMD cap in force (gauge — latest observation wins)."""
        self.spec_steps += 1
        self.draft_k = draft_k

    def record_validation(self, ran: bool) -> None:
        """One fused step retired; it either ran the OA validation pass
        (``ran``) or the reclamation policy elided it."""
        if ran:
            self.validation_passes += 1
        else:
            self.validation_skipped += 1

    def record_policy(self, name: str) -> None:
        """Pin which reclamation backend this engine runs (a label, set
        once at engine build)."""
        self.reclaim_policy = name

    # -- reclamation (the OA warning channel) -------------------------------

    def record_warning(self) -> None:
        """ONE reclamation batch hit a zero-transition: tick the clock
        mirror.  Must stay in lockstep with ``pool.clock`` — the host-mirror
        exactness tests compare the two after every workload."""
        self.warnings_fired += 1

    def record_reclaimed(self, pages: int) -> None:
        """``pages`` page references hit zero and re-entered circulation."""
        self.pages_reclaimed += pages

    # -- allocation / sharing ------------------------------------------------

    def record_grants(self, pages: int) -> None:
        """``pages`` fresh device grants landed (incl. COW copies)."""
        self.pages_allocated += pages

    def record_cow(self) -> None:
        """A divergent write was resolved by a fused page copy."""
        self.cow_copies += 1

    def record_prefix_hit(self, tokens: int) -> None:
        """An admission matched a resident prefix covering ``tokens``."""
        self.prefix_hits += 1
        self.prefix_tokens_reused += tokens

    def record_eviction(self) -> None:
        """One prefix-cache entry was evicted (pressure or cap)."""
        self.prefix_evictions += 1

    def record_cache_pages(self, n: int) -> None:
        """The donation index now pins ``n`` pages."""
        self.prefix_cache_pages = n

    # -- robustness / self-healing -------------------------------------------

    def record_grant_denial(self) -> None:
        """An admission alloc was refused (pool exhausted or chaos-injected)."""
        self.grant_denials += 1

    def record_grant_retry(self) -> None:
        """A denied admission grant was retried within the bounded budget."""
        self.grant_retries += 1

    def record_shed(self, cls: str | None = None,
                    by_ladder: bool = False) -> None:
        """A QUEUED request was dropped: hopeless deadline at admission, or
        rung 4 of the degradation ladder (``by_ladder``)."""
        self.requests_shed += 1
        if by_ladder:
            self.ladder_sheds += 1
        if cls is not None:
            self._class(cls).shed += 1

    def record_rejection(self, cls: str | None = None) -> None:
        """``submit`` refused a request outright: its class queue is at its
        bound (explicit backpressure, never silent unbounded growth)."""
        self.requests_rejected += 1
        if cls is not None:
            self._class(cls).rejected += 1

    def record_ladder(self, level: int) -> None:
        """The degradation ladder moved to ``level`` (gauge + direction
        counters; call only on transitions)."""
        if level > self.degradation_level:
            self.ladder_engagements += 1
        elif level < self.degradation_level:
            self.ladder_releases += 1
        self.degradation_level = level
        self.degradation_level_peak = max(self.degradation_level_peak, level)

    def record_migration(self) -> None:
        """A request from a dead replica was requeued onto this one."""
        self.requests_migrated += 1

    def record_replica_failure(self) -> None:
        """This replica died or stalled; the watchdog failed it over."""
        self.replica_failures += 1

    def record_revival(self) -> None:
        """A failed replica slot was re-admitted with a fresh engine."""
        self.replica_revivals += 1

    def record_backpressure(self, pressure: float, aimd: float,
                            queue_depth: int) -> None:
        """Refresh the backpressure gauges callers throttle on (latest
        observation wins; these are levels, not counters)."""
        self.pool_pressure = pressure
        self.aimd_ratio = aimd
        self.queue_depth = queue_depth

    # -- superblock anchors --------------------------------------------------

    def record_superblocks(self, view: AllocatorView) -> None:
        """Refresh the anchor mirrors from the allocator's own view — the
        single source for the accounting the engine used to duplicate."""
        self.superblocks_resident = view.superblocks_total
        self.superblocks_mapped = view.superblocks_mapped
        self.superblocks_released = view.superblocks_released
        self.superblocks_remapped = view.superblocks_remapped
        self.mapped_pages = view.pages_mapped
        self.release_strategy = view.release_strategy


def aggregate_stats(parts: list[EngineStats],
                    wall_seconds: float | None = None) -> EngineStats:
    """Sum per-replica ``EngineStats`` into one fleet-wide view.

    Counters add; TTFT means weight by each replica's request count; with
    ``wall_seconds`` given (the parallel driver's wall clock) throughput is
    total tokens over THAT wall — replicas run concurrently, so summing
    their individual rates would overstate a serial fleet and understate an
    overlapped one.  Superblock anchors add across pools (each replica owns
    an independent arena)."""
    total = EngineStats()
    for s in parts:
        total.steps += s.steps
        total.tokens_committed += s.tokens_committed
        total.preemptions += s.preemptions
        total.reader_restarts += s.reader_restarts
        total.warnings_fired += s.warnings_fired
        total.pages_reclaimed += s.pages_reclaimed
        total.superblocks_resident += s.superblocks_resident
        total.superblocks_mapped += s.superblocks_mapped
        total.superblocks_released += s.superblocks_released
        total.superblocks_remapped += s.superblocks_remapped
        total.mapped_pages += s.mapped_pages
        total.pages_allocated += s.pages_allocated
        total.prefix_hits += s.prefix_hits
        total.prefix_tokens_reused += s.prefix_tokens_reused
        total.cow_copies += s.cow_copies
        total.prefix_cache_pages += s.prefix_cache_pages
        total.prefix_evictions += s.prefix_evictions
        total.chunked_steps += s.chunked_steps
        total.prefill_tokens_chunked += s.prefill_tokens_chunked
        total.tokens_drafted += s.tokens_drafted
        total.tokens_accepted += s.tokens_accepted
        total.spec_steps += s.spec_steps
        # draft_k is a gauge: report the most aggressive live cap
        total.draft_k = max(total.draft_k, s.draft_k)
        total.validation_passes += s.validation_passes
        total.validation_skipped += s.validation_skipped
        total.grant_denials += s.grant_denials
        total.grant_retries += s.grant_retries
        total.requests_shed += s.requests_shed
        total.requests_migrated += s.requests_migrated
        total.replica_failures += s.replica_failures
        total.replica_revivals += s.replica_revivals
        # gauges: the fleet is as pressured as its WORST replica, as backed
        # off as its most-throttled one; queue depth adds
        total.pool_pressure = max(total.pool_pressure, s.pool_pressure)
        total.aimd_ratio = min(total.aimd_ratio, s.aimd_ratio)
        total.queue_depth += s.queue_depth
        total.requests_rejected += s.requests_rejected
        total.ladder_engagements += s.ladder_engagements
        total.ladder_releases += s.ladder_releases
        total.ladder_sheds += s.ladder_sheds
        total.degradation_level = max(total.degradation_level,
                                      s.degradation_level)
        total.degradation_level_peak = max(total.degradation_level_peak,
                                           s.degradation_level_peak)
        for name, cs in s.class_stats.items():
            tc = total._class(name)
            tc.submitted += cs.submitted
            tc.finished += cs.finished
            tc.shed += cs.shed
            tc.rejected += cs.rejected
            tc.ttft.merge_from(cs.ttft)
            tc.itl.merge_from(cs.itl)
        if s.ttft_requests:
            n = total.ttft_requests + s.ttft_requests
            total.mean_ttft_steps += (
                (s.mean_ttft_steps - total.mean_ttft_steps)
                * s.ttft_requests / n)
            total.mean_ttft_seconds += (
                (s.mean_ttft_seconds - total.mean_ttft_seconds)
                * s.ttft_requests / n)
            total.ttft_requests = n
    if total.tokens_drafted:
        total.accept_rate = total.tokens_accepted / total.tokens_drafted
    if parts:
        total.release_strategy = parts[0].release_strategy
        total.reclaim_policy = parts[0].reclaim_policy
    wall = (max((s.wall_seconds for s in parts), default=0.0)
            if wall_seconds is None else wall_seconds)
    total.record_wall(wall)
    return total

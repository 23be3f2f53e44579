"""Data-parallel multi-pool serving: N engines, one router, self-healing.

The port of ``repro.serving.parallel``: the same router, drive modes,
watchdog, migration and revival.  A replica is exactly one
:class:`~repro_torch.serving.engine.PagedServingEngine` — its own
:class:`~repro_torch.core.pagepool.DevicePagePool`, KV arena, manager and
runner, placed on its own ``torch.device`` (``cuda:0`` … ``cuda:n-1`` by
default; a device may repeat, so ``devices=["cuda:0", "cuda:0"]`` puts two
replicas on one card and ``["cpu", "cpu"]`` is the CPU tests' fleet).
Nothing is shared between pools but read-only weights — no page id ever
crosses a replica boundary (``tests/test_torch_parallel.py`` checks
conservation per pool) — so the OA invariants hold per replica by
construction and each pool releases its own EMPTY superblocks on its own
quiescence clock.

The router is pure scheduler-layer arithmetic: a request goes to the
replica whose prefix index matches the most prompt tokens (cache affinity
— sharing only pays inside one pool), ties broken by pool pressure (the
scheduler's outstanding-token ``load`` plus distinct live pages).

Two drive modes:

- :meth:`DataParallelEngine.step` — enqueue EVERY replica's fused step
  before collecting any (CUDA work is asynchronous, so device work
  overlaps while the host loops); deterministic and single-threaded, used
  by the interleaving tests and by launch counts.
- :meth:`DataParallelEngine.run` — one driver thread per replica running
  its own admit/step/maintain loop.  Python releases the GIL while a
  thread blocks on its replica's read back, so N replicas keep N devices
  busy.  Each thread makes its replica's device current (the current CUDA
  device is per thread); replicas on one card share its default stream,
  where their work runs in the order it was enqueued.

**Self-healing.**  With a :class:`WatchdogConfig`, :meth:`run` becomes a
supervised loop: every driver thread updates a per-replica heartbeat each
iteration, and the main thread watches for (a) a thread that died with an
exception and (b) a heartbeat stale past the stall timeout.  Either marks
the replica DEAD and triggers failover: all surviving workers park at a
safe point (between steps), the dead replica's queued AND in-flight
requests are re-routed onto survivors — a migrated request replays its
already-generated tokens as prompt through the chunked-prefill path, so
greedy decoding makes the stitched output token-exact
(``Request.output_tokens``) — and, with ``auto_revive``, the dead slot
gets a fresh engine (the kernels are already loaded, so revival builds
nothing) and the backlog is rebalanced over the enlarged fleet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch

from .engine import PagedServingEngine
from .scheduler import Request
from .stats import EngineStats, aggregate_stats


def _current(device):
    """A context that makes ``device`` the thread's current CUDA device (a
    no-op for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ReplicaStalled(RuntimeError):
    """A replica's heartbeat went stale past the watchdog's stall timeout
    (hung device call, livelocked driver, …) and it was failed over."""


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Replica health-watchdog knobs for :meth:`DataParallelEngine.run`.

    ``stall_timeout`` — seconds without a heartbeat before a replica is
    declared stalled.  ``poll_interval`` — how often the supervisor checks.
    ``max_failovers`` — upper bound on failover rounds per :meth:`run`
    (prevents a persistent fault from looping forever).  ``auto_revive`` —
    replace a dead replica with a fresh engine and rebalance the backlog.
    ``join_timeout`` — seconds to wait for surviving workers to park at a
    safe point before treating them as stalled too."""

    stall_timeout: float = 30.0
    poll_interval: float = 0.02
    max_failovers: int = 8
    auto_revive: bool = False
    join_timeout: float = 60.0


class DataParallelEngine:
    """N independent pool+runner replicas behind one prefix-affine,
    pressure-balancing router, optionally supervised by a replica health
    watchdog (module docstring)."""

    def __init__(self, cfg, params, *, replicas: int = 2, devices=None,
                 tensor_parallel: int = 1,
                 watchdog: WatchdogConfig | None = None, **engine_kwargs):
        if replicas < 1:
            raise ValueError("need at least one replica")
        if devices is None:
            # the port's device rule: every card, or an error — never the CPU
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass devices=['cpu', ...] "
                    "to run the fleet on the CPU")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = list(devices)
        self._ctor = (cfg, params)
        self._devices = devices
        # 2D replica x tensor fleets: replica i owns the device slice
        # [i*tp, (i+1)*tp) as its private serving mesh — the
        # tensor axis lives INSIDE each engine, the replica axis stays this
        # router's concern, and no mesh spans two replicas (failure domains
        # and page-id spaces remain per-replica, exactly as at tp=1)
        self.tensor_parallel = int(tensor_parallel)
        if self.tensor_parallel > 1 and \
                len(devices) < replicas * self.tensor_parallel:
            raise RuntimeError(
                f"2D fleet needs replicas*tp = {replicas * self.tensor_parallel}"
                f" devices; have {len(devices)}")
        self._engine_kwargs = dict(engine_kwargs)
        self.watchdog = watchdog
        self.replicas = [
            PagedServingEngine(cfg, params, **self._placement_for(i),
                               **self._engine_kwargs_for(i))
            for i in range(replicas)
        ]
        self.alive = [True] * replicas
        # per-replica callable(engine) invoked once per driver iteration —
        # the chaos tests' injection point for kills and stalls
        self.step_hooks: list = [None] * replicas
        self._retired: list[EngineStats] = []  # stats of replaced engines
        self._wall = 0.0

    def _placement_for(self, i: int) -> dict:
        """Replica ``i``'s device placement kwargs: one device (tp=1, the
        classic fleet) or its private tp-wide slice of the device list (the
        2D replica x tensor fleet)."""
        tp = self.tensor_parallel
        if tp <= 1:
            return {"device": self._devices[i % len(self._devices)]}
        return {"tensor_parallel": tp,
                "devices": self._devices[i * tp:(i + 1) * tp]}

    def _engine_kwargs_for(self, i: int) -> dict:
        """Per-replica engine kwargs: a shared chaos config gets its seed
        offset by the replica index, so fault schedules are INDEPENDENT
        across the fleet (same seed would correlate every replica's rng
        stream) while staying deterministic — including after a revive."""
        kw = dict(self._engine_kwargs)
        chaos = kw.get("chaos")
        if chaos is not None:
            kw["chaos"] = dataclasses.replace(chaos, seed=chaos.seed + i)
        policy = kw.get("reclaim_policy")
        if policy is not None and not isinstance(policy, str):
            # a ReclamationPolicy INSTANCE is stateful and wraps exactly one
            # allocator — replicas (and revivals) must each build their own,
            # so only the NAME fans out across the fleet
            kw["reclaim_policy"] = policy.name
        return kw

    # -- routing -------------------------------------------------------------

    def route(self, prompt: list[int]) -> int:
        """Pick the replica for ``prompt``: longest prefix-cache match
        first (KV sharing only pays inside one pool), then least pool
        pressure — the scheduler's outstanding-token load with distinct
        live pages as the tiebreak.  Pure host arithmetic on scheduler
        state; never touches a device.  Dead replicas are skipped."""
        best, best_key = None, None
        for i, eng in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            sched = eng.scheduler
            m = sched.index.match(prompt)[0] if sched.prefix_cache else 0
            key = (-m, sched.load(), sched.distinct_pages_in_use(), i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        if best is None:
            raise RuntimeError("no live replica to route to")
        return best

    def submit(self, prompt: list[int], max_new_tokens: int,
               deadline: float | None = None, cls: str = "interactive",
               block: bool = False) -> Request:
        """Route and queue one request; returns the replica's Request
        handle (its ``_engine`` back-reference names the owning replica,
        which is how the tests pin no-cross-pool-leakage).  ``cls`` and
        ``block`` pass through to the replica's bounded-queue admission."""
        return self.replicas[self.route(prompt)].submit(
            prompt, max_new_tokens, deadline=deadline, cls=cls, block=block)

    # -- stepping ------------------------------------------------------------

    def step(self) -> None:
        """One interleaved step across all live replicas: admit everywhere,
        ENQUEUE every replica's fused step, then collect each single read
        back — per-replica sync-freedom is preserved (still one transfer
        per replica per step, asserted in tests/test_torch_parallel.py)
        and device work overlaps across pools while the host loops."""
        live = [e for i, e in enumerate(self.replicas) if self.alive[i]]
        for eng in live:
            eng.scheduler.admit()
        handles = [eng.launch_step() for eng in live]
        for eng, handle in zip(live, handles):
            eng.collect_step(handle)
        for eng in live:
            eng.scheduler.maintain()

    def drained(self) -> bool:
        """True when no live replica holds queued or running work."""
        return all(not e.scheduler.queue and not e.scheduler.running
                   for i, e in enumerate(self.replicas) if self.alive[i])

    # -- the supervised drain loop -------------------------------------------

    def run(self, max_steps: int = 10_000) -> EngineStats:
        """Drain every replica with one driver thread each (the GIL is
        released while a thread blocks on its replica's read back, so the
        fused steps genuinely overlap across devices).  Returns the
        aggregated fleet stats over THIS call's wall clock.

        Without a watchdog this is one supervised round: worker exceptions
        stop the fleet promptly (survivors park at the next safe point,
        joined WITH a timeout) and the first error propagates — a raising
        replica can no longer hang the join.  With a watchdog, an error or
        stall instead triggers failover + migration and the loop starts
        another round on the survivors (bounded by ``max_failovers``)."""
        t0 = time.time()
        rounds = 1 + (self.watchdog.max_failovers if self.watchdog else 0)
        try:
            for _ in range(rounds):
                if not self._drive_round(max_steps):
                    break
        finally:
            self._wall = time.time() - t0
        return self.stats

    def _drive_round(self, max_steps: int) -> bool:
        """One supervised round: drive every live replica that has work to
        a clean drain, a failure, or a stall.  Returns True iff a failover
        happened and the backlog needs another round."""
        wd = self.watchdog
        workers = [i for i in range(len(self.replicas))
                   if self.alive[i] and (self.replicas[i].scheduler.queue
                                         or self.replicas[i].scheduler.running)]
        if not workers:
            return False
        hb = {i: time.monotonic() for i in workers}
        stop = {i: threading.Event() for i in workers}
        errors: dict[int, BaseException] = {}
        threads = {
            i: threading.Thread(target=self._drive,
                                args=(i, hb, stop, errors, max_steps),
                                daemon=True)
            for i in workers
        }
        for t in threads.values():
            t.start()
        poll = wd.poll_interval if wd else 0.01
        while any(t.is_alive() for t in threads.values()):
            time.sleep(poll)
            if wd is None:
                if errors:  # fail fast: park survivors, propagate below
                    for ev in stop.values():
                        ev.set()
                    break
                continue
            now = time.monotonic()
            for i in [j for j, t in threads.items() if t.is_alive()]:
                if now - hb[i] > wd.stall_timeout:
                    # the thread may be wedged in a device call forever:
                    # flag it, record the stall, and ABANDON it — if it
                    # ever wakes it sees its stop event before touching
                    # the (by then migrated) requests
                    stop[i].set()
                    errors[i] = ReplicaStalled(
                        f"replica {i}: no heartbeat for "
                        f"{now - hb[i]:.1f}s (> {wd.stall_timeout}s)")
                    del threads[i]
        join_timeout = wd.join_timeout if wd else 60.0
        for i, t in list(threads.items()):
            t.join(timeout=join_timeout)
            if t.is_alive():  # refused to park: treat as stalled
                stop[i].set()
                errors.setdefault(i, ReplicaStalled(
                    f"replica {i}: did not park within {join_timeout}s"))
        failed = sorted(errors)
        if not failed:
            return False
        if wd is None:
            raise errors[failed[0]]
        for i in failed:
            self._fail_over(i, errors[i])
        return True

    def _drive(self, i: int, hb: dict, stop: dict, errors: dict,
               max_steps: int) -> None:
        """Driver-thread body for replica ``i``: the engine's own
        admit/step/maintain drain loop, with a heartbeat write, the chaos
        step hook and a safe-point stop check at the top of every
        iteration.  Exceptions land in ``errors`` for the supervisor.  The
        replica's device is made current for the thread (CUDA's current
        device is per thread, and the kernels size themselves for it)."""
        eng = self.replicas[i]
        t0 = time.time()
        try:
            with _current(eng.device):
                for _ in range(max_steps):
                    hb[i] = time.monotonic()
                    hook = self.step_hooks[i]
                    if hook is not None:
                        hook(eng)
                    if stop[i].is_set():
                        return  # supervisor parked the fleet at a safe point
                    eng.scheduler.admit()
                    if not eng.scheduler.running and not eng.scheduler.queue:
                        break
                    if not eng.scheduler.running:  # queue blocked on memory
                        raise MemoryError(
                            "pool exhausted with empty running set")
                    eng.step()
                    eng.scheduler.maintain()
                if eng.scheduler.release_quiescence is not None:
                    eng.shrink()  # drain: park the now-idle superblocks
            eng.stats.record_wall(time.time() - t0)
        except BaseException as exc:  # the supervisor owns the response
            errors[i] = exc

    # -- failover ------------------------------------------------------------

    def _fail_over(self, i: int, err: BaseException) -> None:
        """Replica ``i`` died (``err``): mark it dead, migrate its queued
        and in-flight requests onto survivors, and — with ``auto_revive`` —
        re-admit a fresh engine in its slot and rebalance the backlog.
        Raises ``err`` when no survivor is left to absorb the work."""
        self.alive[i] = False
        eng = self.replicas[i]
        eng.stats.record_replica_failure()
        if not any(self.alive):
            raise err
        doomed = list(eng.scheduler.running) + list(eng.scheduler.queue)
        eng.scheduler.running.clear()
        eng.scheduler.queue.clear()
        for req in doomed:
            self._migrate(req)
        if self.watchdog and self.watchdog.auto_revive:
            self.revive(i)
            self._rebalance()

    def _migrate(self, req: Request) -> None:
        """Re-route one request from a dead replica using committed-token
        state: tokens it already generated are folded into the prompt
        (``migrated_prefix`` keeps them visible as output), so the survivor
        re-prefills them through the chunked path — cheap, and token-exact
        under greedy decoding.  Device-side state on the dead replica is
        simply abandoned; no page id crosses the pool boundary."""
        if req.generated:
            req.migrated_prefix.extend(req.generated)
            req.prompt = req.prompt + req.generated
            req.max_new_tokens -= len(req.generated)
            req.generated = []
        req.migrations += 1
        req.committed = 0
        req.slot = None
        req.pages_held = 0
        req.shared_held = 0
        req.shared_chain = {}
        req.externally_reclaimed = False
        if req.max_new_tokens <= 0:  # nothing left to generate
            req.state = "finished"
            return
        req.state = "queued"
        tgt = self.replicas[self.route(req.prompt)]
        req._engine = tgt
        tgt.scheduler.queue.append(req)
        tgt.stats.record_migration()

    def revive(self, i: int) -> PagedServingEngine:
        """Replace dead replica ``i`` with a fresh engine on the same
        device and mark it live again.  The kernels are loaded once per
        process, so this builds nothing; the old engine's counters are
        retired into the fleet aggregate."""
        assert not self.alive[i], "revive() is for dead replicas"
        cfg, params = self._ctor
        self._retired.append(self.replicas[i].stats)
        self.replicas[i] = PagedServingEngine(
            cfg, params, **self._placement_for(i),
            **self._engine_kwargs_for(i))
        self.alive[i] = True
        self.replicas[i].stats.record_revival()
        return self.replicas[i]

    def _rebalance(self) -> None:
        """Spread every QUEUED (never running) request across the live
        fleet through the router — after a revival the fresh replica is
        idle and should take its share of the backlog.  Called only
        between rounds, when no driver thread is running."""
        pending: list[Request] = []
        for j, e in enumerate(self.replicas):
            if self.alive[j]:
                pending.extend(e.scheduler.queue)
                e.scheduler.queue.clear()
        for req in pending:
            tgt = self.replicas[self.route(req.prompt)]
            req._engine = tgt
            tgt.scheduler.queue.append(req)

    # -- maintenance / introspection -----------------------------------------

    def shrink(self, keep_superblocks: int | None = None) -> int:
        """Per-replica physical release: every pool parks its own EMPTY
        superblocks above its own floor; returns the fleet total."""
        return sum(e.shrink(keep_superblocks)
                   for i, e in enumerate(self.replicas) if self.alive[i])

    @property
    def stats(self) -> EngineStats:
        """Aggregated fleet counters (per-replica stats summed, including
        engines retired by failover; throughput over the last
        :meth:`run`'s wall clock when one happened)."""
        return aggregate_stats(
            [e.stats for e in self.replicas] + self._retired,
            self._wall if self._wall > 0 else None)

    @property
    def per_replica_stats(self) -> list[EngineStats]:
        """Each current replica's own counters (the aggregate's inputs,
        minus retired engines)."""
        return [e.stats for e in self.replicas]

"""PagedServingEngine: the thin facade over the layered serving stack.

The port of ``repro.serving.engine``: the same constructor and surface,
with ``device=`` — ``"cuda"`` unless the caller asks for ``"cpu"``.
``tensor_parallel=T, devices=[...]`` serves on T shards
(``launch/mesh.py``): the engine splits the full parameters it is given by
``sharding/rules.py``, keeps one contiguous KV slab of Hkv/T heads per
shard (a head count T does not divide is a ``ValueError``: the reference's
replicated arena is not ported), and keeps the pool and per-slot state
once on the first device (the reference replicates them over its mesh).
Wiring and delegation over three layers with explicit contracts:

- :class:`repro_torch.serving.scheduler.Scheduler` — continuous-batching
  POLICY (admission, Sarathi budgets, AIMD backoff, victims, prefix index,
  quiescence release).  Pure host logic; imports no tensor framework.
- :class:`repro_torch.serving.kv_manager.KVCacheManager` — page/refcount/
  superblock MECHANICS and host mirrors; the only layer that talks to the
  allocator (:class:`repro_torch.core.pagepool.DevicePagePool`).
- :class:`repro_torch.serving.runner.ModelRunner` — the fused-step
  EXECUTOR owning the model and the one-transfer-per-step invariant.

The historical surface (``submit/step/run/shrink``, ``pool``, ``kv``,
``queue``, ``_admit`` …) delegates to the layer that now owns it.
"""

from __future__ import annotations

import time

from repro_torch.core.chaos import ChaosAllocator, ChaosConfig
from repro_torch.core.pagepool import DEFAULT_PAGES_PER_SUPERBLOCK, DevicePagePool
from repro_torch.core.reclaim_policy import ReclamationPolicy, make_policy
from repro_torch.core.vm import ReleaseStrategy
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.transformer import DecoderLM
from repro_torch.sharding.rules import param_shards
from .kv_manager import KVCacheManager
from .paged_decode import kv_storage_init
from .runner import ModelRunner
from .scheduler import Request, Scheduler  # noqa: F401  (re-export)
from .stats import EngineStats


class PagedServingEngine:
    """Continuous-batching LM serving on the refcounted, versioned page pool
    (module docstring; knobs match the historical constructor)."""

    #: names the reference's ``attn_impl`` takes; here the tensors' device
    #: picks the kernel (CUDA) or its plain version (CPU) whatever the name
    ATTN_IMPLS = ("ref", "interpret", "pallas", "cuda")

    def __init__(self, cfg, params, *, num_pages: int, page_size: int,
                 max_batch: int = 8, max_pages_per_seq: int | None = None,
                 attn_impl: str = "ref", greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 pages_per_compute_block: int = 1,
                 pages_per_superblock: int = DEFAULT_PAGES_PER_SUPERBLOCK,
                 release_strategy: ReleaseStrategy = ReleaseStrategy.MADVISE,
                 release_quiescence: int | str | None = None,
                 reclaim_policy: str | ReclamationPolicy | None = None,
                 min_mapped_superblocks: int = 1,
                 chaos: ChaosConfig | None = None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: int | None = None,
                 prefill_chunk: int = 1,
                 token_budget: int | None = None,
                 grant_retry_limit: int = 8,
                 speculative_k: int = 0,
                 drafter=None,
                 spec_probe_interval: int = 16,
                 classes: dict | None = None,
                 max_queue_depth: int | None = None,
                 victim_policy="youngest",
                 ladder=None,
                 clock=None,
                 device=None,
                 tensor_parallel: int = 1,
                 devices=None):
        if attn_impl not in self.ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; known: "
                             f"{self.ATTN_IMPLS}")
        self.cfg = cfg
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_batch = max_batch
        # tensor parallelism: a mesh of ``tensor_parallel`` shard devices;
        # weights split by sharding/rules.py, the KV arena by its head axis,
        # the pool and per-slot state once on the lead device — every shard
        # works from the same pool decisions: one logical pool, per-shard
        # payloads
        self.tensor_parallel = int(tensor_parallel)
        if self.tensor_parallel > 1:
            if device is not None:
                raise ValueError(
                    "tensor_parallel > 1 takes a `devices` list, not a "
                    "single `device`")
            self.mesh = make_serving_mesh(self.tensor_parallel, devices)
            self.device = self.mesh.lead
            # ``params``: full weights (a DecoderLM or its nested dicts),
            # split here as the reference's device_put with specs does
            self.params = tuple(DecoderLM(cfg, p) for p in
                                param_shards(cfg, params, self.mesh))
        else:
            self.mesh = None
            if device is None and devices:
                device = devices[0]
            self.device = resolve_device(device)
            # ``params``: a DecoderLM, or the nested dicts it is built from;
            # weights already on this device are shared (they are read-only:
            # a fleet's replicas on one card hold one copy)
            model = (params if isinstance(params, DecoderLM)
                     else DecoderLM(cfg, params))
            self.params = model.placed(self.device)
        self.stats = EngineStats()
        allocator = DevicePagePool(num_pages, pages_per_superblock,
                                   release_strategy, device=self.device)
        if chaos is not None:
            # fault injection wraps the PROTOCOL, not the pool: the whole
            # stack above sees denials/perturbations through the same
            # Allocator surface it always talks to (core/chaos.py)
            allocator = ChaosAllocator(allocator, chaos)
        # reclamation policy (core/reclaim_policy.py): a name, a ready
        # instance, or None (the RECLAIM_POLICY env var, default
        # oa-validate).  wrap() interposes OUTSIDE chaos so the interval
        # limbo defers the frees the fault schedule perturbs too.
        policy = (reclaim_policy
                  if isinstance(reclaim_policy, ReclamationPolicy)
                  else make_policy(reclaim_policy))
        self._reclaim_policy = policy
        self.stats.record_policy(policy.name)
        allocator = policy.wrap(allocator)
        self.stats.record_superblocks(allocator.view())
        self.kv_manager = KVCacheManager(
            allocator,
            kv=kv_storage_init(cfg, num_pages, page_size, device=self.device,
                               mesh=self.mesh),
            max_batch=max_batch,
            max_pages_per_seq=max_pages_per_seq or num_pages,
            page_size=page_size, stats=self.stats, device=self.device,
            mesh=self.mesh)
        self.runner = ModelRunner(
            cfg, self.params, greedy=greedy, temperature=temperature,
            seed=seed, pages_per_compute_block=pages_per_compute_block,
            mesh=self.mesh)
        self.scheduler = Scheduler(
            self.kv_manager, self.stats, num_pages=num_pages,
            page_size=page_size, max_batch=max_batch,
            prefix_cache=prefix_cache,
            prefix_cache_pages=prefix_cache_pages,
            prefill_chunk=prefill_chunk, token_budget=token_budget,
            release_quiescence=release_quiescence,
            min_mapped_superblocks=min_mapped_superblocks, engine=self,
            grant_retry_limit=grant_retry_limit, greedy=greedy,
            speculative_k=speculative_k, drafter=drafter,
            spec_probe_interval=spec_probe_interval,
            reclaim_policy=policy, classes=classes,
            max_queue_depth=max_queue_depth,
            victim_policy=victim_policy, ladder=ladder, clock=clock)

    # -- scheduling (delegates to the policy layer) --------------------------

    def submit(self, prompt: list[int], max_new_tokens: int,
               deadline: float | None = None, cls: str = "interactive",
               block: bool = False) -> Request:
        """Queue a request (host-only; rejects degenerate and over-capacity
        inputs; ``deadline`` in relative seconds enables admission-time
        shedding — see :meth:`Scheduler.submit`).

        When ``cls``'s bounded admission queue is full the request comes
        back with state ``"rejected"`` (explicit backpressure).  With
        ``block=True`` the engine instead drives admit/step/maintain rounds
        until the queue drains enough to accept it — the caller blocks, the
        queue still never grows past its bound."""
        req = self.scheduler.submit(prompt, max_new_tokens,
                                    deadline=deadline, cls=cls)
        while block and req.state == "rejected":
            self.scheduler.admit()
            if not self.scheduler.running:
                if not self._reclaim_policy.drain_pending():
                    raise MemoryError(
                        "blocking submit: queue full and nothing running — "
                        "the engine cannot make progress to drain it")
            else:
                self.step()
            self.scheduler.maintain()
            self.scheduler.requeue(req)
        return req

    def step(self, *, inject_preemption_of: Request | None = None) -> None:
        """One batched decode/prefill step: the scheduler plans the chunk,
        the runner enqueues ONE fused step and makes ONE read back, the
        scheduler absorbs the results.  ``inject_preemption_of`` preempts
        that request after launch but before its results are consumed (the
        scheduler-overlap race; tests)."""
        if not self.scheduler.running:
            return
        C, budget, drafts = self.scheduler.plan_chunk()
        do_validate = self.scheduler.plan_validate()
        res = self.runner.execute(self.kv_manager, chunk_size=C,
                                  budget=budget, drafts=drafts,
                                  do_validate=do_validate)
        self.scheduler.absorb(res, C, budget, inject_preemption_of,
                              drafts=drafts)

    def launch_step(self):
        """Enqueue one step WITHOUT collecting its host transfer; returns a
        pending handle for :meth:`collect_step` (None when idle).  CUDA work
        is asynchronous, so the host can plan ahead while the step runs."""
        if not self.scheduler.running:
            return None
        C, budget, drafts = self.scheduler.plan_chunk()
        do_validate = self.scheduler.plan_validate()
        return (self.runner.launch(self.kv_manager, chunk_size=C,
                                   budget=budget, drafts=drafts,
                                   do_validate=do_validate),
                C, budget, drafts)

    def collect_step(self, handle) -> None:
        """Collect a :meth:`launch_step` handle: the single read back,
        then the scheduler absorbs the results."""
        if handle is not None:
            pending, C, budget, drafts = handle
            self.scheduler.absorb(self.runner.collect(pending), C, budget,
                                  drafts=drafts)

    def run(self, max_steps: int = 10_000) -> EngineStats:
        """Drive admit/step/maintain until the queue drains (or max_steps);
        host work only at the allowed sync points."""
        t0 = time.time()
        for _ in range(max_steps):
            self.scheduler.admit()
            if not self.scheduler.running and not self.scheduler.queue:
                break
            if not self.scheduler.running:  # queue blocked on memory
                if self._reclaim_policy.drain_pending():
                    continue  # deferred frees applied (no live reader —
                    # every interval guarantee holds); retry admission
                raise MemoryError("pool exhausted with empty running set")
            self.step()
            self.scheduler.maintain()
        if not self.scheduler.running:
            # drain complete: apply any frees still deferred (interval
            # limbo, chaos delays) so the mirrors and release floors see
            # the true free state — zero readers, so this is always sound
            self._reclaim_policy.flush()
        if (self.scheduler.release_quiescence is not None
                and not self.scheduler._adaptive_release):
            # drain: park the now-idle superblocks.  Adaptive mode skips
            # this eager shrink — its point is to keep capacity mapped
            # across a regular burst cadence, releasing only when
            # maintain()'s learned threshold says the drain is genuine.
            self.shrink()
        self.stats.record_wall(time.time() - t0)
        return self.stats

    def stream(self, max_steps: int = 10_000):
        """Streaming drain: the same admit/step/maintain loop as
        :meth:`run`, but a GENERATOR yielding ``(request, new_tokens)``
        after every step that committed generated tokens — tokens reach the
        caller as steps complete instead of at drain end.  Structurally
        identical to :meth:`run` (one fused step, one read back
        per step; yields are pure host reads of the mirrors), so the
        sync-free invariant holds with a streaming consumer attached."""
        t0 = time.time()
        emitted: dict[int, int] = {}  # rid -> tokens already yielded
        for _ in range(max_steps):
            self.scheduler.admit()
            if not self.scheduler.running and not self.scheduler.queue:
                break
            if not self.scheduler.running:  # queue blocked on memory
                if self._reclaim_policy.drain_pending():
                    continue
                raise MemoryError("pool exhausted with empty running set")
            watch = list(self.scheduler.running)
            self.step()
            for req in watch:
                # emit past the per-request high-water mark only: after a
                # preemption restart the row regenerates tokens the consumer
                # already saw (identical under greedy) — don't re-emit them
                seen = emitted.get(req.rid, 0)
                if len(req.generated) > seen:
                    yield req, req.generated[seen:]
                    emitted[req.rid] = len(req.generated)
            self.scheduler.maintain()
        if not self.scheduler.running:
            self._reclaim_policy.flush()
        if (self.scheduler.release_quiescence is not None
                and not self.scheduler._adaptive_release):
            self.shrink()
        self.stats.record_wall(time.time() - t0)

    def shrink(self, keep_superblocks: int | None = None) -> int:
        """Release every EMPTY superblock above the floor (maintenance sync
        point); returns the number released.  No-op under ``KEEP``."""
        return self.scheduler.shrink(keep_superblocks)

    def inject_external_reclaim(self, req: Request) -> None:
        """TEST/RACE HOOK — a reclaimer races the decode loop (see
        :meth:`Scheduler.inject_external_reclaim`)."""
        self.scheduler.inject_external_reclaim(req)

    # -- historical introspection surface (tests, examples, benchmarks) ------

    @property
    def pool(self):
        """The device pool state (a PagePool of tensors, threaded per step)."""
        return self.kv_manager.allocator.state

    @pool.setter
    def pool(self, state):
        """Install an externally transformed pool state (tests)."""
        self.kv_manager.allocator.state = state

    @property
    def kv(self):
        """The paged KV arena ({'k','v'} page arrays; a list of per-shard
        slabs under tensor parallelism — ``kv_manager.gather_kv()`` joins
        them)."""
        return self.kv_manager.kv

    @property
    def queue(self):
        """Queued requests (scheduler-owned)."""
        return self.scheduler.queue

    @property
    def running(self):
        """Running requests (scheduler-owned)."""
        return self.scheduler.running

    @property
    def max_pages_per_seq(self) -> int:
        """Block-table width per slot (kv-manager-owned)."""
        return self.kv_manager.max_pages_per_seq

    @property
    def pages_per_superblock(self) -> int:
        """Release granularity of the device pool."""
        return self.kv_manager.allocator.pages_per_superblock

    @property
    def prefill_chunk(self) -> int:
        """Configured chunked-prefill width (scheduler-owned)."""
        return self.scheduler.prefill_chunk

    @property
    def prefix_cache(self) -> bool:
        """Whether refcounted prefix sharing is enabled."""
        return self.scheduler.prefix_cache

    @property
    def speculative_k(self) -> int:
        """Configured draft length K (0 = speculation off; scheduler-owned —
        the live AIMD cap is ``scheduler.spec_k_cap``)."""
        return self.scheduler.speculative_k

    @property
    def release_strategy(self) -> ReleaseStrategy:
        """The pool's physical-release strategy."""
        return self.kv_manager.allocator.release_strategy

    @property
    def reclaim_policy(self) -> ReclamationPolicy:
        """The live reclamation backend (core/reclaim_policy.py)."""
        return self._reclaim_policy

    # internal-but-stable hooks the test suites drive directly
    _HOOKS = {
        "_slots": lambda s: s.kv_manager.slots,
        "_bt": lambda s: s.kv_manager._bt,
        "_sharers": lambda s: s.kv_manager.sharers,
        "_cache_pages": lambda s: s.scheduler.index.pages,
        "_prefix_index": lambda s: s.scheduler.index.index,
        "_prefix_tail": lambda s: s.scheduler.index.tail,
        "_prompt_cap": lambda s: s.kv_manager._prompt_cap,
        "_chunk_budget_cap": lambda s: s.scheduler.chunk_budget_cap,
    }

    def __getattr__(self, name):
        hook = type(self)._HOOKS.get(name)
        if hook is None:
            raise AttributeError(name)
        return hook(self)

    @property
    def _warning_batches(self) -> int:
        # the clock mirror lives in stats now; tests still poke it directly
        return self.stats.warnings_fired

    @_warning_batches.setter
    def _warning_batches(self, v: int) -> None:
        self.stats.warnings_fired = v

    def _admit(self) -> None:
        return self.scheduler.admit()

    def _preempt(self, victim: Request) -> None:
        return self.scheduler.preempt(victim)

    def _maintain(self) -> None:
        return self.scheduler.maintain()

    def _evict_prefix(self, need_pages: int | None = None,
                      freeable_only: bool = True) -> int:
        return self.scheduler.index.evict(need_pages, freeable_only)

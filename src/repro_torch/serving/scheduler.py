"""Scheduler: continuous-batching policy — pure host logic, no jax.

The top layer of the serving stack (ARCHITECTURE.md).  Everything here is a
*decision*: admission order and its starvation guard, Sarathi-style token
budgets and the AIMD chunk backoff, victim selection, prefix-index matching
and donation/eviction policy, the quiescence release policy.  Every
*mechanism* those decisions need — device grants, share/unshare batches,
slot installs, refcount and clock mirrors, physical release — is a method
call on the :class:`repro.serving.kv_manager.KVCacheManager`, and every
value crossing that boundary is a plain host int/list/bool.

The module deliberately imports no jax (enforced by
``tests/test_layering.py``): scheduling policy must stay testable against a
fake allocator and portable across backends — the ROADMAP's sharding /
async / multi-backend directions all land below this line.  Data-parallel
serving (``serving/parallel.py``) reuses the same scheduler per replica and
routes between pools with the same pressure arithmetic this module exposes
(:meth:`Scheduler.load`, :meth:`PrefixIndex.match`).
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np

from repro_torch.core.reclaim_policy import ReclamationPolicy, make_policy
from repro_torch.core.vm import superblock_floor
from .draft import NGramDrafter
from .kv_manager import KVCacheManager
from .overload import (DEFAULT_CLASSES, ClassQueues, DegradationLadder,
                       LadderConfig, VICTIM_POLICIES)
from .stats import EngineStats


def required_pages_per_seq(prompt_len: int, max_new: int,
                           page_size: int) -> int:
    """Worst-case block-table width a request can ever need: one slot per
    page of its final sequence, ``ceil((prompt_len + max_new) / page_size)``.

    This is also the worst case under chunked prefill and prefix sharing: a
    C-token chunk's multi-page grant only fills slots inside this width, and
    a COW copy *replaces* the shared page at the same slot rather than
    extending the row.  ``launch/serve.py`` sizes ``max_pages_per_seq`` from
    this instead of re-deriving it from CLI arithmetic (which under-counted
    when ``--shared-prefix`` exceeded ``--prompt-len``)."""
    return -(-(prompt_len + max_new) // page_size)


@dataclasses.dataclass
class Request:
    """One generation request and its host-side mirrors (see engine.py for
    the lifecycle; ``pages`` is the introspection helper tests use)."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    committed: int = 0  # tokens (prompt+generated) whose KV is committed
    restarts: int = 0
    state: str = "queued"  # queued | running | finished | shed | rejected
    # multi-tenant service class (overload.py); routes the request into its
    # class's bounded admission queue and its SLO reservoirs
    cls: str = "interactive"
    # SLO: absolute deadline on the scheduler's monotonic clock (None =
    # best effort).  A request that provably cannot finish in time is SHED
    # at admission — never mid-decode, where its pages and committed KV
    # would be wasted work.
    deadline: float | None = None
    # failover: tokens generated on a replica that died; the re-prefill
    # replays them as prompt, so ``generated`` restarts empty on the
    # surviving replica and ``output_tokens`` stitches the full answer
    migrated_prefix: list[int] = dataclasses.field(default_factory=list)
    migrations: int = 0  # how many replica failures this request survived
    # time-to-first-token accounting (chunked prefill's headline metric)
    submitted_at: float = 0.0  # scheduler clock at submit()
    admitted_step: int | None = None  # engine step count at FIRST admission
    first_token_at: float | None = None  # clock at first generated token
    first_token_step: int | None = None  # engine step that produced it
    _last_token_t: float | None = None  # clock at last token (ITL stream)
    slot: int | None = None  # batch row while running
    pages_held: int = 0  # host-side page COUNT (ids live on device)
    externally_reclaimed: bool = False  # a reclaimer raced us and owns the pages
    reclaim_watermark: int = 0  # pages_held at the moment of the race
    # prefix sharing: block-table index -> shared page id (host mirror of the
    # refcounted grants; shrinks as COW divergence converts shares to owns)
    shared_chain: dict = dataclasses.field(default_factory=dict)
    shared_held: int = 0  # how many of pages_held are shared (refcount > 1)
    prefix_reused: int = 0  # prompt tokens whose prefill this request skipped
    _engine: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def target_len(self) -> int:
        """Final sequence length (prompt + full generation budget)."""
        return len(self.prompt) + self.max_new_tokens

    @property
    def output_tokens(self) -> list[int]:
        """Every token generated for this request across migrations: the
        tokens a dead replica produced (replayed as prompt on the survivor)
        followed by the survivor's own generation.  Token-exact under greedy
        decoding — the comparison surface the chaos benchmark oracles."""
        return self.migrated_prefix + self.generated

    @property
    def ttft_seconds(self) -> float | None:
        """Submit → first generated token wall time (None until it lands)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def ttft_steps(self) -> int | None:
        """Engine dispatches between FIRST admission and the first generated
        token (inclusive) — the structural TTFT chunked prefill shrinks.
        Like ``ttft_seconds``, a preemption restart does NOT reset the
        clock: replayed dispatches are latency the user saw."""
        if self.first_token_step is None or self.admitted_step is None:
            return None
        return self.first_token_step - self.admitted_step

    @property
    def pages(self) -> list[int]:
        """Physical page ids currently mapped (reads the device block table —
        introspection/test helper, never called on the hot path).

        Robust against cleared slots: a request whose slot was released —
        or whose old slot index now belongs to ANOTHER request — reads as
        ``[]``.  Ownership is re-checked after the device read, so a clear
        landing during the transfer is detected; a consistent pre-clear
        snapshot may still be returned, the strongest guarantee an unfenced
        observer of an optimistic structure can have."""
        eng, slot = self._engine, self.slot
        if slot is None or eng is None or eng._slots[slot] is not self:
            return []
        row = eng._bt[slot].tolist()  # a CPU or CUDA tensor row
        if self.slot != slot or eng._slots[slot] is not self:
            return []  # cleared mid-read: stale row, report nothing
        return [int(p) for p in row if p >= 0]


class PrefixIndex:
    """The host-side prefix cache: aligned token tuples → resident pages.

    Pure-dictionary *policy* (what matches, what a finish donates, what
    pressure evicts first); every refcount consequence goes through the
    manager (``index_take``/``index_drop``/``unshare_batch``), which owns
    the mirrors.  The index maps an exact token tuple (length a multiple of
    ``page_size``) to the device page holding that tuple's LAST page_size
    tokens; a chain of k pages is recovered by looking up the k aligned
    prefixes.  ``tail`` holds one partially-filled page per aligned prefix
    for sub-page (COW) matching.  The index owns ONE reference per page.
    """

    def __init__(self, page_size: int, cap: int, kvm: KVCacheManager,
                 stats: EngineStats):
        self.page_size = page_size
        self.cap = cap
        self.kvm = kvm
        self.stats = stats
        self.index: dict[tuple, int] = {}
        self.tail: dict[tuple, tuple[int, tuple]] = {}
        self.pages: dict[int, tuple] = {}  # page -> ("page"|"tail", key)
        # the manager's zero-transition predicates read a LIVE view of
        # ``pages`` — one mutation updates policy and mirrors together
        kvm.bind_index(self.pages)

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
        """Evict entries leaf-first; returns pages actually FREED.

        ``need_pages``: stop once that many pages freed (None = down to the
        cap).  ``freeable_only``: skip pages still referenced by a running
        slot (dropping the index's reference would free nothing).  One
        linear sweep: tails first (always leaves), then index keys
        deepest-first — a chain link becomes a leaf the moment its
        extension is evicted earlier in the SAME sweep; a per-key child
        count replaces the quadratic extension scan.  One batched unshare
        at the end; the clock mirror ticks once iff any page hit zero."""
        kvm, ps = self.kvm, self.page_size
        children: dict[tuple, int] = {}
        for k in self.index:
            if len(k) > ps:
                parent = k[: len(k) - ps]
                children[parent] = children.get(parent, 0) + 1
        candidates = (
            [("tail", k) for k in sorted(self.tail, key=len, reverse=True)]
            + [("page", k) for k in sorted(self.index, key=len, reverse=True)])
        to_unshare: list[int] = []
        freed = 0
        for kind, key in candidates:
            if need_pages is not None and freed >= need_pages:
                break
            if need_pages is None and len(self.pages) <= self.cap:
                break
            if kind == "page" and (children.get(key, 0) > 0
                                   or key in self.tail):
                continue  # a longer chain link or its tail must go first
            page = (self.tail[key][0] if kind == "tail" else self.index[key])
            if freeable_only and kvm.sharer_count(page) > 0:
                continue
            if kind == "tail":
                self.tail.pop(key)
            else:
                self.index.pop(key)
                if len(key) > ps:
                    parent = key[: len(key) - ps]
                    children[parent] = children.get(parent, 0) - 1
            self.pages.pop(page, None)
            to_unshare.append(page)
            if kvm.sharer_count(page) == 0:
                freed += 1
            self.stats.record_eviction()
        if to_unshare:
            kvm.unshare_batch(to_unshare, freed)
            self.stats.record_cache_pages(len(self.pages))
        return freed

    def enforce_cap(self) -> None:
        """Shrink the index back under its page cap (pressure-free path)."""
        if len(self.pages) > self.cap:
            self.evict(need_pages=None, freeable_only=False)


class Scheduler:
    """Continuous-batching policy over a :class:`KVCacheManager` (module
    docstring).  Owns the queue, the running set, the prefix index and all
    the knobs; never holds a device array."""

    def __init__(self, kvm: KVCacheManager, stats: EngineStats, *,
                 num_pages: int, page_size: int, max_batch: int,
                 prefix_cache: bool = False,
                 prefix_cache_pages: int | None = None,
                 prefill_chunk: int = 1, token_budget: int | None = None,
                 release_quiescence: int | str | None = None,
                 min_mapped_superblocks: int = 1, engine: object = None,
                 grant_retry_limit: int = 8, greedy: bool = True,
                 speculative_k: int = 0, drafter=None,
                 spec_probe_interval: int = 16,
                 reclaim_policy: ReclamationPolicy | None = None,
                 classes: dict | None = None,
                 max_queue_depth: int | None = None,
                 victim_policy="youngest",
                 ladder: DegradationLadder | LadderConfig | bool | None = None,
                 clock=None):
        self.kvm = kvm
        self.stats = stats
        # the scheduler's one clock: monotonic by default (deadlines and
        # speed samples must not jump with NTP/wall adjustments); injectable
        # for deterministic tests
        self.clock = clock if clock is not None else time.monotonic
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_batch = max_batch
        self.prefix_cache = prefix_cache
        cap = (max(1, num_pages // 2) if prefix_cache_pages is None
               else max(1, prefix_cache_pages))
        self.index = PrefixIndex(page_size, cap, kvm, stats)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.token_budget = token_budget
        # AIMD backoff of the chunk budget under memory pressure: a starved
        # multi-page chunk grant halves the cap (floor 1 — token-at-a-time),
        # a starvation-free chunked step doubles it back
        self.chunk_budget_cap = self.prefill_chunk
        self._planned_prefill = False  # did the LAST plan include prefill?
        # speculative decoding: draft up to K tokens per decoding row, verify
        # in one dispatch (greedy only — see submit()).  spec_k_cap is the
        # live AIMD cap: a low-accept step halves it with FLOOR ZERO — k=1
        # still pays the full C-wide speculative executable, so useless
        # drafting must fall all the way back to the plain C=1 dispatch —
        # and a probe draft every ``spec_probe_interval`` steps re-tests the
        # workload so a later repetitive stretch can re-open the throttle.
        self.greedy = bool(greedy)
        self.speculative_k = max(0, int(speculative_k))
        self.drafter = (drafter if drafter is not None
                        else (NGramDrafter() if self.speculative_k else None))
        self.spec_k_cap = self.speculative_k
        self.spec_probe_interval = max(1, int(spec_probe_interval))
        self._spec_probe = 0
        # the speculative executable's STATIC chunk width: wide enough for
        # the configured K (+1 for the last committed token at slot 0) and
        # for a mixed batch's prefill chunks — ONE extra compile, total
        self.spec_chunk = max(self.prefill_chunk, self.speculative_k + 1)
        # release_quiescence: int = static idle-tick floor, "adaptive" =
        # Hyaline-style threshold tracking an EWMA of admit-burst
        # inter-arrival gaps (see _release_threshold), None = never release
        self.release_quiescence = release_quiescence
        self._adaptive_release = release_quiescence == "adaptive"
        # EWMA of admit-burst inter-arrival gaps, in queue-empty maintain
        # ticks (the same clock _idle_ticks runs on); None until the first
        # gap is observed
        self._gap_ewma: float | None = None
        self._adaptive_floor = 2  # lower clamp once a cadence is learned
        self._adaptive_bootstrap = 16  # threshold before ANY gap is observed
        # reclamation policy: plans whether each fused step runs the OA
        # validation pass, and (interval) defers frees behind the allocator
        self.policy = (reclaim_policy if reclaim_policy is not None
                       else make_policy())
        self._step_validates = True  # absorb()'s view of the LAST plan
        self._planned_clock = 0  # clock mirror at the last plan
        self.min_mapped_superblocks = max(1, min_mapped_superblocks)
        # denied admission grants get this many PLAIN retries before the
        # escalation chain (remap -> evict -> preempt) — a transient denial
        # (chaos, or a release racing the alloc) should not cost a victim
        self.grant_retry_limit = max(0, int(grant_retry_limit))
        # EWMA seconds-per-committed-token: the shedding estimator's model
        # of this engine's speed (None until the first timed step)
        self.sec_per_token: float | None = None
        self._last_step_t: float | None = None
        self._speed_warmup = 2  # first steps pay jit compiles; skip them
        # multi-tenant admission: per-class bounded FIFOs drained in strict
        # priority order; a full class queue REJECTS at submit (explicit
        # backpressure) instead of growing unboundedly.  max_queue_depth =
        # None keeps the historical unbounded single-tenant behaviour.
        self.classes = dict(classes) if classes else dict(DEFAULT_CLASSES)
        self.queue: ClassQueues = ClassQueues(self.classes, max_queue_depth)
        if callable(victim_policy):
            self.victim_policy = victim_policy
        elif victim_policy in VICTIM_POLICIES:
            self.victim_policy = VICTIM_POLICIES[victim_policy]
        else:
            raise ValueError(
                f"unknown victim_policy {victim_policy!r}; known policies: "
                f"{sorted(VICTIM_POLICIES)} (or pass a callable "
                f"(scheduler, candidates) -> Request)")
        # graceful-degradation ladder (overload.py): None/False = off,
        # True = defaults, or a LadderConfig / prebuilt DegradationLadder
        if isinstance(ladder, DegradationLadder):
            self.ladder = ladder
        elif isinstance(ladder, LadderConfig):
            self.ladder = DegradationLadder(ladder)
        elif ladder is True:
            self.ladder = DegradationLadder()
        elif ladder in (None, False):
            self.ladder = None
        else:
            raise ValueError(f"ladder must be None/bool/LadderConfig/"
                             f"DegradationLadder, got {ladder!r}")
        self._ladder_chunk_cap: int | None = None  # rung 1's chunk ceiling
        self._ladder_spec_off = False  # rung 2: drafts forced to zero
        # real-arrival-gap tracking for the adaptive release threshold:
        # seconds-per-maintain-tick EWMA converts wall gaps between admit
        # bursts into the tick units _release_threshold compares against
        self._last_arrival_t: float | None = None
        self._last_tick_t: float | None = None
        self._sec_per_tick: float | None = None
        self.running: list[Request] = []
        self._idle_ticks = 0
        self._next_rid = itertools.count(1000)
        self._engine = engine  # facade back-reference for Request.pages

    # -- submission ----------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int,
               deadline: float | None = None,
               cls: str = "interactive") -> Request:
        """Queue a request (host-only; no device work until admission).

        Degenerate inputs — an empty prompt, a non-positive or non-int
        generation budget, non-int token ids, an unknown service class —
        are rejected HERE with a clear ``ValueError`` instead of failing
        deep inside the fused step, and over-long requests likewise: replay
        positions beyond the slot's KV capacity would hit the fused step's
        defensive clamp and generate garbage.  (``MemoryError`` for
        pool-wide exhaustion still comes from admission — this guard is
        per-slot, knowable at submit.)

        ``deadline`` is RELATIVE seconds from now (scheduler monotonic
        clock); a request the admission estimator judges unable to finish
        in time is shed at admission (state ``"shed"``), never mid-decode.

        BACKPRESSURE: when ``cls``'s bounded queue is full the request is
        returned with state ``"rejected"`` and is NOT enqueued — the queue
        never grows without bound.  Callers either retry later or use the
        engine facade's blocking submit, which drives steps until space
        frees."""
        if self.speculative_k > 0 and not self.greedy:
            raise ValueError(
                "speculative decoding requires greedy sampling: the accept "
                "scan compares the verifier's argmax, and lossless "
                "rejection sampling for temperature > 0 is not implemented "
                "— set greedy=True or speculative_k=0")
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to decode from")
        bad = [t for t in prompt
               if isinstance(t, bool) or not isinstance(t, (int, np.integer))]
        if bad:
            raise ValueError(
                f"prompt token ids must be ints, got {bad[0]!r} "
                f"({type(bad[0]).__name__})")
        prompt = [int(t) for t in prompt]
        if (isinstance(max_new_tokens, bool)
                or not isinstance(max_new_tokens, (int, np.integer))
                or max_new_tokens <= 0):
            raise ValueError(
                f"max_new_tokens must be a positive int, got "
                f"{max_new_tokens!r}")
        max_new_tokens = int(max_new_tokens)
        cap_tokens = self.kvm.max_pages_per_seq * self.page_size
        if len(prompt) + max_new_tokens > cap_tokens:
            raise ValueError(
                f"request needs {len(prompt)} prompt + {max_new_tokens} "
                f"generated tokens but a slot holds at most {cap_tokens} "
                f"(max_pages_per_seq={self.kvm.max_pages_per_seq} × "
                f"page_size={self.page_size}); split the prompt or raise "
                f"max_pages_per_seq")
        if cls not in self.classes:
            raise ValueError(
                f"unknown request class {cls!r}; configured classes: "
                f"{sorted(self.classes)}")
        now = self.clock()
        req = Request(rid=next(self._next_rid), prompt=prompt,
                      max_new_tokens=max_new_tokens, _engine=self._engine,
                      submitted_at=now, cls=cls,
                      deadline=None if deadline is None
                      else now + float(deadline))
        if self.queue.full(cls):
            # bounded queue: refuse loudly rather than queue unboundedly
            req.state = "rejected"
            self.stats.record_rejection(cls)
            return req
        self._note_arrival(now)
        self.queue.append(req)
        self.stats.record_class_submit(cls)
        return req

    def requeue(self, req: Request) -> bool:
        """Second chance for a ``"rejected"`` request: enqueue it if its
        class queue has drained below its bound (the engine's blocking
        submit drives steps between attempts).  Returns success."""
        if self.queue.full(req.cls):
            return False
        req.state = "queued"
        self._note_arrival(self.clock())
        self.queue.append(req)
        self.stats.record_class_submit(req.cls)
        return True

    def _note_arrival(self, now: float) -> None:
        """Fold the gap since the last admit burst into the EWMA the
        adaptive release threshold tracks (Hyaline-style).  The gap is
        measured on the REAL clock when a tick cadence is known — the
        seconds since the last arrival, converted through the measured
        seconds-per-maintain-tick — and falls back to counted queue-empty
        ticks otherwise (deterministic closed-loop drivers have no usable
        wall cadence).  Only a burst that ENDED a queue-empty stretch
        counts; the rest of the burst folds nothing."""
        if self._idle_ticks > 0:
            g = float(self._idle_ticks)
            if (self._sec_per_tick is not None and self._sec_per_tick > 0
                    and self._last_arrival_t is not None):
                # ceiling: a driver pause (engine not ticking) must not
                # poison the cadence with one unbounded sample
                g = min((now - self._last_arrival_t) / self._sec_per_tick,
                        10.0 * self._adaptive_bootstrap)
            self._gap_ewma = (g if self._gap_ewma is None
                              else 0.7 * self._gap_ewma + 0.3 * g)
            self._idle_ticks = 0
        self._last_arrival_t = now

    # -- pressure arithmetic (host mirrors only) -----------------------------

    def distinct_pages_in_use(self) -> int:
        """Distinct live pages (each shared page counted ONCE — release
        floors and the admission guard must not double-bill sharers)."""
        owned = sum(r.pages_held - r.shared_held for r in self.running)
        return owned + self.kvm.shared_distinct()

    def load(self) -> int:
        """Outstanding token demand — the routing pressure signal the
        data-parallel front end compares across replicas."""
        return (sum(r.target_len - r.committed for r in self.running)
                + sum(r.target_len for r in self.queue))

    def pages_needed_next_step(self, r: Request) -> int:
        """Pages ``r``'s NEXT step will demand from the pool.  A decoding
        row needs at most one (write position crossing into an unmapped
        page); a prefilling row's chunk may straddle several boundaries; a
        row whose write position sits in a shared page needs one more for
        the COW copy.  Charged at the LIVE AIMD cap, not the configured
        chunk — charging the configured chunk would over-reserve after a
        backoff."""
        ps = self.page_size
        chunk = max(1, self._chunk_cap())
        if r.committed < len(r.prompt) and chunk > 1:
            n_next = min(chunk, len(r.prompt) - r.committed)
        else:
            # a decoding row's speculative chunk appends up to 1 + K tokens
            # (drafts included — rejected writes still need granted pages)
            n_next = 1 + self.spec_k_cap
        last_pi = (r.committed + n_next - 1) // ps
        need = max(0, last_pi + 1 - r.pages_held)
        if (r.committed // ps) in r.shared_chain:
            need += 1  # COW copy of the still-shared write page
        return need

    # -- admission -----------------------------------------------------------

    def admit(self) -> None:
        """Admission (an allowed sync point): match the prefix index, grant
        shared pages, reserve the first step's worst-case page demand
        against the starvation guard, allocate the fresh page (remap →
        evict → preempt on exhaustion) and install the slot."""
        ps = self.page_size
        while self.queue and len(self.running) < self.max_batch:
            req = self.queue[0]
            if self._shed_if_hopeless(req):
                continue  # SLO policy dropped it; try the next in line
            need_total = (req.target_len + ps - 1) // ps
            if need_total > min(self.num_pages, self.kvm.max_pages_per_seq):
                raise MemoryError(
                    f"request {req.rid} needs {need_total} pages; the pool "
                    f"can never satisfy it (num_pages={self.num_pages})")
            if self.prefix_cache:
                m, chain, tail_page = self.index.match(req.prompt)
            else:
                m, chain, tail_page = 0, [], -1
            shared = chain + ([tail_page] if tail_page >= 0 else [])
            # share BEFORE the alloc loop: the sharer mirror marks these
            # pages so pressure eviction inside the loop cannot free them
            if shared:
                self.kvm.share(shared)
            need_fresh = (m % ps == 0)  # first write lands on a new page
            fresh_page = -1
            # Starvation guard — for EVERY admission: running rows that need
            # pages THIS step have first claim on the free pool; this
            # admission reserves the fresh page plus every page its FIRST
            # step will demand (a chunk can straddle several, a tail match
            # COWs).  Host arithmetic over the mirrors only.
            used = self.distinct_pages_in_use()
            need_now = sum(self.pages_needed_next_step(r)
                           for r in self.running)
            n_first = min(max(1, self._chunk_cap()),
                          len(req.prompt) - m)
            held_after = len(shared) + (1 if need_fresh else 0)
            first_need = max(0, (m + n_first - 1) // ps + 1 - held_after)
            if tail_page >= 0:
                first_need += 1  # the first step COWs the shared tail page
            reserve = (1 if need_fresh else 0) + first_need
            short = reserve + used + need_now - self.kvm.mapped_pages
            if short > 0:
                self.kvm.remap_for(short)
                short = (reserve + self.distinct_pages_in_use() + need_now
                         - self.kvm.mapped_pages)
                if short > 0 and self.prefix_cache:
                    # cache-only pages cost no running request anything:
                    # evict them before refusing admission
                    self.index.evict(short)
                    short = (reserve + self.distinct_pages_in_use()
                             + need_now - self.kvm.mapped_pages)
                if short > 0:
                    self._unshare_admission(shared)
                    break  # remap + eviction fell short: a partial cover
                    # must not let admission steal a starved row's page
            if need_fresh:
                denials = 0
                while True:
                    fresh_page = self.kvm.alloc_fresh()
                    if fresh_page is not None:
                        break
                    self.stats.record_grant_denial()
                    denials += 1
                    if denials <= self.grant_retry_limit:
                        # bounded plain retry: a transient denial (chaos
                        # fault, or a concurrent release racing the alloc)
                        # should not immediately cost an eviction or victim
                        self.stats.record_grant_retry()
                        continue
                    # released memory covers the need? remap, then evict the
                    # prefix cache, and only then preempt a running request
                    if self.kvm.remap_for(1):
                        continue
                    if self.prefix_cache and self.index.evict(1) > 0:
                        continue
                    if self.policy.pending_frees():
                        # deferred frees (interval limbo) mature within the
                        # lag; a preemption now would only add to the limbo
                        # without making a single page grantable — wait
                        self._unshare_admission(shared)
                        return
                    victim = self.pick_victim(exclude=req)
                    if victim is None:
                        self._unshare_admission(shared)
                        return  # req waits for memory
                    self.preempt(victim)  # free pages, then retry the alloc
            slot = self.kvm.free_slot_index()
            row = shared + ([fresh_page] if need_fresh else [])
            self.kvm.install_slot(slot, row, m, req.prompt)
            self.queue.popleft()
            req.state = "running"
            req.slot = slot
            if req.admitted_step is None:  # restarts keep the original clock
                req.admitted_step = self.stats.steps
            req.committed = m
            req.prefix_reused = m
            req.shared_chain = dict(enumerate(shared))
            req.shared_held = len(shared)
            req.pages_held = len(shared) + (1 if need_fresh else 0)
            self.kvm.slots[slot] = req
            self.running.append(req)
            if need_fresh:
                self.stats.record_grants(1)
            if m > 0:
                self.stats.record_prefix_hit(m)
            # a preemption above may have requeued the victim behind req;
            # keep admitting — the loop condition re-checks capacity

    def _shed_if_hopeless(self, req: Request) -> bool:
        """SLO admission control: drop ``req`` (state ``"shed"``) iff its
        deadline has already passed, or the EWMA speed model says the
        remaining work cannot finish in the remaining time.  Only ever
        called on the QUEUE HEAD — a running request is never shed, because
        its pages and committed KV are sunk cost worth finishing."""
        if req.deadline is None:
            return False
        remaining = req.deadline - self.clock()
        est = (0.0 if self.sec_per_token is None
               else (req.target_len - req.committed) * self.sec_per_token)
        if remaining > 0 and est <= remaining:
            return False
        assert self.queue[0] is req
        self.queue.popleft()
        req.state = "shed"
        self.stats.record_shed(cls=req.cls)
        return True

    def _unshare_admission(self, shared: list[int]) -> None:
        """Back out the shared grants of an admission that could not secure
        its fresh page (the request stays queued).  All these pages are
        still cache-held, so no zero-transition — no clock tick."""
        if not shared:
            return
        for p in shared:
            self.kvm.dec_sharer(p)
        self.kvm.unshare_batch(shared, 0)

    # -- preemption / release ------------------------------------------------

    def pick_victim(self, exclude: Request | None = None):
        """Dispatch to the configured victim policy (overload.py's
        ``VICTIM_POLICIES``): ``"youngest"`` loses the least committed
        work (PR 4's LIFO), ``"deadline"`` spares the requests closest to
        missing their SLO.  Every preemption path routes through here so a
        policy swap changes ALL victim choices."""
        cands = [r for r in self.running if r is not exclude]
        if not cands:
            return None
        return self.victim_policy(self, cands)

    def preempt(self, victim: Request) -> None:
        """OPTIMISTIC free: pages are reclaimed immediately — any in-flight
        read of them will fail version validation and restart."""
        self.free_slot(victim)
        victim.state = "queued"
        victim.committed = 0
        victim.generated = []  # restart from a known-valid root (the prompt)
        victim.restarts += 1
        self.running.remove(victim)
        self.queue.append(victim)
        self.stats.record_preemption()

    def free_slot(self, req: Request, *, donate: bool = False) -> None:
        """Release a slot's pages by DROPPING REFERENCES, not unconditional
        free: owned pages hit zero and reclaim optimistically; shared prefix
        pages merely lose this request's reference.  With ``donate`` (finish
        path, cache on) committed pages are offered to the prefix index
        first — references transfer instead of dropping."""
        assert req.slot is not None
        slot = req.slot
        if req.externally_reclaimed:
            # the racing reclaimer owns every page it saw; only pages
            # granted AFTER the race — past the watermark — are slot-owned
            if req.pages_held > req.reclaim_watermark:
                self.kvm.free_row_tail(slot, req.reclaim_watermark)
                self.stats.record_warning()
                self.stats.record_reclaimed(
                    req.pages_held - req.reclaim_watermark)
            self.kvm.clear_slot(slot)
            req.externally_reclaimed = False
        elif donate and self.prefix_cache and req.committed > 0:
            row = self.kvm.row_pages(slot)
            self.index.donate(row, req.prompt + req.generated, req.committed,
                              set(req.shared_chain.values()))
            self.kvm.clear_slot(slot)
        else:
            owned = req.pages_held - req.shared_held
            self.kvm.release_slot(slot)
            self.kvm.release_mirror(list(req.shared_chain.values()), owned)
        req.slot = None
        req.pages_held = 0
        req.shared_held = 0
        req.shared_chain = {}

    def pick_victim_and_preempt(self, starved: list[Request]) -> bool:
        """Unblock ``starved`` rows: remap released superblocks first (costs
        no one anything), then evict cache pages, then preempt the victim
        the configured policy picks (default youngest overall — the most
        committed row is never the victim, so the batch's leader always
        makes progress and preemption cannot ping-pong under chunked
        growth; ``"deadline"`` trades that for SLO awareness)."""
        if self.kvm.remap_for(len(starved)):
            return True
        if self.prefix_cache and self.index.evict(len(starved)) > 0:
            return True
        if not self.running:
            return False
        if self.policy.pending_frees():
            return False  # limbo frees mature within the lag; retry then
        self.preempt(self.pick_victim())
        return True

    def inject_external_reclaim(self, req: Request) -> None:
        """TEST/RACE HOOK — a reclaimer frees the request's pages while the
        scheduler still believes its snapshot valid.  The NEXT step's fused
        validation must observe the version mismatch, discard the row and
        restart the request.  Ownership transfers to the reclaimer — the
        restart path clears the slot without freeing again."""
        assert req in self.running and req.slot is not None
        self.kvm.free_row(req.slot)
        owned = req.pages_held - req.shared_held
        self.kvm.release_mirror(list(req.shared_chain.values()), owned)
        req.shared_chain = {}
        req.shared_held = 0
        req.externally_reclaimed = True
        req.reclaim_watermark = req.pages_held

    # -- the step protocol (plan -> [runner executes] -> absorb) -------------

    def _live_spec_k(self) -> int:
        """The draft cap in force THIS step: the AIMD cap while it is open;
        once backed off to zero, a 1-token probe every
        ``spec_probe_interval`` steps (0 otherwise) so a workload that turns
        self-predictive again can re-open the throttle."""
        if self.speculative_k <= 0 or not self.greedy:
            return 0
        if self._ladder_spec_off:
            return 0  # rung 2: drafting is pure overhead under overload
        if self.spec_k_cap > 0:
            return self.spec_k_cap
        self._spec_probe += 1
        if self._spec_probe >= self.spec_probe_interval:
            self._spec_probe = 0
            return 1
        return 0

    def plan_validate(self) -> bool:
        """Ask the reclamation policy whether THIS step's fused dispatch
        must run the OA validation pass (host mirrors only — the clock
        mirror is ``stats.warnings_fired``).  Remembers the verdict and the
        mirror value for :meth:`absorb`'s bookkeeping: a mirror tick that
        lands DURING the step (e.g. a COW zero-transition discovered at
        absorb) moves the mirror past the planned value, so the next plan
        validates again — conservative by construction."""
        self._planned_clock = self.stats.warnings_fired
        self._step_validates = self.policy.needs_validation(
            self._planned_clock)
        return self._step_validates

    def plan_chunk(self) -> tuple[int, int, dict | None]:
        """Pick the executable (C), the traced budget and the draft plan for
        this step from host mirrors only.  C=1 is classic decode;
        C=prefill_chunk runs whenever any row still replays its prompt,
        with the Sarathi budget reserving one token per decoding row and
        splitting the rest.  With speculation live, every decoding row asks
        the drafter for up to K tokens; any proposal promotes the step to
        the C=spec_chunk speculative executable (mixed prefill+draft
        batches run in the SAME dispatch).  ``drafts`` maps slot → draft
        token list, or None when this step runs non-speculatively — a
        drafter with nothing to say costs the plain path nothing."""
        n_prefill = sum(1 for r in self.running
                        if r.committed < len(r.prompt))
        drafts: dict | None = None
        k_cap = self._live_spec_k()
        if k_cap > 0 and self.drafter is not None:
            proposals: dict[int, list[int]] = {}
            for r in self.running:
                if r.committed < len(r.prompt):
                    continue  # prefilling rows replay, they don't draft
                # never draft past the generation budget: full acceptance
                # must land EXACTLY on max_new (the bonus token is +1), so
                # the host mirrors and mid-draft finishes stay exact
                room = r.max_new_tokens - len(r.generated) - 1
                k = min(k_cap, room, self.spec_chunk - 1)
                if k <= 0:
                    continue
                d = self.drafter.propose(r.prompt + r.generated, k)[:k]
                if d:
                    proposals[r.slot] = [int(t) for t in d]
            if proposals:
                drafts = proposals
        self._planned_prefill = n_prefill > 0
        if drafts is not None:
            C = self.spec_chunk
            budget = self._prefill_budget(C, n_prefill)
            return C, budget, drafts
        if n_prefill and self.prefill_chunk > 1:
            C = self.prefill_chunk
            budget = self._prefill_budget(C, n_prefill)
            return C, budget, None
        return 1, 1, None

    def _prefill_budget(self, C: int, n_prefill: int) -> int:
        """Sarathi budget for the prefilling rows of a C-wide step: one
        token reserved per decoding row, the rest split across prefills,
        clipped by the AIMD chunk cap and the degradation ladder's rung-1
        ceiling (1 when no row is prefilling — the budget only shapes
        prefill chunks)."""
        if not n_prefill:
            return 1
        if self.token_budget is None:
            budget = C
        else:
            n_decode = len(self.running) - n_prefill
            budget = max(1, min(
                C, (self.token_budget - n_decode) // n_prefill))
        return max(1, min(budget, self._chunk_cap()))

    def _chunk_cap(self) -> int:
        """The chunk budget ceiling in force: the AIMD cap, further clipped
        by the degradation ladder's rung 1 while it is engaged."""
        cap = min(self.prefill_chunk, self.chunk_budget_cap)
        if self._ladder_chunk_cap is not None:
            cap = min(cap, self._ladder_chunk_cap)
        return cap

    def absorb(self, res, C: int, budget: int,
               inject_preemption_of: Request | None = None,
               drafts: dict | None = None) -> None:
        """Fold one step's host results (the single ``device_get``) into the
        request mirrors: grant/COW accounting, OA validation outcomes,
        finishes, starvation response and the AIMD budget updates (chunk
        budget under memory pressure; draft K under the accept rate).
        ``drafts`` is the slot → draft-tokens plan this step launched with
        (None = non-speculative step): a valid speculative row committed
        its accepted draft prefix plus the verifier's bonus token, so the
        host mirror extends ``generated`` by ``n_acc + 1`` tokens."""
        ps = self.page_size
        tok_np, valid_np, grant_np, cow_np, adv_np, nacc_np = res
        committed_this_step = 0
        # host mirror of the device-side grants (before any preemption can
        # reset a row's counters); all COW decrefs landed in ONE device
        # unshare batch, so the clock ticked AT MOST ONCE — mirror follows
        cow_freed = False
        for req in self.running:
            gi = int(grant_np[req.slot])
            if gi <= 0:
                continue  # nothing granted (0 = none needed, −1 = starved)
            self.stats.record_grants(gi)
            req.pages_held += gi
            if cow_np[req.slot]:
                # COW divergence: the fused step copied the shared page,
                # repointed the row and dropped its reference — the grant
                # REPLACED a page; the share mirror shrinks, and if this
                # row was the last sharer the device freed it
                req.pages_held -= 1
                self.stats.record_cow()
                old = req.shared_chain.pop(req.committed // ps, None)
                if old is not None:
                    if self.kvm.drop_ref_frees(old, True):
                        cow_freed = True
                        self.stats.record_reclaimed(1)
                    req.shared_held -= 1
        if cow_freed:
            self.stats.record_warning()

        if (inject_preemption_of is not None
                and inject_preemption_of in self.running):
            # reclaim mid-flight, after the step launched: its results die
            self.preempt(inject_preemption_of)

        starved: list[Request] = []
        step_drafted = step_accepted = 0
        step_t = self.clock()  # one host clock read serves every row's ITL
        for req in list(self.running):
            if req.state != "running":
                continue  # preempted mid-flight; its row is dead anyway
            i = req.slot
            if (not self.policy.detects_stale_readers
                    and req.externally_reclaimed):
                # this policy runs no device validation pass (interval): an
                # external reclaim is outside its free→grant discipline, so
                # the stale reader is detected HERE, host-side — same
                # restart surface as an OA validation failure
                self.stats.record_restart()
                self.preempt(req)
                continue
            if not valid_np[i]:
                if grant_np[i] < 0:
                    starved.append(req)  # stays running; retry after eviction
                else:
                    # OA validation failure: a page was reclaimed since its
                    # snapshot — discard and restart from a known-valid state
                    self.stats.record_restart()
                    self.preempt(req)
                continue
            a = int(adv_np[i])  # chunk rows commit several tokens at once
            was_prefilling = req.committed < len(req.prompt)
            req.committed += a
            committed_this_step += a
            self.stats.record_commit(a, C > 1 and was_prefilling)
            if (req.committed >= len(req.prompt)
                    and len(req.generated) < req.max_new_tokens):
                row_drafts = (None if drafts is None or was_prefilling
                              else drafts.get(i))
                if row_drafts is not None:
                    # speculative row: the accepted draft prefix committed,
                    # then the verifier's bonus token (a == n_acc + 1)
                    acc = int(nacc_np[i])
                    step_drafted += len(row_drafts)
                    step_accepted += acc
                    self.stats.record_speculation(len(row_drafts), acc)
                    req.generated.extend(row_drafts[:acc] + [int(tok_np[i])])
                    n_new = acc + 1
                else:
                    req.generated.append(int(tok_np[i]))
                    n_new = 1
                if req.first_token_step is None:
                    self._record_ttft(req)
                elif req._last_token_t is not None:
                    # streaming inter-token latency: this step's wall gap
                    # amortised over the tokens the row committed
                    self.stats.record_itl(
                        req.cls, (step_t - req._last_token_t) / n_new)
                req._last_token_t = step_t
            if len(req.generated) >= req.max_new_tokens:
                req.state = "finished"
                self.stats.record_class_finish(req.cls)
                self.running.remove(req)
                # retire: donate committed pages to the prefix index (cache
                # on) or fire the warning and free (cache off)
                self.free_slot(req, donate=True)
        if starved:
            self.pick_victim_and_preempt(starved)
        if C > 1:
            # AIMD: starved chunk grants back the budget off toward the
            # token-at-a-time regime; clean chunked PREFILL steps restore
            # it (a pure-decode speculative step says nothing about chunks)
            if starved:
                self.chunk_budget_cap = max(
                    1, min(budget, self.chunk_budget_cap) // 2)
            elif self._planned_prefill:
                self.chunk_budget_cap = min(
                    self.prefill_chunk, max(1, self.chunk_budget_cap) * 2)
        if drafts is not None:
            # AIMD on the draft cap, driven by the measured accept rate: a
            # productive step (>= half the drafts accepted) doubles the cap
            # back toward the configured K; an unproductive one halves it
            # with FLOOR ZERO — k=1 still pays the full spec_chunk-wide
            # executable, so useless drafting must drop to the plain C=1
            # dispatch entirely (the probe in _live_spec_k re-tests later).
            # Steps where every speculative row failed OA validation carry
            # no signal and leave the cap alone.
            if step_drafted:
                if step_accepted * 2 >= step_drafted:
                    self.spec_k_cap = min(self.speculative_k,
                                          max(1, self.spec_k_cap) * 2)
                else:
                    self.spec_k_cap //= 2
            self.stats.record_spec_step(self.spec_k_cap)
        # reclamation-policy bookkeeping: count the pass/skip, remember the
        # epoch a validated step was planned at, advance the interval (the
        # interval policy's limbo frees mature here, once per step)
        self.stats.record_validation(self._step_validates)
        if self._step_validates:
            self.policy.on_validated(self._planned_clock)
        self.policy.on_step()
        self.stats.record_step(chunked=C > 1 and self._planned_prefill)
        self._update_speed_model(committed_this_step)
        pool_pressure = (self.distinct_pages_in_use()
                         / max(1, self.kvm.mapped_pages))
        self.stats.record_backpressure(
            pressure=pool_pressure,
            aimd=self.chunk_budget_cap / max(1, self.prefill_chunk),
            queue_depth=len(self.queue))
        if self.ladder is not None:
            self._tick_ladder(pool_pressure)

    def _tick_ladder(self, pool_pressure: float) -> None:
        """Fold one step's pressure into the degradation ladder and apply
        whatever level it settles on.  Pressure is the WORSE of pool
        occupancy and queue backlog (depth over the soft limit) — either
        signal alone can mean overload.  Pure host policy: every rung turns
        a knob the scheduler already owns, so the fused dispatch and its
        single ``device_get`` per step are untouched."""
        soft = max(1, self.ladder.config.queue_soft_limit)
        pressure = max(pool_pressure, len(self.queue) / soft)
        prev = self.ladder.level
        level = self.ladder.observe(pressure)
        if level != prev:
            self.stats.record_ladder(level)
        # rung 1: halve the chunk-budget ceiling — prefill bursts stop
        # monopolising the token budget and the page pool
        self._ladder_chunk_cap = (max(1, self.prefill_chunk // 2)
                                  if level >= 1 else None)
        # rung 2: speculative drafts to zero — rejected drafts burn pages
        # and dispatch width the overloaded pool cannot spare
        self._ladder_spec_off = level >= 2
        # rung 3: evict the prefix cache — cached pages are a latency
        # optimisation, and under overload they are the cheapest capacity
        if level >= 3 and self.prefix_cache and self.index.pages:
            self.index.evict(need_pages=len(self.index.pages))
        # rung 4: shed queued work, lowest class first, newest first —
        # ONLY queued requests (running KV is sunk cost worth finishing)
        if level >= 4:
            while len(self.queue) > soft:
                victim = self.queue.shed_lowest()
                if victim is None:
                    break
                victim.state = "shed"
                self.stats.record_shed(cls=victim.cls, by_ladder=True)

    def _update_speed_model(self, committed: int) -> None:
        """Fold one step's wall time into the EWMA seconds-per-token the
        shedding estimator uses.  Outlier samples 5× above the established
        mean are dropped — they are compile or pause artifacts, and folding
        one in would make admission shed half the queue after every
        recompile."""
        now = self.clock()
        last, self._last_step_t = self._last_step_t, now
        if last is None or committed <= 0:
            return
        if self._speed_warmup > 0:
            self._speed_warmup -= 1  # compile steps would poison the model
            return
        sample = (now - last) / committed
        if self.sec_per_token is None:
            self.sec_per_token = sample
        elif sample < 5 * self.sec_per_token:
            self.sec_per_token += 0.2 * (sample - self.sec_per_token)

    def _record_ttft(self, req: Request) -> None:
        """First generated token landed: freeze the request's TTFT and fold
        it into the stats means.  A restarted request keeps its original
        submit time — restarts are latency the user saw."""
        req.first_token_at = self.clock()
        req.first_token_step = self.stats.steps + 1  # steps increments at end
        self.stats.record_ttft(req.ttft_steps, req.ttft_seconds, cls=req.cls)

    # -- physical release policy ---------------------------------------------

    def shrink(self, keep_superblocks: int | None = None) -> int:
        """Release every EMPTY superblock above the floor (explicit
        maintenance sync point); returns superblocks released."""
        keep = (self.min_mapped_superblocks if keep_superblocks is None
                else max(1, keep_superblocks))
        return self.kvm.shrink(keep)

    def _release_threshold(self) -> int:
        """Idle ticks required before the quiescence release fires.  Static
        mode returns the configured floor unchanged; adaptive mode
        (``release_quiescence="adaptive"``, Hyaline-style) tracks 1.5× the
        EWMA of recent admit-burst inter-arrival gaps — regular bursts keep
        capacity mapped (no release/remap thrash inside the cadence), a
        genuine drain still releases once the gap outlasts the pattern."""
        if not self._adaptive_release:
            return int(self.release_quiescence)
        if self._gap_ewma is None:
            # no gap observed yet: stay conservative so the first regular
            # cadence is LEARNED, not thrashed through release/remap
            return self._adaptive_bootstrap
        return max(self._adaptive_floor,
                   int(self._gap_ewma * 1.5 + 0.999))

    def maintain(self) -> None:
        """Quiescence-driven release tick: after ``_release_threshold()``
        pressure-free ticks, release capacity no running request can demand
        again — shared pages counted once, plus one page per row still
        sharing its write-position (tail) page, whose first divergent write
        grants a COW copy (omit that and a floor-exact shrink ping-pongs
        with the growth path's remap).  With zero running rows, deferred
        frees (interval limbo) are applied first — no reader is live, so
        every interval guarantee is trivially satisfied and the release
        arithmetic sees the true free state."""
        if not self.running and self.policy.pending_frees():
            self.policy.drain_pending()
        # measure the maintain-tick cadence on the real clock so admit-gap
        # seconds can be converted into tick units (see _note_arrival);
        # EWMA, outlier-clipped like the speed model
        now = self.clock()
        last, self._last_tick_t = self._last_tick_t, now
        if last is not None:
            dt = now - last
            if dt > 0 and (self._sec_per_tick is None
                           or dt < 5 * self._sec_per_tick):
                self._sec_per_tick = (dt if self._sec_per_tick is None
                                      else self._sec_per_tick
                                      + 0.2 * (dt - self._sec_per_tick))
        if self.release_quiescence is None:
            return
        if self.queue:
            self._idle_ticks = 0  # admission pressure: not quiescent
            return
        self._idle_ticks += 1
        if self._idle_ticks < self._release_threshold():
            return
        self._idle_ticks = 0
        ps = self.page_size
        demand = sum((r.target_len + ps - 1) // ps - r.shared_held
                     + (1 if (r.committed // ps) in r.shared_chain else 0)
                     for r in self.running)
        keep = superblock_floor(demand + self.kvm.shared_distinct(),
                                self.kvm.allocator.view().pages_per_superblock,
                                self.min_mapped_superblocks)
        if self.kvm.allocator.view().superblocks_mapped > keep:
            self.shrink(keep_superblocks=keep)

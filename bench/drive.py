"""The timed loop: the traffic of a run driven through the engine's own
round, ``submit``, then ``scheduler.admit()``, ``step()`` and
``scheduler.maintain()`` (the round ``repro_torch/launch/serve.py``'s
trace replay drives), with the benchmark's own timestamps.

Every request gets a :class:`Rec`: its due time (open loop: when the
schedule sends it, whether or not the engine is free; closed loop: when
its caller sends it, right after the step that finished the caller's last
request), and the host time at which each of its generated tokens first
reached the host (the end of the step that read it back).  A preempted
request that generates its tokens again adds no time until it passes the
most it had generated before, so its wait shows as one long gap.

Where the mix says ``fill_cache``, set-up first serves the mix's earlier
requests (:meth:`Loop.fill`) until the prefix cache holds about its cap,
so the window's finishes meet a full cache and evict, as a deployment's
do once it has run a while.

The window opens and closes at step boundaries: it opens at the end of
the first step after the warm-up (open loop: ``warmup_s`` seconds of
arrivals; closed loop: every first prompt prefilled and
``warmup_completions`` requests finished), and closes at the end of the
first step that ends ``seconds`` or more after it opened.
"""

from __future__ import annotations

import dataclasses
import time

from bench.generate import Traffic


@dataclasses.dataclass
class Rec:
    """One request as the benchmark saw it (module docstring)."""

    t_due: float
    prompt: list
    max_new: int
    client: int = -1
    token_times: list = dataclasses.field(default_factory=list)
    failed: bool = False
    t_done: float | None = None
    admitted_step: int | None = None
    prefix_reused: int = 0
    committed_w0: int | None = None  # tokens committed when the window opened
    committed_w1: int | None = None  # ... and when it closed
    committed_done: int | None = None  # ... and when the request finished
    tokens: list | None = None  # the served tokens, once finished
    req: object = None  # the program's Request while the run holds it


@dataclasses.dataclass
class StepRec:
    """One engine step: host times around ``engine.step``, the requests
    left queued after its admission; with ``rows``, each running row's
    (context length before the step, tokens the step committed for it)."""

    t_start: float
    t_end: float
    queued: int
    rows: list | None = None


class Loop:
    """Drives one engine with one run's traffic (module docstring)."""

    def __init__(self, eng, traffic: Traffic, clock=time.perf_counter):
        self.eng = eng
        self.traffic = traffic
        self.clock = clock
        self.recs: list[Rec] = []
        self.steps: list[StepRec] = []
        self.record_rows = False
        self.w0 = self.w1 = None
        self.filled = None  # what :meth:`fill` served, where the mix asks
        self.stats_w0 = self.stats_w1 = None
        self._live: dict[int, Rec] = {}  # id(Request) -> Rec

    # -- traffic -------------------------------------------------------------

    def _send(self, spec, t_due: float, client: int = -1) -> Rec:
        prompt = self.traffic.prompt(spec)
        rec = Rec(t_due, prompt, spec.max_new, client)
        req = self.eng.submit(prompt, spec.max_new)
        self.recs.append(rec)
        if req.state in ("rejected", "shed"):
            rec.failed = True
        else:
            rec.req = req
            self._live[id(req)] = rec
        return rec

    # -- one round -----------------------------------------------------------

    def _round(self) -> float | None:
        """One admit/step/maintain round; the step's end time, or None
        where nothing ran."""
        eng = self.eng
        sched = eng.scheduler
        sched.admit()
        if not sched.running:
            if sched.queue and not eng.reclaim_policy.drain_pending():
                raise MemoryError("queued work cannot be admitted and "
                                  "nothing is running")
            return None
        watch = [(self._live[id(r)], r.committed) for r in sched.running]
        t_a = self.clock()
        eng.step()
        t_b = self.clock()
        rows = [] if self.record_rows else None
        for rec, before in watch:
            req = rec.req
            if rows is not None:
                rows.append((before, req.committed - before))
            while len(rec.token_times) < len(req.generated):
                rec.token_times.append(t_b)
            if req.state == "finished":
                self._finish(rec, t_b)
        self.steps.append(StepRec(t_a, t_b, len(sched.queue), rows))
        sched.maintain()
        return t_b

    def _finish(self, rec: Rec, t: float) -> None:
        req = rec.req
        rec.t_done = t
        rec.tokens = list(req.generated)
        rec.admitted_step = req.admitted_step
        rec.prefix_reused = req.prefix_reused
        rec.committed_done = req.committed
        rec.req = None
        del self._live[id(req)]
        self.on_finish(rec, t)

    def on_finish(self, rec: Rec, t: float) -> None:
        """Closed loop: the caller sends its next request (set by
        :meth:`run`)."""

    def _mark(self, t: float, field: str) -> None:
        """Open (``w0``) or close (``w1``) the window at ``t``: the engine's
        counters and each live request's committed tokens then."""
        setattr(self, field, t)
        setattr(self, "stats_" + field, self.counters())
        for rec in self._live.values():
            setattr(rec, "committed_" + field, rec.req.committed)

    def counters(self) -> dict:
        s = self.eng.stats
        return {"steps": s.steps, "tokens_committed": s.tokens_committed,
                "prefix_tokens_reused": s.prefix_tokens_reused}

    # -- set-up --------------------------------------------------------------

    def fill(self, slack_pages: int | None = None) -> int:
        """Serve the mix's earlier requests through the engine's own round,
        each prefill-only (:meth:`Traffic.fill_prompt`), until the pages
        the prefix cache holds, with those the requests in flight will
        add, come within ``slack_pages`` (default: a 64th) of its cap;
        then drain them.
        They are set-up, not requests of the run.  Returns how many were
        served."""
        eng, sched = self.eng, self.eng.scheduler
        index, ps = sched.index, eng.page_size
        if slack_pages is None:
            slack_pages = index.cap // 64
        sp = self.traffic.mix.get("shared_prefix")
        shared = int(sp["tokens"]) if sp else 0
        t0 = self.clock()
        mix = self.traffic.mix
        # twice the requests of median size the cap holds: the sizes drawn
        # are the mix's, and no draw comes near twice the median's pages
        typical = (int(mix["prompt_median"]) + int(mix["output_median"])) / ps
        specs = iter(self.traffic.fill_specs(
            int(2 * index.cap / typical) + 4 * eng.max_batch))
        inflight: dict[int, tuple] = {}  # id(Request) -> (request, pages)
        sent = 0
        while True:
            adding = sum(n for _, n in inflight.values())
            while (len(inflight) < 2 * eng.max_batch
                   and len(index.pages) + adding < index.cap - slack_pages):
                spec = next(specs, None)
                if spec is None:
                    raise RuntimeError("the fill's requests ran out before "
                                       "the prefix cache was full")
                prompt = self.traffic.fill_prompt(spec)
                req = eng.submit(prompt, 1)
                if req.state in ("rejected", "shed"):
                    raise RuntimeError("the engine refused a request that "
                                       "fills its prefix cache")
                n = -(-(len(prompt) + 1 - shared) // ps)
                inflight[id(req)] = (req, n)
                adding += n
                sent += 1
            if not inflight:
                self.filled = {"requests": sent, "pages": len(index.pages),
                               "cap": index.cap,
                               "seconds": self.clock() - t0}
                return sent
            sched.admit()
            if not sched.running:
                raise MemoryError("requests that fill the prefix cache "
                                  "cannot be admitted")
            eng.step()
            sched.maintain()
            for key, (req, _) in list(inflight.items()):
                if req.state == "finished":
                    del inflight[key]

    # -- the run -------------------------------------------------------------

    def run(self, seconds: float, after=None) -> None:
        """Warm up, then measure ``seconds`` (module docstring).  ``after``
        (called with this loop once the window has closed) runs extra
        rounds of the same traffic, such as the profiled slice, by calling
        :meth:`more`."""
        mix = self.traffic.mix
        if mix.get("fill_cache"):
            self.fill()
        t0 = self.clock()
        if self.traffic.loop == "open":
            warm = float(mix["warmup_s"])
            bounds = (0.0, warm, warm + seconds,
                      warm + seconds + float(mix["tail_s"]))
            pending = [(t0 + t, spec) for t, spec in
                       self.traffic.arrivals(bounds)]
            self._pending, self._cursor = pending, 0
            warmed = lambda t: t >= t0 + warm  # noqa: E731
        else:
            lanes = self.traffic.client_specs(int(mix.get("per_client", 64)))
            self._lanes = [iter(lane) for lane in lanes]
            first = [self._send(next(lane), t0, c)
                     for c, lane in enumerate(self._lanes)]
            need = int(mix["warmup_completions"])

            def warmed(t):
                done = sum(r.t_done is not None for r in self.recs)
                return done >= need and all(
                    r.t_done is not None
                    or r.req.committed >= len(r.prompt) for r in first)

            def on_finish(rec, t):
                self._send(next(self._lanes[rec.client]), t, rec.client)
            self.on_finish = on_finish
        while self.w1 is None:
            t = self.more()
            if t is None:
                continue
            if self.w0 is None:
                if warmed(t):
                    self._mark(t, "w0")
            elif t >= self.w0 + seconds:
                self._mark(t, "w1")
        if after is not None:
            after(self)
        for rec in self._live.values():
            rec.admitted_step = rec.req.admitted_step
            rec.prefix_reused = rec.req.prefix_reused
            rec.req = None
        self._live.clear()

    def more(self) -> float | None:
        """Send what is due, then one round; the step's end time, or None
        (after a short sleep where the engine is idle)."""
        if self.traffic.loop == "open":
            now = self.clock()
            pending, i = self._pending, self._cursor
            while i < len(pending) and pending[i][0] <= now:
                self._send(pending[i][1], pending[i][0])
                i += 1
            self._cursor = i
            if i == len(pending):
                raise RuntimeError("the arrival schedule ran out: raise "
                                   "the mix's tail_s")
        t = self._round()
        if t is None and self.traffic.loop == "open":
            nxt = self._pending[self._cursor][0]
            time.sleep(min(0.005, max(0.0, nxt - self.clock())))
        return t

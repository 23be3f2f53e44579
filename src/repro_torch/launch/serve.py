"""Serving driver: continuous batching over the versioned page pool.

The port of ``repro.launch.serve``: the same flags, validation, trace
replay and output lines, plus ``--device`` (default ``cuda``; the tests
pass ``--device cpu``).  ``--device cuda`` serves on every card, ``cuda:0``
… ``cuda:n-1``, and ``--tp`` × ``--replicas`` must fit in that count; a
named device (``cuda:0``, ``cpu``) holds every shard and replica, as
``devices=["cuda:0"] * 4`` lays a 2D fleet out on one card.  The weights
are seeded ``init_decoder_lm`` parameters on the first device.  Decoder
LMs: the ``dense``, ``moe`` and ``vlm`` families (a VLM serves its text
decoder); any other family raises ``ValueError``, as the reference's
serving demo refuses it (its model runs, unpaged, through
``repro_torch.models.build_model``).

Synthesizes a batch of requests against a (reduced, by default) model and
reports throughput plus the OA counters — preemptions, reader restarts,
warnings (pool clock) — under a configurable memory budget.  With
``--prefix-cache`` the requests share a common system prompt
(``--shared-prefix`` tokens long) and the engine's refcounted prefix index
serves it: later admissions skip prefill for the shared pages and the
sharing counters (hits / tokens reused / COW copies) are reported.  With
``--replicas N`` the workload runs data-parallel across N independent
pool+runner replicas (one per device, cycling) behind the prefix-affine
router, and the aggregated fleet counters are reported.

Multi-tenant / overload extensions:

- ``--classes "interactive:0.7,batch:0.3"`` draws each synthetic request's
  service class from the given mix — per-class tail latency (p50/p95/p99
  TTFT) is reported at the end.
- ``--trace path.jsonl`` replays a recorded open-loop schedule (see
  ``repro_torch.serving.traffic``) against the wall clock instead of submitting
  a closed-loop batch; arrivals never wait for a busy engine.
- ``--stream`` drains through :meth:`PagedServingEngine.stream`, printing
  tokens as steps complete instead of at drain end.

All CLI validation (unknown class names, non-positive weights, malformed
specs, unreadable traces) raises a clear ``ValueError`` BEFORE the model
is built — a typo fails in milliseconds, not after the weights are made.

Capacity note: ``max_pages_per_seq`` is derived from the ACTUAL prompt
length through ``repro_torch.serving.required_pages_per_seq`` — the
worst-case block-table demand the scheduler exposes.  CLI-side arithmetic
from ``--prompt-len`` under-provisions when ``--shared-prefix`` exceeds it
(the real prompt is ``shared + tail``, longer than ``--prompt-len``),
making ``submit`` reject the workload; regression-tested in
``tests/test_torch_serve.py``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import DECODER_FAMILIES, init_decoder_lm
from repro_torch.serving import (DEFAULT_CLASSES, DataParallelEngine,
                                 PagedServingEngine, load_trace,
                                 replay_arrivals, required_pages_per_seq)


def parse_class_mix(spec: str) -> dict[str, float]:
    """``"interactive:0.7,batch:0.3"`` -> ``{...}`` with clear errors:
    unknown class names and non-positive weights are rejected here, before
    any model work."""
    mix: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.partition(":")
        name = name.strip()
        if not sep:
            raise ValueError(f"bad --classes entry {part!r}; "
                             f"expected name:weight")
        if name not in DEFAULT_CLASSES:
            raise ValueError(f"unknown request class {name!r}; known "
                             f"classes: {sorted(DEFAULT_CLASSES)}")
        if name in mix:
            raise ValueError(f"duplicate class {name!r} in --classes")
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(f"bad --classes weight {w!r} for {name!r}; "
                             f"expected a number") from None
        if weight <= 0:
            raise ValueError(f"--classes weight for {name!r} must be "
                             f"positive, got {weight}")
        mix[name] = weight
    if not mix:
        raise ValueError("--classes spec is empty")
    return mix


def _replay_trace(eng, events, vocab: int):
    """Open-loop replay against the wall clock (arrivals never wait for
    the engine), then drain; returns the submitted requests."""
    reqs, cursor = [], 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        due, cursor = replay_arrivals(events, now, cursor)
        for ev in due:
            reqs.append(eng.submit(ev.prompt(vocab), ev.max_new, cls=ev.cls))
        eng.scheduler.admit()
        if eng.scheduler.running:
            eng.step()
            eng.scheduler.maintain()
        elif eng.scheduler.queue:
            if not eng._reclaim_policy.drain_pending():
                raise MemoryError("trace replay wedged: queued work cannot "
                                  "be admitted and nothing is running")
        elif cursor < len(events):
            time.sleep(min(0.005, max(0.0, events[cursor].t - now)))
        else:
            eng.stats.record_wall(time.perf_counter() - t0)
            return reqs


def serving_devices(device: str, need: int) -> list[torch.device]:
    """The devices ``--device`` names: every card for ``cuda`` (the
    count is ``torch.cuda.device_count()``), else the named device once per
    shard and replica (``need`` of them).  Raises ``RuntimeError`` for a
    CUDA device when there is none: never a fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to serve on the CPU")
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * need


def main(argv: list[str] | None = None):
    """Run the serving demo; ``argv`` overrides ``sys.argv`` (tests use it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--num-pages", type=int, default=48)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable refcounted prompt-prefix sharing")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of system prompt common to every request")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel pool+runner replicas (1 = single "
                         "engine; N>1 routes by prefix affinity + pressure)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism per engine: shard weights and "
                         "the KV page arena over N devices (composes with "
                         "--replicas into a 2D replica x tensor fleet "
                         "needing replicas*tp devices)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: up to K n-gram-drafted "
                         "tokens verified per fused dispatch (0 = off; "
                         "greedy only)")
    ap.add_argument("--classes", default=None, metavar="SPEC",
                    help="service-class mix for the synthetic workload, "
                         "e.g. 'interactive:0.7,batch:0.3' (per-class tail "
                         "latency is reported)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay a recorded JSONL trace open-loop against "
                         "the wall clock (repro_torch.serving.traffic "
                         "format)")
    ap.add_argument("--stream", action="store_true",
                    help="drain through the streaming generator, printing "
                         "tokens as steps complete")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' serves on every card (cuda:0 … cuda:n-1); "
                         "a named device ('cuda:0', 'cpu') holds every "
                         "shard and replica")
    args = ap.parse_args(argv)

    # -- cheap validation first: fail on typos before any model work -----
    mix = parse_class_mix(args.classes) if args.classes else None
    events = None
    if args.trace is not None:
        if mix is not None:
            raise ValueError("--classes has no effect with --trace (trace "
                             "events carry their own classes); drop one")
        if args.replicas > 1:
            raise ValueError("--trace replay drives a single engine; "
                             "it cannot be combined with --replicas > 1")
        events = load_trace(args.trace)  # host-only, validates the file
        if not events:
            raise ValueError(f"trace {args.trace!r} contains no events")
        for ev in events:
            if ev.cls not in DEFAULT_CLASSES:
                raise ValueError(f"trace {args.trace!r} uses unknown "
                                 f"request class {ev.cls!r}; known "
                                 f"classes: {sorted(DEFAULT_CLASSES)}")
    if args.stream and args.replicas > 1:
        raise ValueError("--stream drains a single engine; it cannot be "
                         "combined with --replicas > 1")
    if args.tp < 1:
        raise ValueError(f"--tp must be >= 1, got {args.tp}")
    need = args.tp * max(args.replicas, 1)
    devices = serving_devices(args.device, need)
    if args.tp > 1:
        have = len(devices)
        if have < need:
            raise ValueError(
                f"--tp {args.tp} x --replicas {args.replicas} needs {need} "
                f"devices; have {have} (name one device, e.g. --device "
                f"cuda:0, to lay every shard out on it)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(
            f"{cfg.name}: serving demo: decoder LMs "
            f"({', '.join(DECODER_FAMILIES)}); the {cfg.family} family has no "
            f"paged serving path (its model runs through "
            f"repro_torch.models.build_model)")
    params = init_decoder_lm(cfg, seed=args.seed, device=devices[0])

    rng = np.random.default_rng(args.seed)
    if events is not None:
        max_prompt = max(ev.prompt_len for ev in events)
        max_new = max(ev.max_new for ev in events)
    else:
        shared = rng.integers(0, cfg.vocab, (args.shared_prefix,)).tolist()
        tail_len = max(1, args.prompt_len - args.shared_prefix)
        prompts = [shared + rng.integers(0, cfg.vocab, (tail_len,)).tolist()
                   for _ in range(args.requests)]
        # worst-case per-slot demand from the scheduler's own arithmetic —
        # the REAL prompt length (shared + tail) can exceed --prompt-len
        max_prompt = max(len(p) for p in prompts)
        max_new = args.max_new
    # + spec_k: a drafting row may hold up to K uncommitted (possibly
    # rejected) positions past max_new in its final step's grant
    pages_per_seq = required_pages_per_seq(max_prompt,
                                           max_new + args.spec_k,
                                           args.page_size)

    engine_kw = dict(
        num_pages=args.num_pages, page_size=args.page_size,
        max_batch=args.max_batch, max_pages_per_seq=pages_per_seq,
        prefix_cache=args.prefix_cache, speculative_k=args.spec_k,
        tensor_parallel=args.tp,
    )
    if args.replicas > 1:
        eng = DataParallelEngine(cfg, params, replicas=args.replicas,
                                 devices=devices, **engine_kw)
    elif args.tp > 1:
        eng = PagedServingEngine(cfg, params, devices=devices, **engine_kw)
    else:
        eng = PagedServingEngine(cfg, params, device=devices[0], **engine_kw)
    label = (f"[serve x{args.replicas}"
             + (f" tp{args.tp}" if args.tp > 1 else "") + "]"
             if args.replicas > 1 or args.tp > 1 else "[serve]")

    if events is not None:
        reqs = _replay_trace(eng, events, cfg.vocab)
        stats = eng.stats
    else:
        classes = (rng.choice(sorted(mix), size=len(prompts),
                              p=np.array([mix[k] for k in sorted(mix)])
                              / sum(mix.values())).tolist()
                   if mix else ["interactive"] * len(prompts))
        reqs = [eng.submit(p, args.max_new, cls=c)
                for p, c in zip(prompts, classes)]
        if args.stream:
            for req, new in eng.stream():
                print(f"{label} r{req.rid} +{len(new)} tokens: {new}")
            stats = eng.stats
        else:
            stats = eng.run()
    done = sum(r.state == "finished" for r in reqs)
    print(f"{label} finished {done}/{len(reqs)} requests in {stats.steps} steps "
          f"({stats.wall_seconds:.2f}s, "
          f"{stats.tokens_committed / stats.wall_seconds:.1f} tok/s)")
    print(f"{label} OA counters: warnings={stats.warnings_fired} "
          f"preemptions={stats.preemptions} reader_restarts={stats.reader_restarts} "
          f"pages_reclaimed={stats.pages_reclaimed}")
    if args.spec_k > 0:
        print(f"{label} speculation: drafted={stats.tokens_drafted} "
              f"accepted={stats.tokens_accepted} "
              f"accept_rate={stats.accept_rate:.2f} "
              f"draft_k={stats.draft_k} spec_steps={stats.spec_steps}")
    if args.prefix_cache:
        print(f"{label} prefix sharing: hits={stats.prefix_hits} "
              f"tokens_reused={stats.prefix_tokens_reused} "
              f"cow_copies={stats.cow_copies} "
              f"pages_allocated={stats.pages_allocated} "
              f"cache_pages={stats.prefix_cache_pages} "
              f"evictions={stats.prefix_evictions}")
    if mix is not None or events is not None:
        for name, cs in sorted(stats.class_stats.items()):
            p = cs.percentiles()
            print(f"{label} class {name}: "
                  f"finished={cs.finished}/{cs.submitted} shed={cs.shed} "
                  f"rejected={cs.rejected} "
                  f"ttft_p50={p['ttft_p50']:.3f}s "
                  f"p95={p['ttft_p95']:.3f}s p99={p['ttft_p99']:.3f}s")
    lost = sum(r.state not in ("finished", "shed", "rejected") for r in reqs)
    assert lost == 0, f"{lost} requests neither finished nor accounted for"
    return stats


if __name__ == "__main__":
    main()

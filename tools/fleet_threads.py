"""Where a threaded fleet of replicas on one card loses its time.

Usage: python tools/fleet_threads.py [--eager] [--one N]

Serves chip_smoke.py's fleet workload (full-width olmo-1b, seeded bf16
weights, 512 pages of 16 tokens, ``max_batch=8``, ``prefill_chunk=16``,
16 prompts of 64-256 tokens, 32 new tokens each) on the card, through
the step graphs (``--eager``: the eager step), in four ways:

- one engine;
- a 2-replica ``DataParallelEngine`` in ``step()`` mode (one thread);
- in ``run()`` mode (a driver thread a replica) at the interpreter's
  switch interval, then at 0.1 ms (``sys.setswitchinterval``, restored
  after).

Each replica steps on its own CUDA stream, as the fleet places it
(``serving/parallel.py``).

Each way drains the requests twice on one server and times the second
drain (the first's wall, which holds the graphs' captures, is printed
beside it).  Prints each way's wall, tokens/s and ratio to one engine,
and for the
``run()`` ways each driver thread's share of its wall spent in the step's
read (``ModelRunner.collect``, timed by a patch here).  Every way must
generate the ``step()`` fleet's tokens, else it exits 1.  ``--one N``:
only one engine, its first drain then N more, each timed and printed
(tokens/s), so that two trees' engines can be timed in turn, one
process each.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

KW = dict(num_pages=512, page_size=16, max_batch=8, prefill_chunk=16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eager", action="store_true",
                    help="the eager step in place of the step graphs")
    ap.add_argument("--one", type=int, default=0, metavar="N",
                    help="time N warm drains of one engine, nothing else")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import (DataParallelEngine, PagedServingEngine,
                                     parallel)
    from repro_torch.serving.runner import ModelRunner

    if not torch.cuda.is_available():
        print("fleet_threads: no CUDA device", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    cfg = get_config("olmo-1b")
    params = init_decoder_lm(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(64, 257, 16)]
    gen = 16 * 32
    if args.one:
        eng = PagedServingEngine(cfg, params, device="cuda", **KW)
        rates = []
        for i in range(args.one + 1):
            reqs = [eng.submit(p, 32) for p in prompts]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            assert all(r.state == "finished" for r in reqs)
            if i:
                rates.append(gen / wall)
        print(f"fleet_threads one engine on {name}: {args.one} warm drains "
              f"{[round(r, 1) for r in rates]} tokens/s, mean "
              f"{sum(rates) / len(rates):.1f}")
        return 0

    waits: dict = {}  # thread -> seconds in the read
    collect = ModelRunner.collect

    def timed_collect(self, pending):
        t0 = time.perf_counter()
        try:
            return collect(self, pending)
        finally:
            key = threading.current_thread()
            waits[key] = waits.get(key, 0.0) + time.perf_counter() - t0

    ModelRunner.collect = timed_collect

    def drain(make, mode):
        """Two drains of the requests on one server: (the second's tokens,
        the first's wall s — its captures included —, the second's wall
        s, per driver thread of the second: (read s, wall s))."""
        server = make()
        if args.eager:
            for e in getattr(server, "replicas", [server]):
                e.runner.graphs = False
        first = once(server, mode)[1]
        return (first, *once(server, mode))

    def once(server, mode):
        reqs = [server.submit(p, 32) for p in prompts]
        waits.clear()
        threads: dict = {}
        drive = parallel.DataParallelEngine._drive

        def timed_drive(self, i, *a):
            t0 = time.perf_counter()
            try:
                drive(self, i, *a)
            finally:
                threads[threading.current_thread()] = (
                    time.perf_counter() - t0)
        parallel.DataParallelEngine._drive = timed_drive
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if mode == "step":
                while not server.drained():
                    server.step()
            else:
                server.run()
            torch.cuda.synchronize()
        finally:
            parallel.DataParallelEngine._drive = drive
        wall = time.perf_counter() - t0
        assert all(r.state == "finished" for r in reqs)
        return ([list(r.generated) for r in reqs], wall,
                [(waits.get(t, 0.0), w) for t, w in threads.items()])

    def fleet():
        return DataParallelEngine(cfg, params, replicas=2,
                                  devices=["cuda:0", "cuda:0"], **KW)

    def engine():
        return PagedServingEngine(cfg, params, device="cuda", **KW)

    drain(fleet, "step")  # warm: the kernels built, cuBLAS set up
    first, _, one, _ = drain(engine, "run")
    step_name = "graphs" if not args.eager else "eager step"
    print(f"fleet_threads on {name}, {step_name}, the second of two drains "
          f"of one server (the first's wall, captures included, in "
          f"brackets): one engine {one:.3f} s [{first:.3f}] "
          f"({gen / one:.1f} tokens/s)")
    first, base, wall, _ = drain(fleet, "step")
    print(f"fleet_threads step(): {wall:.3f} s [{first:.3f}] "
          f"({gen / wall:.1f} tokens/s, {one / wall:.3f}x one engine)")
    interval = sys.getswitchinterval()
    ways = [("run()", interval), ("run() at 0.1 ms", 1e-4)]
    ok = True
    for label, switch in ways:
        sys.setswitchinterval(switch)
        try:
            first, tokens, wall, threads = drain(fleet, "run")
        finally:
            sys.setswitchinterval(interval)
        ok &= tokens == base
        reads = ", ".join(f"{100 * r / w:.1f}% of {w:.3f} s"
                          for r, w in threads)
        print(f"fleet_threads {label}: {wall:.3f} s [{first:.3f}] "
              f"({gen / wall:.1f} "
              f"tokens/s, {one / wall:.3f}x one engine); each driver "
              f"thread in the read: {reads}; tokens "
              f"{'equal' if tokens == base else 'DIFFER from'} step()'s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

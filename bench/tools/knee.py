"""Sweep an open-loop cell's arrival rate on the card, to find its knee:
the highest rate at which the backlog does not grow over a window.

    python3 bench/tools/knee.py --workload olmo-1b.prefix-chat \
        --rates 8,10,12 --seconds 20 --seed 1

One process; each rate gets a fresh engine over the same weights, and its
set-up as a run's (the cache filled where the mix asks).  Prints per rate
the requests due and finished in the window, the queue when the window
opened and closed and its largest size, the tails, and how long the
window's finished requests lived.  The cell's
file then takes about four fifths of the knee as its rate.
"""

import gc
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main():
    import argparse

    import torch

    from bench.cells import load_cell, load_reader
    from bench.drive import Loop
    from bench.generate import Traffic
    from bench.harness import build_engine, capture_graphs
    from bench.timeline import Run, percentile

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    cell = load_cell(ROOT, args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.mix["rate_rps"] = rate
        eng = build_engine(cell, args.seed, torch.device("cuda:0"))
        capture_graphs(eng)
        d = Loop(eng, Traffic(cell.mix, args.seed, cell.spec.vocab))
        d.run(args.seconds)
        run = Run(d.w0, d.w1, d.recs, d.steps, cell.family, cell.spec,
                  d.stats_w0, d.stats_w1)
        win = run.window_steps()
        done = sum(1 for r in run.recs
                   if r.t_done is not None and d.w0 < r.t_done <= d.w1)
        ttft = run.ttfts_s()
        life = [r.t_done - r.t_due for r in run.recs
                if r.t_done is not None and d.w0 < r.t_done <= d.w1]
        print(f"rate {rate}: due {len(run.due())} finished {done} "
              f"queue {win[0].queued}->{win[-1].queued} "
              f"(max {max(s.queued for s in win)}) "
              f"gen_tok_s {load_reader(ROOT, 'gen_tok_s')(run):.1f} "
              f"ttft p50 {1e3 * percentile(ttft, 50):.1f} "
              f"p95 {1e3 * percentile(ttft, 95):.1f} ms "
              f"itl p95 {load_reader(ROOT, 'itl_p95_ms')(run):.2f} ms "
              f"steps {len(win)} "
              f"step {1e3 * run.window_s / len(win):.2f} ms "
              f"prefix reused {run.counter('prefix_tokens_reused')} "
              f"lifetime mean {sum(life) / max(len(life), 1):.2f} s "
              f"max {max(life, default=0.0):.2f} s "
              f"cache filled {d.filled} "
              f"reserved {torch.cuda.max_memory_reserved()}",
              flush=True)
        del eng, d, run
        gc.collect()
        torch.cuda.empty_cache()
        time.sleep(1.0)


if __name__ == "__main__":
    main()

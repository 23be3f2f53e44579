"""Read the two readings a cell's correctness limit is set from, on the
card, at the cell's own size and load.

    python3 bench/tools/calibrate.py --workload olmoe-1b-7b.chat \
        --seeds 3 --first-seed 3000 --seconds 10

One process runs the cell once per seed (``bench/harness.py::run_cell``
with ``control=True``): the program's run is judged as a benchmark run
judges it, then the fp8 reference put in its place on the same sample is
judged by the same comparison and limits, and has to come out not
correct.  Prints, per seed, both judgements, then each number's largest
program reading (its lower reading) and smallest control reading (its
upper reading).
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main():
    import argparse

    from bench.cells import load_cell
    from bench.harness import run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    cell = load_cell(ROOT, args.workload)
    seen = []
    for i in range(args.seeds):
        seed = args.first_seed + i
        out = run_cell(cell, seed, args.seconds, False, "cuda:0",
                       time.perf_counter(), control=True)
        seen.append(out)
        print(json.dumps({"seed": seed, "program": out["program"],
                          "control": {"correct": out["correct"],
                                      "compared": out["compared"]},
                          "metrics": out["metrics"]}), flush=True)
    for name in seen[0]["compared"]:
        prog = [o["program"]["compared"][name]["value"] for o in seen]
        ctl = [o["compared"][name]["value"] for o in seen]
        print(f"{cell.name} {name}: program max {max(prog)!r} over "
              f"{len(prog)} seeds; control min {min(ctl)!r}, max "
              f"{max(ctl)!r}; control correct in "
              f"{sum(o['correct'] for o in seen)} of {len(seen)}",
              flush=True)


if __name__ == "__main__":
    main()

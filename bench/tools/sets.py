"""Run one cell once per seed, each run a fresh ``bench/run.py`` process,
and append each result line, with the keys ``cell``, ``set``, ``seed``,
``trace`` and ``rc`` added, to a file that ``bench/tools/spread.py`` reads.

    python3 bench/tools/sets.py --workload olmo-1b.chat --set 1 \
        --out chiprun_out/sets.jsonl --seeds 11,12,13,14,15,16

Each run's output and errors go to ``<out>.logs/<cell>.<set>.<seed>.{out,err}``.
The run length is ``BENCHMARK.json``'s ``run_seconds``.
"""

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--set", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = pathlib.Path(args.out)
    logs = out.parent / (out.name + ".logs")
    logs.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        stem = logs / f"{args.workload}.{args.set}.{seed}"
        with open(f"{stem}.out", "w") as so, open(f"{stem}.err", "w") as se:
            rc = subprocess.call(
                [sys.executable, str(ROOT / "bench" / "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(seconds), "--trace", str(args.trace)],
                stdout=so, stderr=se, cwd=ROOT)
        lines = pathlib.Path(f"{stem}.out").read_text().strip().splitlines()
        try:
            line = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            line = {"metrics": {}}
        line.update(cell=args.workload, set=args.set, seed=seed,
                    trace=args.trace, rc=rc)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        err = pathlib.Path(f"{stem}.err").read_text().strip().splitlines()
        print(f"{args.workload} set {args.set} seed {seed} rc {rc} correct "
              f"{line.get('correct')} {line.get('metrics')}", flush=True)
        for e in err[-2:]:
            print("   ", e[:300], flush=True)


if __name__ == "__main__":
    main()

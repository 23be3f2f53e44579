"""The spread of each end-to-end metric over sets of runs, from which the
bounds in ``BENCHMARK.json`` are set.

    python3 bench/tools/spread.py RESULTS...

Each RESULTS file holds result lines of ``bench/run.py`` runs, one JSON
object a line, each with the keys ``cell`` and ``set`` added (the runs of
one set use one seed each; the two sets of a cell use the same seeds).  A
spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.  Prints,
per cell and metric, each set's median and spread; per metric the widest
spread over cells (the wider of a cell's two sets); and the spread the
check would read for tightness (each set without its run farthest from
the median, the two spreads' mean).
"""

import json
import statistics
import sys
from collections import defaultdict


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med, med


def trimmed(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def main(paths):
    runs = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    for path in paths:
        for line in open(path):
            line = line.strip()
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            for name, m in r["metrics"].items():
                runs[r["cell"]][name][r["set"]].append(m["value"])
    widest = defaultdict(float)
    for cell, metrics in sorted(runs.items()):
        for name, sets in sorted(metrics.items()):
            parts = []
            worst = 0.0
            tight = []
            for s, values in sorted(sets.items()):
                sp, med = spread(values)
                worst = max(worst, sp)
                tight.append(spread(trimmed(values))[0])
                parts.append(f"set {s}: median {med!r} spread {sp:.4f} "
                             f"({len(values)} runs)")
            widest[name] = max(widest[name], worst)
            print(f"{cell} {name}: " + "; ".join(parts)
                  + f"; trimmed mean spread {statistics.mean(tight):.4f}")
    for name, w in sorted(widest.items()):
        print(f"{name}: widest spread {w:.4f} -> 5x {5 * w:.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])

"""Hold a cell's program to its family's reference computed at the served
precision, on the card, where the check's control lies too close to the
program to tell a fault from rounding.

    python3 bench/tools/witness.py --workload trinity-mini.long-chat \
        --seeds 3 --first-seed 3000 --seconds 10

Per seed, in one process, the tool serves the cell as a benchmark run
does (``bench/harness.py``: weights and engine from the seed, graphs
captured, the mix until the window closes), draws the check's sample and
frees the program. On that sample three sets of tokens are judged by the
check's comparison (``bench/check.py::compare``, the float32 reference):
the program's served tokens, the first choices of the reference with
every weight product rounded to bfloat16 (``precision="bf16"``, the
witness) and those of the fp8 control. A program that adds no fault to
bf16 rounding reads about what the witness reads. Prints one JSON line a
seed: each set's served positions, tokens off the reference's argmax,
widest and mean gap. The family's ``forward_logits`` must take
``precision="bf16"`` (``afmoe`` does). ``--device cpu`` runs a tiny
cell.
"""

import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def picks(family, spec, seed, device, requests, precision):
    """``requests`` with the reference's first choices at ``precision``
    as the tokens judged (``bench/check.py::control_sample``'s rule)."""
    from bench.check import Served

    params = family.weights(spec, seed, device)
    out = []
    for r in requests:
        seq = list(r.prompt) + list(r.tokens)[:-1]
        low = family.forward_logits(spec, params, seq, precision=precision)
        out.append(Served(r.prompt, r.tokens,
                          low[len(r.prompt) - 1:].argmax(dim=1).tolist()))
        del low
    return out


def main():
    import argparse

    import torch

    from bench.cells import load_cell
    from bench.check import compare
    from bench.drive import Loop
    from bench.generate import Traffic
    from bench.harness import build_engine, capture_graphs, served_sample

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 2000)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    torch.set_num_threads(1)
    cell = load_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    for i in range(args.seeds):
        seed = args.first_seed + i
        eng = build_engine(cell, seed, dev)
        capture_graphs(eng)
        loop = Loop(eng, Traffic(cell.mix, seed, cell.spec.vocab))
        loop.run(args.seconds)
        picked = served_sample(loop, seed,
                               int(cell.check.get("sample_tokens", 512)))
        del eng, loop
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        line = {"cell": cell.name, "seed": seed}
        t = time.perf_counter()
        for name, judged in (
                ("program", picked),
                ("bf16", picks(cell.family, cell.spec, seed, dev, picked,
                               "bf16")),
                ("fp8", picks(cell.family, cell.spec, seed, dev, picked,
                              "fp8"))):
            r = compare(cell.family, cell.spec, seed, dev, judged)
            line[name] = {"positions": r.positions, "off": r.off_argmax,
                          "widest_gap": r.widest_gap, "mean_gap": r.mean_gap}
        line["judge_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

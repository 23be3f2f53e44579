"""Run one cell of the benchmark on the card this process starts on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the correctness check compared, with its limit
(also the last lines of standard error).  Exits non-zero, printing no
result, where there is no card, fewer cards than the cell asks for, or
where the process holds ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` once the window has closed.

Every build and kernel cache lives at a fixed path inside the checkout
(``build/``): the program's CUDA libraries in ``build/repro_torch_kernels``
(the program's own fixed path), and the caches of nvcc's JIT, Triton,
torch extensions and Inductor, set here before anything loads.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHES = {"CUDA_CACHE_PATH": "cuda_cache", "TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch

    # the host's work is one thread of Python; no pool of CPU threads
    # beside it to contend for the machine's cores
    torch.set_num_threads(1)

    from bench.cells import load_cell
    from bench.harness import run_cell

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   T_START)
    found = forbidden_modules()
    if found:
        print(f"the process holds modules it must not load: {found}",
              file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

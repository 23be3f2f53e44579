"""queue_wait_ms.gen: ``queue_wait_ms`` in the cells that report no
``ttft_p95_ms`` (the prefix cell, served above what it sustains, and the
MoE cell), where the wait moves ``gen_tok_s``."""

import pathlib

from bench.cells import load_reader


def read(run):
    root = pathlib.Path(__file__).resolve().parents[2]
    return load_reader(root, "queue_wait_ms")(run)

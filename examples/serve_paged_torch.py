"""Serving example over the PyTorch port (``repro_torch``), the workloads of
``examples/serve_paged.py``: batched requests through the paged engine
under memory pressure — preemptions and version-validated restarts happen
live — then the same workload with the refcounted prefix cache (every
request carries the same 8-token system prompt, so later admissions share
its KV pages and skip its prefill), then ``--stream`` (tokens print as
steps complete) and ``--trace`` (a recorded two-class open-loop schedule
replayed against the wall clock, per-class tail latency at the end).
Everything goes through the port's serving CLI,
``repro_torch.launch.serve.main``, which draws its own seeded weights.

Run on the card: PYTHONPATH=src python examples/serve_paged_torch.py
On the CPU:      PYTHONPATH=src python examples/serve_paged_torch.py --device cpu
"""

import argparse
import os
import tempfile

from repro_torch.launch.serve import main
from repro_torch.serving import dump_trace, synthesize_trace

BASE = ["--requests", "12", "--num-pages", "12", "--page-size", "8",
        "--max-batch", "4", "--prompt-len", "10", "--max-new", "20"]


def demo(base=BASE, shared_pages: int = 24, stream_requests: int = 3,
         trace_s: float = 2.0, device=None) -> dict:
    """The four workloads at ``base``'s scale (the prefix-sharing run on
    ``shared_pages`` pages), on ``device`` (None: the card).  Returns
    each workload's ``EngineStats`` by name."""
    dev = ["--device", str(device or "cuda")]
    out = {}
    print("== no sharing: every prompt distinct, pool under pressure ==")
    out["no sharing"] = main(base + dev)
    print("== prefix sharing: common system prompt served from the cache ==")
    out["prefix sharing"] = main(base + ["--prefix-cache", "--shared-prefix",
                                         "8", "--num-pages",
                                         str(shared_pages)] + dev)
    assert out["prefix sharing"].prefix_hits > 0, \
        "shared prompts must hit the prefix index"
    print("== streaming: tokens arrive as steps complete ==")
    out["streaming"] = main(["--requests", str(stream_requests),
                             "--num-pages", "24", "--page-size", "8",
                             "--max-batch", "2", "--prompt-len", "8",
                             "--max-new", "6", "--stream", "--classes",
                             "interactive:0.7,batch:0.3"] + dev)
    print("== trace replay: two-class bursty schedule, open loop ==")
    events = synthesize_trace(0, duration_s=trace_s, rate_rps=6.0,
                              process="bursty",
                              class_mix={"interactive": 0.7, "batch": 0.3},
                              prompt_mean=8, max_new_mean=6,
                              prompt_cap=16, max_new_cap=8)
    fd, path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    try:
        dump_trace(events, path)
        out["trace replay"] = main(["--num-pages", "48", "--page-size", "8",
                                    "--max-batch", "4", "--trace", path]
                                   + dev)
        assert out["trace replay"].class_stats, \
            "trace replay must report class stats"
    finally:
        os.unlink(path)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    demo(device=ap.parse_args().device)

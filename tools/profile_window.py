"""How many fused launches a torch.profiler trace of steady graph steps sees.

Usage: python tools/profile_window.py

Serves ``chip_smoke.py``'s engine-phase workload on the card through the
step graphs: full-width olmoe-1b-7b, seeded float32 weights,
``tensor_parallel=2`` on ``cuda:0`` with ``REPRO_MOE_SHARD=ep``, 512
pages of 16 tokens, ``max_batch=8``, ``prefill_chunk=16``, 8 prompts of
64-256 tokens, 32 new tokens each, drained 4 times.  In each drain,
from the fourth steady step on, every third pair of steady steps runs
under a fresh ``torch.profiler`` trace of the card, opened just before
the pair with no warm-up step (``chip_smoke.py`` now traces one step
first and drops it).  Prints, for every trace, the launches of
``paged_attention_kernel`` it counts a step, against the ``layers x
shards`` the step's graph replays (``paged_attention_append_cuda``'s
count; a step that captures a graph launches its dry step's too), and
the number of traces that counted fewer.  Exits 0 when every
step finished; the counts are what it reports.  Needs a GPU.
"""

from __future__ import annotations

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

KW = dict(num_pages=512, page_size=16, max_batch=8, prefill_chunk=16)


def fused_launches(prof, steps):
    """Launches of the fused kernel a step in a trace of ``steps`` steps."""
    n = 0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and "paged_attention_kernel" in ev.key:
            n += ev.count
    return n / steps


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import (
        paged_attention_append_cuda)
    from repro_torch.models.transformer import init_decoder_lm
    from repro_torch.serving import PagedServingEngine
    from repro_torch.serving.runner import ModelRunner

    if not torch.cuda.is_available():
        print("profile_window: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_config("olmoe-1b-7b")
    params = init_decoder_lm(cfg, seed=0, dtype=torch.float32,
                             device="cuda")
    os.environ["REPRO_MOE_SHARD"] = "ep"
    try:
        eng = PagedServingEngine(cfg, params, tensor_parallel=2,
                                 devices=["cuda:0"] * 2, **KW)
    finally:
        os.environ.pop("REPRO_MOE_SHARD", None)
    del params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(64, 257, 8)]
    per_step = 2 * cfg.n_layers
    counts = []  # (counted a step, launched a step) of every trace
    for _ in range(4):
        reqs = [eng.submit(p, 32) for p in prompts]
        sched = eng.scheduler
        steady, prof = 0, None
        while True:
            sched.admit()
            if not sched.running and not sched.queue:
                break
            is_steady = (not sched.queue and all(
                r.committed >= len(r.prompt)
                and len(r.generated) + 2 < r.max_new_tokens
                for r in sched.running))
            if is_steady:
                at = steady - 4
                if at >= 0 and at % 6 == 0 and prof is None:
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                    left, launched = 2, 0
                before = paged_attention_append_cuda.launches
                dry = ModelRunner.dry_steps
                eng.step()
                replayed = paged_attention_append_cuda.launches - before
                want = per_step * (1 + ModelRunner.dry_steps - dry)
                if replayed != want:
                    print(f"profile_window: a steady step replayed "
                          f"{replayed} fused launches, want {want}")
                    return 1
                steady += 1
                if prof is not None:
                    torch.cuda.synchronize()
                    left -= 1
                    launched += replayed
                    if left == 0:
                        prof.__exit__(None, None, None)
                        counts.append((fused_launches(prof, 2),
                                       launched / 2))
                        prof = None
            else:
                eng.step()
            sched.maintain()
        if not all(r.state == "finished" for r in reqs):
            print("profile_window: a request did not finish")
            return 1
    short = sum(c < n for c, n in counts)
    print(f"profile_window on {torch.cuda.get_device_name(0)}, "
          f"no warm-up: fused launches a step in {len(counts)} traces, (counted, "
          f"launched): {counts}; {short} counted fewer")
    return 0


if __name__ == "__main__":
    sys.exit(main())

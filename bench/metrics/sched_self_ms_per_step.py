"""sched_self_ms_per_step: host time of the scheduler's own work (the
self time of the program's ``scheduler.*`` spans: less the eviction
sweeps and the device reads opened inside them) that ends inside the
window, ÷ the window's steps (its ``engine.step`` spans).  With
``evict_ms_per_step`` and the reads it splits the benchmark's
``sched_ms_per_step``.  Nothing where the program records no spans, or no
longer holds the window's start."""


def read(run):
    try:
        from repro_torch.spans import records_between, self_times
    except ImportError:
        return None
    recs = records_between(run.w0, run.w1)
    steps = sum(r.name == "engine.step" for r in recs or ())
    if not steps:
        return None
    own = self_times(recs)
    return 1e3 * sum(t for name, t in own.items()
                     if name.startswith("scheduler.")) / steps

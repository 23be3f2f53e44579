"""read_wait_ms_per_step: host time in each step's one read back (the
program's ``runner.read`` spans: the copy and the wait for the device)
that ends inside the window, ÷ the window's steps (its ``engine.step``
spans).  Nothing where the program records no spans, or no longer holds
the window's start."""


def read(run):
    try:
        from repro_torch.spans import records_between
    except ImportError:
        return None
    recs = records_between(run.w0, run.w1)
    steps = sum(r.name == "engine.step" for r in recs or ())
    if not steps:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in recs
                     if r.name == "runner.read") / steps

"""device_idle_pct: the share of the profiled slice in which no device
operation ran (the union of the operations' intervals from
``torch.profiler``).  Nothing without a traced slice."""


def read(run):
    sl = run.profile
    if sl is None:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)

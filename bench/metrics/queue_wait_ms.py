"""queue_wait_ms: the mean time from a request's submission to its first
admission (the program's ``request.queued`` spans), over the requests
first admitted inside the window.  Nothing where none was, the program
records no spans, or no longer holds the window's start."""


def read(run):
    try:
        from repro_torch.spans import records_between
    except ImportError:
        return None
    waits = [r.t1 - r.t0 for r in records_between(run.w0, run.w1) or ()
             if r.name == "request.queued"]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
